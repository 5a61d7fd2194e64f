"""Batched PCM container shared by all analyzers, the device rule of the
entry points, the row blocks of the XLA-path stage, and the extended
features' column names."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Column names of the extended features after the 4 force-vector columns
# (features/extended.py computes them; bliss_tpu/features/extended.py has
# the same names): `store export` names the 49-column rows that an
# --extended scan of either package writes.
EXTENDED_FEATURE_NAMES = (
    "zero_crossing_rate",
    "loudness_db",
    "spectral_centroid_hz",
    "spectral_rolloff_hz",
    "spectral_flatness",
    "bpm",
    "beat_loudness",
) + tuple(f"mfcc_{i}" for i in range(13)) + tuple(
    f"mfcc_std_{i}" for i in range(13)
) + tuple(f"chroma_{i:02d}" for i in range(12))


# Samples of PCM (times bands, for the tempo energies) that one block of
# rows of the XLA-path stage takes at once, so that its temporaries stay
# bounded whatever the batch.
ROW_SAMPLES = 1 << 26


def row_blocks(B: int, per_row: int, budget: int = ROW_SAMPLES):
    """(b0, b1) bounds of blocks of rows that hold at most ``budget``
    elements of ``per_row`` each, at least one row a block."""
    rows = max(1, budget // max(per_row, 1))
    return [(b0, min(B, b0 + rows)) for b0 in range(0, B, rows)]


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; raises RuntimeError for a CUDA device
    when none is present, rather than running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={device!r}: the port runs on the GPU "
            "unless the caller passes device='cpu'"
        )
    return dev


class PCMBatch(NamedTuple):
    """A zero-padded batch of canonical PCM songs.

    samples: int16 [B, L] interleaved stereo at 22.05 kHz, zero-padded to L
    n_samples: int32 [B] true interleaved sample count per song
    durations: int32 [B] container duration in whole seconds (the reference
        uses this, not n_samples, for the tempo score denominator,
        reference: src/tempo_atk_sort.c:283)
    """

    samples: torch.Tensor
    n_samples: torch.Tensor
    durations: torch.Tensor

    @staticmethod
    def from_arrays(
        arrays: list[np.ndarray],
        durations: list[int],
        pad_multiple: int = 1024,
        *,
        device="cuda",
    ) -> "PCMBatch":
        """Pad a list of 1-D int16 PCM arrays to a common length and place
        the batch on ``device``: the GPU unless the caller asks for the CPU
        (``device="cpu"``); raises RuntimeError when no GPU is present."""
        device = resolve_device(device)
        n = [int(a.shape[0]) for a in arrays]
        L = max(n)
        L = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
        out = np.zeros((len(arrays), L), np.int16)
        for i, a in enumerate(arrays):
            out[i, : a.shape[0]] = a
        return PCMBatch(
            samples=torch.from_numpy(out).to(device),
            n_samples=torch.tensor(n, dtype=torch.int32, device=device),
            durations=torch.tensor(
                np.asarray(durations, np.int32), dtype=torch.int32, device=device
            ),
        )
