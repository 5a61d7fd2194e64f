"""Batched PCM container shared by all analyzers."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
