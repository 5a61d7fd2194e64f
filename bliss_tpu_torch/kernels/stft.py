"""Summed power spectrum of an int16 PCM batch: K3 of the two-kernel
configs, and the frequency analyzer's scoring (counterpart of
``bliss_tpu/kernels/pallas_stft.py``).

``stft_power`` returns, for an int16 interleaved-stereo batch [B, L], the
Hann-windowed 512-point power spectrum of the C-truncated mono downmix,
summed over each song's non-overlapping 512-sample frames, as [B, 257]
float32 with a zero Nyquist column (the reference never accumulates it).

On a CUDA tensor it launches ``power_kernel`` of ``csrc/fused_all.cu``; on
a CPU tensor it runs ``stft_power_reference``, the plain PyTorch version of
the same function. Both compute in full float32 (no TF32), so the TPU
kernel's "precise"/"fast" split-matmul modes have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.intops import c_div

NBINS = C.WINDOW_SIZE // 2  # 256 computed bins (0..255; Nyquist dropped)
FRAME = 2 * C.WINDOW_SIZE  # 1024 interleaved samples per spectrum frame

# Launches of the CUDA kernel: one per stft_power on a CUDA tensor.
LAUNCHES = 0


def hann_dft_table() -> np.ndarray:
    """[512, 512] float64: Hann-folded DFT of a 512-sample mono frame;
    columns 0..255 hold the real part of bins 0..255, columns 256..511 the
    imaginary part. The Nyquist bin is dropped: the reference never
    accumulates it (reference: src/frequency_sort.c:86-93)."""
    dre, dim = tables.rdft_matrices()
    h = tables.hann_window()[:, None]
    return np.concatenate([h * dre[:, :NBINS], h * dim[:, :NBINS]], axis=1)


def frame_counts(n_samples: torch.Tensor) -> torch.Tensor:
    """int32 [B] whole 512-sample stereo frames of each song."""
    frames = torch.div(n_samples, C.CHANNELS * C.WINDOW_SIZE, rounding_mode="floor")
    return frames.to(torch.int32)


def check_power_inputs(samples, n_frames, frame_offset):
    """Raises ValueError for inputs the spectrum kernel does not take:
    int16 [B, L] samples with L a positive multiple of 1024, int32 [B]
    n_frames and an optional int32 [B] frame_offset, on one device."""
    if samples.dtype != torch.int16 or samples.dim() != 2:
        raise ValueError(
            f"samples must be int16 [B, L], got {samples.dtype} "
            f"{tuple(samples.shape)}"
        )
    B, L = samples.shape
    if B < 1 or L < FRAME or L % FRAME:
        raise ValueError(f"L must be a positive multiple of {FRAME}, got {L}")
    named = [("n_frames", n_frames)]
    if frame_offset is not None:
        named.append(("frame_offset", frame_offset))
    for name, t in named:
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be int32 [{B}], got {t.dtype} {tuple(t.shape)}")
        if t.device != samples.device:
            raise ValueError(f"{name} is on {t.device}, samples on {samples.device}")


def power_scratch(samples: torch.Tensor):
    """(part, ntiles): the spectrum kernel's scratch [B, ntiles, 512] of
    per-tile partial sums, one tile per ``bliss_power_tile()`` frames."""
    from bliss_tpu_torch.kernels import _build

    if not samples.is_contiguous() or samples.data_ptr() % 16:
        raise ValueError("samples must be contiguous and 16-byte aligned")
    B, L = samples.shape
    tile = _build.library("fused_all").bliss_power_tile()
    ntiles = -(-(L // FRAME) // tile)
    part = torch.empty(B, ntiles, C.WINDOW_SIZE, dtype=torch.float32, device=samples.device)
    return part, ntiles


def fold_power(power512: torch.Tensor) -> torch.Tensor:
    """[B, 257]: the re | im columns' summed squares added per bin, with a
    zero Nyquist column."""
    return F.pad(power512[:, :NBINS] + power512[:, NBINS:], (0, 1))


def _offsets(frame_offset, n_frames):
    if frame_offset is None or isinstance(frame_offset, torch.Tensor):
        return frame_offset
    return torch.full_like(n_frames, int(frame_offset))


def stft_power(
    samples: torch.Tensor,
    n_samples: torch.Tensor,
    frame_offset: torch.Tensor | int | None = None,
    precise: bool = True,
) -> torch.Tensor:
    """samples: int16 [B, L] interleaved stereo, L a multiple of 1024;
    n_samples: int32 [B]. Returns [B, 257] float32 power spectra summed over
    the song's frames (Nyquist column zero).

    ``frame_offset`` (int or int32 [B]): global index of this buffer's first
    frame, so a sequence shard counts its local frame f while
    ``frame_offset + f`` is below the song's frame count. ``precise`` names
    the TPU kernel's matmul mode; the port computes full float32 for
    either."""
    del precise
    n_frames = frame_counts(n_samples)
    frame_offset = _offsets(frame_offset, n_frames)
    check_power_inputs(samples, n_frames, frame_offset)
    if samples.device.type == "cpu":
        return power_reference(samples, n_frames, frame_offset)
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    from bliss_tpu_torch.kernels import _build

    global LAUNCHES
    dft = device_tables(1, 17, "firwin", samples.device)["dft"]
    part, ntiles = power_scratch(samples)
    B, L = samples.shape
    n_frames = n_frames.contiguous()
    offset = None if frame_offset is None else frame_offset.contiguous()
    _build.launch(
        "fused_all", "bliss_stft_power", samples.device, samples.data_ptr(), B, L,
        n_frames.data_ptr(), None if offset is None else offset.data_ptr(),
        dft.data_ptr(), part.data_ptr(), ntiles,
    )
    LAUNCHES += 1
    return fold_power(part.sum(dim=1))


def stft_power_reference(
    samples: torch.Tensor,
    n_samples: torch.Tensor,
    frame_offset: torch.Tensor | int | None = None,
    precise: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of ``stft_power``: the DFT as a float32 matmul.
    Callers on the GPU must keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    del precise
    n_frames = frame_counts(n_samples)
    frame_offset = _offsets(frame_offset, n_frames)
    check_power_inputs(samples, n_frames, frame_offset)
    return power_reference(samples, n_frames, frame_offset)


def power_reference(samples, n_frames, frame_offset=None) -> torch.Tensor:
    """[B, 257] from the frame counts: local frame f counts while
    ``frame_offset + f < n_frames``."""
    dft = device_tables(1, 17, "firwin", samples.device)["dft"]
    B, L = samples.shape
    W = C.WINDOW_SIZE
    NF = L // FRAME
    pairs = samples.reshape(B, NF, W, 2).to(torch.int32)
    mono = c_div(pairs[..., 0] + pairs[..., 1], 2).to(torch.float32)
    del pairs
    frame = torch.arange(NF, device=samples.device)[None, :]
    if frame_offset is not None:
        frame = frame + frame_offset[:, None].to(torch.int64)
    keep = frame < n_frames[:, None]
    mono = mono * keep[..., None].to(torch.float32)
    y = mono.reshape(B * NF, W) @ dft
    del mono
    return fold_power((y * y).reshape(B, NF, W).sum(dim=1))


def frequency_scores_fused(batch, cfg) -> torch.Tensor:
    """[B] frequency scores from ``stft_power`` of the batch."""
    power = stft_power(
        batch.samples, batch.n_samples, precise=cfg.stft_conv == "precise"
    )
    return frequency_scores_from_power(power, cfg)


def frequency_scores_from_power(power: torch.Tensor, cfg) -> torch.Tensor:
    """Reference band-dB scoring from accumulated power spectra [B, 257]
    (reference: src/frequency_sort.c:97-139). Returns [B] float32."""
    dtype = cfg.torch_dtype
    W = C.WINDOW_SIZE
    power = power.to(dtype)
    p = torch.sqrt(power[:, 1:] / float(W))
    peak = torch.amax(p, dim=1, keepdim=True)
    db = 20.0 * torch.log10(p / peak) - (-C.DB_ATTENUATION)
    lo, ls, hi, hs = (
        C.FREQ_LOW_INF, C.FREQ_LOW_SUP, C.FREQ_HIGH_INF, C.FREQ_HIGH_SUP,
    )
    b0 = (db[:, 1] + db[:, 3]) / 2.0
    b1 = (db[:, 5] + db[:, 7]) / 2.0
    b2 = torch.sum(db[:, lo - 1 : ls], dim=1) / (ls - lo)
    b3 = torch.sum(db[:, ls:hi], dim=1) / (hi - (ls + 1))
    b4 = torch.sum(db[:, hi:hs], dim=1) / (hs - (hi + 1))
    score = b4 + b3 + b2 - b0 - b1
    score = C.FREQUENCY_SCALE * score + C.FREQUENCY_BIAS
    return score.to(torch.float32)
