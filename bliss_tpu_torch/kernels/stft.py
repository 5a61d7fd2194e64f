"""Summed power spectrum of an int16 PCM batch: K3 of the two-kernel
configs, and the frequency analyzer's scoring (counterpart of
``bliss_tpu/kernels/pallas_stft.py``).

``stft_power`` returns, for an int16 interleaved-stereo batch [B, L], the
Hann-windowed 512-point power spectrum of the C-truncated mono downmix,
summed over each song's non-overlapping 512-sample frames, as [B, 257]
float32 with a zero Nyquist column (the reference never accumulates it).

On a CUDA tensor it launches ``power_kernel`` of ``csrc/power.cuh``, a
512-point real FFT of each frame; on a CPU tensor it runs
``stft_power_reference``, the plain PyTorch version of the same function,
a float32 product with the Hann-folded DFT table. Both compute in full
float32 (no TF32), so the TPU kernel's "precise"/"fast" split-matmul modes
have no counterpart here. ``rfft512_power_steps`` runs the kernel's FFT
algorithm in PyTorch, step for step, for the tests.
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


def fft_twiddles() -> np.ndarray:
    """[512, 2] float64: W^k = exp(-2 pi i k / 512) as (re, im), k = 0..511.
    The spectrum kernel's radix stages take W_256^a = W^(2a) and W_64^a =
    W^(8a) from it, its real-FFT split step W^k."""
    ang = -2.0 * np.pi * np.arange(C.WINDOW_SIZE) / C.WINDOW_SIZE
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


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
    """(part, ntiles): the spectrum kernel's scratch [B, ntiles, 256] of
    per-block partial sums of bins 0..255, one block per
    ``bliss_power_tile()`` frames."""
    from bliss_tpu_torch.kernels import _build

    if not samples.is_contiguous() or samples.data_ptr() % 16:
        raise ValueError("samples must be contiguous and 16-byte aligned")
    B, L = samples.shape
    tile = _build.library("fused_all").bliss_power_tile()
    ntiles = -(-(L // FRAME) // tile)
    part = torch.empty(B, ntiles, NBINS, dtype=torch.float32, device=samples.device)
    return part, ntiles


def fold_power(power256: torch.Tensor) -> torch.Tensor:
    """[B, 257]: bins 0..255 with a zero Nyquist column."""
    return F.pad(power256, (0, 1))


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

    tabs = device_tables(1, 17, "firwin", samples.device)
    part, ntiles = power_scratch(samples)
    B, L = samples.shape
    n_frames = n_frames.contiguous()
    offset = None if frame_offset is None else frame_offset.contiguous()
    _build.launch(
        "fused_all", "bliss_stft_power", samples.device, samples.data_ptr(), B, L,
        n_frames.data_ptr(), None if offset is None else offset.data_ptr(),
        tabs["twiddle"].data_ptr(), tabs["hann"].data_ptr(), part.data_ptr(), ntiles,
    )
    _build.count_launch(globals(), "LAUNCHES")
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


def mono_frames(samples, n_frames, frame_offset=None, dtype=torch.float32) -> torch.Tensor:
    """[B, L/1024, 512] in ``dtype``: each frame's C-truncated mono downmix
    c_div(l + r, 2), zero where the frame does not count (local frame f
    counts while ``frame_offset + f < n_frames``)."""
    B, L = samples.shape
    NF = L // FRAME
    pairs = samples.reshape(B, NF, C.WINDOW_SIZE, 2).to(torch.int32)
    mono = c_div(pairs[..., 0] + pairs[..., 1], 2).to(dtype)
    del pairs
    frame = torch.arange(NF, device=samples.device)[None, :]
    if frame_offset is not None:
        frame = frame + frame_offset[:, None].to(torch.int64)
    keep = frame < n_frames[:, None]
    return mono * keep[..., None].to(dtype)


def power_reference(samples, n_frames, frame_offset=None) -> torch.Tensor:
    """[B, 257] from the frame counts: the mono frames times the [512, 512]
    Hann-folded DFT table, squared and summed over the frames."""
    dft = device_tables(1, 17, "firwin", samples.device)["dft"]
    mono = mono_frames(samples, n_frames, frame_offset)
    B, NF, W = mono.shape
    y = mono.reshape(B * NF, W) @ dft
    del mono
    y = (y * y).reshape(B, NF, W).sum(dim=1)
    return fold_power(y[:, :NBINS] + y[:, NBINS:])


# ---- the kernel's algorithm, step for step (tests only) ------------------------


def _dft4(a0, a1, a2, a3):
    """The 4-point DFT A_k = sum_n a_n W_4^(nk), as ``dft4`` computes it."""
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, -1j * (a1 - a3)
    return t0 + t2, t1 + t3, t0 - t2, t1 - t3


def _dft8(v):
    """The 8-point DFT of the list ``v``, as ``dft8`` computes it: two
    4-point DFTs of the even and odd points, then one radix-2 step."""
    e = _dft4(v[0], v[2], v[4], v[6])
    o = list(_dft4(v[1], v[3], v[5], v[7]))
    r = np.float32(np.sqrt(0.5))
    o[1] = torch.complex(r * (o[1].real + o[1].imag), r * (o[1].imag - o[1].real))
    o[2] = -1j * o[2]
    o[3] = torch.complex(r * (o[3].imag - o[3].real), -r * (o[3].real + o[3].imag))
    return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]


def rfft512_power_steps(y: torch.Tensor) -> torch.Tensor:
    """float32 [..., 256]: |X_k|^2 for bins 0..255 of the real 512-point
    frames ``y`` [..., 512] (Hann-windowed mono), computed as
    ``power_kernel`` computes it, with a lane axis of 32 and 8 values a
    lane: z[n] = y[2n] + i y[2n+1] (lane j holds n = 2j + e + 64m); a
    radix-4 step over m, twiddles W_256^(n1 k2); a radix-8 step over p2 in
    lane 8 k2 + p1 (n1 = p1 + 8 p2), twiddles W_64^(p1 q2); a radix-8 step
    over p1 in lane 4 q2 + k2, which leaves Z[32 q1 + lane] in value q1;
    then the split step X_k = (Z_k + conj Z_(256-k)) / 2 - i W^k (Z_k -
    conj Z_(256-k)) / 2 with Z_(256-k) from lane (32 - lane) % 32. The
    twiddles are ``fft_twiddles()`` in float32, as the kernel reads them.
    For the CPU tests: the kernel's index and sign conventions."""
    lead = y.shape[:-1]
    y = y.reshape(-1, C.WINDOW_SIZE).to(torch.float32)
    nfr = y.shape[0]
    tw32 = torch.from_numpy(fft_twiddles().astype(np.float32))
    tw = torch.complex(tw32[:, 0], tw32[:, 1])
    z = torch.complex(y[:, 0::2], y[:, 1::2])  # [F, 256]
    # lane j, value (e, m): z[64 m + 2 j + e]
    z = z.reshape(nfr, 4, 32, 2).permute(0, 2, 3, 1)  # [F, j, e, m]
    a = torch.stack(_dft4(*z.unbind(-1)), dim=-1)  # [F, j, e, k2]
    n1 = torch.arange(64).reshape(32, 2, 1)
    a = a * tw[(2 * n1 * torch.arange(4)) % 512]
    # exchange: lane 8 k2 + p1 takes X1(p1 + 8 p2, k2), p2 = 0..7
    x1 = a.reshape(nfr, 8, 8, 4).permute(0, 3, 2, 1).reshape(nfr, 32, 8)
    b = torch.stack(_dft8(x1.unbind(-1)), dim=-1)  # [F, 8 k2 + p1, q2]
    p1 = torch.arange(32).reshape(32, 1) % 8
    b = b * tw[8 * p1 * torch.arange(8)]
    # exchange: lane 4 q2 + k2 takes X2(k2, p1, q2), p1 = 0..7
    x2 = b.reshape(nfr, 4, 8, 8).permute(0, 3, 1, 2).reshape(nfr, 32, 8)
    zz = torch.stack(_dft8(x2.unbind(-1)), dim=-1)  # [F, lane, q1]: Z[32 q1 + lane]
    # split step: Z_(256 - k) sits in lane (32 - lane) % 32, value 7 - q1
    # (lane 0: value (8 - q1) % 8)
    lane = torch.arange(32).reshape(32, 1)
    q1 = torch.arange(8)
    val = torch.where(lane == 0, (8 - q1) % 8, 7 - q1)
    zp = zz.reshape(nfr, 256)[:, ((32 - lane) % 32) * 8 + val]
    w = tw[lane + 32 * q1]
    two_x = (zz + zp.conj()) - 1j * w * (zz - zp.conj())
    p = two_x.real * two_x.real + two_x.imag * two_x.imag
    return (0.25 * p).transpose(1, 2).reshape(*lead, NBINS)


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
