"""One pass of sample statistics plus the summed power spectrum (counterpart
of ``bliss_tpu/kernels/fused_all.py``).

``fused_all_call`` returns, for an int16 PCM batch [B, L]:

- ``wsum`` [B, NBF]: per 256-sample block, the sum of the amplitude weights
  w(s) = T(1000 - |s+1|), T the Chebyshev fit of the smoothing CDF;
- ``rownz`` [B, NBF]: per block, 1.0 if any sample is nonzero;
- ``energies`` [B, NB, NW] float64: per band and 512-sample window (hop
  256), the Parseval energy of the window-reset causal FIR of the
  normalized signal, assembled from per-block sums and warm-up
  corrections;
- ``power`` [B, 257]: the Hann-windowed 512-point power spectrum of the
  C-truncated mono downmix, summed over the song's first ``n_frames``
  frames; the Nyquist column is 0.

NBF = L // 256 and NW = NBF - 1. The energies are float64 (the JAX
kernel's are float32) because the tempo peak detector downstream resolves
~1e-10 relative changes of them on noisy music (see ``csrc/fused_all.cu``).

On a CUDA tensor it launches the hand-written kernel of
``csrc/fused_all.cu``; on a CPU tensor it runs ``fused_all_reference``, the
plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.intops import c_div, wrapping_sum_int32
from bliss_tpu_torch.kernels.fused_stats import BLK, cheb_T, trim_bounds_from_rownz

FRAME = 2 * C.WINDOW_SIZE  # 1024 interleaved samples per spectrum frame
NSTAT = 9  # (sum v, sum v^2, sum (-1)^t v) x (tail, head, reset) per band and block

# Launches of the CUDA kernel: one per fused_all_call on a CUDA tensor.
LAUNCHES = 0

_VP = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        from bliss_tpu_torch.kernels import _build

        lib = _build.load("fused_all")
        I = ctypes.c_int
        lib.bliss_fused_all_stats.argtypes = [
            _VP, I, I, _VP, _VP, _VP, I, ctypes.c_float, _VP, _VP, I, I,
            _VP, _VP, _VP, _VP,
        ]
        lib.bliss_fused_all_stats.restype = I
        lib.bliss_fused_all_power.argtypes = [_VP, I, I, _VP, _VP, _VP, I, _VP]
        lib.bliss_fused_all_power.restype = I
        lib.bliss_fused_all_power_tile.argtypes = []
        lib.bliss_fused_all_power_tile.restype = I
        lib.bliss_cuda_error_string.argtypes = [I]
        lib.bliss_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(samples, alpha, beta, n_frames, nb_bands, band_taps):
    if samples.dtype != torch.int16 or samples.dim() != 2:
        raise ValueError(
            f"samples must be int16 [B, L], got {samples.dtype} "
            f"{tuple(samples.shape)}"
        )
    B, L = samples.shape
    if B < 1 or L < FRAME or L % FRAME:
        raise ValueError(f"L must be a positive multiple of {FRAME}, got {L}")
    for name, t, dtype in (
        ("alpha", alpha, torch.float32),
        ("beta", beta, torch.float32),
        ("n_frames", n_frames, torch.int32),
    ):
        if t.dtype != dtype or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be {dtype} [{B}], got {t.dtype} {tuple(t.shape)}")
        if t.device != samples.device:
            raise ValueError(f"{name} is on {t.device}, samples on {samples.device}")
    if nb_bands < 1 or not 2 <= band_taps <= 129:
        raise ValueError(
            f"need nb_bands >= 1 and 2 <= band_taps <= 129, got {nb_bands}, {band_taps}"
        )


def fused_all_call(
    samples: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    n_frames: torch.Tensor,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
):
    """(wsum [B, NBF], rownz [B, NBF], energies [B, NB, NW], power [B, 257])
    of an int16 batch [B, L], L a multiple of 1024; ``alpha``/``beta``
    float32 [B] normalize the signal (xn = alpha*s + beta) and ``n_frames``
    int32 [B] counts each song's spectrum frames."""
    _check_inputs(samples, alpha, beta, n_frames, nb_bands, band_taps)
    if samples.device.type == "cpu":
        return fused_all_reference(
            samples, alpha, beta, n_frames, nb_bands=nb_bands,
            band_taps=band_taps, filterbank=filterbank,
        )
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    if not samples.is_contiguous() or samples.data_ptr() % 16:
        raise ValueError("samples must be contiguous and 16-byte aligned")
    alpha, beta, n_frames = (t.contiguous() for t in (alpha, beta, n_frames))

    global LAUNCHES
    lib = _library()
    tabs = device_tables(nb_bands, band_taps, filterbank, samples.device)
    B, L = samples.shape
    NBF = L // BLK
    halfwidth, _, _ = tables.amplitude_cdf_poly()
    tile = lib.bliss_fused_all_power_tile()
    ntiles = -(-(L // FRAME) // tile)
    dev = samples.device
    wsum = torch.empty(B, NBF, dtype=torch.float32, device=dev)
    rownz = torch.empty(B, NBF, dtype=torch.float32, device=dev)
    stats = torch.empty(B, nb_bands, NSTAT, NBF, dtype=torch.float64, device=dev)
    part = torch.empty(B, ntiles, C.WINDOW_SIZE, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bliss_fused_all_stats(
            samples.data_ptr(), B, L, alpha.data_ptr(), beta.data_ptr(),
            tabs["cheb"].data_ptr(), tabs["cheb"].numel(), float(halfwidth),
            tabs["fir"].data_ptr(), tabs["warm"].data_ptr(), nb_bands,
            band_taps, wsum.data_ptr(), rownz.data_ptr(), stats.data_ptr(),
            stream,
        )
        if rc == 0:
            rc = lib.bliss_fused_all_power(
                samples.data_ptr(), B, L, n_frames.data_ptr(),
                tabs["dft"].data_ptr(), part.data_ptr(), ntiles, stream,
            )
    if rc != 0:
        msg = lib.bliss_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_all kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return _assemble(wsum, rownz, stats, part.sum(dim=1))


def fused_all_reference(
    samples: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    n_frames: torch.Tensor,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
):
    """Plain PyTorch version of ``fused_all_call``, in the kernel's types
    (float32 amplitude and spectrum, float64 tempo FIR): the FIR as
    ``band_taps`` shifted adds, the warm-up correction as an einsum and the
    DFT as a matmul. Callers on the GPU must keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    _check_inputs(samples, alpha, beta, n_frames, nb_bands, band_taps)
    tabs = device_tables(nb_bands, band_taps, filterbank, samples.device)
    B, L = samples.shape
    NBF = L // BLK
    K = band_taps - 1
    x = samples.to(torch.float32)

    halfwidth, _, _ = tables.amplitude_cdf_poly()
    w = cheb_T(1000.0 - torch.abs(x + 1.0), tabs["cheb"], float(halfwidth))
    wsum = w.reshape(B, NBF, BLK).sum(dim=-1)
    rownz = (samples != 0).reshape(B, NBF, BLK).any(dim=-1).to(torch.float32)
    del w

    xn = alpha.double()[:, None] * x.double() + beta.double()[:, None]
    del x
    xp = F.pad(xn, (K, 0))  # normalized zero before sample 0
    del xn
    fir = tabs["fir"]
    alt = torch.as_tensor(tables.parseval_alt_sign()[:BLK], device=samples.device)
    hist = xp[:, :L].reshape(B, NBF, BLK)[:, :, :K]
    delta = torch.einsum("bwk,njk->bnwj", hist, tabs["warm"])
    stats = torch.empty(B, nb_bands, NSTAT, NBF, dtype=torch.float64, device=samples.device)
    for band in range(nb_bands):
        z = torch.zeros(B, L, dtype=torch.float64, device=samples.device)
        for m in range(band_taps):
            z = z + fir[band, m] * xp[:, K - m : K - m + L]
        zb = z.reshape(B, NBF, BLK)
        pieces = (zb[..., K:], zb[..., :K], zb[..., :K] + delta[:, band])
        for p, (v, sign) in enumerate(zip(pieces, (alt[K:], alt[:K], alt[:K]))):
            stats[:, band, 3 * p] = v.sum(dim=-1)
            stats[:, band, 3 * p + 1] = (v * v).sum(dim=-1)
            stats[:, band, 3 * p + 2] = (v * sign).sum(dim=-1)
        del z, zb, pieces
    del xp, hist, delta

    W = C.WINDOW_SIZE
    NF = L // FRAME
    pairs = samples.reshape(B, NF, W, 2).to(torch.int32)
    mono = c_div(pairs[..., 0] + pairs[..., 1], 2).to(torch.float32)
    del pairs
    keep = torch.arange(NF, device=samples.device)[None, :] < n_frames[:, None]
    mono = mono * keep[..., None].to(torch.float32)
    y = mono.reshape(B * NF, W) @ tabs["dft"]
    del mono
    power512 = (y * y).reshape(B, NF, W).sum(dim=1)
    return _assemble(wsum, rownz, stats, power512)


def _assemble(wsum, rownz, stats, power512):
    """Window energies by Parseval, sum_k |X_k|^2 = (W/2) sum y^2 +
    ((sum y)^2 + (sum (-1)^t y)^2) / 2, from the per-block pieces: window w
    spans blocks w and w+1 with its FIR reset at w's start, so its sums are
    reset(w) + tail(w) + head(w+1) + tail(w+1). The 257-bin power is the
    re | im columns' summed squares added, with a zero Nyquist column."""
    NW = stats.shape[-1] - 1
    tail, head, reset = stats[:, :, 0:3], stats[:, :, 3:6], stats[:, :, 6:9]
    win = (reset[..., :NW] + tail[..., :NW]) + (head[..., 1:] + tail[..., 1:])
    sum_y, sum_y2, sum_a = win.unbind(dim=2)  # each [B, NB, NW]
    energies = (C.WINDOW_SIZE / 2) * sum_y2 + (sum_y * sum_y + sum_a * sum_a) / 2.0
    nbins = C.WINDOW_SIZE // 2
    power = power512[:, :nbins] + power512[:, nbins:]
    return wsum, rownz, energies, F.pad(power, (0, 1))


def normalization(samples: torch.Tensor, n_samples: torch.Tensor):
    """The integer mean/variance prepass: (alpha, beta) float32 [B] with
    xn = alpha*s + beta the zero-mean, divided-by-variance signal
    (reference: src/tempo_atk_sort.c:101-114). The mean is a wrapping int32
    sum divided like C; the variance is a float32 sum, truncated."""
    B, L = samples.shape
    s32 = samples.to(torch.int32)
    valid = torch.arange(L, device=samples.device)[None, :] < n_samples[:, None]
    mean = c_div(wrapping_sum_int32(torch.where(valid, s32, 0), dim=1), n_samples)
    d = torch.where(valid, s32 - mean[:, None], 0).to(torch.float32)
    del s32, valid
    var = torch.trunc(torch.sum(d * d, dim=1) / n_samples.to(torch.float32))
    inv = 1.0 / (1 << 15)
    alpha = inv / (var * inv * inv)
    beta = -(mean.to(torch.float32) * inv) / (var * inv * inv)
    return alpha, beta, mean


def fused_all_stats(
    samples: torch.Tensor,
    n_samples: torch.Tensor,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
):
    """samples: int16 [B, L]; n_samples: int32 [B].

    Returns (amp_integral [B], energies [B, NB, NW], power [B, 257]): the
    prepass, the fused call, the trim bounds and the amplitude integral."""
    B, L = samples.shape
    alpha, beta, _ = normalization(samples, n_samples)
    n_frames = torch.div(
        torch.div(n_samples, C.CHANNELS, rounding_mode="floor"),
        C.WINDOW_SIZE, rounding_mode="floor",
    ).to(torch.int32)
    wsum, rownz, energies, power = fused_all_call(
        samples, alpha, beta, n_frames, nb_bands=nb_bands,
        band_taps=band_taps, filterbank=filterbank,
    )
    start, end = trim_bounds_from_rownz(samples, rownz, L)
    trimlen = (end - start + 1).to(torch.float32)
    # Every sample outside [start, end] is a zero of weight exactly 1.
    amp_dot = torch.sum(wsum, dim=1) - (float(wsum.shape[1] * BLK) - trimlen)
    amp_integral = amp_dot * (100.0 / (end - start).to(torch.float32))
    return amp_integral, energies, power
