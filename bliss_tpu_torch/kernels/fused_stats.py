"""Sample statistics of an int16 PCM batch: K2 of the two-kernel configs
(counterpart of ``bliss_tpu/kernels/fused_stats.py``).

``fused_stats_call`` returns, for an int16 PCM batch [B, L]:

- ``wsum`` [B, NBF]: per 256-sample block, the sum of the amplitude weights
  w(s) = T(1000 - |s+1|), T the Chebyshev fit of the smoothing CDF;
- ``rownz`` [B, NBF]: per block, 1.0 if any sample is nonzero;
- ``energies`` [B, NB, NW] float64: per band and 512-sample window (hop
  256), the Parseval energy of the window-reset causal FIR of the
  normalized signal, assembled from per-block sums and warm-up
  corrections.

NBF = L // 256 and NW = NBF - 1. The JAX kernel pads L to a multiple of its
245760-sample chunk, so its outputs are longer before masking. The energies
are float64 (the JAX kernel's are float32) because the tempo peak detector
downstream resolves ~1e-10 relative changes of them on noisy music (see
``csrc/fused_all.cu``).

On a CUDA tensor it launches ``stats_kernel`` of ``csrc/fused_all.cu``; on a
CPU tensor it runs ``fused_stats_reference``, the plain PyTorch version of
the same function. This module also holds what the two-kernel and
single-pass paths share around it: the normalization prepass, the trim
bounds and the amplitude integral.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.intops import c_div, wrapping_sum_int32

BLK = C.TEMPO_HOP  # 256
NSTAT = 9  # (sum v, sum v^2, sum (-1)^t v) x (tail, head, reset) per band and block

# Launches of the CUDA kernel: one per fused_stats_call on a CUDA tensor.
LAUNCHES = 0


def cheb_T(m: torch.Tensor, coeffs, halfwidth: float) -> torch.Tensor:
    """Chebyshev (Clenshaw) evaluation of the smoothing-kernel CDF, positive
    half plus symmetry fold; ``coeffs`` is a 1-D tensor or sequence,
    ascending."""
    neg = m < 0
    mf = torch.where(neg, -m - 1.0, m)
    t = torch.clamp((2.0 * mf - halfwidth) / halfwidth, -1.0, 1.0)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = coeffs[k] + 2.0 * t * b1 - b2, b1
    val = coeffs[0] + t * b1 - b2
    val = torch.where(mf >= halfwidth, torch.ones_like(val), val)
    return torch.where(neg, 1.0 - val, val)


def check_stats_inputs(samples, alpha, beta, halo0, nb_bands, band_taps, multiple):
    """Raises ValueError for inputs the stats kernel does not take: int16
    [B, L] samples with L a positive multiple of ``multiple``, float32 [B]
    alpha and beta, an optional int16 [B, band_taps - 1] halo0, all on one
    device, and 2 <= band_taps <= 129."""
    if samples.dtype != torch.int16 or samples.dim() != 2:
        raise ValueError(
            f"samples must be int16 [B, L], got {samples.dtype} "
            f"{tuple(samples.shape)}"
        )
    B, L = samples.shape
    if B < 1 or L < multiple or L % multiple:
        raise ValueError(f"L must be a positive multiple of {multiple}, got {L}")
    if nb_bands < 1 or not 2 <= band_taps <= 129:
        raise ValueError(
            f"need nb_bands >= 1 and 2 <= band_taps <= 129, got {nb_bands}, {band_taps}"
        )
    checks = [("alpha", alpha, torch.float32, (B,)), ("beta", beta, torch.float32, (B,))]
    if halo0 is not None:
        checks.append(("halo0", halo0, torch.int16, (B, band_taps - 1)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {list(shape)}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != samples.device:
            raise ValueError(f"{name} is on {t.device}, samples on {samples.device}")


def check_conv_mode(conv_mode: str) -> None:
    """The TPU kernel's FIR modes; the port runs the FIR in float64 for
    either."""
    if conv_mode not in ("split", "exact"):
        raise ValueError(f"unknown conv_mode {conv_mode!r}")


def stats_launch_args(samples, alpha, beta, halo0, tabs, nb_bands, band_taps):
    """(args, (wsum, rownz, stats)): the stats kernel's leading arguments,
    shared by the entry points of K2 and K1 in ``csrc/fused_all.cu``, and
    the outputs it writes, stats [B, NB, 9, NBF] float64."""
    if not samples.is_contiguous() or samples.data_ptr() % 16:
        raise ValueError("samples must be contiguous and 16-byte aligned")
    alpha, beta = alpha.contiguous(), beta.contiguous()
    halo0 = None if halo0 is None else halo0.contiguous()
    B, L = samples.shape
    NBF = L // BLK
    dev = samples.device
    halfwidth, _, _ = tables.amplitude_cdf_poly()
    wsum = torch.empty(B, NBF, dtype=torch.float32, device=dev)
    rownz = torch.empty(B, NBF, dtype=torch.float32, device=dev)
    stats = torch.empty(B, nb_bands, NSTAT, NBF, dtype=torch.float64, device=dev)
    args = [
        samples.data_ptr(), B, L, alpha.data_ptr(), beta.data_ptr(),
        None if halo0 is None else halo0.data_ptr(), tabs["cheb"].data_ptr(),
        tabs["cheb"].numel(), float(halfwidth), tabs["fir"].data_ptr(),
        tabs["warm"].data_ptr(), nb_bands, band_taps, wsum.data_ptr(),
        rownz.data_ptr(), stats.data_ptr(),
    ]
    return args, (wsum, rownz, stats)


def fused_stats_call(
    samples: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    halo0: torch.Tensor | None = None,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
    conv_mode: str = "split",
):
    """(wsum [B, NBF], rownz [B, NBF], energies [B, NB, NW] float64) of an
    int16 batch [B, L], L a multiple of 256; ``alpha``/``beta`` float32 [B]
    normalize the signal (xn = alpha*s + beta). ``halo0``: optional int16
    [B, band_taps - 1], the raw samples before sample 0 (a sequence shard
    passes the previous shard's tail); without it that history is
    normalized zero. ``conv_mode`` names the TPU kernel's FIR precision
    ("split" or "exact"); the port computes the FIR in float64 for either."""
    check_conv_mode(conv_mode)
    check_stats_inputs(samples, alpha, beta, halo0, nb_bands, band_taps, BLK)
    if samples.device.type == "cpu":
        return fused_stats_reference(
            samples, alpha, beta, halo0, nb_bands=nb_bands,
            band_taps=band_taps, filterbank=filterbank, conv_mode=conv_mode,
        )
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    from bliss_tpu_torch.kernels import _build

    global LAUNCHES
    tabs = device_tables(nb_bands, band_taps, filterbank, samples.device)
    args, (wsum, rownz, stats) = stats_launch_args(
        samples, alpha, beta, halo0, tabs, nb_bands, band_taps
    )
    _build.launch("bliss_fused_stats", samples.device, *args)
    LAUNCHES += 1
    return wsum, rownz, assemble_energies(stats)


def fused_stats_reference(
    samples: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    halo0: torch.Tensor | None = None,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
    conv_mode: str = "split",
):
    """Plain PyTorch version of ``fused_stats_call``, in the kernel's types
    (float32 amplitude weights, float64 tempo FIR)."""
    check_conv_mode(conv_mode)
    check_stats_inputs(samples, alpha, beta, halo0, nb_bands, band_taps, BLK)
    wsum, rownz, stats = block_stats_reference(
        samples, alpha, beta, halo0, nb_bands=nb_bands, band_taps=band_taps,
        filterbank=filterbank,
    )
    return wsum, rownz, assemble_energies(stats)


def block_stats_reference(
    samples, alpha, beta, halo0=None, *, nb_bands, band_taps, filterbank
):
    """What the stats kernel writes, in plain PyTorch: (wsum [B, NBF],
    rownz [B, NBF], stats [B, NB, 9, NBF] float64). The FIR runs as
    ``band_taps`` shifted adds and the warm-up correction as an einsum."""
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

    a, be = alpha.double()[:, None], beta.double()[:, None]
    if halo0 is None:
        hist0 = torch.zeros(B, K, dtype=torch.float64, device=samples.device)
    else:
        hist0 = a * halo0.double() + be
    xp = torch.cat([hist0, a * x.double() + be], dim=1)  # [B, K + L]
    del x
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
    return wsum, rownz, stats


def assemble_energies(stats: torch.Tensor) -> torch.Tensor:
    """Window energies [B, NB, NW] by Parseval, sum_k |X_k|^2 = (W/2) sum
    y^2 + ((sum y)^2 + (sum (-1)^t y)^2) / 2, from the per-block pieces:
    window w spans blocks w and w+1 with its FIR reset at w's start, so its
    sums are reset(w) + tail(w) + head(w+1) + tail(w+1)."""
    NW = stats.shape[-1] - 1
    tail, head, reset = stats[:, :, 0:3], stats[:, :, 3:6], stats[:, :, 6:9]
    win = (reset[..., :NW] + tail[..., :NW]) + (head[..., 1:] + tail[..., 1:])
    sum_y, sum_y2, sum_a = win.unbind(dim=2)  # each [B, NB, NW]
    return (C.WINDOW_SIZE / 2) * sum_y2 + (sum_y * sum_y + sum_a * sum_a) / 2.0


def normalization(samples: torch.Tensor, n_samples: torch.Tensor):
    """The integer mean/variance prepass: (alpha, beta, mean) with alpha,
    beta float32 [B] and xn = alpha*s + beta the zero-mean, divided-by-
    variance signal (reference: src/tempo_atk_sort.c:101-114). The mean is
    a wrapping int32 sum divided like C; the variance is a float32 sum,
    truncated."""
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


def amplitude_integral(samples: torch.Tensor, wsum: torch.Tensor, rownz: torch.Tensor):
    """[B] smoothed-histogram integral over each song's zero-trimmed span,
    from the unmasked per-block weight sums and nonzero flags."""
    L = samples.shape[1]
    start, end = trim_bounds_from_rownz(samples, rownz, L)
    trimlen = (end - start + 1).to(torch.float32)
    # Every sample outside [start, end] is a zero of weight exactly 1.
    amp_dot = torch.sum(wsum, dim=1) - (float(wsum.shape[1] * BLK) - trimlen)
    return amp_dot * (100.0 / (end - start).to(torch.float32))


def fused_sample_stats(
    samples: torch.Tensor,
    n_samples: torch.Tensor,
    *,
    nb_bands: int = 1,
    band_taps: int = 17,
    filterbank: str = "firwin",
    conv_mode: str = "split",
):
    """samples: int16 [B, L]; n_samples: int32 [B].

    Returns (amp_integral [B], energies [B, NB, NW]): the prepass, the stats
    call, the trim bounds and the amplitude integral."""
    alpha, beta, _ = normalization(samples, n_samples)
    wsum, rownz, energies = fused_stats_call(
        samples, alpha, beta, nb_bands=nb_bands, band_taps=band_taps,
        filterbank=filterbank, conv_mode=conv_mode,
    )
    return amplitude_integral(samples, wsum, rownz), energies


def trim_bounds_from_rownz(samples: torch.Tensor, rownz: torch.Tensor, L0: int):
    """The amplitude zero-trim bounds (first/last nonzero sample index,
    int32 [B] each) from per-256-block nonzero flags plus two per-song block
    gathers. An all-zero song gets (0, L0 - 1)."""
    B = samples.shape[0]
    nbf_data = (L0 + BLK - 1) // BLK
    nz = (rownz[:, :nbf_data] > 0.0).to(torch.int32)
    any_nz = nz.amax(dim=1) > 0
    bf = torch.argmax(nz, dim=1)
    bl = nbf_data - 1 - torch.argmax(nz.flip(1), dim=1)

    pad = nbf_data * BLK - L0
    xp = F.pad(samples, (0, pad)) if pad else samples
    xblk = xp.reshape(B, nbf_data, BLK)
    first_blk = torch.gather(xblk, 1, bf[:, None, None].expand(B, 1, BLK))[:, 0]
    last_blk = torch.gather(xblk, 1, bl[:, None, None].expand(B, 1, BLK))[:, 0]
    inner_f = torch.argmax((first_blk != 0).to(torch.int32), dim=1)
    inner_l = BLK - 1 - torch.argmax((last_blk.flip(1) != 0).to(torch.int32), dim=1)
    start = torch.where(any_nz, bf * BLK + inner_f, torch.zeros_like(bf))
    end = torch.where(any_nz, bl * BLK + inner_l, torch.full_like(bl, L0 - 1))
    return start.to(torch.int32), end.to(torch.int32)
