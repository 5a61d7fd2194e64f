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
``csrc/fused_all.cu``'s header).

On a CUDA tensor it launches ``stats_kernel`` (``csrc/stats.cuh``) through
K2's entry point in ``csrc/fused_all.cu``; on a CPU tensor it runs
``fused_stats_reference``, the plain PyTorch version of the same function.
This module also holds what the two-kernel and
single-pass paths share around it: the normalization prepass, the trim
bounds and the amplitude integral.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.intops import c_div, wrap_int32

BLK = C.TEMPO_HOP  # 256
NSTAT = 9  # (sum v, sum v^2, sum (-1)^t v) x (tail, head, reset) per band and block

# Launches of the CUDA kernels on CUDA tensors: stats_kernel, one per
# fused_stats_call; prepass_kernel, one per prepass_sums.
LAUNCHES = 0
PREPASS_LAUNCHES = 0


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
    shared by the entry points of K2 and K1 in ``csrc/fused_all.cu`` and of
    the stage ablation in ``csrc/ablate.cu``, and the outputs it writes,
    stats [B, NB, 9, NBF] in the type of ``tabs["fir"]`` (float64 but for
    the ablation's float32 FIR)."""
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
    stats = torch.empty(B, nb_bands, NSTAT, NBF, dtype=tabs["fir"].dtype, device=dev)
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
    _build.launch("fused_all", "bliss_fused_stats", samples.device, *args)
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
    samples, alpha, beta, halo0=None, *, nb_bands, band_taps, filterbank,
    cheb=True, conv=True, warm=True, fir_dtype=torch.float64,
):
    """What the stats kernel writes, in plain PyTorch: (wsum [B, NBF],
    rownz [B, NBF], stats [B, NB, 9, NBF] in ``fir_dtype``). The FIR runs
    as ``band_taps`` shifted adds and the warm-up correction as an einsum.

    The switches are the stages of ``bliss_tpu_torch.ablate.fused``'s
    ablation, all on for the shipped kernel: ``cheb=False`` sums the raw
    samples as the amplitude weights, ``conv=False`` takes the normalized
    signal as the FIR's output, ``warm=False`` drops the window-reset
    correction (the reset piece equals the head), and ``fir_dtype`` is the
    type of the FIR, the correction and their sums."""
    tabs = device_tables(nb_bands, band_taps, filterbank, samples.device)
    B, L = samples.shape
    NBF = L // BLK
    K = band_taps - 1
    x = samples.to(torch.float32)

    if cheb:
        halfwidth, _, _ = tables.amplitude_cdf_poly()
        w = cheb_T(1000.0 - torch.abs(x + 1.0), tabs["cheb"], float(halfwidth))
    else:
        w = x
    wsum = w.reshape(B, NBF, BLK).sum(dim=-1)
    rownz = (samples != 0).reshape(B, NBF, BLK).any(dim=-1).to(torch.float32)
    del w, x

    xp = normalized_history(samples, alpha, beta, halo0, K, fir_dtype)
    alt = torch.as_tensor(
        tables.parseval_alt_sign()[:BLK], dtype=fir_dtype, device=samples.device
    )
    stats = torch.empty(B, nb_bands, NSTAT, NBF, dtype=fir_dtype, device=samples.device)
    for band in range(nb_bands):
        z, delta = fir_pieces(
            xp, tabs["fir"][band].to(fir_dtype), tabs["warm"][band].to(fir_dtype),
            conv=conv, warm=warm,
        )
        pieces = (z[..., K:], z[..., :K], z[..., :K] + delta)
        for p, (v, sign) in enumerate(zip(pieces, (alt[K:], alt[:K], alt[:K]))):
            stats[:, band, 3 * p] = v.sum(dim=-1)
            stats[:, band, 3 * p + 1] = (v * v).sum(dim=-1)
            stats[:, band, 3 * p + 2] = (v * sign).sum(dim=-1)
        del z, delta, pieces
    return wsum, rownz, stats


# stats_kernel's geometry (csrc/stats.cuh): 32 lanes of 8 samples a hop
# block, runs of RUN hop blocks a warp, a ring of RING normalized samples
# whose block starts at MAX_K
LANES, PER_LANE, RUN, RING, MAX_K = 32, 8, 8, 512, 128


def _butterfly(v: torch.Tensor, width: int, up: bool = True) -> torch.Tensor:
    """``__shfl_xor_sync`` sums over groups of ``width`` lanes (dim -1, a
    power of two) in the kernel's order: offsets 1, 2, ... (delta, the
    tail's groups) or, with ``up=False``, ..., 2, 1 (``warp_sum``)."""
    lane = torch.arange(v.shape[-1], device=v.device)
    offsets = [1 << i for i in range(width.bit_length() - 1)]
    for o in offsets if up else offsets[::-1]:
        v = v + v[..., lane ^ o]
    return v


def _in_turn(v: torch.Tensor) -> torch.Tensor:
    """The sum over dim -1 added in turn, first to last, as one lane does."""
    acc = v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i]
    return acc


def stats_lane_steps(
    samples, alpha, beta, halo0=None, *, nb_bands, band_taps, filterbank,
    cheb=True, conv=True, warm=True, fir_dtype=torch.float64,
):
    """``stats_kernel``'s algorithm step for step in PyTorch, with
    ``block_stats_reference``'s arguments and outputs (wsum [B, NBF], rownz
    [B, NBF], stats [B, NB, 9, NBF]): every warp's run of RUN hop blocks at
    once; in each block lane l's samples 8l .. 8l+7, their amplitude
    weights looked up in the block's table of the Clenshaw series at the
    2 ceil(halfwidth) values of |s+1| around 1000, the warp's ring of
    normalized samples with the run's history loaded once and the previous
    block's tail carried, the FIR as a sliding window of 8 samples a lane
    (one ring read a tap), the per-lane sums over the lane's samples, then
    the warp's sums in the kernel's order (the tail's 4 lanes at a time and
    then a shuffle tree over 8 groups, the head's and reset's added in turn
    over the lanes that hold t < K, wsum by a shuffle tree), and the
    correction delta = M h split over the lanes as the kernel splits it. A
    test tool on no path: it holds the kernel's indexing to the plain
    version on the CPU."""
    tabs = device_tables(nb_bands, band_taps, filterbank, samples.device)
    dev, ft = samples.device, fir_dtype
    B, L = samples.shape
    NBF, K = L // BLK, band_taps - 1
    NR = -(-NBF // RUN)
    xpad = torch.zeros(B, NR * RUN * BLK, dtype=samples.dtype, device=dev)
    xpad[:, :L] = samples
    x = xpad.reshape(B, NR, RUN, LANES, PER_LANE)
    a, be = alpha.to(ft)[:, None, None, None], beta.to(ft)[:, None, None, None]
    lane = torch.arange(LANES, device=dev)
    t = (PER_LANE * lane[:, None] + torch.arange(PER_LANE, device=dev)).expand(LANES, PER_LANE)

    # each run's history, the K samples before its first block
    ring = torch.zeros(B, NR, RING, dtype=ft, device=dev)
    base = MAX_K
    h = (torch.arange(NR, device=dev) * RUN * BLK)[:, None] - K + torch.arange(K, device=dev)
    hist = a[..., 0] * samples[:, h.clamp(min=0)].to(ft) + be[..., 0]
    if halo0 is None:
        before = torch.zeros(B, NR, K, dtype=ft, device=dev)
    else:
        before = a[..., 0] * halo0[:, (h + K).clamp(0, max(K - 1, 0))].to(ft) + be[..., 0]
    ring[..., (base - K + torch.arange(K, device=dev)) % RING] = torch.where(h >= 0, hist, before)

    H = (K + 7) // 8  # lanes holding head samples
    G = 1  # lanes sharing a row of M
    while 2 * G * K <= LANES:
        G *= 2
    g = lane % G
    kc = -(-K // G)
    k0 = (g * kc).clamp(max=K)
    k1 = (k0 + kc).clamp(max=K)
    rstep = LANES // G
    alt = torch.tensor([1.0, -1.0], dtype=ft, device=dev)[t % 2]
    halfwidth = float(tables.amplitude_cdf_poly()[0])
    nw = math.ceil(halfwidth)  # the weight at |s+1| = 1001 - nw + i
    half = cheb_T(torch.arange(nw, dtype=torch.float32, device=dev), tabs["cheb"], halfwidth)
    wtab = torch.cat([half.flip(0), 1.0 - half])

    wsum = torch.zeros(B, NR, RUN, dtype=torch.float32, device=dev)
    rownz = torch.zeros(B, NR, RUN, dtype=torch.float32, device=dev)
    stats = torch.zeros(B, nb_bands, NSTAT, NR, RUN, dtype=ft, device=dev)
    for i in range(RUN):
        s = x[:, :, i].to(torch.float32)  # [B, NR, 32, 8]
        rownz[:, :, i] = (s != 0).flatten(2).any(dim=-1).to(torch.float32)
        if cheb:  # 1 or 0 but at 2 nw values of |s+1| around 1000
            idx = torch.abs(x[:, :, i].to(torch.int32) + 1) - (1001 - nw)
            inside = (idx >= 0) & (idx < 2 * nw)
            w = torch.where(inside, wtab[idx.clamp(0, 2 * nw - 1)], (idx < 0).to(torch.float32))
        else:
            w = s
        ws = w[..., 0]
        for j in range(1, PER_LANE):
            ws = ws + w[..., j]
        wsum[:, :, i] = _butterfly(ws, LANES, up=False)[..., 0]
        xn = a * s.to(ft) + be
        ring[..., (base + t) % RING] = xn

        for band in range(nb_bands):
            if conv:
                f = tabs["fir"][band].to(ft)
                v, z = xn, torch.zeros_like(xn)
                for m in range(band_taps):
                    z = z + f[m] * v
                    new = ring[..., (base + PER_LANE * lane - m - 1) % RING]
                    v = torch.cat([new[..., None], v[..., :-1]], dim=-1)
            else:
                z = xn
            zero = torch.zeros((), dtype=ft, device=dev)
            tl = [zero] * 3
            for j in range(PER_LANE):
                zj, tail = z[..., j], t[:, j] >= K
                tl = [acc + torch.where(tail, v_, zero)
                      for acc, v_ in zip(tl, (zj, zj * zj, alt[:, j] * zj))]
            # lane 8p + q: lanes 4q .. 4q+3 in turn, then the 8 lanes of p
            tl = [_butterfly(_in_turn(v_.unflatten(-1, (8, 4))), 8)[..., 0] for v_ in tl]

            drow = torch.zeros(B, NR, max(K, 1), dtype=ft, device=dev)
            if warm:
                M = tabs["warm"][band].to(ft)
                for r in range(-(-K // rstep)):
                    row = r * rstep + lane // G
                    d = torch.zeros(B, NR, LANES, dtype=ft, device=dev)
                    for kk in range(kc):
                        k = k0 + kk
                        ok = (row < K) & (k < k1)
                        mk = M[row.clamp(max=K - 1), k.clamp(max=K - 1)]
                        hk = ring[..., (base - K + k.clamp(max=K - 1)) % RING]
                        d = d + torch.where(ok, mk * hk, zero)
                    d = _butterfly(d, G)
                    put = (row < K) & (g == 0)
                    drow[..., row[put]] = d[..., put]
            hd = [zero] * 6
            for j in range(PER_LANE):
                tj = t[:, j]
                head = tj < K
                zh = z[..., j]
                y = zh + drow[..., tj.clamp(max=max(K - 1, 0))] if warm else zh
                aj = alt[:, j]
                hd = [acc + torch.where(head, v_, zero) for acc, v_ in
                      zip(hd, (zh, zh * zh, aj * zh, y, y * y, aj * y))]
            hd = [_in_turn(v_[..., :H]) for v_ in hd]
            stats[:, band, :, :, i] = torch.stack(tl + hd, dim=1)
        base += BLK
    return (wsum.reshape(B, -1)[:, :NBF], rownz.reshape(B, -1)[:, :NBF],
            stats.reshape(B, nb_bands, NSTAT, -1)[..., :NBF])


def normalized_history(samples, alpha, beta, halo0, K, dtype):
    """[B, K + L]: the K history samples before sample 0 (``alpha*halo0 +
    beta``, or normalized zero without ``halo0``), then the normalized
    signal ``alpha*s + beta``, in ``dtype``."""
    B = samples.shape[0]
    a, be = alpha.to(dtype)[:, None], beta.to(dtype)[:, None]
    if halo0 is None:
        hist0 = torch.zeros(B, K, dtype=dtype, device=samples.device)
    else:
        hist0 = a * halo0.to(dtype) + be
    return torch.cat([hist0, a * samples.to(dtype) + be], dim=1)


def fir_pieces(xp, fir, warm_mat, *, conv=True, warm=True):
    """(z [B, NBF, 256], delta [B, NBF, K]) of one band from ``xp`` =
    ``normalized_history(...)`` [B, K + L]: the causal FIR z (taps ``fir``
    [K + 1]; ``conv=False``: the signal itself) and each block's window-reset
    correction delta = M h over its first K samples (``warm_mat`` [K, K], h
    the K samples before the block; ``warm=False``: zero)."""
    K = fir.shape[0] - 1
    B, L = xp.shape[0], xp.shape[1] - K
    NBF = L // BLK
    if conv:
        z = torch.zeros(B, L, dtype=xp.dtype, device=xp.device)
        for m in range(K + 1):
            z = z + fir[m] * xp[:, K - m : K - m + L]
    else:
        z = xp[:, K:].clone()
    hist = xp[:, :L].reshape(B, NBF, BLK)[:, :, :K]
    if warm:
        delta = torch.einsum("bwk,jk->bwj", hist, warm_mat)
    else:
        delta = torch.zeros_like(hist)
    return z.reshape(B, NBF, BLK), delta


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


def check_prepass_inputs(samples, n_samples):
    """Raises ValueError unless ``samples`` is int16 [B, L] and
    ``n_samples`` an integer [B] on the same device."""
    if samples.dtype != torch.int16 or samples.dim() != 2 or samples.shape[0] < 1:
        raise ValueError(
            f"samples must be int16 [B, L], got {samples.dtype} {tuple(samples.shape)}"
        )
    if (n_samples.dtype.is_floating_point or n_samples.dtype == torch.bool
            or tuple(n_samples.shape) != samples.shape[:1]):
        raise ValueError(
            f"n_samples must be an integer [{samples.shape[0]}], got "
            f"{n_samples.dtype} {tuple(n_samples.shape)}"
        )
    if n_samples.device != samples.device:
        raise ValueError(f"n_samples is on {n_samples.device}, samples on {samples.device}")


def prepass_chunks(L: int) -> int:
    """Blocks of the prepass kernel per song: one per 2^18 samples."""
    return max(1, min(1024, L >> 18))


def prepass_sums(samples: torch.Tensor, n_samples: torch.Tensor):
    """(sum s, sum s^2), each int64 [B]: exact sums over each song's valid
    samples i < n_samples[b]. On a CUDA tensor it launches
    ``prepass_kernel`` (``csrc/prepass.cuh``; L a multiple of 8, the
    samples 16-byte aligned) and adds its per-block partials; on a CPU
    tensor it runs ``prepass_sums_reference``."""
    check_prepass_inputs(samples, n_samples)
    if samples.device.type == "cpu":
        return prepass_sums_reference(samples, n_samples)
    if samples.device.type != "cuda":
        raise ValueError(f"no kernel for device {samples.device}")
    B, L = samples.shape
    if L % 8 or not samples.is_contiguous() or samples.data_ptr() % 16:
        raise ValueError("samples must be contiguous, 16-byte aligned, L a multiple of 8")
    from bliss_tpu_torch.kernels import _build

    global PREPASS_LAUNCHES
    n32 = n_samples.to(torch.int32).contiguous()
    chunks = prepass_chunks(L)
    part = torch.empty(B, chunks, 2, dtype=torch.int64, device=samples.device)
    _build.launch("fused_all", "bliss_prepass", samples.device, samples.data_ptr(), B, L,
                  n32.data_ptr(), part.data_ptr(), chunks)
    PREPASS_LAUNCHES += 1
    sums = part.sum(dim=1)
    return sums[:, 0], sums[:, 1]


def prepass_sums_reference(samples: torch.Tensor, n_samples: torch.Tensor):
    """Plain PyTorch version of ``prepass_sums``: int64 sums of the masked
    samples and of their int32 squares, a few songs at a time so that the
    temporaries stay near 2^24 elements."""
    check_prepass_inputs(samples, n_samples)
    B, L = samples.shape
    n = n_samples.to(torch.int64)
    idx = torch.arange(L, device=samples.device)
    rows = max(1, (1 << 24) // L)
    s1, s2 = [], []
    for b0 in range(0, B, rows):
        x = samples[b0 : b0 + rows].to(torch.int32)
        x = torch.where(idx[None, :] < n[b0 : b0 + rows, None], x, 0)
        s1.append(x.sum(dim=1, dtype=torch.int64))
        s2.append((x * x).sum(dim=1, dtype=torch.int64))
        del x
    return torch.cat(s1), torch.cat(s2)


def mean_variance(samples: torch.Tensor, n_samples: torch.Tensor):
    """(mean int32 [B], var int64 [B]) as the C reference computes them
    (src/helpers.c bl_mean, bl_variance): the mean a wrapping int32 sum
    divided like C, the variance sum (s - mean)^2 divided like C, exact.
    Both come from the exact sums of s and s^2: the wrapped sum is their low
    32 bits, and sum (s - mean)^2 = sum s^2 - 2 mean sum s + n mean^2, each
    term below 2^56."""
    sum_s, sum_s2 = prepass_sums(samples, n_samples)
    mean = c_div(wrap_int32(sum_s), n_samples)
    m = mean.to(torch.int64)
    n = n_samples.to(torch.int64)
    return mean, c_div(sum_s2 - 2 * m * sum_s + n * m * m, n)


def normalization(samples: torch.Tensor, n_samples: torch.Tensor):
    """The integer mean/variance prepass: (alpha, beta, mean) with alpha,
    beta float32 [B] and xn = alpha*s + beta the zero-mean, divided-by-
    variance signal (reference: src/tempo_atk_sort.c:101-114), from
    ``mean_variance``'s exact integers. A silent song (var = 0) gives
    infinite alpha and NaN or infinite beta."""
    mean, var = mean_variance(samples, n_samples)
    var = var.to(torch.float32)
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
