"""The sample statistics with the FIR, the window-reset correction and
the block reductions done as matrix products (counterpart of
``scripts/proto_matred.py``).

``proto_call(x, alpha, beta, cheb_degree, halfwidth)`` computes, for int16
x [B, L], per 256-sample hop block the columns (sum z, sum (-1)^t z,
sum z^2, d1, d2, da, wsum, count of nonzero samples) as float64
[B, NC, NBLK, 8] for NC chunks of ``chunk`` samples, NBLK = chunk // 256:
z is the fp64 causal FIR of the normalized signal (normalized zero before
sample 0; ``taps`` taps, 17 by default, as the script's one band), d1, d2
and da the block head's sums of delta, 2 z delta + delta^2 and (-1)^t delta
for the window-reset correction delta, and wsum the sum of the amplitude
weights under the Chebyshev fit of the smoothing CDF of degree
``cheb_degree`` over +-``halfwidth`` (18/200 is the shipped fit, 14/128 the
script's narrower one).

On a CUDA tensor it launches the kernel A3 (``bliss_matred_stats`` of
``kernels/csrc/ablate.cu``) on the stats kernel's geometry (one warp a hop
block, runs of 8 blocks staged a run ahead, a warp-private ring of
normalized samples): the FIR as fp64 tensor-core products (``mma.sync``
m16n8k8) of the ring, read in place as an im2col matrix, with the banded
Toeplitz matrix of the taps; delta as one product of the correction matrix
with a run's 8 histories; the amplitude weights from a table by sample
value; the sums by shuffles. On a CPU tensor it runs ``matred_reference``, the
plain PyTorch version. ``matred_mma_steps`` runs the kernel's tiles, ring
and sum orders step for step in PyTorch, a test tool on no path: change it
with the kernel. ``numerics_report`` holds ``proto_call`` to the shipped
stats kernel (``fused_stats_call``) as the script did.
"""

from __future__ import annotations

import functools
import math

import torch

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import tables
from bliss_tpu_torch.ablate import probe as _probe
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.kernels import fused_stats as fs

CHUNK = 245760
TAPS = 17

# Launches of the CUDA kernel A3: one per proto_call on a CUDA tensor.
LAUNCHES = 0


@functools.lru_cache(maxsize=8)
def _cheb(cheb_degree: int, halfwidth: int, device) -> tuple[torch.Tensor, float]:
    hw, _, c_pos = tables.amplitude_cdf_poly(cheb_degree, halfwidth)
    return torch.as_tensor(c_pos, dtype=torch.float32, device=device), float(hw)


def _check(x, alpha, beta, cheb_degree, chunk, taps=TAPS):
    fs.check_stats_inputs(x, alpha, beta, None, 1, taps, fs.BLK)
    _probe.rows(x, chunk)
    if not 1 <= cheb_degree + 1 <= 32:
        raise ValueError(f"the kernel takes 1..32 Chebyshev coefficients, got degree {cheb_degree}")


def _layout(out: torch.Tensor, chunk: int) -> torch.Tensor:
    B, NBF, _ = out.shape
    nblk = chunk // fs.BLK
    return out.reshape(B, NBF // nblk, nblk, 8)


def proto_call(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
    cheb_degree: int = 18, halfwidth: int = 200, *, chunk: int = CHUNK, taps: int = TAPS,
) -> torch.Tensor:
    """float64 [B, NC, NBLK, 8] (see the module's docstring)."""
    _check(x, alpha, beta, cheb_degree, chunk, taps)
    if x.device.type == "cpu":
        return matred_reference(x, alpha, beta, cheb_degree, halfwidth, chunk=chunk, taps=taps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    from bliss_tpu_torch.kernels import _build

    B, L = x.shape
    tabs = device_tables(1, taps, "firwin", x.device)
    cheb, hw = _cheb(cheb_degree, halfwidth, torch.device(x.device))
    alpha, beta = alpha.contiguous(), beta.contiguous()
    out = torch.empty(B, L // fs.BLK, 8, dtype=torch.float64, device=x.device)
    _build.launch(
        "ablate", "bliss_matred_stats", x.device, x.data_ptr(), B, L,
        alpha.data_ptr(), beta.data_ptr(), cheb.data_ptr(), cheb.numel(), hw,
        tabs["fir"].data_ptr(), tabs["warm"].data_ptr(), taps, out.data_ptr(),
    )
    _build.count_launch(globals(), "LAUNCHES")
    return _layout(out, chunk)


def selectors(K: int, dtype, device) -> torch.Tensor:
    """[6, 256, 8]: the selector matrices of z, z^2, delta, 2 z delta +
    delta^2 (rows K.. zero), w and the nonzero flags, whose products with
    the pieces [hop blocks, 256] sum them into the 8 columns
    (``scripts/proto_matred.py``'s ``reduce_mats``)."""
    alt = torch.as_tensor(tables.parseval_alt_sign()[: fs.BLK], dtype=dtype, device=device)
    R = torch.zeros(6, fs.BLK, 8, dtype=dtype, device=device)
    R[0, :, 0], R[0, :, 1] = 1.0, alt
    R[1, :, 2] = 1.0
    R[2, :K, 3], R[2, :K, 5] = 1.0, alt[:K]
    R[3, :K, 4] = 1.0
    R[4, :, 6] = 1.0
    R[5, :, 7] = 1.0
    return R


def matred_reference(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
    cheb_degree: int = 18, halfwidth: int = 200, *, chunk: int = CHUNK, taps: int = TAPS,
) -> torch.Tensor:
    """Plain PyTorch version of ``proto_call``: float32 amplitude weights,
    the fp64 FIR and correction of ``fused_stats.fir_pieces``, and each
    piece's float64 product with its selector matrix. As in the kernel, a
    NaN in any piece of a block (a silent song's infinite normalization)
    makes all eight of its columns NaN."""
    _check(x, alpha, beta, cheb_degree, chunk, taps)
    B, L = x.shape
    NBF, K = L // fs.BLK, taps - 1
    tabs = device_tables(1, taps, "firwin", x.device)
    cheb, hw = _cheb(cheb_degree, halfwidth, torch.device(x.device))
    R = selectors(K, torch.float64, x.device)
    xf = x.to(torch.float32)
    w = fs.cheb_T(1000.0 - torch.abs(xf + 1.0), cheb, hw)
    out = w.to(torch.float64).reshape(B, NBF, fs.BLK) @ R[4]
    out += (x != 0).to(torch.float64).reshape(B, NBF, fs.BLK) @ R[5]
    del xf, w
    xp = fs.normalized_history(x, alpha, beta, None, K, torch.float64)
    z, delta = fs.fir_pieces(xp, tabs["fir"][0], tabs["warm"][0])
    del xp
    out += z @ R[0]
    out += (z * z) @ R[1]
    out += delta @ R[2, :K]
    out += ((2.0 * z[..., :K] + delta) * delta) @ R[3, :K]
    return _layout(out, chunk)


# the kernel's geometry (csrc/ablate.cu): lanes, the ring of normalized
# samples (pairs in 16-byte slots) whose block starts at MRING / 2
LANES, MRING = 32, 512


def ring_slot(P: torch.Tensor) -> torch.Tensor:
    """``ring_slot`` of ``csrc/ablate.cu``: the 16-byte slot of ring pair P."""
    P = P & (MRING // 2 - 1)
    return P ^ ((P >> 3) & 3)


def _reduce_scatter(v: torch.Tensor) -> torch.Tensor:
    """The kernel's reduce-scatter of 8 columns over 32 lanes, v [..., 32,
    8] -> [..., 8]: offsets 16, 8 and 4 each halve the columns a lane keeps
    (its own plus its partner's), offsets 2 and 1 add the last; lane 4c
    holds column c."""
    lane = torch.arange(LANES, device=v.device)
    for o in (16, 8, 4):
        half = v.shape[-1] // 2
        hi = ((lane & o) != 0)[:, None]
        other = v[..., lane ^ o, :]  # the partner sends the half this lane keeps
        v = torch.where(hi, v[..., half:], v[..., :half]) + torch.where(
            hi, other[..., half:], other[..., :half])
    v = v[..., 0]
    for o in (2, 1):
        v = v + v[..., lane ^ o]
    return v[..., ::4]


def matred_mma_steps(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
    cheb_degree: int = 18, halfwidth: int = 200, *, chunk: int = CHUNK, taps: int = TAPS,
) -> torch.Tensor:
    """``proto_call``'s kernel step for step in PyTorch, with its arguments
    and output: every warp's run of 8 hop blocks at once; per run delta =
    M [h_0 .. h_7] in the kernel's m16n8k8 tiles and k-steps, and the ring
    loaded with the KE (K rounded up to 8) samples before the run; per block
    the lanes' samples stored to the ring's swizzled slots, the FIR as the
    im2col tiles read from those slots times the banded Toeplitz fragments,
    two tiles of 16 segments, k-step after k-step; each lane's 8 outputs and
    head deltas summed in the kernel's order, its 8 table weights and
    nonzero flags, then the reduce-scatter over the lanes, and a non-finite
    column making all 8 NaN. A test tool: it holds the kernel's indexing to
    the plain version on the CPU."""
    _check(x, alpha, beta, cheb_degree, chunk, taps)
    dev, f64 = x.device, torch.float64
    B, L = x.shape
    NBF, K = L // fs.BLK, taps - 1
    KE, KD = (K + 7) // 8 * 8, (K + 15) // 16 * 16
    nk, RUN = KE // 8 + 1, fs.RUN
    NR = -(-NBF // RUN)
    tabs = device_tables(1, taps, "firwin", dev)
    fir, M = tabs["fir"][0].to(f64), tabs["warm"][0].to(f64)
    cheb, hw = _cheb(cheb_degree, halfwidth, torch.device(dev))
    nw = math.ceil(hw)
    half = fs.cheb_T(torch.arange(nw, dtype=torch.float32, device=dev), cheb, hw)
    wtab = torch.cat([half.flip(0), 1.0 - half])
    lane = torch.arange(LANES, device=dev)
    g, q = lane >> 2, lane & 3
    a, be = alpha.to(f64)[:, None], beta.to(f64)[:, None]

    def xn(pos):  # normalized samples at positions pos [NR, n] (zero before 0)
        v = a[:, :, None] * x[:, pos.clamp(0, L - 1)].to(f64) + be[:, :, None]
        return torch.where(pos >= 0, v, 0.0)

    # T's fragments [nk, 32, 2]: T[8kk + 2q + e][g] = fir[g + KE - (8kk + 2q + e)]
    kk = torch.arange(nk, device=dev)[:, None, None]
    m = g[None, :, None] + KE - (8 * kk + 2 * q[None, :, None] + torch.arange(2, device=dev))
    tfrag = torch.where((m >= 0) & (m < taps), fir[m.clamp(0, K)], 0.0)

    blk0 = torch.arange(NR, device=dev) * RUN
    # delta [B, NR, KD, 8]: per tile of 16 rows of M, k-steps of 8 in turn
    Mp = torch.zeros(KD, (K + 7) // 8 * 8, dtype=f64, device=dev)
    Mp[:K, :K] = M
    k_ = torch.arange(Mp.shape[1], device=dev)
    n_ = torch.arange(RUN, device=dev)
    pos = (blk0[:, None, None] + n_) * fs.BLK - K + k_[:, None]  # [NR, k, n]
    ok = (k_[:, None] < K) & (blk0[:, None, None] + n_ < NBF)
    zero = torch.zeros((), dtype=f64, device=dev)
    H = torch.where(ok, xn(pos.reshape(NR, -1)).reshape(B, NR, -1, RUN), zero)
    delta = torch.zeros(B, NR, KD, RUN, dtype=f64, device=dev)
    for mt in range(KD // 16):
        d = torch.zeros(B, NR, 16, RUN, dtype=f64, device=dev)
        for kd in range(Mp.shape[1] // 8):
            d = d + Mp[16 * mt : 16 * mt + 16, 8 * kd : 8 * kd + 8] @ H[:, :, 8 * kd : 8 * kd + 8]
        delta[:, :, 16 * mt : 16 * mt + 16] = d

    # the ring [B, NR, MRING / 2 slots, 2]: the KE samples before each run
    ring = torch.zeros(B, NR, MRING // 2, 2, dtype=f64, device=dev)
    base = MRING // 2
    e = base - KE + torch.arange(KE, device=dev)
    hist = xn((blk0[:, None] * fs.BLK - KE + torch.arange(KE, device=dev)))
    ring[:, :, ring_slot(e >> 1), e & 1] = hist

    out = torch.zeros(B, NR, RUN, 8, dtype=f64, device=dev)
    xpad = torch.zeros(B, NR * RUN * fs.BLK, dtype=x.dtype, device=dev)
    xpad[:, :L] = x
    xr = xpad.reshape(B, NR, RUN, LANES, 8)
    u_ = torch.arange(2, device=dev)
    i_ = torch.arange(4, device=dev)
    # lane (g, q) holds z[u][i]: output t = 8 (16u + g + 8 (i >> 1)) + 2q + (i & 1)
    t_out = 8 * (16 * u_[:, None, None] + g[None, :, None] + 8 * (i_ >> 1)) + 2 * q[None, :, None] + (i_ & 1)
    sign = torch.tensor([1.0, -1.0], dtype=f64, device=dev)[i_ & 1]
    for n in range(RUN):
        s = xr[:, :, n].to(torch.int32)  # [B, NR, 32, 8]: lane l's samples 8l .. 8l+7
        idx = torch.abs(s + 1) - (1001 - nw)
        inside = (idx >= 0) & (idx < 2 * nw)
        w = torch.where(inside, wtab[idx.clamp(0, 2 * nw - 1)], (idx < 0).to(torch.float32))
        w = w.to(f64)  # float32 weights added in float64, in order
        ws, cnt = w[..., 0], (s[..., 0] != 0).to(f64)
        for j in range(1, 8):
            ws = ws + w[..., j]
            cnt = cnt + (s[..., j] != 0).to(f64)
        xs = a[:, :, None, None] * s.to(f64) + be[:, :, None, None]
        P = (base >> 1) + 4 * lane[:, None] + torch.arange(4, device=dev)  # [32, 4]
        ring[:, :, ring_slot(P)] = xs.reshape(B, NR, LANES, 4, 2)

        z = torch.zeros(B, NR, 2, 16, 8, dtype=f64, device=dev)  # D of each tile
        p0 = ((base - KE) >> 1) + 4 * g + q
        for k in range(nk):
            bt = torch.zeros(8, 8, dtype=f64, device=dev)  # B[kappa][n]
            bt[q, g], bt[q + 4, g] = tfrag[k, :, 0], tfrag[k, :, 1]
            for u in range(2):
                lo = ring[:, :, ring_slot(p0 + 4 * k + 64 * u)]  # [B, NR, 32, 2]
                hi = ring[:, :, ring_slot(p0 + 4 * k + 64 * u + 32)]
                A = torch.zeros(B, NR, 16, 8, dtype=f64, device=dev)
                A[:, :, g, q], A[:, :, g + 8, q] = lo[..., 0], hi[..., 0]
                A[:, :, g, q + 4], A[:, :, g + 8, q + 4] = lo[..., 1], hi[..., 1]
                z[:, :, u] = z[:, :, u] + A @ bt
        zl = z[:, :, u_[:, None, None], g[None, :, None] + 8 * (i_ >> 1), 2 * q[None, :, None] + (i_ & 1)]
        zl = zl.permute(0, 1, 3, 2, 4).reshape(B, NR, LANES, 8)  # [.., lane, 4u + i]
        tl = t_out.permute(1, 0, 2).reshape(LANES, 8)
        sg = sign.repeat(2)
        dv = delta[:, :, tl.clamp(max=KD - 1), n]
        head = tl < K
        v = [zero] * 6
        for c in range(8):
            zc, dc, hc = zl[..., c], dv[..., c], head[:, c]
            v[0] = v[0] + zc
            v[1] = v[1] + sg[c] * zc
            v[2] = v[2] + zc * zc
            v[3] = v[3] + torch.where(hc, dc, zero)
            v[4] = v[4] + torch.where(hc, (2.0 * zc + dc) * dc, zero)
            v[5] = v[5] + torch.where(hc, sg[c] * dc, zero)
        cols = _reduce_scatter(torch.stack(v + [ws, cnt], dim=-1))  # [B, NR, 8]
        bad = ~torch.isfinite(cols).all(dim=-1, keepdim=True)
        out[:, :, n] = torch.where(bad, torch.full_like(cols, float("nan")), cols)
        base += fs.BLK
    return _layout(out.reshape(B, NR * RUN, 8)[:, :NBF].contiguous(), chunk)


def numerics_report(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
    cheb_degree: int = 18, halfwidth: int = 200,
) -> dict:
    """The script's own check (``scripts/proto_matred.py:171-186``) of
    ``proto_call`` against the shipped stats kernel ``fused_stats_call`` on
    the same inputs: the window energies assembled from the columns, their
    largest relative difference (over windows where both are finite), the
    largest difference of the weight sums, and whether the nonzero flags
    agree. A report, not a gate: a narrower fit moves wsum by design."""
    B, L = x.shape
    o = proto_call(x, alpha, beta, cheb_degree, halfwidth, chunk=L)[:, 0]
    wsum0, rownz0, en0 = fs.fused_stats_call(x, alpha, beta)
    s1, sa, s2, d1, d2, da, wsum, count = o.unbind(dim=-1)
    NW = s1.shape[1] - 1
    half = C.WINDOW_SIZE / 2
    en = half * (s2[:, :NW] + s2[:, 1:] + d2[:, :NW]) + (
        (s1[:, :NW] + s1[:, 1:] + d1[:, :NW]) ** 2
        + (sa[:, :NW] + sa[:, 1:] + da[:, :NW]) ** 2
    ) / 2.0
    en0 = en0[:, 0]
    rel = (en - en0).abs() / (en0.abs() + 1e-6)
    rel = rel[torch.isfinite(rel)]
    return {
        "cheb": f"{cheb_degree}/{halfwidth}",
        "energy_max_rel": float(rel.max()) if rel.numel() else float("nan"),
        "wsum_max_diff": float((wsum0.double() - wsum).abs().max()),
        "rownz_agree": bool(((rownz0 > 0) == (count > 0)).all()),
    }
