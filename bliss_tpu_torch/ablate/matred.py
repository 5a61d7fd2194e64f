"""The sample statistics with every block reduction done as a matrix
product (counterpart of ``scripts/proto_matred.py``).

``proto_call(x, alpha, beta, cheb_degree, halfwidth)`` computes, for int16
x [B, L], per 256-sample hop block the columns (sum z, sum (-1)^t z,
sum z^2, d1, d2, da, wsum, count of nonzero samples) as float64
[B, NC, NBLK, 8] for NC chunks of ``chunk`` samples, NBLK = chunk // 256:
z is the fp64 causal FIR of the normalized signal (normalized zero before
sample 0), d1, d2 and da the block head's sums of delta, 2 z delta +
delta^2 and (-1)^t delta for the window-reset correction delta, and wsum
the sum of the amplitude weights under the Chebyshev fit of the smoothing
CDF of degree ``cheb_degree`` over +-``halfwidth`` (18/200 is the shipped
fit, 14/128 the script's narrower one).

On a CUDA tensor it launches the kernel A3 (``bliss_matred_stats`` of
``kernels/csrc/ablate.cu``), which sums each block's pieces as fp64
tensor-core products (``mma.sync`` m8n8k4) by selector matrices of ones and
alternating signs; on a CPU tensor it runs ``matred_reference``, the plain
PyTorch version. ``numerics_report`` holds it to the shipped stats kernel
(``fused_stats_call``) as the script did.
"""

from __future__ import annotations

import functools

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


def _check(x, alpha, beta, cheb_degree, chunk):
    fs.check_stats_inputs(x, alpha, beta, None, 1, TAPS, fs.BLK)
    _probe.rows(x, chunk)
    if not 1 <= cheb_degree + 1 <= 32:
        raise ValueError(f"the kernel takes 1..32 Chebyshev coefficients, got degree {cheb_degree}")


def _layout(out: torch.Tensor, chunk: int) -> torch.Tensor:
    B, NBF, _ = out.shape
    nblk = chunk // fs.BLK
    return out.reshape(B, NBF // nblk, nblk, 8)


def proto_call(
    x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
    cheb_degree: int = 18, halfwidth: int = 200, *, chunk: int = CHUNK,
) -> torch.Tensor:
    """float64 [B, NC, NBLK, 8] (see the module's docstring)."""
    _check(x, alpha, beta, cheb_degree, chunk)
    if x.device.type == "cpu":
        return matred_reference(x, alpha, beta, cheb_degree, halfwidth, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    from bliss_tpu_torch.kernels import _build

    global LAUNCHES
    B, L = x.shape
    tabs = device_tables(1, TAPS, "firwin", x.device)
    cheb, hw = _cheb(cheb_degree, halfwidth, torch.device(x.device))
    alpha, beta = alpha.contiguous(), beta.contiguous()
    out = torch.empty(B, L // fs.BLK, 8, dtype=torch.float64, device=x.device)
    _build.launch(
        "ablate", "bliss_matred_stats", x.device, x.data_ptr(), B, L,
        alpha.data_ptr(), beta.data_ptr(), cheb.data_ptr(), cheb.numel(), hw,
        tabs["fir"].data_ptr(), tabs["warm"].data_ptr(), TAPS, out.data_ptr(),
    )
    LAUNCHES += 1
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
    cheb_degree: int = 18, halfwidth: int = 200, *, chunk: int = CHUNK,
) -> torch.Tensor:
    """Plain PyTorch version of ``proto_call``: float32 amplitude weights,
    the fp64 FIR and correction of ``fused_stats.fir_pieces``, and each
    piece's float64 product with its selector matrix. As in the kernel, a
    NaN in any piece of a block (a silent song's infinite normalization)
    makes all eight of its columns NaN."""
    _check(x, alpha, beta, cheb_degree, chunk)
    B, L = x.shape
    NBF, K = L // fs.BLK, TAPS - 1
    tabs = device_tables(1, TAPS, "firwin", x.device)
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
