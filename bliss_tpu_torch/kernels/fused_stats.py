"""Sample-stats helpers shared by the fused kernel's plain version and its
callers (counterpart of ``bliss_tpu/kernels/fused_stats.py``).

The two-kernel sample-stats kernel itself (K2) is not ported yet; the main
path's statistics come from ``kernels/fused_all.py``.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch import constants as C

BLK = C.TEMPO_HOP  # 256


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
    xp = torch.nn.functional.pad(samples, (0, pad)) if pad else samples
    xblk = xp.reshape(B, nbf_data, BLK)
    first_blk = torch.gather(xblk, 1, bf[:, None, None].expand(B, 1, BLK))[:, 0]
    last_blk = torch.gather(xblk, 1, bl[:, None, None].expand(B, 1, BLK))[:, 0]
    inner_f = torch.argmax((first_blk != 0).to(torch.int32), dim=1)
    inner_l = BLK - 1 - torch.argmax((last_blk.flip(1) != 0).to(torch.int32), dim=1)
    start = torch.where(any_nz, bf * BLK + inner_f, torch.zeros_like(bf))
    end = torch.where(any_nz, bl * BLK + inner_l, torch.full_like(bl, L0 - 1))
    return start.to(torch.int32), end.to(torch.int32)
