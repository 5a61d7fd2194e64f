"""Centered box sums via shifted adds.

Replicates the reference's rectangular smoothing filter
(reference: src/tempo_atk_sort.c:19-40) without its running-sum state: a
width-19 'same' box sum is 19 shifted adds, vectorized over the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum_same(x: torch.Tensor, width: int) -> torch.Tensor:
    """sum_{d=-(w//2)..w//2} x[j+d] with zero padding, over the last axis.

    ``width`` must be odd (the reference uses 19).
    """
    if width % 2 == 0:
        raise ValueError("width must be odd")
    half = width // 2
    T = x.shape[-1]
    xp = F.pad(x, (half, half))
    out = xp[..., :T]
    for d in range(1, width):
        out = out + xp[..., d : d + T]
    return out
