"""The Butterworth low-pass as a blocked linear recurrence.

The reference's filter is a sequential per-sample recurrence
(reference: src/tempo_atk_sort.c:200-218). It is linear, so a block of T
steps is a dense affine map of (block inputs, incoming state), given by the
block operators of ``tables.iir_block_operator``. The in-block products of
every block run as two batched matmuls; only the 6-wide state is carried
block to block, in a Python loop. Zero initial state, as the reference
(registry memset at src/tempo_atk_sort.c:193-197).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def lfilter_blocked(x: torch.Tensor, ops) -> torch.Tensor:
    """Filter ``x`` [..., T] along its last axis with the block operators
    ``ops = (L, Z, M, N)`` (tensors in x's dtype and device; block size
    ``L.shape[0]``). T is padded up to a multiple of the block internally
    and the padded tail is discarded."""
    L, Z, M, N = ops
    block = L.shape[0]
    T = x.shape[-1]
    pad = (-T) % block
    if pad:
        x = F.pad(x, (0, pad))
    lead = x.shape[:-1]
    nblk = x.shape[-1] // block
    xb = x.reshape(*lead, nblk, block)

    y = xb @ L.T  # in-block response of every block at once
    drive = xb @ M.T  # each block's contribution to the outgoing state
    Nt = N.T
    states = []
    z = torch.zeros(*lead, N.shape[0], dtype=x.dtype, device=x.device)
    for i in range(nblk):
        states.append(z)
        z = drive[..., i, :] + z @ Nt
    y = y + torch.stack(states, dim=-2) @ Z.T
    return y.reshape(*lead, nblk * block)[..., :T]
