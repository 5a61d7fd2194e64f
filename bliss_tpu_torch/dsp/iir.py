"""The Butterworth low-pass (counterpart of ``bliss_tpu/dsp/iir.py``).

The reference's filter is a sequential per-sample recurrence
(reference: src/tempo_atk_sort.c:200-218).

- ``lfilter_blocked``: the recurrence is linear, so a block of T steps is
  a dense affine map of (block inputs, incoming state), given by the block
  operators of ``tables.iir_block_operator``. The in-block products of
  every block run as two batched matmuls; only the 6-wide state is carried
  block to block, in a Python loop.
- ``lfilter_scan``: the literal direct-form-II-transposed recurrence, one
  step a sample (``iir_mode="scan"``, a parity mode: a launch or a few a
  step on the GPU).

Both start from zero state, as the reference (registry memset at
src/tempo_atk_sort.c:193-197). On the GPU their float32 matmuls need TF32
off (``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def lfilter_scan(b: np.ndarray, a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Direct-form-II-transposed lfilter of ``x`` [..., T] along its last
    axis, zero initial state, in x's dtype: a Python loop over the T steps,
    each vectorized over the leading axes (rows and bands)."""
    order = len(a) - 1
    bt = torch.as_tensor(np.asarray(b, np.float64), dtype=x.dtype, device=x.device)
    at = torch.as_tensor(np.asarray(a, np.float64), dtype=x.dtype, device=x.device)
    b0, b_rest, a_rest = bt[0], bt[1:], at[1:]
    # z[..., k] carries state k; each step shifts it down one slot, so z
    # keeps one zero slot past the last state
    z = x.new_zeros(*x.shape[:-1], order + 1)
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        u = x[..., t]
        yt = b0 * u + z[..., 0]
        y[..., t] = yt
        # z'[k-1] = b[k] u + z[k] - a[k] y, k = 1..order (z[order] = 0)
        z[..., :order] = b_rest * u[..., None] + z[..., 1:] - a_rest * yt[..., None]
    return y


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
