"""Whole-library k nearest neighbours on the card: ``csrc/knn.cu``.

``knn_topk(feats, row0, row1, k)`` gives rows ``row0:row1`` of float32
``feats`` [N, D] their k nearest other rows among all N, as
``sim/distance._block_topk`` (the plain version, which the CPU runs) gives
them: float64 products, d^2 rounded to float32, equal d^2 in index order.
Two launches: ``bliss_knn_prep`` (the rows padded to a multiple of 4
columns and their float64 squared norms, span ``knn.norms``) and
``bliss_knn_search`` (every query of the call in one launch, span
``knn.search``). Device memory a call: the padded rows, the norms and the
answers, O(N D + N k).

The kernel takes 1 <= k <= ``K_MAX`` and 1 <= D <= ``D_MAX``
(``takes``); ``sim.distance`` sends anything else on a CUDA tensor through
the plain blocked path.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.utils.profiling import trace_annotation

K_MAX = 32  # a lane's sorted list of keys in shared memory (csrc/knn.cu)
D_MAX = 64  # the query rows' fragments held in registers
# Launches of bliss_knn_search, one per knn_topk that has queries
LAUNCHES = 0


def takes(feats: torch.Tensor, k: int) -> bool:
    """Whether ``knn_topk`` computes the k nearest rows of ``feats``: a
    CUDA tensor [N, D] with 1 <= D <= D_MAX, and 1 <= k <= K_MAX."""
    return feats.device.type == "cuda" and 1 <= feats.shape[1] <= D_MAX and 1 <= k <= K_MAX


def knn_topk(feats: torch.Tensor, row0: int, row1: int, k: int):
    """(distances [row1 - row0, k] float32 ascending, indices int32) of rows
    ``row0:row1`` of float32 ``feats`` [N, D] on a CUDA device, each row's
    own column excluded; 1 <= k <= min(K_MAX, N - 1)."""
    if not takes(feats, k) or feats.dtype != torch.float32 or feats.dim() != 2:
        raise ValueError(
            f"knn_topk takes float32 [N, 1..{D_MAX}] on a CUDA device and 1 <= k <= {K_MAX}, "
            f"got {feats.dtype} {tuple(feats.shape)} on {feats.device}, k={k}")
    n, d = feats.shape
    if k >= n or n >= 2**31 or not 0 <= row0 <= row1 <= n:
        raise ValueError(f"need k < N < 2^31 and 0 <= row0 <= row1 <= N, got k={k}, N={n}, "
                         f"rows {row0}:{row1}")
    from bliss_tpu_torch.kernels import _build

    dev = feats.device
    dist = torch.empty(row1 - row0, k, dtype=torch.float32, device=dev)
    idx = torch.empty(row1 - row0, k, dtype=torch.int32, device=dev)
    if row1 == row0:
        return dist, idx
    feats = feats.contiguous()
    dp = -(-d // 4) * 4
    padded = torch.empty(n, dp, dtype=torch.float32, device=dev)
    norms = torch.empty(n, dtype=torch.float64, device=dev)
    with trace_annotation("knn.norms"):
        _build.launch("knn", "bliss_knn_prep", dev, feats.data_ptr(), n, d, dp,
                      padded.data_ptr(), norms.data_ptr())
    with trace_annotation("knn.search"):
        _build.launch("knn", "bliss_knn_search", dev, padded.data_ptr(), norms.data_ptr(),
                      n, dp, row0, row1 - row0, k, dist.data_ptr(), idx.data_ptr())
    _build.count_launch(globals(), "LAUNCHES")
    return dist, idx
