"""Song similarity on force vectors (counterpart of
``bliss_tpu/sim/distance.py``).

Scalar semantics follow the reference (Euclidean distance:
src/analyze.c:88-103; cosine similarity: src/analyze.c:127-143). The
all-pairs forms go through one float32 matmul of the Gram matrix; callers
on the GPU keep TF32 off (``torch.backends.cuda.matmul.allow_tf32``, off by
default).

The library-scale forms (``nearest_neighbors_all``; ``kmeans.py``) form the
Gram matrix in float64 and round d^2 to float32: in float32 it carries an
absolute error of about (D + 4) 2^-23 (|q|^2 + |f|^2), which puts two
identical force vectors (|v|^2 ~ 500) up to 0.03 apart at D = 49. They take
numpy arrays or tensors and run on ``device``: by default a tensor's own
device, and the GPU for anything else (RuntimeError without one). On the
GPU ``nearest_neighbors_all`` runs the hand-written k-NN kernel
(``kernels/knn.py``, ``csrc/knn.cu``); ``_block_topk`` is its plain
version, the CPU's route.
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.features.types import resolve_device
from bliss_tpu_torch.kernels import knn
from bliss_tpu_torch.utils.profiling import trace_annotation


def as_device_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; ``device=None`` keeps a tensor where
    it is and puts anything else on the GPU."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def distance(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between force vectors [..., 4]."""
    d = v1 - v2
    return torch.sqrt(torch.sum(d * d, dim=-1))


def cosine_similarity(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between force vectors [..., 4]."""
    num = torch.sum(v1 * v2, dim=-1)
    den = torch.sqrt(torch.sum(v1 * v1, dim=-1)) * torch.sqrt(
        torch.sum(v2 * v2, dim=-1)
    )
    return num / den


def distance_matrix(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs Euclidean distances: [N, 4] x [M, 4] -> [N, M].

    Through the Gram matrix; the diagonal of a self-distance matrix is
    exactly 0 and the matrix exactly symmetric.
    """
    self_pairs = b is None
    if b is None:
        b = a
    sq_a = torch.sum(a * a, dim=-1)
    sq_b = torch.sum(b * b, dim=-1)
    d2 = sq_a[:, None] + sq_b[None, :] - 2.0 * (a @ b.T)
    if self_pairs:
        eye = torch.eye(a.shape[0], dtype=torch.bool, device=a.device)
        d2 = torch.where(eye, torch.zeros_like(d2), d2)
        d2 = torch.maximum(d2, d2.T)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def cosine_similarity_matrix(
    a: torch.Tensor, b: torch.Tensor | None = None
) -> torch.Tensor:
    """All-pairs cosine similarity: [N, 4] x [M, 4] -> [N, M]."""
    if b is None:
        b = a
    an = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    return an @ bn.T


def nearest_neighbors(features, query, k: int, *, device=None):
    """k nearest songs to ``query`` [D] within ``features`` [N, D], by direct
    distances (the query's own row, if present, is not masked).

    Returns (distances [k] ascending, indices [k] int32); equal distances
    keep index order, as ``jax.lax.top_k`` does."""
    feats = as_device_tensor(features, device)
    q = torch.as_tensor(query, dtype=feats.dtype, device=feats.device)
    d, idx = torch.sort(distance(feats, q[None, :]), stable=True)
    return d[:k], idx[:k].to(torch.int32)


def _block_topk(q, feats, row0: int, k: int):
    """Top-k neighbours of query block ``q`` [Q, D] within ``feats`` [N, D]
    (float64), each query's own column (``row0`` + its row) set to +inf:
    d^2 = |q|^2 + |f|^2 - 2 q.f clamped at 0 and rounded to float32, then
    the k smallest of (d^2, index) as int64 keys, so that equal d^2 come out
    in index order (``jax.lax.top_k``'s order). Returns (distances [Q, k]
    float32, indices [Q, k] int32), still on the device.

    Its stages are the spans ``knn.gram`` (q.f), ``knn.d2`` (the norms,
    the assembly, the clamp, the rounding and the diagonal; it sums |f|^2
    over all N rows again in every block, a known repeat), ``knn.keys``,
    ``knn.topk`` and ``knn.unpack``."""
    with trace_annotation("knn.gram"):
        d2 = q @ feats.T
    with trace_annotation("knn.d2"):
        d2.mul_(-2.0).add_(torch.sum(q * q, dim=-1)[:, None]).add_(torch.sum(feats * feats, dim=-1))
        d2 = d2.clamp_min_(0.0).to(torch.float32)
        d2.diagonal(row0).fill_(float("inf"))  # (i, row0 + i): each query's own row
    with trace_annotation("knn.keys"):
        # a non-negative float32's bits order as its value does
        key = d2.view(torch.int32).to(torch.int64)
        del d2
        key.bitwise_left_shift_(32).bitwise_or_(torch.arange(feats.shape[0], device=q.device))
    with trace_annotation("knn.topk"):
        top = torch.topk(key, k, dim=1, largest=False).values
    with trace_annotation("knn.unpack"):
        d2k = top.bitwise_right_shift(32).to(torch.int32).view(torch.float32)
        return torch.sqrt(d2k), top.bitwise_and(0xFFFFFFFF).to(torch.int32)


def topk_rows(feats: torch.Tensor, row0: int, row1: int, k: int, block: int = 4096):
    """Top-k neighbours of rows ``row0:row1`` of float32 ``feats`` [N, D]
    within all N rows, each row's own column excluded: (distances [row1 -
    row0, k] float32, indices int32), on ``feats``' device; 1 <= k <= N - 1.

    Where ``kernels.knn.takes`` it (a CUDA tensor, k <= ``knn.K_MAX``, D <=
    ``knn.D_MAX``), one launch of the hand-written kernel covers every row,
    whatever ``block``. Otherwise, on the CPU and past those bounds, the
    plain path: the rows widened to float64 (span ``knn.widen``), then
    ``_block_topk`` a block of ``block`` queries at a time (peak memory
    O(block * N), ~5 GB a block at N = 100k), the blocks' results
    concatenated on the device (``knn.concat``). Either way a row's answer
    does not depend on which rows share its call."""
    if knn.takes(feats, k):
        return knn.knn_topk(feats, row0, row1, k)
    with trace_annotation("knn.widen"):
        f64 = feats.to(torch.float64)
    parts = [_block_topk(f64[b0 : min(b0 + block, row1)], f64, b0, k) for b0 in range(row0, row1, block)]
    if not parts:
        return (torch.zeros((0, k), dtype=torch.float32, device=feats.device),
                torch.zeros((0, k), dtype=torch.int32, device=feats.device))
    with trace_annotation("knn.concat"):
        return torch.cat([d for d, _ in parts]), torch.cat([i for _, i in parts])


def nearest_neighbors_all(features, k: int, block: int = 4096, *, device=None):
    """Every song's k nearest others: [N, D] -> (dists [N, k] float32,
    idx [N, k] int32), on the device, through ``topk_rows``.

    ``k`` is clamped to N - 1; N == 0 or k <= 0 gives empty [N, 0] results.
    ``block`` bounds the plain path's query blocks (the CPU's, and a CUDA
    tensor's past the kernel's bounds); nothing reads the device."""
    feats = as_device_tensor(features, device, torch.float32)
    n, k = feats.shape[0], min(k, max(feats.shape[0] - 1, 0))
    if n == 0 or k <= 0:
        return (torch.zeros((n, 0), dtype=torch.float32, device=feats.device),
                torch.zeros((n, 0), dtype=torch.int32, device=feats.device))
    return topk_rows(feats, 0, n, k, block)


def playlist_order(features, seed_index: int, *, device=None) -> torch.Tensor:
    """Every song ordered by ascending distance to the seed song (the batch
    form of the reference's python/examples/make_m3u_playlist.py); equal
    distances, the seed's exact duplicates among them, keep index order."""
    feats = as_device_tensor(features, device)
    return torch.argsort(distance(feats, feats[seed_index][None, :]), stable=True)
