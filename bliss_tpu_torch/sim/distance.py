"""Song similarity on force vectors (counterpart of
``bliss_tpu/sim/distance.py``).

Scalar semantics follow the reference (Euclidean distance:
src/analyze.c:88-103; cosine similarity: src/analyze.c:127-143). The
all-pairs forms go through one float32 matmul of the Gram matrix; callers
on the GPU keep TF32 off (``torch.backends.cuda.matmul.allow_tf32``, off by
default).
"""

from __future__ import annotations

import torch


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
