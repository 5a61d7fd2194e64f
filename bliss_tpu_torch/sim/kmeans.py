"""k-means clustering over force vectors (counterpart of
``bliss_tpu/sim/kmeans.py``): library radio and auto-playlists.

- init: k-means++ (Arthur & Vassilvitskii 2007), each next seed drawn in
  proportion to its squared distance from the seeds chosen so far, or k
  rows drawn without replacement. The draws come from a ``torch.Generator``
  on the features' device seeded with ``seed``, so they are not
  ``jax.random``'s: a seed picks other rows than in ``bliss_tpu``.
- Lloyd iterations (``lloyd``): assign by argmin over an [N, K] distance
  product, update by a one-hot product; an empty cluster keeps its
  centroid. The loop stops when the largest centroid shift is <= ``tol``
  or after ``iters`` steps, reading the shift on the host once a step.

The distance and the update products run in float64 and the centroids are
kept in the features' dtype, so that a run gives the same centroids and
assignments on the GPU and on the CPU (see ``distance.py``'s note on the
Gram form's error).
"""

from __future__ import annotations

import torch

from bliss_tpu_torch.sim.distance import as_device_tensor


def _dist2(f64, sq_f, cents):
    """Squared Euclidean distances [N, K] via one float64 matmul."""
    c = cents.to(torch.float64)
    return sq_f[:, None] - 2.0 * (f64 @ c.T) + torch.sum(c * c, dim=-1)[None, :]


def _pp_init(gen, features, f64, sq_f, k):
    """k-means++ seeding: [k, D] rows of ``features``. Each draw is in
    proportion to max(mind2, 1e-30), as ``jax.random.categorical`` over
    log(max(mind2, 1e-30)) draws."""
    n = features.shape[0]
    idx = torch.empty(k, dtype=torch.int64, device=features.device)
    idx[:1] = torch.randint(n, (1,), generator=gen, device=features.device)
    mind2 = _dist2(f64, sq_f, f64[idx[:1]])[:, 0].clamp_min(0.0)
    for ki in range(1, k):
        idx[ki : ki + 1] = torch.multinomial(mind2.clamp_min(1e-30), 1, generator=gen)
        mind2 = torch.minimum(mind2, _dist2(f64, sq_f, f64[idx[ki : ki + 1]])[:, 0].clamp_min(0.0))
    return features[idx]


def init_centroids(features: torch.Tensor, k: int, seed: int = 0, init: str = "pp") -> torch.Tensor:
    """The [k, D] initial centroids of ``kmeans``: rows of ``features``
    chosen by k-means++ (``init="pp"``) or uniformly without replacement
    (``init="random"``)."""
    gen = torch.Generator(device=features.device).manual_seed(seed)
    if init == "pp":
        f64 = features.to(torch.float64)
        return _pp_init(gen, features, f64, torch.sum(f64 * f64, dim=-1), k)
    if init == "random":
        if k > features.shape[0]:
            raise ValueError(f"k={k} rows without replacement from {features.shape[0]}")
        perm = torch.randperm(features.shape[0], generator=gen, device=features.device)
        return features[perm[:k]]
    raise ValueError(f"unknown init {init!r}: use 'pp' or 'random'")


def lloyd_step(f64, sq_f, cents):
    """One Lloyd step: each point to its nearest centroid, each centroid to
    the mean of its points; an empty cluster keeps its centroid."""
    k = cents.shape[0]
    assign = torch.argmin(_dist2(f64, sq_f, cents), dim=-1)
    onehot = (assign[:, None] == torch.arange(k, device=f64.device)).to(torch.float64)
    counts = torch.sum(onehot, dim=0)
    new = ((onehot.T @ f64) / counts.clamp_min(1.0)[:, None]).to(cents.dtype)
    return torch.where(counts[:, None] > 0, new, cents)


def lloyd(features: torch.Tensor, centroids: torch.Tensor, iters: int = 100, tol: float = 1e-4):
    """Lloyd iterations from ``centroids`` [k, D] over ``features`` [N, D],
    until the largest centroid shift is <= ``tol`` or after ``iters`` steps
    (``bliss_tpu``'s while loop; one read of the shift a step)."""
    f64 = features.to(torch.float64)
    sq_f = torch.sum(f64 * f64, dim=-1)
    cents = centroids.to(features.dtype)
    for _ in range(iters):
        new = lloyd_step(f64, sq_f, cents)
        shift = float(torch.max(torch.abs(new - cents)))
        cents = new
        if not shift > tol:
            break
    return cents


def assign(features: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N] index of each point's nearest centroid (the first on a tie)."""
    f64 = features.to(torch.float64)
    return torch.argmin(_dist2(f64, torch.sum(f64 * f64, dim=-1), centroids), dim=-1)


def kmeans(features, k: int, iters: int = 100, seed: int = 0, tol: float = 1e-4,
           init: str = "pp", *, device=None):
    """Cluster [N, D] features into k groups on ``device`` (a tensor's own
    device by default, the GPU for anything else). Returns (centroids
    [k, D], assignments [N]). ``init``: "pp" (k-means++, default) or
    "random"."""
    feats = as_device_tensor(features, device)
    cents = lloyd(feats, init_centroids(feats, k, seed, init), iters, tol)
    return cents, assign(feats, cents)
