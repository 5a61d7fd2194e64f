"""Plain NumPy reference of whole-library k nearest neighbours, and the
comparison that decides a neighbours cell's ``correct``.

``nearest`` follows ``chip_smoke.py::brute_nearest`` (commit 18c3400): a
float64 Gram picks each query's k + 2 candidates, whose squared distances
are then taken exactly, by differences, and ordered by distance, then
index. ``nearest_float32`` is the control: the same search with the Gram
matrix and the squared distances in float32, the precision below the
float64 that the program's library-scale distances state. It imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np

BLOCK = 256  # queries a block


def exact_d2(f64: np.ndarray, queries: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """[Q, k] squared distances, by differences in float64, of each query
    row to its rows ``idx``."""
    return ((f64[queries][:, None, :] - f64[idx]) ** 2).sum(-1)


def nearest(rows: np.ndarray, queries: np.ndarray, k: int, extra: int = 2):
    """Each query row's k + ``extra`` nearest other rows of ``rows`` [N, D]:
    (exact squared distances [Q, k + extra] ascending, ties by index; their
    indices)."""
    f64 = rows.astype(np.float64)
    sq = (f64 * f64).sum(1)
    es, ids = [], []
    for s in range(0, len(queries), BLOCK):
        q = queries[s : s + BLOCK]
        d2 = sq[q][:, None] + sq[None, :] - 2.0 * (f64[q] @ f64.T)
        d2[np.arange(len(q)), q] = np.inf
        cand = np.argpartition(d2, k + extra, axis=1)[:, : k + extra]
        exact = exact_d2(f64, q, cand)
        order = np.lexsort((cand, exact))  # by d^2, then by index
        es.append(np.take_along_axis(exact, order, 1))
        ids.append(np.take_along_axis(cand, order, 1))
    return np.concatenate(es), np.concatenate(ids)


def nearest_float32(rows: np.ndarray, queries: np.ndarray, k: int):
    """The control: (distances [Q, k] float32, indices [Q, k]) of each
    query's k nearest other rows, d^2 = |q|^2 + |f|^2 - 2 q.f all in
    float32, clamped at 0, ordered by d^2, then index."""
    f = rows.astype(np.float32)
    sq = (f * f).sum(1)
    ds, ids = [], []
    for s in range(0, len(queries), BLOCK):
        q = queries[s : s + BLOCK]
        d2 = np.maximum(sq[q][:, None] + sq[None, :] - np.float32(2.0) * (f[q] @ f.T), np.float32(0))
        d2[np.arange(len(q)), q] = np.inf
        cand = np.argpartition(d2, k, axis=1)[:, :k]
        cd2 = np.take_along_axis(d2, cand, 1)
        order = np.lexsort((cand, cd2))
        ds.append(np.sqrt(np.take_along_axis(cd2, order, 1)))
        ids.append(np.take_along_axis(cand, order, 1))
    return np.concatenate(ds), np.concatenate(ids)


def compare(rows, queries, pairs, ref, answers) -> dict:
    """The numbers that decide ``correct`` over ``answers``, a list of
    (distances [Q, k], indices [Q, k]) of the query rows ``queries``, one
    for each call compared; ``ref`` is ``nearest``'s result for them and
    ``pairs`` [P, 2] the planted (source, copy) rows, all of whose rows are
    among the queries:

    - ``dist_err``: the largest of the gaps, at each rank, between the
      distance returned and the exact distance of the pair returned, and
      between that and the true distance at that rank; in units of
      sqrt(|q|^2 + |f|^2), the scale of the rounding in the Gram form;
    - ``self_hits``: queries that got their own row back;
    - ``twin_miss``: planted rows whose first neighbour is not their twin;
    - ``answers``: the calls compared.
    """
    f64 = rows.astype(np.float64)
    sq = (f64 * f64).sum(1)
    k = answers[0][1].shape[1]
    ref_d = np.sqrt(ref[0][:, :k])
    ref_scale = np.sqrt(sq[queries][:, None] + sq[ref[1][:, :k]])
    pos = {int(r): i for i, r in enumerate(queries)}
    twin_rows = np.array([pos[int(r)] for r in pairs.ravel()], np.int64)
    twins = pairs[:, ::-1].ravel()
    out = {"dist_err": 0.0, "self_hits": 0, "twin_miss": 0, "answers": len(answers)}
    for d, idx in answers:
        idx = idx.astype(np.int64)
        if not (np.all((idx >= 0) & (idx < len(rows))) and np.all(np.isfinite(d))):
            return dict(out, dist_err=np.inf)
        got = np.sqrt(exact_d2(f64, queries, idx))
        scale = np.sqrt(sq[queries][:, None] + sq[idx])
        pair = float((np.abs(d.astype(np.float64) - got) / scale).max())
        rank = float((np.abs(got - ref_d) / ref_scale).max())
        out["dist_err"] = max(out["dist_err"], pair, rank)
        out["self_hits"] += int((idx == queries[:, None]).sum())
        out["twin_miss"] += int((idx[twin_rows, 0] != twins).sum())
    return out
