"""The port's similarity (``bliss_tpu_torch.sim``) against ``bliss_tpu.sim``
on the same inputs: nearest neighbours (one query, and every song by
blocks), playlist order and k-means, exact duplicates and ties included.

Tolerances: direct distances within float32 rounding (1e-6 relative); the
Gram form's d^2 within (D + 4) 2^-23 (|q|^2 + |f|^2) of a float64 brute
force, with indices equal to ``bliss_tpu``'s wherever the gap to the next
candidate is more than twice that; Lloyd's centroids within 1e-5 relative
and its assignments identical, run from ``bliss_tpu``'s own initial
centroids (the two packages' random streams differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bliss_tpu import sim as jsim
from bliss_tpu.sim.distance import _block_topk as jax_block_topk
from bliss_tpu.sim.kmeans import _pp_init as jax_pp_init

from bliss_tpu_torch import sim
from bliss_tpu_torch.sim.distance import _block_topk
from bliss_tpu_torch.sim.kmeans import assign, init_centroids, lloyd

torch.set_num_threads(1)

# exact duplicates planted: rows 60 and 80 copy row 7, row 90 copies row 20
TWINS = {7: (60, 80), 20: (90,)}


def _library(n=100, d=4, seed=0):
    rng = np.random.RandomState(seed)
    f = (rng.randn(n, d) * 5 + np.array([-10, -10, -10, -15, *[0] * (d - 4)])).astype(np.float32)
    for src, dsts in TWINS.items():
        for dst in dsts:
            if dst < n:
                f[dst] = f[src]
    return f


def _groups(n):
    """Sets of rows that hold one vector."""
    return [g for g in ({src, *dsts} for src, dsts in TWINS.items()) if max(g) < n]


@pytest.mark.parametrize("q", [7, 60, 20, 33])
def test_nearest_neighbors_matches_jax(q):
    """Direct distances from a query row (its own row not masked): the seed
    and its exact duplicates at distance 0 come out in index order."""
    f = _library()
    d, i = sim.nearest_neighbors(f, f[q], 6, device="cpu")
    jd, ji = (np.asarray(x) for x in jsim.nearest_neighbors(jnp.asarray(f), jnp.asarray(f[q]), 6))
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-6, atol=0)
    group = next((g for g in _groups(len(f)) if q in g), {q})
    assert i.numpy()[: len(group)].tolist() == sorted(group)
    assert (d.numpy()[: len(group)] == 0).all()


@pytest.mark.parametrize("seed_index", [7, 60, 90, 41])
def test_playlist_order_matches_jax(seed_index):
    """The whole order equals ``bliss_tpu``'s: the seed's exact duplicates
    sit at distance 0 with it, in index order (so row 7 leads row 60's
    playlist), as ``jnp.argsort``'s stable sort leaves them."""
    f = _library()
    order = sim.playlist_order(f, seed_index, device="cpu").numpy()
    np.testing.assert_array_equal(order, np.asarray(jsim.playlist_order(jnp.asarray(f), seed_index)))
    group = next((g for g in _groups(len(f)) if seed_index in g), {seed_index})
    assert order[: len(group)].tolist() == sorted(group)


def _gram_bound(f, rows, cols):
    sq = (f.astype(np.float64) ** 2).sum(-1)
    return (f.shape[1] + 4) * 2.0**-23 * (sq[rows] + sq[cols])


def _check_neighbors(f, d, idx, jd, jidx):
    """d^2 of the port's pairs and of the true k nearest within the Gram
    bound of the float64 brute force; indices equal to ``bliss_tpu``'s and
    the brute force's where the gaps allow; never the query itself."""
    n, k = idx.shape
    f64 = f.astype(np.float64)
    exact = ((f64[:, None, :] - f64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(exact, np.inf)
    rows = np.arange(n)[:, None]
    # ascending d^2, ties by index (lexsort's last key is the primary one)
    order = np.stack([np.lexsort((np.arange(n), exact[r])) for r in range(n)])
    e = np.take_along_axis(exact, order, axis=1)
    bound = _gram_bound(f, rows, idx)
    assert (idx != np.arange(n)[:, None]).all()
    assert (np.abs(d.astype(np.float64) ** 2 - exact[rows, idx]) <= bound).all()
    assert (np.abs(d.astype(np.float64) ** 2 - e[:, :k]) <= _gram_bound(f, rows, order[:, :k])).all()
    padded = np.concatenate([np.full((n, 1), -np.inf), e[:, : k + 1]], axis=1)
    gap = np.minimum(padded[:, 1:-1] - padded[:, :-2], padded[:, 2:] - padded[:, 1:-1])
    clear = gap > 2 * np.maximum(bound, _gram_bound(f, rows, order[:, :k]))
    assert clear.mean() > 0.5, clear.mean()
    np.testing.assert_array_equal(idx[clear], jidx[clear])
    np.testing.assert_array_equal(idx[clear], order[:, :k][clear])
    np.testing.assert_allclose(d, jd, rtol=0, atol=float(np.sqrt(bound.max())))


@pytest.mark.parametrize("n,d,k,block", [(100, 4, 5, 16), (100, 4, 3, 4096), (37, 49, 4, 16)])
def test_nearest_neighbors_all_matches_jax(n, d, k, block):
    f = _library(n, d)
    pd, pi = sim.nearest_neighbors_all(f, k, block=block, device="cpu")
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32 and pd.shape == (n, k)
    jd, ji = (np.asarray(x) for x in jsim.nearest_neighbors_all(f, k, block=block))
    _check_neighbors(f, pd.numpy(), pi.numpy(), jd, ji)
    for g in _groups(n):
        for r in g:  # the other copies first, in index order, as bliss_tpu has them
            twins = sorted(g - {r})
            assert pi.numpy()[r, : len(twins)].tolist() == twins == ji[r, : len(twins)].tolist()
            assert (pd.numpy()[r, : len(twins)] <= 1e-3).all()


@pytest.mark.parametrize("n,k", [(0, 3), (1, 4), (2, 0), (2, -1), (3, 99), (5, 4)])
def test_nearest_neighbors_all_degenerate_sizes_match_jax(n, k):
    """k clamped to n - 1; n == 0 or k <= 0 gives empty [n, 0] results."""
    f = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    pd, pi = sim.nearest_neighbors_all(f, k, device="cpu")
    jd, ji = jsim.nearest_neighbors_all(f, k)
    assert pd.shape == jd.shape and pi.shape == ji.shape
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_block_topk_breaks_ties_by_index():
    """A query block whose d^2 ties with many columns exactly (dyadic
    vectors: every product exact) takes the lowest indices first, as
    ``jax.lax.top_k`` does, whatever the top-k's own order."""
    rng = np.random.RandomState(5)
    f = (rng.randint(-3, 4, size=(300, 4)) / 2).astype(np.float32)
    for row0 in (0, 128):
        q = f[row0 : row0 + 64]
        pd, pi = _block_topk(torch.from_numpy(q).double(), torch.from_numpy(f).double(), row0, 7)
        jd, ji = jax_block_topk(jnp.asarray(q), jnp.asarray(f), row0, 7)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def _blobs(seed, n_per=100, spread=1.5):
    rng = np.random.RandomState(seed)
    centres = np.array([[8, 0, 0, 0], [-8, 0, 0, 0], [0, 8, 0, 0], [0, 0, 8, 3]], np.float64)
    return np.concatenate([rng.randn(n_per, 4) * spread + c for c in centres]).astype(np.float32)


def _jax_init(f, k, seed, init):
    key = jax.random.PRNGKey(seed)
    x = jnp.asarray(f)
    if init == "pp":
        return np.array(jax.jit(jax_pp_init, static_argnums=3)(
            key, x, jnp.sum(x * x, axis=-1), k))
    return f[np.asarray(jax.random.choice(key, f.shape[0], shape=(k,), replace=False))]


@pytest.mark.parametrize("init", ["pp", "random"])
@pytest.mark.parametrize("seed,k,spread", [(0, 4, 1.5), (3, 5, 3.0), (7, 3, 4.0)])
def test_lloyd_from_jax_init_matches_jax(init, seed, k, spread):
    """The port's Lloyd loop from ``bliss_tpu``'s own initial centroids ends
    where ``bliss_tpu.sim.kmeans`` ends."""
    f = _blobs(seed, spread=spread)
    jc, ja = (np.asarray(x) for x in jsim.kmeans(jnp.asarray(f), k=k, seed=seed, init=init))
    start = torch.from_numpy(_jax_init(f, k, seed, init))
    c = lloyd(torch.from_numpy(f), start, iters=100, tol=1e-4)
    a = assign(torch.from_numpy(f), c)
    assert c.dtype == torch.float32
    assert np.abs(c.numpy() - jc).max() <= 1e-5 * np.abs(jc).max()
    np.testing.assert_array_equal(a.numpy(), ja)


def test_lloyd_keeps_an_empty_cluster_and_stops_at_iters():
    f = torch.from_numpy(_blobs(1))
    far = torch.tensor([[100.0, 100, 100, 100]])
    start = torch.cat([f[:3], far])
    one = lloyd(f, start, iters=1)
    assert torch.equal(one[3], far[0])  # no point chose it
    assert not torch.equal(one[:3], start[:3])
    assert torch.equal(lloyd(f, start, iters=0), start)


@pytest.mark.parametrize("init", ["pp", "random"])
def test_kmeans_init_draws_distinct_rows_deterministically(init):
    f = torch.from_numpy(_blobs(2))
    a = init_centroids(f, 12, seed=4, init=init)
    assert torch.equal(a, init_centroids(f, 12, seed=4, init=init))
    assert not torch.equal(a, init_centroids(f, 12, seed=5, init=init))
    rows = {tuple(r) for r in f.numpy().tolist()}
    assert all(tuple(r) in rows for r in a.numpy().tolist())
    assert len({tuple(r) for r in a.numpy().tolist()}) == 12
    c1, a1 = sim.kmeans(f, 12, seed=4, init=init)
    c2, a2 = sim.kmeans(f.numpy(), 12, seed=4, init=init, device="cpu")
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


@pytest.mark.parametrize("seed", range(6))
def test_kmeanspp_recovers_separated_blobs_as_jax(seed):
    """k-means++ finds the four blobs for every seed, as ``bliss_tpu``'s
    does: the same partition up to the labels."""
    f = _blobs(9, spread=0.3)
    _, a = sim.kmeans(f, 4, seed=seed, device="cpu")
    _, ja = jsim.kmeans(jnp.asarray(f), k=4, seed=seed)
    a, ja = a.numpy(), np.asarray(ja)
    assert len(set(zip(a.tolist(), ja.tolist()))) == 4 == len(set(a.tolist()))


def test_kmeans_unknown_init_raises():
    with pytest.raises(ValueError, match="unknown init"):
        sim.kmeans(_blobs(0), 3, init="kmeans||", device="cpu")
    with pytest.raises(ValueError):
        sim.kmeans(_blobs(0)[:2], 3, init="random", device="cpu")


@pytest.mark.parametrize("call", [
    lambda f: sim.nearest_neighbors(f, f[0], 3),
    lambda f: sim.nearest_neighbors_all(f, 3),
    lambda f: sim.playlist_order(f, 0),
    lambda f: sim.kmeans(f, 2),
], ids=["nearest_neighbors", "nearest_neighbors_all", "playlist_order", "kmeans"])
def test_entry_points_default_to_the_gpu(call):
    """A numpy library goes to the GPU unless the caller asks for the CPU;
    without one the call raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(_library(10))
