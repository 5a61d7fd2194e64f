"""The generators' determinism by seed, the plain references against the
literal versions they were copied from, and the spread arithmetic."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch

from portbench import generators, spread
from portbench.reference import analysis, knn


def test_song_lengths_are_one_set_for_every_seed():
    a = generators.song_lengths(128, 6_000_000, 1 << 23)
    assert a.min() >= 6_000_000 and a.max() <= 1 << 23 and (a % 2 == 0).all()
    assert len(np.unique(a)) == 128


def test_songs_repeat_by_seed_and_differ_across_seeds():
    lengths = generators.song_lengths(3, 20_000, 30_000)
    a = generators.songs(lengths, 2**31 + 77, "cpu", chunk=2)
    b = generators.songs(lengths, 2**31 + 77, "cpu", chunk=2)
    c = generators.songs(lengths, 2**31 + 78, "cpu", chunk=2)
    assert a.dtype == np.int16 and a.shape == (3, 30_000)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    for row, n in zip(a, lengths):
        lead = n // 50
        assert not row[n:].any() and not row[:lead].any() and not row[n - lead : n].any()
        assert np.abs(row[lead : n - lead]).max() > 1000


def test_library_rows_repeat_by_seed_and_plant_copies():
    kw = dict(centres=8, centre_mean=-8.0, centre_sd=6.0, noise_sd=3.0, dupes=5)
    a, pa = generators.library_rows(200, 7, 3_000_000_001, "cpu", **kw)
    b, pb = generators.library_rows(200, 7, 3_000_000_001, "cpu", **kw)
    c, _ = generators.library_rows(200, 7, 3_000_000_002, "cpu", **kw)
    assert a.dtype == torch.float32 and a.shape == (200, 7)
    assert torch.equal(a, b) and np.array_equal(pa, pb) and not torch.equal(a, c)
    assert len(np.unique(pa)) == 10
    assert torch.equal(a[pa[:, 0]], a[pa[:, 1]])


def _literal_energies(normalized, n_windows):
    """``oracle.py``'s envelope loop over its 256-sample hops, as it stands
    at 18c3400."""
    from scipy.signal import lfilter

    out = np.zeros(n_windows, np.float64)
    for w in range(n_windows):
        y = lfilter(analysis.FIR_COEFFS, [1.0], normalized[w * 256 : w * 256 + 512])
        X = np.fft.rfft(y)
        sf = np.float32(0.0)
        for v in X.real * X.real + X.imag * X.imag:
            sf = np.float32(np.float64(sf) + v)
        out[w] = np.float64(sf)
    return out


def test_window_energies_are_the_literal_loop_or_float64_sums():
    rng = np.random.default_rng(3)
    for n in (120_000, 250_001 * 2):
        song = generators.songs(np.array([n]), int(rng.integers(1 << 40)), "cpu")[0].astype(np.int64)
        normalized = (song - song.mean()) / (song.var() + 1.0)
        n_windows = -(-(n - n % 512 - 512) // 256)
        got = analysis.window_energies(normalized, n_windows, c_sums=True)
        assert np.array_equal(got.astype(np.float64), _literal_energies(normalized, n_windows))
        f64 = analysis.window_energies(normalized, n_windows)
        assert f64.dtype == np.float64
        # a float32 running sum of 257 bins is within 257 roundings of the float64 sum
        assert np.allclose(f64, got, rtol=257 * 2.0**-24, atol=0) and not np.array_equal(f64, got)


def test_force_vector_of_a_known_song():
    song = generators.songs(np.array([300_000]), 11, "cpu")[0]
    row = analysis.force_vector(song, 6)
    assert np.isfinite(row).all() and row[0] == np.float32(row[0])
    assert analysis.force_vector(song, 6).tolist() == row.tolist()


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, -3.0e-3, np.inf, np.nan], np.float64)
    r = analysis.to_bfloat16(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0078125  # ties to even, then up
    assert abs(r[3] / x[3] - 1) < 2**-8 and np.isinf(r[4]) and np.isnan(r[5])
    assert r.dtype == np.float64


def test_knn_reference_is_the_full_sort():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((300, 6)).astype(np.float32)
    rows[7] = rows[3]
    queries = np.array([0, 3, 7, 150, 299])
    d2, idx = knn.nearest(rows, queries, 4)
    f = rows.astype(np.float64)
    for q, drow, irow in zip(queries, d2, idx):
        full = ((f - f[q]) ** 2).sum(1)
        full[q] = np.inf
        order = np.lexsort((np.arange(len(f)), full))[:6]
        assert irow.tolist() == order.tolist()
        assert np.allclose(drow, full[order], rtol=0, atol=0)


def test_spreads_follow_statistics_quantiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.0, 12.0]
    s = spread.spreads(v)
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert s["median"] == statistics.median(v) and s["n"] == 6
    assert s["iqr"] == pytest.approx((q3 - q1) / s["median"])
    kept = [10.0, 10.2, 9.9, 10.1, 10.0]
    q1, _, q3 = statistics.quantiles(kept, n=4)
    assert s["iqr_drop"] == pytest.approx((q3 - q1) / s["median"])
    assert s["range_drop"] == pytest.approx(0.3 / s["median"])
    assert spread.drop_farthest([1.0, 5.0, 2.0]) == [1.0, 2.0]
