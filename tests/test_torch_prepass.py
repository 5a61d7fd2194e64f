"""The port's integer prepass (``kernels/fused_stats.prepass_sums``,
``mean_variance``, ``normalization``; its plain version, which a CPU tensor
runs) against NumPy's int64 sums and against ``bliss_tpu``'s two prepasses:
the exact int64 variance of its float64 parity mode and its float32
prepass around the fused kernels."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from bliss_tpu.dsp.intops import c_div as j_c_div

from bliss_tpu_torch.kernels import fused_stats as fs

torch.set_num_threads(1)
L = 1 << 17


def _batch():
    """Eight songs of L = 2^17 samples [B, L] and their valid counts: loud
    noise; constant 32767 and constant -32768, whose int32 sums wrap; a
    silent song; two synthetic songs (tones, noise, clicks), one offset;
    noise with loud samples past n; five samples. Most counts are neither
    L nor a multiple of 8."""
    rng = np.random.default_rng(6)
    x = np.zeros((8, L), np.int16)
    n = np.array([L, L - 3, 70_001, 1000, L - 1029, L - 4094, 99_999, 5], np.int32)
    x[0] = rng.integers(-32768, 32768, size=L)
    x[1] = 32767
    x[2] = -32768
    x[4, : n[4]] = chip_smoke.synth_song(rng, int(n[4]))
    x[5, : n[5]] = np.clip(chip_smoke.synth_song(rng, int(n[5])) // 4 + 700, -32768, 32767)
    x[6] = rng.integers(-32768, 32768, size=L)
    x[7] = rng.integers(-32768, 32768, size=L)
    return x, n


def _valid(n):
    return np.arange(L)[None, :] < n[:, None]


def test_reference_sums_equal_numpy_int64():
    x, n = _batch()
    s = np.where(_valid(n), x.astype(np.int64), 0)
    before = fs.PREPASS_LAUNCHES
    sum_s, sum_s2 = fs.prepass_sums(torch.from_numpy(x), torch.from_numpy(n))
    assert fs.PREPASS_LAUNCHES == before  # no kernel on a CPU tensor
    assert sum_s.dtype == sum_s2.dtype == torch.int64
    assert np.array_equal(sum_s.numpy(), s.sum(axis=1))
    assert np.array_equal(sum_s2.numpy(), (s * s).sum(axis=1))
    assert sum_s[1] > 2**31 and sum_s[2] < -(2**31)  # the int32 sums wrap


def _jax_mean(x, n):
    valid = jnp.asarray(_valid(n))
    s32 = jnp.asarray(x).astype(jnp.int32)
    return j_c_div(jnp.sum(jnp.where(valid, s32, 0), axis=1, dtype=jnp.int32), jnp.asarray(n))


def test_variance_is_bliss_tpu_exact_int64_variance():
    """The float64 parity branch of bliss_tpu/features/tempo.py:279-283
    (the identity of bliss_tpu/features/streaming.py:439-441): the wrapping
    int32 mean, then sum (s - mean)^2 in int64 divided like C."""
    x, n = _batch()
    mean = _jax_mean(x, n)
    valid = jnp.asarray(_valid(n))
    d = jnp.where(valid, jnp.asarray(x) - mean[:, None], 0)
    var = j_c_div(jnp.sum(d.astype(jnp.int64) ** 2, axis=1), jnp.asarray(n).astype(jnp.int64))
    p_mean, p_var = fs.mean_variance(torch.from_numpy(x), torch.from_numpy(n))
    assert p_mean.dtype == torch.int32 and p_var.dtype == torch.int64
    assert np.array_equal(p_mean.numpy(), np.asarray(mean))
    assert np.array_equal(p_var.numpy(), np.asarray(var))
    assert p_var[3] == 0 and (p_var[[0, 4, 5, 6]] > 0).all()


def test_variance_within_one_ulp_of_jax_float32_prepass():
    """bliss_tpu/kernels/fused_stats.py:388-399 (float32 sum of d^2,
    truncated) on the same input: the exact variance, as the float32 the
    port normalizes by, is within one float32 ulp of it on every song whose
    JAX float32 sum of d^2 is itself within an ulp of the exact sum. Where
    that sum drifts further (the constant -32768 song: its mean wrapped, so
    it adds 70 001 equal squares of ~3.8e9), the difference is the drift
    plus at most an ulp. How many songs differ at all follows XLA's order
    of summation, not the port (4 of the 8 on the CPU when this was
    written)."""
    x, n = _batch()
    mean = _jax_mean(x, n)
    valid = jnp.asarray(_valid(n))
    d = jnp.where(valid, jnp.asarray(x).astype(jnp.int32) - mean[:, None], 0).astype(jnp.float32)
    j_sum = np.asarray(jnp.sum(d * d, axis=1)).astype(np.float64)
    j_var = np.asarray(jnp.trunc(jnp.sum(d * d, axis=1) / jnp.asarray(n).astype(jnp.float32)))
    d64 = np.where(_valid(n), x.astype(np.int64) - np.asarray(mean, np.int64)[:, None], 0)
    exact = (d64 * d64).sum(axis=1)
    drift = np.abs(j_sum - exact) / np.spacing(exact.astype(np.float32))
    alpha, beta, _ = fs.normalization(torch.from_numpy(x), torch.from_numpy(n))
    _, p_var = fs.mean_variance(torch.from_numpy(x), torch.from_numpy(n))
    p_var = p_var.numpy().astype(np.float32)
    ulps = np.abs(p_var - j_var) / np.spacing(j_var)
    near = drift <= 1
    assert near.any() and (ulps[near] <= 1).all(), (ulps, drift)
    assert (ulps[~near] <= np.ceil(drift[~near]) + 1).all(), (ulps, drift)
    # a silent song still normalizes to inf/NaN, as before
    assert np.isinf(alpha[3].item()) and not np.isfinite(beta[3].item())
    assert np.isfinite(alpha.numpy()[[0, 1, 2, 4, 5, 6, 7]]).all()


def test_reference_chunks_over_songs():
    """At L = 2^23 the plain version sums two songs a chunk; three songs at
    once give the sums of each song alone."""
    rng = np.random.default_rng(7)
    x = rng.integers(-32768, 32768, size=(3, 1 << 23), dtype=np.int16)
    n = np.array([1 << 23, (1 << 23) - 5, 17], np.int32)
    whole = fs.prepass_sums(torch.from_numpy(x), torch.from_numpy(n))
    for b in range(3):
        one = fs.prepass_sums(torch.from_numpy(x[b : b + 1]), torch.from_numpy(n[b : b + 1]))
        assert int(one[0]) == int(whole[0][b]) and int(one[1]) == int(whole[1][b])


@pytest.mark.parametrize("case", ["dtype", "rank", "n_shape", "n_float"])
def test_prepass_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 64, dtype=torch.int16)
    n = torch.full((2,), 64, dtype=torch.int32)
    if case == "dtype":
        x = x.to(torch.int32)
    elif case == "rank":
        x = x[0]
    elif case == "n_shape":
        n = n[:1]
    else:
        n = n.to(torch.float32)
    with pytest.raises(ValueError):
        fs.prepass_sums(x, n)

