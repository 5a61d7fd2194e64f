"""The port's fused_all (its plain version, which a CPU tensor runs) against
bliss_tpu's fused_all_stats in Pallas interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu import constants as C
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.dsp.intops import c_div as j_c_div
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.analyze import _mask_energies as j_mask_energies
from bliss_tpu.kernels.fused_all import fused_all_stats as j_fused_all_stats
from bliss_tpu.kernels.fused_stats import trim_bounds_from_rownz as j_trim
from bliss_tpu.kernels.pallas_stft import frequency_scores_from_power as j_freq

from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.dsp.intops import c_div, wrapping_sum_int32
from bliss_tpu_torch.features.analyze import _mask_energies
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all
from bliss_tpu_torch.kernels import fused_stats
from bliss_tpu_torch.kernels.fused_stats import trim_bounds_from_rownz
from bliss_tpu_torch.kernels.stft import frequency_scores_from_power

torch.set_num_threads(1)
# the plain versions' matmuls in full float32 wherever a GPU runs them
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
JCFG = JConfig.for_tpu()
CFG = AnalysisConfig.for_gpu()


def _arrays():
    """The tests/test_kernels.py:20-26 batch plus a third seeded song of odd
    length with a quieter, offset signal."""
    rng = np.random.RandomState(11)
    a = synth_pcm(rng, 70_000)
    b = rng.randint(-15000, 15000, size=66_000).astype(np.int16)
    b[:100] = 0
    c = (synth_pcm(np.random.RandomState(5), 67_123, amp=3000) + 700).astype(np.int16)
    return [a, b, c], [3, 3, 3]


@pytest.fixture(scope="module")
def ref():
    """JAX outputs, computed once: fused_all_stats (interpret mode), the
    prepass mean, the kernel's own rownz and trim bounds."""
    arrays, durs = _arrays()
    jb = JBatch.from_arrays(arrays, durs)
    amp, energies, power = j_fused_all_stats(jb.samples, jb.n_samples, interpret=True)
    from bliss_tpu.kernels.fused_all import fused_all_call

    s32 = jb.samples.astype(jnp.int32)
    L = jb.samples.shape[1]
    valid = jnp.arange(L)[None, :] < jb.n_samples[:, None]
    mean = j_c_div(
        jnp.sum(jnp.where(valid, s32, 0), axis=1, dtype=jnp.int32), jb.n_samples
    )
    zero = jnp.zeros(len(arrays), jnp.float32)
    wsum, rownz, _, _ = fused_all_call(
        jb.samples, zero + 1.0, zero, zero + 1.0, interpret=True
    )
    start, end = j_trim(jb.samples, rownz, L)
    return {
        "batch": jb,
        "amp": np.asarray(amp),
        "energies": np.asarray(energies),
        "power": np.asarray(power),
        "mean": np.asarray(mean),
        "wsum": np.asarray(wsum),
        "rownz": np.asarray(rownz),
        "start": np.asarray(start),
        "end": np.asarray(end),
    }


@pytest.fixture(scope="module")
def port():
    arrays, durs = _arrays()
    tb = PCMBatch.from_arrays(arrays, durs, device="cpu")
    amp, energies, power = fused_all.fused_all_stats(tb.samples, tb.n_samples)
    _, _, mean = fused_stats.normalization(tb.samples, tb.n_samples)
    return {"batch": tb, "amp": amp, "energies": energies, "power": power, "mean": mean}


def test_prepass_mean_bit_exact(ref, port):
    assert np.array_equal(port["mean"].numpy(), ref["mean"])


def test_mean_wraps_like_c_int():
    """A loud song whose int sum overflows 2^31 wraps exactly as the JAX
    package's int32 sum does."""
    s = np.full((2, 70_000), 32767, np.int16)
    s[1] = -32768
    n = np.array([70_000, 65_000], np.int32)
    valid = np.arange(70_000)[None, :] < n[:, None]
    j = j_c_div(
        jnp.sum(jnp.where(valid, jnp.asarray(s).astype(jnp.int32), 0), axis=1, dtype=jnp.int32),
        jnp.asarray(n),
    )
    _, _, mean = fused_stats.normalization(torch.from_numpy(s), torch.from_numpy(n))
    assert np.array_equal(mean.numpy(), np.asarray(j))
    assert int(np.asarray(j)[0]) != 32767  # the sum really wrapped


@pytest.mark.parametrize("a,b", [(-7, 2), (7, -2), (-7, -2), (6, 4), (0, 3), (-1, 2)])
def test_c_div_truncates(a, b):
    got = int(c_div(torch.tensor([a], dtype=torch.int32), b)[0])
    assert got == int(np.asarray(j_c_div(jnp.int32(a), jnp.int32(b))))
    assert got == int(a / b)


def test_wrapping_sum_int32():
    x = torch.tensor([[2**31 - 1, 1, 5], [-(2**31), -1, 0]], dtype=torch.int32)
    assert wrapping_sum_int32(x, dim=1).tolist() == [-(2**31) + 5, 2**31 - 1]


def test_rownz_and_trim_bounds_identical(ref, port):
    tb = port["batch"]
    L = tb.samples.shape[1]
    x = tb.samples
    zero = torch.zeros(x.shape[0], dtype=torch.float32)
    nf = torch.ones(x.shape[0], dtype=torch.int32)
    wsum, rownz, _, _ = fused_all.fused_all_call(x, zero + 1.0, zero, nf)
    nbf = L // 256
    assert np.array_equal(rownz.numpy(), ref["rownz"][:, :nbf])
    np.testing.assert_allclose(wsum.numpy(), ref["wsum"][:, :nbf], rtol=0, atol=2e-4)
    start, end = trim_bounds_from_rownz(x, rownz, L)
    assert np.array_equal(start.numpy(), ref["start"])
    assert np.array_equal(end.numpy(), ref["end"])


def test_trim_bounds_of_silent_song():
    x = torch.zeros(1, 2048, dtype=torch.int16)
    rownz = torch.zeros(1, 8)
    start, end = trim_bounds_from_rownz(x, rownz, 2048)
    assert (start.item(), end.item()) == (0, 2047)


def test_amplitude_within_2e5(ref, port):
    a_ref = np.float32(C.AMPLITUDE_SCALE) * ref["amp"] + np.float32(C.AMPLITUDE_BIAS)
    a_port = C.AMPLITUDE_SCALE * port["amp"].numpy() + C.AMPLITUDE_BIAS
    np.testing.assert_allclose(a_port, a_ref, atol=2e-5)


def test_masked_energies_within_1e4_relative(ref, port):
    """Compared after masking: the JAX kernel pads L to its tile multiple,
    so its raw window count differs."""
    e_ref = np.asarray(j_mask_energies(ref["batch"], jnp.asarray(ref["energies"]), JCFG))
    e_port = _mask_energies(port["batch"], port["energies"]).numpy()
    assert e_ref.shape == e_port.shape
    rel = np.abs(e_port - e_ref) / (np.abs(e_ref) + 1e-3)
    assert rel.max() < 1e-4


def test_frequency_score_within_1e3(ref, port):
    f_ref = np.asarray(j_freq(jnp.asarray(ref["power"]), JCFG))
    f_port = frequency_scores_from_power(port["power"], CFG).numpy()
    np.testing.assert_allclose(f_port, f_ref, atol=1e-3)
    assert port["power"].shape == (3, 257) and (port["power"][:, -1] == 0).all()


def test_near_silent_highs_match_float64_oracle():
    """tests/test_kernels.py:295-325's signal: a loud low tone over
    near-silent highs, where a coarse spectrum shows in the peak-relative dB.
    The float32 spectrum must stay within 2e-3 of the float64 oracle."""
    n = 2048 * C.WINDOW_SIZE * 2
    t = np.arange(n // 2)
    sig = 24000 * np.sin(2 * np.pi * t / 256.0) + 0.4 * np.sin(2 * np.pi * t / 3.1)
    samples = np.clip(np.repeat(sig, 2), -32768, 32767).astype(np.int16)

    from bliss_tpu import tables as jtables

    pairs = samples.astype(np.int64).reshape(-1, C.WINDOW_SIZE, 2)
    mono = np.fix((pairs[..., 0] + pairs[..., 1]) / 2.0)  # C truncation
    X = np.fft.rfft(mono * jtables.hann_window()[None, :], axis=-1)
    truth = (X.real**2 + X.imag**2).sum(axis=0)
    truth[-1] = 0.0

    x = torch.from_numpy(samples[None, :].copy())
    nf = torch.tensor([n // 2 // C.WINDOW_SIZE], dtype=torch.int32)
    one = torch.ones(1)
    _, _, _, power = fused_all.fused_all_call(x, one, one * 0, nf)
    cfg64 = AnalysisConfig(dtype="float64")
    s_t = float(j_freq(jnp.asarray(truth[None, :]), JConfig(dtype="float64"))[0])
    s_p = float(frequency_scores_from_power(power, cfg64)[0])
    assert abs(s_p - s_t) < 2e-3, (s_p, s_t)


def test_multiband_energies_match_jax():
    """Bands and taps are runtime arguments: the reference author's 5x17
    filterbank against the JAX kernel's multi-band grid."""
    arrays, durs = _arrays()
    arrays = [a[:40_000] for a in arrays[:2]]
    jb = JBatch.from_arrays(arrays, durs[:2])
    _, e_ref, _ = j_fused_all_stats(
        jb.samples, jb.n_samples, interpret=True, nb_bands=5, band_taps=17,
        filterbank="reference5",
    )
    jcfg = JConfig(fused_kernel=True, single_pass=True, filterbank="reference5")
    e_ref = np.asarray(j_mask_energies(jb, e_ref, jcfg))
    tb = PCMBatch.from_arrays(arrays, durs[:2], device="cpu")
    _, e_port, _ = fused_all.fused_all_stats(
        tb.samples, tb.n_samples, nb_bands=5, band_taps=17, filterbank="reference5"
    )
    e_port = _mask_energies(tb, e_port).numpy()
    assert e_port.shape == e_ref.shape == (2, 5, tb.samples.shape[1] // 256)
    rel = np.abs(e_port - e_ref) / (np.abs(e_ref) + 1e-3)
    assert rel.max() < 1e-4


@pytest.mark.parametrize("halo", ["mean", "shard"])
def test_halo0_matches_jax(halo):
    """halo0, the raw history before sample 0, against JAX's
    fused_all_call(..., halo0=...): as the mesh passes it, the clipped
    integer mean to the first shard and the previous shard's last K samples
    to the next (parallel/mesh.py:289-298). rownz identical, wsum within
    2e-4, masked energies within 1e-4 relative, power within 1e-5 of each
    song's peak bin."""
    from bliss_tpu.kernels.fused_all import fused_all_call as j_fused_all_call

    arrays, durs = _arrays()
    jb = JBatch.from_arrays(arrays, durs)
    tb = PCMBatch.from_arrays(arrays, durs, device="cpu")
    alpha, beta, mean = fused_stats.normalization(tb.samples, tb.n_samples)
    B = len(arrays)
    if halo == "mean":
        halo0 = mean.clamp(-32768, 32767).to(torch.int16)[:, None].expand(B, 16).contiguous()
    else:
        S = 16 * 1024
        halo0 = tb.samples[:, S - 16 : S].contiguous()
        jb = JBatch(jb.samples[:, S:], jb.n_samples - S, jb.durations)
        tb = PCMBatch(tb.samples[:, S:].contiguous(), tb.n_samples - S, tb.durations)
    nf = ((tb.n_samples // 2) // 512).to(torch.int32)
    wsum_r, rownz_r, e_ref, p_ref = j_fused_all_call(
        jb.samples, jnp.asarray(alpha.numpy()), jnp.asarray(beta.numpy()),
        jnp.asarray(nf.numpy()), halo0=jnp.asarray(halo0.numpy()), interpret=True,
    )
    wsum, rownz, energies, power = fused_all.fused_all_call(
        tb.samples, alpha, beta, nf, halo0
    )
    nbf = tb.samples.shape[1] // 256
    assert np.array_equal(rownz.numpy(), np.asarray(rownz_r)[:, :nbf])
    np.testing.assert_allclose(wsum.numpy(), np.asarray(wsum_r)[:, :nbf], rtol=0, atol=2e-4)
    e_ref = np.asarray(j_mask_energies(jb, e_ref, JCFG))
    e_port = _mask_energies(tb, energies).numpy()
    assert e_ref.shape == e_port.shape
    assert (np.abs(e_port - e_ref) / (np.abs(e_ref) + 1e-3)).max() < 1e-4
    p_ref = np.asarray(p_ref, np.float64)
    peak = p_ref.max(axis=1, keepdims=True)
    assert (np.abs(power.numpy() - p_ref) / peak).max() < 1e-5


def test_cpu_call_is_the_plain_version(port):
    tb = port["batch"]
    alpha, beta, _ = fused_stats.normalization(tb.samples, tb.n_samples)
    nf = (tb.n_samples // 1024).to(torch.int32)
    before = fused_all.LAUNCHES
    a = fused_all.fused_all_call(tb.samples, alpha, beta, nf)
    b = fused_all.fused_all_reference(tb.samples, alpha, beta, nf)
    assert fused_all.LAUNCHES == before  # no kernel on a CPU tensor
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "case",
    ["dtype", "length", "alpha_shape", "n_frames_dtype", "taps"],
)
def test_call_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 4096, dtype=torch.int16)
    alpha = torch.ones(2)
    beta = torch.zeros(2)
    nf = torch.ones(2, dtype=torch.int32)
    kw = {}
    if case == "dtype":
        x = x.to(torch.int32)
    elif case == "length":
        x = torch.zeros(2, 4096 + 256, dtype=torch.int16)
    elif case == "alpha_shape":
        alpha = torch.ones(3)
    elif case == "n_frames_dtype":
        nf = nf.to(torch.int64)
    elif case == "taps":
        kw = {"band_taps": 130, "nb_bands": 1}
    with pytest.raises(ValueError):
        fused_all.fused_all_call(x, alpha, beta, nf, **kw)
