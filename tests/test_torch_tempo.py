"""The port's float64 envelope finish against bliss_tpu's float64 host finish
and its double-single device finish, on the same band energies."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.signal import lfilter

from conftest import synth_pcm
from bliss_tpu import constants as C
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.tempo import band_energies, envelope_finish_host
from bliss_tpu.features.tempo_exact import envelope_finish_device_exact

from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.convert import device_tables
from bliss_tpu_torch.dsp.boxfilter import box_sum_same
from bliss_tpu_torch.dsp.iir import lfilter_blocked
from bliss_tpu_torch.features.tempo import envelope_finish_device

torch.set_num_threads(1)


def _songs():
    """Tonal + noise songs with silent edges (conftest.synth_pcm) and a
    periodic decaying click, so the envelope has real beats."""
    rng = np.random.RandomState(7)
    out = []
    for n, period in ((90_000, 9_000), (81_920, 11_000), (66_561, 7_000)):
        s = synth_pcm(rng, n).astype(np.float64)
        k = np.arange(1_500)
        click = 9000.0 * np.exp(-k / 300.0) * rng.randn(k.size)
        for start in range(n // 50, n - n // 50 - k.size, period):
            s[start : start + k.size] += click
        out.append(np.clip(s, -32768, 32767).astype(np.int16))
    return out


@pytest.fixture(scope="module", params=[1, 5], ids=["1band", "reference5"])
def case(request):
    songs = _songs()
    jb = JBatch.from_arrays(songs, [4, 3, 3])
    if request.param == 1:
        jcfg = JConfig(dtype="float32", amplitude_mode="poly")
    else:
        jcfg = JConfig(dtype="float32", amplitude_mode="poly", filterbank="reference5")
    fa = np.asarray(band_energies(jb, jcfg))  # [B, NB, NBF] float32
    n = np.asarray(jb.n_samples)
    dur = np.asarray(jb.durations)
    host = envelope_finish_host(fa, n, dur, workers=1)
    exact_cfg = JConfig(
        dtype="float32", amplitude_mode="poly", tempo_finish="device_exact",
        filterbank=jcfg.filterbank,
    )
    dev = envelope_finish_device_exact(
        jnp.asarray(fa), jb.n_samples, jb.durations, exact_cfg
    )
    cfg = AnalysisConfig.for_gpu() if request.param == 1 else AnalysisConfig(
        fused_kernel=True, single_pass=True, tempo_finish="device_exact",
        filterbank="reference5",
    )
    port = envelope_finish_device(
        torch.tensor(fa), torch.tensor(n), torch.tensor(dur), cfg
    )
    return {
        "host": [np.asarray(x) for x in host],
        "dev": [np.asarray(x) for x in dev],
        "port": [x.numpy() for x in port],
        "dur": dur,
    }


def _beats(tempo, dur):
    return np.rint((tempo.astype(np.float64) - C.TEMPO_BIAS) * dur / C.TEMPO_SCALE)


def test_beat_counts_identical(case):
    beats = {k: _beats(case[k][0], case["dur"]) for k in ("host", "dev", "port")}
    assert beats["port"].min() > 3  # the clicks make real beats
    assert np.array_equal(beats["port"], beats["host"])
    assert np.array_equal(beats["port"], beats["dev"])
    assert np.array_equal(case["port"][0], case["host"][0])


def test_attack_within_1e6(case):
    np.testing.assert_allclose(case["port"][1], case["host"][1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(case["port"][1], case["dev"][1], rtol=0, atol=1e-6)


def test_zero_duration_gives_the_references_inf_tempo():
    fa = np.abs(np.random.RandomState(3).randn(2, 1, 400)).astype(np.float32) * 1e4
    n = np.array([400 * 256, 300 * 256], np.int32)
    dur = np.array([0, 2], np.int32)
    host_t, host_a = envelope_finish_host(fa, n, dur, workers=1)
    t, a = envelope_finish_device(
        torch.from_numpy(fa), torch.from_numpy(n), torch.from_numpy(dur),
        AnalysisConfig.for_gpu(),
    )
    assert np.array_equal(t.numpy(), host_t)  # inf where duration is 0
    assert torch.isinf(t[0])
    np.testing.assert_allclose(a.numpy(), host_a, rtol=0, atol=1e-6)


def test_other_finishes_are_not_ported():
    fa = torch.zeros(1, 1, 8)
    n = torch.tensor([2048], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        envelope_finish_device(fa, n, n, AnalysisConfig(tempo_finish="host"))


@pytest.mark.parametrize("block,T", [(256, 2000), (256, 512), (64, 777)])
def test_lfilter_blocked_matches_scipy(block, T):
    x = np.random.RandomState(block + T).randn(2, 3, T)
    tabs = device_tables(1, 17, "firwin", "cpu", iir_block=block)
    ops = tuple(tabs[k] for k in ("iir_L", "iir_Z", "iir_M", "iir_N"))
    got = lfilter_blocked(torch.from_numpy(x), ops).numpy()
    want = lfilter(C.BUTTER_B, C.BUTTER_A, x, axis=-1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_box_sum_same():
    x = np.random.RandomState(0).randn(3, 50)
    got = box_sum_same(torch.from_numpy(x), 19).numpy()
    want = np.stack([np.convolve(r, np.ones(19), mode="same") for r in x])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        box_sum_same(torch.from_numpy(x), 4)
