"""Degenerate songs through the port against ``bliss_tpu`` (the counterpart of
``tests/test_edge_cases.py``): its five inputs (a 700-sample clip, 50 000
silent samples, full-scale samples, a 30 000-sample and a 20 000-sample
clip) and four more (a silent 100 000-sample song, a constant 1234, one
click, and a song of duration 0), at B=1 through ``analyze_batch`` under
``AnalysisConfig(dtype="float64")``, ``for_gpu()`` (against ``for_tpu()``),
``for_parity()`` and the hybrid config. Each row has ``bliss_tpu``'s
NaN/inf pattern and its finite columns within 5e-6 (float64 configs) or
2e-5 (float32 configs, where the two packages' float32 roundings put the
duration-0 song's columns up to 5.7e-6 apart). A constant song's float32 frequency is the log
of a ratio of rounding noise (ROADMAP traps), so it is held to
``for_parity()`` instead. The port's kernels take any length, so a
30 000-sample clip under ``fused_kernel=True`` takes the kernel stage here,
where ``bliss_tpu`` falls back to its XLA path below 65 536 samples; its
beats are ``bliss_tpu``'s and the rest within 1e-4."""

from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features import analyze_batch_hybrid as janalyze_hybrid
from bliss_tpu.features import analyze_batch_jit

from bliss_tpu_torch.config import AnalysisConfig, uses_kernels
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_hybrid
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import fused_all, fused_stats, stft

torch.set_num_threads(1)


CASES = chip_smoke.edge_songs()  # the songs phase 17 (e) runs on the card
CONFIGS = {
    "float64": (JConfig(dtype="float64"), AnalysisConfig(dtype="float64")),
    "for_gpu": (JConfig.for_tpu(), AnalysisConfig.for_gpu()),
    "for_parity": (JConfig.for_parity(), AnalysisConfig.for_parity()),
    "hybrid": (JConfig.for_tpu_hybrid(), AnalysisConfig.for_gpu_hybrid()),
}
TOL = {"float64": 5e-6, "for_parity": 5e-6, "for_gpu": 2e-5, "hybrid": 2e-5}
FREQUENCY = 2


def _jax_row(pcm, dur, name):
    jcfg = CONFIGS[name][0]
    batch = JBatch.from_arrays([pcm], [dur])
    if jcfg.tempo_finish == "host":
        return np.asarray(janalyze_hybrid(batch, jcfg))[0]
    return np.asarray(analyze_batch_jit(batch, jcfg))[0]


def _port_row(pcm, dur, cfg):
    return analyze_batch(PCMBatch.from_arrays([pcm], [dur], device="cpu"), cfg).numpy()[0]


@pytest.fixture(scope="module")
def rows():
    """{(case, config): (bliss_tpu's row, the port's row)}."""
    return {(case, name): (_jax_row(pcm, dur, name), _port_row(pcm, dur, CONFIGS[name][1]))
            for case, (pcm, dur) in CASES.items() for name in CONFIGS}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("case", list(CASES))
def test_the_ports_row_is_bliss_tpus(rows, case, config):
    want, got = rows[case, config]
    assert got.shape == want.shape == (4,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    cols = np.isfinite(want)
    if case == "constant_1234" and config in ("for_gpu", "hybrid"):
        cols[FREQUENCY] = False  # held to for_parity() below
    np.testing.assert_allclose(got[cols], want[cols], rtol=0, atol=TOL[config])


@pytest.mark.parametrize("config", ["for_gpu", "hybrid"])
def test_a_constant_songs_frequency_is_held_to_for_parity(rows, config):
    """c = 1234: the port's float32 frequency is within 5e-3 of both
    packages' for_parity() (observed 3.2e-3), bliss_tpu's float32 one 4.1e-2
    from it; the other columns are held above."""
    jax_parity, port_parity = rows["constant_1234", "for_parity"]
    jax_f32, port_f32 = rows["constant_1234", config]
    assert np.isfinite(port_f32[FREQUENCY]) and np.isfinite(jax_f32[FREQUENCY])
    assert abs(port_parity[FREQUENCY] - jax_parity[FREQUENCY]) <= 5e-6
    assert abs(port_f32[FREQUENCY] - port_parity[FREQUENCY]) <= 5e-3
    assert abs(port_f32[FREQUENCY] - port_parity[FREQUENCY]) <= abs(
        jax_f32[FREQUENCY] - jax_parity[FREQUENCY])


def test_tiny_clip_does_not_crash(rows):
    feats = rows["tiny_clip", "float64"][1]
    # amplitude well-defined; frequency has zero full windows -> NaN;
    # tempo/attack degrade to their affine offsets.
    assert np.isfinite(feats[1])
    assert np.isnan(feats[2])
    assert np.isfinite(feats[0]) and np.isfinite(feats[3])


def test_silent_song_contained(rows):
    for case in ("silent", "silent_100k"):
        feats = rows[case, "float64"][1]
        assert feats.shape == (4,)
        assert not np.isinf(feats).any()


def test_full_scale_samples(rows):
    assert np.isfinite(rows["full_scale", "float64"][1]).all()


def test_duration_0_gives_tempo_inf_in_both(rows):
    for name in CONFIGS:
        want, got = rows["duration_0", name]
        assert np.isposinf(got[0]) and np.isposinf(want[0]) and np.isfinite(got[1:]).all(), name


def _counting(module, name, counts):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return real(*args, **kw)

    return mock.patch.object(module, name, wrapped)


def test_a_short_clip_takes_the_kernel_stage():
    """bliss_tpu's ``test_fused_guard_falls_back_for_short_clips`` holds its
    fused config bit for bit to its plain one on a 30 000-sample clip, as both
    take its XLA path there; the port's kernel config takes K2 and K3 (their
    plain versions on the CPU) on the same clip, with bliss_tpu's beats and
    the rest within 1e-4."""
    pcm, dur = CASES["short_clip"]
    fused_cfg = AnalysisConfig(dtype="float32", amplitude_mode="poly", fused_kernel=True)
    assert uses_kernels(fused_cfg)
    counts = {}
    with _counting(fused_stats, "fused_stats_call", counts), _counting(stft, "stft_power", counts), \
            _counting(fused_all, "fused_all_call", counts):
        got = _port_row(pcm, dur, fused_cfg)
    assert counts == {"fused_stats_call": 1, "stft_power": 1}, counts
    jbatch = JBatch.from_arrays([pcm], [dur])
    want = np.asarray(analyze_batch_jit(jbatch, JConfig(dtype="float32", amplitude_mode="poly",
                                                        fused_kernel=True)))[0]
    plain = np.asarray(analyze_batch_jit(jbatch, JConfig(dtype="float32", amplitude_mode="poly")))[0]
    np.testing.assert_array_equal(want, plain)  # bliss_tpu's XLA fallback
    assert np.isfinite(got).all()
    assert got[0] == want[0]  # the same beat count
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-4)


def test_hybrid_handles_short_clip():
    """bliss_tpu's hybrid path under ``for_tpu()`` on a 20 000-sample clip,
    and the port's under ``for_gpu()``."""
    pcm, dur = CASES["hybrid_short_clip"]
    got = analyze_batch_hybrid(PCMBatch.from_arrays([pcm], [dur], device="cpu"),
                               AnalysisConfig.for_gpu()).numpy()
    want = np.asarray(janalyze_hybrid(JBatch.from_arrays([pcm], [dur]), JConfig.for_tpu()))
    assert got.shape == (1, 4)
    assert np.isfinite(got[0, 0])
    assert got[0, 0] == want[0, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
