"""The port's quality benchmark (``bliss_tpu_torch/tools/quality_benchmark.py``)
against ``scripts/quality_benchmark.py`` on the CPU: its copies of
``synth_song``, ``zscore`` and ``retrieval_metrics`` equal the script's; at
6 families x 4 variants x 5 s under the script's config
(``AnalysisConfig(tempo_finish="device_exact")``, the XLA-path stage) its
[24, 49] rows are ``analyze_batch_ext_jit``'s (beat counts identical, the
core columns within 5e-4, the rest within ``EXTENDED_GATES``) and its recall
and separation within 1e-3 of ``bliss_tpu``'s; under ``for_gpu()`` (the
prepass and K1's plain versions here) ``tests/test_quality.py``'s thresholds
hold; the constants ``chip_smoke.py`` holds the card's run to are
``bliss_tpu``'s; ``main`` prints the script's JSON line and needs a GPU
unless it is given ``--device cpu``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features.analyze import analyze_batch_ext_jit

import chip_smoke
from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.extended import EXTENDED_GATES
from bliss_tpu_torch.tools import quality_benchmark as q

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import quality_benchmark as jq  # noqa: E402  (the script imports JAX only in main)

torch.set_num_threads(1)

FAMILIES, VARIANTS, SECONDS = 6, 4, 5.0  # tests/test_quality.py's run
METRICS = ("recall_at_k_core4", "recall_at_k_extended", "separation_core4",
           "separation_extended")
CORE_TOL = 5e-4


def beat_counts(rows, seconds):
    return np.rint((rows[:, 0].astype(np.float64) - C.TEMPO_BIAS) * int(seconds) / C.TEMPO_SCALE)


@pytest.fixture(scope="module")
def jax_run():
    """The script's protocol through ``bliss_tpu``: its songs, its config,
    ``analyze_batch_ext_jit``, its metrics (unrounded)."""
    songs, labels = [], []
    for fam in range(FAMILIES):
        for var in range(VARIANTS):
            songs.append(jq.synth_song(fam, var, SECONDS, np.random.RandomState(1000 * fam + var)))
            labels.append(fam)
    labels = np.asarray(labels)
    batch = JBatch.from_arrays(songs, [int(SECONDS)] * len(songs))
    feats = np.asarray(analyze_batch_ext_jit(batch, JConfig(tempo_finish="device_exact")))
    k = VARIANTS - 1
    rc, sc = jq.retrieval_metrics(feats[:, :4], labels, k)
    re, se = jq.retrieval_metrics(feats, labels, k)
    return {"features": feats, "recall_at_k_core4": rc, "separation_core4": sc,
            "recall_at_k_extended": re, "separation_extended": se}


@pytest.fixture(scope="module")
def port_runs():
    return {"script": q.run(FAMILIES, VARIANTS, SECONDS, device="cpu"),
            "for_gpu": q.run(FAMILIES, VARIANTS, SECONDS, cfg=AnalysisConfig.for_gpu(),
                             device="cpu")}


def test_synth_song_is_the_scripts():
    for fam, var, secs in ((0, 0, 1.0), (3, 2, 2.5), (7, 5, 0.5)):
        got = q.synth_song(fam, var, secs, np.random.RandomState(1000 * fam + var))
        want = jq.synth_song(fam, var, secs, np.random.RandomState(1000 * fam + var))
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)


def test_zscore_and_retrieval_metrics_are_the_scripts():
    rng = np.random.RandomState(5)
    x = rng.randn(30, 7) * np.linspace(0.01, 100.0, 7) + 3.0
    labels = rng.randint(0, 4, size=30)
    np.testing.assert_array_equal(q.zscore(x), jq.zscore(x))
    for k in (1, 3, 6):
        assert q.retrieval_metrics(x, labels, k) == jq.retrieval_metrics(x, labels, k)
    x32 = x.astype(np.float32)
    assert q.retrieval_metrics(x32, labels, 3) == jq.retrieval_metrics(x32, labels, 3)


def test_library_is_the_scripts_songs():
    songs, labels = q.library(2, 3, 0.5)
    assert labels.tolist() == [0, 0, 0, 1, 1, 1]
    for i, s in enumerate(songs):
        fam, var = divmod(i, 3)
        np.testing.assert_array_equal(
            s, jq.synth_song(fam, var, 0.5, np.random.RandomState(1000 * fam + var)))


def test_rows_under_the_scripts_config_are_bliss_tpus(jax_run, port_runs):
    got, want = port_runs["script"]["features"], jax_run["features"]
    assert got.shape == want.shape == (FAMILIES * VARIANTS, 49) and np.isfinite(got).all()
    np.testing.assert_array_equal(beat_counts(got, SECONDS), beat_counts(want, SECONDS))
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], rtol=0, atol=CORE_TOL)
    ext_got, ext_want = got[:, 4:].astype(np.float64), want[:, 4:].astype(np.float64)
    for name, lo, hi, gate in EXTENDED_GATES:
        d = np.abs(ext_got[:, lo:hi] - ext_want[:, lo:hi])
        if lo == 5:  # bpm: in beats
            d = d * int(SECONDS) / 60.0
        assert d.max() <= gate, (name, d.max(), gate)


@pytest.mark.parametrize("config", ["script", "for_gpu"])
def test_metrics_are_bliss_tpus(jax_run, port_runs, config):
    res = port_runs[config]
    for key in METRICS:
        assert abs(res[key] - jax_run[key]) <= 1e-3, (key, res[key], jax_run[key])
    assert (res["songs"], res["families"], res["variants"], res["k"]) == (24, 6, 4, 3)


@pytest.mark.parametrize("config", ["script", "for_gpu"])
def test_extended_beats_core_on_colliding_families(port_runs, config):
    """``tests/test_quality.py:40-43``'s thresholds."""
    res = port_runs[config]
    assert res["recall_at_k_extended"] >= res["recall_at_k_core4"]
    assert res["recall_at_k_extended"] >= 0.8, res
    assert res["separation_extended"] > res["separation_core4"], res
    assert res["extended_wins"] is True


def test_for_gpu_rows_are_the_scripts_configs(port_runs):
    """The kernel config's rows against the XLA-path config's, as phase 17
    (a) holds the card's: beats identical, the core within 5e-4."""
    a, b = port_runs["for_gpu"]["features"], port_runs["script"]["features"]
    np.testing.assert_array_equal(beat_counts(a, SECONDS), beat_counts(b, SECONDS))
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=CORE_TOL)


def test_chip_smokes_constants_are_bliss_tpus(jax_run):
    """``chip_smoke.py`` holds the card's 6 x 4 x 5 s run to these, as it
    cannot import JAX."""
    assert chip_smoke.QUALITY_SIZES[0] == (FAMILIES, VARIANTS, SECONDS)
    assert set(chip_smoke.QUALITY_BLISS_TPU) == set(METRICS)
    for key in METRICS:
        assert abs(chip_smoke.QUALITY_BLISS_TPU[key] - jax_run[key]) <= 1e-6, key


def test_main_prints_the_scripts_line(port_runs, monkeypatch, capsys):
    monkeypatch.setattr(q, "run", lambda *a, **kw: port_runs["script"])
    assert q.main(["--families", "6", "--variants", "4", "--seconds", "5", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "songs", "families", "variants", "k", *METRICS, "extended_wins"]
    res = port_runs["script"]
    assert line["recall_at_k_extended"] == round(res["recall_at_k_extended"], 4)
    assert line["separation_core4"] == round(res["separation_core4"], 3)
    assert line["extended_wins"] is True


def test_main_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("BLISS_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(q, "run", lambda *a, **kw: pytest.fail("ran without a device"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        q.main(["--families", "2"])
