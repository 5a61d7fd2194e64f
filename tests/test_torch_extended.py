"""The port's extended features (``bliss_tpu_torch/features/extended.py``)
against ``bliss_tpu``'s on the CPU, at B=4, L=131072 (``bliss_tpu`` takes its
fused Pallas path there, in interpret mode): ``extended_features``,
``analyze_batch_ext`` under the main and two-kernel configs, the hybrid path
against ``bliss_tpu``'s hybrid ``_dispatch_analysis``; bpm · duration / 60
against the core's beat count; padding invariance, a silent song and
durations <= 0; the host tables bit for bit; the blocking of the per-frame
stage; the float64 variant; the host beat columns. Tolerances: the core
columns' gates (beats identical, the rest within 5e-4) and
``EXTENDED_GATES`` (``scripts/fuzz_differential.py:199-210``)."""

import dataclasses
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu import pipeline as jpipeline
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import EXTENDED_FEATURE_NAMES as JAX_NAMES
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features import extended as jext
from bliss_tpu.features.analyze import analyze_batch_ext_jit

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features import extended as ext
from bliss_tpu_torch.features import tempo
from bliss_tpu_torch.features.analyze import (
    _device_stage,
    _device_stage_packed,
    _unpack_stage,
    analyze_batch,
    analyze_batch_ext,
    analyze_batch_hybrid,
)
from bliss_tpu_torch.features.types import PCMBatch

torch.set_num_threads(1)

L = 131072
CONFIGS = {
    "main": AnalysisConfig.for_gpu(),
    "two_kernel": dataclasses.replace(AnalysisConfig.for_gpu(), single_pass=False),
    "hybrid": AnalysisConfig.for_gpu_hybrid(),
}
CORE_TOL = 5e-4
BPM = 4 + ext.EXTENDED_FEATURE_NAMES.index("bpm")


def _songs():
    rng = np.random.RandomState(31)
    a = synth_pcm(rng, L)
    b = rng.randint(-15000, 15000, size=100_001).astype(np.int16)
    b[:300] = 0
    c = synth_pcm(np.random.RandomState(32), 90_000, amp=3000)
    t = np.arange(120_000)
    pulse = 9000 * np.sin(2 * np.pi * t / 60.0) * ((t // 11025) % 2 == 0)
    d = np.clip(pulse + 400 * rng.randn(t.size), -32768, 32767).astype(np.int16)
    return [a, b, c, d], [3, 2, 2, 3]


def _gate_errors(got, ref, durations):
    """{gate name: (max |got - ref|, gate)} over the 45 columns; the beat
    gate on bpm · duration / 60."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and got.shape[1] == 45 and np.isfinite(got).all()
    dur = np.asarray(durations, np.float64)
    out = {}
    for name, lo, hi, gate in ext.EXTENDED_GATES:
        d = np.abs(got[:, lo:hi] - ref[:, lo:hi])
        if lo == 5:
            d = d * dur[:, None] / 60.0
        out[name] = (float(d.max()), gate)
    return out


def _within_gates(got, ref, durations):
    errs = _gate_errors(got, ref, durations)
    assert all(e <= g for e, g in errs.values()), errs


def _same_core(got, ref):
    assert np.array_equal(got[:, 0], ref[:, 0])  # tempo: equal beat counts
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], rtol=0, atol=CORE_TOL)


def _core_beats(rows, durations):
    return np.rint((rows[:, 0].astype(np.float64) - C.TEMPO_BIAS) * np.asarray(durations)
                   / C.TEMPO_SCALE)


@pytest.fixture(scope="session")
def batches():
    songs, durs = _songs()
    return (JBatch.from_arrays(songs, durs, pad_multiple=L),
            PCMBatch.from_arrays(songs, durs, pad_multiple=L, device="cpu"))


@pytest.fixture(scope="session")
def jax_rows(batches):
    jb, _ = batches
    main = np.asarray(analyze_batch_ext_jit(jb, JConfig.for_tpu()))
    hybrid = jpipeline._dispatch_analysis(jb, JConfig.for_tpu_hybrid(), None, extended=True)()
    return {"main": main, "hybrid": np.asarray(hybrid)}


@pytest.fixture(scope="session")
def port_rows(batches):
    _, tb = batches
    return {name: analyze_batch_ext(tb, cfg).numpy() for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("table", ["mel_filterbank", "chroma_matrix", "dct_ii_matrix"])
def test_host_tables_equal_bliss_tpus_bit_for_bit(table):
    got, ref = getattr(ext, table)(), getattr(jext, table)()
    assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref)


def test_names_and_gates_are_bliss_tpus():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts", "fuzz_differential.py")
    spec = importlib.util.spec_from_file_location("fuzz_differential", path)
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    assert ext.EXTENDED_FEATURE_NAMES == JAX_NAMES and len(JAX_NAMES) == 45
    assert ext.EXTENDED_GATES == fuzz.EXTENDED_GATES
    assert (ext.N_MELS, ext.N_MFCC, ext.N_CHROMA) == (jext.N_MELS, jext.N_MFCC, jext.N_CHROMA)


def test_extended_features_match_jax(batches, jax_rows):
    _, tb = batches
    got = ext.extended_features(tb, CONFIGS["main"]).numpy()
    assert got.dtype == np.float32
    _within_gates(got, jax_rows["main"][:, 4:], tb.durations.numpy())


@pytest.mark.parametrize("name", ["main", "two_kernel"])
def test_analyze_batch_ext_matches_jax(batches, jax_rows, port_rows, name):
    """analyze_batch_ext against analyze_batch_ext_jit(for_tpu()): the two
    device stages (K1; K2 + K3) give one answer."""
    got, ref = port_rows[name], jax_rows["main"]
    assert got.shape == (4, 49) and got.dtype == np.float32
    _same_core(got, ref)
    _within_gates(got[:, 4:], ref[:, 4:], batches[1].durations.numpy())


def test_hybrid_matches_jax_hybrid(batches, jax_rows, port_rows):
    """The hybrid path (K2 + K3, the float64 host finish, bpm and
    beat_loudness written from the host aux) against bliss_tpu's hybrid
    ``_dispatch_analysis(..., extended=True)``."""
    got, ref = port_rows["hybrid"], jax_rows["hybrid"]
    _same_core(got, ref)
    _within_gates(got[:, 4:], ref[:, 4:], batches[1].durations.numpy())
    _within_gates(got[:, 4:], port_rows["main"][:, 4:], batches[1].durations.numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_core_columns_are_analyze_batchs(batches, port_rows, name):
    _, tb = batches
    np.testing.assert_array_equal(port_rows[name][:, :4], analyze_batch(tb, CONFIGS[name]).numpy())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bpm_counts_the_core_beats(batches, port_rows, name):
    """bpm · duration / 60 is the core's beat count in every row: one
    envelope chain gives both."""
    rows, dur = port_rows[name], batches[1].durations.numpy()
    beats = _core_beats(rows, dur)
    assert (beats > 0).all()
    np.testing.assert_allclose(rows[:, BPM].astype(np.float64) * dur / 60.0, beats, rtol=1e-6, atol=0)


def test_packed_hybrid_stage_holds_the_extended_columns(batches, port_rows):
    """``_device_stage_packed(..., extended=True)`` under the hybrid config:
    one float64 array, the extended columns after the energies, zero beat
    columns (the host finish writes them)."""
    _, tb = batches
    cfg = CONFIGS["hybrid"]
    packed = _device_stage_packed(tb, cfg, extended=True)
    assert packed.dtype == torch.float64 and packed.shape == (4, 2 + L // 256 + 45)
    amp, freq, fa, e = _unpack_stage(packed.numpy(), cfg, L, extended=True)
    a2, f2, fa2 = _device_stage(tb, cfg)
    assert np.array_equal(amp, a2.numpy()) and np.array_equal(freq, f2.numpy())
    assert np.array_equal(fa, fa2.numpy())
    assert e.shape == (4, 45) and not e[:, 5:7].any()
    others = np.r_[0:5, 7:45]
    np.testing.assert_array_equal(e[:, others], port_rows["hybrid"][:, 4 + others])


def test_padding_invariance(batches, port_rows):
    """The features do not move with the bucket length L."""
    songs, durs = _songs()
    for name in ("main", "hybrid"):
        wide = analyze_batch_ext(PCMBatch.from_arrays(songs, durs, pad_multiple=2 * L, device="cpu"),
                                 CONFIGS[name]).numpy()
        assert np.array_equal(wide[:, 0], port_rows[name][:, 0])
        np.testing.assert_allclose(wide[:, 4:], port_rows[name][:, 4:], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["main", "hybrid"])
def test_silent_song_and_durations_not_positive(name):
    """A silent song: loudness -200 dB, zero crossings, bpm and
    beat_loudness 0, every column finite. A duration of 0 or -1: bpm 0
    where the core tempo stays the reference's beats / duration (inf, or
    negative)."""
    song = synth_pcm(np.random.RandomState(33), 70_000)
    batch = PCMBatch.from_arrays([np.zeros(70_000, np.int16), song, song, song], [3, 0, -1, 3],
                                 pad_multiple=65536, device="cpu")
    rows = analyze_batch_ext(batch, CONFIGS[name]).numpy()
    assert np.isfinite(rows[:, 4:]).all()
    silent = dict(zip(ext.EXTENDED_FEATURE_NAMES, rows[0, 4:]))
    assert silent["loudness_db"] == -200.0 and silent["zero_crossing_rate"] == 0.0
    assert silent["bpm"] == silent["beat_loudness"] == 0.0 and silent["spectral_flatness"] == 0.0
    beats = _core_beats(rows[3:], [3])[0]
    assert rows[1, 0] == np.inf and rows[2, 0] == np.float32(C.TEMPO_SCALE * beats / -1.0 + C.TEMPO_BIAS)
    assert rows[1, BPM] == rows[2, BPM] == 0.0 and rows[3, BPM] > 0
    cols = np.r_[4:BPM, BPM + 1 : 49]  # all but bpm: the duration moves nothing else
    np.testing.assert_array_equal(rows[1:3][:, cols], rows[[3, 3]][:, cols])


def test_the_per_frame_stage_in_blocks_is_the_stage_whole(batches):
    """``partials`` in blocks of 2048 samples (one row a block, a row's
    columns in 64 blocks, the zero crossing across each block's edge
    counted once) against one block for the whole batch."""
    _, tb = batches
    frames = tb.n_samples // 1024
    mono = tb.n_samples // 2
    whole = ext.partials(tb.samples, frames, mono)
    with mock.patch.object(ext, "BLOCK_SAMPLES", 2048):
        blocked = ext.partials(tb.samples, frames, mono)
    assert torch.equal(blocked.flips, whole.flips)
    # the spectrum sums its frames in float32 within a block
    torch.testing.assert_close(blocked.spec, whole.spec, rtol=1e-6, atol=0)
    for a, b in zip(blocked[1:5], whole[1:5]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_zero_crossings_count_sign_changes_of_the_c_mono():
    x = np.array([3, -4, -1, 0, -2, -2, 5, 6, -7, -7, 0, 0], np.int16)  # mono 0, 0, -2, 5, -7, 0
    p = ext.partials(torch.from_numpy(np.pad(x, (0, 1024 - x.size)))[None],
                     torch.tensor([0]), torch.tensor([6]))
    # c_div(l + r, 2) >= 0: +, +, -, +, -, +  -> 4 sign changes
    assert int(p.flips[0]) == 4


def test_the_float64_variant_is_within_the_gates(batches, port_rows):
    _, tb = batches
    f64 = ext.extended_features(tb, CONFIGS["main"], dtype=torch.float64).numpy()
    _within_gates(port_rows["main"][:, 4:], f64, tb.durations.numpy())


def test_host_beat_columns_are_the_device_ones(batches):
    """beat_metrics_host (float64 NumPy) against beat_metrics (float64 on
    the tensor's device) on the same band energies."""
    _, tb = batches
    cfg = CONFIGS["main"]
    fa = _device_stage(tb, cfg)[2]
    bpm, loud = tempo.beat_metrics(fa, tb.n_samples, tb.durations, cfg)
    hbpm, hloud = tempo.beat_metrics_host(fa.numpy(), tb.n_samples.numpy(), tb.durations.numpy())
    np.testing.assert_array_equal(bpm.numpy(), hbpm)
    np.testing.assert_allclose(loud.numpy(), hloud, rtol=1e-6, atol=0)
    hyb = analyze_batch_hybrid(tb, CONFIGS["hybrid"], extended=True).numpy()
    np.testing.assert_array_equal(hyb[:, BPM], hbpm)
