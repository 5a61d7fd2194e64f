"""The port's long-song streaming (``bliss_tpu_torch/features/streaming.py``)
against ``bliss_tpu.features.streaming.analyze_song_streaming`` and against
the port's own whole-shape path, on the CPU, where the kernels' wrappers run
their plain versions: the vector, the exact integer statistics, the trim
bounds, the window energies, chunk-size invariance, edge cases of the fold,
the extended row, the refusals, and the launch counters the pipeline's
threads share."""

import dataclasses
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features.streaming import analyze_song_streaming as j_streaming

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features import streaming
from bliss_tpu_torch.features.analyze import _device_stage, analyze_batch
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.kernels import _build
from bliss_tpu_torch.kernels import fused_stats as fs

torch.set_num_threads(1)

CH = 1 << 16  # rows of 65536 samples: a 20 s song folds into 14
CPU = torch.device("cpu")
CONFIGS = {
    "main": (AnalysisConfig.for_gpu(), JConfig.for_tpu()),
    "hybrid": (AnalysisConfig.for_gpu_hybrid(), JConfig.for_tpu_hybrid()),
}
# ROADMAP's float32 gate against bliss_tpu (tests/test_golden.py:28) and the
# cross-path gate against the port's own whole-shape path
JAX_TOL, WHOLE_TOL = 5e-4, 1e-3
ENERGY_RTOL = 1e-9  # float64 energies, streamed against whole-shape


def _song(seconds=20, seed=21):
    """~20 s of tones, noise and a 120 bpm pulse, with a leading silence and
    a silent gap (as tests/test_streaming.py's song)."""
    rng = np.random.RandomState(seed)
    sr = C.SAMPLE_RATE
    n = sr * seconds
    t = np.arange(n)
    sig = 6000 * np.sin(2 * np.pi * 220 * t / sr) + 2500 * np.sin(2 * np.pi * 1300 * t / sr)
    sig += rng.randn(n) * 800
    sig *= 0.35 + 0.65 * ((t * 2.0 / sr) % 1.0 < 0.3)
    sig[: sr // 5] = 0
    sig[5 * sr : 5 * sr + sr // 3] = 0
    inter = np.empty(2 * n, np.int16)
    inter[0::2] = np.clip(sig, -32767, 32767)
    inter[1::2] = np.clip(sig * 0.8, -32767, 32767)
    return inter, seconds


def _beats(out, duration):
    return np.rint((np.asarray(out, np.float64)[..., 0] - C.TEMPO_BIAS) * duration / C.TEMPO_SCALE)


def _same_vector(got, ref, duration, tol):
    assert got.shape == (4,) and got.dtype == np.float32 and np.isfinite(got).all()
    assert _beats(got, duration) == _beats(ref, duration)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=tol)


@pytest.fixture(scope="session")
def song():
    return _song()


@pytest.fixture(scope="session")
def jax_rows(song):
    samples, dur = song
    return {name: j_streaming(samples, dur, jcfg, chunk_samples=CH)
            for name, (_, jcfg) in CONFIGS.items()}


@pytest.fixture(scope="session")
def port_rows(song):
    samples, dur = song
    return {name: streaming.analyze_song_streaming(samples, dur, cfg, CH, device="cpu")
            for name, (cfg, _) in CONFIGS.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streamed_vector_matches_bliss_tpu_streaming(song, jax_rows, port_rows, name):
    _same_vector(port_rows[name], jax_rows[name], song[1], JAX_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streamed_vector_matches_the_whole_shape_path(song, port_rows, name):
    samples, dur = song
    cfg = CONFIGS[name][0]
    whole = analyze_batch(PCMBatch.from_arrays([samples], [dur], device="cpu"), cfg).numpy()[0]
    _same_vector(port_rows[name], whole, dur, WHOLE_TOL)


def _check_stage(samples, dur, cfg):
    """The streamed stage against the whole-shape stage of the same song:
    mean and variance identical to ``fused_stats.mean_variance``, trim
    bounds identical, the masked float64 energies within ENERGY_RTOL of the
    whole-shape ones where those are nonzero and zero where they are."""
    st = streaming.stream_stage(samples, dur, cfg, CH, CPU)
    batch = PCMBatch.from_arrays([samples], [dur], device="cpu")
    mv = fs.mean_variance(batch.samples, batch.n_samples)
    assert all(torch.equal(a, b) for a, b in zip(fs.moments(*st.sums, st.song.n_samples), mv))
    alpha, beta, _ = fs.normalization(batch.samples, batch.n_samples)
    assert torch.equal(st.alpha, alpha) and torch.equal(st.beta, beta)
    _, rownz, _ = fs.fused_stats_call(batch.samples, alpha, beta)
    bounds = fs.trim_bounds_from_rownz(batch.samples, rownz, batch.samples.shape[1])
    assert (int(st.start), int(st.end)) == tuple(int(b) for b in bounds)
    _, _, fa = _device_stage(batch, cfg)
    got, ref = st.energies.numpy(), fa.numpy()
    m = min(got.shape[-1], ref.shape[-1])
    assert not got[..., m:].any() and not ref[..., m:].any()
    np.testing.assert_allclose(got[..., :m], ref[..., :m], rtol=ENERGY_RTOL, atol=0)
    return st


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streamed_stage_matches_the_whole_shape_stage(song, name):
    st = _check_stage(*song, CONFIGS[name][0])
    assert st.energies.shape[-1] == 14 * CH // 256  # 882000 samples in 14 rows


def test_chunk_size_leaves_the_vector(song, port_rows):
    samples, dur = song
    b = streaming.analyze_song_streaming(samples, dur, AnalysisConfig.for_gpu(), 1 << 18, device="cpu")
    a = port_rows["main"]
    assert _beats(a, dur) == _beats(b, dur)
    np.testing.assert_allclose(a[1:], b[1:], rtol=0, atol=1e-5)


def _edge(kind):
    rng = np.random.RandomState(7)
    if kind == "exact_multiple":
        return synth_pcm(rng, 4 * CH)
    if kind == "k_chunks_plus_2":
        return synth_pcm(rng, 3 * CH + 2)
    if kind == "one_row":
        return synth_pcm(rng, CH - 5000)
    if kind == "silence_over_a_chunk":
        x = synth_pcm(rng, 5 * CH)
        x[: 3 * CH // 2] = 0
        return x
    if kind == "click_across_a_boundary":
        x = synth_pcm(rng, 4 * CH, amp=500)
        k = np.arange(-300, 300)
        x[2 * CH + k] = (30000 * np.exp(-np.abs(k) / 100.0) * np.sign(np.sin(k + 0.5))).astype(np.int16)
        return x
    # loud and positive: the int32 sum of its samples wraps
    return np.random.default_rng(8).integers(20000, 32768, size=3 * CH + 1000, dtype=np.int16)


def _c_moments(x):
    """The C reference's mean and variance on Python integers."""
    def c_div(a, b):
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q

    s = x.astype(np.int64)
    n = s.shape[0]
    wrapped = (int(s.sum()) + 2**31) % 2**32 - 2**31
    mean = c_div(wrapped, n)
    return mean, c_div(int(((s - mean) ** 2).sum()), n)


@pytest.mark.parametrize("kind", [
    "exact_multiple", "k_chunks_plus_2", "one_row", "silence_over_a_chunk",
    "click_across_a_boundary", "int32_sum_wraps",
])
def test_edges_of_the_fold(kind):
    """Each edge streamed at CH against the whole-shape path (beats
    identical, the rest within 1e-3, the stage as ``_check_stage``), its
    mean and variance against the C formulas and its trim bounds against
    the first and last nonzero sample."""
    x = _edge(kind)
    dur = max(1, x.shape[0] // (2 * C.SAMPLE_RATE))
    cfg = AnalysisConfig.for_gpu()
    st = _check_stage(x, dur, cfg)
    if kind == "int32_sum_wraps":
        assert int(x.astype(np.int64).sum()) > 2**31
    assert (int(st.mean), int(fs.moments(*st.sums, st.song.n_samples)[1])) == _c_moments(x)
    nz = np.flatnonzero(x)
    assert (int(st.start), int(st.end)) == (nz[0], nz[-1])
    got = streaming.analyze_song_streaming(x, dur, cfg, CH, device="cpu")
    whole = analyze_batch(PCMBatch.from_arrays([x], [dur], device="cpu"), cfg).numpy()[0]
    _same_vector(got, whole, dur, WHOLE_TOL)


@pytest.fixture(scope="session")
def jax_ext_rows(song):
    samples, dur = song
    return {name: j_streaming(samples, dur, jcfg, chunk_samples=CH, extended=True)
            for name, (_, jcfg) in CONFIGS.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_streamed_extended_row_matches_jax_and_the_whole_shape_path(song, jax_ext_rows, port_rows, name):
    """``extended=True``: [49], the 4 the plain streamed vector, the 45
    within EXTENDED_GATES of bliss_tpu's streamed row (``chunk_samples``
    2^16) and of the port's whole-shape ``analyze_batch_ext``; bpm counts
    the core's beats; 2^17-sample rows give the same row within the gates
    (the zero crossings at the rows' edges counted once: exactly)."""
    from bliss_tpu_torch.features.analyze import analyze_batch_ext
    from bliss_tpu_torch.features.extended import EXTENDED_GATES

    samples, dur = song
    cfg = CONFIGS[name][0]
    got = streaming.analyze_song_streaming(samples, dur, cfg, CH, extended=True, device="cpu")
    assert got.shape == (49,) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got[:4], port_rows[name])
    assert got[4 + 5] * dur / 60.0 == pytest.approx(_beats(got, dur), rel=1e-6)
    whole = analyze_batch_ext(PCMBatch.from_arrays([samples], [dur], device="cpu"), cfg).numpy()[0]
    wide = streaming.analyze_song_streaming(samples, dur, cfg, 2 * CH, extended=True, device="cpu")
    assert wide[4] == got[4] == whole[4]  # zero-crossing rate: the same count
    for ref, tol in ((jax_ext_rows[name], JAX_TOL), (whole, WHOLE_TOL), (wide, WHOLE_TOL)):
        _same_vector(got[:4], ref[:4], dur, tol)
        for gate_name, lo, hi, gate in EXTENDED_GATES:
            d = np.abs(got[4 + lo : 4 + hi].astype(np.float64) - ref[4 + lo : 4 + hi])
            assert d.max() * (dur / 60.0 if lo == 5 else 1.0) <= gate, gate_name


@pytest.mark.parametrize("case", ["float64", "chunk_not_a_frame"])
def test_refusals(song, case):
    """What streaming refuses: a mode name neither package knows, and rows
    that are not whole frames. A float64 config that takes the XLA-path
    stage is refused no more (ROADMAP M7b, ported): it streams, with the
    row of the song whole within 1e-5 and its beats."""
    samples, dur = song
    cfg, kw = AnalysisConfig.for_gpu(), {}
    if case == "float64":
        cfg = AnalysisConfig(dtype="float64", fused_kernel=True, tempo_finish="host")
        got = streaming.analyze_song_streaming(samples, dur, cfg, CH, device="cpu")
        whole = analyze_batch(PCMBatch.from_arrays([samples], [dur], device="cpu"), cfg).numpy()[0]
        assert _beats(got, dur) == _beats(whole, dur)
        np.testing.assert_allclose(got[1:], whole[1:], rtol=0, atol=1e-5)
        cfg, err, match = dataclasses.replace(cfg, amplitude_mode="gather"), ValueError, "amplitude_mode"
    else:
        kw, err, match = {"chunk_samples": CH + 512}, ValueError, "multiple of 1024"
    with pytest.raises(err, match=match):
        streaming.analyze_song_streaming(samples, dur, cfg, device="cpu", **kw)


def test_the_stage_waits_for_no_device_value(song):
    """No step before the final copy reads a value back, with or without
    the extended sums: every call that would wait for the device raises
    here."""
    samples, dur = song
    banned = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__", "__index__")
    patches = [mock.patch.object(torch.Tensor, name, side_effect=AssertionError(name)) for name in banned]
    for p in patches:
        p.start()
    try:
        st = streaming.stream_stage(samples, dur, AnalysisConfig.for_gpu(), CH, CPU)
        ste = streaming.stream_stage(samples, dur, AnalysisConfig.for_gpu(), CH, CPU, extended=True)
    finally:
        for p in patches:
            p.stop()
    assert st.energies.dtype == torch.float64 and st.ext is None
    assert ste.ext.spec.shape == (1, 257) and ste.ext.spec.dtype == torch.float64


def test_streaming_defaults_to_the_gpu(song):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.analyze_song_streaming(*song, AnalysisConfig.for_gpu())


def test_launch_counts_from_many_threads_add_up():
    """``_build.count_launch`` loses no count when threads launch at once,
    as the pipeline's pool thread and main thread do."""
    counters = {"LAUNCHES": 0}

    def launches():
        for _ in range(2000):
            _build.count_launch(counters, "LAUNCHES")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launches) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counters["LAUNCHES"] == 16 * 2000
