"""The port's long-song streaming under every config
(``bliss_tpu_torch/features/streaming.py``: the XLA-path route and the
float64 finish) against ``bliss_tpu.features.streaming.analyze_song_streaming``
on the same PCM, on the CPU.

Two seeded songs of 30 s and ~22 s, streamed in rows of 2^18 samples, under
the modes of ``tests/test_streaming.py:249-346``: ``AnalysisConfig()``,
``for_parity()``, the iterative amplitude, ``parseval_framed``, the literal
``fft`` energies with the ``fft`` spectrum, ``fft_strict``, 161 taps,
``reference5``, and ``AnalysisConfig(fused_kernel=True)``, a kernel config
whose ``tempo_finish`` is ``"device"`` (F6); and F7's 161-tap song.

Gates: beats identical; float32 columns within 5e-4 and float64 within
1e-5 (``tests/test_golden.py:27-28``); the 45 extended columns within
``EXTENDED_GATES``. The port's streamed rows are held to ``bliss_tpu``'s
streamed rows, which take the exact integer variance, not to its
whole-shape float32 ones (F4); and to the port's own whole song under the
float64 finish.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features.streaming import analyze_song_streaming as j_streaming

from bliss_tpu_torch import constants as C
from bliss_tpu_torch.api import analyze_pcm
from bliss_tpu_torch.config import AnalysisConfig, uses_kernels
from bliss_tpu_torch.features import streaming
from bliss_tpu_torch.features.extended import EXTENDED_GATES

torch.set_num_threads(1)

CH = 1 << 18
F64_TOL, F32_TOL = 1e-5, 5e-4  # tests/test_golden.py:27-28
CPU = torch.device("cpu")

# name -> AnalysisConfig fields, the same in both packages (None: for_parity())
MODES = {
    "default": {},
    "parity": None,
    "iterative": {"amplitude_mode": "iterative", "tempo_finish": "host"},
    "parseval_framed": {"tempo_energy_mode": "parseval_framed", "tempo_finish": "host"},
    "literal_fft": {"tempo_energy_mode": "fft", "spectrum_mode": "fft", "tempo_finish": "host"},
    "fft_strict": {"tempo_energy_mode": "fft_strict"},
    "taps161": {"band_taps": 161, "amplitude_mode": "poly", "tempo_finish": "device_exact"},
    "reference5": {"amplitude_mode": "poly", "tempo_finish": "host", "filterbank": "reference5"},
    "f6_kernels": {"fused_kernel": True},
}
EXTENDED = ("default", "parity")


def configs(name):
    fields = MODES[name]
    if fields is None:
        return AnalysisConfig.for_parity(), JConfig.for_parity()
    return AnalysisConfig(**fields), JConfig(**fields)


def _songs():
    """Song 0: 30 s of a 220 Hz tone gated at 123 bpm plus noise of sigma
    800, the right channel 0.8 x the left (the F6 input). Song 1: ~22 s of
    two tones and decaying clicks at 97 bpm with a silent lead-in, a silent
    gap and a silent tail, its length not a multiple of 1024."""
    sr = C.SAMPLE_RATE
    rng = np.random.default_rng(7)
    n = 30 * sr
    t = np.arange(n)
    sig = 6000 * np.sin(2 * np.pi * 220 * t / sr)
    sig *= 0.35 + 0.65 * ((t * 123 / 60 / sr) % 1.0 < 0.3)
    sig += rng.standard_normal(n) * 800
    songs = [(sig, 0.8, 30)]

    rng = np.random.default_rng(11)
    n = 22 * sr + 333
    t = np.arange(n)
    sig = 5000 * np.sin(2 * np.pi * 180 * t / sr) + 1500 * np.sin(2 * np.pi * 2400 * t / sr)
    sig += rng.standard_normal(n) * 300
    beat = int(sr * 60 / 97)
    k = np.arange(2000)
    for s0 in range(sr, n - k.size, beat):
        sig[s0 : s0 + k.size] += 12000 * np.exp(-k / 300) * rng.standard_normal(k.size)
    sig[: sr // 2] = 0
    sig[8 * sr : 8 * sr + sr // 4] = 0
    sig[-sr // 3 :] = 0
    songs.append((sig, 0.6, 22))

    out = []
    for sig, right, dur in songs:
        inter = np.empty(2 * sig.shape[0], np.int16)
        inter[0::2] = np.clip(sig, -32767, 32767)
        inter[1::2] = np.clip(sig * right, -32767, 32767)
        out.append((inter, dur))
    return out


SONGS = _songs()
CASES = [(name, i) for name in MODES for i in range(len(SONGS))]


def _beats(row, duration):
    return np.rint((np.float64(row[0]) - C.TEMPO_BIAS) * duration / C.TEMPO_SCALE)


def _check(got, ref, duration, cfg, what):
    """Beats identical, the other columns within the dtype's gate."""
    assert got.shape == ref.shape and got.dtype == np.float32 and np.isfinite(got).all(), what
    assert _beats(got, duration) == _beats(ref, duration), (what, got[0], ref[0])
    tol = F64_TOL if cfg.dtype == "float64" else F32_TOL
    np.testing.assert_allclose(got[1:4], ref[1:4], rtol=0, atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def jax_rows():
    out = {}
    for name, i in CASES:
        samples, dur = SONGS[i]
        jcfg = configs(name)[1]
        out[name, i] = j_streaming(samples, dur, jcfg, chunk_samples=CH)
        if name in EXTENDED:
            out[name, i, "ext"] = j_streaming(samples, dur, jcfg, chunk_samples=CH, extended=True)
    return out


@pytest.fixture(scope="module")
def port_rows():
    out = {}
    for name, i in CASES:
        samples, dur = SONGS[i]
        cfg = configs(name)[0]
        out[name, i] = streaming.analyze_song_streaming(samples, dur, cfg, CH, device="cpu")
        if name in EXTENDED:
            out[name, i, "ext"] = streaming.analyze_song_streaming(
                samples, dur, cfg, CH, extended=True, device="cpu")
    return out


@pytest.mark.parametrize("i", range(len(SONGS)))
def test_f6_a_kernel_config_finishes_in_float64(port_rows, jax_rows, i):
    """F6: under ``AnalysisConfig(fused_kernel=True)`` (the kernels,
    ``tempo_finish="device"``) a streamed song finishes in float64, as
    ``bliss_tpu``'s streaming does: tempo and attack bit for bit those of
    ``tempo_finish="device_exact"``, and ``bliss_tpu``'s beats (200 on
    song 0, where a float32 finish counted 202)."""
    samples, dur = SONGS[i]
    cfg = configs("f6_kernels")[0]
    assert uses_kernels(cfg) and cfg.tempo_finish == "device"
    got = port_rows["f6_kernels", i]
    exact = streaming.analyze_song_streaming(
        samples, dur, dataclasses.replace(cfg, tempo_finish="device_exact"), CH, device="cpu")
    assert got[0] == exact[0] and got[3] == exact[3]
    assert _beats(got, dur) == _beats(jax_rows["f6_kernels", i], dur)


@pytest.mark.parametrize("name,i", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_streamed_rows_match_jax(port_rows, jax_rows, name, i):
    """Every config streams (``streaming_supports``), and its streamed row
    is ``bliss_tpu``'s streamed row."""
    cfg = configs(name)[0]
    assert streaming.streaming_supports(cfg)
    _check(port_rows[name, i], jax_rows[name, i], SONGS[i][1], cfg, f"{name} song {i}")


@pytest.mark.parametrize("name", list(MODES))
def test_streamed_rows_match_the_whole_song(port_rows, name):
    """The port streamed against the port whole (``analyze_pcm`` at B=1)
    under the float64 finish; ``for_parity()``'s strict float32 frame sum
    carries across rows in song order, so its frequency is bit for bit its
    whole-shape value."""
    cfg = configs(name)[0]
    whole_cfg = cfg if cfg.tempo_finish == "host" else dataclasses.replace(
        cfg, tempo_finish="device_exact")
    for i, (samples, dur) in enumerate(SONGS):
        whole = analyze_pcm([samples], [dur], cfg=whole_cfg, device="cpu")[0]
        _check(port_rows[name, i], whole, dur, cfg, f"{name} song {i}")
        if cfg.strict_accumulation:
            assert port_rows[name, i][2] == whole[2]


@pytest.mark.parametrize("name", list(MODES))
def test_chunk_size_invariance(port_rows, name):
    """Rows of 2^20 samples give the beats of rows of 2^18, and, under
    ``for_parity()`` (exact counts, the frames summed in the same order,
    windows that carry no state), the same vector bit for bit."""
    cfg = configs(name)[0]
    for i, (samples, dur) in enumerate(SONGS):
        wide = streaming.analyze_song_streaming(samples, dur, cfg, 4 * CH, device="cpu")
        if cfg.strict_accumulation:
            np.testing.assert_array_equal(wide, port_rows[name, i])
        _check(wide, port_rows[name, i], dur, cfg, f"{name} song {i} at 2^20")


@pytest.mark.parametrize("name", EXTENDED)
def test_extended_rows_match_jax(port_rows, jax_rows, name):
    """``extended=True`` on the XLA-path route: the core 4 those of the
    plain streamed row, bpm counting its beats, the 45 columns within
    EXTENDED_GATES of ``bliss_tpu``'s streamed row."""
    cfg = configs(name)[0]
    for i, (samples, dur) in enumerate(SONGS):
        got, ref = port_rows[name, i, "ext"], jax_rows[name, i, "ext"]
        assert got.shape == ref.shape == (49,) and np.isfinite(got).all()
        np.testing.assert_array_equal(got[:4], port_rows[name, i])
        _check(got[:4], ref[:4], dur, cfg, f"{name} song {i} extended")
        assert got[4 + 5] * dur / 60.0 == pytest.approx(_beats(got, dur), rel=1e-6)
        for gate_name, lo, hi, gate in EXTENDED_GATES:
            d = np.abs(got[4 + lo : 4 + hi].astype(np.float64) - ref[4 + lo : 4 + hi])
            assert d.max() * (dur / 60.0 if lo == 5 else 1.0) <= gate, (name, i, gate_name)


@pytest.mark.parametrize("name", ["default", "parity", "iterative", "reference5"])
def test_the_xla_stage_waits_for_no_device_value(name):
    """No step of the XLA-path route before the final copy reads a value
    back, with or without the extended sums: every call that would wait for
    the device raises here."""
    samples, dur = SONGS[1]
    cfg = configs(name)[0]
    banned = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__", "__index__")
    patches = [mock.patch.object(torch.Tensor, b, side_effect=AssertionError(b)) for b in banned]
    for p in patches:
        p.start()
    try:
        st = streaming.stream_stage(samples, dur, cfg, CH, CPU, extended=True)
    finally:
        for p in patches:
            p.stop()
    assert st.energies.shape == (1, cfg.nb_bands, -(-samples.shape[0] // CH) * CH // 256)
    assert st.energies.dtype == cfg.torch_dtype and st.ext.spec.shape == (1, 257)


def test_f7_161_taps_after_a_loud_to_silence_edge():
    """F7: at 161 taps in float32 the blocked Parseval energies of a window
    just after a loud-to-silence edge cancel the loud history's FIR tail;
    the rounding left one such window at -0.0625, whose log compression
    made the attack NaN and cut the beats after it (whole and streamed
    alike). Window energies are sums of squares, so they are clamped at 0:
    the song (``chip_smoke.synth_song``, its silent tail starting 48
    samples before the song's last window) now gives ``bliss_tpu``'s row,
    whole and streamed."""
    import chip_smoke

    rng = np.random.default_rng(5)
    chip_smoke.synth_song(rng, 300_001)
    samples, dur = chip_smoke.synth_song(rng, 420_000), 9
    cfg, jcfg = configs("taps161")
    ref = j_streaming(samples, dur, jcfg, chunk_samples=CH)
    whole = analyze_pcm([samples], [dur], cfg=cfg, device="cpu")[0]
    streamed = streaming.analyze_song_streaming(samples, dur, cfg, CH, device="cpu")
    _check(whole, ref, dur, cfg, "whole")
    _check(streamed, ref, dur, cfg, "streamed")
