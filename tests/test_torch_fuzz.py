"""The port's differential fuzz (``bliss_tpu_torch/fuzz.py``) and its oracle
(``bliss_tpu_torch/oracle.py``) on the CPU: ``random_song`` is the JAX
script's, the oracle is ``tests/oracle.py`` bit for bit, the batched modes,
``parity`` through ``main`` and ``extended`` find no divergent case, the
port's rows of the fuzz's songs are ``bliss_tpu``'s under ``for_parity()``
(beats identical, the rest within 1e-5), the streamed modes settle a flip
only as the JAX script's rule and ``KNOWN_F32_FLIPS`` allow, that table's
flip is ``bliss_tpu``'s own, and without a GPU the default device fails.
Songs of 3-4 s, but the one song of ``KNOWN_F32_FLIPS`` (284 s)."""

import os
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import oracle as tests_oracle
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features import analyze_batch_jit
from bliss_tpu.features.streaming import analyze_song_streaming as j_streaming

from bliss_tpu_torch import fuzz
from bliss_tpu_torch import oracle as port_oracle
from bliss_tpu_torch.config import AnalysisConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import fuzz_differential  # noqa: E402

torch.set_num_threads(1)


def _short_cases(monkeypatch):
    """The fuzz's songs cut to 3-4 s: one draw of ``randint(3, 5)`` in the
    place of ``randint(3, 9)``, so the draws that follow stay the script's."""
    monkeypatch.setattr(fuzz, "SECONDS", (3, 5))


@pytest.mark.parametrize("seed,seconds,sr", [(0, 3, 22050), (1, 4, 44100), (2, 3, 32000)])
def test_random_song_is_the_scripts(seed, seconds, sr):
    got = fuzz.random_song(np.random.RandomState(seed), seconds, sr)
    ref = fuzz_differential.random_song(np.random.RandomState(seed), seconds, sr)
    assert got.dtype == ref.dtype == np.int16 and np.array_equal(got, ref)


@pytest.mark.parametrize("seed", [3, 4])
def test_oracle_is_tests_oracle_bit_for_bit(seed):
    rng = np.random.RandomState(seed)
    pcm = fuzz.random_song(rng, 3).reshape(-1)
    assert port_oracle.analyze_oracle(pcm, 3) == tests_oracle.analyze_oracle(pcm, 3)
    x = rng.randn(200)
    assert np.array_equal(port_oracle.rectangular_filter_oracle(x.copy(), x, 200, 19),
                          tests_oracle.rectangular_filter_oracle(x.copy(), x, 200, 19))
    fb = rng.randn(3, 17) * 0.1
    assert (port_oracle.multiband_envelope_oracle(pcm, 3, fb)
            == tests_oracle.multiband_envelope_oracle(pcm, 3, fb))


@pytest.mark.parametrize("mode", ["device_exact", "hybrid"])
def test_batched_device_fuzz_finds_no_divergence(mode, monkeypatch):
    _short_cases(monkeypatch)
    res = fuzz.run_batched_device_fuzz(4, mode, device="cpu", verbose=False, workers=1)
    assert (res["cases"], res["divergent"], res["mode"]) == (4, 0, mode)
    assert max(res["max_dev"][1:]) <= fuzz.GATE


def test_main_runs_parity(monkeypatch, capsys):
    _short_cases(monkeypatch)
    assert fuzz.main(["2", "parity", "--device", "cpu", "--workers", "1"]) == 0
    assert "divergent: 0" in capsys.readouterr().out


def test_port_rows_are_bliss_tpus_under_parity(monkeypatch):
    _short_cases(monkeypatch)
    cases = fuzz.make_cases(3, np.random.RandomState(1234), False, lambda *a: None)
    assert [c[1].shape[0] % 2 for c in cases] == [0, 0, 0]
    arrays, durs = [c[1] for c in cases], [c[2] for c in cases]
    from bliss_tpu_torch import analyze_pcm

    got = analyze_pcm(arrays, durs, cfg=AnalysisConfig.for_parity(), device="cpu")
    ref = np.asarray(analyze_batch_jit(JBatch.from_arrays(arrays, durs), JConfig.for_parity()))
    assert np.array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=1e-5)


def test_extended_fuzz_is_within_the_gates(monkeypatch):
    _short_cases(monkeypatch)
    res = fuzz.run_extended_fuzz(2, device="cpu", verbose=False)
    assert (res["cases"], res["divergent"]) == (2, 0)
    gates = {name: gate for name, _, _, gate in fuzz.EXTENDED_GATES}
    assert all(res["max_dev_by_group"][k] <= gates[k] for k in gates)


def test_no_gpu_fails_the_default_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert fuzz.main(["1", "device_exact", "--workers", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.run_extended_fuzz(1, verbose=False)


def test_a_flip_past_one_beat_stays_divergent():
    """The JAX script's rule: one beat settled by the song streamed under
    for_parity() is marginal; more beats stay divergent, and are listed in
    known_flips when they are the case's only fault. A marginal flip does
    not settle another column."""
    cases = [(0, None, 100), (1, None, 100), (2, None, 100), (3, None, 100)]
    ref, ours = np.zeros((4, 4)), np.zeros((4, 4))
    ours[:, 0] = [0.04, 0.12, 0.08, 0.04]  # 1, 3, 2 and 1 beats of 4 / 100
    ours[3, 1] = 2 * fuzz.GATE
    res = fuzz._report("streaming", cases, ours, ref, lambda *a: None, time.perf_counter(),
                       marginal={0, 3}, known={1})
    assert (res["divergent"], res["marginal"], res["known_flips"]) == (3, 2, [1])


def _flip_streams(monkeypatch, beats):
    """The fuzz's float32 streams shifted by ``beats`` (its for_parity()
    streams as they are), songs of 3-4 s."""
    monkeypatch.setattr(fuzz, "LONG_SECONDS", (3, 5))
    real = fuzz.analyze_song_streaming

    def shifted(samples, duration, cfg, device=None):
        row = np.array(real(samples, duration, cfg, device=device), np.float64)
        if cfg.dtype == "float32":
            row[0] += beats * 4.0 / duration
        return row

    monkeypatch.setattr(fuzz, "analyze_song_streaming", shifted)


@pytest.mark.parametrize("beats,pinned,divergent,marginal,known", [
    (0, 0, 0, 0, []),
    (1, 0, 0, 2, []),
    (-1, 0, 0, 2, []),
    (2, 0, 2, 0, []),
    (-2, -2, 2, 0, [0]),  # case 0 pinned at -2: reported, still divergent
    (-2, -3, 2, 0, [0]),
    (-3, -2, 2, 0, []),  # past the pin
    (2, -2, 2, 0, []),  # the other side
])
def test_streaming_adjudicates_flips(monkeypatch, beats, pinned, divergent, marginal, known):
    _flip_streams(monkeypatch, beats)
    if pinned:
        cases = fuzz.make_cases(1, np.random.RandomState(1234), True, lambda *a: None)
        monkeypatch.setattr(fuzz, "KNOWN_F32_FLIPS",
                            {(1234, 0, zlib.crc32(cases[0][1].tobytes())): pinned})
    res = fuzz.run_fuzz(2, "streaming", device="cpu", verbose=False, workers=1)
    assert (res["cases"], res["divergent"], res["marginal"], res["known_flips"]) == (
        2, divergent, marginal, known)


def test_streaming_strict_finds_no_divergence(monkeypatch):
    monkeypatch.setattr(fuzz, "LONG_SECONDS", (3, 5))
    res = fuzz.run_fuzz(2, "streaming_strict", device="cpu", verbose=False, workers=1)
    assert (res["cases"], res["divergent"], res["mode"]) == (2, 0, "streaming_strict")


@pytest.fixture(scope="module")
def known_flip():
    """Each song of ``KNOWN_F32_FLIPS``: (seed, case, samples, duration,
    the oracle's tempo), made as the fuzz makes it where the decoder cannot
    be built (every song generated at 22050 Hz)."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fuzz, "_decoder_error", lambda: "no decoder")
        for seed, case, crc in fuzz.KNOWN_F32_FLIPS:
            cases = fuzz.make_cases(case + 1, np.random.RandomState(seed), True, lambda *a: None)
            _, samples, duration = cases[case]
            assert zlib.crc32(samples.tobytes()) == crc
            out.append((seed, case, samples, duration, fuzz._oracle_row(samples, duration)))
    return out


def test_the_known_float32_flip_is_bliss_tpus_own(known_flip):
    """The flip of each ``KNOWN_F32_FLIPS`` song is what ``bliss_tpu``'s
    float32 streaming counts off the oracle on the CPU, and its float64
    streaming counts the oracle's beats."""
    for seed, case, samples, duration, want in known_flip:
        pinned = fuzz.KNOWN_F32_FLIPS[(seed, case, zlib.crc32(samples.tobytes()))]
        for cfg, beats in ((JConfig(dtype="float32"), pinned), (JConfig.for_parity(), 0)):
            got = float(np.asarray(j_streaming(samples, duration, cfg))[0])
            off = (got - want[0]) * duration / 4.0
            assert abs(off - beats) < fuzz.BEAT_GATE, (seed, case, cfg.dtype, off)


def test_the_ports_known_flip_is_reported(monkeypatch, known_flip):
    """The port streams each ``KNOWN_F32_FLIPS`` song on the CPU through
    ``run_fuzz``'s adjudication: a flip no further than the pinned one,
    reported in ``known_flips``, and still counted divergent."""
    for seed, case, samples, duration, want in known_flip:
        monkeypatch.setattr(fuzz, "make_cases", lambda *a: [(case, samples, duration)])
        monkeypatch.setattr(fuzz, "_oracle_row", lambda *a: want)
        res = fuzz.run_fuzz(1, "streaming", seed=seed, device="cpu", verbose=False, workers=1)
        assert (res["divergent"], res["known_flips"]) == (1, [case]), res
