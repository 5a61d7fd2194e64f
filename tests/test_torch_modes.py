"""The port's XLA-path config modes against bliss_tpu's XLA functions on the
same seeded PCM (B=3, L=131072): framing, the literal IIR, every amplitude,
spectrum and energy mode, the filterbanks, the working-dtype device finish,
and end to end ``analyze_batch`` under ``AnalysisConfig()``, bliss_tpu's CPU
float32 default, ``for_parity()`` and ``for_parity()`` with the host
finish, ``analyze_batch_ext`` under ``for_parity()``, and
``analyze_library`` under ``for_parity()`` with a song above
``long_song_samples``; and the float32 finish at L=2^23.

Gates: beats and integer intermediates (trim bounds, histogram counts)
identical; float64 scores within 1e-5 and float32 scores within 5e-4
(``tests/test_golden.py:27-28``). The float32 working-dtype finish
(``tempo_finish="device"``) is the one exception, as in bliss_tpu's own
``test_device_f32_mode_close``: its Butterworth chain rounds the smoothed
envelope by ~1e-4 where the peak detector compares at 1e-6, so each chain
may count a peak the other does not, and bliss_tpu's own float32 attack
lies up to 6.2e-4 (blocked IIR) and 1.4e-2 (scan) from its float64 finish
of the same energies on these songs. ``check_f32_finish`` requires every
flip to sit within that float32 rounding of the float64 envelope, and holds
the attack to bliss_tpu's float64 finish within the differential fuzz's
float32 gate of 1e-3 or twice bliss_tpu's own largest float32 error on the
batch, whichever is larger: the port's float32 chain no noisier than
twice bliss_tpu's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.dsp import framing as jframing
from bliss_tpu.dsp import iir as jiir
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features import amplitude as jamp
from bliss_tpu.features import frequency as jfreq
from bliss_tpu.features import tempo as jtempo
from bliss_tpu.features.analyze import analyze_batch_ext_jit, analyze_batch_hybrid, analyze_batch_jit

from bliss_tpu_torch import constants as C
from bliss_tpu_torch import pipeline
from bliss_tpu_torch.config import AnalysisConfig, uses_kernels
from bliss_tpu_torch.convert import config_from_reference
from bliss_tpu_torch.dsp.framing import frame_signal
from bliss_tpu_torch.dsp.iir import lfilter_scan
from bliss_tpu_torch.features import amplitude, frequency, tempo
from bliss_tpu_torch.features.analyze import analyze_batch, analyze_batch_ext
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.io.flac_writer import write_flac

torch.set_num_threads(1)

F64_TOL = 1e-5  # tests/test_golden.py:27
F32_TOL = 5e-4  # tests/test_golden.py:28
FUZZ_TOL = 1e-3  # the differential fuzz's float32 gate, scripts/fuzz_differential.py:169
# bliss_tpu's CPU default when x64 is off (bliss_tpu/api.py:48-52)
JAX_CPU_F32 = JConfig(dtype="float32", amplitude_mode="poly", tempo_finish="device_exact")


def songs():
    """Three songs with silent edges and clicks (real beats), one of them
    noise with a silent lead-in, padded to L = 131072."""
    rng = np.random.RandomState(3)
    out = []
    for n, period, amp in ((120_000, 9_000, 12000), (100_000, 0, 0), (131_072, 7_000, 3000)):
        if not period:
            s = rng.randint(-15000, 15000, size=n).astype(np.int16)
            s[:300] = 0
            out.append(s)
            continue
        s = synth_pcm(rng, n, amp=amp).astype(np.float64)
        k = np.arange(1_500)
        click = 3 * amp * np.exp(-k / 300.0) * rng.randn(k.size)
        for start in range(n // 50, n - n // 50 - k.size, period):
            s[start : start + k.size] += click
        out.append(np.clip(s, -32768, 32767).astype(np.int16))
    return out, [3, 2, 3]


@pytest.fixture(scope="module")
def batches():
    pcm, durs = songs()
    return JBatch.from_arrays(pcm, durs), PCMBatch.from_arrays(pcm, durs, device="cpu")


def port_cfg(jcfg: JConfig) -> AnalysisConfig:
    return config_from_reference(dataclasses.asdict(jcfg))


def tol(jcfg) -> float:
    return F64_TOL if jcfg.dtype == "float64" else F32_TOL


def check_rows(port, ref, jcfg, what=""):
    """Beats identical (tempo = 4 beats / duration - 30.4) and the other
    columns within the config's dtype's gate."""
    assert port.shape == ref.shape and np.isfinite(port).all(), what
    assert np.array_equal(port[:, 0], ref[:, 0]), (what, port[:, 0], ref[:, 0])
    np.testing.assert_allclose(port[:, 1:], ref[:, 1:], rtol=0, atol=tol(jcfg), err_msg=what)


def check_f32_finish(port_aux, jax_aux, fa64, n, durations, port_attack, jax_attack, label=""):
    """The float32 working-dtype finish against bliss_tpu's: beat counts
    equal, or every peak where the two chains' masks differ within the
    float32 chain's own rounding of the envelope (``|margin| <= err``:
    margin = min(r2[j] - r2[j-1], r2[j] - r2[j+1]) - eps on bliss_tpu's
    float64 envelope of the same energies, err = the larger of the two
    chains' max |r2_f32 - r2_f64| over the song); the attack within
    max(1e-3, 2 max_songs |bliss_tpu's float32 attack - float64 attack|)
    of that float64 finish. Returns the flips as (song, slot, margin, err)."""
    _, h_attack, (r2, _, _) = jtempo.envelope_finish_host(
        fa64, n, durations, workers=1, return_aux=True)
    p_beat, p_r2, p_peaks, _ = (np.asarray(x) for x in port_aux)
    j_beat, j_r2, j_peaks, _ = (np.asarray(x) for x in jax_aux)
    flips = []
    for i in range(len(n)):
        if p_beat[i] == j_beat[i] and np.array_equal(p_peaks[i], j_peaks[i]):
            continue
        err = max(np.abs(p_r2[i] - r2[i]).max(), np.abs(j_r2[i] - r2[i]).max())
        for j in np.nonzero(p_peaks[i] != j_peaks[i])[0]:
            margin = min(r2[i, j] - r2[i, j - 1], r2[i, j] - r2[i, j + 1]) - C.PEAK_EPSILON
            flips.append((i, int(j), float(margin), float(err)))
            assert abs(margin) <= err, (label, flips[-1])
    port_err = np.abs(np.asarray(port_attack, np.float64) - h_attack)
    jax_err = np.abs(np.asarray(jax_attack, np.float64) - h_attack)
    print(f"{label}: float32-finish flips (song, slot, float64 margin, float32 r2 error): "
          f"{flips}; attack error vs the float64 finish: port {port_err}, bliss_tpu {jax_err}")
    assert port_err.max() <= max(FUZZ_TOL, 2 * jax_err.max()), label
    return flips


# --- framing and the IIR -----------------------------------------------------

@pytest.mark.parametrize("hop", [256, 512])
def test_frame_signal_matches_jax(hop):
    x = np.random.RandomState(hop).randn(2, 3, 4096)
    got = frame_signal(torch.from_numpy(x), 512, hop)
    want = np.asarray(jframing.frame_signal(jnp.asarray(x), 512, hop))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_lfilter_scan_matches_jax():
    x = np.random.RandomState(5).randn(2, 3, 3000)
    got = lfilter_scan(C.BUTTER_B, C.BUTTER_A, torch.from_numpy(x)).numpy()
    want = np.asarray(jiir.lfilter_scan(C.BUTTER_B, C.BUTTER_A, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --- the analyzers, mode by mode --------------------------------------------

def test_trim_bounds_and_histogram_counts_match_jax(batches):
    jb, tb = batches
    s = tb.samples
    start, end = amplitude.trim_bounds(s)
    jstart, jend = jamp._trim_bounds(jb.samples.astype(jnp.int32))
    assert start.tolist() == np.asarray(jstart).tolist()
    assert end.tolist() == np.asarray(jend).tolist()
    idx = torch.arange(s.shape[1])
    seg = (idx[None, :] >= start[:, None]) & (idx[None, :] <= end[:, None])
    jidx = jnp.arange(s.shape[1])
    jseg = (jidx[None, :] >= jstart[:, None]) & (jidx[None, :] <= jend[:, None])
    hist = amplitude.hist_crop_counts(s, seg)
    jhist = np.asarray(jamp.hist_crop_counts(jb.samples.astype(jnp.int32), jseg))
    assert hist.dtype == torch.int32 and np.array_equal(hist.numpy(), jhist)
    assert int(hist.sum()) > 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("mode", ["table", "poly", "iterative"])
def test_amplitude_modes_match_jax(batches, mode, strict, dtype):
    jb, tb = batches
    jcfg = JConfig(dtype=dtype, amplitude_mode=mode, strict_accumulation=strict)
    got = amplitude.amplitude_scores(tb, port_cfg(jcfg)).numpy()
    want = np.asarray(jamp.amplitude_scores(jb, jcfg))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(jcfg))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("mode", ["matmul", "fft"])
def test_spectrum_modes_match_jax(batches, mode, strict, dtype):
    jb, tb = batches
    jcfg = JConfig(dtype=dtype, spectrum_mode=mode, strict_accumulation=strict)
    got = frequency.frequency_scores(tb, port_cfg(jcfg)).numpy()
    want = np.asarray(jfreq.frequency_scores(jb, jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(jcfg))
    power = frequency.power_spectrum(tb, port_cfg(jcfg))
    assert power.dtype == getattr(torch, dtype) and power.shape == (3, 257)
    assert not power[:, -1].any()  # the reference never accumulates Nyquist


ENERGY_RTOL = {"float64": 1e-9, "float32": 1e-5}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["parseval", "parseval_framed", "fft", "fft_strict"])
def test_energy_modes_match_jax(batches, mode, dtype):
    """Window energies [B, NB, NBF] relative to each song's largest, and the
    beats and attack of the float64 finish of each."""
    jb, tb = batches
    jcfg = JConfig(dtype=dtype, tempo_energy_mode=mode)
    got = tempo.band_energies(tb, port_cfg(jcfg))
    want = np.asarray(jtempo.band_energies(jb, jcfg))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape == (3, 1, 512)
    got = got.numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) / scale).max() <= ENERGY_RTOL[dtype]
    assert np.array_equal(got == 0, want == 0)  # the same masked slots
    n, d = np.asarray(jb.n_samples), np.asarray(jb.durations)
    pt, pa = jtempo.envelope_finish_host(got, n, d, workers=1)
    jt, ja = jtempo.envelope_finish_host(want, n, d, workers=1)
    assert np.array_equal(pt, jt)
    np.testing.assert_allclose(pa, ja, rtol=0, atol=tol(jcfg))


FILTERBANKS = {
    "one_band": JConfig(dtype="float64"),
    "reference5": JConfig(dtype="float64", filterbank="reference5"),
    "firwin_161": JConfig(dtype="float64", band_taps=161),
}


@pytest.mark.parametrize("name", sorted(FILTERBANKS))
def test_filterbank_energies_match_jax(batches, name):
    """Each filterbank's parseval and fft_strict energies, then its scores."""
    jb, tb = batches
    for mode in ("parseval", "fft_strict"):
        jcfg = dataclasses.replace(FILTERBANKS[name], tempo_energy_mode=mode)
        got = tempo.band_energies(tb, port_cfg(jcfg)).numpy()
        want = np.asarray(jtempo.band_energies(jb, jcfg))
        assert got.shape == want.shape == (3, jcfg.nb_bands, 512)
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        assert (np.abs(got - want) / scale).max() <= 1e-9, mode
    cfg = port_cfg(jcfg)
    assert not uses_kernels(cfg)
    check_rows(analyze_batch(tb, cfg).numpy(), np.asarray(analyze_batch_jit(jb, jcfg)), jcfg, name)


@pytest.fixture(scope="module")
def energies(batches):
    """bliss_tpu's float64 and float32 window energies of the songs."""
    jb, _ = batches
    return {dt: np.asarray(jtempo.band_energies(jb, JConfig(dtype=dt)))
            for dt in ("float64", "float32")}


@pytest.mark.parametrize("iir_mode", ["blocked", "scan"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_finish_matches_jax(batches, energies, dtype, iir_mode):
    """``tempo_finish="device"`` in the config's dtype on bliss_tpu's own
    energies, against bliss_tpu's working-dtype finish."""
    jb, _ = batches
    jcfg = JConfig(dtype=dtype, iir_mode=iir_mode)
    fa = energies[dtype]
    n, d = np.asarray(jb.n_samples), np.asarray(jb.durations)
    tn, td = torch.from_numpy(n), torch.from_numpy(d)
    pt, pa, paux = tempo.envelope_finish_device(torch.from_numpy(fa), tn, td, port_cfg(jcfg),
                                                return_aux=True)
    jt, ja, jaux = jtempo.envelope_finish_device(jnp.asarray(fa), jb.n_samples, jb.durations,
                                                 jcfg, return_aux=True)
    assert pt.dtype == torch.float32 and paux[1].dtype == getattr(torch, dtype)
    if dtype == "float64":
        assert np.array_equal(pt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=F64_TOL)
        np.testing.assert_allclose(paux[1].numpy(), np.asarray(jaux[1]), rtol=0, atol=1e-9)
        return
    check_f32_finish(paux, jaux, energies["float64"], n, d, pa.numpy(), np.asarray(ja),
                     f"float32 {iir_mode}")


# --- end to end ----------------------------------------------------------------

END_TO_END = {
    "default": JConfig(),
    "jax_cpu_float32": JAX_CPU_F32,
    "parity": JConfig.for_parity(),
    "parity_host": dataclasses.replace(JConfig.for_parity(), tempo_finish="host"),
}


@pytest.mark.parametrize("name", list(END_TO_END))
def test_analyze_batch_matches_jax(batches, name):
    jb, tb = batches
    jcfg = END_TO_END[name]
    cfg = port_cfg(jcfg)
    assert not uses_kernels(cfg)
    port = analyze_batch(tb, cfg).numpy()
    if jcfg.tempo_finish == "host":
        ref = np.asarray(analyze_batch_hybrid(jb, jcfg))
    else:
        ref = np.asarray(analyze_batch_jit(jb, jcfg))
    if name != "default":
        check_rows(port, ref, jcfg, name)
        return
    # the float32 working-dtype finish: amplitude and frequency within the
    # gate; beats and attack through check_f32_finish on each package's own
    # energies
    np.testing.assert_allclose(port[:, 1:3], ref[:, 1:3], rtol=0, atol=F32_TOL)
    n, d = np.asarray(jb.n_samples), np.asarray(jb.durations)
    pfa = tempo.band_energies(tb, cfg)
    jfa = jtempo.band_energies(jb, jcfg)
    _, _, paux = tempo.envelope_finish_device(pfa, tb.n_samples, tb.durations, cfg, return_aux=True)
    _, _, jaux = jtempo.envelope_finish_device(jfa, jb.n_samples, jb.durations, jcfg,
                                               return_aux=True)
    fa64 = np.asarray(jtempo.band_energies(jb, JConfig(dtype="float64")))
    check_f32_finish(paux, jaux, fa64, n, d, port[:, 3], ref[:, 3], name)


def test_analyze_batch_ext_parity_matches_jax(batches):
    jb, tb = batches
    jcfg = JConfig.for_parity()
    port = analyze_batch_ext(tb, port_cfg(jcfg)).numpy()
    ref = np.asarray(analyze_batch_ext_jit(jb, jcfg))
    assert port.shape == ref.shape == (3, 49)
    check_rows(port[:, :4], ref[:, :4], jcfg, "core")
    # the 45 columns in float64 on both sides: within 1e-5 relative (the
    # spectral columns run to 1e4 Hz), far inside EXTENDED_GATES
    np.testing.assert_allclose(port[:, 4:], ref[:, 4:], rtol=F64_TOL, atol=F64_TOL)


def test_analyze_library_parity_takes_a_long_song_whole(tmp_path, batches):
    """Under ``for_parity()`` a song above ``long_song_samples`` no longer
    goes through a bucket whole (ROADMAP M7b, ported): it streams (the
    ``streaming`` stage once), and its row is the port's streamed row, its
    whole song's at its bucket's length within 1e-5 with the same beats,
    and bliss_tpu's streamed row; the other songs' rows are the batch
    path's at their bucket's length and bliss_tpu's."""
    from bliss_tpu.features.streaming import analyze_song_streaming as j_streaming

    from bliss_tpu_torch.features.streaming import analyze_song_streaming
    from bliss_tpu_torch.io import decode

    pcm, durs = songs()
    files = []
    for i, s in enumerate(pcm):
        files.append(str(tmp_path / f"s{i}.flac"))
        write_flac(files[-1], s.reshape(-1, 2), 22050)
    cfg = AnalysisConfig.for_parity()
    r = pipeline.analyze_library(files, cfg=cfg, batch_size=3, device="cpu",
                                 handle_sigint=False, long_song_samples=110_000)
    decoded = [decode(f) for f in files]
    long = [d.n_samples > 110_000 for d in decoded]
    assert r.ok.all() and r.stats["streaming"]["count"] == sum(long) >= 1
    for i, d in enumerate(decoded):
        L = pipeline._bucket_length(d.n_samples, cfg.pad_multiple)
        one = PCMBatch.from_arrays([d.samples], [d.duration], pad_multiple=L, device="cpu")
        whole = analyze_batch(one, cfg).numpy()[0]
        if not long[i]:
            assert np.array_equal(r.features[i], whole)
            jone = JBatch.from_arrays([d.samples], [d.duration], pad_multiple=L)
            check_rows(r.features[i : i + 1], np.asarray(analyze_batch_jit(jone, JConfig.for_parity())),
                       JConfig.for_parity(), files[i])
            continue
        assert np.array_equal(r.features[i],
                              analyze_song_streaming(d.samples, d.duration, cfg, device="cpu"))
        check_rows(r.features[i : i + 1], whole[None], JConfig.for_parity(), f"{files[i]} whole")
        check_rows(r.features[i : i + 1], j_streaming(d.samples, d.duration, JConfig.for_parity())[None],
                   JConfig.for_parity(), f"{files[i]} bliss_tpu streamed")


def test_float32_finish_at_full_length():
    """The float32 working-dtype finish at L=2^23 on two of ``chip_smoke.py``'s
    songs (its generator from ``SEED``; a full and a 7 000 000-sample song):
    bliss_tpu's ``AnalysisConfig()`` and the port's count other beats than
    their float64 finishes, the float64 beats agree between the packages,
    and every float32 flip is within the float32 rounding of the envelope
    (``check_f32_finish``). The printed counts are those PERF.md and
    ROADMAP.md quote."""
    import chip_smoke

    rng = np.random.default_rng(chip_smoke.SEED)
    pcm = [chip_smoke.synth_song(rng, n) for n in (1 << 23, 7_000_000)]
    durs = [int(a.shape[0]) // (2 * chip_smoke.SR) for a in pcm]
    jb = JBatch.from_arrays(pcm, durs)
    tb = PCMBatch.from_arrays(pcm, durs, device="cpu")
    jcfg = JConfig()
    cfg = port_cfg(jcfg)
    n, d = np.asarray(jb.n_samples), np.asarray(jb.durations)
    fa64 = np.asarray(jtempo.band_energies(jb, JConfig(dtype="float64")))
    _, ja, jaux = jtempo.envelope_finish_device(jtempo.band_energies(jb, jcfg), jb.n_samples,
                                                jb.durations, jcfg, return_aux=True)
    pfa = tempo.band_energies(tb, cfg)
    _, pa, paux = tempo.envelope_finish_device(pfa, tb.n_samples, tb.durations, cfg,
                                               return_aux=True)
    exact = dataclasses.replace(cfg, tempo_finish="device_exact")
    _, _, paux64 = tempo.envelope_finish_device(pfa, tb.n_samples, tb.durations, exact,
                                                return_aux=True)
    _, _, (_, peaks64, _) = jtempo.envelope_finish_host(fa64, n, d, workers=1, return_aux=True)
    beats = {"bliss_tpu float32": np.asarray(jaux[0]).tolist(),
             "bliss_tpu float64": peaks64.sum(axis=1).tolist(),
             "port float32": paux[0].tolist(), "port float64 finish": paux64[0].tolist()}
    print(f"beats at L=2^23: {beats}")
    assert beats["port float64 finish"] == beats["bliss_tpu float64"]
    assert beats["port float32"] != beats["port float64 finish"]
    check_f32_finish(paux, jaux, fa64, n, d, pa.numpy(), np.asarray(ja), "L=2^23")
