"""The port's Song API against bliss_tpu's on the same FLAC files: the
Mapping fields, force, calm_or_loud, analyze, distance and cosine on
filenames, the legacy ``*_file`` status codes, ``Song.extended_analysis``,
the per-analyzer methods, and the options the port does not run yet."""

from unittest import mock

import numpy as np
import pytest
import torch

from conftest import synth_pcm
import bliss_tpu
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.io.flac_writer import write_flac

import bliss_tpu_torch
from bliss_tpu_torch import api
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features import streaming

torch.set_num_threads(1)


@pytest.fixture(scope="session")
def files(tmp_path_factory):
    """Two songs of the same length (one shape for bliss_tpu to compile:
    73728 samples, over the 65536 at which its Pallas kernels run) and a
    broken file."""
    d = tmp_path_factory.mktemp("torch_api")
    out = []
    for i, amp in enumerate((12000, 2500)):
        pcm = synth_pcm(np.random.RandomState(80 + i), 72_000, amp=amp)
        out.append(str(d / f"song{i}.flac"))
        write_flac(out[-1], pcm.reshape(-1, 2), 22050,
                   tags={"ARTIST": "synth", "TITLE": f"song {i}", "ALBUM": "tests"})
    bad = d / "broken.flac"
    bad.write_bytes(b"\x00" * 2048)
    out.append(str(bad))
    return out


@pytest.fixture(scope="session")
def jax_songs(files):
    songs = []
    for f in files[:2]:
        s = bliss_tpu.Song()
        s.analyze(f, cfg=JConfig.for_tpu())
        songs.append(s)
    return songs


@pytest.fixture(scope="session")
def port_songs(files):
    return [bliss_tpu_torch.Song(f, device="cpu") for f in files[:2]]


def test_song_fields_match_jax(jax_songs, port_songs):
    assert bliss_tpu_torch.Song._FIELDS == bliss_tpu.Song._FIELDS
    for got, ref in zip(port_songs, jax_songs):
        assert list(got) == list(ref) and len(got) == len(ref)
        for key in got:
            if key == "sample_array":
                np.testing.assert_array_equal(got[key], ref[key])
            elif key not in ("force_vector", "force"):
                assert got[key] == ref[key], key
        fv, rfv = got["force_vector"], ref["force_vector"]
        assert list(fv) == list(rfv)
        assert fv["tempo"] == rfv["tempo"]  # equal beat counts
        for k in ("amplitude", "frequency", "attack"):
            assert abs(fv[k] - rfv[k]) <= 1e-3, k
        assert abs(got.force - ref.force) <= 3e-3


def test_analyze_and_hybrid_config(files, port_songs):
    s = bliss_tpu_torch.analyze(files[0], device="cpu")
    assert isinstance(s, bliss_tpu_torch.Song)
    np.testing.assert_array_equal(s.force_vector.as_array(), port_songs[0].force_vector.as_array())
    h = bliss_tpu_torch.analyze(files[0], cfg=AnalysisConfig.for_gpu_hybrid(), device="cpu")
    assert h.force_vector.tempo == s.force_vector.tempo
    np.testing.assert_allclose(h.force_vector.as_array(), s.force_vector.as_array(), atol=1e-3)


def test_distance_and_cosine_take_files_songs_and_vectors(files, jax_songs, port_songs):
    a, b = port_songs
    va, vb = a.force_vector.as_array(), b.force_vector.as_array()
    d = float(np.linalg.norm(va.astype(np.float64) - vb))
    cos = float(va @ vb / np.linalg.norm(va) / np.linalg.norm(vb))
    for x, y in ((files[0], files[1]), (a, b), (a.force_vector, b.force_vector), (va, vb)):
        assert abs(bliss_tpu_torch.distance(x, y, device="cpu") - d) <= 1e-5
        assert abs(bliss_tpu_torch.cosine_similarity(x, y, device="cpu") - cos) <= 1e-5
    assert abs(bliss_tpu_torch.distance_file(files[0], files[1], device="cpu") - d) <= 1e-5
    assert abs(bliss_tpu_torch.cosine_similarity_file(files[0], files[1], device="cpu") - cos) <= 1e-5
    assert abs(d - bliss_tpu.distance(*jax_songs)) <= 3e-3


@pytest.mark.parametrize("fn", ["distance_file", "cosine_similarity_file"])
def test_file_functions_return_unexpected_on_a_broken_file(files, fn):
    got = getattr(bliss_tpu_torch, fn)(files[0], files[2], device="cpu")
    assert got == getattr(bliss_tpu, fn)(files[0], files[2]) == -2.0
    with pytest.raises(bliss_tpu_torch.io.DecodeError):
        bliss_tpu_torch.Song(files[2], device="cpu")


@pytest.mark.parametrize(
    "method, item",
    [("amplitude_analysis", "M7"), ("frequency_analysis", "M7"),
     ("envelope_analysis", "M7")],
)
def test_unported_methods_raise(files, method, item):
    """The per-analyzer methods that ROADMAP item ``item`` ported run the
    XLA-path analyzer on the Song's device and set its force_vector fields,
    as bliss_tpu's do: under ``for_parity()`` within 1e-5 of bliss_tpu's,
    under the main path's config (bliss_tpu's ``for_tpu()``) within 5e-4,
    beats identical under both."""
    assert item == "M7"
    fields = {"amplitude_analysis": ("amplitude",), "frequency_analysis": ("frequency",),
              "envelope_analysis": ("tempo", "attack")}[method]
    for cfg, jcfg, tol in ((AnalysisConfig.for_parity(), JConfig.for_parity(), 1e-5),
                           (AnalysisConfig.for_gpu(), JConfig.for_tpu(), 5e-4)):
        port = bliss_tpu_torch.Song(device="cpu")
        port.decode(files[1])
        ref = bliss_tpu.Song()
        ref.decode(files[1])
        got = np.atleast_1d(getattr(port, method)(cfg))
        want = np.atleast_1d(getattr(ref, method)(jcfg))
        assert [getattr(port.force_vector, f) for f in fields] == got.tolist()
        if method == "envelope_analysis":
            assert got[0] == want[0]  # beats
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_extended_analysis_matches_jax(jax_songs, port_songs):
    """``Song.extended_analysis`` against bliss_tpu's on the same files, each
    package under its own default config (bliss_tpu's CPU default is its
    float64 parity config), within EXTENDED_GATES; bpm counts the beats of
    the Song's own tempo; the hybrid config within the gates of the main
    path's."""
    from bliss_tpu_torch.features.extended import EXTENDED_FEATURE_NAMES, EXTENDED_GATES

    for got_song, ref_song in zip(port_songs, jax_songs):
        got = got_song.extended_analysis()
        ref = ref_song.extended_analysis()
        assert list(got) == list(ref) == list(EXTENDED_FEATURE_NAMES)
        hyb = got_song.extended_analysis(AnalysisConfig.for_gpu_hybrid(), device="cpu")
        dur = got_song.duration
        beats = round((got_song.force_vector.tempo + 30.4) * dur / 4.0)
        assert got["bpm"] * dur / 60.0 == pytest.approx(beats, rel=1e-6)
        g, r, h = (np.array(list(x.values()), np.float64) for x in (got, ref, hyb))
        for name, lo, hi, gate in EXTENDED_GATES:
            scale = dur / 60.0 if lo == 5 else 1.0
            assert np.abs(g[lo:hi] - r[lo:hi]).max() * scale <= gate, name
            assert np.abs(g[lo:hi] - h[lo:hi]).max() * scale <= gate, name


def test_mapping_interface():
    s = bliss_tpu_torch.Song(initial_values={"title": "t", "force_vector": {"tempo": 1.0}}, device="cpu")
    assert s["title"] == "t" and s.force_vector == api.ForceVector(tempo=1.0)
    assert s["force_vector"] == {"tempo": 1.0, "amplitude": 0.0, "frequency": 0.0, "attack": 0.0}
    assert s["calm_or_loud"] == bliss_tpu_torch.BL_UNKNOWN
    with pytest.raises(KeyError):
        s["device"]
    with pytest.raises(KeyError):
        s["nope"] = 1
    s.sample_array = np.zeros(4, np.int16)
    with s:
        pass
    assert s.sample_array is None
    with pytest.raises(ValueError, match="no filename"):
        s.decode()


def test_a_long_song_is_logged_and_analyzed_whole(files):
    """Above ``LONG_SONG_SAMPLES`` a Song streams on its device, as
    bliss_tpu's does: ``analyze`` calls ``analyze_song_streaming``, its
    vector is that function's, and it counts the beats of bliss_tpu's
    streamed Song within 5e-4 elsewhere (ROADMAP's float32 gate)."""
    real = streaming.analyze_song_streaming
    devices = []

    def spy(*args, **kwargs):
        devices.append(kwargs["device"])
        return real(*args, **kwargs)

    with mock.patch.object(api, "LONG_SONG_SAMPLES", 50_000), \
            mock.patch.object(streaming, "analyze_song_streaming", spy):
        s = bliss_tpu_torch.Song(files[0], device="cpu")
    assert devices == [torch.device("cpu")]
    row = real(s.sample_array, s.duration, AnalysisConfig.for_gpu(), device="cpu")
    np.testing.assert_array_equal(s.force_vector.as_array(), row)
    with mock.patch.object(bliss_tpu.api, "LONG_SONG_SAMPLES", 50_000):
        ref = bliss_tpu.Song()
        ref.analyze(files[0], cfg=JConfig.for_tpu())
    assert s.force_vector.tempo == ref.force_vector.tempo  # equal beat counts
    np.testing.assert_allclose(
        s.force_vector.as_array()[1:], ref.force_vector.as_array()[1:], rtol=0, atol=5e-4
    )
    assert api.LONG_SONG_SAMPLES == bliss_tpu.api.LONG_SONG_SAMPLES


def test_a_long_song_streams_under_an_xla_path_config(files):
    """Under ``AnalysisConfig()`` (the XLA-path stage, the float32 device
    finish) a Song above ``LONG_SONG_SAMPLES`` streams too (M7b), with the
    float64 finish: its vector is ``analyze_song_streaming``'s, and
    bliss_tpu's streamed Song's (beats identical, the rest within 5e-4)."""
    cfg = AnalysisConfig()
    with mock.patch.object(api, "LONG_SONG_SAMPLES", 50_000):
        s = bliss_tpu_torch.Song(device="cpu")
        s.analyze(files[0], cfg=cfg)
    row = streaming.analyze_song_streaming(s.sample_array, s.duration, cfg, device="cpu")
    np.testing.assert_array_equal(s.force_vector.as_array(), row)
    with mock.patch.object(bliss_tpu.api, "LONG_SONG_SAMPLES", 50_000):
        ref = bliss_tpu.Song()
        ref.analyze(files[0], cfg=JConfig())
    assert s.force_vector.tempo == ref.force_vector.tempo  # equal beat counts
    np.testing.assert_allclose(
        s.force_vector.as_array()[1:], ref.force_vector.as_array()[1:], rtol=0, atol=5e-4
    )


def test_version_and_exports():
    assert bliss_tpu_torch.version() == bliss_tpu.version() == bliss_tpu_torch.__version__
    assert set(bliss_tpu.__all__) <= set(bliss_tpu_torch.__all__)
    assert bliss_tpu_torch.BL_UNEXPECTED == bliss_tpu.BL_UNEXPECTED


def test_entry_points_default_to_the_gpu(files):
    """Without ``device`` every entry point that analyzes runs on the GPU;
    where there is none it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    for call in (
        lambda: bliss_tpu_torch.Song(files[0]),
        lambda: bliss_tpu_torch.analyze(files[0]),
        lambda: bliss_tpu_torch.distance_file(files[0], files[1]),
        lambda: bliss_tpu_torch.cosine_similarity_file(files[0], files[1]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
