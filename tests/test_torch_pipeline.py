"""The port's library pipeline against bliss_tpu.pipeline.analyze_library on
the same synthetic FLAC library: rows, ok flags, errors and stats keys;
padding invariance; store resume, cancellation and cross-package stores;
extended scans."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from conftest import synth_pcm
from test_torch_slice import _check_force_vectors
from bliss_tpu import pipeline as jpipeline
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.io.flac_writer import write_flac
from bliss_tpu.store import FeatureStore as JStore

from bliss_tpu_torch import pipeline
from bliss_tpu_torch.features import streaming
from bliss_tpu_torch.io import decode
from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.analyze import analyze_batch
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.store import FeatureStore

torch.set_num_threads(1)

# (samples written, channels, sample rate); write_flac pads each file to
# whole 4096-frame blocks and decode gives interleaved stereo at 22.05 kHz.
# At batch_size 2 the five songs (73728..98304 samples) share the 98304
# bucket, in batches of 2, 2 and 1 plus a dummy row; the clip (49152
# samples, 1 s) has its own, under the 65536 at which bliss_tpu's Pallas
# kernels take over from its XLA path. Two shapes keep bliss_tpu's compile
# time down.
SONGS = [
    (70_000, 2, 22050),
    (40_000, 1, 22050),  # mono: 81920 samples once upmixed
    (150_000, 2, 44100),  # resampled: 77824 samples
    (80_000, 2, 22050),
    (95_000, 2, 22050),  # 98304 samples: the longest
    (49_152, 2, 22050),  # the clip
]
BROKEN_AT = 3


def _write_library(d):
    files = []
    for i, (n, ch, sr) in enumerate(SONGS):
        rng = np.random.RandomState(60 + i)
        pcm = synth_pcm(rng, n, amp=int(rng.randint(3000, 14000)))
        files.append(str(d / f"song{i}.flac"))
        write_flac(files[-1], pcm.reshape(-1, ch), sr, tags={"TITLE": f"song {i}"})
    bad = d / "broken.flac"
    bad.write_bytes(b"not audio at all")
    files.insert(BROKEN_AT, str(bad))
    return files


@pytest.fixture(scope="session")
def scans(tmp_path_factory):
    """One scan of the library by each package, each into a store of its
    own."""
    d = tmp_path_factory.mktemp("torch_pipeline")
    files = _write_library(d)
    ref = jpipeline.analyze_library(
        files, cfg=JConfig.for_tpu(), batch_size=2, long_song_samples=None,
        store=JStore(str(d / "jax_store")), handle_sigint=False,
    )
    port = pipeline.analyze_library(
        files, cfg=AnalysisConfig.for_gpu(), batch_size=2, device="cpu",
        store=FeatureStore(str(d / "port_store")), handle_sigint=False,
    )
    return {"dir": d, "files": files, "ref": ref, "port": port}


def _check_rows(port, ref):
    assert port.files == ref.files
    assert port.ok.tolist() == ref.ok.tolist()
    assert port.errors == ref.errors
    assert np.isnan(port.features[~port.ok]).all()
    _check_force_vectors(port.features[port.ok], ref.features[ref.ok])


def test_analyze_library_matches_jax(scans):
    port, ref = scans["port"], scans["ref"]
    _check_rows(port, ref)
    assert port.ok.sum() == len(SONGS) and list(port.errors) == [scans["files"][BROKEN_AT]]
    assert port.extended is None
    np.testing.assert_allclose(port.force(), ref.force(), rtol=0, atol=3e-3, equal_nan=True)


def test_stats_carry_the_same_stages_as_jax(scans):
    port, ref = scans["port"].stats, scans["ref"].stats
    assert sorted(port) == sorted(ref)
    for stage in ("pad", "device_dispatch", "device_finalize", "finalize_wait", "scan"):
        assert set(port[stage]) == {"seconds", "cpu_seconds", "count"}
        assert port[stage]["count"] == ref[stage]["count"]
    assert port["decoded"] == ref["decoded"] == len(SONGS) + 1
    assert port["errors"] == 1 and port["cancelled"] is False


def test_hybrid_config_matches_jax(scans):
    port = pipeline.analyze_library(
        scans["files"], cfg=AnalysisConfig.for_gpu_hybrid(), batch_size=2,
        device="cpu", handle_sigint=False,
    )
    _check_rows(port, scans["ref"])


@pytest.mark.parametrize("n", [1, 1000, 1024, 49_152, 49_153, 65_536, 300_000, 6_000_000, 1 << 23])
def test_bucket_length_matches_jax(n):
    assert pipeline._bucket_length(n, 1024) == jpipeline._bucket_length(n, 1024)


def test_a_song_gives_the_same_vector_alone_and_in_a_longer_bucket():
    """Padding invariance: the row of a song does not depend on its bucket
    length or on its batch mates (the store key leaves pad_multiple out on
    that ground), up to the float32 summation order of the amplitude."""
    rng = np.random.RandomState(12)
    song = synth_pcm(rng, 90_000)
    long_mate = synth_pcm(rng, 200_000, amp=3000)
    cfg = AnalysisConfig.for_gpu()
    alone = analyze_batch(PCMBatch.from_arrays([song], [2], device="cpu"), cfg).numpy()
    batch = PCMBatch.from_arrays([long_mate, song], [4, 2], pad_multiple=65536, device="cpu")
    assert batch.samples.shape[1] == 262_144
    mixed = analyze_batch(batch, cfg).numpy()
    # beats, frequency and attack identical; the amplitude integral sums the
    # padding's blocks in float32 too, so its order moves with L by an ulp
    # or so, as in bliss_tpu's for_tpu() (6.2e-6 on this song)
    assert np.array_equal(mixed[1, [0, 2, 3]], alone[0, [0, 2, 3]])
    np.testing.assert_allclose(mixed[1, 1], alone[0, 1], rtol=0, atol=1e-5)


def test_store_resumes_every_row(scans):
    store = FeatureStore(str(scans["dir"] / "port_store"))  # fresh load from disk
    assert len(store) == len(SONGS)
    again = pipeline.analyze_library(
        scans["files"], cfg=AnalysisConfig.for_gpu(), batch_size=2, device="cpu",
        store=store, handle_sigint=False,
    )
    assert again.stats.get("device_dispatch", {"count": 0})["count"] == 0
    # only the broken file is decoded again: it never reached the store
    assert again.stats["decoded"] == 1
    np.testing.assert_array_equal(again.features, scans["port"].features)
    assert again.ok.tolist() == scans["port"].ok.tolist()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_written_by_one_package_resumes_in_the_other(scans, writer):
    """Same on-disk format and the same config key: for_gpu() has for_tpu()'s
    field values, so each package's scan resumes from the other's store."""
    path = str(scans["dir"] / f"{writer}_store")
    if writer == "jax":
        again = pipeline.analyze_library(
            scans["files"], cfg=AnalysisConfig.for_gpu(), batch_size=2,
            device="cpu", store=FeatureStore(path), handle_sigint=False,
        )
    else:
        again = jpipeline.analyze_library(
            scans["files"], cfg=JConfig.for_tpu(), batch_size=2,
            long_song_samples=None, store=JStore(path), handle_sigint=False,
        )
    assert again.stats.get("device_dispatch", {"count": 0})["count"] == 0
    np.testing.assert_array_equal(again.features, scans["ref" if writer == "jax" else "port"].features)
    assert dataclasses.asdict(AnalysisConfig.for_gpu()) == dataclasses.asdict(JConfig.for_tpu())


def test_cancel_event_drains_and_resumes(tmp_path):
    """A cancel Event stops the scan after in-flight work drains; the next
    run resumes losslessly from the store (tests/test_pipeline.py's
    cancellation test, on the port)."""
    rng = np.random.RandomState(3)
    files = []
    for i in range(8):
        frames = rng.randint(-15000, 15000, size=(30_000 + 512 * i, 2))
        files.append(str(tmp_path / f"song{i}.flac"))
        write_flac(files[-1], frames.astype(np.int16), 22050)
    store = FeatureStore(str(tmp_path / "store"))
    cancel = threading.Event()

    def progress(done, total, msg):
        if done >= 2:  # cancel once the first batch lands
            cancel.set()

    cfg = AnalysisConfig.for_gpu()
    r1 = pipeline.analyze_library(
        files, cfg=cfg, batch_size=2, store=store, progress=progress,
        cancel=cancel, device="cpu",
    )
    assert r1.stats["cancelled"]
    n_done = int(r1.ok.sum())
    assert 0 < n_done <= len(files)
    assert np.isfinite(r1.features[r1.ok]).all()

    store2 = FeatureStore(str(tmp_path / "store"))
    assert len(store2) == n_done  # completed work persisted
    r2 = pipeline.analyze_library(files, cfg=cfg, batch_size=2, store=store2, device="cpu")
    assert not r2.stats["cancelled"]
    assert r2.ok.all()
    np.testing.assert_array_equal(r2.features[r1.ok], r1.features[r1.ok])


def test_a_long_song_is_logged_and_stays_on_the_bucket_path(scans):
    """A song above ``long_song_samples`` is streamed, as bliss_tpu's
    pipeline streams it: the scan's ``streaming`` stage ran once, the song's
    row is the port's ``analyze_song_streaming`` of it, it counts the beats
    of bliss_tpu's scan under the same threshold and lies within 5e-4 of it
    (ROADMAP's float32 gate), and every other row is the bucket scan's."""
    files, cfg = scans["files"], AnalysisConfig.for_gpu()
    r = pipeline.analyze_library(
        files, cfg=cfg, batch_size=2, device="cpu", handle_sigint=False,
        long_song_samples=90_000,
    )
    assert r.ok.sum() == len(SONGS) and r.stats["streaming"]["count"] == 1
    d = decode(files[5])  # the one song above 90 000 samples
    assert d.n_samples > 90_000
    row = streaming.analyze_song_streaming(d.samples, d.duration, cfg, device="cpu")
    np.testing.assert_array_equal(r.features[5], row)
    others = np.arange(len(files)) != 5
    np.testing.assert_array_equal(r.features[others], scans["port"].features[others])
    ref = jpipeline.analyze_library(
        files, cfg=JConfig.for_tpu(), batch_size=2, long_song_samples=90_000,
        handle_sigint=False,
    )
    assert ref.stats["streaming"]["count"] == 1
    assert r.features[5, 0] == ref.features[5, 0]  # equal beat counts
    np.testing.assert_allclose(r.features[5, 1:], ref.features[5, 1:], rtol=0, atol=5e-4)


@pytest.mark.parametrize("shape", [(2, 1)], ids=["mesh"])
def test_unported_options_raise(scans, shape):
    """Formerly the M10 refusal: ``analyze_library`` with a mesh
    (``[cpu] * 2``: the 98304 bucket's shards take the kernels, the clip's
    the XLA branch) gives the rows of the scan without one, a long song
    streamed on the scan's device (beats identical, the rest within
    5e-4)."""
    from bliss_tpu_torch.parallel import analysis_mesh

    mesh = analysis_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    r = pipeline.analyze_library(scans["files"], cfg=AnalysisConfig.for_gpu(), batch_size=2,
                                 mesh=mesh, device="cpu", long_song_samples=90_000,
                                 handle_sigint=False)
    port = scans["port"]
    assert r.ok.tolist() == port.ok.tolist() and r.errors == port.errors
    assert r.stats["streaming"]["count"] == 1
    np.testing.assert_array_equal(r.features[r.ok, 0], port.features[port.ok, 0])
    np.testing.assert_allclose(r.features[r.ok], port.features[port.ok], rtol=0, atol=5e-4)


@pytest.mark.parametrize("name", ["main", "hybrid"])
def test_an_extended_scan_fills_extended_and_keeps_49_column_entries(scans, tmp_path, name):
    """``extended=True``: ``ScanResult.extended`` [N, 45], NaN for the
    broken file; batch rows as ``analyze_batch_ext`` of the same songs in
    the same bucket, a long song's as ``analyze_song_streaming(...,
    extended=True)``; the core rows those of the plain scan; 49-column
    store entries, taken again by an extended rescan and not by a plain one
    (which analyzes again), as bliss_tpu's pipeline does."""
    from bliss_tpu_torch.features.analyze import analyze_batch_ext

    files = scans["files"]
    cfg = AnalysisConfig.for_gpu() if name == "main" else AnalysisConfig.for_gpu_hybrid()
    store = FeatureStore(str(tmp_path / "store"))
    r = pipeline.analyze_library(files, cfg=cfg, batch_size=2, device="cpu", store=store,
                                 handle_sigint=False, long_song_samples=90_000, extended=True)
    assert r.extended.shape == (len(files), 45) and r.extended.dtype == np.float32
    assert np.isnan(r.extended[BROKEN_AT]).all() and not r.ok[BROKEN_AT]
    assert np.isfinite(r.extended[r.ok]).all() and r.stats["streaming"]["count"] == 1
    plain = pipeline.analyze_library(files, cfg=cfg, batch_size=2, device="cpu",
                                     handle_sigint=False, long_song_samples=90_000)
    np.testing.assert_array_equal(r.features, plain.features)
    d = decode(files[5])
    row = streaming.analyze_song_streaming(d.samples, d.duration, cfg, extended=True, device="cpu")
    np.testing.assert_array_equal(r.extended[5], row[4:])
    pair = [decode(files[i]) for i in (0, 1)]  # scanned together in the 98304 bucket
    batch = PCMBatch.from_arrays([p.samples for p in pair], [p.duration for p in pair],
                                 pad_multiple=98304, device="cpu")
    np.testing.assert_array_equal(r.extended[:2], analyze_batch_ext(batch, cfg).numpy()[:, 4:])
    assert {v.shape for _, v in FeatureStore(str(tmp_path / "store")).items()} == {(49,)}

    again = pipeline.analyze_library(files, cfg=cfg, batch_size=2, device="cpu", extended=True,
                                     store=FeatureStore(str(tmp_path / "store")), handle_sigint=False)
    assert "device_dispatch" not in again.stats  # every row from the store
    np.testing.assert_array_equal(again.extended, r.extended, strict=True)
    narrow = pipeline.analyze_library(files, cfg=cfg, batch_size=2, device="cpu",
                                      store=FeatureStore(str(tmp_path / "store")), handle_sigint=False,
                                      long_song_samples=90_000)
    # two batches and the clip's; the long song streams
    assert narrow.stats["device_dispatch"]["count"] == 3 and narrow.extended is None
    np.testing.assert_array_equal(narrow.features, plain.features)


M7_CHANGES = {"float64": {"dtype": "float64"}, "xla_path": {"fused_kernel": False}}


@pytest.fixture(scope="module")
def m7_refs(scans):
    """bliss_tpu's scan of the library under each hybrid XLA-path config."""
    return {
        name: jpipeline.analyze_library(
            scans["files"], cfg=dataclasses.replace(JConfig.for_tpu_hybrid(), **change),
            batch_size=2, long_song_samples=None, handle_sigint=False)
        for name, change in M7_CHANGES.items()
    }


@pytest.mark.parametrize("entry", ["analyze_library", "_scan"])
@pytest.mark.parametrize("change", list(M7_CHANGES), ids=list(M7_CHANGES))
def test_an_unported_hybrid_config_is_refused_before_any_decode(scans, m7_refs, entry, change):
    """A tempo_finish="host" config that takes the XLA-path stage (the
    float64 config, the XLA path; once refused, ported as ROADMAP items M7
    and M7b) scans: every row ok and bliss_tpu's (beats identical, float64
    within 1e-5, float32 within 5e-4), the store keyed by its config, and
    the longest song, above ``long_song_samples``, streamed (the
    ``streaming`` stage once) while the others take two buckets."""
    cfg = dataclasses.replace(AnalysisConfig.for_gpu_hybrid(), **M7_CHANGES[change])
    assert streaming.streaming_supports(cfg)
    store = FeatureStore(str(scans["dir"] / f"m7_{entry}_{change}"))
    files = scans["files"]
    if entry == "analyze_library":
        result = pipeline.analyze_library(
            files, cfg=cfg, batch_size=2, device="cpu", store=store, handle_sigint=False,
            long_song_samples=90_000,
        )
        assert len(store) == len(SONGS)
        stats = result.stats
    else:
        result = pipeline.ScanResult(
            list(files), np.full((len(files), 4), np.nan, np.float32),
            np.zeros(len(files), bool), {}, {},
        )
        decoded = [None if i == BROKEN_AT else decode(f) for i, f in enumerate(files)]
        timer = pipeline.StageTimer()
        pipeline._scan(
            result, enumerate(decoded), cfg=cfg, batch_size=2,
            device=torch.device("cpu"), timer=timer, long_song_samples=90_000,
        )
        stats = timer.report()
    assert sum(decode(f).n_samples > 90_000 for f in files if f != files[BROKEN_AT]) == 1
    ref = m7_refs[change]
    assert result.ok.tolist() == ref.ok.tolist()
    assert stats["streaming"]["count"] == 1 and stats["device_dispatch"]["count"] == 3
    got, want = result.features[result.ok], ref.features[ref.ok]
    assert np.array_equal(got[:, 0], want[:, 0])  # beats
    tol = 1e-5 if cfg.dtype == "float64" else 5e-4
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["default", "parity"])
def test_an_xla_path_long_song_streams_as_bliss_tpu_streams_it(scans, name):
    """Under ``AnalysisConfig()`` and ``for_parity()`` (the XLA-path stage)
    ``analyze_library`` streams the song above ``long_song_samples`` (the
    ``streaming`` stage once, M7b), and its row is bliss_tpu's
    ``analyze_library`` row at the same ``long_song_samples``, which
    streams it too: beats identical, float32 within 5e-4, float64 within
    1e-5. Under ``for_parity()`` every row is held so; under
    ``AnalysisConfig()`` the bucketed rows take the float32 working-dtype
    finish, which flips marginal beats in both packages
    (``tests/test_torch_modes.py::check_f32_finish`` holds those)."""
    cfg, jcfg = {"default": (AnalysisConfig(), JConfig()),
                 "parity": (AnalysisConfig.for_parity(), JConfig.for_parity())}[name]
    files = scans["files"]
    got = pipeline.analyze_library(files, cfg=cfg, batch_size=2, device="cpu",
                                   handle_sigint=False, long_song_samples=90_000)
    ref = jpipeline.analyze_library(files, cfg=jcfg, batch_size=2, handle_sigint=False,
                                    long_song_samples=90_000)
    assert got.stats["streaming"]["count"] == ref.stats["streaming"]["count"] == 1
    assert got.ok.tolist() == ref.ok.tolist()
    long = [i for i, f in enumerate(files) if got.ok[i] and decode(f).n_samples > 90_000]
    rows = slice(None) if name == "parity" else long
    a, b = got.features[rows], ref.features[rows]
    a, b = a[np.isfinite(b[:, 0])], b[np.isfinite(b[:, 0])]  # the failed file's NaN row
    assert len(long) == 1 and np.array_equal(a[:, 0], b[:, 0])  # beats
    tol = 1e-5 if cfg.dtype == "float64" else 5e-4
    np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=tol)


def test_scan_defaults_to_the_gpu(scans):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.analyze_library(scans["files"])
