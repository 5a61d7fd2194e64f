"""The port's CLI (``bliss_tpu_torch.cli``, on ``--device cpu``) against
``bliss_tpu``'s on the same inputs: a scan of a small FLAC library against
both packages' ``analyze_library``, the playlist against
``bliss_tpu.sim.playlist_order``, radio against ``bliss_tpu.sim.kmeans``,
and every ``store`` action through both CLIs on copies of one store; the
``--extended`` surfaces of ``analyze``, ``scan`` and ``radio``; the
reference filterbanks; the options of unported parts, and the default
device without a GPU."""

import csv
import dataclasses
import os
import shutil
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_pcm
from bliss_tpu import cli as jcli
from bliss_tpu import pipeline as jpipeline
from bliss_tpu import sim as jsim
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import EXTENDED_FEATURE_NAMES as JAX_EXTENDED_NAMES

from bliss_tpu_torch import api, cli, pipeline
from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES
from bliss_tpu_torch.io.flac_writer import write_flac
from bliss_tpu_torch.store import FeatureStore

torch.set_num_threads(1)

# interleaved samples written; padded by write_flac to whole 4096-frame
# blocks, all six decode to 81920..98304 samples: one 98304 bucket, one
# batch of 6, so bliss_tpu compiles one shape
LENGTHS = [74_000, 78_000, 82_000, 86_000, 90_000, 94_000]
SEED_SONG = 2


@pytest.fixture(scope="session")
def library(tmp_path_factory):
    """Six FLAC songs, the port's CLI scan of them into a store, and both
    packages' ``analyze_library`` rows."""
    root = tmp_path_factory.mktemp("torch_cli")
    lib = root / "lib"
    lib.mkdir()
    files = []
    for i, n in enumerate(LENGTHS):
        rng = np.random.RandomState(70 + i)
        pcm = synth_pcm(rng, n, amp=int(rng.randint(3000, 14000)))
        files.append(str(lib / f"song{i}.flac"))
        write_flac(files[-1], pcm.reshape(-1, 2), 22050, tags={"TITLE": f"song {i}"})
    out = root / "features.csv"
    rc = cli.main(["--device", "cpu", "scan", str(lib), "--batch-size", "6",
                   "--store", str(root / "store"), "-o", str(out)])
    assert rc == 0
    with open(out, newline="") as f:
        rows = list(csv.reader(f, delimiter=";"))
    port = pipeline.analyze_library(files, batch_size=6, device="cpu", handle_sigint=False)
    # extended: one bliss_tpu program gives the core rows and the 45 columns
    ref = jpipeline.analyze_library(files, cfg=JConfig.for_tpu(), batch_size=6,
                                    long_song_samples=None, handle_sigint=False, extended=True)
    return {"root": root, "lib": lib, "files": files, "csv": rows, "port": port, "ref": ref}


def test_scan_csv_is_analyze_library_and_matches_jax(library):
    rows, port, ref = library["csv"], library["port"], library["ref"]
    assert rows[0] == ["filename", "tempo", "amplitude", "frequency", "attack", "force"]
    assert [r[0] for r in rows[1:]] == library["files"]
    got = np.array([[float(x) for x in r[1:]] for r in rows[1:]])
    want = np.concatenate([port.features, port.force()[:, None]], axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)  # "%f" keeps 6 decimals
    assert port.ok.all() and ref.ok.all()
    np.testing.assert_array_equal(port.features[:, 0], ref.features[:, 0])  # beats
    np.testing.assert_allclose(port.features[:, 1:], ref.features[:, 1:], rtol=0, atol=5e-4)


def _decode_nothing(paths, **kw):
    """``iter_decode`` where every row must come from the store."""
    assert not list(paths), paths
    return iter(())


@pytest.mark.parametrize("length", [None, 4])
def test_playlist_m3u_is_jax_playlist_order_resumed_from_the_store(library, tmp_path, length):
    files, rows = library["files"], library["port"].features
    out = tmp_path / "p.m3u"
    argv = ["--device", "cpu", "playlist", files[SEED_SONG], str(library["lib"]),
            "--store", str(library["root"] / "store"), "--batch-size", "6", "-o", str(out)]
    if length:
        argv += ["--length", str(length)]
    with mock.patch.object(pipeline, "iter_decode", _decode_nothing):
        assert cli.main(argv) == 0
    order = np.asarray(jsim.playlist_order(jnp.asarray(rows), SEED_SONG))[:length]
    assert out.read_text().splitlines() == ["#EXTM3U"] + [os.path.abspath(files[i]) for i in order]


def test_analyze_and_distance_print_bliss_tpus_lines(library, capsys):
    """Line for line the reference example's report; the values are the
    port's ``Song`` (float32 main path) where ``bliss_tpu``'s CPU default is
    its float64 parity config: beats equal, the rest within 1e-3."""
    f0, f1 = library["files"][:2]
    assert cli.main(["--device", "cpu", "analyze", f0]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jcli.main(["analyze", f0]) == 0
    ref = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in port] == [ln.split(":")[0] for ln in ref]
    song = api.Song(f0, device="cpu")
    fv = song.force_vector
    assert port[3] == f"Force vector: ({fv.tempo:f}, {fv.amplitude:f}, {fv.frequency:f}, {fv.attack:f})"
    for a, b in zip(port, ref):
        if a.startswith("Force"):
            got = np.array(a.split(":")[1].strip(" ()").split(", "), float)
            np.testing.assert_allclose(got, np.array(b.split(":")[1].strip(" ()").split(", "), float),
                                       atol=1e-3 if a.startswith("Force vector") else 3e-3)
        else:
            assert a == b
    assert cli.main(["--device", "cpu", "distance", f0, f1]) == 0
    lines = capsys.readouterr().out.splitlines()
    d = api.distance(song, api.Song(f1, device="cpu"))
    assert lines[0] == f"Distance between the two songs: {d:f}"
    assert lines[1].startswith("Cosine similarity between the two songs: ")


def test_ml_analyze_csv_matches_scan(library, tmp_path):
    out = tmp_path / "ml.csv"
    assert cli.main(["--device", "cpu", "ml-analyze", str(library["lib"]), "--batch-size", "6",
                     "-o", str(out)]) == 0
    with open(out, newline="") as f:
        rows = list(csv.reader(f, delimiter=";"))
    assert [r[0] for r in rows] == [f"song{i}" for i in range(len(LENGTHS))]
    assert [r[1:] for r in rows] == [r[1:5] for r in library["csv"][1:]]


def _blob_result(names):
    rng = np.random.RandomState(8)
    centres = np.array([[-8, -12, -10, -15], [-2, -9, -11, -14], [-9, -5, -6, -12]], np.float32)
    feats = np.concatenate([c + 0.3 * rng.randn(len(names) // 3, 4) for c in centres])
    return types.SimpleNamespace(features=feats.astype(np.float32), ok=np.ones(len(names), bool))


def test_radio_gives_jax_kmeans_partition(tmp_path):
    """On well-separated rows both CLIs' radio playlists and
    ``bliss_tpu.sim.kmeans`` make the same partition, up to the labels."""
    (tmp_path / "lib").mkdir()
    names = [str(tmp_path / "lib" / f"s{i:02d}.flac") for i in range(30)]
    for n in names:
        open(n, "wb").close()
    res = _blob_result(names)
    parts = {}
    for who, main, mod, extra in (("port", cli.main, pipeline, ["--device", "cpu"]),
                                  ("jax", jcli.main, jpipeline, [])):
        out = tmp_path / who
        out.mkdir()
        with mock.patch.object(mod, "analyze_library", return_value=res):
            assert main([*extra, "radio", str(tmp_path / "lib"), "--clusters", "3",
                         "--output-dir", str(out)]) == 0
        parts[who] = {frozenset((out / f"radio-{c:02d}.m3u").read_text().splitlines()[1:])
                      for c in range(3)}
    _, assign = jsim.kmeans(jnp.asarray(res.features), k=3, iters=50)
    assign = np.asarray(assign)
    want = {frozenset(os.path.abspath(names[i]) for i in np.nonzero(assign == c)[0]) for c in range(3)}
    assert parts["port"] == parts["jax"] == want
    assert all(len(p) == 10 for p in want)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """A store filled with ``put``: dyadic vectors (every float32 product in
    the distances exact, so both packages see the same d^2 and the same
    ties), exact and near duplicates under names of their own, a row as wide
    as bliss_tpu's --extended rows, tags with the ';' delimiter, and two
    entries whose files are gone (for prune)."""
    d = tmp_path_factory.mktemp("torch_cli_store")
    rng = np.random.RandomState(4)
    path = str(d / "store")
    s = FeatureStore(path)
    vecs = rng.randint(-40, 40, size=(40, 4)) / 8.0
    vecs[11] = vecs[3]  # an exact duplicate
    vecs[25] = vecs[17] + [0.125, 0, 0, 0]  # a near one
    for i, v in enumerate(vecs):
        name = d / f"song{i:02d}.flac"
        if i not in (5, 30):
            name.write_bytes(b"x")
        s.put(f"k{i:02d}", v.astype(np.float32),
              {"filename": str(name), "title": f"t{i}; live" if i % 7 == 0 else f"t{i}",
               "artist": "a", "album": "b", "genre": "", "tracknumber": str(i)})
        if i == 19:
            s.flush()  # two shards
    wide = np.concatenate([vecs[8], rng.randint(-8, 8, size=45) / 4.0]).astype(np.float32)
    s.put("k08-ext", wide, {"filename": str(d / "song08.flac")})
    s.flush()
    return path


def _same_output(port, ref):
    """Same lines and ';' fields; numbers within 1e-5."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        fa, fb = a.split(";"), b.split(";")
        assert len(fa) == len(fb), (a, b)
        for x, y in zip(fa, fb):
            try:
                assert abs(float(x) - float(y)) <= 1e-5, (a, b)
            except ValueError:
                assert x == y, (a, b)


@pytest.mark.parametrize("opts", [
    ["stats"], ["compact"], ["export"], ["prune"], ["neighbors"], ["--top-k", "3", "neighbors"],
    ["dupes"], ["--threshold", "0.5", "--top-k", "2", "dupes"],
], ids=lambda o: "-".join(x.strip("-") for x in o))
def test_store_actions_match_bliss_tpu(store_dir, tmp_path, capsys, opts):
    outs = {}
    for who, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        copy = str(tmp_path / who)
        shutil.copytree(store_dir, copy)
        assert main([*extra, "store", *opts, copy]) == 0
        outs[who] = capsys.readouterr().out.replace(copy, "STORE").splitlines()
        after = sorted(f for f in os.listdir(copy) if not f.startswith("shard-"))
        outs[who + " files"] = (after, len(FeatureStore(copy)))
    _same_output(outs["port"], outs["jax"])
    assert outs["port files"] == outs["jax files"]
    assert len(outs["port"]) > 1 or opts[-1] in ("compact", "prune")


def test_store_export_names_the_extended_columns(store_dir, tmp_path):
    assert EXTENDED_FEATURE_NAMES == JAX_EXTENDED_NAMES
    out = tmp_path / "e.csv"
    assert cli.main(["store", "export", store_dir, "-o", str(out)]) == 0  # no device needed
    header = out.read_text().splitlines()[0].split(";")
    assert header[11:] == list(JAX_EXTENDED_NAMES)


def test_neighbors_csv_is_nearest_neighbors_all(store_dir, tmp_path):
    from bliss_tpu_torch.sim import nearest_neighbors_all
    from bliss_tpu_torch.store import similarity_rows

    out = tmp_path / "n.csv"
    assert cli.main(["--device", "cpu", "store", "neighbors", store_dir, "-o", str(out)]) == 0
    names, feats = similarity_rows(FeatureStore(store_dir))
    d, i = nearest_neighbors_all(feats, 5, device="cpu")
    rows = [r.split(";") for r in out.read_text().splitlines()[1:]]
    assert [r[0] for r in rows] == names
    assert [r[1::2] for r in rows] == [[names[j] for j in row] for row in i.tolist()]
    assert [r[2::2] for r in rows] == [[f"{x:f}" for x in row] for row in d.tolist()]


# the mesh runs of ROADMAP item M10 (once refused with status 2)
UNPORTED = [
    (["scan", "LIB", "--store", "S", "--mesh", "2"], "M10"),
    (["radio", "LIB", "--store", "S", "--mesh", "4x2"], "M10"),
    (["playlist", "F", "LIB", "--store", "S", "--mesh", "2"], "M10"),
    (["ml-analyze", "F", "--mesh", "2"], "M10"),
]


@pytest.mark.parametrize("argv,item", UNPORTED, ids=lambda x: "-".join(x) if isinstance(x, list) else x)
def test_unported_options_exit_2_before_any_decode_or_store_write(library, tmp_path, capsys, argv, item):
    """Formerly the refusal of ``--mesh`` (ROADMAP item M10): on ``--device
    cpu`` each command runs over a mesh of the CPU repeated ('2': 2 x 1, its
    shards on the kernels; '4x2': shards of 49 152 samples, the XLA
    branch) and analyzes the library's songs as the scan without a mesh:
    beats identical, the rest within 5e-4 (the store's rows, or
    ml-analyze's CSV)."""
    from bliss_tpu_torch.store import similarity_rows

    store, out = tmp_path / "store", tmp_path / "out"
    sub = {"F": library["files"][0], "LIB": str(library["lib"]), "S": str(store)}
    extra = {"scan": ["-o", str(out)], "playlist": ["-o", str(out)],
             "radio": ["--output-dir", str(tmp_path)], "ml-analyze": []}[argv[0]]
    capsys.readouterr()
    assert cli.main(["--device", "cpu", *[sub.get(a, a) for a in argv], *extra]) == 0
    files, want = library["files"], library["port"].features
    if argv[0] == "ml-analyze":
        (line,) = capsys.readouterr().out.splitlines()
        name, *cols = line.split(";")
        # "%f" keeps 6 decimals, far inside a beat (4 / duration)
        got, rows, beat_tol = np.array([[float(c) for c in cols]]), want[:1], 1e-5
        assert name == "song0"
    else:
        names, got = similarity_rows(FeatureStore(str(store)))
        rows, beat_tol = want[[files.index(n) for n in names]], 0
        assert sorted(names) == sorted(files)
    np.testing.assert_allclose(got[:, 0], rows[:, 0], rtol=0, atol=beat_tol)
    np.testing.assert_allclose(got, rows, rtol=0, atol=5e-4)


def test_mesh_on_cuda_needs_its_devices(library, tmp_path, monkeypatch, capsys):
    """``--mesh`` under ``--device cuda`` takes the first N·M CUDA devices:
    too few stop the command with bliss_tpu's text before any decode or
    store write (the device count patched: this machine has no GPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    store = tmp_path / "store"
    with mock.patch.object(pipeline, "iter_decode", side_effect=AssertionError("decoded")):
        with pytest.raises(SystemExit) as e:
            cli.main(["--device", "cuda", "scan", str(library["lib"]), "--store", str(store),
                      "--mesh", "2x2"])
    assert str(e.value.code) == "--mesh '2x2' needs 4 devices, have 2"
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "scan", str(library["lib"]), "--mesh", "2x2x1"])
    assert "expected 'N' or 'NxM' (data x seq shards)" in str(e.value.code)
    assert not store.exists()


FILTERBANK_RUNS = [
    (["analyze", "F", "--filterbank", "reference5"], "reference5"),
    (["scan", "LIB", "--store", "S", "--batch-size", "6", "--filterbank", "reference36",
      "-o", "OUT"], "reference36"),
]


@pytest.mark.parametrize("argv,filterbank", FILTERBANK_RUNS, ids=["analyze-reference5",
                                                                   "scan-reference36"])
def test_reference_filterbanks_run_and_match_jax_parity(library, tmp_path, capsys, argv,
                                                        filterbank):
    """``--filterbank reference5|reference36`` run through the port's
    kernels (F5) and count the beats of ``bliss_tpu``'s ``for_parity()`` with
    the same filterbank, the other columns within 5e-4."""
    from bliss_tpu_torch.config import AnalysisConfig

    out = tmp_path / "rows.csv"
    sub = {"F": library["files"][0], "LIB": str(library["lib"]), "S": str(tmp_path / "store"),
           "OUT": str(out)}
    assert cli.main(["--device", "cpu", *[sub.get(a, a) for a in argv]]) == 0
    printed = capsys.readouterr().out
    if argv[0] == "analyze":
        files = library["files"][:1]
        line = next(ln for ln in printed.splitlines() if ln.startswith("Force vector"))
        got = np.array([line.split(":")[1].strip(" ()").split(", ")], float)
    else:
        files = library["files"]
        with open(out, newline="") as f:
            rows = list(csv.reader(f, delimiter=";"))[1:]
        assert [r[0] for r in rows] == files
        got = np.array([[float(x) for x in r[1:5]] for r in rows])
        cfg = dataclasses.replace(AnalysisConfig.for_gpu(), filterbank=filterbank,
                                  nb_bands=None, band_taps=None)
        assert len(FeatureStore(sub["S"])) == len(files)
        port = pipeline.analyze_library(files, cfg=cfg, batch_size=6, device="cpu",
                                        handle_sigint=False)
        np.testing.assert_allclose(got, port.features, rtol=0, atol=5e-7)  # "%f"
    jcfg = dataclasses.replace(JConfig.for_parity(), filterbank=filterbank, nb_bands=None,
                               band_taps=None)
    ref = jpipeline.analyze_library(files, cfg=jcfg, batch_size=6, long_song_samples=None,
                                    handle_sigint=False).features
    # beats: one beat moves the tempo by 4 / duration, far above "%f"'s 5e-7
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=5e-4)


def test_a_config_check_supported_refuses_exits_2(library, capsys):
    """A config with a mode name neither package knows exits 2 before any
    decode, naming the field (every single-device config bliss_tpu runs is
    run, M7)."""
    from bliss_tpu_torch.config import AnalysisConfig

    unknown = AnalysisConfig(dtype="float32", amplitude_mode="nope")
    with mock.patch.object(cli, "_band_config", return_value=unknown), \
            mock.patch.object(pipeline, "iter_decode", side_effect=AssertionError("decoded")):
        assert cli.main(["--device", "cpu", "scan", str(library["lib"])]) == 2
    assert "unknown amplitude_mode 'nope'" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["scan", "LIB", "--store", "S"], ["analyze", "F"], ["store", "neighbors", "STORE"],
], ids=["scan", "analyze", "store-neighbors"])
def test_the_default_device_fails_without_a_gpu(library, store_dir, tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    sub = {"F": library["files"][0], "LIB": str(library["lib"]), "S": str(tmp_path / "s"),
           "STORE": store_dir}
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([sub.get(a, a) for a in argv])
    assert not (tmp_path / "s").exists()


def test_device_flag_and_env_fallback(monkeypatch):
    assert cli.build_parser().parse_args(["version"]).device == "cuda"
    monkeypatch.setenv("BLISS_TPU_TORCH_DEVICE", "cpu")
    assert cli.build_parser().parse_args(["version"]).device == "cpu"
    assert cli.build_parser().parse_args(["--device", "cuda:1", "version"]).device == "cuda:1"


def _options(parser, cmd) -> dict:
    """{dest: default} of subcommand ``cmd``'s arguments."""
    import argparse

    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices[cmd]._actions if a.dest != "help"}


@pytest.mark.parametrize("cmd", ["gui", "doctor", "serve", "call"])
def test_the_rest_of_m11_is_not_registered(cmd):
    """Named for when these four commands waited for the serving part of
    ROADMAP M11: each is now registered with bliss_tpu's arguments and
    defaults."""
    assert _options(cli.build_parser(), cmd) == _options(jcli.build_parser(), cmd)


def test_audio_files_are_collected_as_bliss_tpu_collects_them(library):
    root = library["root"]
    paths = [str(root), library["files"][0]]
    assert cli._collect_audio_files(paths) == jcli._collect_audio_files(paths)
    for name in ("a.flac", "b.mp3", "c.txt", "d.npz", "e.wav", "noext"):
        assert cli.is_audio_filename(name) == jcli.is_audio_filename(name)


def _within_extended_gates(got, ref, durations):
    from bliss_tpu_torch.features.extended import EXTENDED_GATES

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    for name, lo, hi, gate in EXTENDED_GATES:
        d = np.abs(got[:, lo:hi] - ref[:, lo:hi])
        if lo == 5:  # bpm, gated in beats
            d = d * np.asarray(durations, np.float64)[:, None] / 60.0
        assert d.max() <= gate, (name, d.max())


@pytest.fixture(scope="module")
def ext_scan(library, tmp_path_factory):
    """The port's CLI ``scan --extended`` of the library into a store of its
    own, and its CSV."""
    root = tmp_path_factory.mktemp("torch_cli_ext")
    out = root / "ext.csv"
    assert cli.main(["--device", "cpu", "scan", str(library["lib"]), "--batch-size", "6",
                     "--extended", "--store", str(root / "store"), "-o", str(out)]) == 0
    with open(out, newline="") as f:
        rows = list(csv.reader(f, delimiter=";"))
    return {"store": str(root / "store"), "csv": rows}


def test_scan_extended_writes_49_columns_and_rows(library, ext_scan):
    """``scan --extended``: bliss_tpu's header, the core columns of the plain
    scan, the extended columns of ``analyze_library(extended=True)`` and
    within EXTENDED_GATES of bliss_tpu's, and 49-column store entries."""
    rows = ext_scan["csv"]
    assert rows[0] == library["csv"][0] + list(JAX_EXTENDED_NAMES)
    assert [r[:6] for r in rows[1:]] == library["csv"][1:]
    port = pipeline.analyze_library(library["files"], batch_size=6, device="cpu",
                                    handle_sigint=False, extended=True)
    np.testing.assert_array_equal(port.features, library["port"].features)
    assert port.extended.shape == (len(LENGTHS), 45)
    assert [r[6:] for r in rows[1:]] == [[f"{v:f}" for v in e] for e in port.extended]
    durations = [api.Song(f, device="cpu").duration for f in library["files"]]
    _within_extended_gates(port.extended, library["ref"].extended, durations)
    store = FeatureStore(ext_scan["store"])
    assert len(store) == len(LENGTHS) and {v.shape for _, v in store.items()} == {(49,)}


def test_analyze_extended_prints_bliss_tpus_lines(library, capsys):
    """``analyze --extended``: the report, then one ``name: value`` line a
    feature, the values ``Song.extended_analysis``'s and within
    EXTENDED_GATES of bliss_tpu's CLI (its float64 parity default)."""
    f0 = library["files"][0]
    assert cli.main(["--device", "cpu", "analyze", f0, "--extended"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jcli.main(["analyze", f0, "--extended"]) == 0
    ref = capsys.readouterr().out.splitlines()
    assert len(port) == len(ref) == 16 + 45
    assert [ln.split(":")[0] for ln in port[16:]] == [ln.split(":")[0] for ln in ref[16:]] \
        == list(EXTENDED_FEATURE_NAMES)
    song = api.Song(f0, device="cpu")
    assert port[16:] == [f"{k}: {v:f}" for k, v in song.extended_analysis().items()]
    got, want = ([[float(ln.split(": ")[1]) for ln in out[16:]]] for out in (port, ref))
    _within_extended_gates(got, want, [song.duration])


def test_radio_extended_clusters_z_scored_rows(library, ext_scan, tmp_path):
    """``radio --extended`` resumed from the extended store: its lists are
    ``kmeans`` of the z-scored 49-column rows; and on well-separated rows
    both CLIs make the same partition, up to the labels."""
    from bliss_tpu_torch.sim import kmeans

    out = tmp_path / "radio"
    out.mkdir()
    with mock.patch.object(pipeline, "iter_decode", _decode_nothing):
        assert cli.main(["--device", "cpu", "radio", str(library["lib"]), "--clusters", "2",
                         "--store", ext_scan["store"], "--extended", "--output-dir", str(out)]) == 0
    rows = np.array([[float(x) for x in r[1:5] + r[6:]] for r in ext_scan["csv"][1:]], np.float32)
    full = np.concatenate([library["port"].features, np.array(
        [[float(x) for x in r[6:]] for r in ext_scan["csv"][1:]], np.float32)], axis=1)
    np.testing.assert_allclose(full, rows, rtol=0, atol=5e-7)
    z = (full - full.mean(0)) / np.maximum(full.std(0), 1e-6)
    _, assign = kmeans(z, k=2, iters=50, device="cpu")
    for c in range(2):
        got = (out / f"radio-{c:02d}.m3u").read_text().splitlines()[1:]
        want = [os.path.abspath(library["files"][i]) for i in np.nonzero(assign.numpy() == c)[0]]
        assert got == want

    (tmp_path / "lib").mkdir()
    names = [str(tmp_path / "lib" / f"s{i:02d}.flac") for i in range(30)]
    for n in names:
        open(n, "wb").close()
    res = _blob_result(names)
    rng = np.random.RandomState(9)
    res.extended = np.concatenate([np.repeat(rng.randn(3, 45) * 5, 10, axis=0)
                                   + 0.1 * rng.randn(30, 45)]).astype(np.float32)
    parts = {}
    for who, main, mod, extra in (("port", cli.main, pipeline, ["--device", "cpu"]),
                                  ("jax", jcli.main, jpipeline, [])):
        d = tmp_path / who
        d.mkdir()
        with mock.patch.object(mod, "analyze_library", return_value=res):
            assert main([*extra, "radio", str(tmp_path / "lib"), "--clusters", "3", "--extended",
                         "--output-dir", str(d)]) == 0
        parts[who] = {frozenset((d / f"radio-{c:02d}.m3u").read_text().splitlines()[1:])
                      for c in range(3)}
    assert parts["port"] == parts["jax"] and all(len(p) == 10 for p in parts["port"])
