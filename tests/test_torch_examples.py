"""The examples over the port (``bliss_tpu_torch/examples/``), each run with
``--device cpu`` on a 3-song library written by ``tools.gen_library``:
``song_api_demo`` and ``distance_demo`` print the rows ``analyze_pcm`` gives
the decoded songs; ``library_scan`` and ``make_playlist`` write the CSV and
the m3u that the port's CLI writes for the same files; ``scan_interactive``
scans into a store and resumes from it; ``analyze_gui`` re-exports the GUI
and opens it on its device. Without ``--device cpu`` each stops with
``resolve_device``'s error."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bliss_tpu_torch import api, cli, gui
from bliss_tpu_torch.examples import (
    analyze_gui,
    distance_demo,
    library_scan,
    make_playlist,
    scan_interactive,
    song_api_demo,
)
from bliss_tpu_torch.io import decode
from bliss_tpu_torch.store import FeatureStore
from bliss_tpu_torch.tools.gen_library import make_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [song_api_demo, distance_demo, library_scan, make_playlist, scan_interactive,
            analyze_gui]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """Three generated songs of 2 s, their decoded rows through
    ``analyze_pcm`` and the port's CLI's scan CSV of them."""
    root = tmp_path_factory.mktemp("examples")
    files = make_library(str(root / "lib"), 3, 2, 11)
    pcm = [decode(f) for f in files]
    rows = api.analyze_pcm([p.samples for p in pcm], [p.duration for p in pcm], device="cpu")
    out = root / "cli.csv"
    assert cli.main(["--device", "cpu", "scan", str(root / "lib"), "-o", str(out),
                     "--store", str(root / "cli-store")]) == 0
    with open(out, newline="") as f:
        scan_rows = list(csv.reader(f, delimiter=";"))
    return {"root": root, "lib": str(root / "lib"), "files": files, "rows": rows,
            "scan": scan_rows}


def _value(line: str) -> str:
    return line.split(":", 1)[1].strip()


def test_song_api_demo(library, capsys):
    assert song_api_demo.main(["--device", "cpu", library["files"][0]]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "title", "artist", "duration", "force", "vector", "class", "amplitude", "frequency",
        "tempo/atk"]
    row = library["rows"][0]
    vector = eval(_value(lines[4]))  # the ForceVector's dict
    np.testing.assert_array_equal([vector[k] for k in ("tempo", "amplitude", "frequency", "attack")],
                                  row)
    assert _value(lines[2]) == "2 s"
    t, a, f, k = row.astype(np.float64)
    assert float(_value(lines[3])) == pytest.approx(max(t, 0) + a + f + max(k, 0), abs=1e-5)
    assert float(_value(lines[6])) == pytest.approx(a, abs=5e-4)
    assert float(_value(lines[7])) == pytest.approx(f, abs=5e-4)
    assert eval(_value(lines[8]))[0] == pytest.approx(t, abs=1e-6)


def test_distance_demo(library, capsys):
    f0, f1 = library["files"][:2]
    assert distance_demo.main(["--device", "cpu", f0, f1]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "force vectors:" and lines[1].split()[0] == f0 and lines[2].split()[0] == f1
    r0, r1 = library["rows"][:2].astype(np.float64)
    assert float(_value(lines[3])) == pytest.approx(np.linalg.norm(r0 - r1), abs=1e-5)
    cos = r0 @ r1 / (np.linalg.norm(r0) * np.linalg.norm(r1))
    assert float(_value(lines[4])) == pytest.approx(cos, abs=1e-6)


def test_library_scan_writes_the_clis_rows(library, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert library_scan.main(["--device", "cpu", library["lib"], "out.csv"]) == 0
    with open("out.csv", newline="") as f:
        assert list(csv.reader(f, delimiter=";")) == library["scan"]
    assert len(FeatureStore(".bliss-store")) == 3


def test_make_playlist_writes_the_clis_order(library, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seed = library["files"][1]
    assert make_playlist.main(["--device", "cpu", seed, library["lib"], "ex.m3u"]) == 0
    assert cli.main(["--device", "cpu", "playlist", seed, library["lib"], "-o", "cli.m3u"]) == 0
    with open("ex.m3u") as a, open("cli.m3u") as b:
        got = a.read().splitlines()
        assert got == b.read().splitlines()
    assert got[0] == "#EXTM3U" and got[1] == os.path.abspath(seed) and len(got) == 4


def test_scan_interactive_scans_and_resumes(library, tmp_path, capsys):
    store = str(tmp_path / "store")
    for run in range(2):  # the second run takes every row from the store
        assert scan_interactive.main(["--device", "cpu", library["lib"], store]) == 0
        captured = capsys.readouterr()
        assert captured.out.strip() == "done: 3/3 songs analyzed (0 failed)"
        bar = "100.0%  analyzed batch of 3" in captured.err and "(q to cancel)" in captured.err
        assert bar == (run == 0), captured.err
    assert len(FeatureStore(store)) == 3


def test_analyze_gui_opens_the_gui_on_its_device(monkeypatch):
    assert (analyze_gui.ScanJob, analyze_gui.CSV_DIALECT, analyze_gui.build_app,
            analyze_gui.discover_audio_files, analyze_gui.gui_main) == (
        gui.ScanJob, gui.CSV_DIALECT, gui.build_app, gui.discover_audio_files, gui.main)
    seen = []
    monkeypatch.setattr(analyze_gui, "gui_main", lambda device: seen.append(device) or 0)
    assert analyze_gui.main(["--device", "cpu"]) == 0
    assert seen == [torch.device("cpu")]


def test_analyze_gui_without_a_display_says_so(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert analyze_gui.main(["--device", "cpu"]) == 1
    assert "Cannot open a display" in capsys.readouterr().err


def test_the_gui_examples_scanjob_writes_the_scans_rows(library, tmp_path):
    out = str(tmp_path / "gui.csv")
    job = analyze_gui.ScanJob(library["lib"], out, device="cpu")
    assert job.run() == 3
    with open(out, newline="") as f:
        rows = list(csv.reader(f, **analyze_gui.CSV_DIALECT))
    # (filename, album, attack, tempo, amplitude, frequency), the reference's order
    assert [r[0] for r in rows] == library["files"]
    got = np.array([[float(r[i]) for i in (3, 4, 5, 2)] for r in rows], np.float32)
    np.testing.assert_allclose(got, library["rows"], rtol=0, atol=1e-5)


ARGS = {
    song_api_demo: ["a.flac"], distance_demo: ["a.flac", "b.flac"], library_scan: ["lib"],
    make_playlist: ["a.flac", "lib"], scan_interactive: ["lib"], analyze_gui: [],
}


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_each_example_needs_a_gpu_unless_asked_for_the_cpu(example, monkeypatch):
    monkeypatch.delenv("BLISS_TPU_TORCH_DEVICE", raising=False)
    with pytest.raises(SystemExit, match="no CUDA device for device='cuda'"):
        example.main(ARGS[example])


def test_an_example_runs_as_a_module(library, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("BLISS_TPU_TORCH_DEVICE", None)
    f0, f1 = library["files"][:2]
    run = [sys.executable, "-m", "bliss_tpu_torch.examples.distance_demo"]
    ok = subprocess.run(run + ["--device", "cpu", f0, f1], cwd=tmp_path, env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0 and ok.stdout.startswith("force vectors:"), ok.stderr[-2000:]
    bad = subprocess.run(run + [f0, f1], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode == 1 and "distance_demo: no CUDA device" in bad.stderr, bad.stderr[-2000:]
    assert not bad.stdout
