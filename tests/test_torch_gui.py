"""Headless tests of the port's GUI scanner (``bliss_tpu_torch/gui.py``) on
the CPU: each case of ``tests/test_gui.py`` on a library of FLAC files
written with the port's writer (the reference fixtures are not needed),
the CSV dialect held to ``bliss_tpu``'s, and the device a scan runs on."""

import csv
import os

import numpy as np
import pytest
import torch

from conftest import synth_pcm

from bliss_tpu_torch import gui as analyze_gui
from bliss_tpu_torch.io.flac_writer import write_flac

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    d = tmp_path_factory.mktemp("guilib")
    for i, name in enumerate(("song.flac", "song_s32.flac")):
        pcm = synth_pcm(np.random.RandomState(40 + i), 60_000 + 8_000 * i)
        write_flac(str(d / name), pcm.reshape(-1, 2), 22050,
                   tags={"TITLE": name, "ALBUM": "Renaissance"})
    (d / "notes.txt").write_text("not audio")
    sub = d / "sub"
    sub.mkdir()
    write_flac(str(sub / "deep.flac"),
               synth_pcm(np.random.RandomState(42), 50_000).reshape(-1, 2), 22050)
    return d


def test_csv_dialect_is_bliss_tpus():
    from bliss_tpu import gui as jgui

    assert analyze_gui.CSV_DIALECT == jgui.CSV_DIALECT


def test_discover_filters_and_recursion(library):
    flat = analyze_gui.discover_audio_files(str(library))
    assert [os.path.basename(f) for f in flat] == ["song.flac", "song_s32.flac"]
    deep = analyze_gui.discover_audio_files(str(library), recursive=True)
    assert any(f.endswith("deep.flac") for f in deep) and len(deep) == 3
    assert not any(f.endswith("notes.txt") for f in deep)
    assert analyze_gui.discover_audio_files(str(library / "missing")) == []


def test_scanjob_headless_end_to_end(library, tmp_path):
    out = tmp_path / "out.csv"
    progress, done = [], []
    job = analyze_gui.ScanJob(
        str(library),
        str(out),
        device="cpu",
        on_progress=lambda d, t, m: progress.append((d, t)),
        on_done=lambda rows, cancelled: done.append((rows, cancelled)),
    )
    rows = job.run()  # synchronously, on this thread
    assert rows == 2 and done == [(2, False)]
    assert progress and progress[-1][0] == progress[-1][1] == 2

    with open(out, newline="") as fh:
        data = list(csv.reader(fh, **analyze_gui.CSV_DIALECT))
    assert len(data) == 2
    # the reference's exact column order: filename, album, attack, tempo,
    # amplitude, frequency (analyze_gui.py:48) — cross-check each row
    # against the Song API on the same file
    from bliss_tpu_torch import api

    for row in data:
        fname, album, attack, tempo, amplitude, frequency = row
        assert album == "Renaissance"
        with api.Song(fname, device="cpu") as song:
            fv = song["force_vector"]
            assert float(attack) == pytest.approx(fv["attack"], abs=1e-5)
            assert float(tempo) == pytest.approx(fv["tempo"], abs=1e-5)
            assert float(amplitude) == pytest.approx(fv["amplitude"], abs=1e-5)
            assert float(frequency) == pytest.approx(fv["frequency"], abs=1e-5)
    assert data[0][0].endswith("song.flac")


def test_scanjob_cancel_drains_to_partial_csv(library, tmp_path):
    out = tmp_path / "out.csv"
    done = []
    job = analyze_gui.ScanJob(
        str(library), str(out), device="cpu", on_done=lambda r, c: done.append((r, c))
    )
    job.cancel()  # cancelled before it starts: drains to an empty scan
    job.run()
    assert done == [(0, True)]
    with open(out, newline="") as fh:
        assert list(csv.reader(fh, **analyze_gui.CSV_DIALECT)) == []


def test_scanjob_empty_dir_reports_error(tmp_path):
    errs = []
    job = analyze_gui.ScanJob(
        str(tmp_path), str(tmp_path / "o.csv"), device="cpu", on_error=errs.append
    )
    assert job.run() == 0
    assert errs == ["Please enter a valid directory containing audio files"]
    assert not (tmp_path / "o.csv").exists()


def test_scanjob_threaded_start_join(library, tmp_path):
    out = tmp_path / "out.csv"
    done = []
    job = analyze_gui.ScanJob(
        str(library), str(out), device="cpu", on_done=lambda r, c: done.append((r, c))
    )
    job.start()
    job.join(timeout=300)
    assert not job.running and done == [(2, False)]


def test_scanjob_without_a_gpu_reports_and_runs_nothing(library, tmp_path, monkeypatch):
    """The default device is the GPU: without one the scan reports
    resolve_device's error instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    errs = []
    job = analyze_gui.ScanJob(str(library), str(tmp_path / "o.csv"), on_error=errs.append)
    assert job.run() == 0
    assert len(errs) == 1 and errs[0].startswith("scan failed: no CUDA device")
    assert not (tmp_path / "o.csv").exists()


def test_cli_gui_opens_the_window_on_its_device(monkeypatch, capsys):
    """``gui`` hands ``--device`` to the window; with no display ``main``
    points at the terminal scanner and exits 1."""
    from bliss_tpu_torch import cli

    seen = []
    monkeypatch.setattr(analyze_gui, "main", lambda device: seen.append(device) or 0)
    assert cli.main(["--device", "cpu", "gui"]) == 0
    assert seen == [torch.device("cpu")]
    monkeypatch.undo()

    def no_display(device):
        raise RuntimeError("no $DISPLAY")

    monkeypatch.setattr(analyze_gui, "build_app", no_display)
    assert analyze_gui.main("cpu") == 1
    err = capsys.readouterr().err
    assert "Cannot open a display (no $DISPLAY)" in err and "bliss-tpu-torch scan" in err
