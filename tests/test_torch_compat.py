"""The port's C compatibility library (``bliss_tpu_torch/compat/``) on the
CPU: ``abi_check.c``, a C consumer of all fifteen functions of ``bliss.h``,
linked against the port's ``libbliss.so`` and run with
``BLISS_TPU_TORCH_DEVICE=cpu`` on FLAC files written by the port's writer
and on caller-filled raw songs, against ``bliss_tpu`` on the same PCM:
``parity`` within 1e-5 of ``for_parity()``, ``gpu`` (the kernels' plain
versions here) within 5e-4 of ``for_tpu()``, beats identical in both;
``bl_mean``, ``bl_variance`` and ``bl_rectangular_filter`` bit for bit
against ``tests/oracle.py``; four threads at once equal to one; a missing
file; the header's declarations; where the library is built and when it is
built anew; and, with the default device and no GPU, no result at all."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from conftest import synth_pcm
from oracle import c_trunc_div, rectangular_filter_oracle
from bliss_tpu.config import AnalysisConfig as JConfig
from bliss_tpu.features import PCMBatch as JBatch
from bliss_tpu.features import amplitude_scores, envelope_scores, frequency_scores
from bliss_tpu.api import analyze_features
from bliss_tpu.io import decode as jdecode

from bliss_tpu_torch import compat
from bliss_tpu_torch.io.flac_writer import write_flac

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 176_400  # 4 s of 22050 Hz stereo
DUR = 4
BL_UNEXPECTED = -2


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """Two FLAC files, two raw songs (the first file's PCM and a quieter
    one), a missing file and the filter's inputs."""
    d = tmp_path_factory.mktemp("torch_compat")
    pcm = [synth_pcm(np.random.RandomState(70 + i), N, amp=amp)
           for i, amp in enumerate((12000, 3000, 7000))]
    files = [str(d / f"song{i}.flac") for i in range(2)]
    for f, p in zip(files, pcm):
        write_flac(f, p.reshape(-1, 2), 22050, tags={"ARTIST": "synth", "TITLE": os.path.basename(f)})
    raws = [str(d / "song0.s16"), str(d / "song2.s16")]
    pcm[0].tofile(raws[0])
    pcm[2].tofile(raws[1])
    rng = np.random.RandomState(5)
    # multiples of 1/8: every partial sum is exact, so the C running sum and
    # the oracle's convolution agree bit for bit, whatever their order
    rect_in, rect_out0 = rng.randint(-8000, 8000, size=(2, 333)) / 8.0
    rect_in.tofile(d / "in.f64")
    rect_out0.tofile(d / "out0.f64")
    return {"dir": d, "pcm": pcm, "files": files, "raws": raws,
            "raw_pcm": [pcm[0], pcm[2]], "missing": str(d / "missing.flac"),
            "rect": (rect_in, rect_out0)}


@pytest.fixture(scope="module")
def abi_check():
    return compat.abi_check_path()


def _run(exe, args, mode, device="cpu", timeout=300, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLISS_TPU_TORCH_")}
    env.update(OMP_NUM_THREADS="1", BLISS_TPU_TORCH_COMPAT_MODE=mode, **extra)
    if device is not None:
        env["BLISS_TPU_TORCH_DEVICE"] = device
    return subprocess.run([exe, *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def _args(songs, threads=0):
    args = []
    for r in songs["raws"]:
        args += ["--raw", r, str(DUR)]
    d = songs["dir"]
    args += ["--bad", songs["missing"], "--rect", str(d / "in.f64"), str(d / "out0.f64"),
             "19", str(d / "rect.f64")]
    if threads:
        args += ["--threads", str(threads), "--rounds", "2"]
    return args + songs["files"]


@pytest.fixture(scope="module")
def runs(songs, abi_check):
    out = {}
    for mode in ("parity", "gpu"):
        proc = _run(abi_check, _args(songs), mode)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[mode] = proc
    return out


@pytest.fixture(scope="module")
def jax_rows(songs):
    """bliss_tpu on the same PCM: analyze_features of the files (as
    bliss_tpu decodes them: the writer fills the last FLAC block) and the
    three scores of the raw songs, under for_parity() and for_tpu()."""
    decoded = [jdecode(f) for f in songs["files"]]
    out = {"decoded": decoded}
    for mode, cfg in (("parity", JConfig.for_parity()), ("gpu", JConfig.for_tpu())):
        files = JBatch.from_arrays([d.samples for d in decoded], [d.duration for d in decoded])
        raws = JBatch.from_arrays(songs["raw_pcm"], [DUR, DUR])
        t, a = envelope_scores(raws, cfg)
        out[mode] = {
            "analyze": np.asarray(analyze_features(files, cfg), np.float32),
            "sorts": np.stack([np.asarray(x, np.float32) for x in (
                amplitude_scores(raws, cfg), frequency_scores(raws, cfg), t, a)], axis=1),
        }
    return out


TOL = {"parity": 1e-5, "gpu": 5e-4}


@pytest.mark.parametrize("mode", ["parity", "gpu"])
def test_bl_analyze_matches_bliss_tpu(runs, jax_rows, mode):
    rows = compat.abi_check_lines(runs[mode].stdout)["analyze"]
    assert [r[0] for r in rows] == ["0", "0"]  # BL_LOUD
    got = np.array([[float(x) for x in r[2:6]] for r in rows], np.float32)
    ref = jax_rows[mode]["analyze"]
    assert np.array_equal(got[:, 0], ref[:, 0])  # beats identical
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=TOL[mode])
    # the force is the reference's rating of the vector (analyze.c:67-80)
    force = np.array([float(r[1]) for r in rows], np.float32)
    rating = (np.maximum(got[:, 0], 0) + got[:, 1] + got[:, 2] + np.maximum(got[:, 3], 0))
    np.testing.assert_allclose(force, rating, rtol=1e-6)


@pytest.mark.parametrize("mode", ["parity", "gpu"])
def test_sorts_of_caller_filled_songs_match_bliss_tpu(runs, jax_rows, mode):
    rows = compat.abi_check_lines(runs[mode].stdout)["sorts"]
    got = np.array([[float(x) for x in r[:4]] for r in rows], np.float32)
    ref = jax_rows[mode]["sorts"]  # amplitude, frequency, tempo, attack
    assert np.array_equal(got[:, 2], ref[:, 2])  # beats identical
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[mode])


def test_decode_tags_and_distances(runs, songs, jax_rows):
    lines = compat.abi_check_lines(runs["parity"].stdout)
    for (rc, n, ch, sr, br, nb, resampled, dur, path), d in zip(lines["decode"], jax_rows["decoded"]):
        assert (rc, n, ch, sr, br, nb, resampled, dur, path) == (
            "0", str(d.n_samples), "2", "22050", str(d.bitrate), "2", "0", str(d.duration), d.filename)
    assert [t[0].split("|")[:2] for t in lines["tags"]] == [
        ["synth", os.path.basename(f)] for f in songs["files"]]
    vecs = [np.array([float(x) for x in r[2:6]]) for r in lines["analyze"]]
    vecs += [np.array([float(r[2]), float(r[0]), float(r[1]), float(r[3])]) for r in lines["sorts"]]
    for i, j, d, c in lines["distance"]:
        a, b = vecs[int(i)], vecs[int(j)]
        assert float(d) == pytest.approx(np.linalg.norm(a - b), rel=1e-6)
        assert float(c) == pytest.approx(a @ b / np.linalg.norm(a) / np.linalg.norm(b), rel=1e-6)
    (d, c), = lines["distance_file"]
    assert (d, c) == tuple(lines["distance"][0][2:])  # the two files' pair


def test_mean_variance_and_filter_bit_for_bit(runs, songs):
    lines = compat.abi_check_lines(runs["parity"].stdout)
    for (mean, var, path), pcm in zip(lines["stats"], songs["raw_pcm"]):
        s = pcm.astype(np.int64)
        m = c_trunc_div(int(s.sum()), s.size)
        assert int(mean) == m, path
        assert int(var) == c_trunc_div(int(((s - m) ** 2).sum()), s.size), path
    assert lines["rect"] == [["333", "19"]]
    rect_in, rect_out0 = songs["rect"]
    got = np.fromfile(songs["dir"] / "rect.f64")
    ref = rectangular_filter_oracle(rect_out0.copy(), rect_in, rect_in.size, 19)
    assert np.array_equal(got, ref)


def test_a_missing_file_is_unexpected(runs, songs):
    for mode in ("parity", "gpu"):
        (bad,) = compat.abi_check_lines(runs[mode].stdout)["bad"]
        assert bad == [str(BL_UNEXPECTED)] * 2 + ["-2", "-2", songs["missing"]]
        assert "missing.flac" in runs[mode].stderr and "Couldn't decode song" in runs[mode].stderr


def test_four_threads_equal_one(songs, abi_check, runs):
    """4 pthreads x 2 rounds of bl_analyze and the sorts at once, each
    result bit for bit the single-thread one (abi_check compares), and the
    single-thread lines those of the run without threads."""
    proc = _run(abi_check, _args(songs, threads=4), "parity", timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = compat.abi_check_lines(proc.stdout)
    assert lines["threads"] == [["4", "2", "4", "0"]]
    base = compat.abi_check_lines(runs["parity"].stdout)
    for kind in ("analyze", "sorts", "distance", "stats"):
        assert lines[kind] == base[kind], kind


def test_no_gpu_and_the_default_device_give_no_result(songs, abi_check):
    """BLISS_TPU_TORCH_DEVICE unset: cuda, which is absent here. Every
    analysis call is BL_UNEXPECTED, stderr names the missing GPU, and
    nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = _run(abi_check, ["--raw", songs["raws"][0], str(DUR), songs["files"][0]], "gpu",
                device=None)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = compat.abi_check_lines(proc.stdout)
    assert lines["sorts"][0][:4] == ["-2"] * 4
    assert lines["analyze"][0][0] == str(BL_UNEXPECTED)
    assert "no CUDA device" in proc.stderr


def _strip(header: str) -> str:
    header = re.sub(r"/\*.*?\*/", " ", header, flags=re.S)
    header = re.sub(r"//[^\n]*", " ", header)
    return " ".join(header.split())


def test_header_declares_what_bliss_tpus_does():
    with open(os.path.join(REPO, "bliss_tpu", "compat", "include", "bliss.h")) as f:
        ref = _strip(f.read())
    with open(os.path.join(REPO, "bliss_tpu_torch", "compat", "include", "bliss.h")) as f:
        got = _strip(f.read())
    assert got == ref
    assert len(re.findall(r"\bbl_\w+\s*\(", got)) == 15


def test_built_under_build_and_rebuilt_when_a_source_changes(tmp_path, monkeypatch):
    lib = compat.library_path()
    assert os.path.dirname(os.path.dirname(lib)) == os.path.join(REPO, "build", "bliss_tpu_torch")
    assert os.path.basename(os.path.dirname(lib)).startswith("compat-")
    assert compat.library_path() == lib  # built once
    src = tmp_path / "src"
    shutil.copytree(compat.COMPAT_DIR, src, ignore=shutil.ignore_patterns("__pycache__"))
    with open(src / "compat_shim.cc", "a") as f:
        f.write("// edited\n")
    monkeypatch.setattr(compat, "COMPAT_DIR", src)
    monkeypatch.setattr(compat, "_BUILD_ROOT", tmp_path / "build")
    rebuilt = compat.library_path()
    assert os.path.exists(rebuilt) and os.path.dirname(rebuilt) != os.path.dirname(lib)
    assert os.path.basename(os.path.dirname(rebuilt)).startswith("compat-")


def test_a_missing_header_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(compat.sysconfig, "get_path", lambda name: str(tmp_path))
    with pytest.raises(compat.MissingBuildTool, match="Python.h"):
        compat.library_path()


def test_loaded_into_python_it_runs_in_the_callers_interpreter(runs, songs, monkeypatch):
    """ctypes.CDLL of the library in this process: the calls run in this
    interpreter, and read the mode at each call."""
    lib = compat.load()
    monkeypatch.setenv("BLISS_TPU_TORCH_DEVICE", "cpu")
    for mode in ("parity", "gpu"):
        monkeypatch.setenv("BLISS_TPU_TORCH_COMPAT_MODE", mode)
        song = compat.BlSong()
        assert lib.bl_analyze(songs["files"][0].encode(), ctypes.byref(song)) == 0
        v = song.force_vector
        want = np.float32(compat.abi_check_lines(runs[mode].stdout)["analyze"][0][2:6])
        assert np.array_equal(np.float32([v.tempo, v.amplitude, v.frequency, v.attack]), want)
        lib.bl_free_song(ctypes.byref(song))
