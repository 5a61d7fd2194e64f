"""The port runs where JAX is absent, as on the GPU machines: a fresh
interpreter in which ``jax``, ``ml_dtypes`` and ``bliss_tpu`` cannot be
imported runs ``analyze_pcm`` on the CPU, under the main path's config and
the hybrid config (two kernels, then the NumPy/SciPy host finish), imports
every module of ``bliss_tpu_torch.ablate`` and runs one ablation variant,
runs the prepass sums and the stats kernel's CPU twin, writes two FLAC
files with the port's writer and scans them with the port's
``analyze_library`` on the CPU (the native decoder built at first use), and
streams a song with ``analyze_song_streaming`` (under ``for_gpu()`` and
under ``AnalysisConfig()``, the XLA-path stage), computes the extended
features (``features/extended.py``) batched and streamed, runs the XLA-path
config modes (``features/amplitude.py``, ``features/frequency.py``, the XLA
half of ``features/tempo.py``, ``dsp/framing.py``, ``dsp/iir.lfilter_scan``)
under ``AnalysisConfig()`` and ``for_parity()`` and the three ``Song``
analyzer methods, and runs the similarity (``kmeans``,
``nearest_neighbors_all``) and the port's CLI (``store neighbors`` on a
small store), imports the serving layer (``server``, ``http_gateway``,
``gui``, ``utils.debug``) and answers a status request, and imports the
mesh (``bliss_tpu_torch.parallel``) and analyzes a batch over a 2x2 mesh of
the CPU."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "bliss_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import bliss_tpu_torch
import chip_smoke  # the GPU smoke script imports no JAX either
rng = np.random.RandomState(0)
t = np.arange(30_000)
song = (8000 * np.sin(2 * np.pi * t / 40.0) + 500 * rng.randn(t.size)).astype(np.int16)
out = bliss_tpu_torch.analyze_pcm([song, song[:25_000]], [1, 1], device="cpu")
assert out.shape == (2, 4) and np.isfinite(out).all(), out
hybrid = bliss_tpu_torch.analyze_pcm(
    [song, song[:25_000]], [1, 1], cfg=bliss_tpu_torch.AnalysisConfig.for_gpu_hybrid(),
    device="cpu",
)
assert np.array_equal(hybrid[:, 0], out[:, 0]), (hybrid, out)
assert np.abs(hybrid[:, 1:] - out[:, 1:]).max() <= 1e-3, (hybrid, out)
from bliss_tpu_torch.ablate import breakdown, dma, fused, matred, packread, probe
from bliss_tpu_torch.ablate.__main__ import main as ablate_main
x16 = torch.from_numpy(rng.randint(-3000, 3000, size=(2, 4096)).astype(np.int16))
ab = (torch.full((2,), 1e-3), torch.full((2,), 1e-5))
v = fused.stats_variant(x16, *ab, "full", chunk=2048)
assert v.shape == (2, 2, 8, 8) and torch.isfinite(v).all(), v
assert ablate_main(["--shape", "script"]) == 2  # no GPU here: exits, times nothing
from bliss_tpu_torch.kernels import fused_stats as fs
s1, s2 = fs.prepass_sums(x16, torch.tensor([4096, 1001], dtype=torch.int32))
assert s1.dtype == s2.dtype == torch.int64 and int(s2[1]) > 0, (s1, s2)
twin = fs.stats_lane_steps(x16, *ab, nb_bands=1, band_taps=17, filterbank="firwin")
ref = fs.block_stats_reference(x16, *ab, nb_bands=1, band_taps=17, filterbank="firwin")
assert torch.equal(twin[1], ref[1]) and torch.allclose(twin[2], ref[2], rtol=1e-12, atol=1e-12)
import tempfile
from bliss_tpu_torch.io import decode
from bliss_tpu_torch.io.flac_writer import write_flac
from bliss_tpu_torch.pipeline import analyze_library
with tempfile.TemporaryDirectory() as d:
    files = [f"{d}/a.flac", f"{d}/b.flac"]
    longer = np.tile(song, 2)  # over a second once padded: a finite tempo
    write_flac(files[0], longer.reshape(-1, 2), 22050)
    write_flac(files[1], longer[:50_000].reshape(-1, 2), 22050)
    scan = analyze_library(files, batch_size=2, device="cpu", handle_sigint=False)
    pcm = [decode(f) for f in files]
assert scan.ok.all() and not scan.errors and np.isfinite(scan.features).all(), scan
direct = bliss_tpu_torch.analyze_pcm([p.samples for p in pcm], [p.duration for p in pcm], device="cpu")
assert np.array_equal(scan.features[:, 0], direct[:, 0]), (scan.features, direct)
assert np.abs(scan.features - direct).max() <= 1e-5, (scan.features, direct)
from bliss_tpu_torch.features.streaming import analyze_song_streaming
long_song = np.tile(song, 5)  # 150 000 samples: three rows of 2^16
streamed = analyze_song_streaming(long_song, 3, bliss_tpu_torch.AnalysisConfig.for_gpu(), 1 << 16, device="cpu")
whole = bliss_tpu_torch.analyze_pcm([long_song], [3], device="cpu")[0]
assert streamed[0] == whole[0] and np.abs(streamed - whole).max() <= 1e-3, (streamed, whole)
xla_cfg = bliss_tpu_torch.AnalysisConfig()  # the XLA-path stage streamed, with the float64 finish
xla_streamed = analyze_song_streaming(long_song, 3, xla_cfg, 1 << 16, device="cpu")
xla_whole = bliss_tpu_torch.analyze_pcm(
    [long_song], [3], cfg=bliss_tpu_torch.AnalysisConfig(tempo_finish="device_exact"), device="cpu")[0]
assert xla_streamed[0] == xla_whole[0] and np.abs(xla_streamed - xla_whole).max() <= 1e-3, (xla_streamed, xla_whole)
from bliss_tpu_torch.features import extended
rows = bliss_tpu_torch.analyze_pcm([long_song, song], [3, 1], device="cpu", extended=True)
assert rows.shape == (2, 49) and np.isfinite(rows).all(), rows
assert np.array_equal(rows[:, :4], bliss_tpu_torch.analyze_pcm([long_song, song], [3, 1], device="cpu"))
ext_streamed = analyze_song_streaming(long_song, 3, bliss_tpu_torch.AnalysisConfig.for_gpu(), 1 << 16, extended=True, device="cpu")
assert ext_streamed.shape == (49,) and np.abs(ext_streamed[4:] - rows[0, 4:]).max() <= 1e-2, ext_streamed
assert len(extended.EXTENDED_FEATURE_NAMES) == 45 and extended.mel_filterbank().shape == (257, 40)
from bliss_tpu_torch.dsp.framing import frame_signal
from bliss_tpu_torch.dsp.iir import lfilter_scan
from bliss_tpu_torch.features import amplitude, frequency, tempo
AC = bliss_tpu_torch.AnalysisConfig
xla = {}
for name, cfg in (("default", AC()), ("parity", AC.for_parity()),
                  ("modes", AC(dtype="float64", amplitude_mode="table", spectrum_mode="fft",
                               tempo_energy_mode="parseval_framed", iir_mode="scan"))):
    xla[name] = bliss_tpu_torch.analyze_pcm([long_song, song], [3, 1], cfg=cfg, device="cpu")
    assert xla[name].shape == (2, 4) and np.isfinite(xla[name]).all(), (name, xla[name])
assert np.abs(xla["parity"][:, 1:] - xla["modes"][:, 1:]).max() <= 1e-3, xla
assert frame_signal(torch.zeros(2, 4096), 512, 256).shape == (2, 15, 512)
assert lfilter_scan(np.array([1.0, 0.0]), np.array([1.0, -0.5]), torch.ones(1, 4)).tolist() == [[1.0, 1.5, 1.75, 1.875]]
with tempfile.TemporaryDirectory() as d:
    write_flac(f"{d}/s.flac", long_song.reshape(-1, 2), 22050)
    s = bliss_tpu_torch.Song(device="cpu")
    s.decode(f"{d}/s.flac")
parity = AC.for_parity()
got = [s.amplitude_analysis(parity), s.frequency_analysis(parity), *s.envelope_analysis(parity)]
assert np.isfinite(got).all() and s.force_vector.attack == got[3], got
from bliss_tpu_torch import cli
from bliss_tpu_torch.sim import kmeans, nearest_neighbors_all
from bliss_tpu_torch.store import FeatureStore
lib = np.concatenate([rng.randn(20, 4) + 8, rng.randn(20, 4) - 8]).astype(np.float32)
cents, labels = kmeans(lib, 2, device="cpu")
assert cents.shape == (2, 4) and len(set(labels[:20].tolist())) == 1 == len(set(labels[20:].tolist()))
assert labels[0] != labels[20], labels
dist, idx = nearest_neighbors_all(lib, 3, block=16, device="cpu")
assert idx.shape == (40, 3) and (idx.numpy() != np.arange(40)[:, None]).all(), idx
with tempfile.TemporaryDirectory() as d:
    store = FeatureStore(d)
    for i, v in enumerate(lib[:6]):
        store.put(f"k{i}", v, {"filename": f"song{i}.flac"})
    store.flush()
    import contextlib, io
    with contextlib.redirect_stdout(io.StringIO()) as said:
        assert cli.main(["--device", "cpu", "store", "neighbors", d, "-o", f"{d}/n.csv"]) == 0
    assert said.getvalue().startswith("wrote 6 x top-5 neighbors"), said.getvalue()
    with open(f"{d}/n.csv") as f:
        assert len(f.read().splitlines()) == 7
from bliss_tpu_torch import gui, http_gateway, server
from bliss_tpu_torch.utils import debug
srv = server.AnalysisServer(device="cpu")
st = srv._handle_line(b'{"op": "status"}')
assert st["ok"] and st["backend"] == "cpu" and st["devices"] == 1, st
assert http_gateway.HttpGateway and gui.ScanJob and debug.nan_debugging
from bliss_tpu_torch.features.types import PCMBatch
from bliss_tpu_torch.parallel import analysis_mesh, analyze_sharded, dryrun, init_distributed, pod_mesh
f64 = AC(dtype="float64")
meshed = analyze_sharded(PCMBatch.from_arrays([long_song, song], [3, 1], device="cpu"),
                         analysis_mesh(2, 2, devices=["cpu"] * 4), f64)
flat = bliss_tpu_torch.analyze_pcm([long_song, song], [3, 1], cfg=f64, device="cpu")
assert np.abs(meshed - flat).max() <= 2e-6, (meshed, flat)
assert dryrun.dryrun_multichip and init_distributed and pod_mesh
from bliss_tpu_torch import compat, fuzz
assert compat.library_path and compat.abi_check_path
fuzz.SECONDS = (3, 4)
res = fuzz.run_batched_device_fuzz(1, "device_exact", device="cpu", verbose=False, workers=1)
assert (res["cases"], res["divergent"]) == (1, 0), res
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ml_dtypes", "bliss_tpu") and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", out.tolist())
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout


SITECUSTOMIZE = """
import sys
for name in ("jax", "jaxlib", "ml_dtypes", "bliss_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
open(__file__ + ".ran", "w").close()
"""


def test_the_c_librarys_interpreter_runs_without_jax(tmp_path):
    """``abi_check`` on a caller-filled song with a ``sitecustomize`` on
    ``PYTHONPATH`` that blocks ``jax``, ``ml_dtypes`` and ``bliss_tpu`` in the
    interpreter ``libbliss.so`` embeds: the three sorts come back (an import
    of a blocked module would make them BL_UNEXPECTED)."""
    from bliss_tpu_torch import compat

    exe = compat.abi_check_path()
    (tmp_path / "sitecustomize.py").write_text(SITECUSTOMIZE)
    t = np.arange(88_200)
    (9000 * np.sin(2 * np.pi * t / 45.0)).astype(np.int16).tofile(tmp_path / "song.s16")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLISS_TPU_TORCH_")}
    env.update(PYTHONPATH=str(tmp_path), OMP_NUM_THREADS="1", BLISS_TPU_TORCH_DEVICE="cpu",
               BLISS_TPU_TORCH_COMPAT_MODE="gpu")
    proc = subprocess.run([exe, "--raw", str(tmp_path / "song.s16"), "2"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "sitecustomize.py.ran").exists()
    (sorts,) = compat.abi_check_lines(proc.stdout)["sorts"]
    sorts = sorts[:4]
    assert all(np.isfinite(float(x)) and float(x) != -2.0 for x in sorts), (sorts, proc.stderr)
    assert "Error" not in proc.stderr, proc.stderr
