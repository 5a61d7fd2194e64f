"""The port runs where JAX is absent, as on the GPU machines: a fresh
interpreter in which ``jax``, ``ml_dtypes`` and ``bliss_tpu`` cannot be
imported runs ``analyze_pcm`` on the CPU, under the main path's config and
the hybrid config (two kernels, then the NumPy/SciPy host finish), imports
every module of ``bliss_tpu_torch.ablate`` and runs one ablation variant,
and runs the prepass sums and the stats kernel's CPU twin."""

import os
import subprocess
import sys

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
