"""The port runs where JAX is absent, as on the GPU machines: a fresh
interpreter in which ``jax``, ``ml_dtypes`` and ``bliss_tpu`` cannot be
imported runs ``analyze_pcm`` on the CPU."""

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
