"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for sm_90a into
``build/bliss_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout,
and is loaded with ``ctypes``. The hash covers every file under ``csrc/``
and the compiler flags, so an edited source rebuilds. Nothing is built when
a module is imported, and a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bliss_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent compiling, compiler's stderr: ptxas register and
# spill report); absent when the library was already on disk
BUILD_INFO: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda): the "
        "CUDA kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it first
    if the current sources have not been built yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = BUILD_DIR / f"lib{name}-{_digest()}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            BUILD_INFO[name] = (time.perf_counter() - t0, proc.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
