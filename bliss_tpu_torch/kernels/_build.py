"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for sm_90a into
``build/bliss_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout,
and is loaded with ``ctypes``. The hash covers every file under ``csrc/``
and the compiler flags, so an edited source rebuilds. Nothing is built when
a module is imported, and a missing ``nvcc`` or a failed build raises.

``fused_all_library`` binds the entry points of ``csrc/fused_all.cu``,
which the wrappers of K1, K2 and K3 share, and ``launch`` calls one of them
on the tensor's current stream and raises if the launch failed.
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

import torch

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


_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of csrc/fused_all.cu's entry points (see its extern "C" block)
_STATS = [_VP, _I, _I, _VP, _VP, _VP, _VP, _I, _F, _VP, _VP, _I, _I, _VP, _VP, _VP]
_POWER = [_VP, _I, _I, _VP, _VP, _VP, _VP, _I]
_SIGNATURES = {
    "bliss_fused_stats": _STATS + [_VP],
    "bliss_stft_power": _POWER + [_VP],
    "bliss_fused_all": _STATS + [_VP, _VP, _VP, _I, _VP],
    "bliss_power_tile": [],
}
_bound: ctypes.CDLL | None = None


def fused_all_library() -> ctypes.CDLL:
    """``csrc/fused_all.cu``'s library with every entry point's argument
    and return types declared."""
    global _bound
    if _bound is None:
        lib = load("fused_all")
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.bliss_cuda_error_string.argtypes = [_I]
        lib.bliss_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def launch(fn: str, device, *args) -> None:
    """Calls entry point ``fn`` with ``args`` and the current stream of
    CUDA ``device`` as its last argument; raises RuntimeError with CUDA's
    message if the launch was refused."""
    lib = fused_all_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.bliss_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")
