"""Builds the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for sm_90a into
``build/bliss_tpu_torch/lib<name>-<hash>.so`` at the root of the checkout,
and is loaded with ``ctypes``. The hash covers every file under ``csrc/``
and the compiler flags, so an edited source rebuilds. Nothing is built when
a module is imported, and a missing ``nvcc`` or a failed build raises.

``library(name)`` binds the entry points of ``csrc/<name>.cu``:
``fused_all`` (K1, K2, K3 and the prepass) and ``ablate`` (the measurement
kernels A1, A2 and A3 of ``bliss_tpu_torch.ablate``). ``launch`` calls one entry point
on the tensor's current stream and raises if the launch failed;
``count_launch`` counts a wrapper's launches.
``build(names)`` compiles several sources at once, one ``nvcc`` each.
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


def _path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names) -> None:
    """Compiles each of ``csrc/<name>.cu`` for ``names`` whose current
    sources have not been built yet, all ``nvcc`` processes started
    together; raises if any fails."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if not _path(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, t0, procs = nvcc_path(), time.perf_counter(), {}
        for name in todo:
            tmp = _path(name).with_name(f"{_path(name).name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) for {name}.cu:\n{out}\n{err}")
                continue
            BUILD_INFO[name] = (time.perf_counter() - t0, err)
            os.replace(tmp, _path(name))
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it first
    if the current sources have not been built yet."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(_path(name))))
    return lib


_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STATS = [_VP, _I, _I, _VP, _VP, _VP, _VP, _I, _F, _VP, _VP, _I, _I, _VP, _VP, _VP]
_POWER = [_VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _I]
# argtypes of each library's entry points (see the extern "C" block of
# csrc/<name>.cu); each also takes the stream last and returns a cudaError_t
_SIGNATURES = {
    "fused_all": {
        "bliss_fused_stats": _STATS + [_VP],
        "bliss_stft_power": _POWER + [_VP],
        "bliss_fused_all": _STATS + [_VP, _VP, _VP, _VP, _I, _VP],
        "bliss_power_tile": [],
        "bliss_prepass": [_VP, _I, _I, _VP, _VP, _I, _VP],
    },
    "ablate": {
        "bliss_stats_ablate": [_I] + _STATS + [_VP],
        "bliss_probe": [_I, _I, _VP, _I, _I, _I, _VP, _VP],
        "bliss_matred_stats": [_VP, _I, _I, _VP, _VP, _VP, _I, _F, _VP, _VP, _I, _VP, _VP],
    },
}
_bound: dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library, built at first use, with every entry
    point's argument and return types declared."""
    lib = _bound.get(name)
    if lib is None:
        lib = load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.bliss_cuda_error_string.argtypes = [_I]
        lib.bliss_cuda_error_string.restype = ctypes.c_char_p
        _bound[name] = lib
    return lib


_count_lock = threading.Lock()


def count_launch(counters: dict, name: str) -> None:
    """Adds one to the launch counter ``name`` of ``counters`` (a wrapper
    module's ``globals()``) under a lock: kernels launch from more than one
    thread (the pipeline streams a long song on its pool thread while the
    main thread launches batches), and a bare ``+=`` can lose a count."""
    with _count_lock:
        counters[name] += 1


def launch(name: str, fn: str, device, *args) -> None:
    """Calls entry point ``fn`` of library ``name`` with ``args`` and the
    current stream of CUDA ``device`` as its last argument; raises
    RuntimeError with CUDA's message if the launch was refused."""
    lib = library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.bliss_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")
