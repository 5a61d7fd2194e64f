"""The C compatibility library of the port: ``libbliss.so``, the fifteen
functions of the reference's ``bliss.h`` (``include/bliss.h``) over
``bliss_tpu_torch`` (the counterpart of ``bliss_tpu/compat/``).

``library_path()`` builds the library at first use, never at import, with
``make`` and ``g++`` against the running interpreter's headers and
``libpython`` (what ``python3-config --includes`` and ``--ldflags --embed``
print for it), into ``build/bliss_tpu_torch/compat-<hash>/`` at the root of
the checkout, beside the port's other native libraries. The hash covers the
sources and what the build bakes in: the checkout's root, the interpreter's
``sys.path`` and its torch package, so that a program embedding the library
imports the same ``torch`` as the interpreter that built it, and an edited
source builds anew. ``abi_check_path()`` compiles ``abi_check.c``, a C
consumer of every function, beside it.

At run time (``compat_shim.cc``): ``BLISS_TPU_TORCH_COMPAT_MODE`` is
``parity`` (``AnalysisConfig.for_parity()``, the default) or ``gpu``
(``AnalysisConfig.for_gpu()``: the prepass, then K1); ``BLISS_TPU_TORCH_DEVICE``
is the device (``cuda`` unless set: without a GPU the analysis calls return
``BL_UNEXPECTED``).
Decode goes through ``bliss_tpu_torch.io.decoder.decode``; where that
decoder cannot be built (no libav), ``bl_audio_decode`` returns
``BL_UNEXPECTED`` with its message, and a caller that fills
``sample_array`` itself still gets every analysis call.

``load()`` loads the library into this process with ``ctypes``: its calls
then run in this interpreter (``BlSong`` mirrors ``struct bl_song``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import site
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

COMPAT_DIR = Path(__file__).resolve().parent
ROOT = COMPAT_DIR.parents[1]
_BUILD_ROOT = ROOT / "build" / "bliss_tpu_torch"
_SOURCES = ("compat_shim.cc", "Makefile", "include/bliss.h", "abi_check.c")
LIB_NAME = "libbliss.so"
ABI_CHECK = "abi_check"
_build_lock = threading.Lock()


class MissingBuildTool(RuntimeError):
    """A tool or header the build needs is missing on this machine (the
    message names it); any other build failure raises RuntimeError."""


def _require(tool: str) -> str:
    path = shutil.which(tool)
    if path is None:
        raise MissingBuildTool(f"libbliss.so needs {tool}, which is not on PATH")
    return path


def _make_vars() -> dict[str, str]:
    """The Makefile's variables for this interpreter; raises
    MissingBuildTool when ``Python.h``, ``g++`` or ``make`` is missing."""
    include = sysconfig.get_path("include")
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise MissingBuildTool(
            f"libbliss.so needs Python.h, which is not in {include} (the "
            "interpreter's development headers are not installed)")
    cxx = _require("g++")
    _require("make")
    _require("gcc")  # abi_check.c
    import torch

    var = sysconfig.get_config_var
    libdir = var("LIBDIR")
    ldflags = [f"-L{libdir}", f"-L{var('LIBPL')}",
               f"-lpython{var('VERSION')}{getattr(sys, 'abiflags', '')}",
               *(var("LIBS") or "").split(), *(var("SYSLIBS") or "").split(),
               f"-Wl,-rpath,{libdir}"]
    torch_dir = os.path.dirname(os.path.realpath(torch.__file__))
    # the site directories (a venv's) and the one torch comes from: a program
    # that embeds the interpreter finds its standard library by itself
    pypath = dict.fromkeys([*site.getsitepackages(), os.path.dirname(torch_dir)])
    out = {
        "CXX": cxx,
        "PY_CFLAGS": f"-I{include} -I{sysconfig.get_path('platinclude')}",
        "PY_LDFLAGS": " ".join(ldflags),
        "ROOT": str(ROOT),
        "PYPATH": os.pathsep.join(pypath),
        "TORCH": torch_dir,
    }
    baked = out["ROOT"] + out["PYPATH"] + out["TORCH"]
    if any(c in baked for c in "'\"\\"):
        raise RuntimeError(
            "libbliss.so bakes the checkout's root, sys.path and the torch "
            f"directory into C strings; none may hold a quote or a backslash: {baked!r}")
    return out


def _build_dir(make_vars: dict[str, str]) -> Path:
    """``build/bliss_tpu_torch/compat-<hash of the sources and the baked
    values>``."""
    h = hashlib.sha1()
    for name in _SOURCES:
        h.update((COMPAT_DIR / name).read_bytes())
    h.update(json.dumps(make_vars, sort_keys=True).encode())
    return _BUILD_ROOT / f"compat-{h.hexdigest()[:12]}"


def _run(cmd, what: str, directory: Path) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed in {directory}:\n{proc.stdout}\n{proc.stderr}")


def _build(directory: Path, make_vars: dict[str, str]) -> None:
    """Copy the sources into ``directory``, then make the library and
    compile ``abi_check.c`` against it there (each to a temp name, then a
    rename)."""
    (directory / "include").mkdir(parents=True, exist_ok=True)
    for name in _SOURCES:
        target = directory / name
        if not target.exists():
            # a pid-unique temp + atomic rename: a concurrent process sees
            # the complete file or none
            tmp = directory / f"{name}.tmp.{os.getpid()}"
            shutil.copy(COMPAT_DIR / name, tmp)
            os.replace(tmp, target)
    _run(["make", "-C", str(directory), *(f"{k}={v}" for k, v in make_vars.items())],
         "libbliss.so's build", directory)
    tmp = directory / f"{ABI_CHECK}.tmp.{os.getpid()}"
    _run([_require("gcc"), "-O2", "-pthread", "-DBLISS_COMPAT_NO_LIBAV",
          f"-I{directory / 'include'}", "-o", str(tmp), str(directory / "abi_check.c"),
          f"-L{directory}", "-lbliss", f"-Wl,-rpath,{directory}", "-lm"],
         "abi_check.c's build", directory)
    os.replace(tmp, directory / ABI_CHECK)


def _ensure_built() -> Path:
    """The build directory, with the library and ``abi_check`` in it.
    Existence is re-checked under the lock, so concurrent first-use threads
    build once; processes meet only renames."""
    make_vars = _make_vars()
    directory = _build_dir(make_vars)
    if not (directory / ABI_CHECK).exists():
        with _build_lock:
            if not (directory / ABI_CHECK).exists():
                _build(directory, make_vars)
    return directory


def library_path() -> str:
    """Path of ``libbliss.so``, built at first use; raises MissingBuildTool
    naming what is missing (``Python.h``, ``g++``, ``make``, ``gcc``), or
    RuntimeError with the compiler's output."""
    return str(_ensure_built() / LIB_NAME)


def abi_check_path() -> str:
    """Path of the ``abi_check`` program linked against ``library_path()``."""
    return str(_ensure_built() / ABI_CHECK)


class ForceVector(ctypes.Structure):
    """``struct force_vector_s``."""

    _fields_ = [(n, ctypes.c_float) for n in ("tempo", "amplitude", "frequency", "attack")]


class EnvelopeResult(ctypes.Structure):
    """``struct envelope_result_s``."""

    _fields_ = [("tempo", ctypes.c_float), ("attack", ctypes.c_float)]


class BlSong(ctypes.Structure):
    """``struct bl_song`` (``include/bliss.h``); the strings and
    ``sample_array`` belong to the library: free them with ``bl_free_song``."""

    _fields_ = [("force", ctypes.c_float), ("force_vector", ForceVector),
                ("sample_array", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("channels", "nSamples", "sample_rate", "bitrate",
                                     "nb_bytes_per_sample", "calm_or_loud", "resampled")] + [
        ("duration", ctypes.c_uint64)] + [
        (n, ctypes.c_void_p) for n in ("filename", "artist", "title", "album", "tracknumber",
                                        "genre")]


def abi_check_lines(stdout: str) -> dict[str, list[list[str]]]:
    """``abi_check``'s output as {kind: [the fields of each line, ...]}
    (``abi_check.c``'s header lists the kinds)."""
    out: dict[str, list[list[str]]] = {}
    for line in stdout.splitlines():
        kind, _, rest = line.partition(" ")
        out.setdefault(kind, []).append(rest.split(" "))
    return out


def load() -> ctypes.CDLL:
    """``libbliss.so`` (built at first use) loaded into this process, with
    the argument and result types of all fifteen functions. A call releases
    the GIL, and the library takes it back to run in this interpreter."""
    lib = ctypes.CDLL(library_path())
    song = ctypes.POINTER(BlSong)
    vec = ForceVector
    path = ctypes.c_char_p
    i16 = ctypes.POINTER(ctypes.c_int16)
    f64 = ctypes.POINTER(ctypes.c_double)
    for name, args, res in (
        ("bl_analyze", [path, song], ctypes.c_int),
        ("bl_distance_file", [path, path, song, song], ctypes.c_float),
        ("bl_distance", [vec, vec], ctypes.c_float),
        ("bl_cosine_similarity_file", [path, path, song, song], ctypes.c_float),
        ("bl_cosine_similarity", [vec, vec], ctypes.c_float),
        ("bl_envelope_sort", [song, ctypes.POINTER(EnvelopeResult)], None),
        ("bl_amplitude_sort", [song], ctypes.c_float),
        ("bl_frequency_sort", [song], ctypes.c_float),
        ("bl_audio_decode", [path, song], ctypes.c_int),
        ("bl_free_song", [song], None),
        ("bl_version", [], ctypes.c_float),
        ("bl_initialize_song", [song], None),
        ("bl_mean", [i16, ctypes.c_int], ctypes.c_int),
        ("bl_variance", [i16, ctypes.c_int, ctypes.c_int], ctypes.c_int),
        ("bl_rectangular_filter", [f64, f64, ctypes.c_int, ctypes.c_int], None),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib
