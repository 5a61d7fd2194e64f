"""Host-side audio decode: any libav-supported format -> canonical PCM (the
port of ``bliss_tpu/io/decoder.py``).

Canonical analysis contract (mirrors the reference contract at
reference src/decode.c:7-9): interleaved signed 16-bit PCM, 22 050 Hz, stereo.
Decode runs on the host through the native C++ shim ``_native/decoder.cc``
(a byte-for-byte copy of the JAX package's), bound via ctypes; batch decode
fans out over host threads (the C call releases the GIL) to keep the device
input pipeline fed.

The shim is built at first use, never at import, with ``make`` against the
host's libav (g++, make, pkg-config and the libav development files), into
``build/bliss_tpu_torch/io-<hash>/`` at the root of the checkout, beside the
port's CUDA libraries. The hash covers the sources, so an edited source
builds anew. The JAX package's other build routes (a library prebuilt into
a wheel, a user-cache copy for read-only installs, the CMake fallback) are
left out: the port runs from its checkout and nothing in it needs them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent / "_native"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "bliss_tpu_torch"
_SOURCES = ("decoder.cc", "Makefile")
_LIB_NAME = "libblisstpu_io.so"
_build_lock = threading.Lock()
_lib = None


class DecodeError(RuntimeError):
    """Raised when a file cannot be decoded.

    Replaces the reference's in-band BL_UNEXPECTED status codes
    (reference: src/decode.c:55-98) with a real exception type.
    """


@dataclasses.dataclass
class DecodedAudio:
    """Decoded, canonicalized audio plus container metadata.

    Field names track the reference ``struct bl_song``
    (reference: include/bliss.h:49-67) so downstream API parity is direct.
    """

    samples: np.ndarray  # int16, interleaved, shape [n_samples]
    channels: int
    sample_rate: int
    bitrate: int
    nb_bytes_per_sample: int
    resampled: int
    duration: int  # whole seconds (container duration, truncated)
    filename: str
    artist: str
    title: str
    album: str
    tracknumber: str
    genre: str

    @property
    def n_samples(self) -> int:
        """Total interleaved sample count (frames * channels)."""
        return int(self.samples.shape[0])

    @property
    def n_frames(self) -> int:
        return self.n_samples // self.channels

    def as_frames(self) -> np.ndarray:
        """[n_frames, channels] view of the interleaved buffer."""
        return self.samples.reshape(-1, self.channels)


class _BtDecoded(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_int16)),
        ("n_samples", ctypes.c_int64),
        ("channels", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("bitrate", ctypes.c_int32),
        ("nb_bytes_per_sample", ctypes.c_int32),
        ("resampled", ctypes.c_int32),
        ("duration", ctypes.c_uint64),
        ("artist", ctypes.c_char_p),
        ("title", ctypes.c_char_p),
        ("album", ctypes.c_char_p),
        ("tracknumber", ctypes.c_char_p),
        ("genre", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


def _build_dir() -> Path:
    """``build/bliss_tpu_torch/io-<hash of the sources>``."""
    h = hashlib.sha1()
    for name in _SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return _BUILD_ROOT / f"io-{h.hexdigest()[:12]}"


def _build_native(directory: Path) -> None:
    """Copy the sources into ``directory`` and run make there; raises
    RuntimeError with make's output if no library comes out."""
    directory.mkdir(parents=True, exist_ok=True)
    for name in _SOURCES:
        target = directory / name
        if not target.exists():
            # copy via a pid-unique temp + atomic rename: a concurrent
            # process either sees the complete file or none at all (a bare
            # shutil.copy could be observed half-written and make would
            # compile truncated source)
            tmp = directory / f"{name}.tmp.{os.getpid()}"
            shutil.copy(_NATIVE_DIR / name, tmp)
            os.replace(tmp, target)
    proc = subprocess.run(
        ["make", "-C", str(directory)], capture_output=True, text=True
    )
    if proc.returncode != 0 or not (directory / _LIB_NAME).exists():
        raise RuntimeError(
            f"native decoder build failed in {directory} (needs g++, make, "
            f"pkg-config and libav's development files):\n{proc.stdout}\n"
            f"{proc.stderr}"
        )


def _ensure_built() -> str:
    """Build the native library on first use if missing.

    Existence is re-checked under the lock so concurrent first-use threads
    run make once; the Makefile builds to a temp name and renames, so a
    concurrent *process* dlopen()ing the library never sees a partial file
    (and two processes building at once resolve to a no-op rename race at
    worst)."""
    directory = _build_dir()
    lib = directory / _LIB_NAME
    if not lib.exists():
        with _build_lock:
            if not lib.exists():
                _build_native(directory)
    return str(lib)


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_ensure_built())
        lib.bt_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(_BtDecoded)]
        lib.bt_decode.restype = ctypes.c_int
        lib.bt_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_BtDecoded)]
        lib.bt_probe.restype = ctypes.c_int
        lib.bt_free_decoded.argtypes = [ctypes.POINTER(_BtDecoded)]
        lib.bt_free_decoded.restype = None
        lib.bt_encode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.bt_encode.restype = ctypes.c_int
        lib.bt_free_cstr.argtypes = [ctypes.c_char_p]
        lib.bt_free_cstr.restype = None
        lib.bt_version.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _decode_str(b: bytes | None) -> str:
    return b.decode("utf-8", errors="replace") if b else ""


def decode(filename: str | os.PathLike) -> DecodedAudio:
    """Decode one audio file to canonical s16/22.05kHz/stereo PCM + tags."""
    filename = os.fspath(filename)
    lib = _load_lib()
    out = _BtDecoded()
    rc = lib.bt_decode(filename.encode("utf-8"), ctypes.byref(out))
    try:
        if rc != 0:
            raise DecodeError(_decode_str(out.error) or f"decode failed: {filename}")
        n = int(out.n_samples)
        samples = np.ctypeslib.as_array(out.samples, shape=(n,)).copy()
        return DecodedAudio(
            samples=samples,
            channels=int(out.channels),
            sample_rate=int(out.sample_rate),
            bitrate=int(out.bitrate),
            nb_bytes_per_sample=int(out.nb_bytes_per_sample),
            resampled=int(out.resampled),
            duration=int(out.duration),
            filename=filename,
            artist=_decode_str(out.artist),
            title=_decode_str(out.title),
            album=_decode_str(out.album),
            tracknumber=_decode_str(out.tracknumber),
            genre=_decode_str(out.genre),
        )
    finally:
        lib.bt_free_decoded(ctypes.byref(out))


@dataclasses.dataclass
class AudioProbe:
    """Container metadata without decoded PCM (the cheap half of decode).

    Audio properties describe the SOURCE stream; ``resampled`` flags whether
    a full decode would canonicalize it. The reference has no probe — its
    only way to read a tag is a full ``bl_audio_decode``
    (reference: src/decode.c:261-309); here tag lookups and library scans
    use this much cheaper path."""

    channels: int
    sample_rate: int
    bitrate: int
    nb_bytes_per_sample: int
    resampled: int
    duration: int
    filename: str
    artist: str
    title: str
    album: str
    tracknumber: str
    genre: str


def probe(filename: str | os.PathLike) -> AudioProbe:
    """Read tags + audio properties WITHOUT decoding any PCM."""
    filename = os.fspath(filename)
    lib = _load_lib()
    out = _BtDecoded()
    rc = lib.bt_probe(filename.encode("utf-8"), ctypes.byref(out))
    try:
        if rc != 0:
            raise DecodeError(_decode_str(out.error) or f"probe failed: {filename}")
        return AudioProbe(
            channels=int(out.channels),
            sample_rate=int(out.sample_rate),
            bitrate=int(out.bitrate),
            nb_bytes_per_sample=int(out.nb_bytes_per_sample),
            resampled=int(out.resampled),
            duration=int(out.duration),
            filename=filename,
            artist=_decode_str(out.artist),
            title=_decode_str(out.title),
            album=_decode_str(out.album),
            tracknumber=_decode_str(out.tracknumber),
            genre=_decode_str(out.genre),
        )
    finally:
        lib.bt_free_decoded(ctypes.byref(out))


class EncodeError(RuntimeError):
    """Raised when PCM cannot be encoded to the requested file/codec."""


def encode(
    filename: str | os.PathLike,
    samples: np.ndarray,
    sample_rate: int = 22050,
    codec: str | None = None,
) -> str:
    """Encode interleaved s16 stereo PCM to an audio file.

    The container comes from the filename extension (``.flac``, ``.mp3``,
    ``.ogg``, ``.wav``, ...); ``codec`` optionally overrides the
    container's default encoder (e.g. ``"libmp3lame"``). The reference has
    no encoder — this exists so tests and benches can generate per-codec
    fixtures (compressed FLAC, mp3, ...) instead of shipping them.
    Lossless targets round-trip bit-exactly through :func:`decode`.
    """
    filename = os.fspath(filename)
    pcm = np.ascontiguousarray(np.asarray(samples, np.int16).reshape(-1))
    if pcm.size == 0 or pcm.size % 2:
        raise EncodeError("need non-empty interleaved stereo samples")
    lib = _load_lib()
    err = ctypes.c_char_p()
    rc = lib.bt_encode(
        filename.encode("utf-8"),
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(pcm.size),
        ctypes.c_int32(sample_rate),
        codec.encode("utf-8") if codec else None,
        ctypes.byref(err),
    )
    if rc != 0:
        msg = _decode_str(err.value) or f"encode failed: {filename}"
        lib.bt_free_cstr(err)
        raise EncodeError(msg)
    return filename


def decode_batch(
    filenames: Sequence[str | os.PathLike],
    *,
    num_workers: int | None = None,
    on_error: str = "raise",
) -> list[DecodedAudio | None]:
    """Decode many files in parallel on host threads.

    With ``on_error="skip"``, undecodable files yield ``None`` instead of
    aborting the batch (per-song error isolation; the batch analog of the
    reference GUI's skip-bad-files behavior,
    reference: python/examples/analyze_gui.py:43-48).
    """
    if on_error not in ("raise", "skip"):
        raise ValueError("on_error must be 'raise' or 'skip'")
    _load_lib()  # build once, outside the pool
    if num_workers is None:
        num_workers = min(32, (os.cpu_count() or 8))

    def _one(fn):
        try:
            return decode(fn)
        except DecodeError:
            if on_error == "raise":
                raise
            return None

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(_one, filenames))


def iter_decode(
    filenames: Iterable[str | os.PathLike],
    *,
    num_workers: int | None = None,
    prefetch: int = 2,
    on_error: str = "skip",
    perf: dict | None = None,
):
    """Streaming decode with bounded prefetch.

    Yields ``(filename, DecodedAudio | None)`` in input order while decoding
    ahead on a thread pool — the host half of the host→device pipeline.
    ``perf``, if given, accumulates "decode_seconds" (summed per-file wall
    time across workers — i.e. core-seconds, not elapsed), "decoded", and
    "decode_cpu_seconds" (summed ``time.thread_time()`` deltas: CPU the
    worker threads actually burned decoding, excluding time they sat
    descheduled behind other threads — the number capacity projections
    must use on contended hosts).
    """
    import time as _time
    from collections import deque

    if num_workers is None:
        num_workers = min(32, (os.cpu_count() or 8))
    filenames = list(filenames)
    plock = threading.Lock()

    def _one(fn):
        t0 = _time.perf_counter()
        c0 = _time.thread_time()
        try:
            return decode(fn)
        except DecodeError:
            if on_error == "raise":
                raise
            return None
        finally:
            if perf is not None:
                with plock:
                    perf["decode_seconds"] = perf.get(
                        "decode_seconds", 0.0
                    ) + (_time.perf_counter() - t0)
                    perf["decode_cpu_seconds"] = perf.get(
                        "decode_cpu_seconds", 0.0
                    ) + (_time.thread_time() - c0)
                    perf["decoded"] = perf.get("decoded", 0) + 1

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        window = max(1, num_workers * max(1, prefetch))
        pending: deque = deque()
        it = iter(filenames)
        for fn in it:
            pending.append((fn, pool.submit(_one, fn)))
            if len(pending) >= window:
                f, fut = pending.popleft()
                yield f, fut.result()
        while pending:
            f, fut = pending.popleft()
            yield f, fut.result()


def native_version() -> str:
    return _load_lib().bt_version().decode()
