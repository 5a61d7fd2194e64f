"""Persistent analysis daemon: JSON-lines over a Unix socket or TCP (the
port of ``bliss_tpu/server.py``: the same protocol, ops, JSON keys, error
texts and lifecycle).

The reference is strictly one-shot: every ``bl_analyze`` consumer pays
process start and library init per invocation (reference: src/analyze.c:33,
examples/analyze.c:17-46 — there is no serving layer at all). A production
deployment wants a resident process instead: the CUDA libraries are built
(``nvcc``, at first use) and loaded once, the CUDA context is created once,
the FeatureStore index stays in memory, and repeat queries for
already-scanned content return without touching the device. This module is
that layer.

Protocol: newline-delimited JSON, one object per line in each direction.

    Request:  {"op": <str>, "id": <any, optional>, ...params}
    Response: {"ok": true,  "id": ...,  ...result}
            | {"ok": false, "id": ..., "error": <str>}

Ops:
    ping                                      -> {"pong": true}
    status                                    -> version/backend/config/
                                                 store/counter snapshot
    analyze  {"paths": [p...], "extended"?}   -> {"features": {p: [t,a,f,k]},
                                                  "extended": {p: [...]}?,
                                                  "errors": {p: msg}}
    scan     {"dir": d, "extended"?,
              "progress"?}                    -> interleaved
                                                 {"event": "progress", ...}
                                                 lines (if requested), then
                                                 {"files": n, "analyzed": n,
                                                  "errors": {...}, "stats"?}
    distance {"a": p|vec, "b": p|vec}         -> {"distance": float,
                                                  "similarity": float}
    playlist {"seed": p, "paths": [p...],
              "length"?}                      -> {"paths": [ordered...]}
    neighbors {"top_k"?}                      -> every store entry's k
                                                 nearest others (warm
                                                 store, zero re-analysis)
    shutdown                                  -> {"stopping": true} and the
                                                 server exits its loop

``a``/``b`` accept either an audio path (analyzed, store-cached) or a
ready 4-element force vector. All analysis rides the same
``pipeline.analyze_library`` as the CLI — store caching, long-song
streaming and per-song failure isolation apply unchanged; a ``mesh``
(``parallel.analysis_mesh``) goes to ``analyze_library``, which analyzes
every bucket over it, and to warmup's clip. Concurrent client
connections are accepted; analysis requests are serialized on one lock (a
single device queue beats interleaved launches on one card). Every op runs
on the server's ``device``, passed explicitly: nothing depends on a
thread's current CUDA device or stream.

Backend loss. A CUDA error such as an illegal memory access or an
unspecified launch failure is sticky: it poisons the process's CUDA
context, and PyTorch cannot reset that context in-process (there is no
``jax.clear_backends`` counterpart). So a request that hits one answers
``{"ok": false, ...}``, the daemon marks itself degraded in ``/status`` and
``/metrics``, and it recovers only when a later request (or health probe)
on the card succeeds; while the context stays poisoned every device request
fails and the daemon stays degraded. Nothing moves the work to the CPU. A
``torch.OutOfMemoryError`` fails its request only: the context survives it,
so it does not mark the daemon degraded.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any

import numpy as np
import torch

from bliss_tpu_torch.config import AnalysisConfig
from bliss_tpu_torch.features.types import resolve_device
from bliss_tpu_torch.store import FeatureStore
from bliss_tpu_torch.utils import get_logger, log_event

logger = get_logger("bliss_tpu_torch.server")

_MAX_LINE = 32 << 20  # defensive cap on one request line (32 MB)
_SEND_TIMEOUT = 30.0  # max seconds one send to a stalled client may block

# Error texts of a lost or poisoned CUDA backend, as opposed to a bad
# request: torch.AcceleratorError and RuntimeError("CUDA error: ...") carry
# CUDA's own messages, and kernels/_build.launch raises "<entry> launch
# failed: ..." when a launch is refused. A match flips the daemon into
# degraded mode until a device call succeeds again.
_BACKEND_ERROR_MARKERS = (
    "AcceleratorError",
    "CUDA error",
    "unspecified launch failure",
    "illegal memory access",
    "CUDA driver",
    "CUDA GPUs are available",  # "No CUDA GPUs are available"
    "CUDA-capable device",
    "launch failed",
)


def _is_backend_error(e: BaseException) -> bool:
    """Whether ``e`` says the CUDA backend is lost; running out of device
    memory is a failure of the request, not of the backend."""
    msg = f"{type(e).__name__}: {e}"
    if isinstance(e, torch.OutOfMemoryError) or "out of memory" in msg:
        return False
    return any(m in msg for m in _BACKEND_ERROR_MARKERS)


class AnalysisServer:
    """Resident analysis service over a Unix socket or loopback TCP.

    Exactly one of ``socket_path`` / ``port`` selects the transport. The
    analysis runs on ``device``: the GPU unless the caller asks for the CPU
    (``device="cpu"``); RuntimeError when no GPU is present.
    """

    def __init__(
        self,
        socket_path: str | None = None,
        *,
        port: int | None = None,
        host: str = "127.0.0.1",
        cfg: AnalysisConfig | None = None,
        store: FeatureStore | None = None,
        batch_size: int = 64,
        mesh=None,
        health_probe_interval: float | None = None,
        device="cuda",
    ):
        if socket_path is not None and port is not None:
            raise ValueError("pass at most one of socket_path / port")
        # both None is allowed: an HTTP-only deployment wraps this server
        # with http_gateway.HttpGateway and never calls serve_forever()
        self.device = resolve_device(device)
        if cfg is None:
            from bliss_tpu_torch.api import default_config

            cfg = default_config()
        self.socket_path = socket_path
        self.host, self.port = host, port
        self.cfg = cfg
        self.store = store
        self.batch_size = batch_size
        self.mesh = mesh
        self._analysis_lock = threading.Lock()
        self._stop = threading.Event()
        self._listener: socket.socket | None = None
        self._sock_ino: int | None = None
        self._t0 = time.time()
        self._counters = {"requests": 0, "songs_analyzed": 0, "errors": 0}
        self._ready = threading.Event()
        # Backend loss handling: the affected request fails cleanly,
        # /status and /metrics report degraded, and the next
        # device-touching request that succeeds marks the daemon healthy.
        self._backend_health = {
            "healthy": True,
            "consecutive_failures": 0,
            "recoveries": 0,
            "last_error": None,
            "last_failure_unix": None,
        }
        self._health_lock = threading.Lock()
        # Optional watchdog: a host->device->host round trip every
        # `health_probe_interval` seconds, so a poisoned context flips
        # /metrics within one interval and a degraded daemon recovers
        # WITHOUT waiting for client traffic. Off by default.
        self.health_probe_interval = health_probe_interval
        if health_probe_interval:
            threading.Thread(
                target=self._health_probe_loop, daemon=True,
                name="bliss-health-probe",
            ).start()

    # --- transport ----------------------------------------------------------

    def _bind(self) -> socket.socket:
        if self.socket_path is None and self.port is None:
            raise RuntimeError(
                "no socket transport configured (HTTP-only server); "
                "pass socket_path= or port= to serve the line protocol"
            )
        if self.socket_path is not None:
            if not hasattr(socket, "AF_UNIX"):  # pragma: no cover
                raise RuntimeError(
                    "AF_UNIX unavailable on this platform; use port="
                )
            # A socket file may be a stale leftover from a dead server
            # (safe to replace) or a LIVE daemon (silently stealing its
            # path would leave it running but unreachable): probe first.
            if os.path.exists(self.socket_path):
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.settimeout(2.0)
                    probe.connect(self.socket_path)
                except OSError:
                    pass  # nobody answering -> stale file
                else:
                    raise RuntimeError(
                        f"{self.socket_path}: a live server is already "
                        "listening here"
                    )
                finally:
                    probe.close()
                os.unlink(self.socket_path)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(self.socket_path)
            self._sock_ino = os.stat(self.socket_path).st_ino
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((self.host, self.port))
            self.port = s.getsockname()[1]  # resolve port=0
        s.listen(64)  # enough backlog for a burst of one-shot clients
        # (each `request()` opens a fresh connection; on a loaded host a
        # burst can outrun the accept loop)
        s.settimeout(0.25)  # so the accept loop notices _stop
        return s

    def warmup(self, seconds: float = 2.0) -> None:
        """Get the device path ready before accepting traffic: a synthetic
        clip goes through ``pipeline._scan``, the loop that
        ``analyze_library`` runs after decode. On the GPU that builds the
        CUDA libraries with ``nvcc`` if they are not on disk yet
        (``kernels/_build``), creates the CUDA context and launches the
        prepass and K1 once (with a ``mesh``, the clip is analyzed over it:
        the prepass, K2 and K3 where its shards take the kernels). It
        decodes nothing: the card's machines may
        lack the libav development files that the native decoder builds
        against, and the decode round trip is ``doctor``'s check."""
        from bliss_tpu_torch import pipeline
        from bliss_tpu_torch.io import DecodedAudio
        from bliss_tpu_torch.utils import StageTimer

        n = int(22050 * seconds)
        t = np.arange(n)
        pcm = (
            4000.0
            * np.sin(2 * np.pi * 440.0 * t / 22050.0)
            * (((t * 2.0 / 22050.0) % 1.0) < 0.5)
        ).astype(np.int16)
        clip = DecodedAudio(np.stack([pcm, pcm], axis=1).reshape(-1), 2, 22050, 0, 2, 0,
                            int(seconds), "warmup", "", "", "", "", "")
        result = pipeline.ScanResult(["warmup"], np.full((1, 4), np.nan, np.float32),
                                     np.zeros(1, bool), {}, {})
        t0 = time.time()
        with self._analysis_lock:
            self._device_call(lambda: pipeline._scan(
                result, enumerate([clip]), cfg=self.cfg, batch_size=self.batch_size,
                device=self.device, timer=StageTimer(), mesh=self.mesh,
            ))
        if not result.ok.all():
            raise RuntimeError(f"warmup analysis failed: {result.errors}")
        log_event(logger, "warmup done", seconds=round(time.time() - t0, 2),
                  device=str(self.device))

    def bind(self) -> None:
        """Bind the listener now (idempotent). ``serve_forever`` calls this
        itself; call it earlier to resolve an ephemeral ``port=0`` to the
        real port before announcing the address."""
        if self._listener is None:
            self._listener = self._bind()
            self._ready.set()

    def serve_forever(self) -> None:
        """Accept connections until a ``shutdown`` op or ``stop()``."""
        self.bind()
        where = self.socket_path or f"{self.host}:{self.port}"
        log_event(logger, "serving", at=where, device=str(self.device))
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                t = threading.Thread(
                    target=self._serve_connection, args=(conn,), daemon=True
                )
                t.start()
        finally:
            self._listener.close()
            if self.socket_path is not None:
                # only remove the file WE bound: if another daemon replaced
                # it meanwhile, unlinking would cut that live server off
                try:
                    if os.stat(self.socket_path).st_ino == self._sock_ino:
                        os.unlink(self.socket_path)
                except OSError:
                    pass
            if self.store is not None:
                self.store.flush()
            log_event(logger, "server stopped", **self._counters)

    def stop(self) -> None:
        self._stop.set()

    def wait_stopped(self, timeout: float | None = None) -> bool:
        """Block until ``stop()`` / a shutdown op (HTTP-only run loops)."""
        return self._stop.wait(timeout)

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until the listener is bound (for tests / supervisors)."""
        return self._ready.wait(timeout)

    def _serve_connection(self, conn: socket.socket) -> None:
        # The timeout bounds how long ONE send to a stalled client can
        # block (a scan-progress emit runs under the analysis lock, so an
        # unbounded sendall there would wedge every other client's
        # analysis). Idle recv timeouts are normal for a kept-open client
        # connection and just re-poll.
        conn.settimeout(_SEND_TIMEOUT)
        with conn:
            buf = b""
            while not self._stop.is_set():
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                if len(buf) > _MAX_LINE:
                    self._send(conn, {"ok": False, "error": "request too large"})
                    return
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    resp = self._handle_line(
                        line, lambda obj: self._send(conn, obj)
                    )
                    if not self._send(conn, resp):
                        return
                    if self._stop.is_set():
                        return

    @staticmethod
    def _send(conn: socket.socket, obj: dict) -> bool:
        try:
            conn.sendall(json.dumps(obj).encode() + b"\n")
            return True
        except OSError:
            return False

    # --- request handling ---------------------------------------------------

    def _handle_line(self, line: bytes, send=None) -> dict:
        """Handle one request line; returns the response object.

        ``send`` is an optional transport-agnostic event sink
        ``(dict) -> bool`` (False = client gone) used for intermediate
        progress events — a socket writer here, a chunked HTTP writer in
        ``http_gateway.HttpGateway``.
        """
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            self._counters["errors"] += 1
            return {"ok": False, "error": f"bad request: {e}"}
        rid = req.get("id")
        self._counters["requests"] += 1

        broken = [False]  # after one failed send, stop trying: each retry
        # against a stalled client would burn another _SEND_TIMEOUT while
        # the analysis lock is held

        def emit(obj: dict) -> None:
            """Intermediate event line (no 'ok' key => not the response)."""
            if send is not None and not broken[0]:
                if rid is not None:
                    obj = {**obj, "id": rid}
                if not send(obj):
                    broken[0] = True

        try:
            out = self._dispatch(req, emit)
            out["ok"] = True
        except Exception as e:  # per-request isolation: server survives
            self._counters["errors"] += 1
            log_event(logger, "request failed", op=req.get("op"), error=str(e))
            out = {"ok": False, "error": str(e)}
        if rid is not None:
            out["id"] = rid
        return out

    def _dispatch(self, req: dict, emit) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"pong": True}
        if op == "status":
            return self._status()
        if op == "analyze":
            return self._analyze_op(req)
        if op == "scan":
            return self._scan_op(req, emit)
        if op in ("distance", "cosine"):
            return self._distance_op(req)
        if op == "playlist":
            return self._playlist_op(req)
        if op == "neighbors":
            return self._neighbors_op(req)
        if op == "shutdown":
            self._stop.set()
            return {"stopping": True}
        raise ValueError(f"unknown op {op!r}")

    # --- backend loss / recovery ---------------------------------------------

    def _device_call(self, fn):
        """Run device-touching work on the server's device with
        backend-loss accounting: a backend error marks the daemon degraded
        (and re-raises so the request fails cleanly); the next call that
        succeeds in degraded state marks it healthy again."""
        with self._health_lock:
            was_degraded = not self._backend_health["healthy"]
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    out = fn()
            else:
                out = fn()
        except Exception as e:
            if _is_backend_error(e):
                with self._health_lock:
                    self._backend_health["healthy"] = False
                    self._backend_health["consecutive_failures"] += 1
                    self._backend_health["last_error"] = (
                        f"{type(e).__name__}: {e}"
                    )
                    self._backend_health["last_failure_unix"] = round(
                        time.time(), 1
                    )
                    consecutive = self._backend_health["consecutive_failures"]
                log_event(
                    logger, "backend lost", error=str(e),
                    consecutive=consecutive,
                )
            raise
        if was_degraded:
            with self._health_lock:
                # a concurrent caller (or the probe) may have recovered
                # first — count one recovery per degraded episode
                if not self._backend_health["healthy"]:
                    self._backend_health["healthy"] = True
                    self._backend_health["consecutive_failures"] = 0
                    self._backend_health["recoveries"] += 1
                    log_event(logger, "backend recovered")
        return out

    def _probe_op(self) -> None:
        """One host->device->host round trip of a float on the server's
        device, synchronized: the path that fails once the context is
        poisoned, with no kernel of the port's own."""
        x = torch.ones(1, dtype=torch.float32).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        x.cpu()

    def _health_probe_loop(self) -> None:
        """Watchdog body: probe the backend every interval. A failing probe
        marks the daemon degraded (silent-loss detection); a succeeding
        probe in degraded state marks it recovered — both via the same
        ``_device_call`` accounting the request path uses."""
        while not self._stop.wait(self.health_probe_interval):
            try:
                self._device_call(self._probe_op)
            except Exception:  # noqa: BLE001 — accounted for in _device_call
                pass

    def _status(self) -> dict:
        """Touches no CUDA when the server runs on the CPU; on the GPU
        ``torch.cuda.device_count`` creates no context either."""
        from bliss_tpu_torch import __version__

        backend, devices = self.device.type, 1
        if backend == "cuda":
            # a dead backend must not take /status down with it: report it
            try:
                devices = torch.cuda.device_count()
            except Exception as e:  # noqa: BLE001 — degraded, not broken
                backend, devices = "unavailable", 0
                with self._health_lock:
                    self._backend_health["healthy"] = False
                    self._backend_health["last_error"] = (
                        f"{type(e).__name__}: {e}"
                    )
        with self._health_lock:
            health = dict(self._backend_health)
        return {
            "version": __version__,
            "backend": backend,
            "devices": devices,
            "backend_health": health,
            "config": {
                "dtype": self.cfg.dtype,
                "tempo_finish": self.cfg.tempo_finish,
                "fused_kernel": self.cfg.fused_kernel,
                "nb_bands": self.cfg.nb_bands,
            },
            "store": None if self.store is None else {
                "path": self.store.path,
                "entries": len(self.store),
            },
            "uptime_s": round(time.time() - self._t0, 1),
            **self._counters,
        }

    def _library(self, files: list[str], **kw):
        """``analyze_library`` of ``files`` on the server's device, under
        the analysis lock and the backend-loss accounting."""
        from bliss_tpu_torch.pipeline import analyze_library

        with self._analysis_lock:
            result = self._device_call(
                lambda: analyze_library(
                    files,
                    cfg=self.cfg,
                    batch_size=self.batch_size,
                    store=self.store,
                    mesh=self.mesh,
                    handle_sigint=False,
                    device=self.device,
                    **kw,
                )
            )
        self._counters["songs_analyzed"] += int(result.ok.sum())
        return result

    def _analyze_paths(self, paths: list[str], extended: bool = False):
        for p in paths:
            if not isinstance(p, str):
                raise ValueError("paths must be strings")
        return self._library(paths, extended=extended)

    def _analyze_op(self, req: dict) -> dict:
        paths = req.get("paths")
        if not isinstance(paths, list) or not paths:
            raise ValueError("analyze needs a non-empty 'paths' list")
        extended = bool(req.get("extended", False))
        result = self._analyze_paths(paths, extended=extended)
        out: dict[str, Any] = {
            "features": {
                p: [float(x) for x in result.features[i]]
                for i, p in enumerate(paths)
                if result.ok[i]
            },
            "errors": result.errors,
        }
        if extended:
            from bliss_tpu_torch.features.types import EXTENDED_FEATURE_NAMES

            out["extended_names"] = list(EXTENDED_FEATURE_NAMES)
            out["extended"] = {
                p: [float(x) for x in result.extended[i]]
                for i, p in enumerate(paths)
                if result.ok[i]
            }
        return out

    def _scan_op(self, req: dict, emit) -> dict:
        """Walk a directory, analyze every audio file into the store.

        The daemon analog of ``cli scan`` (and of the reference GUI's
        background worker, reference python/examples/analyze_gui.py:13-58):
        with ``"progress": true`` the connection receives interleaved
        ``{"event": "progress", "done": n, "total": n, "path": ...}``
        lines before the final response.
        """
        from bliss_tpu_torch.cli import _collect_audio_files

        d = req.get("dir")
        if not isinstance(d, str) or not os.path.isdir(d):
            raise ValueError("scan needs a 'dir' pointing at a directory")
        files = _collect_audio_files([d])
        extended = bool(req.get("extended", False))

        progress = None
        if req.get("progress"):
            def progress(done, total, msg):
                emit({
                    "event": "progress", "done": done, "total": total,
                    "path": msg,
                })

        result = self._library(files, extended=extended, progress=progress)
        return {
            "files": len(files),
            "analyzed": int(result.ok.sum()),
            "errors": result.errors,
            "stats": {
                k: v for k, v in result.stats.items()
                if isinstance(v, (int, float, bool, str))
            },
        }

    def _neighbors_op(self, req: dict) -> dict:
        """Whole-library top-k from the warm store (see cli 'store
        neighbors'): blocked float64 distance products and top-k on the
        device, no re-analysis. ``similarity_rows`` snapshots under the
        store lock (safe against a concurrent scan's puts) and dedups
        multi-config entries per file."""
        from bliss_tpu_torch.sim import nearest_neighbors_all
        from bliss_tpu_torch.store import similarity_rows

        if self.store is None:
            raise ValueError("neighbors needs the daemon to run with --store")
        top_k = int(req.get("top_k", 5))
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1 (got {top_k})")
        names, feats = similarity_rows(self.store)
        if len(names) < 2:
            raise ValueError("need at least 2 store entries")
        k = min(top_k, len(names) - 1)
        with self._analysis_lock:
            dists, idx = self._device_call(
                lambda: tuple(
                    x.cpu().numpy()
                    for x in nearest_neighbors_all(feats, k, device=self.device)
                )
            )
        return {
            "neighbors": {
                name: [
                    {"path": names[idx[i, j]], "distance": float(dists[i, j])}
                    for j in range(k)
                ]
                for i, name in enumerate(names)
            }
        }

    def _vector(self, spec) -> np.ndarray:
        """An audio path (analyze, store-cached) or a literal 4-vector."""
        if isinstance(spec, str):
            result = self._analyze_paths([spec])
            if not result.ok[0]:
                raise ValueError(
                    f"analysis failed for {spec}: "
                    f"{result.errors.get(spec, 'unknown error')}"
                )
            return result.features[0]
        v = np.asarray(spec, np.float32)
        if v.shape != (4,):
            raise ValueError("vector operands must have exactly 4 elements")
        return v

    def _distance_op(self, req: dict) -> dict:
        from bliss_tpu_torch.sim import cosine_similarity, distance

        # two 4-vectors on the host, as api.distance computes them
        va, vb = (torch.from_numpy(self._vector(req.get(k))) for k in ("a", "b"))
        return {
            "distance": float(distance(va, vb)),
            "similarity": float(cosine_similarity(va, vb)),
        }

    def _playlist_op(self, req: dict) -> dict:
        from bliss_tpu_torch.sim import playlist_order

        seed = req.get("seed")
        paths = list(req.get("paths") or [])
        if not isinstance(seed, str):
            raise ValueError("playlist needs a 'seed' path")
        if seed not in paths:
            paths = [seed] + paths
        result = self._analyze_paths(paths)
        valid = [i for i in range(len(paths)) if result.ok[i]]
        if paths.index(seed) not in valid:
            raise ValueError(
                f"seed analysis failed: {result.errors.get(seed, 'unknown')}"
            )
        with self._analysis_lock:
            order = self._device_call(lambda: playlist_order(
                result.features[valid], valid.index(paths.index(seed)), device=self.device,
            ).cpu().numpy())
        length = req.get("length")
        if length is None:
            length = len(order)
        elif not isinstance(length, int) or length < 0:
            raise ValueError(f"length must be a non-negative int (got {length!r})")
        return {
            "paths": [paths[valid[i]] for i in order[:length]],
            "errors": result.errors,
        }


def request(
    obj: dict,
    socket_path: str | None = None,
    *,
    port: int | None = None,
    host: str = "127.0.0.1",
    timeout: float = 600.0,
    on_event=None,
) -> dict:
    """One-shot client: send one request object, return the response.

    Intermediate event lines (objects without an ``ok`` key, e.g. scan
    progress) are passed to ``on_event`` if given, else discarded; the
    first object carrying ``ok`` is the response. Each received chunk is
    searched for the end of the line once, so a response of tens of MB
    (``neighbors`` over a large store) reads in linear time.
    """
    if (socket_path is None) == (port is None):
        raise ValueError("pass exactly one of socket_path / port")
    if socket_path is not None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        addr: Any = socket_path
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        addr = (host, port)
    with s:
        s.settimeout(timeout)
        s.connect(addr)
        s.sendall(json.dumps(obj).encode() + b"\n")
        buf = bytearray()
        seen = 0  # no newline in buf[:seen]
        while True:
            nl = buf.find(b"\n", seen)
            if nl < 0:
                seen = len(buf)
                chunk = s.recv(1 << 20)
                if not chunk:
                    raise ConnectionError("server closed before replying")
                buf += chunk
                continue
            resp = json.loads(buf[:nl])
            del buf[: nl + 1]
            seen = 0
            if "ok" in resp:
                return resp
            if on_event is not None:
                on_event(resp)
