"""HTTP front-end for the analysis daemon (a copy of
``bliss_tpu/http_gateway.py`` over the port's ``AnalysisServer``: the same
routes, chunked NDJSON progress and Prometheus names).

The JSON-lines socket protocol (``bliss_tpu_torch/server.py``) is ideal for
local shell/Python clients, but production infrastructure — load
balancers, health checks, monitoring scrapes, non-Python services — talks
HTTP. This gateway exposes the SAME dispatch table over HTTP, sharing the
``AnalysisServer`` instance (one set of loaded CUDA libraries, one store,
one analysis lock) with the socket transport, so both can serve
simultaneously from a single resident process (``bliss-tpu-torch serve
--socket ... --http-port ...``).
The reference has no serving layer at all (every consumer is one-shot,
reference: examples/analyze.c:17-46, src/analyze.c:33).

Routes:
    POST /            body = one request object (same schema as the socket
                      protocol, e.g. ``{"op": "analyze", "paths": [...]}``)
                      -> the response object; HTTP status mirrors ``ok``
                      (200 / 400). With ``"progress": true`` in the body
                      the response is a chunked ``application/x-ndjson``
                      stream: interleaved ``{"event": "progress", ...}``
                      lines followed by the final response object (always
                      HTTP 200 — inspect the last line's ``ok``); same
                      event shapes as the socket transport. ``curl -sN``
                      renders the stream live.
    GET  /ping        liveness  -> {"ok": true, "pong": true}
    GET  /status      the status op (readiness + config snapshot)
    GET  /metrics     Prometheus text exposition of the daemon counters
                      (bliss_requests_total, bliss_songs_analyzed_total,
                      bliss_errors_total, bliss_uptime_seconds,
                      bliss_store_entries)

The ``shutdown`` op is accepted over HTTP and stops BOTH transports.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bliss_tpu_torch.utils import get_logger, log_event

logger = get_logger("bliss_tpu_torch.http")

_MAX_BODY = 32 << 20  # same defensive cap as the socket transport


class HttpGateway:
    """Serve an ``AnalysisServer``'s dispatch table over HTTP."""

    def __init__(self, server, port: int, host: str = "127.0.0.1"):
        self.server = server
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # route table -------------------------------------------------
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path == "/ping":
                    self._reply(200, {"ok": True, "pong": True})
                elif self.path == "/status":
                    self._reply(*gateway._run_op({"op": "status"}))
                elif self.path == "/metrics":
                    self._reply_text(200, gateway._metrics_text())
                else:
                    self._reply(404, {"ok": False, "error": "not found"})

            def do_POST(self):  # noqa: N802
                if self.path != "/":
                    self._reply(404, {"ok": False, "error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = -1
                if n < 0 or n > _MAX_BODY:
                    self._reply(
                        413, {"ok": False, "error": "request too large"}
                    )
                    return
                body = self.rfile.read(n)
                try:
                    req = json.loads(body)
                    if not isinstance(req, dict):
                        raise ValueError("request must be a JSON object")
                except ValueError as e:
                    self._reply(
                        400, {"ok": False, "error": f"bad request: {e}"}
                    )
                    return
                if req.get("progress"):
                    self._stream(req)
                else:
                    self._reply(*gateway._run_op(req))

            def _stream(self, req: dict) -> None:
                """Chunked NDJSON: progress event lines, then the final
                response object. The status line goes out before the op
                runs, so it is always 200; clients read ``ok`` off the
                last line (mirrors the socket protocol's line semantics).
                """
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send(obj: dict) -> bool:
                    data = json.dumps(obj).encode() + b"\n"
                    try:
                        self.wfile.write(
                            b"%x\r\n%s\r\n" % (len(data), data)
                        )
                        self.wfile.flush()
                        return True
                    except OSError:
                        return False

                resp = gateway._run_op(req, send)[1]
                send(resp)
                try:
                    self.wfile.write(b"0\r\n\r\n")  # chunked terminator
                except OSError:
                    pass

            # plumbing ----------------------------------------------------
            def _reply(self, code: int, obj: dict) -> None:
                self._reply_bytes(
                    code, json.dumps(obj).encode() + b"\n",
                    "application/json",
                )

            def _reply_text(self, code: int, text: str) -> None:
                self._reply_bytes(
                    code, text.encode(), "text/plain; version=0.0.4"
                )

            def _reply_bytes(self, code, payload, ctype) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, fmt, *args):  # route to structured log
                log_event(logger, "http", line=fmt % args)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.timeout = 5
        self.port = self._httpd.server_address[1]  # resolve port=0
        self.host = host
        self._thread: threading.Thread | None = None

    # --- request handling (shares the socket transport's semantics) ------

    def _run_op(self, req: dict, send=None) -> tuple[int, dict]:
        # _handle_line applies counting, error isolation and id passthrough;
        # ``send`` (the chunked NDJSON writer for streamed requests, None
        # for plain ones) receives intermediate progress events
        resp = self.server._handle_line(json.dumps(req).encode(), send)
        if resp.get("ok") and req.get("op") == "shutdown":
            self.stop_soon()  # stop the HTTP listener too
        return (200 if resp.get("ok") else 400), resp

    def _metrics_text(self) -> str:
        c = self.server._counters
        lines = [
            "# HELP bliss_requests_total Requests handled (all transports).",
            "# TYPE bliss_requests_total counter",
            f"bliss_requests_total {c['requests']}",
            "# HELP bliss_songs_analyzed_total Songs analyzed.",
            "# TYPE bliss_songs_analyzed_total counter",
            f"bliss_songs_analyzed_total {c['songs_analyzed']}",
            "# HELP bliss_errors_total Failed requests.",
            "# TYPE bliss_errors_total counter",
            f"bliss_errors_total {c['errors']}",
            "# HELP bliss_uptime_seconds Seconds since daemon start.",
            "# TYPE bliss_uptime_seconds gauge",
            f"bliss_uptime_seconds {time.time() - self.server._t0:.1f}",
        ]
        with self.server._health_lock:
            h = dict(self.server._backend_health)
        lines += [
            "# HELP bliss_backend_healthy 1 while the accelerator backend "
            "answers; 0 after a backend-loss error until recovery.",
            "# TYPE bliss_backend_healthy gauge",
            f"bliss_backend_healthy {1 if h['healthy'] else 0}",
            "# HELP bliss_backend_failures_consecutive Device-touching "
            "requests failed since the backend was last healthy.",
            "# TYPE bliss_backend_failures_consecutive gauge",
            f"bliss_backend_failures_consecutive {h['consecutive_failures']}",
            "# HELP bliss_backend_recoveries_total Degraded->healthy "
            "transitions.",
            "# TYPE bliss_backend_recoveries_total counter",
            f"bliss_backend_recoveries_total {h['recoveries']}",
        ]
        if self.server.store is not None:
            lines += [
                "# HELP bliss_store_entries Feature-store entries resident.",
                "# TYPE bliss_store_entries gauge",
                f"bliss_store_entries {len(self.server.store)}",
            ]
        return "\n".join(lines) + "\n"

    # --- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Serve in a daemon thread until ``stop()`` (or a shutdown op)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        log_event(logger, "http serving", at=f"{self.host}:{self.port}")

    def stop_soon(self) -> None:
        """Initiate shutdown without joining (callable from a handler)."""
        self.server.stop()
        threading.Thread(target=self._httpd.shutdown, daemon=True).start()

    def stop(self) -> None:
        self.server.stop()
        if self._thread is not None:
            # shutdown() blocks on serve_forever's exit handshake, so it
            # must only run if start() actually started the loop
            self._httpd.shutdown()
            self._thread.join(timeout=30)
        self._httpd.server_close()
        if self.server.store is not None:
            # an HTTP-only daemon has no serve_forever finally-flush
            self.server.store.flush()
