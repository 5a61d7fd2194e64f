"""The port's HTTP gateway (``bliss_tpu_torch/http_gateway.py``) over the
port's daemon on the CPU: each HTTP case of ``tests/test_server.py``, the
backend-health gauges after a CUDA error text, and the routes and metric
names held to ``bliss_tpu``'s gateway. Every wait is bounded."""

import json
import socket
import threading
import time
import urllib.request

import pytest
import torch

from test_server import _http, _write_wav

from bliss_tpu_torch import pipeline
from bliss_tpu_torch.http_gateway import HttpGateway
from bliss_tpu_torch.server import AnalysisServer, request
from bliss_tpu_torch.store import FeatureStore

torch.set_num_threads(1)


@pytest.fixture
def http_served(tmp_path):
    """AnalysisServer on the CPU with an HTTP gateway on an ephemeral port
    (HTTP-only: no line-protocol listener)."""
    store = FeatureStore(str(tmp_path / "store"))
    server = AnalysisServer(port=None, socket_path=None, store=store,
                            batch_size=8, device="cpu")
    gw = HttpGateway(server, port=0)
    gw.start()
    yield server, gw, store, tmp_path
    gw.stop()


def test_http_ping_status_metrics(http_served):
    server, gw, store, tmp = http_served
    code, body, _ = _http("GET", gw.port, "/ping", timeout=30)
    assert code == 200 and json.loads(body) == {"ok": True, "pong": True}

    code, body, _ = _http("GET", gw.port, "/status", timeout=30)
    st = json.loads(body)
    assert code == 200 and st["ok"] and st["backend"] == "cpu" and st["devices"] == 1

    code, body, hdrs = _http("GET", gw.port, "/metrics", timeout=30)
    assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
    text = body.decode()
    assert "bliss_requests_total" in text
    assert "bliss_store_entries 0" in text

    code, body, _ = _http("GET", gw.port, "/nope", timeout=30)
    assert code == 404


def test_http_metric_names_are_bliss_tpus(http_served):
    """The same Prometheus names, in the same order, as bliss_tpu's
    gateway over a server with a store."""
    from bliss_tpu.http_gateway import HttpGateway as JGateway
    from bliss_tpu.server import AnalysisServer as JServer
    from bliss_tpu.store import FeatureStore as JStore

    server, gw, store, tmp = http_served

    def names(text):
        return [line.split()[0] for line in text.splitlines() if not line.startswith("#")]

    jgw = JGateway(JServer(store=JStore(str(tmp / "jstore"))), port=0)
    try:
        want = names(jgw._metrics_text())
    finally:
        jgw.stop()
    assert names(gw._metrics_text()) == want


def test_http_analyze_and_errors(http_served):
    server, gw, store, tmp = http_served
    a = _write_wav(tmp / "a.wav", freq=600.0)
    code, body, _ = _http("POST", gw.port, "/",
                          {"op": "analyze", "paths": [a]}, timeout=120)
    r = json.loads(body)
    assert code == 200 and r["ok"] and len(r["features"][a]) == 4
    assert len(store) == 1

    # request-level errors map to HTTP 400 with the error payload
    code, body, _ = _http("POST", gw.port, "/", {"op": "no_such"}, timeout=30)
    r = json.loads(body)
    assert code == 400 and not r["ok"] and "unknown op" in r["error"]

    code, body, _ = _http("POST", gw.port, "/",
                          {"op": "analyze", "paths": []}, timeout=30)
    assert code == 400

    # counters moved
    code, body, _ = _http("GET", gw.port, "/metrics", timeout=30)
    text = body.decode()
    assert "bliss_songs_analyzed_total 1" in text
    assert "bliss_store_entries 1" in text


def test_http_shutdown_stops_gateway(tmp_path):
    server = AnalysisServer(port=None, socket_path=None, device="cpu")
    gw = HttpGateway(server, port=0)
    gw.start()
    code, body, _ = _http("POST", gw.port, "/", {"op": "shutdown"}, timeout=30)
    assert code == 200 and json.loads(body)["stopping"]
    assert server.wait_stopped(30)
    gw.stop()  # idempotent


def test_http_alongside_socket_transport(tmp_path):
    """Both transports on ONE server share the store, counters and lock."""
    sock = str(tmp_path / "s.sock")
    store = FeatureStore(str(tmp_path / "store"))
    server = AnalysisServer(sock, store=store, batch_size=8, device="cpu")
    gw = HttpGateway(server, port=0)
    gw.start()
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    assert server.wait_ready(30)
    try:
        a = _write_wav(tmp_path / "a.wav", freq=700.0)
        assert request({"op": "analyze", "paths": [a]}, sock, timeout=120)["ok"]
        code, body, _ = _http("POST", gw.port, "/",
                              {"op": "analyze", "paths": [a]}, timeout=120)
        r = json.loads(body)
        assert code == 200 and r["ok"]
        # served from the same warm store (no second entry)
        assert len(store) == 1
        code, body, _ = _http("GET", gw.port, "/metrics", timeout=30)
        assert "bliss_requests_total 2" in body.decode()
    finally:
        gw.stop()
        server.stop()
        t.join(timeout=30)
        assert not t.is_alive()


def test_http_scan_streams_progress(http_served):
    """POST / with progress:true streams chunked NDJSON: interleaved
    progress events, then the final response (always HTTP 200)."""
    server, gw, store, tmp = http_served
    lib = tmp / "lib"
    lib.mkdir()
    for i in range(3):
        _write_wav(lib / f"s{i}.wav", freq=300.0 + 90 * i)

    req = urllib.request.Request(
        f"http://127.0.0.1:{gw.port}/",
        data=json.dumps(
            {"op": "scan", "dir": str(lib), "progress": True, "id": 5}
        ).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/x-ndjson"
        assert r.headers.get("Content-Length") is None  # chunked
        lines = [json.loads(l) for l in r.read().splitlines() if l.strip()]

    final = lines[-1]
    events = lines[:-1]
    assert final["ok"] and final["analyzed"] == 3 and final["id"] == 5
    assert len(events) >= 1  # progress is per finalized batch
    assert all(e["event"] == "progress" and e["id"] == 5 for e in events)
    assert events[-1]["done"] == events[-1]["total"] == 3
    assert len(store) == 3


def test_http_streamed_error_is_last_line(http_served):
    """A failing streamed request still returns HTTP 200 (status already
    sent); the error rides the final NDJSON line."""
    server, gw, store, tmp = http_served
    code, body, hdrs = _http(
        "POST", gw.port, "/",
        {"op": "scan", "dir": str(tmp / "missing"), "progress": True}, timeout=30,
    )
    assert code == 200
    assert hdrs["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(l) for l in body.splitlines() if l.strip()]
    assert len(lines) == 1 and not lines[0]["ok"]
    assert "scan needs a 'dir'" in lines[0]["error"]


def test_http_gateway_stop_without_start():
    """stop() on a constructed-but-never-started gateway must not hang on
    the serve_forever shutdown handshake."""
    server = AnalysisServer(port=None, socket_path=None, device="cpu")
    gw = HttpGateway(server, port=0)
    gw.stop()  # must return promptly
    assert server.wait_stopped(5)


def test_http_stream_client_disconnect_mid_scan(http_served):
    """A client that drops the connection mid-stream must not wedge or
    kill the daemon: the scan finishes, later events are dropped, and the
    gateway keeps serving."""
    server, gw, store, tmp = http_served
    lib = tmp / "lib2"
    lib.mkdir()
    for i in range(5):
        _write_wav(lib / f"s{i}.wav", freq=320.0 + 70 * i)

    body = json.dumps(
        {"op": "scan", "dir": str(lib), "progress": True}
    ).encode()
    s = socket.create_connection(("127.0.0.1", gw.port), timeout=30)
    s.sendall(
        b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: "
        + str(len(body)).encode() + b"\r\n\r\n" + body
    )
    s.recv(1)  # wait for the status line to start, then vanish
    s.close()

    # the daemon must finish the scan (store fills) and stay responsive
    deadline = time.time() + 60
    while len(store) < 5 and time.time() < deadline:
        time.sleep(0.1)
    assert len(store) == 5
    code, body2, _ = _http("GET", gw.port, "/ping", timeout=30)
    assert code == 200 and json.loads(body2)["pong"]


def test_backend_health_in_http_metrics(http_served, monkeypatch):
    """/metrics exposes the degraded gauge after a CUDA error so operators
    can alert on it, and its recovery once a request succeeds."""
    server, gw, store, tmp = http_served
    a = _write_wav(tmp / "a.wav", freq=520.0)
    real = pipeline.analyze_library

    def lost(*args, **kw):
        raise torch.AcceleratorError("CUDA error: unspecified launch failure")

    code, body, _ = _http("GET", gw.port, "/metrics", timeout=30)
    assert "bliss_backend_healthy 1" in body.decode()

    monkeypatch.setattr(pipeline, "analyze_library", lost)
    code, body, _ = _http("POST", gw.port, "/",
                          {"op": "analyze", "paths": [a]}, timeout=30)
    assert code == 400 and "unspecified launch failure" in json.loads(body)["error"]
    code, body, _ = _http("GET", gw.port, "/metrics", timeout=30)
    text = body.decode()
    assert "bliss_backend_healthy 0" in text
    assert "bliss_backend_failures_consecutive 1" in text
    code, body, _ = _http("GET", gw.port, "/status", timeout=30)
    assert not json.loads(body)["backend_health"]["healthy"]

    monkeypatch.setattr(pipeline, "analyze_library", real)
    code, body, _ = _http("POST", gw.port, "/",
                          {"op": "analyze", "paths": [a]}, timeout=120)
    assert code == 200
    code, body, _ = _http("GET", gw.port, "/metrics", timeout=30)
    text = body.decode()
    assert "bliss_backend_healthy 1" in text
    assert "bliss_backend_recoveries_total 1" in text


def test_out_of_memory_leaves_metrics_healthy(http_served, monkeypatch):
    """A request that runs out of device memory answers 400 and leaves the
    backend gauges healthy."""
    server, gw, store, tmp = http_served
    a = _write_wav(tmp / "a.wav")

    def oom(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")

    monkeypatch.setattr(pipeline, "analyze_library", oom)
    code, body, _ = _http("POST", gw.port, "/", {"op": "analyze", "paths": [a]}, timeout=30)
    assert code == 400 and "out of memory" in json.loads(body)["error"]
    code, body, _ = _http("GET", gw.port, "/metrics", timeout=30)
    text = body.decode()
    assert "bliss_backend_healthy 1" in text and "bliss_errors_total 1" in text
    assert "bliss_backend_failures_consecutive 0" in text
