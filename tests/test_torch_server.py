"""The port's analysis daemon (``bliss_tpu_torch/server.py``) on the CPU:
each socket-transport case of ``tests/test_server.py`` on the port with
``device="cpu"`` (the mesh case waits for ROADMAP M10), the CUDA
backend-loss taxonomy, the CLI's ``serve``, ``call`` and ``doctor``, and a
differential run of ``bliss_tpu``'s daemon (``for_tpu()``, Pallas in
interpret mode) and the port's (``for_gpu()``, the kernels' plain versions)
on the same WAV files. Every wait is bounded."""

import json
import os
import socket
import threading
import time
import wave

import numpy as np
import pytest
import torch

from conftest import synth_pcm
from test_server import _write_wav

from bliss_tpu_torch import pipeline
from bliss_tpu_torch.server import AnalysisServer, _is_backend_error, request
from bliss_tpu_torch.store import FeatureStore

torch.set_num_threads(1)


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    assert server.wait_ready(30)
    return t


def _stop(server, t):
    server.stop()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.fixture
def served(tmp_path):
    """A running CPU server on a tmp Unix socket with an attached store."""
    sock = str(tmp_path / "bliss.sock")
    store = FeatureStore(str(tmp_path / "store"))
    server = AnalysisServer(sock, store=store, batch_size=8, device="cpu")
    t = _serve(server)
    yield server, sock, store, tmp_path
    _stop(server, t)


def test_ping_status_and_id_passthrough(served):
    server, sock, store, _ = served
    assert request({"op": "ping", "id": 7}, sock, timeout=30) == {
        "ok": True, "pong": True, "id": 7,
    }
    st = request({"op": "status"}, sock, timeout=30)
    assert st["ok"] and st["backend"] == "cpu" and st["devices"] == 1
    assert st["config"] == {"dtype": "float32", "tempo_finish": "device_exact",
                            "fused_kernel": True, "nb_bands": 1}
    assert st["store"]["entries"] == 0
    assert st["requests"] >= 1


def test_status_touches_no_cuda_on_the_cpu(tmp_path, monkeypatch):
    """A CPU daemon's status, ping and analysis never call into torch.cuda
    (a CUDA call would create a context or fail on a card-less host)."""
    def no_cuda(*a, **k):
        raise AssertionError("torch.cuda touched by a CPU server")

    server = AnalysisServer(device="cpu")
    for name in ("device_count", "is_available", "synchronize", "current_device", "_lazy_init"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    st = server._handle_line(b'{"op": "status"}')
    assert st["ok"] and st["backend"] == "cpu" and st["devices"] == 1
    a = _write_wav(tmp_path / "a.wav")
    assert server._handle_line(json.dumps({"op": "analyze", "paths": [a]}).encode())["ok"]
    server._device_call(server._probe_op)


def test_server_runs_on_its_device_and_never_falls_back(tmp_path, monkeypatch):
    """Every analysis gets the server's device; without a GPU the default
    device raises at construction instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalysisServer(str(tmp_path / "s.sock"))
    seen = []
    real = pipeline.analyze_library

    def spy(*args, **kw):
        seen.append(kw["device"])
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "analyze_library", spy)
    server = AnalysisServer(device="cpu")
    a = _write_wav(tmp_path / "a.wav")
    assert server._handle_line(json.dumps({"op": "analyze", "paths": [a]}).encode())["ok"]
    assert seen == [torch.device("cpu")]


def test_analyze_caches_in_store(served):
    server, sock, store, tmp = served
    a = _write_wav(tmp / "a.wav", freq=300.0)
    b = _write_wav(tmp / "b.wav", freq=1200.0, beat_hz=3.0)
    r1 = request({"op": "analyze", "paths": [a, b]}, sock, timeout=120)
    assert r1["ok"] and r1["errors"] == {}
    assert set(r1["features"]) == {a, b}
    assert all(len(v) == 4 and np.isfinite(v).all()
               for v in r1["features"].values())
    assert len(store) == 2  # cached under (content, config) keys
    # the rows are analyze_library's on the same files
    ref = pipeline.analyze_library([a, b], batch_size=8, device="cpu", handle_sigint=False)
    assert [r1["features"][p] for p in (a, b)] == ref.features.tolist()
    # repeat request: served from the warm store, bitwise-identical
    r2 = request({"op": "analyze", "paths": [a, b]}, sock, timeout=120)
    assert r2["features"] == r1["features"]
    assert len(store) == 2


def test_analyze_extended(served):
    server, sock, _, tmp = served
    a = _write_wav(tmp / "a.wav")
    r = request({"op": "analyze", "paths": [a], "extended": True}, sock, timeout=120)
    assert r["ok"]
    assert len(r["extended"][a]) == len(r["extended_names"]) == 45


def test_distance_paths_and_vectors(served):
    server, sock, _, tmp = served
    a = _write_wav(tmp / "a.wav", freq=300.0)
    r = request({"op": "distance", "a": a, "b": [0.0, 0.0, 0.0, 0.0]}, sock, timeout=120)
    assert r["ok"]
    va = np.asarray(request(
        {"op": "analyze", "paths": [a]}, sock, timeout=120)["features"][a])
    assert r["distance"] == pytest.approx(float(np.linalg.norm(va)), rel=1e-5)
    # self-distance ~ 0, similarity ~ 1 (reference README.md:17 property)
    r = request({"op": "distance", "a": a, "b": a}, sock, timeout=120)
    assert r["distance"] == pytest.approx(0.0, abs=1e-6)
    assert r["similarity"] == pytest.approx(1.0, abs=1e-6)


def test_playlist_orders_by_similarity(served):
    server, sock, _, tmp = served
    seed = _write_wav(tmp / "seed.wav", freq=400.0)
    near = _write_wav(tmp / "near.wav", freq=410.0)
    far = _write_wav(tmp / "far.wav", freq=5000.0, beat_hz=6.0, amp=16000.0)
    r = request(
        {"op": "playlist", "seed": seed, "paths": [far, near]}, sock, timeout=120
    )
    assert r["ok"]
    assert r["paths"][0] == seed and set(r["paths"]) == {seed, near, far}


def test_per_request_isolation(served):
    server, sock, _, tmp = served
    # bad op
    r = request({"op": "frobnicate"}, sock, timeout=30)
    assert not r["ok"] and "unknown op" in r["error"]
    # malformed JSON line
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(30)
        s.connect(sock)
        s.sendall(b"{not json\n")
        assert not json.loads(s.makefile().readline())["ok"]
    # a missing file is an error ROW, not a failed request
    good = _write_wav(tmp / "good.wav")
    r = request(
        {"op": "analyze", "paths": [good, str(tmp / "missing.flac")]}, sock, timeout=120
    )
    assert r["ok"] and good in r["features"]
    assert str(tmp / "missing.flac") in r["errors"]
    # server still alive
    assert request({"op": "ping"}, sock, timeout=30)["ok"]


def test_shutdown_op_stops_server_and_unlinks_socket(tmp_path):
    sock = str(tmp_path / "bliss.sock")
    server = AnalysisServer(sock, device="cpu")
    t = _serve(server)
    assert request({"op": "shutdown"}, sock, timeout=30)["stopping"]
    t.join(timeout=30)
    assert not t.is_alive()
    assert not os.path.exists(sock)


def test_tcp_transport(tmp_path):
    server = AnalysisServer(None, port=0, device="cpu")  # ephemeral loopback port
    t = _serve(server)
    try:
        a = _write_wav(tmp_path / "a.wav")
        r = request({"op": "analyze", "paths": [a]}, port=server.port, timeout=120)
        assert r["ok"] and a in r["features"]
    finally:
        _stop(server, t)


def test_scan_op_streams_progress_and_fills_store(served):
    server, sock, store, tmp = served
    lib = tmp / "lib"
    lib.mkdir()
    for i in range(3):
        _write_wav(lib / f"s{i}.wav", freq=300.0 + 200 * i)
    events = []
    r = request(
        {"op": "scan", "dir": str(lib), "progress": True}, sock,
        on_event=events.append, timeout=120,
    )
    assert r["ok"] and r["files"] == 3 and r["analyzed"] == 3
    assert r["errors"] == {} and len(store) == 3
    assert events and all(e["event"] == "progress" for e in events)
    assert events[-1]["done"] == 3 and events[-1]["total"] == 3
    # re-scan: all store hits, still correct
    r2 = request({"op": "scan", "dir": str(lib)}, sock, timeout=120)
    assert r2["analyzed"] == 3 and len(store) == 3
    assert r2["stats"]["decoded"] == 0
    # bad dir is a request error, server survives
    assert not request({"op": "scan", "dir": str(lib / "nope")}, sock, timeout=30)["ok"]
    assert request({"op": "ping"}, sock, timeout=30)["ok"]


def test_neighbors_op_from_warm_store(served):
    from bliss_tpu_torch.sim import nearest_neighbors_all
    from bliss_tpu_torch.store import similarity_rows

    server, sock, store, tmp = served
    lib = tmp / "lib"
    lib.mkdir()
    paths = [
        _write_wav(lib / "a.wav", freq=400.0),
        _write_wav(lib / "b.wav", freq=420.0),
        _write_wav(lib / "c.wav", freq=4000.0, beat_hz=5.0, amp=14000.0),
    ]
    assert request({"op": "scan", "dir": str(lib)}, sock, timeout=120)["analyzed"] == 3
    r = request({"op": "neighbors", "top_k": 2}, sock, timeout=120)
    assert r["ok"] and set(r["neighbors"]) == set(paths)
    for nbrs in r["neighbors"].values():
        assert len(nbrs) == 2
        assert nbrs[0]["distance"] <= nbrs[1]["distance"]
    # a/b are near-identical tones -> mutual nearest
    assert r["neighbors"][paths[0]][0]["path"] == paths[1]
    # the answer is nearest_neighbors_all over the store's rows
    names, feats = similarity_rows(store)
    dist, idx = (x.numpy() for x in nearest_neighbors_all(feats, 2, device="cpu"))
    assert r["neighbors"] == {
        n: [{"path": names[idx[i, j]], "distance": float(dist[i, j])} for j in range(2)]
        for i, n in enumerate(names)
    }
    # without a store it's a request error
    bare = AnalysisServer(str(tmp / "bare.sock"), device="cpu")
    t = _serve(bare)
    try:
        rr = request({"op": "neighbors"}, str(tmp / "bare.sock"), timeout=30)
        assert not rr["ok"] and "--store" in rr["error"]
    finally:
        _stop(bare, t)


def test_warmup_runs_the_device_path_without_traffic(tmp_path, monkeypatch):
    """warmup feeds a synthetic clip to the loop analyze_library runs after
    decode, on the server's device, and decodes nothing."""
    calls = []
    real = pipeline._scan

    def spy(result, stream, **kw):
        stream = list(stream)
        calls.append((len(stream), kw["device"], kw["batch_size"]))
        return real(result, iter(stream), **kw)

    def no_decode(*a, **k):
        raise AssertionError("warmup decoded a file")

    monkeypatch.setattr(pipeline, "_scan", spy)
    monkeypatch.setattr(pipeline, "iter_decode", no_decode)
    server = AnalysisServer(str(tmp_path / "s.sock"), batch_size=4, device="cpu")
    server.warmup(seconds=1.0)  # must not raise; leaves no files behind
    assert calls == [(1, torch.device("cpu"), 4)]
    assert list(tmp_path.iterdir()) == []
    st = server._status()
    assert st["backend_health"]["healthy"] and st["songs_analyzed"] == 0


def test_cli_serve_requires_exactly_one_transport(tmp_path):
    from bliss_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu", "serve"])  # neither --socket nor --port
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "serve", "--socket", str(tmp_path / "s"), "--port", "0"])


def test_cli_serve_without_a_gpu_exits_before_binding(tmp_path, monkeypatch, capsys):
    """No card and no --device cpu: resolve_device's error, and no store,
    no warmup and no socket."""
    from bliss_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock, store = tmp_path / "s.sock", tmp_path / "store"
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--socket", str(sock), "--store", str(store)])
    assert "no CUDA device for device='cuda'" in str(e.value.code)
    assert not sock.exists() and not store.exists()
    # a mesh of more CUDA devices than the card count: stopped before the
    # store, warmup and bind too
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--socket", str(sock), "--store", str(store), "--mesh", "4"])
    assert str(e.value.code) == "--mesh '4' needs 4 devices, have 1"
    assert not sock.exists() and not store.exists()


def test_cli_serve_with_a_mesh_runs_the_daemon(tmp_path):
    """``serve --mesh 2x2`` on the CPU: warmup through the mesh, then the
    daemon answers ``analyze`` with the unmeshed features (beats identical,
    the rest within 5e-4)."""
    from bliss_tpu_torch import cli

    sock = str(tmp_path / "s.sock")
    out = []
    t = threading.Thread(target=lambda: out.append(cli.main(
        ["--device", "cpu", "serve", "--socket", sock, "--batch-size", "4", "--mesh", "2x2"])),
        daemon=True)
    t.start()
    deadline = time.time() + 60
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    a = _write_wav(tmp_path / "a.wav", seconds=2.0)
    r = request({"op": "analyze", "paths": [a]}, sock, timeout=120)
    assert r["ok"] and r["errors"] == {}
    want = pipeline.analyze_library([a], device="cpu", handle_sigint=False).features[0]
    got = np.asarray(r["features"][a], np.float32)
    assert got[0] == want[0]
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert request({"op": "shutdown"}, sock, timeout=30)["ok"]
    t.join(timeout=30)
    assert not t.is_alive() and out == [0]


def test_cli_serve_runs_the_daemon(tmp_path):
    """``serve --socket --store`` on the CPU: warmup, bind, answer, and a
    shutdown op ends the command with status 0 and the store flushed."""
    from bliss_tpu_torch import cli

    sock, store = str(tmp_path / "s.sock"), str(tmp_path / "store")
    out = []
    t = threading.Thread(target=lambda: out.append(cli.main(
        ["--device", "cpu", "serve", "--socket", sock, "--store", store, "--batch-size", "4"])),
        daemon=True)
    t.start()
    deadline = time.time() + 60
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    a = _write_wav(tmp_path / "a.wav")
    r = request({"op": "analyze", "paths": [a]}, sock, timeout=120)
    assert r["ok"] and a in r["features"]
    st = request({"op": "status"}, sock, timeout=30)
    assert st["backend"] == "cpu" and st["store"]["entries"] == 1
    assert request({"op": "shutdown"}, sock, timeout=30)["ok"]
    t.join(timeout=30)
    assert not t.is_alive() and out == [0]
    assert len(FeatureStore(store)) == 1


def test_cli_call_roundtrip(served, capsys):
    from bliss_tpu_torch.cli import main

    server, sock, _, _ = served
    rc = main(["call", "--socket", sock, '{"op": "ping"}'])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out == {"ok": True, "pong": True}
    # error responses exit nonzero
    rc = main(["call", "--socket", sock, '{"op": "nope"}'])
    assert rc == 1
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main(["call", "--socket", sock, "{not json"])
    with pytest.raises(SystemExit):
        main(["call", '{"op": "ping"}'])  # no transport


def test_cli_doctor(tmp_path, capsys, monkeypatch):
    """Every check passes on --device cpu (this host has libav); without a
    GPU the CUDA checks fail with resolve_device's error and the command
    exits 1."""
    from bliss_tpu_torch.cli import main

    store = FeatureStore(str(tmp_path / "store"))
    store.put("k", np.zeros(4, np.float32), {"filename": "x.flac"})
    store.flush()
    assert main(["--device", "cpu", "doctor", "--store", str(tmp_path / "store")]) == 0
    out = capsys.readouterr().out
    for check in ("native decoder build", "decode round-trip", "backend acquisition",
                  "device dispatch", "feature store: 1 entry"):
        assert f"  ok {check}" in out, out
    assert "backend acquisition: cpu (1 device(s))" in out and "all checks passed" in out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["doctor", "--timeout", "30"]) == 1
    out = capsys.readouterr().out
    assert "FAIL backend acquisition: RuntimeError: no CUDA device" in out
    assert "FAIL device dispatch: RuntimeError: no CUDA device" in out
    assert "  ok decode round-trip" in out and "2 check(s) FAILED" in out


def test_cli_doctor_bounds_a_hung_device(capsys, monkeypatch):
    """A device probe that blocks fails its check after --timeout instead
    of hanging the doctor."""
    from bliss_tpu_torch import cli

    release = threading.Event()
    monkeypatch.setattr(cli, "resolve_device", lambda d: release.wait(30) or torch.device("cpu"))
    try:
        assert cli.main(["--device", "cpu", "doctor", "--timeout", "0.2"]) == 1
    finally:
        release.set()
    out = capsys.readouterr().out
    assert "FAIL backend acquisition: TimeoutError: still blocked after" in out
    assert "FAIL device dispatch: TimeoutError" in out


def test_concurrent_clients(served):
    """Clients issuing requests at once all get correct replies (analysis
    is serialized internally; the protocol is per-connection)."""
    server, sock, _, tmp = served
    a = _write_wav(tmp / "a.wav")
    results = {}

    def client(name):
        results[name] = request(
            {"op": "analyze", "paths": [a], "id": name}, sock, timeout=120)

    ts = [threading.Thread(target=client, args=(f"c{i}",)) for i in range(3)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert len(results) == 3
    vals = [tuple(r["features"][a]) for r in results.values()]
    assert all(r["ok"] for r in results.values())
    assert len(set(vals)) == 1


def test_playlist_length_zero_and_negative(served):
    server, sock, _, tmp = served
    a = _write_wav(tmp / "a.wav", freq=300.0)
    b = _write_wav(tmp / "b.wav", freq=900.0)
    r = request({"op": "playlist", "seed": a, "paths": [b], "length": 0}, sock, timeout=120)
    assert r["ok"] and r["paths"] == []
    r = request({"op": "playlist", "seed": a, "paths": [b], "length": 1}, sock, timeout=120)
    assert r["ok"] and r["paths"] == [a]
    r = request({"op": "playlist", "seed": a, "paths": [b], "length": -1}, sock, timeout=120)
    assert not r["ok"] and "non-negative" in r["error"]


def test_neighbors_rejects_bad_top_k(served):
    server, sock, _, _ = served
    r = request({"op": "neighbors", "top_k": 0}, sock, timeout=30)
    assert not r["ok"] and "top_k must be >= 1" in r["error"]


def test_bind_refuses_live_socket_and_spares_replacement(tmp_path):
    """Starting a second daemon on a live socket must fail instead of
    silently cutting the first one off; and a stopping server must not
    unlink a socket file it no longer owns."""
    sock = str(tmp_path / "bliss.sock")
    a = AnalysisServer(sock, device="cpu")
    t = _serve(a)

    b = AnalysisServer(sock, device="cpu")
    with pytest.raises(RuntimeError, match="already listening"):
        b.bind()
    # the probe must not have broken A
    assert request({"op": "ping"}, sock, timeout=30)["ok"]

    # simulate a takeover: replace A's socket file with someone else's
    os.unlink(sock)
    other = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    other.bind(sock)
    try:
        _stop(a, t)
        # A must NOT have unlinked the replacement socket
        assert os.path.exists(sock)
    finally:
        other.close()
        os.unlink(sock)


def test_scan_survives_client_that_stops_reading(served):
    """A progress-streaming client that disconnects mid-scan must not wedge
    the daemon (emits run under the analysis lock)."""
    server, sock, store, tmp = served
    lib = tmp / "lib"
    lib.mkdir()
    for i in range(3):
        _write_wav(lib / f"s{i}.wav", freq=300.0 + 100 * i)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock)
    s.sendall(json.dumps(
        {"op": "scan", "dir": str(lib), "progress": True}
    ).encode() + b"\n")
    s.close()  # walk away before any progress/response line
    # the daemon must finish the scan and stay responsive
    deadline = time.time() + 120
    while len(store) < 3 and time.time() < deadline:
        time.sleep(0.1)
    assert len(store) == 3
    assert request({"op": "ping"}, sock, timeout=30)["ok"]


def test_ephemeral_port_resolves_before_serving(tmp_path):
    """bind() must resolve port=0 to the real port so `serve` can announce
    a usable address (cli prints it before serve_forever)."""
    server = AnalysisServer(port=0, device="cpu")
    server.bind()
    assert server.port != 0
    t = _serve(server)
    try:
        assert request({"op": "ping"}, port=server.port, timeout=30)["ok"]
    finally:
        _stop(server, t)


def test_protocol_fuzz_malformed_requests(served):
    """The daemon must answer (or cleanly drop) anything a confused client
    throws at it, and stay alive throughout."""
    server, sock, _, _ = served
    evil = [
        b"not json at all\n",
        b"[1, 2, 3]\n",                      # JSON but not an object
        b'"just a string"\n',
        b"{}\n",                              # no op
        b'{"op": "no_such_op"}\n',
        b'{"op": null}\n',
        b'{"op": "analyze"}\n',               # missing paths
        b'{"op": "analyze", "paths": []}\n',
        b'{"op": "analyze", "paths": [42]}\n',
        b'{"op": "scan", "dir": "/nonexistent/dir"}\n',
        b'{"op": "distance", "a": [1,2], "b": [1,2,3,4]}\n',
        b'{"op": "playlist"}\n',
        b'\xff\xfe garbage bytes\n',
        b'{"op": "ping", "id": {"nested": ["weird", null]}}\n',
    ]
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock)
    s.settimeout(60)
    with s:
        buf = b""
        for line in evil:
            s.sendall(line)
            while b"\n" not in buf:
                buf += s.recv(1 << 16)
            resp_line, buf = buf.split(b"\n", 1)
            resp = json.loads(resp_line)
            if b'"ping"' in line:
                assert resp["ok"]
            else:
                assert not resp["ok"] and resp["error"]
    # a single oversized line is rejected and the connection dropped,
    # but the server survives
    s2 = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s2.connect(sock)
    s2.settimeout(120)
    with s2:
        big = b'{"op": "ping", "pad": "' + b"x" * (33 << 20) + b'"}\n'
        try:
            s2.sendall(big)
            resp = json.loads(s2.recv(1 << 16).split(b"\n")[0])
            assert not resp["ok"] and "too large" in resp["error"]
        except (BrokenPipeError, ConnectionResetError):
            pass  # server may drop mid-send; that's a clean rejection too
    assert request({"op": "ping"}, sock, timeout=30)["ok"]


def test_request_reads_events_and_a_large_response(tmp_path):
    """``request`` passes event lines to ``on_event`` and returns the first
    object with ``ok``, however the bytes are split, for a response of a
    few MB."""
    sock = str(tmp_path / "fake.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock)
    listener.listen(1)
    big = {"ok": True, "neighbors": {f"song{i:05d}": [i] * 8 for i in range(60_000)}}
    payload = (json.dumps({"event": "progress", "done": 1}) + "\n"
               + json.dumps({"event": "progress", "done": 2}) + "\n"
               + json.dumps(big) + "\n").encode()

    def answer():
        conn, _ = listener.accept()
        with conn:
            conn.recv(1 << 16)
            for k in range(0, len(payload), 7919):  # odd-sized writes
                conn.sendall(payload[k:k + 7919])

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    events = []
    try:
        assert request({"op": "neighbors"}, sock, timeout=60, on_event=events.append) == big
    finally:
        t.join(timeout=30)
        listener.close()
    assert events == [{"event": "progress", "done": 1}, {"event": "progress", "done": 2}]


def test_concurrent_mixed_clients(served):
    """Many clients issuing mixed ops at once: every request gets a
    correct, request-matched answer (the lock serializes device work but
    must not cross wires between connections)."""
    server, sock, store, tmp = served
    a = _write_wav(tmp / "a.wav", freq=350.0)
    b = _write_wav(tmp / "b.wav", freq=3000.0, beat_hz=5.0)
    # prime the store so neighbors has rows and analyze hits the cache
    assert request({"op": "analyze", "paths": [a, b]}, sock, timeout=120)["ok"]

    results, errors = {}, []

    def client(i):
        try:
            ops = [
                {"op": "ping", "id": i},
                {"op": "status"},
                {"op": "analyze", "paths": [a, b]},
                {"op": "distance", "a": a, "b": b},
                {"op": "neighbors", "top_k": 1},
                {"op": "playlist", "seed": a, "paths": [b]},
            ]
            r = request(ops[i % len(ops)], sock, timeout=300)
            results[i] = r
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(18)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors
    assert len(results) == 18
    for i, r in results.items():
        assert r["ok"], (i, r)
        kind = i % 6
        if kind == 0:
            assert r["pong"] and r["id"] == i
        elif kind == 2:
            assert set(r["features"]) == {a, b}
        elif kind == 3:
            assert r["distance"] > 0
        elif kind == 4:
            assert r["neighbors"][a][0]["path"] == b
        elif kind == 5:
            assert r["paths"][0] == a


def test_daemon_with_mesh_refuses_until_m10(served, tmp_path):
    """Formerly the M10 refusal; now ``tests/test_server.py``'s
    ``test_daemon_with_mesh_matches_unsharded``: a daemon built with an
    ``analysis_mesh(4, 2)`` of the CPU warms up through the mesh and serves
    the plain daemon's features (beats identical, the rest within 5e-4:
    its shards of 32 768 samples take the mesh's XLA branch where the plain
    daemon takes K1)."""
    from bliss_tpu_torch.parallel import analysis_mesh

    _, sock, _, _ = served
    a = _write_wav(tmp_path / "a.wav", freq=500.0)
    plain = request({"op": "analyze", "paths": [a]}, sock, timeout=60)
    assert plain["ok"]
    msock = str(tmp_path / "mesh.sock")
    meshed = AnalysisServer(msock, store=None, batch_size=8,
                            mesh=analysis_mesh(4, 2, devices=["cpu"] * 8), device="cpu")
    meshed.warmup()
    t = _serve(meshed)
    try:
        r = request({"op": "analyze", "paths": [a]}, msock, timeout=120)
        assert r["ok"] and r["errors"] == {}
        assert r["features"][a][0] == plain["features"][a][0]
        np.testing.assert_allclose(r["features"][a], plain["features"][a], atol=5e-4)
        assert request({"op": "status"}, msock, timeout=30)["backend_health"]["healthy"]
    finally:
        _stop(meshed, t)


# --- backend loss / degraded mode --------------------------------------------

# what PyTorch raises once a CUDA context is poisoned, and the port's own
# refused-launch error (kernels/_build.launch)
CUDA_LOSS = [
    lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered\nCUDA kernel errors "
        "might be asynchronously reported at some other API call"),
    lambda: RuntimeError("CUDA error: unspecified launch failure"),
    lambda: RuntimeError("CUDA driver error: device not ready"),
    lambda: RuntimeError("No CUDA GPUs are available"),
    lambda: RuntimeError("CUDA error: no CUDA-capable device is detected"),
    lambda: RuntimeError("bliss_fused_all launch failed: an illegal memory access "
                         "was encountered (700)"),
]


def _boom(exc):
    def boom(*a, **k):
        raise exc()
    return boom


def test_backend_loss_degrades_and_recovers(served, monkeypatch):
    """A mid-request device loss fails THAT request cleanly, flips the
    daemon to degraded in /status, and the next device-touching request
    that succeeds recovers it — the daemon never dies."""
    server, sock, store, tmp = served
    a = _write_wav(tmp / "a.wav", freq=440.0)
    real = pipeline.analyze_library

    # healthy to start
    st = request({"op": "status"}, sock, timeout=30)
    assert st["backend_health"]["healthy"]
    assert st["backend_health"]["recoveries"] == 0

    # two failing requests: both fail cleanly, daemon stays up, degraded
    monkeypatch.setattr(pipeline, "analyze_library", _boom(CUDA_LOSS[0]))
    for _ in range(2):
        r = request({"op": "analyze", "paths": [a]}, sock, timeout=30)
        assert not r["ok"] and "illegal memory access" in r["error"]
    st = request({"op": "status"}, sock, timeout=30)
    assert not st["backend_health"]["healthy"]
    assert st["backend_health"]["consecutive_failures"] == 2
    assert st["backend_health"]["last_error"].startswith(
        "AcceleratorError: CUDA error: an illegal memory access")
    assert st["backend_health"]["last_failure_unix"] is not None

    # the context is good again: next device request succeeds and recovers
    monkeypatch.setattr(pipeline, "analyze_library", real)
    r = request({"op": "analyze", "paths": [a]}, sock, timeout=120)
    assert r["ok"] and a in r["features"]
    st = request({"op": "status"}, sock, timeout=30)
    assert st["backend_health"]["healthy"]
    assert st["backend_health"]["consecutive_failures"] == 0
    assert st["backend_health"]["recoveries"] == 1


def test_non_backend_errors_do_not_degrade(served, monkeypatch):
    """Ordinary request failures (bad input, decode errors) and running out
    of device memory must not be misclassified as backend loss."""
    server, sock, _, tmp = served
    a = _write_wav(tmp / "a.wav")

    for exc in (ValueError("malformed frames"),
                torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 GiB"),
                RuntimeError("CUDA error: out of memory")):
        monkeypatch.setattr(pipeline, "analyze_library", _boom(lambda exc=exc: exc))
        r = request({"op": "analyze", "paths": [a]}, sock, timeout=30)
        assert not r["ok"] and str(exc) in r["error"]
        st = request({"op": "status"}, sock, timeout=30)
        assert st["backend_health"]["healthy"]
        assert st["backend_health"]["consecutive_failures"] == 0


def test_health_probe_detects_loss_and_recovers_without_traffic(tmp_path):
    """With --health-probe, a silent backend loss flips the daemon to
    degraded within ~one interval, and recovery happens with NO client
    requests at all — the watchdog's own round trips do both."""
    sock = str(tmp_path / "probe.sock")
    server = AnalysisServer(sock, health_probe_interval=0.1, device="cpu")
    t = _serve(server)
    try:
        # break the probe: the watchdog must mark degraded on its own
        server._probe_op = _boom(CUDA_LOSS[1])
        deadline = time.time() + 30
        while time.time() < deadline:
            with server._health_lock:
                if not server._backend_health["healthy"]:
                    break
            time.sleep(0.05)
        st = request({"op": "status"}, sock, timeout=30)
        assert not st["backend_health"]["healthy"]
        assert st["backend_health"]["consecutive_failures"] >= 1
        assert "unspecified launch failure" in st["backend_health"]["last_error"]

        # heal the probe: the watchdog must recover, still with no traffic
        del server._probe_op  # restore the class method
        deadline = time.time() + 30
        while time.time() < deadline:
            with server._health_lock:
                if server._backend_health["healthy"]:
                    break
            time.sleep(0.05)
        st = request({"op": "status"}, sock, timeout=30)
        assert st["backend_health"]["healthy"]
        assert st["backend_health"]["recoveries"] == 1
    finally:
        _stop(server, t)


def test_cli_serve_health_probe_flag(tmp_path):
    from bliss_tpu_torch.cli import build_parser

    args = build_parser().parse_args(
        ["serve", "--socket", str(tmp_path / "s"), "--health-probe", "45"]
    )
    assert args.health_probe == 45.0
    args = build_parser().parse_args(["serve", "--socket", "s"])
    assert args.health_probe == 0.0


@pytest.mark.parametrize("make", CUDA_LOSS, ids=[
    "illegal_memory_access", "launch_failure", "driver", "no_gpus", "no_device", "port_launch"])
def test_is_backend_error_taxonomy(make):
    assert _is_backend_error(make())


def test_is_not_backend_error():
    assert not _is_backend_error(ValueError("paths must be strings"))
    assert not _is_backend_error(RuntimeError("decode failed: bad header"))
    assert not _is_backend_error(torch.OutOfMemoryError("CUDA out of memory."))
    assert not _is_backend_error(RuntimeError("CUDA error: out of memory"))
    assert not _is_backend_error(NotImplementedError("analysis over a mesh is ROADMAP item M10"))


def test_poisoned_context_stays_degraded_until_a_call_succeeds(served, monkeypatch):
    """A sticky CUDA error has no in-process reset: while every device call
    fails (requests and probes alike) the daemon stays degraded and runs
    nothing elsewhere; the first call that succeeds marks one recovery."""
    server, sock, _, tmp = served
    a = _write_wav(tmp / "a.wav")
    real = pipeline.analyze_library
    devices = []

    def poisoned(*args, **kw):
        devices.append(kw["device"])
        raise CUDA_LOSS[0]()

    monkeypatch.setattr(pipeline, "analyze_library", poisoned)
    monkeypatch.setattr(server, "_probe_op", _boom(CUDA_LOSS[0]))
    for _ in range(3):
        assert not request({"op": "analyze", "paths": [a]}, sock, timeout=30)["ok"]
        with pytest.raises(torch.AcceleratorError):
            server._device_call(server._probe_op)
    st = request({"op": "status"}, sock, timeout=30)
    assert not st["backend_health"]["healthy"]
    assert st["backend_health"]["consecutive_failures"] == 6
    assert st["backend_health"]["recoveries"] == 0
    assert devices == [server.device] * 3  # no retry on another device
    monkeypatch.setattr(pipeline, "analyze_library", real)
    assert request({"op": "analyze", "paths": [a]}, sock, timeout=120)["ok"]
    st = request({"op": "status"}, sock, timeout=30)
    assert st["backend_health"]["healthy"] and st["backend_health"]["recoveries"] == 1


# --- the port's daemon against bliss_tpu's, on the same files ----------------

# interleaved samples; bliss_tpu's fused path needs L >= 65536, and all four
# land in its 98304 bucket, one batch, one compiled shape
DIFF_LENGTHS = [70_000, 76_000, 84_000, 90_000]


def _write_pcm_wav(path, pcm):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def both_daemons(tmp_path_factory):
    """bliss_tpu's daemon (for_tpu(), Pallas in interpret mode on the CPU)
    and the port's (for_gpu(), the kernels' plain versions) over the same
    WAV files, each with its own store: their analyze and neighbors
    responses."""
    from bliss_tpu.config import AnalysisConfig as JConfig
    from bliss_tpu.server import AnalysisServer as JServer
    from bliss_tpu.server import request as jrequest
    from bliss_tpu.store import FeatureStore as JStore

    root = tmp_path_factory.mktemp("torch_server_diff")
    files = []
    for i, n in enumerate(DIFF_LENGTHS):
        rng = np.random.RandomState(90 + i)
        pcm = synth_pcm(rng, n, amp=int(rng.randint(3000, 14000)))
        files.append(_write_pcm_wav(root / f"song{i}.wav", pcm))
    out = {}
    for name, make, call in (
        ("jax", lambda s: JServer(s, cfg=JConfig.for_tpu(), batch_size=4,
                                  store=JStore(str(root / "jax_store"))), jrequest),
        ("port", lambda s: AnalysisServer(s, batch_size=4, device="cpu",
                                          store=FeatureStore(str(root / "port_store"))), request),
    ):
        sock = str(root / f"{name}.sock")
        server = make(sock)
        t = _serve(server)
        try:
            out[name] = {
                "analyze": call({"op": "analyze", "paths": files}, sock, timeout=600),
                "neighbors": call({"op": "neighbors", "top_k": 3}, sock, timeout=120),
            }
        finally:
            _stop(server, t)
    return files, out


def test_analyze_matches_bliss_tpu_daemon(both_daemons):
    files, out = both_daemons
    j, p = out["jax"]["analyze"], out["port"]["analyze"]
    assert set(p) == set(j) == {"ok", "features", "errors"}
    assert p["ok"] and j["ok"] and p["errors"] == j["errors"] == {}
    assert list(p["features"]) == list(j["features"]) == files
    pf = np.array([p["features"][f] for f in files])
    jf = np.array([j["features"][f] for f in files])
    np.testing.assert_array_equal(pf[:, 0], jf[:, 0])  # beats
    np.testing.assert_allclose(pf[:, 1:], jf[:, 1:], rtol=0, atol=5e-4)


def test_neighbors_match_bliss_tpu_daemon(both_daemons):
    """Same neighbour order wherever the port's distances leave a gap of
    more than 1e-2 (bliss_tpu forms d^2 in float32, ~1e-3 off here, on
    features 5e-4 apart); distances within 5e-3."""
    files, out = both_daemons
    j, p = out["jax"]["neighbors"], out["port"]["neighbors"]
    assert p["ok"] and j["ok"] and set(p["neighbors"]) == set(j["neighbors"]) == set(files)
    compared = 0
    for name, mine in p["neighbors"].items():
        theirs = j["neighbors"][name]
        d = [x["distance"] for x in mine]
        np.testing.assert_allclose(d, [x["distance"] for x in theirs], rtol=0, atol=5e-3)
        for k, x in enumerate(mine):
            gaps = [abs(d[k] - d[m]) for m in (k - 1, k + 1) if 0 <= m < len(d)]
            if min(gaps) > 1e-2:
                assert x["path"] == theirs[k]["path"], (name, k, mine, theirs)
                compared += 1
    assert compared >= len(files)
