"""Interface tests: CLI subprocess, MCP JSON-RPC protocol, HTTP server.

Mirrors the reference integration suites
(/root/reference/tests/integration/{cli,mcp}.test.cjs — spawn the CLI as a
subprocess, check MCP protocol compliance) and the server endpoints
(server/index.js).
"""
import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

import sublinear_tpu as slt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "sublinear_tpu.interfaces.cli"]


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_cli(args, timeout=300, input_text=None):
    return subprocess.run(
        CLI + args, capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=_env(), input=input_text,
    )


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    A = slt.generate("random-sparse", 40, seed=3, density=0.1)
    b = slt.rhs(40, seed=3)
    mpath, vpath = d / "A.json", d / "b.json"
    mpath.write_text(json.dumps(A.to_dict()))
    vpath.write_text(json.dumps(b.tolist()))
    return d, str(mpath), str(vpath), A, b


def test_cli_generate_and_analyze(tmp_path):
    out = tmp_path / "gen.json"
    r = run_cli(["generate", "-t", "tridiagonal", "-s", "16", "-o", str(out)])
    assert r.returncode == 0, r.stderr
    doc = json.loads(out.read_text())
    assert doc["rows"] == 16 and doc["format"] == "coo"

    r = run_cli(["analyze", "-m", str(out)])
    assert r.returncode == 0, r.stderr
    a = json.loads(r.stdout)
    assert a["isSymmetric"] is True
    assert a["isDiagonallyDominant"] is True


def test_cli_solve_and_verify(files, tmp_path):
    d, mpath, vpath, A, b = files
    sol = tmp_path / "x.json"
    r = run_cli(["solve", "-m", mpath, "-b", vpath, "--method", "conjugate-gradient",
                 "-o", str(sol)])
    assert r.returncode == 0, r.stderr
    doc = json.loads(sol.read_text())
    assert doc["converged"] is True
    x = np.asarray(doc["solution"])
    assert np.linalg.norm(A.csr.matvec(x) - b) / np.linalg.norm(b) < 1e-5

    r = run_cli(["verify", "-m", mpath, "-b", vpath, "-s", str(sol)])
    assert r.returncode == 0, r.stderr
    v = json.loads(r.stdout)
    assert v["verified"] is True


def test_cli_solve_non_dd_errors(files, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"rows": 2, "cols": 2, "data": [[1, 5], [5, 1]], "format": "dense"}))
    vec = tmp_path / "v2.json"
    vec.write_text("[1.0, 1.0]")
    r = run_cli(["solve", "-m", str(bad), "-b", str(vec), "--method", "neumann"])
    assert r.returncode == 2
    err = json.loads(r.stderr.strip().splitlines()[-1])
    assert err["code"] == "E001"


def test_cli_pagerank(files, tmp_path):
    d, mpath, vpath, A, b = files
    adj = tmp_path / "adj.json"
    n = 12
    rows = list(range(n)) + [0] * (n - 1)
    cols = [(i + 1) % n for i in range(n)] + list(range(1, n))
    adj.write_text(json.dumps({
        "rows": n, "cols": n, "values": [1.0] * len(rows),
        "rowIndices": rows, "colIndices": cols, "format": "coo",
    }))
    r = run_cli(["pagerank", "-a", str(adj)])
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    assert len(doc["pageRankVector"]) == n
    assert doc["converged"] is True


def test_mcp_protocol_end_to_end():
    """Spawn the MCP server, run initialize -> tools/list -> tools/call."""
    A = slt.generate("random-sparse", 16, seed=1, density=0.2)
    b = slt.rhs(16, seed=1)
    requests = [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "notifications/initialized"},
        {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
        {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
            "name": "solve",
            "arguments": {"matrix": A.to_dict(), "vector": b.tolist(),
                          "method": "conjugate-gradient"},
        }},
        {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {
            "name": "analyzeMatrix", "arguments": {"matrix": A.to_dict()},
        }},
        {"jsonrpc": "2.0", "id": 5, "method": "tools/call", "params": {
            "name": "calculateLightTravel", "arguments": {"distanceKm": 10900},
        }},
        {"jsonrpc": "2.0", "id": 6, "method": "tools/call", "params": {
            "name": "nonexistent", "arguments": {},
        }},
    ]
    proc = subprocess.run(
        [sys.executable, "-m", "sublinear_tpu.interfaces.mcp_server"],
        input="\n".join(json.dumps(r) for r in requests) + "\n",
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_env(),
    )
    lines = [json.loads(l) for l in proc.stdout.strip().splitlines()]
    by_id = {l["id"]: l for l in lines if "id" in l}
    assert by_id[1]["result"]["serverInfo"]["name"] == "sublinear-tpu-solver"
    tool_names = {t["name"] for t in by_id[2]["result"]["tools"]}
    # the reference's 8 tools must all be present (server.ts:54-233)
    assert {"solve", "estimateEntry", "analyzeMatrix", "pageRank",
            "predictWithTemporalAdvantage", "validateTemporalAdvantage",
            "calculateLightTravel", "demonstrateTemporalLead"} <= tool_names
    solve_out = json.loads(by_id[3]["result"]["content"][0]["text"])
    assert solve_out["converged"] is True
    analysis = json.loads(by_id[4]["result"]["content"][0]["text"])
    assert analysis["isDiagonallyDominant"] is True
    light = json.loads(by_id[5]["result"]["content"][0]["text"])
    assert light["feasible"] is True
    assert "error" in by_id[6]


@pytest.fixture(scope="module")
def http_server():
    from sublinear_tpu.interfaces.http_server import make_server

    server = make_server(port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_http_health(http_server):
    with urllib.request.urlopen(http_server + "/health", timeout=30) as resp:
        doc = json.loads(resp.read())
    assert doc["status"] == "healthy"
    assert doc["devices"] >= 1


def test_http_solve_and_verify(http_server):
    A = slt.generate("random-sparse", 24, seed=2, density=0.15)
    b = slt.rhs(24, seed=2)
    status, doc = _post(http_server + "/api/v1/solve",
                        {"matrix": A.to_dict(), "vector": b.tolist()})
    assert status == 200 and doc["converged"] is True
    status, v = _post(http_server + "/api/v1/verify",
                      {"matrix": A.to_dict(), "vector": b.tolist(), "solution": doc["solution"]})
    assert status == 200 and v["verified"] is True


def test_http_solve_stream_chunks(http_server):
    A = slt.generate("random-sparse", 32, seed=4, density=0.1)
    b = slt.rhs(32, seed=4)
    req = urllib.request.Request(
        http_server + "/api/v1/solve-stream",
        data=json.dumps({"matrix": A.to_dict(), "vector": b.tolist(),
                         "method": "conjugate-gradient", "epsilon": 1e-6}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        job_id = resp.headers.get("X-Job-Id")
        lines = [json.loads(l) for l in resp.read().decode().strip().splitlines()]
    assert job_id
    assert lines[-1]["done"] is True and lines[-1]["status"] == "completed"
    chunks = lines[:-1]
    assert len(chunks) >= 1
    assert chunks[-1]["converged"] is True
    # job endpoint knows about it afterwards
    with urllib.request.urlopen(http_server + f"/api/v1/jobs/{job_id}", timeout=30) as resp:
        job = json.loads(resp.read())
    assert job["status"] == "completed"


def test_http_unknown_route(http_server):
    try:
        urllib.request.urlopen(http_server + "/nope", timeout=30)
        assert False
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_streaming_solve_generator():
    from sublinear_tpu.solvers.streaming import streaming_solve

    A = slt.generate("random-sparse", 48, seed=6, density=0.1)
    b = slt.rhs(48, seed=6)
    chunks = list(streaming_solve(A, b, slt.SolverOptions(epsilon=1e-8), chunk_iters=5))
    assert chunks[-1].converged
    assert chunks[-1].solution is not None
    assert [c.iteration for c in chunks] == sorted(c.iteration for c in chunks)
    x = chunks[-1].solution
    assert np.linalg.norm(A.csr.matvec(x) - b) / np.linalg.norm(b) < 1e-6


def test_streaming_live_delta_and_verification():
    """Live update_rhs semantics (neumann.rs:436-462 online form): a delta
    queued into the session's StreamControl mutates b BETWEEN chunks, the
    iterate carries over, and the stream converges to the NEW fixed point.
    In-stream probe verification events ride the chunks (streaming.js:323-420)."""
    from sublinear_tpu.solvers.streaming import StreamControl, streaming_solve

    A = slt.generate("random-sparse", 64, seed=9, density=0.1)
    b = slt.rhs(64, seed=9)
    ctrl = StreamControl()
    it = streaming_solve(A, b, slt.SolverOptions(epsilon=1e-8, seed=3),
                         chunk_iters=2, control=ctrl,
                         verify_every=1, verify_probes=12,
                         verify_tolerance=1e-5)
    first = next(it)
    assert first.rhs_version == 0
    assert first.verification is not None  # probes from chunk 1
    # mutate b mid-solve: the session must keep running, not restart
    delta_idx, delta_val = np.array([0, 5, 7]), np.array([2.0, -1.5, 0.25])
    ctrl.push_delta(delta_idx, delta_val)
    chunks = [first] + list(it)
    last = chunks[-1]
    assert last.converged
    assert last.rhs_version == 1
    # residual responded to the mutation: some post-delta chunk jumped above
    # the pre-delta trajectory before re-converging
    b_new = b.copy()
    b_new[delta_idx] += delta_val
    x = last.solution
    assert np.linalg.norm(A.csr.matvec(x) - b_new) / np.linalg.norm(b_new) < 1e-6
    # the old fixed point is NOT the answer any more
    assert np.linalg.norm(A.csr.matvec(x) - b) / np.linalg.norm(b) > 1e-3
    # the final verification event checked against the UPDATED b and passed
    assert last.verification is not None and last.verification["verified"]
    # iteration counter is cumulative across the delta (no restart)
    post = [c for c in chunks if c.rhs_version == 1]
    assert post and post[0].iteration > first.iteration


def test_websocket_update_rhs_live(http_server):
    """WS e2e: subscribe to a solve, push update_rhs mid-stream, watch the
    residual respond and the stream re-converge to the new RHS with passing
    in-stream verification events."""
    sock, ws = _ws_connect(http_server)
    try:
        assert _ws_recv(ws)["type"] == "welcome"
        n = 96
        A = slt.generate("random-sparse", n, seed=4, density=0.08)
        b = slt.rhs(n, seed=4)
        _ws_send(ws, {"type": "solve", "matrix": A.to_dict(),
                      "vector": b.tolist(), "method": "conjugate-gradient",
                      "epsilon": 1e-8, "chunkIterations": 1,
                      "verifyEvery": 2, "verifyTolerance": 1e-5})
        started = _ws_recv(ws)
        assert started["type"] == "solve_started"
        sid = started["session_id"]
        delta = {"indices": [1, 2], "values": [3.0, -2.0]}
        sent_update = False
        updates, acked = [], False
        while True:
            doc = _ws_recv(ws)
            if doc["type"] == "rhs_updated":
                acked = True
                assert doc["count"] == 2
                continue
            if doc["type"] == "session_complete":
                break
            assert doc["type"] == "session_update"
            updates.append(doc)
            if not sent_update and len(updates) == 2:
                _ws_send(ws, {"type": "update_rhs", "session_id": sid,
                              "delta": delta})
                sent_update = True
        assert acked
        last = updates[-1]
        assert last["converged"] is True
        assert last.get("rhsVersion") == 1
        # in-stream verification events were emitted and the final one passed
        vevents = [u["verification"] for u in updates if "verification" in u]
        assert vevents and vevents[-1]["verified"] is True
        b_new = b.copy()
        b_new[[1, 2]] += [3.0, -2.0]
        x = np.asarray(last["solution"])
        assert np.linalg.norm(A.csr.matvec(x) - b_new) / np.linalg.norm(b_new) < 1e-5
    finally:
        sock.close()


def test_http_swarm_endpoints(http_server):
    status, j = _post(http_server + "/api/v1/swarm/join", {"capabilities": {"methods": ["all"]}})
    assert status == 200 and "workerId" in j
    wid = j["workerId"]
    status, c = _post(http_server + "/api/v1/swarm/costs", {"workerId": wid, "cost": 2.5})
    assert status == 200 and c["workers"] >= 1
    status, h = _post(http_server + "/api/v1/swarm/heartbeat", {"workerId": wid})
    assert status == 200 and h["ok"]
    A = slt.generate("random-sparse", 16, seed=8, density=0.2)
    b = slt.rhs(16, seed=8)
    status, s = _post(http_server + "/api/v1/swarm/solve",
                      {"matrix": A.to_dict(), "vector": b.tolist()})
    assert status == 200 and s["converged"] is True
    with urllib.request.urlopen(http_server + "/api/v1/swarm/status", timeout=30) as resp:
        st = json.loads(resp.read())
    assert st["workers"] >= 1


def test_cli_help_examples():
    r = run_cli(["help-examples"])
    assert r.returncode == 0
    assert "generate" in r.stdout and "serve-mcp" in r.stdout


def test_trainer_save_load(tmp_path):
    import numpy as np

    from sublinear_tpu.models import SystemA, Trainer, make_windows

    series = np.sin(np.arange(120, dtype=np.float32) / 5.0)
    w, t = make_windows(series, window=8, horizon=1)
    tr = Trainer(SystemA(hidden=4, horizon=1), window=8, seed=0)
    tr.fit(w[:64], t[:64], epochs=1, batch_size=32)
    pred_before = tr.predict(w[0])
    p = str(tmp_path / "model.msgpack")
    tr.save(p)
    tr2 = Trainer(SystemA(hidden=4, horizon=1), window=8, seed=99)
    tr2.load(p)
    np.testing.assert_allclose(tr2.predict(w[0]), pred_before, rtol=1e-6)


def _ws_connect(http_server):
    import socket
    from urllib.parse import urlparse

    from sublinear_tpu.interfaces.websocket import WebSocketConnection

    u = urlparse(http_server)
    sock = socket.create_connection((u.hostname, u.port), timeout=60)
    sock.sendall(
        (f"GET /ws HTTP/1.1\r\nHost: {u.hostname}:{u.port}\r\n"
         "Upgrade: websocket\r\nConnection: Upgrade\r\n"
         "Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
         "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    f = sock.makefile("rwb")
    status = f.readline()
    assert b"101" in status, status
    while f.readline().strip():
        pass  # drain handshake headers
    return sock, WebSocketConnection(f, f)


def _ws_send(ws, obj):
    from sublinear_tpu.interfaces.websocket import client_frame

    with ws.send_lock:
        ws.wfile.write(client_frame(json.dumps(obj).encode()))
        ws.wfile.flush()


def _ws_recv(ws):
    msg = ws.read_message()
    assert msg is not None
    return json.loads(msg[1].decode())


def test_websocket_protocol(http_server):
    """welcome / ping-pong / solve -> solve_started + session_update stream
    (reference server/index.js:449-596)."""
    sock, ws = _ws_connect(http_server)
    try:
        assert _ws_recv(ws)["type"] == "welcome"
        _ws_send(ws, {"type": "ping"})
        assert _ws_recv(ws)["type"] == "pong"
        _ws_send(ws, {"type": "bogus"})
        assert "Unknown message type" in _ws_recv(ws)["error"]

        A = slt.generate("random-sparse", 24, seed=3, density=0.15)
        b = slt.rhs(24, seed=3)
        _ws_send(ws, {"type": "solve", "matrix": A.to_dict(), "vector": b.tolist(),
                      "method": "conjugate-gradient"})
        started = _ws_recv(ws)
        assert started["type"] == "solve_started" and started["session_id"]
        updates = []
        while True:
            doc = _ws_recv(ws)
            if doc["type"] == "session_complete":
                assert doc["status"] == "completed"
                break
            assert doc["type"] == "session_update"
            updates.append(doc)
        assert updates and updates[-1]["converged"] is True
    finally:
        sock.close()


def test_cli_predict_temporal(tmp_path):
    """temporal-cli `predict` parity (cli.rs:126-170)."""
    proc = run_cli(["predict", "-s", "64", "-d", "10900"])
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["converged"] is True
    assert doc["lightTravelTimeMs"] > 30  # 10,900 km is ~36.4 ms of light time
    assert doc["causality"]["valid"] is True
    assert "solution" not in doc  # --full not passed


def test_load_matrix_routes_gml(tmp_path):
    from sublinear_tpu.formats.io import load_matrix

    p = tmp_path / "g.gml"
    p.write_text(
        "graph [\n directed 1\n node [ id 0 ]\n node [ id 1 ]\n"
        " edge [ source 0 target 1 value 2.5 ]\n]\n")
    A = load_matrix(str(p))
    assert A.shape == (2, 2)
    assert A.csr.to_dense()[0, 1] == 2.5


def test_websocket_late_subscribe_replays(http_server):
    """A subscriber attaching after the solve completed must receive the full
    chunk history and session_complete instead of hanging (round-1 advisor
    finding: single-consumer queue starved late subscribers; the reference
    errors instead, server/session-manager.js getJobStream)."""
    sock, ws = _ws_connect(http_server)
    try:
        assert _ws_recv(ws)["type"] == "welcome"
        A = slt.generate("random-sparse", 24, seed=4, density=0.15)
        b = slt.rhs(24, seed=4)
        _ws_send(ws, {"type": "solve", "matrix": A.to_dict(), "vector": b.tolist(),
                      "method": "conjugate-gradient"})
        started = _ws_recv(ws)
        assert started["type"] == "solve_started"
        sid = started["session_id"]
        n_updates = 0
        while True:
            doc = _ws_recv(ws)
            if doc["type"] == "session_complete":
                break
            n_updates += 1
        # job is now finished: subscribe from a second connection
        sock2, ws2 = _ws_connect(http_server)
        try:
            assert _ws_recv(ws2)["type"] == "welcome"
            _ws_send(ws2, {"type": "subscribe", "session_id": sid})
            replayed = 0
            while True:
                doc = _ws_recv(ws2)
                if doc["type"] == "session_complete":
                    assert doc["status"] == "completed"
                    break
                assert doc["type"] == "session_update"
                replayed += 1
            assert replayed == n_updates
        finally:
            sock2.close()
        # unknown session still errors like the reference
        _ws_send(ws, {"type": "subscribe", "session_id": "nope"})
        assert "not found" in _ws_recv(ws)["error"].lower()
    finally:
        sock.close()


def test_http_middleware_parity(http_server):
    """CORS headers, OPTIONS preflight, body-size cap (413) and rate
    limiting (429) — reference server/index.js:40-84 middleware stack."""
    import urllib.request
    import urllib.error

    # CORS on normal responses
    with urllib.request.urlopen(f"{http_server}/health", timeout=30) as r:
        assert r.headers.get("Access-Control-Allow-Origin") == "*"
    # OPTIONS preflight
    req = urllib.request.Request(f"{http_server}/api/v1/solve", method="OPTIONS")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 204
        assert "POST" in r.headers.get("Access-Control-Allow-Methods", "")
    # oversized body -> 413 (declared length over the cap)
    from sublinear_tpu.interfaces import http_server as hs
    req = urllib.request.Request(
        f"{http_server}/api/v1/solve", data=b"x",
        headers={"Content-Length": str(hs.MAX_BODY_BYTES + 1),
                 "Content-Type": "application/json"},
        method="POST")
    try:
        urllib.request.urlopen(req, timeout=30)
        assert False, "expected 413"
    except urllib.error.HTTPError as e:
        assert e.code == 413
    # rate limit: shrink the budget and hammer
    old = hs.RATE_LIMITER.limit
    hs.RATE_LIMITER.limit = 3
    hs.RATE_LIMITER._hits.clear()
    try:
        codes = []
        for _ in range(5):
            try:
                with urllib.request.urlopen(f"{http_server}/api/v1/swarm/status", timeout=30) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        assert 429 in codes
    finally:
        hs.RATE_LIMITER.limit = old
        hs.RATE_LIMITER._hits.clear()


def test_cli_train_and_latency(tmp_path):
    """Config-driven training + per-tick latency harness through the CLI
    (reference bin/train.rs + lib.rs latency budget)."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({
        "common": {"window_ms": 8, "sample_rate_hz": 1000, "features": ["x"],
                   "quantize": False},
        "model": {"hidden_size": 8},
        "training": {"epochs": 2, "batch_size": 32, "patience": 0},
        "inference": {"target_latency_ms": 1000.0},
    }))
    out = tmp_path / "params.msgpack"
    r = run_cli(["train", "--config", str(cfg), "--out", str(out)])
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["epochs_run"] == 2 and out.exists()

    r = run_cli(["nn-latency", "--config", str(cfg), "--ticks", "20",
                 "--warmup", "2"])
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["ticks"] == 20 and "tick" in rep and rep["meets_targets"] is True
