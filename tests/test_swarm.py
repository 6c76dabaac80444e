"""Swarm control plane: WS channel, heartbeat/reconnect, cost propagation,
verification, and the Flow-Nexus MCP tools.

Reference behaviors: /root/reference/integrations/flow-nexus.js —
connectToSwarm/WS protocol :127-185, cost-update queue + aggregation
:188-335, exponential-backoff reconnect :385-405, MCP tools :500-619.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import sublinear_tpu as slt


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture()
def swarm_server():
    from sublinear_tpu.interfaces.http_server import SWARM, make_server

    server = make_server(port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"127.0.0.1:{server.server_address[1]}", SWARM
    server.shutdown()


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(predicate, timeout=30.0, step=0.1):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if predicate():
            return True
        time.sleep(step)
    return False


def test_two_process_swarm_e2e(swarm_server):
    """A REAL second process connects over localhost WS, registers, solves a
    demo session, announces a cost update, and answers a random-probe
    verification request routed by the coordinator."""
    addr, swarm = swarm_server
    proc = subprocess.Popen(
        [sys.executable, "-m", "sublinear_tpu.interfaces.swarm",
         "--connect", f"ws://{addr}/ws/swarm", "--id", "worker-e2e",
         "--heartbeat", "0.5", "--demo-session"],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        # worker registered + demo cost update landed in the coordinator
        assert _wait(lambda: "worker-e2e" in swarm.workers, timeout=60), \
            "worker process never registered"
        assert _wait(lambda: "worker-e2e" in swarm.connections, timeout=30)
        assert _wait(lambda: any(h.get("workerId") == "worker-e2e"
                                 for h in swarm.cost_history), timeout=60), \
            "demo cost update never propagated"

        # coordinator -> worker verification request over the WS channel
        status, resp = _post(f"http://{addr}/api/v1/swarm/verify",
                             {"nodeId": "worker-e2e", "sessionId": "demo",
                              "probeCount": 8, "timeout": 30,
                              "tolerance": 1e-4})  # f32 device solution
        assert status == 200, resp
        assert resp["verified"] is True and resp["node_id"] == "worker-e2e"
        assert resp["max_error"] < 1e-3  # f32 solve: ~1e-5 true residual

        # unknown session fails verification honestly
        status, resp = _post(f"http://{addr}/api/v1/swarm/verify",
                             {"nodeId": "worker-e2e", "sessionId": "nope"})
        assert status == 200 and resp["verified"] is False

        # heartbeats keep the worker alive in the status aggregate
        with urllib.request.urlopen(f"http://{addr}/api/v1/swarm/status",
                                    timeout=10) as r:
            agg = json.loads(r.read())
        assert agg["workers"] >= 1
    finally:
        proc.terminate()  # exact PID of the process we spawned
        proc.wait(timeout=10)


def test_ws_reconnect_with_backoff(swarm_server):
    """Server-side drop triggers the node's exponential-backoff reconnect;
    on success the attempt counter resets (flow-nexus.js:385-405)."""
    from sublinear_tpu.interfaces.swarm import SwarmNode

    addr, swarm = swarm_server
    node = SwarmNode(f"ws://{addr}/ws/swarm", node_id="reconnector",
                     heartbeat_interval=0.3, reconnect_base=0.05)
    node.connect()
    try:
        assert _wait(lambda: "reconnector" in swarm.connections, timeout=10)
        swarm.connections["reconnector"].close()  # simulate a dropped link
        assert _wait(lambda: node.connected and "reconnector" in swarm.connections
                     and node.reconnect_attempts == 0, timeout=20), \
            "node did not reconnect"
    finally:
        node.disconnect()


def test_cost_update_propagates_between_nodes(swarm_server):
    """cost_update from node A is re-broadcast by the coordinator to node B
    with incremented propagation_depth; B's queue aggregates per session."""
    from sublinear_tpu.interfaces.swarm import SwarmNode

    addr, swarm = swarm_server
    received = []
    a = SwarmNode(f"ws://{addr}/ws/swarm", node_id="node-a", heartbeat_interval=5)
    b = SwarmNode(f"ws://{addr}/ws/swarm", node_id="node-b", heartbeat_interval=5,
                  on_cost_update=received.append)
    a.connect()
    b.connect()
    try:
        a.broadcast_cost_update("sess1", {"indices": [0, 2], "values": [0.5, -0.25]})
        a.broadcast_cost_update("sess1", {"indices": [2, 7], "values": [0.25, 1.0]})
        assert _wait(lambda: len(received) >= 2, timeout=15), "B never saw the updates"
        assert all(u["source_node"] == "node-a" for u in received)
        assert all(u["propagation_depth"] == 1 for u in received)

        # per-session aggregation sums deltas by index (applyAggregatedUpdates)
        aggs = b.process_cost_update_queue()
        agg = next(x for x in aggs if x["session_id"] == "sess1")
        deltas = dict(zip(agg["delta_costs"]["indices"], agg["delta_costs"]["values"]))
        assert deltas[0] == pytest.approx(0.5)
        assert deltas[2] == pytest.approx(0.0)
        assert deltas[7] == pytest.approx(1.0)
        assert agg["update_count"] == 2

        # the coordinator recorded A's cost signal
        assert any(h["workerId"] == "node-a" for h in swarm.cost_history)
    finally:
        a.disconnect()
        b.disconnect()


def test_broadcast_survives_dead_socket(swarm_server):
    """A node whose socket dies mid-broadcast must not poison the fan-out:
    the coordinator detaches it and the surviving node still receives the
    cost update (round-3 weakness: one broken pipe killed the loop)."""
    from sublinear_tpu.interfaces.swarm import SwarmNode

    addr, swarm = swarm_server
    received = []
    a = SwarmNode(f"ws://{addr}/ws/swarm", node_id="alive-a", heartbeat_interval=5)
    b = SwarmNode(f"ws://{addr}/ws/swarm", node_id="alive-b", heartbeat_interval=5,
                  on_cost_update=received.append)
    a.connect()
    b.connect()

    class DeadWS:  # a socket that breaks the moment it is written to
        open = True

        def send_json(self, obj):
            raise OSError("broken pipe")

    try:
        swarm.register(node_id="dead-node")
        swarm.attach_ws("dead-node", DeadWS())
        # dict ordering: dead-node was attached AFTER b, but broadcast must
        # reach every live node regardless of where the dead one sits
        a.broadcast_cost_update("sessX", {"indices": [0], "values": [1.0]})
        assert _wait(lambda: len(received) >= 1, timeout=15), \
            "surviving node never saw the update"
        assert _wait(lambda: "dead-node" not in swarm.connections, timeout=10), \
            "dead socket was not detached"
        assert swarm.workers["dead-node"].alive is False
    finally:
        a.disconnect()
        b.disconnect()


def test_consensus_vote_majority_decision(swarm_server):
    """run_consensus broadcasts a consensus_request, nodes cast real
    consensus_vote messages (closing the reference's dead message type,
    flow-nexus.js:175,246-250), and the coordinator applies a majority rule."""
    from sublinear_tpu.interfaces.swarm import SwarmNode

    addr, swarm = swarm_server
    a = SwarmNode(f"ws://{addr}/ws/swarm", node_id="voter-a", heartbeat_interval=5)
    b = SwarmNode(f"ws://{addr}/ws/swarm", node_id="voter-b", heartbeat_interval=5)
    nay = SwarmNode(f"ws://{addr}/ws/swarm", node_id="voter-nay",
                    heartbeat_interval=5, on_consensus=lambda proposal: False)
    for n in (a, b, nay):
        n.connect()
    try:
        assert _wait(lambda: len(swarm.connections) >= 3, timeout=10)
        # session-verification policy: give voter-a a real solved session
        A = slt.generate("tridiagonal", 32)
        bvec = slt.rhs(32, seed=2)
        r = slt.solve(A, bvec, method="conjugate-gradient", epsilon=1e-8)
        a.add_session("csess", A, bvec, r.solution)

        out = swarm.run_consensus({"session_id": "csess", "probe_count": 6,
                                   "tolerance": 1e-4}, timeout=20)
        assert out["quorum_met"], out
        assert out["votes"] == 3
        assert out["decision"] is True  # 2-1 majority (voter-nay dissents)

        # no majority -> no decision (explicit vote_id, manual votes)
        a.cast_vote("tie", True)
        nay.cast_vote("tie", False)
        assert _wait(lambda: len(swarm.votes.get("tie", [])) >= 2, timeout=10)
        tie = swarm.decide("tie", quorum=2)
        assert tie["votes"] == 2 and tie["decision"] is None
    finally:
        for n in (a, b, nay):
            n.disconnect()


def test_mcp_swarm_tools_roundtrip():
    """sublinear_solver_stream -> solver_verification -> swarm_cost_propagation
    (reference FlowNexusMCPTools.getToolDefinitions, flow-nexus.js:500-619)."""
    from sublinear_tpu.interfaces.mcp_server import TOOLS, MCPServer

    names = {t["name"] for t in TOOLS}
    assert {"sublinear_solver_stream", "solver_verification",
            "swarm_cost_propagation"} <= names

    srv = MCPServer()
    A = slt.generate("random-sparse", 32, seed=6, density=0.15)
    b = slt.rhs(32, seed=6)
    out = srv.call_tool("sublinear_solver_stream", {
        "matrix": A.to_dict(), "vector": b.tolist(), "epsilon": 1e-8,
        "chunkIterations": 5,
    })
    assert out["status"] == "completed" and out["updates"]
    assert all("solution" not in u for u in out["updates"])

    v = srv.call_tool("solver_verification", {
        "session_id": out["session_id"], "probe_count": 12, "tolerance": 1e-6})
    assert v["verified"] is True and v["probe_count"] == 12

    v2 = srv.call_tool("solver_verification", {"session_id": "missing"})
    assert v2["verified"] is False

    p = srv.call_tool("swarm_cost_propagation", {
        "session_id": out["session_id"],
        "delta_costs": {"indices": [1, 2], "values": [0.1, 0.2]}})
    assert p["status"] == "propagated"
