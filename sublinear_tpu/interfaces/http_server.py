"""HTTP streaming server (stdlib, no external web framework).

Parity with the reference server (/root/reference/server/index.js:13-628):

  GET  /health                      - liveness + device info
  POST /api/v1/solve                - blocking solve
  POST /api/v1/solve-stream         - chunked JSON-lines SolutionChunk stream
  GET  /api/v1/jobs/<id>            - job status
  GET  /api/v1/jobs/<id>/stream     - stream chunks of a running job
  POST /api/v1/verify               - random-probe verification
  GET  /api/v1/sessions/<id>        - session info
  GET  /ws                          - WebSocket (welcome/solve/subscribe/ping,
                                      index.js:449-596; stdlib RFC 6455)

Sessions/jobs mirror SessionManager (/root/reference/server/session-manager.js:5-439):
in-memory lifecycle with background worker threads (the reference uses
worker_threads; here the device program runs in a Python thread and streams
chunks through a queue).
"""
from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_START_TIME = time.monotonic()

import numpy as np


class Job:
    """Chunk log is a replayable list guarded by a condition variable: any
    number of concurrent streamers (HTTP /stream consumers, WS solve
    streamers, late WS subscribers) replay from their own cursor.  The
    reference's single-consumer queue could silently hang a second
    subscriber (server/session-manager.js getJobStream returns an error
    instead); here late subscribers replay the full history."""

    def __init__(self, job_id: str, session_id: str):
        from ..solvers.streaming import StreamControl

        self.id = job_id
        self.session_id = session_id
        self.status = "pending"  # pending|running|completed|failed
        self.chunk_log: list = []
        self.done = False
        self.cond = threading.Condition()
        self.result = None
        self.error = None
        self.created = time.time()
        # live-session mailbox: WS update_rhs messages land here and the
        # streaming loop drains them between chunks (neumann.rs:436-462)
        self.control = StreamControl()

    def append_chunk(self, chunk: dict):
        with self.cond:
            self.chunk_log.append(chunk)
            self.cond.notify_all()

    def finish(self):
        with self.cond:
            self.done = True
            self.cond.notify_all()

    def iter_chunks(self, timeout: float = 600.0):
        """Replay all chunks from the start, then follow live until done."""
        cursor = 0
        while True:
            with self.cond:
                while cursor >= len(self.chunk_log) and not self.done:
                    if not self.cond.wait(timeout):
                        return
                if cursor < len(self.chunk_log):
                    chunk = self.chunk_log[cursor]
                    cursor += 1
                else:
                    return
            yield chunk


class SessionManager:
    """In-memory sessions + job queue (session-manager.js:83-211)."""

    def __init__(self):
        self.sessions: dict = {}
        self.jobs: dict = {}
        self.lock = threading.Lock()

    def create_session(self) -> dict:
        sid = str(uuid.uuid4())
        session = {"id": sid, "created": time.time(), "jobs": [], "status": "active"}
        with self.lock:
            self.sessions[sid] = session
        return session

    def submit_job(self, payload: dict) -> Job:
        session = self.create_session()
        job = Job(str(uuid.uuid4()), session["id"])
        with self.lock:
            self.jobs[job.id] = job
            session["jobs"].append(job.id)
        thread = threading.Thread(target=self._run_job, args=(job, payload), daemon=True)
        thread.start()
        return job

    def _run_job(self, job: Job, payload: dict):
        job.status = "running"
        try:
            import sublinear_tpu as slt
            from ..solvers.streaming import streaming_solve

            matrix = slt.Matrix.from_dict(payload["matrix"])
            b = np.asarray(payload["vector"], dtype=np.float64)
            options = slt.SolverOptions(
                epsilon=float(payload.get("epsilon", 1e-6)),
                max_iterations=int(payload.get("maxIterations", 1000)),
            )
            method = payload.get("method", "conjugate-gradient")
            last = None
            for chunk in streaming_solve(
                    matrix, b, options, method=method,
                    chunk_iters=int(payload.get("chunkIterations", 10)),
                    control=job.control,
                    verify_every=int(payload.get("verifyEvery", 4)),
                    verify_probes=int(payload.get("verifyProbes", 16)),
                    verify_tolerance=float(payload.get("verifyTolerance", 1e-4))):
                last = chunk
                job.append_chunk(chunk.to_dict())
            job.result = last.to_dict() if last else None
            job.status = "completed" if (last and last.converged) else "failed"
        except Exception as e:
            job.error = str(e)
            job.status = "failed"
        finally:
            job.finish()


MANAGER = SessionManager()

# swarm control plane (reference: server/index.js:341-431 swarm endpoints)
from .swarm import SwarmCoordinator  # noqa: E402

SWARM = SwarmCoordinator()


class RateLimiter:
    """Sliding-window per-IP limiter (reference server/index.js:61-69:
    1000 requests / 15 min per IP on /api)."""

    def __init__(self, window_s: float = 900.0, limit: int = 1000):
        self.window_s = window_s
        self.limit = limit
        self._hits: dict = {}
        self._lock = threading.Lock()

    def allow(self, ip: str) -> bool:
        now = time.monotonic()
        with self._lock:
            q = self._hits.setdefault(ip, [])
            cutoff = now - self.window_s
            while q and q[0] < cutoff:
                q.pop(0)
            if len(q) >= self.limit:
                return False
            q.append(now)
            # bound the per-IP table itself
            if len(self._hits) > 10_000:
                self._hits.clear()
            return True


RATE_LIMITER = RateLimiter()
MAX_BODY_BYTES = 50 * 1024 * 1024  # express.json({limit: '50mb'}) parity


class BodyTooLarge(ValueError):
    pass


class Handler(BaseHTTPRequestHandler):
    server_version = "sublinear-tpu/0.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # ------------------------------------------------------------- helpers
    _CORS = {
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Methods": "GET, POST, PUT, DELETE, OPTIONS",
        "Access-Control-Allow-Headers": "Content-Type, Authorization, X-Session-ID",
    }

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in self._CORS.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_OPTIONS(self):  # CORS preflight
        self.send_response(204)
        for k, v in self._CORS.items():
            self.send_header(k, v)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _rate_limited(self) -> bool:
        """429 on /api paths past the per-IP budget (index.js:61-69)."""
        if not self.path.startswith("/api"):
            return False
        ip = self.client_address[0] if self.client_address else "?"
        if RATE_LIMITER.allow(ip):
            return False
        self._json(429, {"error": "Too many requests", "retryAfter": "15 minutes"})
        return True

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            return {}
        if length > MAX_BODY_BYTES:
            raise BodyTooLarge(f"body {length} bytes > limit {MAX_BODY_BYTES}")
        return json.loads(self.rfile.read(length))

    # ------------------------------------------------------------- routes
    def do_GET(self):
        if self._rate_limited():
            return
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if parts == ["ws"]:
            return self._websocket()
        if parts == ["ws", "swarm"]:
            return self._swarm_websocket()
        if parts == ["health"]:
            import jax

            return self._json(200, {
                "status": "healthy",
                "backend": jax.default_backend(),
                "devices": len(jax.devices()),
                "uptime": time.monotonic() - _START_TIME,
            })
        if len(parts) == 4 and parts[:3] == ["api", "v1", "jobs"]:
            job = MANAGER.jobs.get(parts[3])
            if job is None:
                return self._json(404, {"error": "job not found"})
            return self._json(200, {
                "id": job.id, "status": job.status, "sessionId": job.session_id,
                "result": job.result, "error": job.error,
            })
        if len(parts) == 5 and parts[:3] == ["api", "v1", "jobs"] and parts[4] == "stream":
            job = MANAGER.jobs.get(parts[3])
            if job is None:
                return self._json(404, {"error": "job not found"})
            return self._stream_job(job)
        if len(parts) == 4 and parts[:3] == ["api", "v1", "sessions"]:
            s = MANAGER.sessions.get(parts[3])
            if s is None:
                return self._json(404, {"error": "session not found"})
            return self._json(200, s)
        if parts == ["api", "v1", "swarm", "status"]:
            return self._json(200, SWARM.aggregate_costs())
        return self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self._rate_limited():
            return
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            payload = self._read_body()
        except json.JSONDecodeError:
            return self._json(400, {"error": "invalid JSON body"})
        except BodyTooLarge as e:
            return self._json(413, {"error": str(e)})
        try:
            if parts == ["api", "v1", "solve"]:
                return self._solve_blocking(payload)
            if parts == ["api", "v1", "solve-stream"]:
                job = MANAGER.submit_job(payload)
                return self._stream_job(job, header_extra={"X-Job-Id": job.id})
            if parts == ["api", "v1", "verify"]:
                return self._verify(payload)
            if parts == ["api", "v1", "swarm", "join"]:
                w = SWARM.register(payload.get("endpoint"), payload.get("capabilities"))
                return self._json(200, {"workerId": w.id, "swarmId": SWARM.swarm_id})
            if parts == ["api", "v1", "swarm", "costs"]:
                SWARM.update_cost(payload["workerId"], float(payload["cost"]),
                                  payload.get("metadata"))
                return self._json(200, SWARM.aggregate_costs())
            if parts == ["api", "v1", "swarm", "heartbeat"]:
                SWARM.heartbeat(payload["workerId"])
                return self._json(200, {"ok": True})
            if parts == ["api", "v1", "swarm", "solve"]:
                return self._json(200, SWARM.submit(payload))
            if parts == ["api", "v1", "swarm", "verify"]:
                resp = SWARM.request_verification(
                    payload["nodeId"], payload["sessionId"],
                    int(payload.get("probeCount", 10)),
                    timeout=float(payload.get("timeout", 10.0)),
                    tolerance=float(payload.get("tolerance", 1e-6)))
                if resp is None:
                    return self._json(504, {"error": "verification timed out"})
                return self._json(200, resp)
            return self._json(404, {"error": f"unknown path {self.path}"})
        except Exception as e:
            from ..errors import SolverError

            if isinstance(e, SolverError):
                return self._json(422, e.to_dict())
            return self._json(500, {"error": str(e)})

    # ------------------------------------------------------------- actions
    def _solve_blocking(self, payload: dict):
        import sublinear_tpu as slt

        matrix = slt.Matrix.from_dict(payload["matrix"])
        b = np.asarray(payload["vector"], dtype=np.float64)
        result = slt.solve(
            matrix, b,
            method=payload.get("method", "adaptive"),
            epsilon=float(payload.get("epsilon", 1e-6)),
            max_iterations=int(payload.get("maxIterations", 1000)),
            raise_on_fail=False,
        )
        return self._json(200, result.to_dict())

    def _verify(self, payload: dict):
        import sublinear_tpu as slt

        matrix = slt.Matrix.from_dict(payload["matrix"])
        b = np.asarray(payload["vector"], dtype=np.float64)
        x = np.asarray(payload["solution"], dtype=np.float64)
        r = matrix.csr.matvec(x) - b
        rel = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-30))
        eps = float(payload.get("epsilon", 1e-5))
        return self._json(200, {
            "relativeResidual": rel,
            "maxAbsResidual": float(np.abs(r).max()) if r.size else 0.0,
            "verified": rel <= eps,
        })

    # ---------------------------------------------------------- websocket
    def _websocket(self):
        """WS message protocol (reference server/index.js:449-596):
        welcome on connect; solve -> solve_started + session_update stream;
        subscribe {session_id}; ping -> pong; unknown -> error."""
        from .websocket import WebSocketConnection, perform_handshake

        if not perform_handshake(self):
            return
        ws = WebSocketConnection(self.rfile, self.wfile)
        ws.send_json({"type": "welcome", "timestamp": time.time()})
        while ws.open:
            msg = ws.read_message()
            if msg is None:
                break
            _, payload = msg
            try:
                message = json.loads(payload.decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                ws.send_json({"type": "error", "error": str(e)})
                continue
            mtype = message.get("type")
            if mtype == "ping":
                ws.send_json({"type": "pong", "timestamp": time.time()})
            elif mtype == "solve":
                try:
                    job = MANAGER.submit_job(message)
                except Exception as e:
                    ws.send_json({"type": "error", "error": str(e)})
                    continue
                ws.send_json({"type": "solve_started", "session_id": job.session_id,
                              "job_id": job.id})
                threading.Thread(
                    target=self._ws_stream_job, args=(ws, job), daemon=True
                ).start()
            elif mtype == "subscribe":
                job = self._find_session_job(message.get("session_id"))
                if job is None:
                    ws.send_json({"type": "error",
                                  "error": "Session not found or not streaming"})
                else:
                    threading.Thread(
                        target=self._ws_stream_job, args=(ws, job), daemon=True
                    ).start()
            elif mtype == "update_rhs":
                # delta update into a LIVE session: queued into the job's
                # StreamControl, applied between chunks without restarting
                # the stream (src/solver/mod.rs:245, neumann.rs:436-462)
                job = self._find_session_job(message.get("session_id"))
                delta = message.get("delta") or {}
                if job is None or job.done:
                    ws.send_json({"type": "error",
                                  "error": "Session not found or not running"})
                else:
                    try:
                        job.control.push_delta(delta.get("indices", []),
                                               delta.get("values", []))
                        ws.send_json({"type": "rhs_updated",
                                      "session_id": job.session_id,
                                      "count": len(delta.get("indices", []))})
                    except (ValueError, TypeError) as e:
                        ws.send_json({"type": "error", "error": str(e)})
            else:
                ws.send_json({"type": "error", "error": f"Unknown message type: {mtype}"})

    def _swarm_websocket(self):
        """Swarm WS channel: register -> registered, then the flow-nexus
        message protocol {heartbeat, cost_update (re-broadcast to peers),
        verification_request/response, consensus_vote}
        (/root/reference/integrations/flow-nexus.js:127-405)."""
        from .websocket import WebSocketConnection, perform_handshake

        if not perform_handshake(self):
            return
        ws = WebSocketConnection(self.rfile, self.wfile)
        node_id = None
        try:
            msg = ws.read_message()
            if msg is None:
                return
            try:
                message = json.loads(msg[1].decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                ws.send_json({"type": "error", "error": str(e)})
                return
            if message.get("type") != "register":
                ws.send_json({"type": "error",
                              "error": "first swarm message must be 'register'"})
                return
            w = SWARM.register(None, message.get("capabilities"),
                               node_id=message.get("node_id"))
            node_id = w.id
            SWARM.attach_ws(node_id, ws)
            ws.send_json({"type": "registered", "node_id": node_id,
                          "swarm_id": SWARM.swarm_id})
            while ws.open:
                msg = ws.read_message()
                if msg is None:
                    break
                try:
                    message = json.loads(msg[1].decode())
                except (UnicodeDecodeError, json.JSONDecodeError):
                    continue
                reply = SWARM.handle_ws_message(node_id, message, ws)
                if reply is not None:
                    ws.send_json(reply)
        finally:
            if node_id is not None:
                SWARM.detach_ws(node_id)

    @staticmethod
    def _find_session_job(session_id):
        session = MANAGER.sessions.get(session_id)
        if not session or not session["jobs"]:
            return None
        return MANAGER.jobs.get(session["jobs"][-1])

    @staticmethod
    def _ws_stream_job(ws, job: Job):
        for chunk in job.iter_chunks():
            ws.send_json({"type": "session_update", "session_id": job.session_id, **chunk})
        ws.send_json({"type": "session_complete", "session_id": job.session_id,
                      "status": job.status})

    def _stream_job(self, job: Job, header_extra: dict | None = None):
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in (header_extra or {}).items():
            self.send_header(k, v)
        self.end_headers()

        def write_chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        for chunk in job.iter_chunks():
            write_chunk(chunk)
        write_chunk({"done": True, "status": job.status, "jobId": job.id})
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()


def serve(host: str = "127.0.0.1", port: int = 3000):
    server = ThreadingHTTPServer((host, port), Handler)
    print(f"sublinear-tpu HTTP server on http://{host}:{server.server_address[1]}", flush=True)
    server.serve_forever()


def make_server(host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), Handler)


if __name__ == "__main__":
    import argparse

    from ..config import configure_platform

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=3000)
    ap.add_argument("--platform", help="jax platform override (cpu/cuda); also SLT_PLATFORM env")
    a = ap.parse_args()
    configure_platform(a.platform)
    serve(a.host, a.port)
