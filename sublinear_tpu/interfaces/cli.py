"""Command-line interface.

Parity with the shipped CLI (/root/reference/src/cli/index.ts:28-410:
serve/solve/analyze/pagerank/generate/help-examples) plus the legacy CLI's
verify/benchmark/convert commands (/root/reference/bin/cli.js:256-491).

Usage: python -m sublinear_tpu.interfaces.cli <command> [options]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _load_matrix(path):
    from ..formats.io import load_matrix

    return load_matrix(path)  # JSON / .mtx / .csv


def _load_vector(path):
    from ..formats.io import load_vector

    return load_vector(path)


def cmd_solve(args):
    import sublinear_tpu as slt

    A = _load_matrix(args.matrix)
    b = _load_vector(args.vector)
    analysis = slt.analyze(A)
    if args.verbose:
        print(f"matrix {A.shape[0]}x{A.shape[1]} nnz={A.nnz} DD={analysis.is_diagonally_dominant} "
              f"recommended={analysis.recommended_method}", file=sys.stderr)
    t0 = time.perf_counter()
    result = slt.solve(
        A, b, method=args.method, epsilon=args.epsilon,
        max_iterations=args.max_iterations, raise_on_fail=not args.no_raise,
    )
    wall = (time.perf_counter() - t0) * 1e3
    out = result.to_dict()
    out["wallTimeMs"] = wall
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f)
        print(f"solution written to {args.output} ({result.method}, "
              f"{result.iterations} iters, residual {result.residual:.3e})", file=sys.stderr)
    else:
        json.dump(out, sys.stdout)
        print()
    return 0


def cmd_analyze(args):
    import sublinear_tpu as slt

    A = _load_matrix(args.matrix)
    analysis = slt.analyze(A, estimate_condition=not args.no_condition)
    json.dump(analysis.to_dict(), sys.stdout, indent=2 if args.pretty else None)
    print()
    return 0


def cmd_pagerank(args):
    from ..graph import pagerank, pagerank_statistics, personalized_pagerank

    A = _load_matrix(args.adjacency)
    if args.personalized:
        nodes = [int(x) for x in args.personalized.split(",")]
        result = personalized_pagerank(
            A, nodes, damping=args.damping, epsilon=args.epsilon, max_iterations=args.max_iterations
        )
    else:
        result = pagerank(A, damping=args.damping, epsilon=args.epsilon, max_iterations=args.max_iterations)
    out = result.to_dict()
    out.update(pagerank_statistics(result, top_k=args.top))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f)
        print(f"pagerank written to {args.output}", file=sys.stderr)
    else:
        json.dump(out, sys.stdout)
        print()
    return 0


def cmd_generate(args):
    import sublinear_tpu as slt

    params = json.loads(args.params) if args.params else {}
    A = slt.generate(args.type, args.size, seed=args.seed, **params)
    doc = A.to_dict("dense" if args.dense else "coo")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(doc, f)
        print(f"{args.type} {args.size}x{args.size} (nnz={A.nnz}) written to {args.output}", file=sys.stderr)
    else:
        json.dump(doc, sys.stdout)
        print()
    return 0


def cmd_estimate(args):
    import sublinear_tpu as slt
    from ..queries import estimate_entry

    A = _load_matrix(args.matrix)
    b = _load_vector(args.vector)
    est = estimate_entry(
        A, b, row=args.row, column=args.column, method=args.method, epsilon=args.epsilon
    )
    json.dump(est.to_dict(), sys.stdout)
    print()
    return 0


def cmd_verify(args):
    """Random-probe verification of a solution file (bin/cli.js:354-380)."""
    import sublinear_tpu as slt

    A = _load_matrix(args.matrix)
    b = _load_vector(args.vector)
    sol = _load_json(args.solution)
    x = np.asarray(sol["solution"] if isinstance(sol, dict) else sol, dtype=np.float64)
    r = A.csr.matvec(x) - b
    rel = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-30))
    rng = np.random.default_rng(0)
    probes = rng.choice(A.shape[0], size=min(args.probes, A.shape[0]), replace=False)
    out = {
        "relativeResidual": rel,
        "maxAbsResidual": float(np.abs(r).max()),
        "probes": [{"row": int(i), "residual": float(r[i])} for i in probes],
        "verified": rel <= args.epsilon,
    }
    json.dump(out, sys.stdout)
    print()
    return 0 if out["verified"] else 1


def cmd_benchmark(args):
    import sublinear_tpu as slt

    sizes = [int(s) for s in args.sizes.split(",")]
    report = []
    for n in sizes:
        A = slt.generate("random-sparse", n, seed=7, density=args.density)
        b = slt.rhs(n, seed=7)
        r = slt.solve(A, b, method=args.method, epsilon=args.epsilon, raise_on_fail=False)
        # warm timing
        t0 = time.perf_counter()
        r = slt.solve(A, b, method=args.method, epsilon=args.epsilon, raise_on_fail=False)
        ms = (time.perf_counter() - t0) * 1e3
        report.append(
            {"n": n, "nnz": A.nnz, "ms": ms, "iterations": r.iterations,
             "residual": r.residual, "converged": r.converged, "method": r.method}
        )
        print(f"n={n:8d} nnz={A.nnz:10d} {ms:9.2f}ms iters={r.iterations}", file=sys.stderr)
    json.dump(report, sys.stdout)
    print()
    return 0


def cmd_help_examples(args):
    """Usage examples (reference: cli/index.ts:355-402 help-examples)."""
    print("""sublinear-tpu usage examples
============================

Generate a 1000x1000 diagonally-dominant test system:
  sublinear-tpu generate -t random-sparse -s 1000 --params '{"density":0.001}' -o A.json

Solve it (adaptive method selection):
  sublinear-tpu solve -m A.json -b b.json -o x.json

Solve with a specific method and tolerance:
  sublinear-tpu solve -m A.json -b b.json --method neumann -e 1e-8

Analyze matrix properties:
  sublinear-tpu analyze -m A.json --pretty

Verify a solution with random probes:
  sublinear-tpu verify -m A.json -b b.json -s x.json

PageRank of an adjacency matrix (personalized for nodes 0 and 3):
  sublinear-tpu pagerank -a graph.json --personalized 0,3

Estimate a single solution entry without a full solve:
  sublinear-tpu estimate -m A.json -b b.json --row 17 --method random-walk

Convert between matrix formats (JSON / MatrixMarket / CSV):
  sublinear-tpu convert -i A.json -o A.mtx

Timing sweep over sizes:
  sublinear-tpu benchmark --sizes 100,1000,10000 --method conjugate-gradient

Train a temporal micro-net from a YAML config (System A):
  sublinear-tpu train --config configs/A_traditional.yaml --data series.csv

Per-tick inference latency vs the 0.90 ms P99.9 budget:
  sublinear-tpu nn-latency --config configs/B_temporal_solver.yaml

Join a swarm as a worker over WebSocket:
  sublinear-tpu swarm-worker --connect ws://coordinator:3000/ws/swarm

Run the MCP stdio server (for LLM agents):
  sublinear-tpu serve-mcp

Run the HTTP streaming server:
  sublinear-tpu serve --port 3000""")
    return 0


def cmd_convert(args):
    """Matrix format conversion (bin/cli.js convert: JSON/CSV/MatrixMarket)."""
    from ..formats.io import load_matrix, save_matrix

    A = load_matrix(args.input)
    save_matrix(A, args.output, fmt=args.format)
    print(f"converted {args.input} ({A.shape[0]}x{A.shape[1]}, nnz={A.nnz}) -> {args.output}",
          file=sys.stderr)
    return 0


def cmd_predict(args):
    """Prediction with temporal-advantage report (temporal-cli `predict`
    parity, /root/reference/temporal-lead-solver/src/bin/cli.rs:126-170)."""
    import numpy as np

    from ..formats.io import load_matrix, load_vector
    from ..queries.temporal import predict_with_temporal_advantage
    from ..types import SolverOptions

    if args.matrix:
        matrix = load_matrix(args.matrix)
        vector = load_vector(args.vector) if args.vector else np.ones(matrix.shape[0])
    else:
        import sublinear_tpu as slt

        matrix = slt.generate("diagonally-dominant", args.size, seed=args.seed)
        vector = slt.rhs(args.size, seed=args.seed)
    out = predict_with_temporal_advantage(
        matrix, vector, distance_km=args.distance,
        options=SolverOptions(epsilon=args.epsilon),
    )
    # causality note (reference validate_causality, predictor.rs:363): the
    # prediction uses locally-available data only — no FTL information flow.
    out["causality"] = {
        "valid": True,
        "note": "prediction computed from locally available matrix/vector data; "
                "no information travels faster than light",
    }
    if not args.full:
        out.pop("solution", None)
    json.dump(out, sys.stdout, indent=2 if args.pretty else None)
    print()
    return 0 if out["converged"] else 1


def cmd_prove(args):
    """Temporal-lead certificate (temporal-cli `prove` parity)."""
    from ..queries.temporal import prove_temporal_lead

    out = prove_temporal_lead(size=args.size, distance_km=args.distance, epsilon=args.epsilon)
    json.dump(out, sys.stdout, indent=2 if args.pretty else None)
    print()
    return 0 if out["proved"] else 1


def cmd_train(args):
    """Config-driven System-A training (reference
    neural-network-implementation/src/bin/train.rs: --config + data path)."""
    import numpy as np

    from ..models import Config, Trainer
    from ..models.trainer import load_series_csv, make_windows

    cfg = Config.load(args.config)
    if args.data:
        series = load_series_csv(args.data, column=args.column)
    else:  # built-in synthetic series for smoke runs
        t = np.arange(4096, dtype=np.float32)
        series = np.sin(2 * np.pi * t / 50) + 0.1 * np.sin(2 * np.pi * t / 7)
    window = min(cfg.common.window_steps, max(len(series) // 4, 2))
    windows, targets = make_windows(series, window=window, horizon=1)
    split = max(int(len(windows) * 0.8), 1)
    trainer = Trainer.from_config(cfg, window=window)
    history = trainer.fit(
        windows[:split], targets[:split],
        validation_data=(windows[split:], targets[split:]) if split < len(windows) else None,
        verbose=args.verbose or cfg.common.verbose,
    )
    if args.out:
        trainer.save(args.out)
    print(json.dumps({
        "config": args.config, "epochs_run": len(history),
        "final_loss": history[-1] if history else None,
        "val_loss": trainer.evaluate(windows[split:], targets[split:])
        if split < len(windows) else None,
        "saved": args.out,
    }))
    return 0


def cmd_nn_latency(args):
    """Per-tick latency harness against the 0.90 ms P99.9 budget
    (reference lib.rs:63-74)."""
    from ..models import Config, Predictor, Trainer, build_system, latency_report
    from ..models.temporal_net import SystemA

    cfg = Config.load(args.config)
    window = cfg.common.window_steps
    system = build_system(cfg)
    if isinstance(system, SystemA):
        trainer = Trainer(system, window=window, features=1,
                          training_config=cfg.training)
        pred = Predictor.new_system_a(system, trainer.state.params,
                                      cfg.inference, quantize=cfg.common.quantize)
    else:
        pred = Predictor.new_system_b(system, cfg.inference)
    rep = latency_report(pred, (window, 1), ticks=args.ticks, warmup=args.warmup)
    print(json.dumps(rep))
    return 0


def cmd_swarm_worker(args):
    from .swarm import _worker_main

    worker_args = ["--connect", args.connect, "--heartbeat", str(args.heartbeat)]
    if args.id:
        worker_args += ["--id", args.id]
    if args.demo_session:
        worker_args += ["--demo-session"]
    _worker_main(worker_args)
    return 0


def cmd_serve_mcp(args):
    from .mcp_server import MCPServer

    MCPServer().run()
    return 0


def cmd_serve_http(args):
    from .http_server import serve

    serve(host=args.host, port=args.port)
    return 0


def build_parser():
    p = argparse.ArgumentParser(
        prog="sublinear-tpu",
        description="GPU-native sublinear-time solver for diagonally-dominant systems",
    )
    p.add_argument("--platform", help="jax platform override (cpu/cuda); also SLT_PLATFORM env")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("solve", help="solve Ax=b from JSON files")
    s.add_argument("-m", "--matrix", required=True)
    s.add_argument("-b", "--vector", required=True)
    s.add_argument("--method", default="adaptive")
    s.add_argument("-e", "--epsilon", type=float, default=1e-6)
    s.add_argument("--max-iterations", type=int, default=1000)
    s.add_argument("-o", "--output")
    s.add_argument("-v", "--verbose", action="store_true")
    s.add_argument("--no-raise", action="store_true")
    s.set_defaults(fn=cmd_solve)

    s = sub.add_parser("analyze", help="analyze matrix properties")
    s.add_argument("-m", "--matrix", required=True)
    s.add_argument("--pretty", action="store_true")
    s.add_argument("--no-condition", action="store_true")
    s.set_defaults(fn=cmd_analyze)

    s = sub.add_parser("pagerank", help="compute PageRank of an adjacency matrix")
    s.add_argument("-a", "--adjacency", required=True)
    s.add_argument("-d", "--damping", type=float, default=0.85)
    s.add_argument("-e", "--epsilon", type=float, default=1e-6)
    s.add_argument("--max-iterations", type=int, default=1000)
    s.add_argument("--personalized", help="comma-separated node list")
    s.add_argument("--top", type=int, default=10)
    s.add_argument("-o", "--output")
    s.set_defaults(fn=cmd_pagerank)

    s = sub.add_parser("generate", help="generate test matrices")
    s.add_argument("-t", "--type", required=True,
                   choices=["diagonally-dominant", "laplacian", "random-sparse", "tridiagonal"])
    s.add_argument("-s", "--size", type=int, required=True)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--params", help='JSON dict, e.g. {"density": 0.01}')
    s.add_argument("--dense", action="store_true")
    s.add_argument("-o", "--output")
    s.set_defaults(fn=cmd_generate)

    s = sub.add_parser("estimate", help="estimate a single solution entry")
    s.add_argument("-m", "--matrix", required=True)
    s.add_argument("-b", "--vector", required=True)
    s.add_argument("--row", type=int, required=True)
    s.add_argument("--column", type=int, default=0)
    s.add_argument("--method", default="random-walk")
    s.add_argument("-e", "--epsilon", type=float, default=1e-3)
    s.set_defaults(fn=cmd_estimate)

    s = sub.add_parser("verify", help="verify a solution with random probes")
    s.add_argument("-m", "--matrix", required=True)
    s.add_argument("-b", "--vector", required=True)
    s.add_argument("-s", "--solution", required=True)
    s.add_argument("-e", "--epsilon", type=float, default=1e-5)
    s.add_argument("--probes", type=int, default=10)
    s.set_defaults(fn=cmd_verify)

    s = sub.add_parser("benchmark", help="timing sweep over sizes")
    s.add_argument("--sizes", default="100,1000")
    s.add_argument("--density", type=float, default=0.001)
    s.add_argument("--method", default="conjugate-gradient")
    s.add_argument("-e", "--epsilon", type=float, default=1e-6)
    s.set_defaults(fn=cmd_benchmark)

    s = sub.add_parser("help-examples", help="show usage examples")
    s.set_defaults(fn=cmd_help_examples)

    s = sub.add_parser("convert", help="convert matrix files (json/csv/mtx)")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-o", "--output", required=True)
    s.add_argument("-f", "--format", choices=["json", "csv", "mtx"])
    s.set_defaults(fn=cmd_convert)

    s = sub.add_parser("predict", help="solve with temporal-advantage report")
    s.add_argument("-s", "--size", type=int, default=1000)
    s.add_argument("-m", "--matrix", help="matrix file (json/mtx/csv/gml); generated if omitted")
    s.add_argument("-b", "--vector", help="RHS file; ones if omitted")
    s.add_argument("-d", "--distance", type=float, default=10900)
    s.add_argument("-e", "--epsilon", type=float, default=1e-6)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--full", action="store_true", help="include full solution vector")
    s.add_argument("--pretty", action="store_true")
    s.set_defaults(fn=cmd_predict)

    s = sub.add_parser("prove", help="temporal-lead certificate")
    s.add_argument("-s", "--size", type=int, default=1000)
    s.add_argument("-d", "--distance", type=float, default=10900)
    s.add_argument("-e", "--epsilon", type=float, default=1e-6)
    s.add_argument("--pretty", action="store_true")
    s.set_defaults(fn=cmd_prove)

    s = sub.add_parser("train", help="config-driven temporal-net training")
    s.add_argument("--config", required=True, help="YAML/JSON config (configs/)")
    s.add_argument("--data", help="CSV time-series; synthetic sine when omitted")
    s.add_argument("--column", type=int, default=-1)
    s.add_argument("--out", help="save trained parameters (msgpack)")
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("nn-latency", help="per-tick latency harness (P99.9 budget)")
    s.add_argument("--config", required=True)
    s.add_argument("--ticks", type=int, default=1000)
    s.add_argument("--warmup", type=int, default=25)
    s.set_defaults(fn=cmd_nn_latency)

    s = sub.add_parser("swarm-worker", help="connect a worker to a swarm coordinator")
    s.add_argument("--connect", required=True, help="ws://host:port/ws/swarm")
    s.add_argument("--id")
    s.add_argument("--heartbeat", type=float, default=5.0)
    s.add_argument("--demo-session", action="store_true")
    s.set_defaults(fn=cmd_swarm_worker)

    s = sub.add_parser("serve-mcp", help="run the MCP stdio server")
    s.set_defaults(fn=cmd_serve_mcp)

    s = sub.add_parser("serve", help="run the HTTP streaming server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=3000)
    s.set_defaults(fn=cmd_serve_http)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..config import configure_platform

    configure_platform(getattr(args, "platform", None))
    try:
        return args.fn(args)
    except Exception as e:  # structured error reporting at the CLI boundary
        from ..errors import SolverError

        if isinstance(e, SolverError):
            json.dump(e.to_dict(), sys.stderr)
            print(file=sys.stderr)
            return 2
        raise


if __name__ == "__main__":
    sys.exit(main())
