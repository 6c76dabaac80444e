"""Temporal micro-nets end to end: config -> train -> quantize -> serve.

Mirrors the reference's neural-network-implementation workflow
(configs/*.yaml + bin/train.rs + the lib.rs latency budget): train System A
from a YAML config, train System B's residual net on the Kalman prior with
PageRank active selection, then measure per-tick serving latency on the
fused streaming path against the P99.9 <= 0.90 ms budget.

Run: python examples/temporal_nets.py  (CPU or GPU; a few minutes on CPU)
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sublinear_tpu.models import (  # noqa: E402
    Config,
    EarlyStopping,
    History,
    Predictor,
    SystemB,
    Trainer,
    build_system,
    latency_report,
    make_windows,
    quantization_error,
    quantize_tree,
    train_system_b,
)


def make_series(n=4096):
    t = np.arange(n, dtype=np.float32)
    return (np.sin(2 * np.pi * t / 50) + 0.3 * np.sin(2 * np.pi * t / 11)
            + 0.05 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)


def main():
    series = make_series()

    # --- System A from the shipped config (window geometry scaled down for a
    # quick demo; drop the overrides to run the full 256-step geometry)
    cfg = Config.load(os.path.join(os.path.dirname(__file__), "..",
                                   "configs", "A_traditional.yaml"))
    cfg.common.window_ms, cfg.common.sample_rate_hz = 16, 1000  # window 16
    cfg.training.epochs = 8
    window = cfg.common.window_steps
    windows, targets = make_windows(series, window=window, horizon=1)
    split = int(len(windows) * 0.8)

    trainer = Trainer.from_config(cfg, window=window)
    hist = History()
    trainer.fit(windows[:split], targets[:split],
                validation_data=(windows[split:], targets[split:]),
                callbacks=[hist, EarlyStopping(patience=cfg.training.patience)])
    print("System A val loss:", trainer.evaluate(windows[split:], targets[split:]))

    # --- INT8 quantization (FP32 train, INT8 inference storage)
    qp = quantize_tree(trainer.state.params["params"], scheme="int8")
    print("int8 round-trip:", json.dumps(quantization_error(
        trainer.state.params["params"], qp)))

    # --- System B: Kalman prior + residual net + gate, active selection
    cfg_b = Config.load(os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "B_temporal_solver.yaml"))
    cfg_b.common.window_ms, cfg_b.common.sample_rate_hz = 16, 1000
    cfg_b.training.epochs = 6
    sysb = build_system(cfg_b)
    assert isinstance(sysb, SystemB)
    hist_b = train_system_b(sysb, windows[:split], targets[:split], cfg_b,
                            validation_data=(windows[split:], targets[split:]))
    print("System B:", json.dumps(hist_b[-1]))

    # --- serving latency on the fused streaming tick (one dispatch/tick)
    pred_a = Predictor.new_system_a(trainer.model, trainer.state.params,
                                    cfg.inference, quantize=True)
    rep_a = latency_report(pred_a, (window, 1), ticks=500, warmup=25)
    pred_b = Predictor.new_system_b(sysb, cfg_b.inference)
    rep_b = latency_report(pred_b, (window, 1), ticks=500, warmup=25)
    for name, rep in (("A", rep_a), ("B", rep_b)):
        print(f"System {name} tick P50={rep['tick']['p50']:.3f} ms "
              f"P99.9={rep['tick']['p999']:.3f} ms "
              f"(budget {rep['budget_ms']['total_p999']} ms, "
              f"meets={rep['meets_targets']})")


if __name__ == "__main__":
    main()
