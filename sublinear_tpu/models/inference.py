"""Low-latency inference path + per-tick latency harness.

Reference: /root/reference/neural-network-implementation/src/inference/
(Predictor with per-stage TimingBreakdown, InferenceStatistics, warmup,
meets_performance_targets; memory_pool.rs zero-alloc buffers; quantization.rs
INT8 inference) and the lib.rs:63-74 latency budget:
ingest 0.10 + prior 0.10 + network 0.30 + gate 0.20 + actuation 0.10
=> total P99.9 <= 0.90 ms/tick.

Device re-design of "zero-alloc": the reference pre-allocates host buffers and
hand-rolls SIMD; here every stage is ONE cached jitted XLA program with
static shapes (no per-tick tracing or compilation), the host staging buffer
is allocated once and refilled in place, and the per-tick result is a single
small fetch.  A stage is timed by fetching a result scalar to the host, so
the time covers the device work the scalar depends on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .config import InferenceConfig
from .temporal_net import SystemA, SystemB


@dataclasses.dataclass
class TimingBreakdown:
    """Per-stage milliseconds for one tick (inference/mod.rs TimingBreakdown)."""

    ingest_ms: float = 0.0
    prior_ms: float = 0.0
    network_ms: float = 0.0
    gate_ms: float = 0.0
    actuation_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return (self.ingest_ms + self.prior_ms + self.network_ms
                + self.gate_ms + self.actuation_ms)


@dataclasses.dataclass
class Prediction:
    value: np.ndarray
    timing: TimingBreakdown
    gated: bool = False  # True when the gate swapped in the fallback


def _percentile(xs: np.ndarray, q: float) -> float:
    return float(np.percentile(xs, q)) if xs.size else 0.0


class InferenceStatistics:
    """Streaming latency statistics (inference/mod.rs InferenceStatistics)."""

    STAGES = ("ingest", "prior", "network", "gate", "actuation", "total")

    def __init__(self):
        self._ticks: list[TimingBreakdown] = []

    def record(self, t: TimingBreakdown):
        self._ticks.append(t)

    @property
    def count(self) -> int:
        return len(self._ticks)

    def stage_ms(self, stage: str) -> np.ndarray:
        if stage == "total":
            return np.asarray([t.total_ms for t in self._ticks])
        return np.asarray([getattr(t, f"{stage}_ms") for t in self._ticks])

    def percentiles(self, stage: str = "total") -> dict:
        xs = self.stage_ms(stage)
        return {
            "p50": _percentile(xs, 50), "p90": _percentile(xs, 90),
            "p99": _percentile(xs, 99), "p999": _percentile(xs, 99.9),
            "mean": float(xs.mean()) if xs.size else 0.0,
            "max": float(xs.max()) if xs.size else 0.0,
        }

    def report(self) -> dict:
        return {s: self.percentiles(s) for s in self.STAGES}

    def reset(self):
        self._ticks.clear()


class Predictor:
    """Single-tick predictor over System A or System B.

    Stage mapping (lib.rs latency budget):
      ingest    — refill the reused host staging buffer + device transfer
      prior     — System B only: jitted Kalman filter + open-loop forecast
      network   — jitted net apply (quantized params when configured)
      gate      — System B only: jitted certificate verify + select
      actuation — host-side output write (bounds-checked copy)
    """

    def __init__(self, config: Optional[InferenceConfig] = None):
        self.config = config or InferenceConfig()
        self.stats = InferenceStatistics()
        self._staging: Optional[np.ndarray] = None  # reused host buffer
        self._out: Optional[np.ndarray] = None
        self._tick = None           # fused streaming step (when supported)
        self._stream_init = None
        self._carry = None
        self.tick_ms: list[float] = []  # fused-path per-tick latencies

    # ------------------------------------------------------------- builders
    @classmethod
    def new_system_a(cls, model: SystemA, params, config: Optional[InferenceConfig] = None,
                     quantize: bool = False):
        self = cls(config)
        self.kind = "A"
        apply = model.apply
        if quantize:
            from .quantization import quantize_tree

            qp = quantize_tree(params, scheme="int8", per_channel=True)
            # dequantize once at load (INT8 storage, f32 compute; per-tick
            # dequant would add a kernel)
            params = qp.dequantize()
        self._net = jax.jit(lambda w: apply(params, w))
        self._prior_fn = None
        self._gate_fn = None

        # ---- streaming tick step (GRU only): carry the hidden state, do
        # O(1) work per tick instead of re-scanning the whole window.  The
        # carry is donated so XLA reuses the state buffer in place — the
        # device-native form of memory_pool.rs's zero-alloc serving.
        if model.arch == "gru":
            import flax.linen as nn

            cell = nn.GRUCell(features=model.hidden)
            cp = {"params": params["params"]["GRUBlock_0"]["GRUCell_0"]}
            d0 = params["params"]["Dense_0"]
            d1 = params["params"]["Dense_1"]

            def tick(h, x):  # h: (H,), x: (F,)
                new_h, _ = cell.apply(cp, h, x)
                z = jax.nn.relu(new_h @ d0["kernel"] + d0["bias"])
                return new_h, z @ d1["kernel"] + d1["bias"]

            self._tick = jax.jit(tick, donate_argnums=0)
            self._stream_init = jax.jit(
                lambda w: jax.lax.scan(tick, jnp.zeros(model.hidden), w)[0])
        else:
            # TCN: dilated convs need the window — carry it as a device ring
            # (roll + set, donated) and re-apply the full conv stack; still
            # one fused dispatch per tick with zero host allocation.
            def tick(buf, x):  # buf: (T, F)
                buf = jnp.roll(buf, -1, axis=0).at[-1].set(x)
                return buf, apply(params, buf)

            self._tick = jax.jit(tick, donate_argnums=0)
            self._stream_init = jax.jit(lambda w: w)
        return self

    @classmethod
    def new_system_b(cls, system: SystemB, config: Optional[InferenceConfig] = None):
        self = cls(config)
        self.kind = "B"
        net, params, kalman, gate = system.net, system.params, system.kalman, system.gate
        horizon = net.horizon

        def prior_fn(window):  # (T, F) -> (horizon,)
            sT, _ = kalman.filter_sequence(window[:, :1])
            return kalman.forecast(sT, horizon).reshape(-1)

        def net_fn(window, prior):
            return prior + net.apply(params, window.reshape(-1), prior)

        pad = max(0, 2 - horizon)

        def gate_fn(raw, prior):  # jitted certificate verify + select
            X = jnp.pad(raw, (0, pad))[None, :]
            F = jnp.pad(prior, (0, pad))[None, :]
            err, passed = gate._verify_batch(X)
            out = jnp.where(passed[:, None], X, F)[0, :horizon]
            return out, passed[0]

        self._prior_fn = jax.jit(prior_fn)
        self._net = jax.jit(net_fn)
        self._gate_fn = jax.jit(gate_fn)

        # ---- streaming tick: carry (kalman mean, kalman cov, window ring);
        # per tick = ONE fused dispatch (predict/update + forecast + residual
        # net + certificate gate), donated carry.
        from .kalman import KalmanState

        def tick(carry, x):  # x: (F,)
            kx, kP, buf = carry
            s = kalman.update(kalman.predict(KalmanState(kx, kP)), x[:1])
            prior = kalman.forecast(s, horizon).reshape(-1)
            buf = jnp.roll(buf, -1, axis=0).at[-1].set(x)
            raw = prior + net.apply(params, buf.reshape(-1), prior)
            X = jnp.pad(raw, (0, pad))[None, :]
            Fb = jnp.pad(prior, (0, pad))[None, :]
            _, passed = gate._verify_batch(X)
            out = jnp.where(passed[:, None], X, Fb)[0, :horizon]
            return (s.x, s.P, buf), out

        def stream_init(w):  # (T, F) -> carry
            sT, _ = kalman.filter_sequence(w[:, :1])
            return (sT.x, sT.P, w)

        self._tick = jax.jit(tick, donate_argnums=0)
        self._stream_init = jax.jit(stream_init)
        return self

    # ------------------------------------------------------------- serving
    def warmup(self, window_shape, iterations: int = 3):
        """Compile + warm every stage (inference/mod.rs warmup)."""
        w = np.zeros(window_shape, dtype=np.float32)
        for _ in range(max(iterations, 1)):
            self.predict(w)
        self.stats.reset()

    def predict(self, window: np.ndarray) -> Prediction:
        t = TimingBreakdown()

        t0 = time.perf_counter()
        window = np.atleast_2d(np.asarray(window, dtype=np.float32))
        if self._staging is None or self._staging.shape != window.shape:
            self._staging = np.empty_like(window)  # allocated once, reused
        np.copyto(self._staging, window)
        w_dev = jnp.asarray(self._staging)
        t.ingest_ms = (time.perf_counter() - t0) * 1e3

        prior = None
        if self._prior_fn is not None:
            t0 = time.perf_counter()
            prior = self._prior_fn(w_dev)
            _ = float(prior[0])  # host fetch = real synchronization
            t.prior_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        raw = self._net(w_dev) if prior is None else self._net(w_dev, prior)
        raw_host = np.asarray(raw)
        t.network_ms = (time.perf_counter() - t0) * 1e3

        gated = False
        if self._gate_fn is not None:
            t0 = time.perf_counter()
            out_dev, passed = self._gate_fn(raw, prior)
            raw_host = np.asarray(out_dev)
            gated = not bool(passed)
            t.gate_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        if self._out is None or self._out.shape != raw_host.shape:
            self._out = np.empty_like(raw_host)
        np.copyto(self._out, raw_host)
        np.nan_to_num(self._out, copy=False)  # actuation safety clamp
        t.actuation_ms = (time.perf_counter() - t0) * 1e3

        self.stats.record(t)
        return Prediction(self._out.copy(), t, gated)

    # ------------------------------------------------------ streaming ticks
    def init_stream(self, window: np.ndarray):
        """Prime the streaming carry from a full history window (one scan);
        afterwards predict_tick() is O(1) work per tick."""
        if self._stream_init is None:
            from ..errors import InvalidParametersError

            raise InvalidParametersError(
                "streaming ticks are supported for GRU System A and System B"
                " (TCN needs the full window per tick)")
        w = jnp.asarray(np.atleast_2d(np.asarray(window, dtype=np.float32)))
        self._carry = self._stream_init(w)

    def predict_tick(self, sample) -> np.ndarray:
        """One fused-dispatch tick on the carried state (the production
        serving path; per-stage breakdown comes from predict())."""
        if self._carry is None:
            from ..errors import InvalidParametersError

            raise InvalidParametersError("call init_stream(window) first")
        t0 = time.perf_counter()
        x = jnp.asarray(np.asarray(sample, dtype=np.float32).reshape(-1))
        self._carry, out = self._tick(self._carry, x)
        out_host = np.asarray(out)  # host fetch = real synchronization
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)
        return out_host

    def tick_percentiles(self) -> dict:
        xs = np.asarray(self.tick_ms)
        return {
            "p50": _percentile(xs, 50), "p90": _percentile(xs, 90),
            "p99": _percentile(xs, 99), "p999": _percentile(xs, 99.9),
            "mean": float(xs.mean()) if xs.size else 0.0,
            "max": float(xs.max()) if xs.size else 0.0,
        }

    # ----------------------------------------------------------- reporting
    def meets_performance_targets(self) -> bool:
        """lib.rs success criteria: per-tick P99.9 <= target (0.90 ms
        default).  On the fused streaming path the gate runs inside the same
        XLA program, so its sub-budget is subsumed by the total; on the
        staged path each stage pays its own dispatch+sync, so the 0.20 ms
        gate sub-budget is checked there explicitly."""
        c = self.config
        if self.tick_ms:
            return bool(self.tick_percentiles()["p999"] <= c.target_latency_ms)
        ok_total = self.stats.percentiles("total")["p999"] <= c.target_latency_ms
        ok_gate = self.stats.percentiles("gate")["p999"] <= c.budget_gate_ms
        return bool(ok_total and ok_gate)


def latency_report(predictor: Predictor, window_shape, ticks: int = 1000,
                   warmup: int = 25, seed: int = 0) -> dict:
    """Drive ``ticks`` single-tick predictions and report per-stage
    percentiles against the latency budget (the harness the reference runs
    its P99.9 <= 0.90 ms claim on, lib.rs:63-74).

    Measures BOTH paths: the staged predict() for the per-stage breakdown,
    and — when the model supports carried state — the fused predict_tick()
    streaming path whose totals are the production per-tick latency."""
    rng = np.random.default_rng(seed)
    predictor.warmup(window_shape, warmup)
    for _ in range(ticks):
        predictor.predict(rng.standard_normal(window_shape).astype(np.float32))
    rep = predictor.stats.report()
    if predictor._stream_init is not None:
        predictor.init_stream(rng.standard_normal(window_shape).astype(np.float32))
        f = window_shape[-1] if len(window_shape) > 1 else 1
        for _ in range(max(warmup, 1)):  # compile + warm the tick program
            predictor.predict_tick(rng.standard_normal(f).astype(np.float32))
        predictor.tick_ms.clear()
        for _ in range(ticks):
            predictor.predict_tick(rng.standard_normal(f).astype(np.float32))
        rep["tick"] = predictor.tick_percentiles()
    rep["ticks"] = ticks
    rep["budget_ms"] = {
        "ingest": predictor.config.budget_ingest_ms,
        "prior": predictor.config.budget_prior_ms,
        "network": predictor.config.budget_network_ms,
        "gate": predictor.config.budget_gate_ms,
        "actuation": predictor.config.budget_actuation_ms,
        "total_p999": predictor.config.target_latency_ms,
    }
    rep["meets_targets"] = predictor.meets_performance_targets()
    return rep
