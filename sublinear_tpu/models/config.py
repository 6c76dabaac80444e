"""YAML/JSON config system for the temporal-net vertical.

Reference parity: /root/reference/neural-network-implementation/src/config.rs
(Config{common,model,training,inference,system}, SystemConfig enum with the
Kalman prior / solver-gate / active-selection sub-configs, validate()) and the
shipped configs/ directory (A_traditional.yaml, B_temporal_solver.yaml).

Device notes: fields that configure host threading in the reference
(num_threads, cpu_affinity, enable_simd, pin_memory) are kept for config-file
compatibility but are advisory here — XLA owns scheduling; "SIMD" is the
always-on fused jitted program.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from ..errors import InvalidParametersError

_ACTIVATIONS = {"tanh", "relu", "gelu", "sigmoid"}
_MODEL_TYPES = {"micro_gru", "micro_tcn", "gru", "tcn"}
_OPTIMIZERS = {"adam", "adamw", "sgd", "rmsprop"}
_LOSSES = {"mse", "mae", "huber"}
_SYSTEM_TYPES = {"Traditional", "TemporalSolver"}


@dataclasses.dataclass
class CommonConfig:
    """config.rs CommonConfig: timing geometry + global switches."""

    horizon_ms: float = 500.0
    window_ms: float = 128.0
    sample_rate_hz: float = 2000.0
    features: List[str] = dataclasses.field(default_factory=lambda: ["x", "y", "vx", "vy"])
    quantize: bool = True
    random_seed: int = 42
    verbose: bool = False

    @property
    def window_steps(self) -> int:
        return max(int(round(self.window_ms * self.sample_rate_hz / 1000.0)), 1)

    @property
    def horizon_steps(self) -> int:
        return max(int(round(self.horizon_ms * self.sample_rate_hz / 1000.0)), 1)


@dataclasses.dataclass
class ModelConfig:
    model_type: str = "micro_gru"
    hidden_size: int = 32
    num_layers: int = 1
    dropout: float = 0.1
    residual: bool = True
    activation: str = "tanh"
    layer_norm: bool = False

    @property
    def arch(self) -> str:
        """SystemA arch string ('gru' | 'tcn')."""
        return "tcn" if "tcn" in self.model_type else "gru"


@dataclasses.dataclass
class TrainingConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 15
    patience: int = 5
    val_frequency: int = 1
    grad_clip: float = 1.0
    weight_decay: float = 1e-4
    smoothness_weight: float = 0.1
    checkpoint_frequency: int = 5
    loss: str = "mse"  # losses.py registry key


@dataclasses.dataclass
class InferenceConfig:
    target_latency_ms: float = 0.9
    enable_simd: bool = True
    num_threads: int = 1
    pin_memory: bool = True
    cpu_affinity: Optional[int] = None
    batch_size: int = 1
    # lib.rs:63-74 per-stage budgets (ms)
    budget_ingest_ms: float = 0.10
    budget_prior_ms: float = 0.10
    budget_network_ms: float = 0.30
    budget_gate_ms: float = 0.20
    budget_actuation_ms: float = 0.10


@dataclasses.dataclass
class KalmanConfig:
    """config.rs KalmanConfig (the System-B prior)."""

    process_noise: float = 0.01
    measurement_noise: float = 0.1
    initial_uncertainty: float = 1.0
    transition_model: str = "constant_velocity"
    update_frequency: float = 2000.0


@dataclasses.dataclass
class SolverGateConfig:
    algorithm: str = "neumann"
    epsilon: float = 0.02
    budget: int = 200_000
    max_cert_error: float = 0.02
    fallback_strategy: str = "kalman_only"


@dataclasses.dataclass
class ActiveSelectionConfig:
    k: int = 15
    pagerank_eps: float = 0.03
    samples_per_epoch: int = 1000
    error_weight: float = 0.8
    diversity_weight: float = 0.2


@dataclasses.dataclass
class SystemConfig:
    """config.rs SystemConfig enum: Traditional | TemporalSolver(+subconfigs)."""

    type: str = "Traditional"
    prior: Optional[KalmanConfig] = None
    solver_gate: Optional[SolverGateConfig] = None
    active_selection: Optional[ActiveSelectionConfig] = None


@dataclasses.dataclass
class Config:
    common: CommonConfig = dataclasses.field(default_factory=CommonConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    inference: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)

    # ------------------------------------------------------------ validation
    def validate(self) -> "Config":
        """config.rs validate(): structured E008 errors, not asserts."""
        c, m, t, i, s = self.common, self.model, self.training, self.inference, self.system

        def bad(msg, **details):
            raise InvalidParametersError(f"config: {msg}", details or None)

        if c.sample_rate_hz <= 0:
            bad("sample_rate_hz must be > 0", value=c.sample_rate_hz)
        if c.window_ms <= 0 or c.horizon_ms <= 0:
            bad("window_ms and horizon_ms must be > 0")
        if not c.features:
            bad("features list is empty")
        if m.model_type not in _MODEL_TYPES:
            bad(f"unknown model_type '{m.model_type}'", allowed=sorted(_MODEL_TYPES))
        if m.hidden_size <= 0 or m.num_layers <= 0:
            bad("hidden_size and num_layers must be >= 1")
        if not (0.0 <= m.dropout < 1.0):
            bad("dropout must be in [0, 1)", value=m.dropout)
        if m.activation not in _ACTIVATIONS:
            bad(f"unknown activation '{m.activation}'", allowed=sorted(_ACTIVATIONS))
        if t.optimizer not in _OPTIMIZERS:
            bad(f"unknown optimizer '{t.optimizer}'", allowed=sorted(_OPTIMIZERS))
        if t.loss not in _LOSSES:
            bad(f"unknown loss '{t.loss}'", allowed=sorted(_LOSSES))
        if t.learning_rate <= 0 or t.batch_size <= 0 or t.epochs <= 0:
            bad("learning_rate, batch_size, epochs must be > 0")
        if t.grad_clip < 0 or t.weight_decay < 0 or t.smoothness_weight < 0:
            bad("grad_clip, weight_decay, smoothness_weight must be >= 0")
        if i.target_latency_ms <= 0 or i.batch_size <= 0:
            bad("target_latency_ms and inference batch_size must be > 0")
        if s.type not in _SYSTEM_TYPES:
            bad(f"unknown system type '{s.type}'", allowed=sorted(_SYSTEM_TYPES))
        if s.type == "TemporalSolver":
            if s.solver_gate is None:
                bad("TemporalSolver system requires a solver_gate section")
            if s.solver_gate.epsilon <= 0 or s.solver_gate.max_cert_error <= 0:
                bad("solver_gate epsilon / max_cert_error must be > 0")
        return self

    # ------------------------------------------------------------- dict I/O
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # system sub-sections: drop unset optionals like the reference's
        # untagged-enum serialization
        d["system"] = {k: v for k, v in d["system"].items() if v is not None}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(klass, section, sub=None):
            if section is None:
                return klass()
            if not isinstance(section, dict):
                raise InvalidParametersError(
                    f"config section for {klass.__name__} must be a mapping")
            fields = {f.name for f in dataclasses.fields(klass)}
            unknown = set(section) - fields
            if unknown:
                raise InvalidParametersError(
                    f"unknown config keys in {klass.__name__}: {sorted(unknown)}")
            kw = dict(section)
            for name, sk in (sub or {}).items():
                if name in kw and kw[name] is not None:
                    kw[name] = build(sk, kw[name])
            return klass(**kw)

        return cls(
            common=build(CommonConfig, d.get("common")),
            model=build(ModelConfig, d.get("model")),
            training=build(TrainingConfig, d.get("training")),
            inference=build(InferenceConfig, d.get("inference")),
            system=build(SystemConfig, d.get("system"), sub={
                "prior": KalmanConfig,
                "solver_gate": SolverGateConfig,
                "active_selection": ActiveSelectionConfig,
            }),
        ).validate()

    # ------------------------------------------------------------- file I/O
    @classmethod
    def load(cls, path: str) -> "Config":
        """Load + validate a YAML or JSON config file (by extension)."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError as e:  # pragma: no cover - baked into this image
                raise InvalidParametersError(
                    "YAML config requires pyyaml; use a .json config instead"
                ) from e
            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        return cls.from_dict(data or {})

    def save(self, path: str):
        d = self.to_dict()
        with open(path, "w") as f:
            if path.endswith((".yaml", ".yml")):
                import yaml

                yaml.safe_dump(d, f, sort_keys=False)
            else:
                json.dump(d, f, indent=2)


def build_system(config: Config, features: int = 1, seed: Optional[int] = None):
    """Instantiate the configured system (config-driven model factory).

    Returns a SystemA flax module (Traditional) or a SystemB composite
    (TemporalSolver: Kalman prior + residual net + solver gate), mirroring
    the reference's per-system constructors (system_a.rs / system_b.rs)."""
    from .kalman import KalmanFilter
    from .solver_gate import GateConfig, SolverGate
    from .temporal_net import SystemA, SystemB

    seed = config.common.random_seed if seed is None else seed
    horizon = 1  # value at horizon_ms ahead per feature column (see trainer)
    if config.system.type == "Traditional":
        return SystemA(hidden=config.model.hidden_size, arch=config.model.arch,
                       horizon=horizon)
    sysb = SystemB.create(
        window=config.common.window_steps, features=features,
        hidden=config.model.hidden_size, horizon=horizon, seed=seed,
    )
    prior = config.system.prior or KalmanConfig()
    sysb.kalman = KalmanFilter.constant_velocity(
        dt=1.0 / max(prior.update_frequency, 1e-9),
        q=prior.process_noise, r=prior.measurement_noise,
    )
    gate_cfg = config.system.solver_gate or SolverGateConfig()
    sysb.gate = SolverGate(
        dim=max(horizon, 2),
        config=GateConfig(tolerance=gate_cfg.max_cert_error,
                          max_iterations=max(int(gate_cfg.budget) // 25_000, 2)),
    )
    return sysb
