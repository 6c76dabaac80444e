"""Temporal prediction micro-nets: System A (GRU/TCN) and System B
(Kalman prior + residual net + solver gate).

Reference: /root/reference/neural-network-implementation/src/models/
(layers.rs GRU/TCN/Dense, system_a.rs:548, system_b.rs:479) and src/lib.rs
System A/B definitions; latency budget P99.9 <= 0.90ms/tick with gate <=
0.20ms (lib.rs:63-74).

Device re-design: flax.linen modules; the sequence loop is lax.scan inside the
GRU; training steps are jitted and data-parallel over the mesh ``batch``
axis (see trainer.py).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
import flax.linen as nn


class GRUBlock(nn.Module):
    """GRU encoder over a window; returns the final hidden state."""

    hidden: int = 32

    @nn.compact
    def __call__(self, x):  # x: (T, F)
        rnn = nn.RNN(nn.GRUCell(features=self.hidden))
        ys = rnn(x[None, :, :])  # (1, T, H); nn.RNN runs the scan flax-safely
        return ys[0, -1]


class TCNBlock(nn.Module):
    """Dilated causal Conv1D stack (layers.rs TCN)."""

    channels: int = 32
    kernel: int = 3
    dilations: Sequence[int] = (1, 2, 4)

    @nn.compact
    def __call__(self, x):  # x: (T, F)
        h = x
        for d in self.dilations:
            pad = (self.kernel - 1) * d
            h = jnp.pad(h, ((pad, 0), (0, 0)))  # causal left pad
            h = nn.Conv(features=self.channels, kernel_size=(self.kernel,),
                        kernel_dilation=(d,), padding="VALID")(h)
            h = nn.relu(h)
        return h[-1]  # last step features


class SystemA(nn.Module):
    """GRU/TCN micro-net predicting the next value (system_a.rs)."""

    hidden: int = 32
    arch: str = "gru"  # 'gru' | 'tcn'
    horizon: int = 1

    @nn.compact
    def __call__(self, window):  # (T, F) -> (horizon,)
        enc = GRUBlock(self.hidden)(window) if self.arch == "gru" else TCNBlock(self.hidden)(window)
        h = nn.relu(nn.Dense(self.hidden)(enc))
        return nn.Dense(self.horizon)(h)


class ResidualNet(nn.Module):
    """Small MLP predicting the residual on top of the Kalman prior."""

    hidden: int = 32
    horizon: int = 1

    @nn.compact
    def __call__(self, window_feats, prior):  # (T*F,), (horizon,)
        h = jnp.concatenate([window_feats, prior])
        h = nn.relu(nn.Dense(self.hidden)(h))
        h = nn.relu(nn.Dense(self.hidden)(h))
        return nn.Dense(self.horizon)(h)


@dataclasses.dataclass
class SystemB:
    """Kalman prior + residual net + solver gate (system_b.rs:479).

    predict(window) = gate(prior + residual_net(window, prior), fallback=prior)
    """

    net: ResidualNet
    params: dict
    kalman: "object"
    gate: "object"

    @classmethod
    def create(cls, window: int, features: int = 1, hidden: int = 32, horizon: int = 1, seed: int = 0):
        from .kalman import KalmanFilter
        from .solver_gate import GateConfig, SolverGate

        net = ResidualNet(hidden=hidden, horizon=horizon)
        params = net.init(
            jax.random.PRNGKey(seed),
            jnp.zeros(window * features), jnp.zeros(horizon),
        )
        return cls(
            net=net,
            params=params,
            kalman=KalmanFilter.constant_velocity(),
            gate=SolverGate(dim=max(horizon, 2), config=GateConfig()),
        )

    def prior(self, window: np.ndarray, horizon: int) -> np.ndarray:
        """Kalman filtered over the window, then open-loop forecast."""
        sT, _ = self.kalman.filter_sequence(jnp.asarray(window[:, :1]))
        return np.asarray(self.kalman.forecast(sT, horizon)).reshape(-1)

    def predict(self, window: np.ndarray) -> np.ndarray:
        window = np.atleast_2d(np.asarray(window, dtype=np.float32))
        horizon = self.net.horizon
        prior = self.prior(window, horizon)
        resid = self.net.apply(
            self.params, jnp.asarray(window.reshape(-1)), jnp.asarray(prior, jnp.float32)
        )
        raw = prior + np.asarray(resid)
        pad = np.zeros(max(0, 2 - horizon))
        gated = self.gate.gate(np.concatenate([raw, pad]), np.concatenate([prior, pad]))
        return gated[:horizon]
