"""Kalman filter — the System-B prior.

Reference: /root/reference/neural-network-implementation/src/solvers/kalman.rs:19-279
(predict/update/multi-horizon forecast over a linear-Gaussian state model).

Device re-design: a functional filter whose sequence pass is one ``lax.scan``
(the reference steps a mutable struct per tick); batched across series via
``vmap``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KalmanState:
    x: jax.Array  # (d,) state mean
    P: jax.Array  # (d, d) state covariance

    def tree_flatten(self):
        return (self.x, self.P), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass
class KalmanFilter:
    """x' = F x + w (Q);  z = H x + v (R)."""

    F: jax.Array
    H: jax.Array
    Q: jax.Array
    R: jax.Array

    @classmethod
    def constant_velocity(cls, dt: float = 1.0, q: float = 1e-3, r: float = 1e-2):
        """The reference's default 2-state (position, velocity) model."""
        F = jnp.array([[1.0, dt], [0.0, 1.0]])
        H = jnp.array([[1.0, 0.0]])
        Q = q * jnp.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]])
        R = jnp.array([[r]])
        return cls(F, H, Q, R)

    def init(self, x0=None) -> KalmanState:
        d = self.F.shape[0]
        x = jnp.zeros(d) if x0 is None else jnp.asarray(x0)
        return KalmanState(x, jnp.eye(d))

    def predict(self, s: KalmanState) -> KalmanState:
        return KalmanState(self.F @ s.x, self.F @ s.P @ self.F.T + self.Q)

    def update(self, s: KalmanState, z) -> KalmanState:
        z = jnp.atleast_1d(z)
        y = z - self.H @ s.x
        S = self.H @ s.P @ self.H.T + self.R
        K = s.P @ self.H.T @ jnp.linalg.inv(S)
        x = s.x + K @ y
        d = self.F.shape[0]
        P = (jnp.eye(d) - K @ self.H) @ s.P
        return KalmanState(x, P)

    def step(self, s: KalmanState, z) -> tuple[KalmanState, jax.Array]:
        s = self.update(self.predict(s), z)
        return s, self.H @ s.x

    def filter_sequence(self, zs, x0=None):
        """One lax.scan over the measurement sequence.  zs: (T, m)."""
        s0 = self.init(x0)

        def body(s, z):
            s, pred = self.step(s, z)
            return s, pred

        sT, preds = jax.lax.scan(body, s0, jnp.atleast_2d(zs))
        return sT, preds

    def forecast(self, s: KalmanState, horizon: int):
        """Multi-horizon open-loop forecast (kalman.rs horizon API)."""

        def body(state, _):
            state = self.predict(state)
            return state, self.H @ state.x

        _, preds = jax.lax.scan(body, s, None, length=horizon)
        return preds
