"""Training loop for the temporal micro-nets.

Reference: /root/reference/neural-network-implementation/src/training/
(Trainer + optimizer registry mod.rs/optimizer.rs, losses.rs, callbacks.rs).

Device design: optax optimizer chain (grad-clip -> optimizer -> weight decay),
one jitted train_step (donated state), data parallel over the mesh ``batch``
axis — batches are placed with a NamedSharding and GSPMD partitions the step;
gradients reduce over the mesh automatically.  Losses come from the
losses.py registry; per-epoch control flow (validation cadence, early
stopping, checkpoints) is host-side via callbacks.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
import optax

from .temporal_net import SystemA


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: object
    step: int = 0


def make_optimizer(name: str = "adam", learning_rate: float = 1e-3,
                   grad_clip: float = 0.0, weight_decay: float = 0.0):
    """Optimizer registry (reference training/optimizer.rs): a gradient
    transform chain clip -> {adam,adamw,sgd,rmsprop} -> decoupled decay."""
    from ..errors import InvalidParametersError

    makers = {
        "adam": lambda: optax.adam(learning_rate),
        "adamw": lambda: optax.adamw(learning_rate, weight_decay=weight_decay),
        "sgd": lambda: optax.sgd(learning_rate, momentum=0.9),
        "rmsprop": lambda: optax.rmsprop(learning_rate),
    }
    if name not in makers:
        raise InvalidParametersError(
            f"unknown optimizer '{name}'", {"allowed": sorted(makers)})
    chain = []
    if grad_clip and grad_clip > 0:
        chain.append(optax.clip_by_global_norm(grad_clip))
    chain.append(makers[name]())
    if weight_decay and weight_decay > 0 and name != "adamw":
        # decoupled weight decay: w -= lr_scale * wd * w
        chain.append(optax.add_decayed_weights(-weight_decay * learning_rate))
    return optax.chain(*chain)


class Trainer:
    def __init__(self, model: SystemA, window: int, features: int = 1,
                 learning_rate: float = 1e-3, seed: int = 0,
                 training_config=None, loss=None):
        """``training_config``: models.config.TrainingConfig — optimizer,
        grad_clip, weight_decay, loss + smoothness override the scalar args."""
        self.model = model
        self.config = training_config
        if training_config is not None:
            self.tx = make_optimizer(
                training_config.optimizer, training_config.learning_rate,
                training_config.grad_clip, training_config.weight_decay)
            if loss is None:
                from .losses import get_loss

                loss = get_loss(training_config.loss,
                                smoothness_weight=training_config.smoothness_weight)
        else:
            self.tx = optax.adam(learning_rate)
        if loss is None:
            loss = lambda pred, target: jnp.mean((pred - target) ** 2)  # noqa: E731
        params = model.init(jax.random.PRNGKey(seed), jnp.zeros((window, features)))
        self.state = TrainState(params, self.tx.init(params))

        def loss_fn(params, windows, targets):
            preds = jax.vmap(lambda w: model.apply(params, w))(windows)
            return loss(preds, targets)

        def train_step(params, opt_state, windows, targets):
            val, grads = jax.value_and_grad(loss_fn)(params, windows, targets)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, val

        self._train_step = jax.jit(train_step, donate_argnums=(0, 1))
        self._loss_fn = jax.jit(loss_fn)

    @classmethod
    def from_config(cls, config, features: int = 1, window: Optional[int] = None):
        """Build model + trainer from a full models.config.Config (the
        reference's config-file-driven training entry, src/main.rs)."""
        from .config import build_system

        window = config.common.window_steps if window is None else window
        model = build_system(config, features=features)
        if not isinstance(model, SystemA):
            from ..errors import InvalidParametersError

            raise InvalidParametersError(
                "Trainer.from_config trains System A nets; train System B's "
                "residual net via its own trainer path (models.temporal_net)")
        return cls(model, window=window, features=features,
                   seed=config.common.random_seed, training_config=config.training)

    def fit(self, windows: np.ndarray, targets: np.ndarray, epochs: int = 10,
            batch_size: int = 64, mesh=None, seed: int = 0,
            validation_data=None, callbacks=None, verbose: bool = False) -> list:
        """windows: (N, T, F); targets: (N, horizon).

        Config-driven runs (training_config set) take epochs/batch_size from
        the config and add patience-based early stopping on val loss
        (callbacks.rs semantics).  Returns per-epoch train losses; richer
        logs via a History callback."""
        cfg = self.config
        if cfg is not None:
            epochs = cfg.epochs if epochs == 10 else epochs
            batch_size = cfg.batch_size if batch_size == 64 else batch_size
        callbacks = list(callbacks or [])
        if cfg is not None and cfg.patience > 0 and validation_data is not None:
            from .callbacks import EarlyStopping

            callbacks.append(EarlyStopping(patience=cfg.patience))
        val_frequency = cfg.val_frequency if cfg is not None else 1

        windows = jnp.asarray(np.asarray(windows, dtype=np.float32))
        targets = jnp.asarray(np.asarray(targets, dtype=np.float32))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import BATCH

            sh = NamedSharding(mesh, P(BATCH))
            windows = jax.device_put(windows, sh)
            targets = jax.device_put(targets, sh)

        n = windows.shape[0]
        batch_size = min(batch_size, n)
        rng = np.random.default_rng(seed)
        history = []
        for cb in callbacks:
            cb.on_train_begin(self)
        for epoch in range(epochs):
            order = rng.permutation(n)
            epoch_loss = 0.0
            batches = 0
            for start in range(0, n - batch_size + 1, batch_size):
                idx = jnp.asarray(order[start : start + batch_size])
                bw, bt = windows[idx], targets[idx]
                self.state.params, self.state.opt_state, loss = self._train_step(
                    self.state.params, self.state.opt_state, bw, bt
                )
                self.state.step += 1
                epoch_loss += float(loss)
                batches += 1
            train_loss = epoch_loss / max(batches, 1)
            history.append(train_loss)
            logs = {"loss": train_loss}
            if validation_data is not None and (epoch + 1) % max(val_frequency, 1) == 0:
                logs["val_loss"] = self.evaluate(*validation_data)
            if verbose:
                print(f"epoch {epoch + 1}/{epochs}: " +
                      " ".join(f"{k}={v:.6f}" for k, v in logs.items()))
            stop = any(cb.on_epoch_end(epoch, logs, self) for cb in callbacks)
            if stop:
                break
        for cb in callbacks:
            cb.on_train_end(self)
        return history

    def evaluate(self, windows, targets) -> float:
        return float(
            self._loss_fn(
                self.state.params,
                jnp.asarray(np.asarray(windows, dtype=np.float32)),
                jnp.asarray(np.asarray(targets, dtype=np.float32)),
            )
        )

    def predict(self, window) -> np.ndarray:
        return np.asarray(
            self.model.apply(self.state.params, jnp.asarray(np.asarray(window, dtype=np.float32)))
        )

    def save(self, path: str):
        """Persist parameters (flax msgpack serialization)."""
        from flax import serialization

        with open(path, "wb") as f:
            f.write(serialization.to_bytes(self.state.params))

    def load(self, path: str):
        from flax import serialization

        with open(path, "rb") as f:
            self.state.params = serialization.from_bytes(self.state.params, f.read())


def train_system_b(system, windows, targets, config, validation_data=None,
                   seed: int = 0, verbose: bool = False) -> list:
    """System-B training: residual learning on the Kalman prior with
    PageRank active sample selection.

    Reference semantics (training/mod.rs:246-340 train_system_b): epochs 0-1
    train on the full set; from epoch 2 each epoch trains on the
    ``samples_per_epoch`` samples scoring highest on
    error_weight * normalized_residual_error + diversity_weight * pagerank
    (ActiveSelectionConfig, config.rs:162); early stopping on val loss; the
    gate pass rate is tracked per epoch.

    Device design: priors for ALL windows come from one vmapped Kalman scan;
    per-sample errors for the selection step are one jitted batch eval —
    active selection costs two device dispatches per epoch, not a host loop.
    Returns per-epoch log dicts; ``system.params`` is updated in place."""
    import functools

    from .config import ActiveSelectionConfig
    from .losses import get_loss

    net, kalman = system.net, system.kalman
    tcfg = config.training
    acfg = config.system.active_selection or ActiveSelectionConfig()
    horizon = net.horizon

    W = np.asarray(windows, dtype=np.float32)      # (N, T, F)
    Y = np.asarray(targets, dtype=np.float32)      # (N, horizon)
    N = W.shape[0]

    @jax.jit
    def priors_of(Wd):
        def one(w):
            sT, _ = kalman.filter_sequence(w[:, :1])
            return kalman.forecast(sT, horizon).reshape(-1)

        return jax.vmap(one)(Wd)

    W_dev = jnp.asarray(W)
    P_all = priors_of(W_dev)                        # (N, horizon) priors
    R_all = jnp.asarray(Y) - P_all                  # residual targets
    F_all = W_dev.reshape(N, -1)

    tx = make_optimizer(tcfg.optimizer, tcfg.learning_rate,
                        tcfg.grad_clip, tcfg.weight_decay)
    base_loss = get_loss(tcfg.loss, smoothness_weight=tcfg.smoothness_weight)
    params = system.params
    opt_state = tx.init(params)

    def loss_fn(params, wf, pr, rt):
        preds = jax.vmap(lambda a, b: net.apply(params, a, b))(wf, pr)
        return base_loss(preds, rt)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, wf, pr, rt):
        val, grads = jax.value_and_grad(loss_fn)(params, wf, pr, rt)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, val

    @jax.jit
    def sample_errors(params, wf, pr, rt):
        preds = jax.vmap(lambda a, b: net.apply(params, a, b))(wf, pr)
        return jnp.mean((preds - rt) ** 2, axis=1)

    # diversity scores: PageRank over the window-feature kNN graph, computed
    # once (the graph doesn't change across epochs)
    from .pagerank_selector import select_samples

    div = np.asarray(select_samples(W.reshape(N, -1), num_select=1,
                                    k=min(acfg.k, max(N - 1, 1)))["allScores"])
    div = div / max(float(div.max()), 1e-30)

    if validation_data is not None:
        Wv = jnp.asarray(np.asarray(validation_data[0], np.float32))
        Pv = priors_of(Wv)
        Rv = jnp.asarray(np.asarray(validation_data[1], np.float32)) - Pv
        Fv = Wv.reshape(Wv.shape[0], -1)

    rng = np.random.default_rng(seed)
    batch = min(tcfg.batch_size, N)
    history = []
    best_val = float("inf")
    patience = 0
    for epoch in range(tcfg.epochs):
        if epoch < 2:
            pool = np.arange(N)  # first 2 epochs: full data (mod.rs:261-266)
        else:
            err = np.asarray(sample_errors(params, F_all, P_all, R_all))
            e_n = err / max(float(err.max()), 1e-30)
            score = acfg.error_weight * e_n + acfg.diversity_weight * div
            pool = np.argsort(-score)[: min(acfg.samples_per_epoch, N)]
        order = rng.permutation(pool)
        total, nb = 0.0, 0
        for s in range(0, len(order) - batch + 1, batch):
            idx = jnp.asarray(order[s : s + batch])
            params, opt_state, loss = train_step(
                params, opt_state, F_all[idx], P_all[idx], R_all[idx])
            total += float(loss)
            nb += 1
        logs = {"epoch": epoch, "loss": total / max(nb, 1),
                "samples": int(len(order))}
        if validation_data is not None:
            logs["val_loss"] = float(loss_fn(params, Fv, Pv, Rv))
            if logs["val_loss"] < best_val:
                best_val, patience = logs["val_loss"], 0
            else:
                patience += 1
        # gate pass rate on this epoch's predictions (SystemBMetrics)
        probe = jnp.asarray(rng.choice(N, size=min(64, N), replace=False))
        preds = np.asarray(jax.vmap(lambda a, b: net.apply(params, a, b))(
            F_all[probe], P_all[probe])) + np.asarray(P_all[probe])
        pad = np.zeros((preds.shape[0], max(0, 2 - horizon)))
        _, passed = system.gate.verify(np.concatenate([preds, pad], axis=1))
        logs["gate_pass_rate"] = float(passed.mean())
        history.append(logs)
        if verbose:
            print(" ".join(f"{k}={v}" for k, v in logs.items()))
        if validation_data is not None and tcfg.patience > 0 and patience >= tcfg.patience:
            break
    system.params = params
    return history


def load_series_csv(path: str, column: int | str = -1, skip_header: bool = True) -> np.ndarray:
    """CSV time-series loader (reference: neural-network-implementation
    src/data CSV loader).  Returns one column as a float32 series."""
    import csv

    with open(path) as f:
        reader = csv.reader(f)
        rows = list(reader)
    if not rows:
        return np.zeros(0, dtype=np.float32)
    header = rows[0]
    if isinstance(column, str):
        idx = header.index(column)
        rows = rows[1:]
    else:
        idx = column if column >= 0 else len(rows[-1]) + column
        if skip_header:
            try:
                float(rows[0][idx])
            except (ValueError, IndexError):
                rows = rows[1:]
    return np.asarray([float(r[idx]) for r in rows if r], dtype=np.float32)


def make_windows(series: np.ndarray, window: int, horizon: int = 1):
    """Sliding-window dataset from a 1-D series (data/ loader equivalent)."""
    series = np.asarray(series, dtype=np.float32).reshape(-1)
    N = series.size - window - horizon + 1
    windows = np.stack([series[i : i + window] for i in range(N)])[:, :, None]
    targets = np.stack([series[i + window : i + window + horizon] for i in range(N)])
    return windows, targets
