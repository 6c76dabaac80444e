"""Models layer: Kalman, solver gate, PageRank selection, System A/B training.

Reference behaviors: neural-network-implementation/src/solvers/{kalman,
solver_gate,pagerank_selector}.rs and models/system_{a,b}.rs.
"""
import numpy as np
import pytest

import jax.numpy as jnp

# models/ needs flax, which the solver path does not; machines without it
# (the GPU host) skip this module instead of failing to collect it
pytest.importorskip("flax")

from sublinear_tpu.models import (  # noqa: E402
    KalmanFilter,
    SolverGate,
    GateConfig,
    SystemA,
    SystemB,
    Trainer,
    make_windows,
    select_samples,
    similarity_graph,
)


def test_kalman_tracks_constant_signal():
    kf = KalmanFilter.constant_velocity(q=1e-4, r=1e-2)
    zs = np.full((50, 1), 3.0)
    sT, preds = kf.filter_sequence(zs)
    assert abs(float(preds[-1][0]) - 3.0) < 0.05
    fc = kf.forecast(sT, 5)
    assert np.allclose(np.asarray(fc), 3.0, atol=0.1)


def test_kalman_tracks_linear_trend():
    kf = KalmanFilter.constant_velocity(q=1e-3, r=1e-3)
    t = np.arange(100, dtype=np.float64)
    zs = (0.5 * t)[:, None]
    sT, preds = kf.filter_sequence(zs)
    fc = np.asarray(kf.forecast(sT, 3)).reshape(-1)
    expect = 0.5 * np.array([100, 101, 102])
    np.testing.assert_allclose(fc, expect, atol=0.5)


def test_solver_gate_passes_good_and_stats():
    gate = SolverGate(dim=8, config=GateConfig(tolerance=1e-2, max_iterations=30))
    x = np.random.default_rng(0).normal(size=(5, 8))
    err, passed = gate.verify(x)
    assert passed.all(), f"certificate errors {err}"
    assert gate.stats.total == 5 and gate.stats.pass_rate == 1.0


def test_solver_gate_rejects_with_tiny_budget():
    gate = SolverGate(dim=8, config=GateConfig(tolerance=1e-8, max_iterations=1))
    x = np.random.default_rng(1).normal(size=(4, 8))
    err, passed = gate.verify(x)
    assert not passed.all()
    fallback = np.zeros((4, 8))
    out = gate.gate(x, fallback)
    assert out.shape == (4, 8)


def test_pagerank_selector_prefers_cluster_cores():
    rng = np.random.default_rng(2)
    cluster = rng.normal(0, 0.1, size=(20, 4))
    # isolated, mutually-distant outliers: only teleport mass reaches them
    outliers = np.array([[50.0] * 4, [-70.0] * 4, [120.0, -120.0, 90.0, -90.0]])
    feats = np.vstack([cluster, outliers])
    out = select_samples(feats, num_select=5, k=4)
    assert len(out["selected"]) == 5
    assert set(out["selected"]) <= set(range(20))  # outliers not selected
    g = similarity_graph(feats, k=4)
    assert g.shape == (23, 23)


def test_system_a_trains_on_sine():
    t = np.arange(400, dtype=np.float32)
    series = np.sin(2 * np.pi * t / 25)
    windows, targets = make_windows(series, window=16, horizon=1)
    model = SystemA(hidden=16, arch="gru", horizon=1)
    trainer = Trainer(model, window=16, features=1, learning_rate=5e-3)
    history = trainer.fit(windows[:256], targets[:256], epochs=6, batch_size=64)
    assert history[-1] < history[0]
    assert history[-1] < 0.1


def test_system_a_tcn_forward():
    model = SystemA(hidden=8, arch="tcn", horizon=2)
    trainer = Trainer(model, window=12, features=1)
    pred = trainer.predict(np.zeros((12, 1), dtype=np.float32))
    assert pred.shape == (2,)


def test_system_b_gated_prediction():
    sysb = SystemB.create(window=16, features=1, hidden=8, horizon=1)
    window = np.linspace(0, 1.5, 16)[:, None].astype(np.float32)
    pred = sysb.predict(window)
    assert pred.shape == (1,)
    assert np.isfinite(pred).all()
    # gate tracked the verification
    assert sysb.gate.stats.total >= 1


def test_quantization_roundtrip_schemes():
    from sublinear_tpu.models import quantization_error, quantize_tree

    model = SystemA(hidden=16, arch="gru", horizon=1)
    trainer = Trainer(model, window=16, features=1)
    params = trainer.state.params["params"]
    errors = {}
    for scheme in ["int8", "int4", "binary"]:
        qp = quantize_tree(params, scheme=scheme)
        info = quantization_error(params, qp)
        errors[scheme] = info["relative_l2_error"]
        assert info["size_bytes"] > 0
    # error ordering: int8 < int4 < binary; int8 must be tight
    assert errors["int8"] < 0.01
    assert errors["int8"] < errors["int4"] < errors["binary"]


def test_quantized_inference_matches_f32():
    from sublinear_tpu.models import quantize_tree, quantized_apply

    t = np.arange(400, dtype=np.float32)
    series = np.sin(2 * np.pi * t / 25)
    windows, targets = make_windows(series, window=16, horizon=1)
    model = SystemA(hidden=16, arch="gru", horizon=1)
    trainer = Trainer(model, window=16, features=1, learning_rate=5e-3)
    trainer.fit(windows[:256], targets[:256], epochs=4, batch_size=64)

    w = np.asarray(windows[300], dtype=np.float32)
    full = np.asarray(trainer.predict(w))
    qp = quantize_tree(trainer.state.params["params"], scheme="int8")
    quant = np.asarray(quantized_apply(model.apply, qp, jnp.asarray(w)))
    assert quant.shape == full.shape
    np.testing.assert_allclose(quant, full, atol=0.05)


def test_quantize_rejects_bad_scheme_and_empty():
    from sublinear_tpu.errors import InvalidParametersError
    from sublinear_tpu.models import quantize_tree

    with pytest.raises(InvalidParametersError):
        quantize_tree({"w": np.ones((4, 4), np.float32)}, scheme="int2")
    with pytest.raises(InvalidParametersError):
        quantize_tree({}, scheme="int8")


# -------------------------------------------------------------- round 3:
# config system / losses / callbacks / inference latency (VERDICT r2 item 6)

def test_config_yaml_roundtrip_and_validation(tmp_path):
    from sublinear_tpu.errors import InvalidParametersError
    from sublinear_tpu.models import Config

    cfg = Config.load("configs/B_temporal_solver.yaml")
    assert cfg.system.type == "TemporalSolver"
    assert cfg.system.solver_gate.algorithm == "neumann"
    assert cfg.common.window_steps == 256  # 128 ms @ 2000 Hz
    assert cfg.model.arch == "gru"

    p = tmp_path / "roundtrip.yaml"
    cfg.save(str(p))
    cfg2 = Config.load(str(p))
    assert cfg2.to_dict() == cfg.to_dict()

    # JSON path + unknown-key / bad-value validation (E008)
    j = tmp_path / "c.json"
    j.write_text('{"model": {"hidden_size": 8}}')
    assert Config.load(str(j)).model.hidden_size == 8
    with pytest.raises(InvalidParametersError):
        Config.from_dict({"model": {"not_a_field": 1}})
    with pytest.raises(InvalidParametersError):
        Config.from_dict({"training": {"optimizer": "adagrad9000"}})
    with pytest.raises(InvalidParametersError):
        Config.from_dict({"system": {"type": "TemporalSolver"}})  # gate required


def test_build_system_from_config():
    from sublinear_tpu.models import Config, SystemA, SystemB, build_system

    a = build_system(Config.load("configs/A_traditional.yaml"))
    assert isinstance(a, SystemA) and a.hidden == 32
    cfg_b = Config.load("configs/B_temporal_solver.yaml")
    b = build_system(cfg_b)
    assert isinstance(b, SystemB)
    # residual net is sized for the configured window geometry
    out = b.predict(np.zeros((cfg_b.common.window_steps, 1), np.float32))
    assert out.shape == (1,) and np.isfinite(out).all()


def test_losses_registry_and_smoothness():
    from sublinear_tpu.models import get_loss

    p = jnp.asarray([[1.0, 2.0]])
    t = jnp.asarray([[1.5, 1.5]])
    assert float(get_loss("mse")(p, t)) == pytest.approx(0.25)
    assert float(get_loss("mae")(p, t)) == pytest.approx(0.5)
    # huber == mse/2 inside delta
    assert float(get_loss("huber")(p, t)) == pytest.approx(0.125)
    # smoothness adds a magnitude penalty even at zero error
    base = get_loss("mse")(p, p)
    pen = get_loss("mse", smoothness_weight=0.1)(p, p)
    assert float(pen) > float(base)
    from sublinear_tpu.errors import InvalidParametersError
    with pytest.raises(InvalidParametersError):
        get_loss("nope")


def test_trainer_config_driven_with_callbacks(tmp_path):
    from sublinear_tpu.models import (
        Config, EarlyStopping, History, ModelCheckpoint, Trainer,
    )

    cfg = Config.from_dict({
        "common": {"window_ms": 8, "sample_rate_hz": 1000, "features": ["x"]},
        "training": {"epochs": 30, "batch_size": 32, "patience": 2,
                     "grad_clip": 1.0, "weight_decay": 1e-4,
                     "optimizer": "adamw", "loss": "mse",
                     "checkpoint_frequency": 2},
    })
    series = np.sin(np.arange(400, dtype=np.float32) / 9.0)
    windows, targets = make_windows(series, window=cfg.common.window_steps, horizon=1)
    trainer = Trainer.from_config(cfg)
    hist_cb = History()
    ckpt = ModelCheckpoint(str(tmp_path), frequency=cfg.training.checkpoint_frequency)
    es = EarlyStopping(patience=cfg.training.patience, min_delta=0.0)
    history = trainer.fit(
        windows[:256], targets[:256],
        validation_data=(windows[256:320], targets[256:320]),
        callbacks=[hist_cb, ckpt, es],
    )
    # trained at all, logged val losses, early stopping bounded the run
    assert len(history) <= 30 and history[-1] < history[0]
    assert any("val_loss" in e for e in hist_cb.epochs)
    assert ckpt.best_path is not None
    # checkpoint loads back
    trainer.load(ckpt.best_path)


def test_optimizer_registry():
    from sublinear_tpu.errors import InvalidParametersError
    from sublinear_tpu.models import make_optimizer

    for name in ("adam", "adamw", "sgd", "rmsprop"):
        tx = make_optimizer(name, 1e-3, grad_clip=1.0, weight_decay=1e-4)
        params = {"w": jnp.ones(3)}
        state = tx.init(params)
        updates, _ = tx.update({"w": jnp.ones(3)}, state, params)
        assert np.isfinite(np.asarray(updates["w"])).all()
    with pytest.raises(InvalidParametersError):
        make_optimizer("lion9000", 1e-3)


def test_predictor_system_a_latency_harness():
    from sublinear_tpu.models import InferenceConfig, Predictor, latency_report

    model = SystemA(hidden=8, arch="gru", horizon=1)
    trainer = Trainer(model, window=8, features=1)
    pred = Predictor.new_system_a(model, trainer.state.params,
                                  InferenceConfig(target_latency_ms=1000.0))
    rep = latency_report(pred, (8, 1), ticks=30, warmup=3)
    assert rep["ticks"] == 30 and rep["total"]["p999"] > 0
    assert set(rep["budget_ms"]) >= {"ingest", "network", "gate", "total_p999"}
    # CPU test: generous budget so meets_targets exercises the true path
    assert rep["meets_targets"] is True
    # stage timings recorded for every tick
    assert pred.stats.count == 30


def test_predictor_system_b_stages_and_gate():
    from sublinear_tpu.models import InferenceConfig, Predictor, SystemB

    sysb = SystemB.create(window=8, features=1, hidden=8, horizon=1, seed=1)
    pred = Predictor.new_system_b(sysb, InferenceConfig(target_latency_ms=1000.0))
    pred.warmup((8, 1), 2)
    out = pred.predict(np.linspace(0, 1, 8, dtype=np.float32)[:, None])
    assert out.value.shape == (1,) and np.isfinite(out.value).all()
    # System B exercises prior + gate stages
    assert out.timing.prior_ms > 0 and out.timing.gate_ms > 0
    # predictor output agrees with the composite's own predict path
    ref = sysb.predict(np.linspace(0, 1, 8, dtype=np.float32)[:, None])
    np.testing.assert_allclose(out.value, ref, atol=1e-5)


def test_streaming_tick_matches_full_window():
    """The O(1) carried-state tick path computes exactly the full-window
    GRU forward on the shifted window."""
    from sublinear_tpu.models import Predictor

    model = SystemA(hidden=8, arch="gru", horizon=1)
    trainer = Trainer(model, window=8, features=1)
    pred = Predictor.new_system_a(model, trainer.state.params)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 1)).astype(np.float32)
    pred.init_stream(w)
    xs = rng.standard_normal((5, 1)).astype(np.float32)
    hist = list(w)
    for x in xs:
        out_tick = pred.predict_tick(x)
        hist = hist[1:] + [x]  # full-window oracle on the shifted window... 
        # streaming GRU state corresponds to the FULL history, not a sliding
        # window — oracle: scan over w ++ xs_so_far
    full_hist = np.concatenate([w, xs], axis=0)
    full = np.asarray(model.apply(trainer.state.params, jnp.asarray(full_hist)))
    np.testing.assert_allclose(out_tick, full, rtol=1e-5, atol=1e-6)
    assert len(pred.tick_ms) == 5


def test_system_b_streaming_tick_runs_and_gates():
    from sublinear_tpu.models import InferenceConfig, Predictor, SystemB

    sysb = SystemB.create(window=8, features=1, hidden=8, horizon=1, seed=2)
    pred = Predictor.new_system_b(sysb, InferenceConfig(target_latency_ms=1000.0))
    rng = np.random.default_rng(1)
    pred.init_stream(rng.standard_normal((8, 1)).astype(np.float32))
    outs = [pred.predict_tick(rng.standard_normal(1).astype(np.float32)) for _ in range(10)]
    assert all(np.isfinite(o).all() and o.shape == (1,) for o in outs)
    assert pred.tick_percentiles()["p50"] > 0


def test_train_system_b_residual_active_selection():
    """System-B trainer: residual learning on the Kalman prior with
    PageRank active selection from epoch 2 (training/mod.rs:246-340)."""
    from sublinear_tpu.models import Config, SystemB, train_system_b

    cfg = Config.from_dict({
        "common": {"window_ms": 8, "sample_rate_hz": 1000, "features": ["x"]},
        "training": {"epochs": 6, "batch_size": 32, "patience": 0,
                     "learning_rate": 0.005},
        "system": {"type": "TemporalSolver",
                   "solver_gate": {"max_cert_error": 0.05},
                   "active_selection": {"k": 6, "samples_per_epoch": 96,
                                        "error_weight": 0.8,
                                        "diversity_weight": 0.2}},
    })
    t = np.arange(420, dtype=np.float32)
    series = np.sin(2 * np.pi * t / 30)
    windows, targets = make_windows(series, window=8, horizon=1)
    sysb = SystemB.create(window=8, features=1, hidden=8, horizon=1, seed=3)
    hist = train_system_b(sysb, windows[:256], targets[:256], cfg,
                          validation_data=(windows[256:320], targets[256:320]))
    assert len(hist) == 6
    # epochs 0-1 use the full pool; later epochs the active-selection budget
    assert hist[0]["samples"] == 256 and hist[3]["samples"] == 96
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all("gate_pass_rate" in h and "val_loss" in h for h in hist)
    # residual learning should beat the raw Kalman prior on held-out data
    prior_only_err = np.mean((targets[320:350] - np.stack(
        [sysb.prior(w, 1) for w in windows[320:350]])) ** 2)
    model_err = np.mean((targets[320:350] - np.stack(
        [sysb.predict(w) for w in windows[320:350]])) ** 2)
    assert model_err < prior_only_err


def test_tcn_streaming_tick_matches_full_window():
    """TCN streaming: carried device window ring == full-window forward."""
    from sublinear_tpu.models import Predictor

    model = SystemA(hidden=8, arch="tcn", horizon=1)
    trainer = Trainer(model, window=8, features=1)
    pred = Predictor.new_system_a(model, trainer.state.params)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 1)).astype(np.float32)
    pred.init_stream(w)
    hist = w
    for x in rng.standard_normal((4, 1)).astype(np.float32):
        out = pred.predict_tick(x)
        hist = np.concatenate([hist[1:], x[None]], axis=0)
    full = np.asarray(model.apply(trainer.state.params, jnp.asarray(hist)))
    np.testing.assert_allclose(out, full, rtol=1e-5, atol=1e-6)
