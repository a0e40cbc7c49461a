"""Harness tests: schedulers (exact formulas), losses, config system,
checkpointing, dataloader, and tiny end-to-end training runs for every
experiment family (classification ODE/SDE, CIFAR CNN, latent ODE)."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.harness import (
    Constant,
    CosineAnneal,
    Dataloader,
    ExponentialDecay,
    InverseDecay,
    Step,
    define_configuration,
    load_checkpoint,
    save_checkpoint,
)
from localregneuralde_tpu.harness.losses import (
    accuracy,
    kl_divergence,
    log_likelihood_loss,
    logitcrossentropy,
)


def test_schedulers_formulas():
    e = ExponentialDecay(2.5, 1.0, 100)
    assert abs(e(0) - 2.5) < 1e-9
    assert abs(e(100) - 1.0) < 1e-9
    i = InverseDecay(1.0, 0.1)
    assert abs(i(10) - 1.0 / 2.0) < 1e-9
    s = Step(1.0, 0.1, [10, 20])
    assert s(5) == 1.0 and abs(s(12) - 0.1) < 1e-12 and abs(s(25) - 0.01) < 1e-12
    c = CosineAnneal(1.0, 0.1, 100, restart=True)
    assert abs(c(1) - 1.0) < 1e-9  # peak at cycle start (t is 1-based)
    assert abs(c(51) - (0.45 * (1 + math.cos(math.pi / 2)) + 0.1)) < 1e-9
    assert Constant(0.5)(123) == 0.5


def test_logitcrossentropy_matches_manual():
    y_pred = jnp.array([[2.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    y = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    expected = -(
        jax.nn.log_softmax(y_pred)[0, 0] + jax.nn.log_softmax(y_pred)[1, 1]
    ) / 2
    assert abs(float(logitcrossentropy(y_pred, y)) - float(expected)) < 1e-6


def test_accuracy_topk():
    y_pred = jnp.array([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]])
    y = jnp.eye(3)[jnp.array([1, 2])]
    a1, a2 = accuracy(y_pred, y, (1, 2))
    assert float(a1) == 50.0
    assert float(a2) == 50.0  # class 2 is ranked 2nd or 3rd: [0.8,0.1,0.1] → top2 = {0, 1 or 2}


def test_kl_divergence_zero_at_standard_normal():
    mu = jnp.zeros((4, 8))
    logvar = jnp.zeros((4, 8))
    np.testing.assert_allclose(np.asarray(kl_divergence(mu, logvar)), 0.0)


def test_log_likelihood_mask_normalization():
    dpred = jnp.zeros((2, 5, 3))
    mask = jnp.ones((2, 5, 3))
    ll = log_likelihood_loss(dpred, mask)
    sigma = 0.01
    per_elem = -np.log(sigma) - np.log(2 * np.pi) / 2
    np.testing.assert_allclose(np.asarray(ll), per_elem, rtol=1e-5)


def test_config_yaml_and_overrides(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(
        "seed: 3\nmodel:\n  regularize: 'unbiased'\n  solver:\n    abstol: 0.01\n"
    )
    cfg = define_configuration(
        ["--model.solver.reltol=0.5", "--train.total_steps=42"], str(p)
    )
    assert cfg.seed == 3
    assert cfg.model.regularize == "unbiased"
    assert cfg.model.solver.abstol == 0.01
    assert cfg.model.solver.reltol == 0.5
    assert cfg.train.total_steps == 42
    with pytest.raises(KeyError):
        define_configuration(["--no.such.key=1"], str(p))


def test_checkpoint_roundtrip_and_pointers(tmp_path):
    state = {"a": jnp.arange(3), "nested": {"b": jnp.ones((2, 2))}}
    save_checkpoint(state, fdir=str(tmp_path), fname="s1.ckpt")
    save_checkpoint(state, fdir=str(tmp_path), fname="s2.ckpt", is_best=True)
    cur = load_checkpoint(os.path.join(str(tmp_path), "model_current.ckpt"))
    best = load_checkpoint(os.path.join(str(tmp_path), "model_best.ckpt"))
    np.testing.assert_array_equal(cur["a"], np.arange(3))
    np.testing.assert_array_equal(best["nested"]["b"], np.ones((2, 2)))
    assert load_checkpoint(os.path.join(str(tmp_path), "nope.ckpt")) is None


def test_dataloader_shapes_and_cycle():
    x = np.arange(100).reshape(100, 1).astype(np.float32)
    y = np.arange(100).astype(np.int64)
    dl = Dataloader((x, y), 32, shuffle=True, cycle=True, seed=1)
    it = iter(dl)
    batches = [next(it) for _ in range(5)]  # cycles past one epoch (3 batches)
    assert all(b[0].shape == (32, 1) for b in batches)
    # shuffling: first batch not the identity order
    assert not np.array_equal(batches[0][1], np.arange(32))
    # non-cycling loader terminates
    dl2 = Dataloader((x, y), 32)
    assert len(list(dl2)) == 3


def _tiny_cfg(model_type="mlp", regularize="unbiased"):
    from localregneuralde_tpu.harness import ExperimentConfig

    cfg = ExperimentConfig()
    cfg.model.model_type = model_type
    cfg.model.regularize = regularize
    cfg.model.image_size = [8, 8]
    cfg.model.in_channels = 1 if model_type == "mlp" else 3
    cfg.model.mlp_hidden_state_size = 16
    cfg.model.solver.abstol = 1e-2
    cfg.model.solver.reltol = 1e-2
    cfg.model.solver.max_steps = 32
    cfg.model.solver.checkpoint_every = 8
    cfg.dataset.train_batchsize = 16
    cfg.dataset.eval_batchsize = 64
    cfg.train.total_steps = 2
    cfg.train.print_frequency = 1
    cfg.train.evaluate_every = 2
    cfg.optimizer.scheduler.lr_scheduler = "constant"
    return cfg


def test_end_to_end_mnist_ode(tmp_path):
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    cfg = _tiny_cfg()
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    out = run_classification_experiment(cfg, "tiny")
    assert out["best_eval_acc"] > 0
    assert os.path.exists(
        os.path.join(out["log_dir"], "results_train.csv")
    )
    assert os.path.exists(
        os.path.join(out["ckpt_dir"], "model_current.ckpt")
    )
    # resume path: a second run restores from the checkpoint
    cfg2 = _tiny_cfg()
    cfg2.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg2.train.log_dir = str(tmp_path / "logs2")
    cfg2.train.total_steps = 3
    out2 = run_classification_experiment(cfg2, "tiny")
    assert out2["final_step"] == 3


def test_end_to_end_mnist_sde(tmp_path):
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    cfg = _tiny_cfg()
    cfg.model.sde = True
    cfg.model.solver.abstol = 1.4e-1
    cfg.model.solver.reltol = 1.4e-1
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    out = run_classification_experiment(cfg, "tiny_sde")
    assert out["best_eval_acc"] > 0


@pytest.mark.parametrize("adjoint", ["stored", "interpolating"])
def test_end_to_end_latent_ode(tmp_path, adjoint):
    from localregneuralde_tpu.harness.latent_runner import (
        run_latent_ode_experiment,
    )

    cfg = _tiny_cfg("time_series")
    cfg.model.solver.adjoint = adjoint
    cfg.model.ts_in_dims = 5
    cfg.model.ts_hidden_dims = 8
    cfg.model.ts_latent_dims = 6
    cfg.model.ts_node_dims = 4
    cfg.dataset.eval_batchsize = 16
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    out = run_latent_ode_experiment(cfg, "tiny_ts")
    assert np.isfinite(out["best_eval_mse"])


def test_latent_eval_batch_larger_than_test_split(tmp_path):
    """eval_batchsize > test split must clamp, not yield zero eval batches
    (hit with the shipped physionet.yaml eval_batchsize=512 on the
    409-sample synthetic test split — ZeroDivisionError pre-fix)."""
    from localregneuralde_tpu.harness.latent_runner import (
        run_latent_ode_experiment,
    )

    cfg = _tiny_cfg("time_series")
    cfg.model.ts_in_dims = 5
    cfg.model.ts_hidden_dims = 8
    cfg.model.ts_latent_dims = 6
    cfg.model.ts_node_dims = 4
    cfg.dataset.eval_batchsize = 4096  # >> the synthetic test split
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    out = run_latent_ode_experiment(cfg, "tiny_ts_bigeval")
    assert np.isfinite(out["best_eval_mse"])


def test_settle_state_shapes_prevents_retrace():
    """ReparameterizeLayer inits mu/logvar as (1,1) placeholders that become
    (B, latent) on the first call; settle_state_shapes must pre-grow them so
    the donated train step traces once (state-tree shapes are a stable fixed
    point of the step)."""
    from localregneuralde_tpu.harness.construct import (
        construct_loss,
        construct_optimizer,
        construct_time_series,
    )
    from localregneuralde_tpu.harness.train import (
        create_train_state,
        settle_state_shapes,
    )

    cfg = _tiny_cfg("time_series")
    cfg.model.ts_in_dims = 5
    cfg.model.ts_hidden_dims = 8
    cfg.model.ts_latent_dims = 6
    cfg.model.ts_node_dims = 4

    tgrid = jnp.linspace(0.0, 1.0, 7)
    model = construct_time_series(cfg, saveat=tgrid)
    loss_fn, (w_reg_sched, w_kl_sched) = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))

    B, T, D = 4, 7, 5
    batch = (
        jnp.zeros((B, T, D)),
        jnp.ones((B, T, D)),
        jnp.full((B, T, 1), 1.0 / T),
    )
    w = (float(w_reg_sched(1)), float(w_kl_sched(1)))

    before = [x.shape for x in jax.tree_util.tree_leaves(ts.state)]
    ts = settle_state_shapes(model, loss_fn, ts, batch, w)
    after = [x.shape for x in jax.tree_util.tree_leaves(ts.state)]
    assert before != after  # the placeholders really did need settling

    # settled shapes are the fixed point: one abstract step maps the state
    # tree onto itself (so the donated jit never retraces on shape change)
    st_sd = jax.eval_shape(
        lambda p, s: loss_fn(model, p, s, batch, w, training=True)[1],
        ts.params, ts.state,
    )
    assert [x.shape for x in jax.tree_util.tree_leaves(st_sd)] == after

    # idempotent
    ts2 = settle_state_shapes(model, loss_fn, ts, batch, w)
    assert [x.shape for x in jax.tree_util.tree_leaves(ts2.state)] == after


def test_optimizer_factory_variants():
    from localregneuralde_tpu.harness import ExperimentConfig
    from localregneuralde_tpu.harness.construct import construct_optimizer

    for name, extra in [
        ("adam", {}),
        ("adamw", {}),
        ("adamax", {}),
        ("sgd", {"momentum": 0.9}),
        ("sgd", {"momentum": 0.9, "nesterov": True}),
        ("sgd", {}),
    ]:
        cfg = ExperimentConfig()
        cfg.optimizer.optimizer = name
        for k, v in extra.items():
            setattr(cfg.optimizer, k, v)
        cfg.optimizer.weight_decay = 1e-4 if name == "adam" else 0.0
        opt, sched = construct_optimizer(cfg)
        params = {"w": jnp.ones((3, 3))}
        state = opt.init(params)
        g = {"w": jnp.ones((3, 3))}
        updates, _ = opt.update(g, state, params)
        assert jnp.isfinite(updates["w"]).all()

    cfg = ExperimentConfig()
    cfg.optimizer.optimizer = "nope"
    with pytest.raises(ValueError):
        construct_optimizer(cfg)


def test_optimizer_gradient_clipping():
    """optimizer.gradient_clip_norm=c clips the global grad norm BEFORE the
    update: a huge gradient produces the same update as the same gradient
    pre-scaled to norm c, and clip=0 leaves the optimizer unchanged."""
    from localregneuralde_tpu.harness import ExperimentConfig
    from localregneuralde_tpu.harness.construct import construct_optimizer

    def updates_for(clip, g):
        cfg = ExperimentConfig()
        cfg.optimizer.optimizer = "sgd"  # update == -lr * (clipped) grad
        cfg.optimizer.learning_rate = 1.0
        cfg.optimizer.gradient_clip_norm = clip
        opt, _ = construct_optimizer(cfg)
        params = {"w": jnp.zeros((4,))}
        u, _ = opt.update(g, opt.init(params), params)
        return u["w"]

    big = {"w": jnp.asarray([3e3, 4e3, 0.0, 0.0])}  # global norm 5e3
    u_clip = updates_for(1.0, big)
    np.testing.assert_allclose(
        np.asarray(u_clip), -np.asarray([0.6, 0.8, 0.0, 0.0]), rtol=1e-6
    )
    small = {"w": jnp.asarray([0.3, 0.4, 0.0, 0.0])}  # norm 0.5 < clip
    np.testing.assert_allclose(
        np.asarray(updates_for(1.0, small)),
        np.asarray(updates_for(0.0, small)), rtol=1e-6,
    )


def test_lr_scheduler_factory_variants():
    from localregneuralde_tpu.harness import ExperimentConfig
    from localregneuralde_tpu.harness.construct import construct_optimizer

    for kind in ("constant", "step", "exponential", "inverse", "cosine"):
        cfg = ExperimentConfig()
        cfg.optimizer.scheduler.lr_scheduler = kind
        _, sched = construct_optimizer(cfg)
        assert sched(1) > 0
        assert sched(1000) > 0


def test_solver_config_dispatches_multistep(monkeypatch):
    """A config with ode_solver=vcabm3 must actually integrate with VCABM3
    (reference construct.jl:154-164 honors the YAML solver choice)."""
    import localregneuralde_tpu.ode.multistep as multistep
    from localregneuralde_tpu.harness.construct import construct_model

    calls = {"n": 0}
    real = multistep.adams_solve

    def spy(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(multistep, "adams_solve", spy)

    cfg = _tiny_cfg(regularize="none")
    cfg.model.solver.ode_solver = "vcabm3"
    model = construct_model(cfg)
    key = jax.random.PRNGKey(0)
    params, state = model.init(key)
    x = jnp.ones((4, 8, 8, 1))
    y, _ = model(params, state, x, training=False)
    assert calls["n"] >= 1
    assert jnp.isfinite(y).all()

    cfg.model.solver.ode_solver = "nope"
    with pytest.raises(ValueError):
        construct_model(cfg)


def test_config_list_override():
    cfg = define_configuration(["--model.image_size=[8,8]"], None)
    assert cfg.model.image_size == [8, 8]
    cfg2 = define_configuration(
        ["--optimizer.scheduler.step_lr_steps=[100,200,300]"], None
    )
    assert cfg2.optimizer.scheduler.step_lr_steps == [100, 200, 300]


@pytest.mark.parametrize("dp_mode,tp", [("gspmd", 1), ("gspmd", 2),
                                        ("shardmap", 1)])
def test_end_to_end_data_parallel_runner(tmp_path, dp_mode, tp):
    """train.data_parallel wires the parallel train steps into the
    canonical runner: gspmd keeps the reference-exact global adaptive
    grid (loss trajectory identical to single-device at the same seed);
    shardmap is the documented per-shard-grid estimator (runs, logs,
    checkpoints — values differ by design)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    def run(mode, tpn, sub):
        cfg = _tiny_cfg()
        cfg.train.data_parallel = mode
        cfg.train.tensor_parallel = tpn
        cfg.train.checkpoint_dir = str(tmp_path / f"ckpt{sub}")
        cfg.train.log_dir = str(tmp_path / f"logs{sub}")
        out = run_classification_experiment(cfg, f"dp_{sub}")
        csv = os.path.join(out["log_dir"], "results_train.csv")
        with open(csv) as f:
            rows = f.read().strip().splitlines()
        header = rows[0].split(",")
        ce = [float(r.split(",")[header.index("ce_loss")])
              for r in rows[1:]]
        return out, ce

    out, ce = run(dp_mode, tp, f"{dp_mode}{tp}")
    assert os.path.exists(os.path.join(out["ckpt_dir"], "model_current.ckpt"))
    assert np.all(np.isfinite(ce))
    if dp_mode == "gspmd":
        out0, ce0 = run("none", 1, "single")
        np.testing.assert_allclose(ce, ce0, rtol=1e-4)


def test_data_parallel_config_validation():
    from localregneuralde_tpu.harness.runner import _wire_data_parallel

    cfg = _tiny_cfg()
    cfg.train.data_parallel = "bogus"
    with pytest.raises(ValueError, match="data_parallel"):
        _wire_data_parallel(cfg, None, None, None, None, None, None, 1.0)
    cfg.train.data_parallel = "shardmap"
    cfg.train.tensor_parallel = 2
    with pytest.raises(ValueError, match="tensor_parallel"):
        _wire_data_parallel(cfg, None, None, None, None, None, None, 1.0)
    cfg.train.data_parallel = "shardmap"
    cfg.train.tensor_parallel = 1
    cfg.dataset.train_batchsize = 12  # not divisible by 8 shards
    if len(jax.devices()) == 8:
        with pytest.raises(ValueError, match="divisible"):
            _wire_data_parallel(cfg, None, None, None, None, None, None, 1.0)


def test_end_to_end_latent_data_parallel(tmp_path):
    """The latent runner accepts train.data_parallel too (shardmap here:
    3-tuple batches, tuple w_reg, per-shard grids)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from localregneuralde_tpu.harness.latent_runner import (
        run_latent_ode_experiment,
    )

    cfg = _tiny_cfg("time_series")
    cfg.train.data_parallel = "shardmap"
    cfg.model.ts_in_dims = 5
    cfg.model.ts_hidden_dims = 8
    cfg.model.ts_latent_dims = 6
    cfg.model.ts_node_dims = 4
    cfg.dataset.eval_batchsize = 16
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    out = run_latent_ode_experiment(cfg, "tiny_ts_dp")
    assert np.isfinite(out["best_eval_mse"])


def test_resume_single_device_checkpoint_into_data_parallel(tmp_path):
    """Recovery scenario: a checkpoint trained single-device resumes into
    a data_parallel run — restored host arrays must get (re)sharded
    (the wiring runs after resume by design)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    cfg = _tiny_cfg()
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    out = run_classification_experiment(cfg, "resume_dp")
    assert out["final_step"] == 2

    cfg2 = _tiny_cfg()
    cfg2.train.data_parallel = "gspmd"
    cfg2.train.total_steps = 4
    cfg2.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg2.train.log_dir = str(tmp_path / "logs2")
    out2 = run_classification_experiment(cfg2, "resume_dp")
    assert out2["final_step"] == 4
    assert np.isfinite(out2["best_eval_acc"])
