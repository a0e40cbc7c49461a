"""Per-shard-grid DP (``parallel/shardmap_train.py``) tests on the virtual
8-device CPU mesh.

The shard_map path is the opt-in throughput alternative to the GSPMD path:
each shard runs the complete single-device computation on its local
sub-batch with its OWN adaptive grid; the
only cross-shard communication is one pmean of (loss, grads, scalar state)
per step. These tests pin the documented estimator semantics exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.harness.config import ExperimentConfig
from localregneuralde_tpu.harness.construct import (
    construct_loss,
    construct_model,
    construct_optimizer,
)
from localregneuralde_tpu.harness.train import (
    create_train_state,
    settle_state_shapes,
)
from localregneuralde_tpu.parallel import (
    make_mesh,
    make_shardmap_train_step,
    shard_batch,
    shard_train_state,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _tiny_cfg():
    cfg = ExperimentConfig()
    cfg.model.model_type = "mlp"
    cfg.model.regularize = "unbiased"
    cfg.model.image_size = [8, 8]
    cfg.model.in_channels = 1
    cfg.model.mlp_hidden_state_size = 16
    cfg.model.solver.abstol = 1e-2
    cfg.model.solver.reltol = 1e-2
    cfg.model.solver.max_steps = 16
    cfg.model.solver.checkpoint_every = 4
    cfg.optimizer.scheduler.lr_scheduler = "constant"
    return cfg


def _batch(B=16):
    x = jax.random.uniform(jax.random.PRNGKey(1), (B, 8, 8, 1))
    y = jnp.eye(10)[jax.random.randint(jax.random.PRNGKey(2), (B,), 0, 10)]
    return x, y


def test_shardmap_matches_manual_per_shard_estimator():
    """The documented estimator: with n shards, loss/grads are the mean of
    n independent per-sub-batch solves, shard i seeing rng leaves folded
    with its axis index; the carried rng advances by fold_in(., 1). Verify
    against an explicit Python-loop simulation on a 2-shard mesh."""
    cfg = _tiny_cfg()
    model = construct_model(cfg)
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    n = 2
    mesh = make_mesh({"data": n})
    x, y = _batch(8)
    w_reg, lr = 1.0, 1e-3

    ts0 = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    ts0 = settle_state_shapes(model, loss_fn, ts0, (x, y), w_reg)

    # ---- manual simulation --------------------------------------------
    def is_rng(path):
        return getattr(path[-1], "key", None) == "rng"

    losses, grads_list, preds, nfes = [], [], [], []
    for i in range(n):
        xs = x[i * 4:(i + 1) * 4]
        ys = y[i * 4:(i + 1) * 4]
        state_i = jax.tree_util.tree_map_with_path(
            lambda p, l: jax.random.fold_in(l, i) if is_rng(p) else l,
            ts0.state,
        )

        def obj(params):
            loss, st_, stats = loss_fn(
                model, params, state_i, (xs, ys), w_reg, training=True
            )
            return loss, stats

        (loss_i, stats_i), g_i = jax.value_and_grad(obj, has_aux=True)(
            ts0.params
        )
        losses.append(loss_i)
        grads_list.append(g_i)
        preds.append(stats_i["y_pred"])
        nfes.append(float(stats_i["nfe"]))

    loss_ref = float(np.mean([float(l) for l in losses]))
    grads_ref = jax.tree_util.tree_map(
        lambda *gs: sum(np.asarray(g) for g in gs) / n, *grads_list
    )
    import optax

    opt_state = ts0.opt_state
    opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    updates, _ = optimizer.update(
        jax.tree_util.tree_map(jnp.asarray, grads_ref), opt_state,
        ts0.params,
    )
    params_ref = optax.apply_updates(ts0.params, updates)

    # ---- shard_map path ------------------------------------------------
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    ts = settle_state_shapes(model, loss_fn, ts, (x, y), w_reg)
    ts = shard_train_state(ts, mesh)
    step = make_shardmap_train_step(model, loss_fn, optimizer, mesh)
    ts1, loss_sm, stats = step(ts, shard_batch((x, y), mesh), w_reg, lr)

    np.testing.assert_allclose(loss_ref, float(loss_sm), rtol=2e-5)
    np.testing.assert_allclose(
        float(np.mean(nfes)), float(stats["nfe"]), rtol=1e-6
    )
    # y_pred reassembles the global batch in shard order
    np.testing.assert_allclose(
        np.concatenate([np.asarray(p) for p in preds], axis=0),
        np.asarray(jax.device_get(stats["y_pred"])),
        rtol=2e-5, atol=1e-6,
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(params_ref),
        jax.tree_util.tree_leaves(ts1.params),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(jax.device_get(b)), atol=3e-6
        )
    # carried rng advanced deterministically and stays replicated
    rng0 = ts0.state["neural_ode"]["rng"]
    rng1 = jax.device_get(ts1.state["neural_ode"]["rng"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(rng0, 1)), np.asarray(rng1)
    )


def test_shardmap_second_step_runs_and_decorrelates():
    """Two consecutive steps reuse the compiled program; shard grids differ
    (per-shard NFE mean is non-integer for a heterogeneous batch at least
    once across steps) — a direct observable of per-shard adaptivity."""
    cfg = _tiny_cfg()
    model = construct_model(cfg)
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    mesh = make_mesh({"data": 8})
    x, y = _batch(16)
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    ts = settle_state_shapes(model, loss_fn, ts, (x, y), 1.0)
    ts = shard_train_state(ts, mesh)
    step = make_shardmap_train_step(model, loss_fn, optimizer, mesh)
    data = shard_batch((x, y), mesh)
    nfes = []
    for _ in range(3):
        ts, loss, stats = step(ts, data, 1.0, 1e-3)
        assert np.isfinite(float(loss))
        nfes.append(float(stats["nfe"]))
    assert int(ts.step) == 3
    # unbiased-t1 draws are folded per shard: with 8 independent grids the
    # mean NFE is fractional unless all 8 coincide every step
    assert any(abs(v - round(v)) > 1e-6 for v in nfes), nfes


def test_shardmap_latent_family_tuple_wreg():
    """3-tuple latent batches and tuple-valued w_reg=(w_kl, w_reg) go
    through the same step (prefix P() in_specs broadcast over pytrees)."""
    from localregneuralde_tpu.harness.construct import construct_time_series

    cfg = _tiny_cfg()
    cfg.model.model_type = "time_series"
    cfg.model.ts_in_dims = 5
    cfg.model.ts_hidden_dims = 8
    cfg.model.ts_latent_dims = 6
    cfg.model.ts_node_dims = 4
    tgrid = jnp.linspace(0.0, 1.0, 7)
    model = construct_time_series(cfg, saveat=tgrid)
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    mesh = make_mesh({"data": 4})
    B = 8
    data = (
        jnp.ones((B, 7, 5)),
        jnp.ones((B, 7, 5)),
        jnp.full((B, 7, 1), 1.0 / 6),
    )
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    ts = settle_state_shapes(model, loss_fn, ts, data, (1.0, 0.1))
    ts = shard_train_state(ts, mesh)
    step = make_shardmap_train_step(model, loss_fn, optimizer, mesh)
    ts, loss, stats = step(ts, shard_batch(data, mesh), (1.0, 0.1), 1e-3)
    assert np.isfinite(float(loss))
    ts, loss, stats = step(ts, shard_batch(data, mesh), (1.0, 0.1), 1e-3)
    assert np.isfinite(float(loss))


def test_shardmap_bool_stats_reduce_by_all_and_dim_collisions():
    """Two reduction-semantics regressions:

    1. Boolean stats leaves reduce by all-shards AND (not a pmean that
       any nonzero shard rounds to True) and keep dtype bool.
    2. A non-batch stats leaf whose leading dim coincidentally equals the
       LOCAL batch (here a (2,)-pair at b_local=2) must be classified
       'reduce', not concatenated into a garbage global-batch array —
       the two-size eval_shape classification."""
    cfg = _tiny_cfg()
    model = construct_model(cfg)
    base_loss, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    mesh = make_mesh({"data": 8})
    x, y = _batch(16)  # b_local = 2

    thresh = float(x.max())  # concrete, computed outside any trace

    def loss_fn(model_, params, state, data, w_reg, training=True):
        loss, st_, stats = base_loss(
            model_, params, state, data, w_reg, training=training
        )
        xs = data[0]
        # exactly the shards holding the batch max see flag=False
        stats["flag"] = xs.max() < thresh
        stats["pair"] = jnp.zeros((2,), jnp.float32)  # dim == b_local
        return loss, st_, stats

    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    ts = settle_state_shapes(model, loss_fn, ts, (x, y), 1.0)
    ts = shard_train_state(ts, mesh)
    step = make_shardmap_train_step(model, loss_fn, optimizer, mesh)
    ts2, loss, stats = step(ts, shard_batch((x, y), mesh), 1.0, 1e-3)

    flag = stats["flag"]
    assert flag.dtype == jnp.bool_
    assert not bool(flag), "one shard's False must surface (AND, not mean)"
    assert stats["pair"].shape == (2,), (
        "b_local-collision leaf must stay a reduced (2,) pair, not be "
        "concatenated across shards"
    )
    # state success flags keep their dtype through the bool reduction
    ok = ts2.state["neural_ode"]["success"]
    assert ok.dtype == jnp.bool_ and bool(ok)
