"""Sharded-training tests on the virtual 8-device CPU mesh: DP×TP train
step parity with the single-device step, and batch sharding placement."""
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
from localregneuralde_tpu.harness.train import create_train_state, make_train_step
from localregneuralde_tpu.parallel import (
    make_mesh,
    make_param_shardings,
    make_sharded_train_step,
    shard_batch,
    shard_train_state,
    sharding_rules_for_mlp_tp,
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


def _setup(mesh_axes):
    cfg = _tiny_cfg()
    model = construct_model(cfg)
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    mesh = make_mesh(mesh_axes)
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    return cfg, model, loss_fn, optimizer, mesh, ts


def test_dp_tp_step_matches_single_device():
    cfg, model, loss_fn, optimizer, mesh, ts = _setup(
        {"data": 4, "model": 2}
    )
    rules = sharding_rules_for_mlp_tp("model")

    x = jax.random.uniform(jax.random.PRNGKey(1), (8, 8, 8, 1))
    y = jnp.eye(10)[jax.random.randint(jax.random.PRNGKey(2), (8,), 0, 10)]

    # single-device reference
    single_step = make_train_step(model, loss_fn, optimizer)
    ts_ref = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    ts_ref, loss_ref, _ = single_step(ts_ref, (x, y), 1.0, 1e-3)

    # sharded
    ts_sh = shard_train_state(ts, mesh, rules)
    sharded_step = make_sharded_train_step(
        model, loss_fn, optimizer, mesh, rules=rules
    )
    xb, yb = shard_batch((x, y), mesh)
    ts_sh, loss_sh, _ = sharded_step(ts_sh, (xb, yb), 1.0, 1e-3)

    np.testing.assert_allclose(
        float(loss_ref), float(loss_sh), rtol=1e-4
    )
    # parameters after one update agree
    for a, b in zip(
        jax.tree_util.tree_leaves(ts_ref.params),
        jax.tree_util.tree_leaves(ts_sh.params),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(jax.device_get(b)), atol=2e-5
        )


def test_param_sharding_rules_apply():
    cfg, model, loss_fn, optimizer, mesh, ts = _setup(
        {"data": 4, "model": 2}
    )
    rules = sharding_rules_for_mlp_tp("model")
    shardings = make_param_shardings(ts.params, mesh, rules)
    from jax.sharding import PartitionSpec as P

    flat, _ = jax.tree_util.tree_flatten_with_path(shardings)
    tp_sharded = [
        s for path, s in flat
        if "layer_0" in "/".join(str(p) for p in path) and s.spec != P()
    ]
    assert tp_sharded, "expected the first dynamics layer to be TP-sharded"


def test_shard_batch_places_on_mesh():
    mesh = make_mesh({"data": 8})
    x = jnp.ones((16, 4))
    (xs,) = shard_batch((x,), mesh)
    assert len(xs.sharding.device_set) == 8


def test_opt_moments_sharded_like_params():
    """Adam mu/nu for TP-sharded params must carry the same sharding as the
    params themselves (memory-minimal)."""
    from jax.sharding import PartitionSpec as P

    cfg, model, loss_fn, optimizer, mesh, ts = _setup(
        {"data": 4, "model": 2}
    )
    rules = sharding_rules_for_mlp_tp("model")
    ts_sh = shard_train_state(ts, mesh, rules)

    flat_p = jax.tree_util.tree_flatten_with_path(ts_sh.params)[0]
    specs_by_path = {
        "/".join(str(getattr(k, "key", k)) for k in path): leaf.sharding.spec
        for path, leaf in flat_p
    }
    tp_paths = {p: s for p, s in specs_by_path.items() if s != P()}
    assert tp_paths, "expected TP-sharded params"

    flat_o = jax.tree_util.tree_flatten_with_path(ts_sh.opt_state)[0]
    matched = 0
    for path, leaf in flat_o:
        s = "/".join(str(getattr(k, "key", k)) for k in path)
        for ppath, spec in tp_paths.items():
            if s.endswith("/" + ppath) and hasattr(leaf, "sharding"):
                assert leaf.sharding.spec == spec, (s, leaf.sharding.spec, spec)
                matched += 1
    # adam: mu and nu per TP param at least
    assert matched >= 2 * len(tp_paths), (matched, len(tp_paths))


def test_dp_accept_reject_sequence_identity():
    """Shared-batch adaptive grid under GSPMD: the error norm is a global
    mean over the distributed batch tensor, so the DP-sharded solve must take
    the IDENTICAL accept/reject sequence (same naccept/nreject/nfe) as the
    single-device solve."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from localregneuralde_tpu.ode import odesolve

    mesh = make_mesh({"data": 8})

    def f(u, t, p):
        return jnp.tanh(u @ p["w"]) - 0.5 * u

    p = {"w": jax.random.normal(jax.random.PRNGKey(0), (6, 6)) * 0.5}
    u0 = jax.random.normal(jax.random.PRNGKey(1), (16, 6))

    def solve(u0, p):
        sol = odesolve(
            f, u0, (0.0, 1.0), p, rtol=1e-6, atol=1e-8, max_steps=64,
            adjoint="none",
        )
        return sol.y_final, sol.naccept, sol.nreject, sol.nfe

    y_ref, na_ref, nr_ref, nfe_ref = jax.jit(solve)(u0, p)

    batch_sh = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    u0_sh = jax.device_put(u0, batch_sh)
    p_sh = jax.device_put(p, repl)
    y_dp, na_dp, nr_dp, nfe_dp = jax.jit(
        solve, in_shardings=(batch_sh, repl)
    )(u0_sh, p_sh)
    y_dp2, na_dp2, nr_dp2, nfe_dp2 = jax.jit(
        solve, in_shardings=(batch_sh, repl)
    )(u0_sh, p_sh)

    # Within one SPMD program the grid is a single global scalar sequence —
    # deterministic across runs (all devices see the SAME dt decisions).
    assert int(na_dp) == int(na_dp2)
    assert int(nr_dp) == int(nr_dp2)
    assert int(nfe_dp) == int(nfe_dp2)
    # vs single-device: GSPMD's distributed reduction order differs at the
    # ULP level, so a borderline accept can flip — counts agree to ±1 and
    # the trajectory agrees at solve tolerance.
    assert abs(int(na_ref) - int(na_dp)) <= 1
    assert abs(int(nfe_ref) - int(nfe_dp)) <= 12
    np.testing.assert_allclose(
        np.asarray(y_ref), np.asarray(jax.device_get(y_dp)),
        rtol=1e-4, atol=1e-6,
    )


def test_sharded_step_accepts_arbitrary_data_pytrees():
    """The data in_sharding is a pytree prefix: 3-tuple latent batches go
    through the same sharded step."""
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
    mesh = make_mesh({"data": 4, "model": 2})
    ts = shard_train_state(
        create_train_state(model, optimizer, jax.random.PRNGKey(0)), mesh
    )
    step = make_sharded_train_step(model, loss_fn, optimizer, mesh)
    B = 8
    batch = shard_batch(
        (
            jnp.ones((B, 7, 5)), jnp.ones((B, 7, 5)),
            jnp.full((B, 7, 1), 1.0 / 6),
        ),
        mesh,
    )
    ts, loss, stats = step(ts, batch, (1.0, 0.1), 1e-3)
    assert np.isfinite(float(loss))
