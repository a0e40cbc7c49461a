"""Layer-zoo unit tests: TDChain, Augmenter, Reparameterize, LatentGRUCell,
BatchNorm, Recurrence, ArrayAndTime lift."""
import jax
import jax.numpy as jnp
import numpy as np

from localregneuralde_tpu.core import ArrayAndTime
from localregneuralde_tpu.models import (
    AugmenterLayer,
    LatentGRUCell,
    ReparameterizeLayer,
    TDChain,
)
from localregneuralde_tpu.nn import BatchNorm, Chain, Conv, Dense, Recurrence


def test_tdchain_concats_time_channel():
    td = TDChain(Dense(3, 4, "tanh"), Dense(5, 2))
    ps, st = td.init(jax.random.PRNGKey(0))
    x = jnp.ones((8, 2))
    out, _ = td(ps, st, ArrayAndTime(x, jnp.asarray(0.5)), training=True)
    assert out.array.shape == (8, 2)
    assert np.isclose(float(out.scalar), 0.5)
    # time actually matters
    out2, _ = td(ps, st, ArrayAndTime(x, jnp.asarray(0.9)), training=True)
    assert not np.allclose(np.asarray(out.array), np.asarray(out2.array))


def test_arrayandtime_lift_ignores_time_for_plain_layers():
    d = Dense(2, 3)
    ps, st = d.init(jax.random.PRNGKey(0))
    x = jnp.ones((4, 2))
    y_plain, _ = d(ps, st, x)
    y_lift, _ = d(ps, st, ArrayAndTime(x, jnp.asarray(0.7)))
    assert isinstance(y_lift, ArrayAndTime)
    np.testing.assert_allclose(
        np.asarray(y_plain), np.asarray(y_lift.array)
    )
    assert np.isclose(float(y_lift.scalar), 0.7)


def test_augmenter_concats_channels():
    aug = AugmenterLayer(Conv((3, 3), 3, 5), axis=-1)
    ps, st = aug.init(jax.random.PRNGKey(0))
    x = jnp.ones((2, 8, 8, 3))
    y, _ = aug(ps, st, x)
    assert y.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(np.asarray(y[..., :3]), np.asarray(x))


def test_reparameterize_train_vs_eval():
    r = ReparameterizeLayer()
    _, st = r.init(jax.random.PRNGKey(0))
    x = jnp.concatenate(
        [jnp.ones((4, 3)), jnp.full((4, 3), -2.0)], axis=-1
    )
    y_eval, _ = r({}, st, x, training=False)
    np.testing.assert_allclose(np.asarray(y_eval), 1.0)
    y_tr, st2 = r({}, st, x, training=True)
    assert y_tr.shape == (4, 3)
    assert not np.allclose(np.asarray(y_tr), 1.0)
    np.testing.assert_allclose(np.asarray(st2["mu"]), 1.0)
    np.testing.assert_allclose(np.asarray(st2["logvar"]), -2.0)
    # rng advances
    y_tr2, _ = r({}, st2, x, training=True)
    assert not np.allclose(np.asarray(y_tr), np.asarray(y_tr2))


def test_latent_gru_cell_mask_gating():
    cell = LatentGRUCell(3, 8, 5)
    ps, st = cell.init(jax.random.PRNGKey(0))
    x_obs = jnp.concatenate(
        [jnp.ones((2, 3)), jnp.ones((2, 3)), 0.1 * jnp.ones((2, 1))],
        axis=-1,
    )
    x_unobs = jnp.zeros((2, 7))
    carry = cell.initial_carry(x_obs)
    (y, (m1, s1)), _ = cell(ps, st, (x_obs, carry), training=True)
    assert y.shape == (2, 10)
    # unobserved step (mask+dt all zero) keeps the carry unchanged
    (_, (m2, s2)), _ = cell(ps, st, (x_unobs, (m1, s1)), training=True)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1))
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1))


def test_recurrence_scans_time_axis():
    cell = LatentGRUCell(3, 8, 5)
    rec = Recurrence(cell)
    ps, st = rec.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 6, 7))
    y, _ = rec(ps, st, x, training=True)
    assert y.shape == (2, 10)


def test_batchnorm_train_updates_running_stats():
    bn = BatchNorm(3)
    ps, st = bn.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 3)) * 2 + 1
    y, st2 = bn(ps, st, x, training=True)
    assert not np.allclose(np.asarray(st2["mean"]), 0.0)
    # training output is normalized with batch stats
    assert abs(float(jnp.mean(y))) < 1e-5
    # eval uses running stats, state unchanged
    _, st3 = bn(ps, st2, x, training=False)
    np.testing.assert_allclose(
        np.asarray(st3["mean"]), np.asarray(st2["mean"])
    )


def test_tdchain_conv_split_matches_concat():
    """The concat-free conv fast path must equal the generic ones·t concat
    exactly (linearity of convolution; common.py _apply_time_dependent)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from localregneuralde_tpu.models.common import TDChain
    from localregneuralde_tpu.nn import BatchNorm, Chain, Conv
    from localregneuralde_tpu.core.containers import ArrayAndTime

    td = TDChain(
        Chain(Conv((3, 3), 5, 8, use_bias=False), BatchNorm(8, "gelu")),
        Conv((3, 3), 9, 4, "tanh"),
    )
    ps, st = td.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 6, 6, 4))
    t = jnp.asarray(0.37)
    y_fast, st_fast = td(ps, st, ArrayAndTime(x, t), training=True)

    # generic path: apply each layer on the explicit concat
    arr = x
    for name, layer in td.layers.items():
        tc = jnp.full(arr.shape[:-1] + (1,), t, arr.dtype)
        arr, _ = layer(ps[name], st[name], jnp.concatenate([arr, tc], -1),
                       training=True)
    np.testing.assert_allclose(
        np.asarray(y_fast.array), np.asarray(arr), rtol=1e-5, atol=1e-6
    )


def test_batchnorm_eval_stats_batch():
    """eval_stats='batch': eval-mode normalization uses current batch
    statistics (escape hatch for BN-inside-ODE-dynamics); running stats are kept but unused in eval, and
    eval output equals training output given identical inputs."""
    import pytest

    from localregneuralde_tpu.nn import BatchNorm

    bn_run = BatchNorm(4)
    bn_bat = BatchNorm(4, eval_stats="batch")
    params, state = bn_run.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 4)) * 3.0 + 1.0

    y_tr, st_tr = bn_run.apply(params, state, x, training=True)
    y_bat, st_bat = bn_bat.apply(params, state, x, training=False)
    # same normalization as training mode (batch stats)
    np.testing.assert_allclose(
        np.asarray(y_bat), np.asarray(y_tr), rtol=1e-6, atol=1e-6
    )
    # eval must not touch running stats
    for k in ("mean", "var"):
        np.testing.assert_array_equal(
            np.asarray(st_bat[k]), np.asarray(state[k])
        )
    # 'running' eval differs (fresh init stats vs batch stats)
    y_run, _ = bn_run.apply(params, state, x, training=False)
    assert not np.allclose(np.asarray(y_run), np.asarray(y_bat))

    with pytest.raises(ValueError, match="eval_stats"):
        BatchNorm(4, eval_stats="nope")


def test_cifar_model_bn_eval_stats_knob():
    """model.bn_eval_stats='batch' threads through the conv builder: the
    eval-mode forward of a freshly built model matches its training-mode
    logits (all-BN normalization identical), unlike the default."""
    from localregneuralde_tpu.harness.config import ExperimentConfig
    from localregneuralde_tpu.harness.construct import construct_model

    cfg = ExperimentConfig()
    cfg.model.model_type = "cifar10_cnn"
    cfg.model.image_size = [8, 8]
    cfg.model.solver.abstol = 1e-2
    cfg.model.solver.reltol = 1e-2
    cfg.model.solver.max_steps = 16
    cfg.model.bn_eval_stats = "batch"
    model = construct_model(cfg)
    params, state = model.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 8, 3))
    y_tr, _ = model(params, state, x, training=True)
    y_ev, _ = model(params, state, x, training=False)
    np.testing.assert_allclose(
        np.asarray(y_ev), np.asarray(y_tr), rtol=1e-4, atol=1e-5
    )
