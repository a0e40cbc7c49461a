"""NeuralODE property matrix — mirrors the reference's 9-item test strategy
(``test/runtests.jl``, SURVEY.md §4): for each regularization mode × dynamics
kind, check output shape, reg_val zero/nonzero, loss-gradient finiteness and
nonzero-ness w.r.t. input and params, and the reg-gradient locality fence
(∂reg/∂x ≡ 0 while ∂reg/∂ps is finite with nonzero entries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.models import (
    NeuralODE,
    TDChain,
    diffeqsol_to_array,
)
from localregneuralde_tpu.nn import Chain, Dense


def _make_node(regularize, time_dependent, **kw):
    if time_dependent:
        dyn = TDChain(Dense(3, 4, "tanh"), Dense(5, 2))
    else:
        dyn = Chain(Dense(2, 4, "tanh"), Dense(4, 2))
    return NeuralODE(
        dyn, regularize=regularize, max_steps=32, checkpoint_every=8, **kw
    )


def _flat(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([np.ravel(np.asarray(l)) for l in leaves])


@pytest.mark.parametrize("time_dependent", [True, False])
@pytest.mark.parametrize("regularize", ["none", "unbiased", "biased"])
def test_neural_ode_matrix(regularize, time_dependent):
    node = _make_node(regularize, time_dependent)
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 2))

    def forward(ps, x):
        sol, st_ = node(ps, st, x, training=True)
        return diffeqsol_to_array(sol), st_

    y, st_ = jax.jit(forward)(ps, x)
    assert y.shape == (8, 2)
    assert int(st_["nfe"]) > 0
    if regularize == "none":
        assert float(st_["reg_val"]) == 0.0
    else:
        assert float(st_["reg_val"]) != 0.0

    # loss gradients: finite and nonzero w.r.t. both input and params
    def loss(ps, x):
        y, _ = forward(ps, x)
        return jnp.sum(y)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(ps, x)
    gp_flat, gx_flat = _flat(gp), _flat(gx)
    assert np.isfinite(gp_flat).all() and (gp_flat != 0).any()
    assert np.isfinite(gx_flat).all() and (gx_flat != 0).any()

    if regularize != "none":
        # locality fence: reg gradient flows to params only
        def regloss(ps, x):
            _, st_ = forward(ps, x)
            return st_["reg_val"]

        rgp, rgx = jax.jit(jax.grad(regloss, argnums=(0, 1)))(ps, x)
        assert float(jnp.abs(_flat(rgx)).max()) == 0.0
        rgp_flat = _flat(rgp)
        assert np.isfinite(rgp_flat).all() and (rgp_flat != 0).any()


def test_eval_mode_is_vanilla():
    node = _make_node("unbiased", True)
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    sol, st_ = node(ps, st, x, training=False)
    assert float(st_["reg_val"]) == 0.0
    y = diffeqsol_to_array(sol)
    assert y.shape == (4, 2)


def test_stiffness_estimate_regularizer():
    node = _make_node(
        "unbiased", True, regularize_type="stiffness_estimate"
    )
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    _, st_ = node(ps, st, x, training=True)
    assert float(st_["reg_val"]) != 0.0

    def regloss(ps):
        _, s = node(ps, st, x, training=True)
        return s["reg_val"]

    gp = jax.grad(regloss)(ps)
    gp_flat = _flat(gp)
    assert np.isfinite(gp_flat).all() and (gp_flat != 0).any()


def test_unbiased_saveat_strips_t1():
    ts = jnp.array([0.25, 0.5, 1.0])
    node = NeuralODE(
        Chain(Dense(2, 4, "tanh"), Dense(4, 2)),
        regularize="unbiased", saveat=ts, max_steps=32,
    )
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    sol, _ = node(ps, st, x, training=True)
    # user saveat grid preserved exactly (t1 removed from outputs)
    assert sol.ys.shape == (3, 4, 2)
    np.testing.assert_allclose(np.asarray(sol.ts), np.asarray(ts))


def test_rng_advances_between_calls():
    node = _make_node("unbiased", False)
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    _, st1 = node(ps, st, x, training=True)
    _, st2 = node(ps, st1, x, training=True)
    assert float(st1["reg_val"]) != float(st2["reg_val"])


def test_constructor_validation():
    dyn = Chain(Dense(2, 2))
    with pytest.raises(ValueError):
        NeuralODE(dyn, regularize="bogus")
    with pytest.raises(ValueError):
        NeuralODE(dyn, regularize_type="bogus")
    with pytest.raises(ValueError):
        NeuralODE(dyn, solver="rk4")
    # bool coercion (reference neural_ode.jl:14-16)
    assert NeuralODE(dyn, regularize=True).regularize == "unbiased"
    assert NeuralODE(dyn, regularize=False).regularize == "none"


def test_unknown_adjoint_raises():
    from localregneuralde_tpu.ode import odesolve

    with pytest.raises(ValueError):
        odesolve(
            lambda u, t, p: -u, jnp.ones(2), (0.0, 1.0),
            adjoint="bogus", max_steps=8,
        )


def test_stiffness_estimate_nonfinite_guard():
    """Overflowed stage values (inf/NaN — e.g. a diverged truncated solve)
    must yield reg = 0 with ZERO (not NaN) gradients: a NaN here silently
    poisons the training loss (observed at max_steps saturation).
    The double-where keeps the zeroed branch's backward clean."""
    from localregneuralde_tpu.ode.step import (
        Tsit5StepResult,
        regularization_value,
    )

    u = jnp.ones((2, 3))

    def reg_of(scale):
        ks = tuple(u * scale * (i + 1) for i in range(7))
        step = Tsit5StepResult(u * scale, u * 0.0, ks, u, None)
        return regularization_value(
            "stiffness_estimate", step, u, 0.1, 1e-6, 1e-6
        )

    # healthy scale: finite value, finite gradient
    v, g = jax.value_and_grad(reg_of)(2.0)
    assert np.isfinite(float(v)) and np.isfinite(float(g))

    # overflowed stages: inf norms -> guarded to exactly 0 with 0 grad
    big = jnp.float32(3.0e38)
    v_inf = reg_of(big)
    assert float(v_inf) == 0.0
    g_inf = jax.grad(lambda s: reg_of(s))(big)
    assert float(g_inf) == 0.0

    # NaN stages likewise
    v_nan = reg_of(jnp.float32(np.nan))
    assert float(v_nan) == 0.0
