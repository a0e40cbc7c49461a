"""Stored adjoint tests: exact parity with the direct (discretize-through)
adjoint — both are pure optimize-then-discretize, so they agree to fp
rounding — including saveat cotangents, the fused-kernel route, and
NeuralODE's regularized path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.models import NeuralODE, TDChain, diffeqsol_to_array
from localregneuralde_tpu.nn import Chain, Dense
from localregneuralde_tpu.ode import odesolve


def _f(u, t, p):
    return jnp.tanh(p["w"] @ u + p["b"]) - 0.5 * u


def _setup():
    key = jax.random.PRNGKey(0)
    p = {"w": jax.random.normal(key, (4, 4)) * 0.5, "b": jnp.zeros(4)}
    u0 = jax.random.normal(jax.random.PRNGKey(1), (4,))
    return u0, p


def _make_loss(adjoint):
    def loss(u0, p):
        sol = odesolve(
            _f, u0, (0.0, 1.0), p, rtol=1e-7, atol=1e-9, max_steps=128,
            saveat=jnp.array([0.0, 0.4, 1.0]), adjoint=adjoint,
        )
        return (
            jnp.sum(sol.y_final ** 2)
            + jnp.sum(sol.ys[1] ** 2)
            + jnp.sum(sol.ys[0])  # saveat at t0 → direct u0 path
        )

    return loss


def test_stored_matches_direct_to_rounding():
    u0, p = _setup()
    gd = jax.jit(jax.grad(_make_loss("direct"), argnums=(0, 1)))(u0, p)
    gs = jax.jit(jax.grad(_make_loss("stored"), argnums=(0, 1)))(u0, p)
    np.testing.assert_allclose(
        np.asarray(gd[0]), np.asarray(gs[0]), rtol=1e-4, atol=1e-6
    )
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(gd[1][k]), np.asarray(gs[1][k]), rtol=1e-4, atol=1e-6
        )


def test_stored_primal_identical_to_forward():
    u0, p = _setup()
    assert float(_make_loss("none")(u0, p)) == float(
        _make_loss("stored")(u0, p)
    )


@pytest.mark.parametrize("biased", [False, True])
def test_neural_ode_with_stored_adjoint(biased):
    """Stored and direct adjoints give the same gradients through the
    layer, for the unbiased (dense-output t1) and the biased
    (reservoir-sampled t1) regularizer."""
    F, H, B = 16, 8, 4
    mode = "biased" if biased else "unbiased"
    dyn = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    node = NeuralODE(
        dyn, regularize=mode, adjoint="stored",
        rtol=1e-3, atol=1e-5, max_steps=32,
    )
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (B, F))

    def loss(ps, x):
        sol, st_ = node(ps, st, x, training=True)
        return jnp.sum(diffeqsol_to_array(sol)) + st_["reg_val"]

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(ps, x)
    leaves = np.concatenate(
        [np.ravel(np.asarray(l)) for l in jax.tree_util.tree_leaves(gp)]
    )
    assert np.isfinite(leaves).all() and (leaves != 0).any()
    assert np.isfinite(np.asarray(gx)).all()

    # stored vs direct on the same layer: gradients agree
    node_d = NeuralODE(
        dyn, regularize=mode, adjoint="direct",
        rtol=1e-3, atol=1e-5, max_steps=32,
    )

    def loss_d(ps, x):
        sol, st_ = node_d(ps, st, x, training=True)
        return jnp.sum(diffeqsol_to_array(sol)) + st_["reg_val"]

    gp_d, _ = jax.jit(jax.grad(loss_d, argnums=(0, 1)))(ps, x)
    for a, b in zip(
        jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gp_d)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-5
        )


def test_sde_stored_matches_direct():
    from localregneuralde_tpu.sde import sdesolve

    def f(u, t, p):
        return jnp.tanh(p["w"] @ u) - 0.5 * u

    def g(u, t, p):
        return 0.2 * u

    p = {"w": jax.random.normal(jax.random.PRNGKey(0), (4, 4)) * 0.5}
    u0 = jnp.ones(4)
    nk = jax.random.PRNGKey(5)

    def make_loss(adj):
        def loss(u0, p):
            sol = sdesolve(
                f, g, u0, (0.0, 1.0), p, noise_key=nk, rtol=1e-2, atol=1e-2,
                saveat=jnp.array([0.5, 1.0]), max_steps=128, adjoint=adj,
            )
            return jnp.sum(sol.y_final ** 2) + jnp.sum(sol.ys[0] ** 2)

        return loss

    assert float(make_loss("direct")(u0, p)) == float(
        make_loss("stored")(u0, p)
    )
    gd = jax.jit(jax.grad(make_loss("direct"), argnums=(0, 1)))(u0, p)
    gs = jax.jit(jax.grad(make_loss("stored"), argnums=(0, 1)))(u0, p)
    np.testing.assert_allclose(
        np.asarray(gd[0]), np.asarray(gs[0]), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(gd[1]["w"]), np.asarray(gs[1]["w"]), rtol=1e-4, atol=1e-6
    )


def test_stateful_dynamics_bn_state_updates_under_stored():
    """BatchNorm inside the dynamics (the CIFAR family pattern): the single
    custom-VJP solve must thread the running statistics (no separate stats
    solve exists anymore), and gradients must match the direct adjoint —
    exact because BN in training mode normalizes with batch stats, so the
    threaded state never alters outputs mid-solve."""
    from localregneuralde_tpu.nn import BatchNorm

    F, B = 6, 8
    dyn = Chain(Dense(F, F, "tanh"), BatchNorm(F))

    def make(adjoint):
        return NeuralODE(
            dyn, regularize="none", adjoint=adjoint,
            rtol=1e-3, atol=1e-5, max_steps=32,
        )

    node = make("stored")
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (B, F))

    def fwd(ps, x):
        sol, st_ = node(ps, st, x, training=True)
        return jnp.sum(diffeqsol_to_array(sol)), st_

    (loss_s, st_s), gp = jax.jit(
        jax.value_and_grad(fwd, has_aux=True)
    )(ps, x)

    bn0 = st["model"]["layer_1"]
    bn1 = st_s["model"]["layer_1"]
    # running stats actually moved through the solve
    assert not np.allclose(np.asarray(bn0["mean"]), np.asarray(bn1["mean"]))
    assert not np.allclose(np.asarray(bn0["var"]), np.asarray(bn1["var"]))
    assert int(st_s["nfe"]) > 0

    node_d = make("direct")

    def fwd_d(ps, x):
        sol, st_ = node_d(ps, st, x, training=True)
        return jnp.sum(diffeqsol_to_array(sol)), st_

    (loss_d, st_d), gp_d = jax.jit(
        jax.value_and_grad(fwd_d, has_aux=True)
    )(ps, x)
    np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-6)
    # atol 1e-5: the BN scale gradient is analytically ~0 (batch-centered
    # activations sum to zero), so that leaf is cancellation noise under the
    # two adjoints' different reduction orders.
    for a, b in zip(
        jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gp_d)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
        )


def test_two_level_windowed_matches_single_level():
    """knot_window < max_steps triggers checkpoint+replay; the replay is a
    deterministic re-execution of the same math, so gradients must match
    the single-level sweep to compiler-fusion rounding (the windowed branch
    lives inside lax.cond, which XLA may fuse differently — ≤ a few ULP)."""
    from localregneuralde_tpu.ode.stored_adjoint import stored_odesolve

    u0, p = _setup()
    sv = jnp.array([0.0, 0.37, 0.81, 1.0])

    def make_loss(window):
        def loss(u0, p):
            sol = stored_odesolve(
                _f, u0, (0.0, 1.0), p, rtol=1e-7, atol=1e-9, max_steps=128,
                saveat=sv, knot_window=window,
            )
            return jnp.sum(sol.y_final ** 2) + jnp.sum(sol.ys[1] ** 2) + jnp.sum(
                sol.ys[2] * sol.ys[0]
            )

        return loss

    g1 = jax.jit(jax.grad(make_loss(128), argnums=(0, 1)))(u0, p)  # single
    g2 = jax.jit(jax.grad(make_loss(7), argnums=(0, 1)))(u0, p)    # windowed
    np.testing.assert_allclose(
        np.asarray(g1[0]), np.asarray(g2[0]), rtol=1e-5, atol=1e-6
    )
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(g1[1][k]), np.asarray(g2[1][k]), rtol=1e-5, atol=1e-6
        )
    # primals identical (forward path is shared)
    np.testing.assert_array_equal(
        np.asarray(make_loss(128)(u0, p)), np.asarray(make_loss(7)(u0, p))
    )


def test_large_capacity_auto_windowing():
    """max_steps > 512 auto-enables the two-level scheme (W = ⌈√N⌉): the
    memory-feasible path for reference-scale maxiters=10_000. Gradients must
    match the direct adjoint."""
    u0, p = _setup()

    def loss_stored(u0, p):
        sol = odesolve(
            _f, u0, (0.0, 1.0), p, rtol=1e-9, atol=1e-11, max_steps=2048,
            adjoint="stored",
        )
        return jnp.sum(sol.y_final ** 2)

    def loss_direct(u0, p):
        sol = odesolve(
            _f, u0, (0.0, 1.0), p, rtol=1e-9, atol=1e-11, max_steps=2048,
            checkpoint_every=64, adjoint="direct",
        )
        return jnp.sum(sol.y_final ** 2)

    gs = jax.jit(jax.grad(loss_stored, argnums=(0, 1)))(u0, p)
    gd = jax.jit(jax.grad(loss_direct, argnums=(0, 1)))(u0, p)
    np.testing.assert_allclose(
        np.asarray(gs[0]), np.asarray(gd[0]), rtol=1e-4, atol=1e-6
    )
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(gs[1][k]), np.asarray(gd[1][k]), rtol=1e-4, atol=1e-6
        )


def test_truncated_solve_routes_uncovered_saveat_grads_to_u0():
    """A solve that exhausts max_steps leaves uncovered saveat entries at
    their u0 broadcast (the forward's init) — an identity function of u0.
    The stored backward must credit d_u0 with those cotangents (it used
    to silently drop them in exactly this truncation regime)."""
    u0, p = _setup()
    saveat = jnp.asarray([0.5, 1.0])

    def loss(u0_):
        sol = odesolve(
            _f, u0_, (0.0, 1.0), p, rtol=1e-12, atol=1e-14, max_steps=2,
            adjoint="stored", saveat=saveat,
        )
        return jnp.sum(sol.ys), sol.success

    sol_ok = loss(u0)[1]
    assert not bool(sol_ok), "config must truncate for this test"
    g = jax.grad(lambda u: loss(u)[0])(u0)
    # both entries uncovered -> ys = [u0, u0] -> d_u0 = 2 * ones
    np.testing.assert_allclose(np.asarray(g), 2.0, rtol=1e-6)


def test_truncated_sde_solve_routes_uncovered_saveat_grads_to_u0():
    from localregneuralde_tpu.sde import sdesolve

    u0 = jnp.arange(1.0, 5.0)

    def loss(u0_):
        sol = sdesolve(
            lambda u, t, p: -u, lambda u, t, p: 0.1 * jnp.ones_like(u),
            u0_, (0.0, 1.0), noise_key=jax.random.PRNGKey(0),
            rtol=1e-12, atol=1e-14, max_steps=2, adjoint="stored",
            saveat=jnp.asarray([1.0]),
        )
        return jnp.sum(sol.ys), sol.success

    assert not bool(loss(u0)[1])
    g = jax.grad(lambda u: loss(u)[0])(u0)
    np.testing.assert_allclose(np.asarray(g), 1.0, rtol=1e-6)
