"""Stored-adjoint gradients against two independent references.

The stored adjoint transposes the recorded accepted steps one at a time
(dense knots), or replays √N-step windows from checkpoints first
(``knot_window`` below the step count). Its gradient must equal the
direct adjoint's (reverse mode through the scanned loop: the same
discretization, another code path) and a central finite difference of the
loss along a random direction, in each regime the training path uses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from localregneuralde_tpu.ode import odesolve


def _td(u, t, p):
    return jnp.tanh(u @ p["w"] + p["b"] * (1.0 + t)) - 0.5 * u


def _chain(u, t, p):
    return jnp.tanh(jnp.tanh(u) @ p["w"]) @ p["w2"]


def _params(problem):
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    if problem == "latent_chain":
        return {
            "w": 0.9 * jax.random.normal(k1, (4, 8)) / 2.0,
            "w2": 0.9 * jax.random.normal(k2, (8, 4)) / 2.8,
        }
    return {
        "w": 0.8 * jax.random.normal(k1, (4, 4)) / 2.0,
        "b": 0.3 * jax.random.normal(k2, (4,)),
    }


def _loss(problem, regime, adjoint):
    fn = _chain if problem == "latent_chain" else _td
    saveat = {
        "latent_chain": jnp.linspace(0.0, 1.0, 9),
        "saveat_grid": jnp.asarray([0.0, 0.3, 0.7, 1.0]),
    }.get(problem)
    kw = dict(rtol=1e-6, atol=1e-8, max_steps=128, adjoint=adjoint,
              saveat=saveat)
    if adjoint == "stored" and regime == "two_level":
        kw["knot_window"] = 4
    if problem == "reservoir":
        kw["reservoir_key"] = jax.random.PRNGKey(3)

    def loss(p, u0):
        sol = odesolve(fn, u0, (0.0, 1.0), p, **kw)
        return jnp.sum(jnp.sin(sol.ys)) + 0.5 * jnp.sum(sol.y_final ** 2)

    return loss


CASES = [
    (problem, regime, ref)
    for problem in ("tanh_td", "saveat_grid", "latent_chain", "reservoir")
    for regime in ("dense", "two_level")
    for ref in ("direct", "finite_difference")
]


@pytest.mark.parametrize("problem,regime,ref", CASES)
def test_stored_adjoint_gradient(problem, regime, ref):
    p = _params(problem)
    u0 = jax.random.normal(jax.random.PRNGKey(2), (3, 4))
    stored = _loss(problem, regime, "stored")
    g_p, g_u = jax.jit(jax.grad(stored, argnums=(0, 1)))(p, u0)
    flat, unravel = ravel_pytree((g_p, g_u))
    flat = np.asarray(flat, np.float64)
    assert np.isfinite(flat).all() and np.abs(flat).max() > 0
    if ref == "direct":
        d_p, d_u = jax.jit(jax.grad(_loss(problem, regime, "direct"),
                                    argnums=(0, 1)))(p, u0)
        want, _ = ravel_pytree((d_p, d_u))
        np.testing.assert_allclose(flat, np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
        return
    # directional derivative along a random unit direction v
    v = np.random.RandomState(7).randn(flat.size)
    v /= np.linalg.norm(v)
    vp, vu = unravel(jnp.asarray(v, jnp.float32))
    eps = 1e-2
    f = jax.jit(stored)

    def at(s):
        shift = jax.tree_util.tree_map(lambda a, d: a + s * d, p, vp)
        return float(f(shift, u0 + s * vu))

    fd = (at(eps) - at(-eps)) / (2.0 * eps)
    analytic = float(flat @ v)
    assert abs(fd - analytic) <= 2e-3 * max(abs(analytic), 1e-2), (
        fd, analytic)
