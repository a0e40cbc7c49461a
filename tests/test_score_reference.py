"""Score samplers against closed forms for Gaussian data.

For data ~ N(m, v) the VP-SDE marginal at time t is N(√α_t m, α_t v +
1 − α_t), its score is linear, and the probability-flow ODE is linear per
coordinate: a sample started at u(t1) ends at
m_t0 + √(var_t0 / var_t1)·(u(t1) − m_t1). The probability-flow sampler
must land on that map point by point; the reverse-SDE sampler's samples
must have the data's mean and variance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.models import TDChain
from localregneuralde_tpu.models.score_sde import (
    VPSDE,
    gaussian_score_fn,
    sample_probability_flow,
    sample_vpsde,
)
from localregneuralde_tpu.nn import Dense

T0, T1 = 1e-3, 1.0


def _marginal(sde, t, mean, var):
    alpha = float(np.exp(2.0 * sde.marginal_log_alpha(t)))
    return np.sqrt(alpha) * mean, alpha * var + 1.0 - alpha


def _identity_score_net(f):
    """A TDChain score network realizing s(u, t) = −u: the exact score of
    N(0, I) data at every t."""
    net = TDChain(Dense(f + 1, f))
    w = jnp.zeros((f + 1, f)).at[:f].set(-jnp.eye(f))
    return net, {"layer_0": {"w": w, "b": jnp.zeros(f)}}


PF_CASES = [
    (mean, var, rtol, kind)
    for (mean, var, kind) in (
        (0.0, 1.0, "module"), (2.0, 0.25, "fn"), (-1.0, 1.0, "fn"),
        (0.5, 4.0, "fn"),
    )
    for rtol in (1e-4, 1e-6)
]


@pytest.mark.parametrize("mean,var,rtol,kind", PF_CASES)
def test_probability_flow_matches_closed_form(mean, var, rtol, kind):
    sde = VPSDE()
    shape = (64, 4)
    key = jax.random.PRNGKey(3)
    if kind == "module":
        net, params = _identity_score_net(shape[-1])
        kw = dict(score_module=net)
        score, p = None, params
    else:
        kw = {}
        score, p = gaussian_score_fn(mean=mean, var=var, sde=sde), None
    s, sol = sample_probability_flow(
        score, shape, key, p, sde=sde, t0=T0, t1=T1, rtol=rtol,
        atol=rtol * 1e-2, max_steps=1024, **kw,
    )
    assert bool(sol.success)
    u1 = np.asarray(jax.random.normal(key, shape), np.float64)
    m1, v1 = _marginal(sde, T1, mean, var)
    m0, v0 = _marginal(sde, T0, mean, var)
    want = m0 + np.sqrt(v0 / v1) * (u1 - m1)
    err = np.abs(np.asarray(s, np.float64) - want)
    assert (err <= 300 * rtol * (1 + np.abs(want)) + 1e-5).all(), err.max()


# the order-0.5 Euler–Heun pair needs a tighter tolerance than the SRI
# methods for the same weak error
SDE_CASES = [
    (solver, tol, mean, var)
    for (solver, tol) in (("sri", 5e-2), ("sosri", 5e-2), ("sosri", 1e-2),
                          ("euler_heun", 5e-3))
    for (mean, var) in ((2.0, 0.25), (-0.5, 1.0))
]


@pytest.mark.parametrize("solver,tol,mean,var", SDE_CASES)
def test_vpsde_sampler_moments(solver, tol, mean, var):
    """The diffusion is additive (√β(t)), so Itô and Stratonovich solvers
    sample the same law."""
    sde = VPSDE()
    n = 4096
    s, sol = jax.jit(lambda k: sample_vpsde(
        gaussian_score_fn(mean=mean, var=var, sde=sde), (n,), k, sde=sde,
        t0=T0, t1=T1, rtol=tol, atol=tol, solver=solver, max_steps=1024,
    ))(jax.random.PRNGKey(9))
    assert bool(sol.success)
    s = np.asarray(s, np.float64)
    m0, v0 = _marginal(sde, T0, mean, var)
    assert abs(s.mean() - m0) <= 5 * np.sqrt(v0 / n) + 0.03 * np.sqrt(v0)
    assert abs(s.var() - v0) <= 6 * v0 * np.sqrt(2.0 / n) + 0.08 * v0
