"""The adaptive Tsit5 loop against an independent integrator.

``scipy.integrate.solve_ivp`` (DOP853 at rtol 1e-11) integrates the same
vector fields in float64; the XLA loop must land within its requested
tolerance of it in every regime the training path uses: a saveat grid,
the stored adjoint's dense-knot and checkpoint-knot recording, the
reservoir sample of the biased regularizer, and the latent-ODE's
autonomous Dense chain on a 49-point observation grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from localregneuralde_tpu.ode import odesolve

T_END = 2.0
GRID = np.linspace(0.0, T_END, 7)
LATENT_GRID = np.linspace(0.0, 1.0, 49)


def _weights(seed, d_in, d_out, scale=0.8):
    rng = np.random.RandomState(seed)
    return (scale * rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)


# time-dependent tanh field: u' = tanh(u W + b + c t) - u/2, batch of 3
W = _weights(0, 4, 4)
B = np.linspace(-0.3, 0.3, 4).astype(np.float32)
C = np.float32(0.7)
U0 = np.random.RandomState(1).randn(3, 4).astype(np.float32)

# latent-chain field: u' = tanh(tanh(u) W1) W2 (autonomous Dense chain)
W1 = _weights(2, 4, 8, 1.2)
W2 = _weights(3, 8, 4, 1.2)
U0_LATENT = np.random.RandomState(4).randn(5, 4).astype(np.float32)


def _td(u, t, p):
    return jnp.tanh(u @ p["w"] + p["b"] + p["c"] * t) - 0.5 * u


def _td_np(t, y):
    u = y.reshape(U0.shape)
    return (np.tanh(u @ W + B + C * t) - 0.5 * u).ravel()


def _chain(u, t, p):
    return jnp.tanh(jnp.tanh(u) @ p["w1"]) @ p["w2"]


def _chain_np(t, y):
    u = y.reshape(U0_LATENT.shape)
    return (np.tanh(np.tanh(u) @ W1) @ W2).ravel()


def _reference(fn_np, u0, ts):
    ref = solve_ivp(fn_np, (0.0, float(ts[-1])), u0.ravel().astype(np.float64),
                    method="DOP853", rtol=1e-11, atol=1e-12, t_eval=ts,
                    dense_output=True)
    assert ref.success
    return ref


def _within_tolerance(got, want, rtol, atol):
    # a global error of a few hundred local tolerances, plus the float32
    # rounding the loop accumulates over its steps
    bound = 200.0 * (rtol * np.abs(want) + atol) + 5e-6 * (1.0 + np.abs(want))
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= bound).all(), float((err / bound).max())


CASES = [
    (regime, adjoint, rtol)
    for regime in ("end", "saveat", "reservoir", "latent_chain")
    for adjoint in ("none", "direct", "stored")
    for rtol in (1e-5, 1e-7)
] + [
    (regime, "stored", rtol)
    for regime in ("dense_knots", "checkpoint_knots")
    for rtol in (1e-5, 1e-7)
]


@pytest.mark.parametrize("regime,adjoint,rtol", CASES)
def test_odesolve_matches_dop853(regime, adjoint, rtol):
    atol = rtol * 1e-2
    kw = dict(rtol=rtol, atol=atol, max_steps=256, adjoint=adjoint)
    if regime == "latent_chain":
        fn, fn_np, u0, ts = _chain, _chain_np, U0_LATENT, LATENT_GRID
        p = {"w1": jnp.asarray(W1), "w2": jnp.asarray(W2)}
    else:
        fn, fn_np, u0 = _td, _td_np, U0
        ts = np.asarray([T_END]) if regime == "end" else GRID
        p = {"w": jnp.asarray(W), "b": jnp.asarray(B), "c": jnp.asarray(C)}
    if regime == "dense_knots":
        kw["knot_window"] = 256  # every accepted step keeps a dense knot
    if regime == "checkpoint_knots":
        kw["knot_window"] = 4  # past 4 accepted steps: √N checkpoints
    if regime == "reservoir":
        kw["reservoir_key"] = jax.random.PRNGKey(5)
    saveat = None if regime == "end" else jnp.asarray(ts, jnp.float32)
    sol = jax.jit(
        lambda p, u: odesolve(fn, u, (0.0, float(ts[-1])), p, saveat=saveat,
                              **kw)
    )(p, jnp.asarray(u0))
    assert bool(sol.success)
    ref = _reference(fn_np, u0, ts)
    want = ref.y.T.reshape((len(ts),) + u0.shape)
    _within_tolerance(sol.ys, want, rtol, atol)
    _within_tolerance(sol.y_final, want[-1], rtol, atol)
    nfe = int(sol.nfe)
    assert nfe == 2 + 6 * (int(sol.naccept) + int(sol.nreject))
    if regime == "reservoir":
        # the sample is an accepted step start: on the trajectory
        t_r = float(sol.reservoir_t)
        assert 0.0 <= t_r < T_END
        _within_tolerance(sol.reservoir_u, ref.sol(t_r).reshape(u0.shape),
                          rtol, atol)
