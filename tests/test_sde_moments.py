"""Adaptive SDE solves against the analytic moments of OU and GBM.

Each solve carries 2000 independent paths in one batch (diagonal noise:
one Brownian coordinate per path; the shared adaptive grid steps them
together). The sample mean and variance at T = 1 must match the closed
forms within their sampling error plus the method's weak error at the
tolerance used. Euler–Heun integrates in the Stratonovich sense, which
for GBM shifts the drift by σ²/2; for OU (additive noise) the two
readings agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.sde import sdesolve

N_PATHS = 2000
THETA, SIG_OU, U0_OU = 1.0, 0.5, 1.0
MU, SIG_GBM = 0.2, 0.4


def _moments(process, stratonovich):
    t = 1.0
    if process == "ou":
        mean = U0_OU * np.exp(-THETA * t)
        var = SIG_OU ** 2 / (2 * THETA) * (1 - np.exp(-2 * THETA * t))
        return mean, var
    mu = MU + (SIG_GBM ** 2 / 2 if stratonovich else 0.0)
    mean = np.exp(mu * t)
    var = np.exp(2 * mu * t) * (np.exp(SIG_GBM ** 2 * t) - 1)
    return mean, var


def _fields(process, nondiag):
    if process == "ou":
        def f(u, t, p):
            return -THETA * u

        if nondiag:
            # two noise channels of σ/√2 each: the same total variance
            def g(u, t, p):
                return jnp.full(u.shape + (2,), SIG_OU / np.sqrt(2.0))
        else:
            def g(u, t, p):
                return jnp.full_like(u, SIG_OU)
        return f, g, U0_OU

    def f(u, t, p):
        return MU * u

    def g(u, t, p):
        return SIG_GBM * u

    return f, g, 1.0


CASES = [
    ("sri", "ou", "none", 1e-2),
    ("sri", "gbm", "none", 1e-2),
    ("sosri", "ou", "none", 1e-2),
    ("sosri", "gbm", "none", 1e-2),
    ("sosri", "gbm", "stored", 1e-2),
    ("milstein", "ou", "none", 5e-2),
    ("milstein", "gbm", "none", 5e-2),
    ("milstein_nondiag", "ou", "none", 5e-2),
    ("euler_heun", "ou", "none", 1e-2),
    ("euler_heun", "gbm", "none", 1e-2),
]


@pytest.mark.parametrize("solver,process,adjoint,tol", CASES)
def test_sde_moments(solver, process, adjoint, tol):
    nondiag = solver == "milstein_nondiag"
    f, g, u0 = _fields(process, nondiag)
    shape = (N_PATHS, 1) if nondiag else (N_PATHS,)
    u = jnp.full(shape, u0, jnp.float32)
    sol = jax.jit(lambda u: sdesolve(
        f, g, u, (0.0, 1.0), None, noise_key=jax.random.PRNGKey(42),
        rtol=tol, atol=tol, solver="milstein" if nondiag else solver,
        max_steps=2048, adjoint=adjoint,
        noise_shape=(N_PATHS, 2) if nondiag else None,
    ))(u)
    assert bool(sol.success)
    y = np.asarray(sol.y_final, np.float64).ravel()
    mean, var = _moments(process, solver == "euler_heun")
    se_mean = np.sqrt(var / N_PATHS)
    se_var = var * np.sqrt(2.0 / N_PATHS)
    assert abs(y.mean() - mean) <= 5 * se_mean + 0.02 * abs(mean), (
        y.mean(), mean)
    assert abs(y.var() - var) <= 6 * se_var + 0.05 * var, (y.var(), var)
