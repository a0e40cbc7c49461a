"""Score-SDE sampler with locally regularized adaptive stepping.

The stretch configuration from the project baseline ("Score-SDE diffusion
sampler with locally regularized adaptive steps") and the motivating use
case of the reference paper: "some black boxes were meant to remain closed"
— a pretrained diffusion model's score network cannot be retrained, but the
*sampler's* step count can still be controlled by adaptive solvers whose
error estimates were shaped during training, or simply exploited at
inference via the adaptive SRI machinery of this framework.

Implements the VP-SDE (DDPM-continuous) family:

    forward:  du = −½ β(t) u dt + √β(t) dW
    reverse:  du = [−½ β(t) u − β(t) s_θ(u, t)] dt + √β(t) dW̄   (t: 1 → 0)

Sampling integrates the reverse SDE with the adaptive diagonal-noise solvers
(``sde/solve.py``) — SRI / Milstein / Euler–Heun — on a time-reversed clock,
with NFE statistics as first-class outputs. The probability-flow ODE variant
integrates the deterministic counterpart with the adaptive Tsit5 stack.

``score_fn(u, t, p) -> score``; any NN module can be adapted via
``module_score_fn``.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ode.solve import odesolve
from ..sde.solve import sdesolve


class VPSDE:
    """Variance-preserving SDE with linear β(t) = βmin + t·(βmax − βmin)."""

    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0):
        self.beta_min = float(beta_min)
        self.beta_max = float(beta_max)

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def marginal_log_alpha(self, t):
        """log α(t) where u(t) ~ N(√α u0, (1−α) I)."""
        return -0.5 * (
            self.beta_min * t + 0.5 * (self.beta_max - self.beta_min) * t ** 2
        )

    def marginal_std(self, t):
        return jnp.sqrt(1.0 - jnp.exp(2.0 * self.marginal_log_alpha(t)))


def sample_vpsde(
    score_fn: Optional[Callable],
    shape,
    key,
    p=None,
    *,
    sde: Optional[VPSDE] = None,
    t0: float = 1e-3,
    t1: float = 1.0,
    rtol: float = 1e-2,
    atol: float = 1e-2,
    solver: str = "sri",
    max_steps: int = 256,
    score_module=None,
):
    """Draw samples by integrating the reverse-time VP-SDE adaptively.

    Returns ``(samples, solution)`` — the solution carries NFE stats
    (drift/diffusion evals), the paper's headline observable for samplers.

    Internally integrates in τ = t1 − t (forward clock): for the reverse SDE
    ``du = f̄ dt + g dW̄`` with dt < 0, substituting τ gives
    ``du = −f̄(u, t1−τ) dτ + g(t1−τ) dWτ`` on τ ∈ [0, t1−t0].

    Pass exactly one of ``score_fn`` or ``score_module`` (a stateless
    score network whose raw params are ``p``).
    """
    sde = sde or VPSDE()
    key_init, key_noise = jax.random.split(key)
    u_init = jax.random.normal(key_init, shape)

    score_fn = _resolve_score_fn(score_fn, score_module)

    def drift(u, tau, p_):
        # reverse drift f̄ = f − g²s = −½βu − βs; in the τ = t1 − t clock
        # du/dτ = −f̄(u, t1−τ)
        t = t1 - tau
        b = sde.beta(t)
        f_rev = -0.5 * b * u - b * score_fn(u, t, p_)
        return -f_rev

    def diffusion(u, tau, p_):
        t = t1 - tau
        return jnp.sqrt(sde.beta(t)) * jnp.ones_like(u)

    sol = sdesolve(
        drift, diffusion, u_init, (0.0, t1 - t0), p,
        noise_key=key_noise, rtol=rtol, atol=atol, solver=solver,
        max_steps=max_steps, adjoint="none",
    )
    return sol.y_final, sol


def _resolve_score_fn(score_fn, score_module):
    """Single source of truth for the score: exactly one of ``score_fn``
    / ``score_module``."""
    if score_module is not None:
        if score_fn is not None:
            raise ValueError("pass exactly one of score_fn / score_module")
        return _raw_module_score_fn(score_module)
    if score_fn is None:
        raise ValueError("pass score_fn or score_module")
    return score_fn


def _raw_module_score_fn(module):
    """``module_score_fn`` for a stateless module whose raw params are
    passed as ``p`` (the ``sample_vpsde(score_module=...)`` contract)."""
    from ..core.containers import ArrayAndTime, get_array

    def score(u, t, p):
        empty = {name: {} for name in getattr(module, "layers", {})}
        y, _ = module(p, empty, ArrayAndTime(u, t))
        return get_array(y)

    return score


def sample_probability_flow(
    score_fn: Optional[Callable],
    shape,
    key,
    p=None,
    *,
    sde: Optional[VPSDE] = None,
    t0: float = 1e-3,
    t1: float = 1.0,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    max_steps: int = 256,
    score_module=None,
):
    """Deterministic probability-flow ODE sampler (adaptive Tsit5):
    du/dt = −½β(t)(u + s_θ(u, t)) integrated from t1 down to t0.

    Pass exactly one of ``score_fn`` or ``score_module`` (a stateless
    score network whose raw params are ``p``)."""
    sde = sde or VPSDE()
    u_init = jax.random.normal(key, shape)

    score_fn = _resolve_score_fn(score_fn, score_module)

    def dynamics(u, tau, p_):
        t = t1 - tau
        b = sde.beta(t)
        du_dt = -0.5 * b * (u + score_fn(u, t, p_))
        return -du_dt

    sol = odesolve(
        dynamics, u_init, (0.0, t1 - t0), p,
        rtol=rtol, atol=atol, max_steps=max_steps, adjoint="none",
    )
    return sol.y_final, sol


def gaussian_score_fn(mean=0.0, var=1.0, sde: Optional[VPSDE] = None):
    """Analytic score for data ~ N(mean, var) under the VP-SDE marginals —
    for validating the samplers without a trained network:
    s(u, t) = −(u − √α·mean) / (α·var + 1 − α)."""
    sde = sde or VPSDE()

    def score(u, t, p):
        alpha = jnp.exp(2.0 * sde.marginal_log_alpha(t))
        m = jnp.sqrt(alpha) * mean
        v = alpha * var + (1.0 - alpha)
        return -(u - m) / v

    return score


def module_score_fn(module, training: bool = False):
    """Adapt an (params, state)-style NN module into a score_fn; the module
    receives an ArrayAndTime so TDChain-style time conditioning works."""
    from ..core.containers import ArrayAndTime, get_array

    def score(u, t, p):
        y, _ = module(p["params"], p["state"], ArrayAndTime(u, t),
                      training=training)
        return get_array(y)

    return score
