"""PI step-size controller and initial-dt heuristic.

Replacements for the controller machinery the reference delegates
to OrdinaryDiffEq (SURVEY.md §2d): pure XLA scalar ops, fully traceable, no
data-dependent Python control flow. Controller parameters follow the standard
defaults for a 5th-order explicit pair: gamma 9/10, qmin 1/5, qmax 10,
beta1 = 7/(10·order), beta2 = 2/(5·order), qoldinit 1e-4, with acceptance at
scaled error EEst ≤ 1.

The whole controller is *non-differentiable by design*: callers wrap its
outputs in ``lax.stop_gradient`` so no gradient flows through step-size
selection (matching the reference's ``@non_differentiable`` fences,
``src/utils.jl:60-61``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

from ..ops.residuals import internal_norm


class PIController(NamedTuple):
    gamma: float = 0.9
    qmin: float = 0.2
    qmax: float = 10.0
    beta1: float = 0.14   # 7 / (10 * 5) for a 5th-order pair
    beta2: float = 0.08   # 2 / (5 * 5)
    qoldinit: float = 1e-4

    @staticmethod
    def for_order(order: int) -> "PIController":
        return PIController(beta1=7.0 / (10.0 * order), beta2=2.0 / (5.0 * order))

    def propose(self, eest, dt, qold):
        """Return (dt_accept, dt_reject, qold_accept) given the scaled error.

        dt_accept: step size for the next step if this one is accepted.
        dt_reject: retry step size if this one is rejected.
        Non-finite ``eest`` (diverging dynamics) halves the step.
        """
        eest = jnp.asarray(eest)
        finite = jnp.isfinite(eest)
        eest_safe = jnp.where(finite, jnp.maximum(eest, 0.0), 1.0)
        q11 = jnp.power(eest_safe, self.beta1)
        q = q11 / jnp.power(qold, self.beta2)
        q = jnp.maximum(
            1.0 / self.qmax, jnp.minimum(1.0 / self.qmin, q / self.gamma)
        )
        dt_accept = jnp.where(finite, dt / q, dt * 0.5)
        dt_reject = jnp.where(
            finite,
            dt / jnp.minimum(1.0 / self.qmin, q11 / self.gamma),
            dt * 0.5,
        )
        qold_accept = jnp.maximum(eest_safe, self.qoldinit)
        return dt_accept, dt_reject, qold_accept


def initial_step_size(
    f: Callable, u0, t0, p, f_state, order: int, rtol, atol, direction=1.0,
    f0=None,
):
    """Hairer–Nørsett–Wanner automatic initial step size (HNW II.4).

    Costs one extra dynamics evaluation when ``f0`` (the derivative at
    ``(u0, t0)``) is already available, two otherwise. Returns ``(dt0, nfe)``.
    """
    nfe = 0
    if f0 is None:
        f0, _ = f(u0, t0, p, f_state)
        nfe += 1
    sc = atol + jnp.abs(u0) * rtol
    d0 = internal_norm(u0 / sc)
    d1 = internal_norm(f0 / sc)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    dt0 = jnp.where(small, 1e-6, 0.01 * d0 / jnp.where(d1 == 0, 1.0, d1))
    u1 = u0 + direction * dt0 * f0
    f1, _ = f(u1, t0 + direction * dt0, p, f_state)
    nfe += 1
    d2 = internal_norm((f1 - f0) / sc) / dt0
    dmax = jnp.maximum(d1, d2)
    dt1 = jnp.where(
        dmax <= 1e-15,
        jnp.maximum(1e-6, dt0 * 1e-3),
        jnp.power(0.01 / dmax, 1.0 / (order + 1.0)),
    )
    return jnp.minimum(100.0 * dt0, dt1), nfe
