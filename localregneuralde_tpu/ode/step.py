"""Differentiable single Tsit5 step and local regularizers.

This is the framework's L1 "solver-step delta": the explicit, traceable,
reverse-differentiable single Runge–Kutta step whose embedded error (or
stiffness) estimate becomes the local regularization signal of the paper.
Reference semantics: ``src/perform_step.jl:3-47``.

Dynamics convention throughout the framework::

    f(u, t, p, st) -> (du, st_new)

where ``st`` is optional carried layer state (e.g. BatchNorm statistics inside
a conv dynamics net); stateless dynamics simply return ``st`` unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax.numpy as jnp

from ..ops.residuals import error_residuals, internal_norm
from .tableaus import Tsit5Tableau as T


class Tsit5StepResult(NamedTuple):
    u_new: Any          # 5th-order solution at t + dt
    utilde: Any         # embedded error estimate (b − bhat contraction)
    ks: tuple           # all seven stage derivatives (k1..k7); k7 is FSAL-last
    g6: Any             # 6th stage argument (for the stiffness estimate)
    f_state: Any        # threaded dynamics state after the step


def tsit5_step(f: Callable, u, t, dt, k1, p, f_state) -> Tsit5StepResult:
    """One explicit Tsit5 step from ``(u, t)`` with FSAL first stage ``k1``.

    Exactly six new dynamics evaluations (k2..k7); ``k7 = f(u_new, t+dt)`` is
    the FSAL derivative reused as the next step's ``k1``.
    Reference: ``src/perform_step.jl:3-32``.
    """
    st = f_state
    k2, st = f(u + dt * (T.a21 * k1), t + T.c1 * dt, p, st)
    k3, st = f(u + dt * (T.a31 * k1 + T.a32 * k2), t + T.c2 * dt, p, st)
    k4, st = f(u + dt * (T.a41 * k1 + T.a42 * k2 + T.a43 * k3), t + T.c3 * dt, p, st)
    k5, st = f(
        u + dt * (T.a51 * k1 + T.a52 * k2 + T.a53 * k3 + T.a54 * k4),
        t + T.c4 * dt, p, st,
    )
    g6 = u + dt * (T.a61 * k1 + T.a62 * k2 + T.a63 * k3 + T.a64 * k4 + T.a65 * k5)
    k6, st = f(g6, t + dt, p, st)
    u_new = u + dt * (
        T.a71 * k1 + T.a72 * k2 + T.a73 * k3 + T.a74 * k4 + T.a75 * k5 + T.a76 * k6
    )
    k7, st = f(u_new, t + dt, p, st)
    utilde = dt * (
        T.btilde1 * k1
        + T.btilde2 * k2
        + T.btilde3 * k3
        + T.btilde4 * k4
        + T.btilde5 * k5
        + T.btilde6 * k6
        + T.btilde7 * k7
    )
    return Tsit5StepResult(u_new, utilde, (k1, k2, k3, k4, k5, k6, k7), g6, st)


def regularization_value(
    reg_type: str, step: Tsit5StepResult, u_prev, dt, atol, rtol
) -> jnp.ndarray:
    """Local regularizer computed from a single step.

    ``error_estimate`` (reference ``src/perform_step.jl:34-38``):
        sqrt(mean(residuals²)) · dt, residuals = ũ / (atol + max(|u₀|,|u₁|)·rtol)

    ``stiffness_estimate`` (reference ``src/perform_step.jl:40-47``):
        |rms(k7 − k6)| / (rms(u_new − g6) + eps) / stability_size
        (0 when the denominator RMS is exactly zero; NOT scaled by dt)
    """
    if reg_type == "error_estimate":
        res = error_residuals(step.utilde, u_prev, step.u_new, atol, rtol)
        return internal_norm(res) * dt
    elif reg_type == "stiffness_estimate":
        k7, k6 = step.ks[6], step.ks[5]
        # dtype-dependent epsilon like the reference's eps(eltype(u))
        # (perform_step.jl:45) — under x64/non-f32 states the small-
        # denominator behavior must track the state dtype
        eps = jnp.finfo(jnp.result_type(step.u_new)).eps
        # Guard both degenerate limits: den == 0 (the reference's explicit
        # `iszero(den) && return 0`, perform_step.jl:45) and non-finite
        # operands (inf/inf when a truncated/diverged solve overflows the
        # stage values — observed when stiffness regularization
        # drives the dynamics into max_steps saturation; the overflow
        # analog of the reference's zero-denominator case). Double-where
        # so the zeroed branch also has zero — not NaN — gradients.
        # Sanitize the norm INPUTS, not just the output: NaN born inside
        # the norms (inf − inf stages) survives a zero cotangent
        # (0 · NaN = NaN), so the fence must sit before the subtraction's
        # results enter any reduction.
        finite_in = (
            jnp.isfinite(num_x := k7 - k6).all()
            & jnp.isfinite(den_x := step.u_new - step.g6).all()
        )
        num = internal_norm(jnp.where(finite_in, num_x, 0.0))
        den = internal_norm(jnp.where(finite_in, den_x, 1.0))
        bad = ~finite_in | (den == 0.0) | ~jnp.isfinite(num + den)
        num_s = jnp.where(bad, 0.0, num)
        den_s = jnp.where(bad, 1.0, den)
        est = jnp.abs(num_s / (den_s + eps)) / T.stability_size
        return jnp.where(bad, jnp.zeros_like(est), est)
    raise ValueError(
        f"unknown regularize_type {reg_type!r}; expected 'error_estimate' or "
        "'stiffness_estimate'"
    )
