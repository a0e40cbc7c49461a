"""Stored discretize-through adjoint for the SDE solver.

Mirror of ``ode/stored_adjoint.py`` for the stochastic stack: the forward is
the early-exit ``while_loop`` recording ``(t, u)`` knots at accepted-step
boundaries; the backward is a reverse ``while_loop`` over ONLY the
``naccept`` recorded steps, transposing one SRI/Milstein/Euler–Heun step per
iteration via ``jax.vjp``. The Brownian increments are RECORDED by the
forward at accepted steps and consumed directly (bitwise the values the
forward used — the tree is a pure function of (key, t), so this equals
re-descending it, minus two 24-level descents per step) and never
differentiated. Saveat cotangents
split linearly (the forward's RODESolution-style interpolation):
``y_s = u + θ(u_new − u)`` ⇒ ``d_u += (1−θ)·ct``, ``d_u_new += θ·ct``.

**Single forward solve** (as in the ODE twin): the one ``custom_vjp`` primal
produces the differentiable outputs and the fenced auxiliaries (NFE stats,
reservoir sample, threaded f/g state) together — no duplicate stats solve.

dt/controller quantities receive no cotangents (framework-wide fencing);
``f_state``/``g_state`` gradients are fenced (BatchNorm-style state is
write-only in training). Memory: (max_steps+1) × state knots.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from .solve import SDESolution, sdesolve
from .step import (
    lamba_euler_heun_step,
    milstein_commute_step,
    milstein_commute_step_nondiag,
    sri_step,
)
from .tableaus import get_sri_tableau


def stored_sdesolve(
    f: Callable,
    g: Callable,
    u0,
    tspan,
    p=None,
    *,
    noise_key,
    rtol: float = 1e-2,
    atol: float = 1e-2,
    solver: str = "sri",
    delta: float = 1 / 6,
    saveat=None,
    max_steps: int = 256,
    dt0=None,
    stateful: bool = False,
    f_state: Any = None,
    g_state: Any = None,
    reservoir_key=None,
    brownian_depth: int = 24,
    noise_shape: Optional[tuple] = None,
) -> SDESolution:
    t0, t_end = float(tspan[0]), float(tspan[1])
    if saveat is None:
        saveat_arr = jnp.asarray([t_end], jnp.float32)
    else:
        saveat_arr = jnp.atleast_1d(jnp.asarray(saveat, jnp.float32))

    fn, gn = f, g
    if stateful:
        def fn(u, t, p_):  # noqa: F811 — state fenced under this adjoint
            du, _ = f(u, t, p_, f_state)
            return du

        def gn(u, t, p_):  # noqa: F811
            du, _ = g(u, t, p_, g_state)
            return du

    def fn_st(u, t, p_, st):
        return fn(u, t, p_), st

    def gn_st(u, t, p_, st):
        return gn(u, t, p_), st

    solve_kwargs = dict(
        noise_key=noise_key, rtol=rtol, atol=atol, solver=solver,
        delta=delta, max_steps=max_steps, dt0=dt0,
        brownian_depth=brownian_depth, noise_shape=noise_shape,
    )

    def step_out(p_, u, t, dt, dW, dZ):
        if solver in ("sri", "sosri"):
            res = sri_step(
                fn_st, gn_st, u, t, dt, dW, dZ, p_, None, None,
                atol, rtol, delta, tableau=get_sri_tableau(solver),
            )
        elif solver == "milstein":
            if noise_shape is not None:
                res = milstein_commute_step_nondiag(
                    fn_st, gn_st, u, t, dt, dW, p_, None, None, atol, rtol
                )
            else:
                res = milstein_commute_step(
                    fn_st, gn_st, u, t, dt, dW, p_, None, None, atol, rtol
                )
        else:
            res = lamba_euler_heun_step(
                fn_st, gn_st, u, t, dt, dW, p_, None, None,
                atol, rtol, delta,
            )
        return res.u_new

    def run_solve(u0_, p_, saveat_):
        # THE forward solve: differentiable outputs and fenced auxiliaries
        # (stats, reservoir, threaded f/g state, knots) from one integration.
        return sdesolve(
            f, g, u0_, (t0, t_end), p_, saveat=saveat_, adjoint="none",
            record_knots=True, stateful=stateful, f_state=f_state,
            g_state=g_state, reservoir_key=reservoir_key, **solve_kwargs,
        )

    def outputs(sol):
        return (
            sol.ys, sol.y_final, sol.t_final, sol.nfe_drift,
            sol.nfe_diffusion, sol.naccept, sol.nreject, sol.success,
            sol.reservoir_t, sol.reservoir_u, sol.f_state, sol.g_state,
        )

    @jax.custom_vjp
    def core(u0, p, saveat_arr):
        return outputs(run_solve(u0, p, saveat_arr))

    def core_fwd(u0, p, saveat_arr):
        sol = run_solve(u0, p, saveat_arr)
        res = (u0, p, saveat_arr, sol.knot_ts, sol.knot_us, sol.knot_dws,
               sol.knot_dzs, sol.naccept)
        return outputs(sol), res

    def core_bwd(res, cts):
        (u0, p, saveat_arr, knot_ts, knot_us, knot_dws, knot_dzs,
         naccept) = res
        # aux outputs are gradient-fenced: only ys / y_final cotangents flow
        ct_ys, ct_y = cts[0], cts[1]
        p_flat, unravel_p = ravel_pytree(p)

        # entries the forward never wrote still hold the u0 broadcast —
        # an identity function of u0: saveat <= t0 (by contract) AND
        # anything beyond the last accepted time (truncated/failed
        # solves). Dropping the latter silently zeroed d_u0 exactly in
        # the max_steps-exhausted regime.
        t_last = knot_ts[naccept]
        unwritten = (
            (saveat_arr <= t0) | (saveat_arr > t_last)
        ).astype(u0.dtype)
        d_u0_pre = jnp.sum(
            ct_ys * unwritten.reshape((-1,) + (1,) * u0.ndim), axis=0
        )

        def body(carry):
            j, a_u, a_p = carry
            t = knot_ts[j]
            tn = knot_ts[j + 1]
            dt = tn - t
            u = knot_us[j]
            dW = lax.stop_gradient(knot_dws[j])
            dZ = lax.stop_gradient(knot_dzs[j])

            # linear saveat interpolation cotangent split
            theta = jnp.clip((saveat_arr - t) / dt, 0.0, 1.0)
            hit = ((saveat_arr > t) & (saveat_arr <= tn)).astype(u.dtype)
            shape = (-1,) + (1,) * u.ndim
            ct_hit = ct_ys * hit.reshape(shape)
            d_u_interp = jnp.sum(
                (1.0 - theta).reshape(shape) * ct_hit, axis=0
            )
            d_unew_interp = jnp.sum(theta.reshape(shape) * ct_hit, axis=0)

            _, vjp = jax.vjp(step_out, p, u, t, dt, dW, dZ)
            d_p, d_u, _dt_, _ddt, _dw, _dz = vjp(a_u + d_unew_interp)
            d_p_flat, _ = ravel_pytree(d_p)
            return (j - 1, d_u + d_u_interp, a_p + d_p_flat)

        carry0 = (naccept - 1, ct_y, jnp.zeros_like(p_flat))
        _, a_u, a_p = lax.while_loop(lambda c: c[0] >= 0, body, carry0)
        return a_u + d_u0_pre, unravel_p(a_p), jnp.zeros_like(saveat_arr)

    core.defvjp(core_fwd, core_bwd)

    (ys, y_final, t_final, nfe_d, nfe_g, naccept, nreject, success, res_t,
     res_u, f_state_out, g_state_out) = core(u0, p, saveat_arr)
    return SDESolution(
        ts=saveat_arr, ys=ys, t_final=t_final, y_final=y_final,
        nfe_drift=nfe_d, nfe_diffusion=nfe_g, naccept=naccept,
        nreject=nreject, success=success, reservoir_t=res_t,
        reservoir_u=res_u, f_state=f_state_out, g_state=g_state_out,
    )
