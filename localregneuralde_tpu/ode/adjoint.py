"""Continuous (backsolve) adjoint for the adaptive ODE solver.

The reference's default sensitivity algorithm is a continuous adjoint
(``InterpolatingAdjoint(autojacvec=ZygoteVJP())``,
``src/layers/neural_ode.jl:11``): the backward pass integrates the adjoint
ODE instead of storing the forward trajectory. This module provides the
analog as ``odesolve(..., adjoint='backsolve')``:

- forward: the fast early-exit ``while_loop`` integrator (no taping);
- backward: one augmented adaptive solve in reversed time carrying
  ``(u, a_u, a_p)`` with ``da_u = −a_uᵀ∂f/∂u dt`` and ``da_p = −a_uᵀ∂f/∂p dt``
  (per-eval ``jax.vjp`` of the dynamics — the ZygoteVJP analog), flattened to
  a single state vector via ``ravel_pytree``;
- saveat cotangents are injected segment-by-segment at their (descending)
  output times.

Memory is O(state), independent of step count — the right trade for long
integrations; the default ``adjoint='direct'`` (discretize-through) remains
the exactness-preferred choice. Stats/reservoir/f_state outputs are
gradient-fenced under this adjoint.
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from .solve import ODESolution, odesolve


def backsolve_odesolve(
    f: Callable,
    u0,
    tspan,
    p=None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-7,
    saveat=None,
    max_steps: int = 256,
    stateful: bool = False,
    f_state: Any = None,
    reservoir_key=None,
) -> ODESolution:
    """Adaptive Tsit5 solve whose VJP integrates the adjoint ODE backward."""
    t0, t_end = float(tspan[0]), float(tspan[1])
    if saveat is None:
        saveat_arr = jnp.asarray([t_end], jnp.float32)
    else:
        saveat_arr = jnp.atleast_1d(jnp.asarray(saveat, jnp.float32))

    fn = f
    if stateful:
        def fn(u, t, p_):  # noqa: F811 — strip state (fenced under backsolve)
            du, _ = f(u, t, p_, f_state)
            return du

    solve_kwargs = dict(rtol=rtol, atol=atol, max_steps=max_steps)

    def run_solve(u0_, p_, saveat_):
        # THE forward solve: differentiable outputs and fenced auxiliaries
        # (stats, reservoir, threaded f_state) from one integration.
        return odesolve(
            f, u0_, (t0, t_end), p_, saveat=saveat_, adjoint="none",
            stateful=stateful, f_state=f_state,
            reservoir_key=reservoir_key, **solve_kwargs,
        )

    def outputs(sol):
        return (
            sol.ys, sol.y_final, sol.t_final, sol.nfe, sol.naccept,
            sol.nreject, sol.success, sol.reservoir_t, sol.reservoir_u,
            sol.f_state,
        )

    @jax.custom_vjp
    def core(u0, p, saveat_arr):
        return outputs(run_solve(u0, p, saveat_arr))

    def core_fwd(u0, p, saveat_arr):
        sol = run_solve(u0, p, saveat_arr)
        return outputs(sol), (p, saveat_arr, sol.ys, sol.y_final)

    def core_bwd(res, cts):
        p, saveat_arr, ys, y_final = res
        # aux outputs are gradient-fenced: only ys / y_final cotangents flow
        ct_ys, ct_y = cts[0], cts[1]

        p_flat, unravel_p = ravel_pytree(p)
        zero_p = jnp.zeros_like(p_flat)

        def make_aug(u_like):
            aug0, unravel_aug = ravel_pytree(
                (u_like, jnp.zeros_like(u_like), zero_p)
            )
            return unravel_aug

        unravel_aug = make_aug(y_final)

        def f_aug(vec, tau, _):
            u, a, _g = unravel_aug(vec)
            t = -tau
            du, vjp_fn = jax.vjp(lambda u_, p_: fn(u_, t, p_), u, p)
            vu, vp = vjp_fn(a)
            vp_flat, _ = ravel_pytree(vp)
            out, _ = ravel_pytree((-du, vu, vp_flat))
            return out

        # One lax.scan over the saveat segments (descending): each iteration
        # integrates the augmented system over [tau, tau_next] and injects
        # that event's cotangent; a trailing zero-cotangent segment reaches
        # t0. Compile cost is O(1) in n_save.
        order = jnp.argsort(-saveat_arr)
        events = jnp.clip(saveat_arr[order], t0, t_end)
        cts_sorted = ct_ys[order]
        tau_targets = jnp.concatenate(
            [-events, jnp.asarray([-t0], jnp.float32)]
        )
        ct_pad = jnp.concatenate(
            [cts_sorted, jnp.zeros_like(cts_sorted[:1])], axis=0
        )

        def seg_body(carry, xs):
            state, tau_cur = carry
            tau_next, ct_i = xs
            seg = odesolve(
                f_aug, state, (tau_cur, tau_next), None, adjoint="none",
                **solve_kwargs,
            )
            u_c, a_c, g_c = unravel_aug(seg.y_final)
            state_next, _ = ravel_pytree((u_c, a_c + ct_i, g_c))
            return (state_next, tau_next), None

        state0, _ = ravel_pytree((y_final, ct_y, zero_p))
        (state_fin, _), _ = lax.scan(
            seg_body,
            (state0, jnp.asarray(-t_end, jnp.float32)),
            (tau_targets, ct_pad),
        )
        _, a_final, g_final = unravel_aug(state_fin)
        return a_final, unravel_p(g_final), jnp.zeros_like(saveat_arr)

    core.defvjp(core_fwd, core_bwd)

    (ys, y_final, t_final, nfe, naccept, nreject, success, res_t, res_u,
     f_state_out) = core(u0, p, saveat_arr)
    return ODESolution(
        ts=saveat_arr, ys=ys, t_final=t_final, y_final=y_final, nfe=nfe,
        naccept=naccept, nreject=nreject, success=success,
        reservoir_t=res_t, reservoir_u=res_u, f_state=f_state_out,
    )
