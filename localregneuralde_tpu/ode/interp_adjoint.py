"""Interpolating continuous adjoint — the reference's default sensealg.

``InterpolatingAdjoint(autojacvec=ZygoteVJP())`` (reference
``src/layers/neural_ode.jl:11``) integrates the adjoint ODE backward while
reading ``u(t)`` from the *stored forward solution's interpolant* instead of
co-integrating it (as 'backsolve' does) — trading memory for the numerical
stability backsolve lacks on stiff/contracting dynamics.

Realization (``odesolve(..., adjoint='interpolating')``):

- forward: the early-exit ``while_loop`` integrator, additionally recording
  ``(t, u, k1)`` at every accepted step into static ``max_steps`` buffers
  (memory: 2 × max_steps × state — the analog of OrdinaryDiffEq's dense
  solution storage. NOTE: unlike the 'stored' adjoint this has no windowed
  variant — the backward interpolates at arbitrary times, so at
  ``max_steps = 10_000`` the buffers are only feasible for small states
  like the latent-ODE family; use 'stored' for large-state tight-capacity
  configs);
- ``u(t)`` on the backward pass: cubic Hermite over the recorded knots
  (values + FSAL derivatives), located by a vectorized ``searchsorted``
  over the (padded) knot times — 3rd-order dense output, tolerance-
  controlled adjoint accuracy;
- backward: one adaptive solve of ``(a_u, a_p)`` in reversed time with
  per-eval ``jax.vjp`` of the dynamics at the interpolated ``u(t)``,
  saveat cotangents injected segment-wise (same machinery as backsolve).
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from .solve import ODESolution, odesolve


def interpolating_odesolve(
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
    """Adaptive Tsit5 solve whose VJP integrates the adjoint ODE against the
    stored forward interpolant."""
    t0, t_end = float(tspan[0]), float(tspan[1])
    if saveat is None:
        saveat_arr = jnp.asarray([t_end], jnp.float32)
    else:
        saveat_arr = jnp.atleast_1d(jnp.asarray(saveat, jnp.float32))

    fn = f
    if stateful:
        def fn(u, t, p_):  # noqa: F811 — state is fenced under this adjoint
            du, _ = f(u, t, p_, f_state)
            return du

    solve_kwargs = dict(rtol=rtol, atol=atol, max_steps=max_steps)

    def run_solve(u0_, p_, saveat_):
        # THE forward solve: differentiable outputs and fenced auxiliaries
        # (stats, reservoir, threaded f_state, knots) from one integration.
        return odesolve(
            f, u0_, (t0, t_end), p_, saveat=saveat_, adjoint="none",
            record_knots=True, stateful=stateful,
            f_state=f_state, reservoir_key=reservoir_key, **solve_kwargs,
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
        res = (
            p, saveat_arr, sol.ys, sol.y_final,
            sol.knot_ts, sol.knot_us, sol.knot_ks, sol.naccept,
        )
        return outputs(sol), res

    def core_bwd(res, cts):
        (p, saveat_arr, ys, y_final, knot_ts, knot_us, knot_ks,
         naccept) = res
        # aux outputs are gradient-fenced: only ys / y_final cotangents flow
        ct_ys, ct_y = cts[0], cts[1]

        # pad unused knot slots with +inf times so searchsorted lands in the
        # last valid interval; knot 0 is (t0, u0, k1(t0)).
        idxs = jnp.arange(knot_ts.shape[0])
        valid = idxs <= naccept  # naccept+1 knots recorded
        ts_pad = jnp.where(valid, knot_ts, jnp.inf)

        def u_at(t):
            """Cubic Hermite over recorded knots (clamped)."""
            i = jnp.clip(
                jnp.searchsorted(ts_pad, t, side="right") - 1,
                0, jnp.maximum(naccept - 1, 0),
            )
            t_a = knot_ts[i]
            t_b = knot_ts[i + 1]
            h = jnp.maximum(t_b - t_a, 1e-30)
            th = jnp.clip((t - t_a) / h, 0.0, 1.0)
            ua, ub = knot_us[i], knot_us[i + 1]
            ka, kb = knot_ks[i], knot_ks[i + 1]
            h00 = 2 * th ** 3 - 3 * th ** 2 + 1
            h10 = th ** 3 - 2 * th ** 2 + th
            h01 = -2 * th ** 3 + 3 * th ** 2
            h11 = th ** 3 - th ** 2
            return h00 * ua + h10 * h * ka + h01 * ub + h11 * h * kb

        p_flat, unravel_p = ravel_pytree(p)
        zero_p = jnp.zeros_like(p_flat)
        _, unravel_aug = ravel_pytree((jnp.zeros_like(y_final), zero_p))

        def f_aug(vec, tau, _):
            a, _g = unravel_aug(vec)
            t = -tau
            u = u_at(t)
            _du, vjp_fn = jax.vjp(lambda u_, p_: fn(u_, t, p_), u, p)
            vu, vp = vjp_fn(a)
            vp_flat, _ = ravel_pytree(vp)
            out, _ = ravel_pytree((vu, vp_flat))
            return out

        # One lax.scan over the saveat segments (descending): each iteration
        # integrates the adjoint over [tau, tau_next] and injects that
        # event's cotangent. A trailing segment to t0 carries a zero
        # cotangent. Compile cost is O(1) in n_save (one segment solve
        # traced once), unlike an unrolled Python event loop.
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
            a_c, g_c = unravel_aug(seg.y_final)
            state_next, _ = ravel_pytree((a_c + ct_i, g_c))
            return (state_next, tau_next), None

        state0, _ = ravel_pytree((ct_y, zero_p))
        (state_fin, _), _ = lax.scan(
            seg_body,
            (state0, jnp.asarray(-t_end, jnp.float32)),
            (tau_targets, ct_pad),
        )
        a_final, g_final = unravel_aug(state_fin)
        return a_final, unravel_p(g_final), jnp.zeros_like(saveat_arr)

    core.defvjp(core_fwd, core_bwd)

    (ys, y_final, t_final, nfe, naccept, nreject, success, res_t, res_u,
     f_state_out) = core(u0, p, saveat_arr)
    return ODESolution(
        ts=saveat_arr, ys=ys, t_final=t_final, y_final=y_final, nfe=nfe,
        naccept=naccept, nreject=nreject, success=success,
        reservoir_t=res_t, reservoir_u=res_u, f_state=f_state_out,
    )
