"""Stored discretize-through adjoint: cost ∝ accepted steps, both ways.

The 'direct' adjoint pays for the static scan capacity (max_steps) in both
directions; `lax.cond` masking recovers most of the forward but reverse-mode
still sweeps every capacity slot. This adjoint eliminates capacity cost
entirely:

- **forward**: the early-exit ``while_loop`` integrator with
  ``record_knots=True`` — knot i is ``(t_i, u_i, k1_i)`` at accepted-step
  boundaries (k1 is the FSAL derivative, so consecutive knots fully describe
  each accepted step: ``u_{i+1} = step(u_i, t_i, dt_i, k1_i)`` and
  ``k1_{i+1} = k7`` of that step);
- **backward**: a reverse ``while_loop`` over ONLY the ``naccept`` recorded
  steps, transposing one step per iteration via ``jax.vjp`` of the step
  function. The FSAL chain is carried explicitly
  (``a_k``: cotangent on the incoming k1 ≡ previous step's k7); saveat
  cotangents are injected at the steps whose interval contains each output
  time, exactly mirroring the forward interpolation.

**Hybrid windowing for large capacity** (``max_steps > knot_window``,
default 512): the forward records dense knots for the first ``knot_window``
accepted steps AND every-W-th *checkpoint* beyond (with the controller
state ``(dt_next, qold)`` needed to resume stepping), W = ⌈√max_steps⌉.
The backward picks per solve (``lax.cond`` on ``naccept``): short solves —
the common case — sweep the dense knots directly with NO replay; long
solves replay one W-step window at a time (deterministic accept/reject
replay) before reverse-sweeping it. Memory is
O(knot_window + max_steps/W + W) states, making reference-scale
``maxiters = 10_000`` (``construct.jl:196``) feasible at MNIST batch sizes
while keeping the sub-512-step fast path replay-free.

Rejected attempts contribute nothing to gradients (their outputs are
discarded by the forward masking), so skipping them is exact. dt/controller
quantities receive no cotangents, matching the framework-wide fencing.

**Single forward solve.** The one ``custom_vjp`` primal solve produces the
differentiable outputs (``ys``, ``y_final``) *and* the fenced auxiliaries
(NFE stats, reservoir sample, threaded ``f_state``, knots) together — there
is no separate stats solve, so training pays exactly one forward
integration per step. Aux outputs receive no cotangents in the backward
rule, which realizes the reference's non-differentiable integrator fencing
(``src/utils.jl:60-61``). Dynamics state (e.g. BatchNorm running stats) is
threaded through the forward trajectory; the backward step transposes use
the *initial* ``f_state`` — exact whenever state does not alter outputs
mid-solve (true for BatchNorm in training mode, which normalizes with batch
statistics; asserted by tests/test_stored_adjoint.py).

Same exactness class as 'direct' (pure discretize-then-optimize).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from ..ops.residuals import scaled_error_norm
from .controller import PIController
from .solve import ODESolution, odesolve
from .step import tsit5_step
from .tableaus import tsit5_interp_weights


def stored_odesolve(
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
    knot_window: Optional[int] = None,
) -> ODESolution:
    t0, t_end = float(tspan[0]), float(tspan[1])
    if saveat is None:
        saveat_arr = jnp.asarray([t_end], jnp.float32)
    else:
        saveat_arr = jnp.atleast_1d(jnp.asarray(saveat, jnp.float32))

    if knot_window is None:
        knot_window = 512
    # hybrid scheme: dense knots up to `knot_window` accepted steps (no
    # replay needed — the common case), plus √N-strided checkpoints beyond
    # (windowed replay for long solves). The backward picks per solve.
    dense_cap = min(max_steps, int(knot_window))
    two_level = dense_cap < max_steps
    stride = (
        max(16, int(math.ceil(math.sqrt(float(max_steps)))))
        if two_level else 1
    )
    controller = PIController()

    fn = f
    if stateful:
        def fn(u, t, p_):  # noqa: F811 — state fenced under this adjoint
            du, _ = f(u, t, p_, f_state)
            return du

    def fn_st(u, t, p_, st):
        return fn(u, t, p_), st

    solve_kwargs = dict(rtol=rtol, atol=atol, max_steps=max_steps)

    def raw_step(p_, u, t, dt, k1):
        return tsit5_step(fn_st, u, t, dt, k1, p_, None)

    def step_out(p_, u, t, dt, k1):
        """(u_new, (k2..k7)) of one Tsit5 step — the unit the backward
        transposes."""
        res = raw_step(p_, u, t, dt, k1)
        return res.u_new, tuple(res.ks[1:])

    def step_transpose(p_, u, t, dt, k1, d_unew, d_ks):
        """Cotangents of one step: (d_p, d_u, d_k1)."""
        _, vjp = jax.vjp(step_out, p_, u, t, dt, k1)
        d_p, d_u, _d_t, _d_dt, d_k1 = vjp((d_unew, d_ks))
        return d_p, d_u, d_k1

    def run_solve(u0_, p_, saveat_):
        # THE forward solve: differentiable outputs and fenced auxiliaries
        # (stats, reservoir, threaded f_state, knots) from one integration.
        return odesolve(
            f, u0_, (t0, t_end), p_, saveat=saveat_, adjoint="none",
            record_knots=True, knot_stride=stride, knot_dense_cap=dense_cap,
            stateful=stateful, f_state=f_state, reservoir_key=reservoir_key,
            **solve_kwargs,
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
            u0, p, saveat_arr, sol.knot_ts, sol.knot_us, sol.knot_ks,
            sol.ckpt_ts, sol.ckpt_us, sol.ckpt_ks,
            sol.ckpt_dts, sol.ckpt_qolds, sol.naccept, sol.t_final,
        )
        return outputs(sol), res

    def core_bwd(res, cts):
        (u0, p, saveat_arr, knot_ts, knot_us, knot_ks, ckpt_ts, ckpt_us,
         ckpt_ks, ckpt_dts, ckpt_qolds, naccept, t_final) = res
        # aux outputs (stats/reservoir/f_state) are gradient-fenced: only the
        # ys / y_final cotangents propagate.
        ct_ys, ct_y = cts[0], cts[1]
        p_flat, unravel_p = ravel_pytree(p)
        tdtype = knot_ts.dtype
        t_end_arr = jnp.asarray(t_end, tdtype)

        def make_sweep_body(l_ts, l_us, l_ks):
            """Reverse-transpose one accepted step per iteration over the
            given knot buffers (global buffers single-level; per-window
            replayed buffers two-level)."""

            def body(carry):
                j, a_u, a_k, a_p = carry
                t = l_ts[j]
                tn = l_ts[j + 1]
                dt = tn - t
                u = l_us[j]
                k1 = l_ks[j]

                # saveat cotangents whose output time falls inside this step:
                # y_s = u + dt·Σ_m b_m(θ_s)·k_m  (m = 1..7, b from the Tsit5
                # free interpolant — identical to the forward fill)
                theta = jnp.clip((saveat_arr - t) / dt, 0.0, 1.0)
                hit = ((saveat_arr > t) & (saveat_arr <= tn)).astype(u.dtype)
                ct_hit = ct_ys * hit.reshape((-1,) + (1,) * u.ndim)
                bs = tsit5_interp_weights(theta)  # 7 × (n_save,)
                d_u_interp = jnp.sum(ct_hit, axis=0)

                def k_ct(m):
                    w = (dt * bs[m] * hit).reshape((-1,) + (1,) * u.ndim)
                    return jnp.sum(w * ct_ys, axis=0)

                d_unew = a_u
                d_ks = (
                    k_ct(1), k_ct(2), k_ct(3), k_ct(4), k_ct(5),
                    k_ct(6) + a_k,  # k7 feeds the next step's k1 (FSAL)
                )
                d_p, d_u, d_k1 = step_transpose(
                    p, u, t, dt, k1, d_unew, d_ks
                )
                d_p_flat, _ = ravel_pytree(d_p)
                return (
                    j - 1,
                    d_u + d_u_interp,
                    d_k1 + k_ct(0),
                    a_p + d_p_flat,
                )

            return body

        a0 = (ct_y, jnp.zeros_like(u0), jnp.zeros_like(p_flat))

        def dense_sweep(a0):
            body = make_sweep_body(knot_ts, knot_us, knot_ks)
            _, a_u, a_k, a_p = lax.while_loop(
                lambda c: c[0] >= 0, body, (naccept - 1,) + a0
            )
            return a_u, a_k, a_p

        if not two_level:
            a_u, a_k, a_p = dense_sweep(a0)
        else:
            W = stride

            def replay_window(w, n_steps):
                """Deterministically re-integrate the ≤W accepted steps of
                window ``w`` from its checkpoint, recording local knots.
                Identical arithmetic to the forward loop ⇒ identical
                accept/reject and dt sequence (same ops, same order)."""
                l_ts0 = jnp.full((W + 1,), t_end_arr, tdtype).at[0].set(
                    ckpt_ts[w]
                )
                l_us0 = jnp.zeros((W + 1,) + u0.shape, u0.dtype).at[0].set(
                    ckpt_us[w]
                )
                l_ks0 = jnp.zeros((W + 1,) + u0.shape, u0.dtype).at[0].set(
                    ckpt_ks[w]
                )

                def rcond(c):
                    return (c[0] < n_steps) & (c[1] < max_steps)

                def rbody(c):
                    i, att, t, u, k1, dt, qold, l_ts, l_us, l_ks = c
                    t_rem = t_end_arr - t
                    dt_c = jnp.minimum(dt, t_rem)
                    is_last = dt >= t_rem
                    r = raw_step(p, u, t, dt_c, k1)
                    eest = scaled_error_norm(
                        r.utilde, u, r.u_new, atol, rtol
                    )
                    accept = eest <= 1.0
                    dt_acc, dt_rej, qold_acc = controller.propose(
                        eest, dt_c, qold
                    )
                    t_new = jnp.where(is_last, t_end_arr, t + dt_c)
                    sl = i + 1
                    l_ts = l_ts.at[sl].set(
                        jnp.where(accept, t_new, l_ts[sl])
                    )
                    l_us = l_us.at[sl].set(
                        jnp.where(accept, r.u_new, l_us[sl])
                    )
                    l_ks = l_ks.at[sl].set(
                        jnp.where(accept, r.ks[6], l_ks[sl])
                    )
                    return (
                        i + accept.astype(i.dtype),
                        att + 1,
                        jnp.where(accept, t_new, t),
                        jnp.where(accept, r.u_new, u),
                        jnp.where(accept, r.ks[6], k1),
                        jnp.where(accept, dt_acc, dt_rej),
                        jnp.where(accept, qold_acc, qold),
                        l_ts, l_us, l_ks,
                    )

                init = (
                    jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                    ckpt_ts[w], ckpt_us[w], ckpt_ks[w],
                    ckpt_dts[w], ckpt_qolds[w],
                    l_ts0, l_us0, l_ks0,
                )
                out = lax.while_loop(rcond, rbody, init)
                return out[7], out[8], out[9]

            def outer_body(carry):
                w, a_u, a_k, a_p = carry
                start = w * W
                n_steps = jnp.clip(naccept - start, 0, W)
                l_ts, l_us, l_ks = replay_window(w, n_steps)
                body = make_sweep_body(l_ts, l_us, l_ks)
                _, a_u, a_k, a_p = lax.while_loop(
                    lambda c: c[0] >= 0, body, (n_steps - 1, a_u, a_k, a_p)
                )
                return (w - 1, a_u, a_k, a_p)

            def windowed_sweep(a0):
                w_start = jnp.maximum((naccept - 1) // W, 0)
                _, a_u, a_k, a_p = lax.while_loop(
                    lambda c: c[0] >= 0, outer_body, (w_start,) + a0
                )
                return a_u, a_k, a_p

            # hybrid: when the whole solve fits in the dense knot region
            # (the common case), sweep it directly — no replay forward.
            a_u, a_k, a_p = lax.cond(
                naccept <= dense_cap, dense_sweep, windowed_sweep, a0
            )

        # close the FSAL chain: k1_0 = f(u0, t0, p)
        _, vjp0 = jax.vjp(lambda u_, p_: fn(u_, jnp.asarray(t0), p_), u0, p)
        d_u0_k, d_p_k = vjp0(a_k)
        d_p_k_flat, _ = ravel_pytree(d_p_k)

        # entries the forward never wrote still hold the u0 broadcast —
        # an identity function of u0: saveat <= t0 (reported as u0 by
        # contract) AND anything beyond the last accepted time
        # (truncated/failed solves). Dropping the latter silently zeroed
        # d_u0 exactly in the max_steps-exhausted regime.
        unwritten = (
            (saveat_arr <= t0)
            | (saveat_arr > lax.stop_gradient(t_final))
        ).astype(u0.dtype)
        d_u0_pre = jnp.sum(
            ct_ys * unwritten.reshape((-1,) + (1,) * u0.ndim), axis=0
        )

        d_u0 = a_u + d_u0_k + d_u0_pre
        d_p_total = unravel_p(a_p + d_p_k_flat)
        return d_u0, d_p_total, jnp.zeros_like(saveat_arr)

    core.defvjp(core_fwd, core_bwd)

    (ys, y_final, t_final, nfe, naccept, nreject, success, res_t, res_u,
     f_state_out) = core(u0, p, saveat_arr)
    return ODESolution(
        ts=saveat_arr, ys=ys, t_final=t_final, y_final=y_final, nfe=nfe,
        naccept=naccept, nreject=nreject, success=success,
        reservoir_t=res_t, reservoir_u=res_u, f_state=f_state_out,
    )
