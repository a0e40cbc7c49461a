"""Adaptive ODE integration as a bounded, reverse-differentiable XLA loop.

This module owns everything the reference delegates to OrdinaryDiffEq
(SURVEY.md §2d): the accept/reject stepping loop, PI step-size control, the
automatic initial-dt heuristic, dense-output interpolation for ``saveat``,
``maxiters`` bounding, and NFE statistics. The design:

- **Adaptive control flow as data.** The loop body is a pure function of a
  carrier; finished/rejected iterations are masked no-ops. Under
  ``adjoint='direct'`` the loop is a fixed-capacity ``lax.scan`` (statically
  ``max_steps`` long) so reverse-mode is plain ``jax.grad``; under
  ``adjoint='none'`` (inference) it is a ``lax.while_loop`` with early exit.
- **Chunked rematerialization.** The scan nests an inner scan of
  ``checkpoint_every`` steps wrapped in ``jax.checkpoint``, bounding stored
  carriers to ``max_steps / checkpoint_every`` copies (sqrt-remat tradeoff).
- **Shared batch grid.** One dt and one RMS error norm over the entire batch
  tensor, matching the reference semantics (``src/perform_step.jl:36-37``).
- **Controller fenced from autodiff.** All step-size logic is wrapped in
  ``stop_gradient``, matching the reference's non-differentiable integrator
  machinery (``src/utils.jl:60-61``).
- **Reservoir sampling** of an accepted step-start point ``(t, u)`` during the
  solve — a single-pass, O(1)-memory way to sample uniformly from the accepted
  grid, used by the *biased* regularization mode (reference samples from
  ``sol.t[1:end-1]``, ``src/layers/neural_ode.jl:92``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.struct import pytree_dataclass
from ..ops.residuals import scaled_error_norm
from .controller import PIController, initial_step_size
from .step import tsit5_step
from .tableaus import tsit5_interpolate


@pytree_dataclass
class ODESolution:
    """Result of an adaptive solve.

    ``ts``/``ys`` hold the ``saveat`` grid (``ys[i] ≈ u(ts[i])`` via the Tsit5
    4th-order interpolant). ``nfe`` counts dynamics evaluations: 2 for the
    initial FSAL derivative + dt heuristic, then 6 per attempted step
    (accepted or rejected), the same accounting the reference reads from
    ``sol.destats.nf`` (``src/utils.jl:7``).
    """

    ts: jnp.ndarray
    ys: Any
    t_final: jnp.ndarray
    y_final: Any
    nfe: jnp.ndarray
    naccept: jnp.ndarray
    nreject: jnp.ndarray
    success: jnp.ndarray
    reservoir_t: jnp.ndarray
    reservoir_u: Any
    f_state: Any
    # dense forward storage for the stored/interpolating adjoints (None
    # unless record_knots=True): knot i = (t_i, u_i, k1_i) at accepted step
    # starts plus the final state. Dense capacity is min(max_steps,
    # knot_dense_cap); with knot_stride=W > 1 every W-th accepted state is
    # ADDITIONALLY stored as a checkpoint together with the controller
    # state (dt of the next attempt, qold) needed to deterministically
    # replay a window — the stored adjoint picks dense sweep vs windowed
    # replay per solve based on naccept (hybrid two-level scheme).
    knot_ts: Any = None
    knot_us: Any = None
    knot_ks: Any = None
    ckpt_ts: Any = None
    ckpt_us: Any = None
    ckpt_ks: Any = None
    ckpt_dts: Any = None
    ckpt_qolds: Any = None


@pytree_dataclass
class _LoopState:
    t: jnp.ndarray
    dt: jnp.ndarray
    u: Any
    k1: Any
    qold: jnp.ndarray
    done: jnp.ndarray
    nfe: jnp.ndarray
    naccept: jnp.ndarray
    nreject: jnp.ndarray
    ys: Any
    res_t: jnp.ndarray
    res_u: Any
    key: jnp.ndarray
    f_st: Any
    knot_ts: Any
    knot_us: Any
    knot_ks: Any
    ckpt_ts: Any
    ckpt_us: Any
    ckpt_ks: Any
    ckpt_dts: Any
    ckpt_qolds: Any


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b
    )


def _wrap_stateless(f: Callable) -> Callable:
    def f_st(u, t, p, st):
        return f(u, t, p), st

    return f_st


def odesolve(
    f: Callable,
    u0,
    tspan,
    p=None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-7,
    saveat: Optional[jnp.ndarray] = None,
    max_steps: int = 256,
    checkpoint_every: int = 16,
    adjoint: str = "direct",
    controller: Optional[PIController] = None,
    dt0=None,
    stateful: bool = False,
    f_state: Any = None,
    reservoir_key: Optional[jnp.ndarray] = None,
    record_knots: bool = False,
    knot_stride: int = 1,
    knot_dense_cap: Optional[int] = None,
    knot_window: Optional[int] = None,
) -> ODESolution:
    """Integrate ``du/dt = f(u, t, p)`` over ``tspan`` with adaptive Tsit5.

    Args:
      f: dynamics; ``f(u, t, p) -> du`` or, with ``stateful=True``,
        ``f(u, t, p, st) -> (du, st)``.
      u0: initial state (single array; batch rides inside it).
      tspan: ``(t0, t_end)`` with ``t_end > t0``.
      saveat: 1-D array of output times in ``[t0, t_end]`` (need not be
        sorted); defaults to ``[t_end]``. Times ≤ t0 return ``u0``.
      max_steps: static bound on attempted steps (reference ``maxiters``).
      checkpoint_every: inner remat chunk length for the direct adjoint.
      adjoint: ``'direct'`` (differentiable fixed-capacity scan) or ``'none'``
        (early-exit while loop; not reverse-differentiable).
      reservoir_key: PRNG key enabling reservoir sampling of an accepted
        step-start point (for biased regularization).
    """
    if adjoint == "stored":
        from .stored_adjoint import stored_odesolve

        return stored_odesolve(
            f, u0, tspan, p, rtol=rtol, atol=atol, saveat=saveat,
            max_steps=max_steps, stateful=stateful, f_state=f_state,
            reservoir_key=reservoir_key, knot_window=knot_window,
        )
    if adjoint == "interpolating":
        from .interp_adjoint import interpolating_odesolve

        return interpolating_odesolve(
            f, u0, tspan, p, rtol=rtol, atol=atol, saveat=saveat,
            max_steps=max_steps, stateful=stateful, f_state=f_state,
            reservoir_key=reservoir_key,
        )
    if adjoint == "backsolve":
        from .adjoint import backsolve_odesolve

        return backsolve_odesolve(
            f, u0, tspan, p, rtol=rtol, atol=atol, saveat=saveat,
            max_steps=max_steps, stateful=stateful, f_state=f_state,
            reservoir_key=reservoir_key,
        )
    if controller is None:
        controller = PIController()
    fn = f if stateful else _wrap_stateless(f)

    t0, t_end = tspan
    dtype = jnp.result_type(u0.dtype, jnp.float32)
    t0 = jnp.asarray(t0, dtype)
    t_end = jnp.asarray(t_end, dtype)

    if saveat is None:
        saveat_arr = t_end[None]
    else:
        saveat_arr = jnp.atleast_1d(jnp.asarray(saveat, dtype))
    n_save = saveat_arr.shape[0]

    k1_0, f_st0 = fn(u0, t0, p, f_state)
    nfe0 = jnp.asarray(1, jnp.int32)
    if dt0 is None:
        dt_init, extra = initial_step_size(
            fn, u0, t0, p, f_state, order=5, rtol=rtol, atol=atol, f0=k1_0
        )
        nfe0 = nfe0 + extra
    else:
        dt_init = jnp.asarray(dt0, dtype)
    dt_init = lax.stop_gradient(jnp.minimum(dt_init, t_end - t0))

    ys0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_save,) + x.shape), u0
    )
    # reservoir buffers only exist when requested — otherwise they'd add a
    # full state copy to the scan carrier for nothing
    use_reservoir = reservoir_key is not None
    key0 = reservoir_key if use_reservoir else jax.random.PRNGKey(0)
    res_t0 = t0 if use_reservoir else None
    res_u0 = u0 if use_reservoir else None

    stride = max(1, int(knot_stride))
    if record_knots:
        dense_cap = max_steps if knot_dense_cap is None else min(
            max_steps, int(knot_dense_cap)
        )
        n_dense = dense_cap + 1
        knot_ts0 = jnp.full((n_dense,), t_end, dtype).at[0].set(t0)
        knot_us0 = jnp.zeros((n_dense,) + u0.shape, u0.dtype).at[0].set(u0)
        knot_ks0 = jnp.zeros((n_dense,) + u0.shape, u0.dtype).at[0].set(k1_0)
        if stride > 1:
            # checkpoints: every stride-th accepted state + the controller
            # state (dt of the next attempt, qold) a window replay needs to
            # reproduce the exact accept/reject sequence.
            n_ckpt = max_steps // stride + 1
            ckpt_ts0 = jnp.full((n_ckpt,), t_end, dtype).at[0].set(t0)
            ckpt_us0 = jnp.zeros((n_ckpt,) + u0.shape, u0.dtype).at[0].set(u0)
            ckpt_ks0 = jnp.zeros((n_ckpt,) + u0.shape, u0.dtype).at[0].set(k1_0)
            ckpt_dts0 = jnp.zeros((n_ckpt,), dtype).at[0].set(dt_init)
            ckpt_qolds0 = jnp.full((n_ckpt,), controller.qoldinit, dtype)
        else:
            ckpt_ts0 = ckpt_us0 = ckpt_ks0 = None
            ckpt_dts0 = ckpt_qolds0 = None
    else:
        knot_ts0 = knot_us0 = knot_ks0 = None
        ckpt_ts0 = ckpt_us0 = ckpt_ks0 = ckpt_dts0 = ckpt_qolds0 = None

    state0 = _LoopState(
        t=t0,
        dt=dt_init,
        u=u0,
        k1=k1_0,
        qold=jnp.asarray(controller.qoldinit, dtype),
        done=(t0 >= t_end),
        nfe=nfe0,
        naccept=jnp.asarray(0, jnp.int32),
        nreject=jnp.asarray(0, jnp.int32),
        ys=ys0,
        res_t=res_t0,
        res_u=res_u0,
        key=key0,
        f_st=f_st0,
        knot_ts=knot_ts0,
        knot_us=knot_us0,
        knot_ks=knot_ks0,
        ckpt_ts=ckpt_ts0,
        ckpt_us=ckpt_us0,
        ckpt_ks=ckpt_ks0,
        ckpt_dts=ckpt_dts0,
        ckpt_qolds=ckpt_qolds0,
    )

    def step_fn(s: _LoopState) -> _LoopState:
        t_rem = t_end - s.t
        # Keep math finite when done (t_rem == 0): use a dummy unit dt.
        dt_c = jnp.where(s.done, jnp.ones_like(s.dt), jnp.minimum(s.dt, t_rem))
        is_last = s.dt >= t_rem

        res = tsit5_step(fn, s.u, s.t, dt_c, s.k1, p, s.f_st)
        eest = scaled_error_norm(res.utilde, s.u, res.u_new, atol, rtol)
        eest_c = lax.stop_gradient(eest)
        accept = eest_c <= 1.0
        dt_acc, dt_rej, qold_acc = controller.propose(eest_c, dt_c, s.qold)
        dt_acc = lax.stop_gradient(dt_acc)
        dt_rej = lax.stop_gradient(dt_rej)

        t_new = jnp.where(is_last, t_end, s.t + dt_c)
        upd = accept & ~s.done

        # --- dense output onto the saveat grid ---
        # gated on any saveat time landing in this step: interpolation reads
        # all 7 stage tensors, but most steps hit no output time (saveat is
        # typically just {t_end}), so lax.cond skips that traffic at runtime
        hit = (saveat_arr > s.t) & (saveat_arr <= t_new) & upd

        def do_interp(ys):
            def interp_at(ts_save):
                theta = jnp.clip((ts_save - s.t) / dt_c, 0.0, 1.0)
                return tsit5_interpolate(s.u, dt_c, res.ks, theta)

            y_interp = jax.vmap(interp_at)(saveat_arr)
            return jax.tree_util.tree_map(
                lambda yi, yo: jnp.where(
                    hit.reshape((n_save,) + (1,) * (yo.ndim - 1)), yi, yo
                ),
                y_interp,
                ys,
            )

        ys_new = lax.cond(hit.any(), do_interp, lambda ys: ys, s.ys)

        # --- reservoir sample of accepted step-start points ---
        if use_reservoir:
            key_next, sub = jax.random.split(s.key)
            cnt = s.naccept + 1
            take = (
                jax.random.uniform(sub, (), dtype) * cnt.astype(dtype) < 1.0
            ) & upd
            res_t_new = jnp.where(take, s.t, s.res_t)
            res_u_new = _tree_where(take, s.u, s.res_u)
        else:
            key_next = s.key
            res_t_new = None
            res_u_new = None

        # --- commit ---
        u_next = _tree_where(upd, res.u_new, s.u)
        k1_next = _tree_where(upd, res.ks[6], s.k1)
        if record_knots:
            # knot index for this accepted step's END point; on reject/done
            # rewrite the slot with its own value (in-place slice update —
            # no full-buffer copy inside the loop). Writes beyond the dense
            # capacity are dropped (mode='drop').
            cnt = s.naccept + 1
            knot_ts_n = s.knot_ts.at[cnt].set(
                jnp.where(upd, t_new, s.knot_ts.at[cnt].get(mode="clip")),
                mode="drop",
            )
            knot_us_n = s.knot_us.at[cnt].set(
                jnp.where(upd, res.u_new, s.knot_us.at[cnt].get(mode="clip")),
                mode="drop",
            )
            knot_ks_n = s.knot_ks.at[cnt].set(
                jnp.where(upd, res.ks[6], s.knot_ks.at[cnt].get(mode="clip")),
                mode="drop",
            )
            if stride > 1:
                ci = cnt // stride
                rec_c = upd & (cnt % stride == 0)
                ckpt_ts_n = s.ckpt_ts.at[ci].set(
                    jnp.where(rec_c, t_new, s.ckpt_ts[ci])
                )
                ckpt_us_n = s.ckpt_us.at[ci].set(
                    jnp.where(rec_c, res.u_new, s.ckpt_us[ci])
                )
                ckpt_ks_n = s.ckpt_ks.at[ci].set(
                    jnp.where(rec_c, res.ks[6], s.ckpt_ks[ci])
                )
                ckpt_dts_n = s.ckpt_dts.at[ci].set(
                    jnp.where(rec_c, dt_acc, s.ckpt_dts[ci])
                )
                ckpt_qolds_n = s.ckpt_qolds.at[ci].set(
                    jnp.where(rec_c, qold_acc, s.ckpt_qolds[ci])
                )
            else:
                ckpt_ts_n = ckpt_us_n = ckpt_ks_n = None
                ckpt_dts_n = ckpt_qolds_n = None
        else:
            knot_ts_n = knot_us_n = knot_ks_n = None
            ckpt_ts_n = ckpt_us_n = ckpt_ks_n = None
            ckpt_dts_n = ckpt_qolds_n = None
        f_st_next = _tree_where(upd, res.f_state, s.f_st)
        t_next = jnp.where(upd, t_new, s.t)
        dt_next = jnp.where(
            s.done, s.dt, jnp.where(accept, dt_acc, dt_rej)
        )
        qold_next = jnp.where(upd, qold_acc, s.qold)
        done_next = s.done | (upd & is_last)
        return _LoopState(
            t=t_next,
            dt=dt_next,
            u=u_next,
            k1=k1_next,
            qold=qold_next,
            done=done_next,
            nfe=s.nfe + jnp.where(s.done, 0, 6).astype(jnp.int32),
            naccept=s.naccept + upd.astype(jnp.int32),
            nreject=s.nreject + (~accept & ~s.done).astype(jnp.int32),
            ys=ys_new,
            res_t=res_t_new,
            res_u=res_u_new,
            key=key_next,
            f_st=f_st_next,
            knot_ts=knot_ts_n,
            knot_us=knot_us_n,
            knot_ks=knot_ks_n,
            ckpt_ts=ckpt_ts_n,
            ckpt_us=ckpt_us_n,
            ckpt_ks=ckpt_ks_n,
            ckpt_dts=ckpt_dts_n,
            ckpt_qolds=ckpt_qolds_n,
        )

    if adjoint == "none":
        def cond(s):
            return ~s.done & (s.naccept + s.nreject < max_steps)

        final = lax.while_loop(cond, step_fn, state0)
    elif adjoint == "direct":
        # lax.cond executes only the taken branch at runtime (this state is
        # not batched), so finished solves skip the 6 stage evaluations —
        # the fixed-capacity scan costs ~actual-steps, not max_steps.
        def masked_step(s):
            return lax.cond(s.done, lambda st: st, step_fn, s)

        if checkpoint_every <= 0:
            # no remat: scan reverse stores per-step residuals
            # (~(2+n_save)·state each), avoiding a forward recompute per
            # chunk. Memory: O(max_steps·state).
            def body(s, _):
                return masked_step(s), None

            final, _ = lax.scan(body, state0, None, length=max_steps)
        else:
            chunk = max(1, min(checkpoint_every, max_steps))
            n_outer = -(-max_steps // chunk)

            @jax.checkpoint
            def chunk_fn(s, _):
                def inner(s2, _):
                    return masked_step(s2), None

                s, _ = lax.scan(inner, s, None, length=chunk)
                return s, None

            final, _ = lax.scan(chunk_fn, state0, None, length=n_outer)
    else:
        raise ValueError(f"unknown adjoint {adjoint!r}")

    # saveat times at/before t0 report the initial state (prefilled in ys0).
    return ODESolution(
        ts=saveat_arr,
        ys=final.ys,
        t_final=final.t,
        y_final=final.u,
        nfe=final.nfe,
        naccept=final.naccept,
        nreject=final.nreject,
        success=final.done,
        reservoir_t=final.res_t,
        reservoir_u=final.res_u,
        f_state=final.f_st,
        knot_ts=final.knot_ts,
        knot_us=final.knot_us,
        knot_ks=final.knot_ks,
        ckpt_ts=final.ckpt_ts,
        ckpt_us=final.ckpt_us,
        ckpt_ks=final.ckpt_ks,
        ckpt_dts=final.ckpt_dts,
        ckpt_qolds=final.ckpt_qolds,
    )
