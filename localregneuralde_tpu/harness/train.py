"""Training step, train state, and warmup.

Reference: ``experiments/src/utils.jl:104-153``. Deviation: the
forward+backward+optimizer-update is ONE jitted, donated function (XLA fuses
the whole step; separate fwd/bwd/opt dispatches would leave performance on
the table). Per-phase wall-clock parity metrics are still available via
``timed=True``, which runs value_and_grad and the optimizer update as separate
jitted calls with ``block_until_ready`` fences.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from jax import lax

from ..core.struct import pytree_dataclass, replace as struct_replace


@pytree_dataclass
class TrainState:
    params: Any
    state: Any
    opt_state: Any
    step: jnp.ndarray
    # exponential moving average of params (None = disabled). The None
    # default is a CLASS attribute, so TrainStates unpickled from
    # checkpoints written before this field existed still resolve
    # ``.ema`` (to None) — old checkpoints stay loadable.
    ema: Any = None


def create_train_state(model, optimizer, key) -> TrainState:
    params, state = model.init(key)
    opt_state = optimizer.init(params)
    return TrainState(
        params=params,
        state=state,
        opt_state=opt_state,
        step=jnp.asarray(0, jnp.int32),
    )


def settle_state_shapes(model, loss_fn, ts: TrainState, data,
                        w_reg) -> TrainState:
    """Replace layer-state leaves whose shapes settle on the first call
    (e.g. ``ReparameterizeLayer``'s (1,1) mu/logvar placeholders becoming
    (B, latent)) with zeros of the settled shape — computed abstractly via
    ``jax.eval_shape`` (no compute, no compilation). Without this, the
    donated train step is guaranteed one recompilation: the first call
    traces with init shapes, every later call with settled shapes — at
    tight-tolerance configs that is a second full compile."""
    st_sd = jax.eval_shape(
        lambda p, s: loss_fn(model, p, s, data, w_reg, training=True)[1],
        ts.params, ts.state,
    )

    def pick(old, sd):
        if old.shape == sd.shape and old.dtype == sd.dtype:
            return old
        return jnp.zeros(sd.shape, sd.dtype)

    settled = jax.tree_util.tree_map(pick, ts.state, st_sd)
    return struct_replace(ts, state=settled)


def _merge_micro_stats(stacked):
    """Collapse the leading microbatch axis of scanned per-micro stats so
    consumers (window accumulators, loggers) see one step's worth:
    per-sample arrays (y_pred, …) concatenate back into the full batch;
    integer scalars (NFE counters) sum; boolean scalars (solver_success)
    AND; float scalars (losses, reg values) average."""

    def merge(s):
        if s.ndim >= 2:
            return s.reshape((-1,) + s.shape[2:])
        if jnp.issubdtype(s.dtype, jnp.bool_):
            return jnp.all(s)
        if jnp.issubdtype(s.dtype, jnp.integer):
            return jnp.sum(s)
        return jnp.mean(s)

    return jax.tree_util.tree_map(merge, stacked)


def _microbatched_value_and_grad(model, loss_fn, n_micro, params, state,
                                 data, w_reg):
    """Gradient accumulation over ``n_micro`` sequential microbatches.

    Splits every data leaf ``(B, …) -> (n_micro, B/n_micro, …)`` and scans
    the microbatches, accumulating the gradient in the carry (O(1) memory
    in ``n_micro`` — remat-free large effective batches on one chip).
    Layer state (PRNG chains, BatchNorm stats, NFE counters) threads
    sequentially exactly as n_micro smaller steps would. NOTE the adaptive
    grid is shared per MICROBATCH (each microbatch solve picks its own dt
    sequence) — the accumulated step equals the mean of n_micro
    independent small-batch losses, not one big-batch solve."""
    micro = jax.tree_util.tree_map(
        lambda a: a.reshape((n_micro, a.shape[0] // n_micro) + a.shape[1:]),
        data,
    )

    def objective(params, state, mdata):
        loss, st_, stats = loss_fn(
            model, params, state, mdata, w_reg, training=True
        )
        return loss, (st_, stats)

    vg = jax.value_and_grad(objective, has_aux=True)

    def body(carry, mdata):
        state, gsum = carry
        (loss, (st_, stats)), g = vg(params, state, mdata)
        gsum = jax.tree_util.tree_map(jnp.add, gsum, g)
        return (st_, gsum), (loss, stats)

    zero_g = jax.tree_util.tree_map(jnp.zeros_like, params)
    (st_, gsum), (losses, stats_stack) = lax.scan(
        body, (state, zero_g), micro
    )
    inv = 1.0 / float(n_micro)
    grads = jax.tree_util.tree_map(lambda g: g * inv, gsum)
    return jnp.mean(losses), st_, _merge_micro_stats(stats_stack), grads


def _fused_step_body(model, loss_fn, optimizer, ts: TrainState, data,
                     w_reg, lr, n_micro: int = 1,
                     ema_decay: float = 0.0):
    """One forward+backward+optimizer update — the shared body of the
    single-step and multi-step train calls. ``n_micro > 1`` accumulates
    gradients over microbatches before the single optimizer update;
    ``ema_decay > 0`` folds the params-EMA update into the same program
    (``ts.ema`` must be seeded via ``init_ema`` first)."""

    if n_micro > 1:
        loss, st_, stats, grads = _microbatched_value_and_grad(
            model, loss_fn, n_micro, ts.params, ts.state, data, w_reg
        )
    else:
        def objective(params):
            loss, st_, stats = loss_fn(
                model, params, ts.state, data, w_reg, training=True
            )
            return loss, (st_, stats)

        (loss, (st_, stats)), grads = jax.value_and_grad(
            objective, has_aux=True
        )(ts.params)
    opt_state = ts.opt_state
    opt_state.hyperparams["learning_rate"] = lr
    updates, opt_state = optimizer.update(grads, opt_state, ts.params)
    params = optax.apply_updates(ts.params, updates)
    if ema_decay > 0.0:
        d = jnp.float32(ema_decay)
        ema = jax.tree_util.tree_map(
            lambda e, p: e * d + p * (1.0 - d), ts.ema, params
        )
    else:
        ema = ts.ema
    return (
        TrainState(
            params=params,
            state=st_,
            opt_state=opt_state,
            step=ts.step + 1,
            ema=ema,
        ),
        loss,
        stats,
    )


def init_ema(ts: TrainState) -> TrainState:
    """Seed the params-EMA accumulator at the current params (call once
    before the first EMA-enabled step; re-seeds cleanly after resuming a
    pre-EMA checkpoint whose ``ema`` is None)."""
    return struct_replace(
        ts, ema=jax.tree_util.tree_map(jnp.array, ts.params)
    )


def swap_ema_params(ts: TrainState) -> TrainState:
    """A view of the train state with the EMA weights in ``params`` —
    evaluation/checkpoint-best/serving should see the averaged model."""
    if ts.ema is None:
        return ts
    return struct_replace(ts, params=ts.ema)


def make_train_step(model, loss_fn, optimizer,
                    grad_accumulation: int = 1,
                    ema_decay: float = 0.0) -> Callable:
    """Build the fused jitted train step.

    ``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)``. The learning
    rate is injected via optax's hyperparam mechanism so Python-side
    schedulers (reference ``Optimisers.adjust``, ``main.jl:94-95``) work
    without recompilation. ``grad_accumulation=N`` splits the batch into N
    sequential microbatches and applies ONE optimizer update on the mean
    gradient (``train.grad_accumulation`` — an addition for
    large effective batches on one chip; no reference counterpart).
    """
    n_micro = int(grad_accumulation)

    @partial(jax.jit, donate_argnums=(0,))
    def train_step(ts: TrainState, data, w_reg, lr):
        return _fused_step_body(model, loss_fn, optimizer, ts, data,
                                w_reg, lr, n_micro=n_micro,
                                ema_decay=float(ema_decay))

    return train_step


def make_multi_train_step(model, loss_fn, optimizer,
                          reduce_fn: Callable = None,
                          grad_accumulation: int = 1,
                          ema_decay: float = 0.0) -> Callable:
    """Fused K-step train call: a donated jit around ``lax.scan`` over the
    single-step body — K optimizer steps per host dispatch.

    Addition (no reference counterpart — the reference dispatches
    one CUDA step per Julia loop iteration): each host→device round trip
    costs fixed dispatch latency plus Python-side batch handling; scanning
    K steps on device amortizes both by K× while keeping the arithmetic of
    K sequential single steps (the scan body IS the single-step body).

    ``multi_step(ts, data_stack, w_regs, lrs) -> (ts', last_loss, red)``
    where every leaf of ``data_stack`` / ``w_regs`` carries a leading K
    axis and ``lrs`` is ``(K,)``. ``red`` is the per-step
    ``reduce_fn(loss, stats, data) -> pytree`` (scalars) summed over the K
    steps — default: ``{"loss": Σ loss}``. Keeping the reduction in-kernel
    avoids staging K copies of bulky stats (e.g. ``y_pred``) back to the
    host.
    """
    if reduce_fn is None:
        def reduce_fn(loss, stats, data):  # noqa: F811 — default reducer
            return {"loss": loss}

    n_micro = int(grad_accumulation)

    @partial(jax.jit, donate_argnums=(0,))
    def multi_step(ts: TrainState, data_stack, w_regs, lrs):
        def body(ts, xs):
            data, w_reg, lr = xs
            ts, loss, stats = _fused_step_body(
                model, loss_fn, optimizer, ts, data, w_reg, lr,
                n_micro=n_micro, ema_decay=float(ema_decay),
            )
            return ts, (loss, reduce_fn(loss, stats, data))

        ts, (losses, reds) = lax.scan(
            body, ts, (data_stack, w_regs, lrs)
        )
        red = jax.tree_util.tree_map(lambda a: jnp.sum(a, axis=0), reds)
        return ts, losses[-1], red

    return multi_step


def make_eval_step(model, loss_fn) -> Callable:
    @jax.jit
    def eval_step(ts: TrainState, data, w_reg):
        loss, st_, stats = loss_fn(
            model, ts.params, ts.state, data, w_reg, training=False
        )
        return loss, stats

    return eval_step


def make_phase_probes(model, loss_fn, optimizer) -> Callable:
    """Per-phase wall-clock parity metrics (reference ``utils.jl:107-121``
    logs fwd/bwd/opt separately). The production step is one fused XLA
    program, so phases are probed with two auxiliary programs — forward-only
    and forward+backward — run once per print window (not per step, which
    would throttle throughput):

      fwd_time  = t(value-only)
      bwd_time  = t(value_and_grad) − fwd_time
      opt_time  = avg fused step time − t(value_and_grad)   (by the caller)
    """

    @jax.jit
    def value_only(ts: TrainState, data, w_reg):
        loss, _, _ = loss_fn(
            model, ts.params, ts.state, data, w_reg, training=True
        )
        return loss

    @jax.jit
    def value_and_grad_only(ts: TrainState, data, w_reg):
        def objective(params):
            loss, _, _ = loss_fn(
                model, params, ts.state, data, w_reg, training=True
            )
            return loss

        loss, grads = jax.value_and_grad(objective)(ts.params)
        return loss, optax.global_norm(grads)

    def measure(ts, data, w_reg):
        """Returns (fwd_time, fwdbwd_time) in seconds (compiled-path)."""
        value_only(ts, data, w_reg).block_until_ready()  # ensure compiled
        t0 = time.perf_counter()
        value_only(ts, data, w_reg).block_until_ready()
        t_fwd = time.perf_counter() - t0
        _, gn = value_and_grad_only(ts, data, w_reg)
        gn.block_until_ready()
        t0 = time.perf_counter()
        _, gn = value_and_grad_only(ts, data, w_reg)
        gn.block_until_ready()
        t_fwdbwd = time.perf_counter() - t0
        return t_fwd, t_fwdbwd

    return measure


def run_training_step(train_step, ts, data, w_reg, lr, timed: bool = False):
    """Run one step; returns ``(ts, loss, stats, times)`` where times is a
    dict of wall-clock segments (total always; fwd/bwd/opt only for parity
    logging — they are one fused XLA program here)."""
    t0 = time.perf_counter()
    ts, loss, stats = train_step(ts, data, w_reg, lr)
    if timed:
        loss.block_until_ready()
    total = time.perf_counter() - t0
    return ts, loss, stats, {"step_time": total}


def warmup_model(train_step, eval_step, ts, data, w_reg, lr):
    """One forward+backward+update on dummy data to trigger XLA compilation
    before timing starts (reference ``utils.jl:126-153``). The updated
    TrainState is discarded; only compilation caches persist.
    ``train_step=None`` warms only the eval program (block mode compiles
    its own scanned multi-step program instead)."""
    import copy

    ts_copy = jax.tree_util.tree_map(lambda x: x.copy() if hasattr(x, "copy") else copy.copy(x), ts)
    if train_step is not None:
        ts_copy, loss, _ = train_step(ts_copy, data, w_reg, lr)
        loss.block_until_ready()
    if eval_step is not None:
        l2, _ = eval_step(ts_copy, data, w_reg)
        l2.block_until_ready()
    return None
