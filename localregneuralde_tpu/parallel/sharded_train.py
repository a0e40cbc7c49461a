"""Sharded (DP × TP) training over a named device mesh.

Strategy (additive over the single-device semantics, SURVEY.md §2e):

- **Data parallel**: the batch (leading) dimension of inputs is sharded over
  the ``data`` mesh axis. Because the loss is a mean over the whole batch
  tensor and parameters are replicated (or TP-sharded), XLA/GSPMD inserts the
  gradient ``psum`` automatically — no hand-written collectives.
- **Tensor parallel**: wide Dense weights inside the neural-ODE dynamics are
  sharded column-wise/row-wise over the ``model`` axis via rule-based
  PartitionSpecs; XLA inserts the activation all-reduce per RK stage.

Note the shared-adaptive-grid semantic survives sharding: the error norm is a
mean over the full (now distributed) batch tensor, so accept/reject decisions
stay bitwise-identical across devices under GSPMD (one global scalar).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..harness.train import TrainState


def sharding_rules_for_mlp_tp(model_axis: str = "model") -> Dict[str, P]:
    """Tensor-parallel rules for the MLP NeuralODE dynamics: first dynamics
    layer column-parallel, following layers row-parallel on their input dim.
    Keys are regexes over '/'-joined param paths."""
    return {
        r".*neural_ode/model/layer_0/w$": P(None, model_axis),
        r".*neural_ode/model/layer_0/b$": P(model_axis),
        r".*neural_ode/model/layer_\d+/w$": P(model_axis, None),
    }


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def make_param_shardings(params, mesh: Mesh, rules: Optional[Dict[str, P]] = None):
    """Map each param leaf to a NamedSharding: first matching rule, else
    replicated."""
    rules = rules or {}

    def spec_for(path, leaf):
        s = _path_str(path)
        for pattern, spec in rules.items():
            if re.match(pattern, s):
                # only apply if divisible; otherwise replicate
                ok = True
                for dim, axis in enumerate(spec):
                    if axis is None:
                        continue
                    if leaf.ndim <= dim or leaf.shape[dim] % mesh.shape[axis] != 0:
                        ok = False
                if ok and leaf.ndim >= len([a for a in spec]):
                    return NamedSharding(mesh, spec)
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)


def make_sharded_train_step(
    model, loss_fn, optimizer, mesh: Mesh,
    *, rules: Optional[Dict[str, P]] = None, data_axis: str = "data",
    ts_shardings=None, ema_decay: float = 0.0,
    grad_accumulation: int = 1,
) -> Callable:
    """Jitted train step with explicit input/output shardings.

    ``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)`` — identical
    signature and semantics to the single-device step
    (``harness.train.make_train_step``; the body IS the shared
    ``_fused_step_body``), executed SPMD over the mesh.
    ``ema_decay > 0`` folds the params-EMA update in (``ts.ema`` seeded
    via ``harness.train.init_ema`` BEFORE sharding-spec construction so
    the specs carry the ema leaves). ``grad_accumulation=N`` microbatches
    inside the step exactly like the single-device path — the in-jit
    ``(B, …) -> (N, B/N, …)`` reshape of the DP-sharded batch costs one
    GSPMD all-to-all on the (small) input tensors; the knob's purpose —
    O(1) ACTIVATION memory in N — is unaffected.

    Pass ``ts_shardings`` (from ``train_state_shardings``) to PIN the
    TrainState's input AND output shardings. Without it GSPMD is free to
    pick different shardings for some optimizer-moment outputs than the
    inputs carried, so the donated state's layout drifts call-to-call and
    the step recompiles until the layouts reach a fixed point (measured:
    3 full compiles on the DP×TP mesh before settling).
    """
    from ..harness.train import _fused_step_body

    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(data_axis))

    def step(ts: TrainState, data, w_reg, lr):
        return _fused_step_body(
            model, loss_fn, optimizer, ts, data, w_reg, lr,
            n_micro=int(grad_accumulation), ema_decay=float(ema_decay),
        )

    # `batch_sh` is a pytree *prefix*: it broadcasts over any data pytree
    # (2-tuple classification batches, 3-tuple latent/SDE batches, dicts),
    # sharding every leaf's leading (batch) axis over the data mesh axis.
    if ts_shardings is not None:
        return jax.jit(
            step,
            in_shardings=(ts_shardings, batch_sh, repl, repl),
            out_shardings=(ts_shardings, None, None),
            donate_argnums=(0,),
        )
    return jax.jit(
        step,
        in_shardings=(None, batch_sh, repl, repl),
        donate_argnums=(0,),
    )


def make_sharded_multi_train_step(
    model, loss_fn, optimizer, mesh: Mesh,
    *, rules: Optional[Dict[str, P]] = None, data_axis: str = "data",
    ts_shardings=None, reduce_fn: Optional[Callable] = None,
    ema_decay: float = 0.0, grad_accumulation: int = 1,
) -> Callable:
    """Sharded K-steps-per-dispatch train call: ``lax.scan`` over the
    sharded single-step body (``harness.train.make_multi_train_step``
    semantics — the scan body IS the shared ``_fused_step_body`` —
    executed SPMD over the mesh).

    ``multi_step(ts, data_stack, w_regs, lrs) -> (ts', last_loss, red)``
    where every ``data_stack`` leaf is (K, B, ...) with the BATCH axis
    (axis 1) sharded over ``data_axis`` and the scan axis replicated —
    each scanned step consumes one full DP-sharded batch, so the shared
    global adaptive grid semantics are identical to K sequential sharded
    steps. TrainState layouts should be pinned via ``ts_shardings``
    (layout-drift rationale in ``make_sharded_train_step``)."""
    import jax.numpy as jnp
    from jax import lax

    from ..harness.train import _fused_step_body

    if reduce_fn is None:
        def reduce_fn(loss, stats, data):  # noqa: F811 — default reducer
            return {"loss": loss}

    repl = NamedSharding(mesh, P())
    stack_sh = NamedSharding(mesh, P(None, data_axis))

    def multi_step(ts: TrainState, data_stack, w_regs, lrs):
        def body(ts, xs):
            data, w_reg, lr = xs
            ts, loss, stats = _fused_step_body(
                model, loss_fn, optimizer, ts, data, w_reg, lr,
                n_micro=int(grad_accumulation),
                ema_decay=float(ema_decay),
            )
            return ts, (loss, reduce_fn(loss, stats, data))

        ts, (losses, reds) = lax.scan(body, ts, (data_stack, w_regs, lrs))
        red = jax.tree_util.tree_map(lambda a: jnp.sum(a, axis=0), reds)
        return ts, losses[-1], red

    return jax.jit(
        multi_step,
        in_shardings=(ts_shardings, stack_sh, repl, repl),
        out_shardings=(ts_shardings, None, None),
        donate_argnums=(0,),
    )


def shard_batch_stack(batch_stack, mesh: Mesh, data_axis: str = "data"):
    """Place a K-stacked batch pytree with the batch axis (axis 1) sharded
    over the data mesh axis and the scan axis replicated."""
    sh = NamedSharding(mesh, P(None, data_axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh), batch_stack
    )


def train_state_shardings(ts: TrainState, mesh: Mesh,
                          rules: Optional[Dict[str, P]] = None) -> TrainState:
    """NamedSharding pytree for a TrainState: params per rules, optimizer
    moments sharded like their params, layer state and step replicated.
    Feed this to ``shard_train_state`` (placement) and
    ``make_sharded_train_step(ts_shardings=...)`` (pinned layouts)."""
    param_sh = make_param_shardings(ts.params, mesh, rules)
    repl = NamedSharding(mesh, P())

    # Optimizer moment trees (optax adam mu/nu etc.) mirror the param tree
    # under inner paths like 'inner_state/0/0/mu/<param-path>'. Match each
    # opt-state leaf to its param by longest path suffix (+ shape check) and
    # reuse the param's sharding; anything unmatched is replicated.
    p_flat = jax.tree_util.tree_flatten_with_path(ts.params)[0]
    sh_flat = jax.tree_util.tree_flatten_with_path(
        param_sh, is_leaf=lambda x: isinstance(x, NamedSharding)
    )[0]
    by_path = {
        _path_str(path): (sh, leaf.shape)
        for (path, leaf), (_, sh) in zip(p_flat, sh_flat)
    }

    def opt_sharding_for(path, leaf):
        s = _path_str(path)
        if not hasattr(leaf, "shape"):
            return repl
        best_sh, best_len = repl, -1
        for ppath, (sh, shape) in by_path.items():
            if leaf.shape == shape and (
                s == ppath or s.endswith("/" + ppath)
            ) and len(ppath) > best_len:
                best_sh, best_len = sh, len(ppath)
        return best_sh

    opt_sh = jax.tree_util.tree_map_with_path(
        lambda path, leaf: opt_sharding_for(path, leaf), ts.opt_state
    )
    state_sh = jax.tree_util.tree_map(lambda _: repl, ts.state)
    # the params-EMA mirrors the param tree — shard it identically
    # (tree_map over ema=None yields None: pre-EMA states stay compatible)
    ema_sh = None if ts.ema is None else param_sh
    return TrainState(
        params=param_sh, state=state_sh, opt_state=opt_sh, step=repl,
        ema=ema_sh,
    )


def shard_train_state(ts: TrainState, mesh: Mesh,
                      rules: Optional[Dict[str, P]] = None,
                      *, shardings: Optional[TrainState] = None) -> TrainState:
    """Place params (per rules), optimizer state (moments sharded like their
    params), and layer state (replicated) onto the mesh. Pass a
    precomputed ``shardings`` tree (from ``train_state_shardings``) to
    skip recomputing it."""
    sh = shardings if shardings is not None else train_state_shardings(
        ts, mesh, rules
    )

    def put(leaf, s):
        return jax.device_put(leaf, s) if hasattr(leaf, "shape") else leaf

    return TrainState(
        params=jax.tree_util.tree_map(put, ts.params, sh.params),
        state=jax.tree_util.tree_map(put, ts.state, sh.state),
        opt_state=jax.tree_util.tree_map(put, ts.opt_state, sh.opt_state),
        step=put(ts.step, sh.step),
        ema=(None if ts.ema is None
             else jax.tree_util.tree_map(put, ts.ema, sh.ema)),
    )
