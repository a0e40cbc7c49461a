"""Per-shard-grid data parallelism via ``shard_map`` (opt-in).

The default sharded path (``sharded_train.make_sharded_train_step``) keeps
the reference's shared-adaptive-grid semantics exactly: GSPMD computes ONE
error norm over the whole distributed batch, so every device executes the
same accept/reject sequence (``src/utils.jl:60-61`` controller semantics,
one dt for the batch). The cost is a cross-device reduction of the error
norm on every attempt, and every device steps as often as the hardest
sub-batch needs.

This module is the opt-in alternative for multi-device throughput: each
shard runs the COMPLETE single-device train computation on its local
sub-batch with its OWN adaptive grid, and the only cross-device
communication is one fused ``pmean`` of (loss, grads, scalar state) per
step.

**Documented estimator deviation**: with ``n`` shards the regularized
objective becomes the mean of ``n`` independent per-sub-batch solves
(each with its own dt sequence and its own reg_val) instead of one
solve of the global batch. This is a well-defined — and for adaptivity,
strictly finer-grained — estimator, but it is NOT bitwise the reference
semantic; NFE statistics are reported as the per-shard mean (float).
Keep the GSPMD path for reference-exact numbers.

Per-leaf state handling inside the shard (classification is by state
leaf, derived once via ``jax.eval_shape``):

- ``rng`` leaves: per-shard effective key = ``fold_in(key, axis_index)``
  (decorrelates SDE noise / unbiased-t1 draws / reparameterization
  across shards); the carried key is advanced deterministically and
  identically on every shard, so it stays replicated.
- leaves whose leading dim equals the local batch (e.g.
  ``ReparameterizeLayer``'s mu/logvar): stay batch-sharded.
- everything else (NFE counters, reg_val, BatchNorm running stats):
  cross-shard ``pmean`` cast back to the original dtype — for BN
  statistics this is exactly the cross-replica sync a distributed
  BatchNorm wants. Boolean leaves (``success`` flags) reduce by
  all-shards AND instead: one diverged shard must surface.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..harness.train import TrainState

from .compat import shard_map_nocheck


def _is_rng_path(path) -> bool:
    last = path[-1]
    key = getattr(last, "key", None)
    return key == "rng"


def _advance_key(k, salt):
    """Deterministic replicated advance of a carried rng leaf (the model's
    own per-shard advance is discarded — it diverges across shards)."""
    return jax.random.fold_in(k, salt)


def make_shardmap_train_step(
    model, loss_fn, optimizer, mesh: Mesh, *, data_axis: str = "data",
    ema_decay: float = 0.0,
) -> Callable:
    """Build the per-shard-grid DP train step.

    ``train_step(ts, data, w_reg, lr) -> (ts', loss, stats)`` — same
    signature as ``harness.train.make_train_step``. ``ts`` must be
    placed via ``shard_train_state`` (params/opt replicated) with its
    layer state settled at the GLOBAL batch shape
    (``harness.train.settle_state_shapes``); ``data`` leaves must have
    their leading dim divisible by ``mesh.shape[data_axis]`` and be
    placed with ``shard_batch``. ``loss`` and scalar ``stats`` come back
    as cross-shard means; ``stats['nfe']``-style counters become floats
    (per-shard mean — shards run different adaptive grids by design);
    batch-shaped stats leaves (``y_pred``) stay batch-sharded and
    reassemble the global batch, so runner-side accuracy is exact.
    """
    n_shards = mesh.shape[data_axis]
    repl_spec = P()
    batch_spec = P(data_axis)

    jitted = {}

    def build(ts, data, w_reg, lr):
        # ---- classify state leaves from local output shapes ----------
        # Classification runs the abstract loss at TWO local batch sizes
        # (b_local and 2·b_local): a leaf is batch-type iff its leading
        # dim tracks the batch across both evals. A single-size
        # dim-equality check misclassifies leaves whose leading dim
        # coincidentally equals b_local (e.g. a (2,)-wide stats pair at
        # b_local=2); a constant dim cannot match both sizes.
        b_global = jax.tree_util.tree_leaves(data)[0].shape[0]
        b_local = b_global // n_shards
        abs_params = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ts.params
        )

        def eval_at(b):
            # input state: leaves whose leading dim is exactly the
            # GLOBAL batch are presumed batch-type and re-sized; a
            # non-batch leaf colliding with b_global would fail this
            # trace loudly (shape mismatch inside the model).
            st = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(
                    ((b,) + x.shape[1:])
                    if (x.ndim >= 1 and x.shape[0] == b_global
                        and b_global > 0)
                    else x.shape,
                    x.dtype,
                ),
                ts.state,
            )
            d = jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(
                    (b,) + x.shape[1:], x.dtype
                ),
                data,
            )
            return jax.eval_shape(
                lambda p, s, dd: loss_fn(
                    model, p, s, dd, w_reg, training=True
                )[1:],
                abs_params, st, d,
            )

        st_out, stats_out = eval_at(b_local)
        st_out2, stats_out2 = eval_at(2 * b_local)

        def _tracks_batch(l1, l2):
            return (l1.ndim >= 1 and l1.shape[0] == b_local
                    and l2.shape[0] == 2 * b_local)

        def classify(path, leaf, leaf2):
            if _is_rng_path(path):
                return "rng"
            if _tracks_batch(leaf, leaf2):
                return "batch"
            return "reduce"

        cls = jax.tree_util.tree_map_with_path(classify, st_out, st_out2)
        state_spec = jax.tree_util.tree_map(
            lambda c: batch_spec if c == "batch" else repl_spec, cls
        )
        # stats: batch-shaped leaves (e.g. y_pred for accuracy) stay
        # sharded — concatenating across shards reconstructs the global
        # batch; scalar/other leaves are cross-shard means (booleans:
        # all-shards AND).
        stats_cls = jax.tree_util.tree_map(
            lambda l1, l2: "batch" if _tracks_batch(l1, l2) else "reduce",
            stats_out, stats_out2,
        )
        stats_spec = jax.tree_util.tree_map(
            lambda c: batch_spec if c == "batch" else repl_spec, stats_cls
        )

        ts_spec = TrainState(
            params=jax.tree_util.tree_map(lambda _: repl_spec, ts.params),
            state=state_spec,
            opt_state=jax.tree_util.tree_map(
                lambda x: repl_spec, ts.opt_state,
                is_leaf=lambda x: hasattr(x, "shape"),
            ),
            step=repl_spec,
            # params-EMA rides replicated (grads are pmean'd, so the
            # params — and hence the EMA update — are shard-identical)
            ema=jax.tree_util.tree_map(lambda _: repl_spec, ts.ema),
        )
        data_spec = jax.tree_util.tree_map(lambda _: batch_spec, data)

        def local_step(ts, data, w_reg, lr):
            idx = jax.lax.axis_index(data_axis)

            # per-shard effective rng; carried key re-replicated below
            def eff(path, leaf):
                if _is_rng_path(path):
                    return jax.random.fold_in(leaf, idx)
                return leaf

            state_in = jax.tree_util.tree_map_with_path(eff, ts.state)

            def objective(params):
                loss, st_, stats = loss_fn(
                    model, params, state_in, data, w_reg, training=True
                )
                return loss, (st_, stats)

            (loss, (st_, stats)), grads = jax.value_and_grad(
                objective, has_aux=True
            )(ts.params)

            def reduce_leaf(x):
                # booleans are success-style flags: the correct
                # cross-shard reduction is ALL (a diverged shard must
                # surface), not a mean that any nonzero rounds to True.
                x = jnp.asarray(x)
                if x.dtype == jnp.bool_:
                    return jax.lax.psum(
                        x.astype(jnp.int32), data_axis
                    ) == n_shards
                return jax.lax.pmean(
                    jnp.asarray(x, jnp.float32), data_axis
                )

            loss = jax.lax.pmean(loss, data_axis)
            grads = jax.lax.pmean(grads, data_axis)
            stats = jax.tree_util.tree_map(
                lambda x, c: x if c == "batch" else reduce_leaf(x),
                stats, stats_cls,
            )

            def merge(path, leaf, c, old):
                if c == "rng":
                    return _advance_key(old, 1)
                if c == "batch":
                    return leaf
                red = reduce_leaf(leaf)
                return red.astype(leaf.dtype)

            state_out = jax.tree_util.tree_map_with_path(
                merge, st_, cls, ts.state
            )

            opt_state = ts.opt_state
            opt_state.hyperparams["learning_rate"] = lr
            updates, opt_state = optimizer.update(
                grads, opt_state, ts.params
            )
            params = optax.apply_updates(ts.params, updates)
            if ema_decay > 0.0:
                d = jnp.float32(ema_decay)
                ema = jax.tree_util.tree_map(
                    lambda e, p: e * d + p * (1.0 - d), ts.ema, params
                )
            else:
                ema = ts.ema
            ts = TrainState(
                params=params, state=state_out, opt_state=opt_state,
                step=ts.step + 1, ema=ema,
            )
            return ts, loss, stats

        mapped = shard_map_nocheck(
            local_step, mesh,
            in_specs=(ts_spec, data_spec, repl_spec, repl_spec),
            out_specs=(ts_spec, repl_spec, stats_spec),
        )
        return jax.jit(mapped, donate_argnums=(0,))

    def train_step(ts: TrainState, data, w_reg, lr):
        # w_reg may be a scalar or a pytree (latent configs pass
        # (w_kl, w_reg)); P() in_specs broadcast over any pytree prefix.
        w_reg = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float32), w_reg
        )
        sig = jax.tree_util.tree_structure(data), tuple(
            x.shape for x in jax.tree_util.tree_leaves(data)
        )
        if sig not in jitted:
            jitted[sig] = build(ts, data, w_reg, jnp.asarray(lr))
        return jitted[sig](ts, data, w_reg, jnp.asarray(lr, jnp.float32))

    return train_step
