"""AOT serving export: serialized StableHLO artifacts via ``jax.export``.

Serving story (no reference counterpart — the reference deploys
nothing; ``experiments/*/main.jl`` only train). A trained Neural-DE model is
exported as a platform-checked, shape-checked StableHLO program that a
serving process can load and run **without the framework, the model builder,
or the Python layer zoo** — only ``jax`` is needed at load time:

    exp = export_model(model, params, state, example)      # trace + freeze
    save_exported(exp, "model.stablehlo")                   # bytes on disk
    ...
    fn = load_exported("model.stablehlo")                   # serving process
    y = fn(batch)

Design notes:

- **Static shapes.** The adaptive integrator's shared-batch error norm
  and the compiled layouts are static-shape programs. Batch polymorphism
  via symbolic dims would force the lowest-common-denominator lowering,
  so exports are per-batch-size; ``export_model_multi`` packs several
  batch sizes into one artifact and dispatch picks by leading dim.
- **Params are baked** (``freeze=True`` default): serving wants one
  self-contained executable, not a (weights, program) pair. ``freeze=False``
  exports ``fn(params, x)`` for weight-hot-swap setups.
- **Eval-mode forward**: ``training=False`` — no reg-step sampling, no PRNG
  requirements, ReparameterizeLayer returns the posterior mean
  (reference ``common.jl:73-77`` semantics).
- The export captures whatever the model lowered to on the export
  platform; pass ``platforms=('cpu', 'cuda')`` for an artifact that loads
  on either.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import export as jax_export

_MAGIC = b"LRNDE-EXPORT-V1\n"


def _eval_forward(model, params, state, *, with_state: bool,
                  freeze: bool, freeze_state: bool):
    """Eval-mode forward with weights/state baked or threaded.

    Returns ``(fn, extra_example_args)`` where ``extra_example_args`` are
    the non-``x`` leading arguments the exported callable takes."""
    if freeze and freeze_state:
        def fn(x):
            y, st = model(params, state, x, training=False)
            return (y, st) if with_state else y

        return fn, ()
    if freeze and not freeze_state:
        def fn(st_in, x):
            y, st = model(params, st_in, x, training=False)
            return y, st

        return fn, (state,)
    if not freeze and freeze_state:
        def fn(p, x):
            y, st = model(p, state, x, training=False)
            return (y, st) if with_state else y

        return fn, (params,)

    def fn(p, st_in, x):
        y, st = model(p, st_in, x, training=False)
        return y, st

    return fn, (params, state)


def export_model(
    model,
    params,
    state,
    example_input,
    *,
    freeze: bool = True,
    freeze_state: bool = True,
    with_state: bool = False,
    platforms: Optional[Sequence[str]] = None,
) -> jax_export.Exported:
    """Trace the eval-mode forward and export it as StableHLO.

    ``example_input`` fixes shapes/dtypes (an array or a ShapeDtypeStruct).
    ``freeze=True`` bakes params into the program as constants; otherwise
    the exported callable takes them as a leading argument.
    ``freeze_state=True`` likewise bakes the layer state. **Stochastic
    caveat**: ``NeuralDSDE``/``ReparameterizeLayer`` draw noise from the
    PRNG key in the layer state — a fully frozen export replays the SAME
    noise every call (deterministic serving; fine for ODE families whose
    eval forward is deterministic anyway). For fresh-noise serving use
    ``freeze_state=False``: the callable becomes ``fn(state, x) ->
    (y, state')`` and the caller threads the returned state.
    ``with_state=True`` additionally returns the post-call layer state
    (NFE counters, reg values — serving-side solver telemetry); implied
    whenever ``freeze_state=False``.
    ``platforms`` defaults to the current backend.
    """
    fn, extra = _eval_forward(
        model, params, state, with_state=with_state, freeze=freeze,
        freeze_state=freeze_state,
    )

    def spec_of(tree):
        return jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
            tree,
        )

    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    specs = tuple(spec_of(t) for t in extra) + (spec_of(example_input),)
    return jax_export.export(jax.jit(fn), **kwargs)(*specs)


def export_fn(
    fn: Callable,
    *example_args,
    platforms: Optional[Sequence[str]] = None,
) -> jax_export.Exported:
    """Export an arbitrary jittable callable (e.g. a score-SDE sampler
    closure, a custom eval head) at the shapes/dtypes of
    ``example_args`` (arrays or ShapeDtypeStructs)."""
    specs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
        example_args,
    )
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    return jax_export.export(jax.jit(fn), **kwargs)(*specs)


def export_model_multi(
    model,
    params,
    state,
    example_input,
    batch_sizes: Sequence[int],
    **kwargs,
) -> dict:
    """One exported program per batch size (static-shape serving ladder).

    ``example_input``'s leading axis is replaced by each entry of
    ``batch_sizes``. Returns ``{B: Exported}``; see ``MultiExported`` for
    the dispatching loader."""
    outs = {}
    for b in batch_sizes:
        spec = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(
                (int(b),) + tuple(jnp.shape(a)[1:]), jnp.result_type(a)
            ),
            example_input,
        )
        outs[int(b)] = export_model(model, params, state, spec, **kwargs)
    return outs


# ---------------------------------------------------------------------------
# serialization container: MAGIC | n | (len | name_len | name | bytes)*


def _pack(named_blobs):
    import struct

    out = [_MAGIC, struct.pack("<I", len(named_blobs))]
    for name, blob in named_blobs:
        nb = name.encode()
        out.append(struct.pack("<II", len(nb), len(blob)))
        out.append(nb)
        out.append(bytes(blob))
    return b"".join(out)


def _unpack(data: bytes):
    import struct

    if not data.startswith(_MAGIC):
        raise ValueError("not an LRNDE export artifact")
    off = len(_MAGIC)
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    blobs = []
    for _ in range(n):
        ln, lb = struct.unpack_from("<II", data, off)
        off += 8
        name = data[off:off + ln].decode()
        off += ln
        blobs.append((name, data[off:off + lb]))
        off += lb
    return blobs


def save_exported(exported, path: str) -> None:
    """Serialize one ``Exported`` (or a ``{batch: Exported}`` ladder from
    ``export_model_multi``) to ``path`` atomically (tmp+rename, same
    discipline as ``harness/checkpoint.py``)."""
    if isinstance(exported, dict):
        blobs = [(f"b{b}", e.serialize()) for b, e in sorted(exported.items())]
    else:
        blobs = [("single", exported.serialize())]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_pack(blobs))
    os.replace(tmp, path)


class MultiExported:
    """Batch-size-dispatching wrapper over a serving ladder.

    Calls route to the smallest exported batch size ≥ the input's leading
    dim, zero-padding the tail (adaptive-solver note: padding joins the
    shared batch error norm, so tiny remainders on a big program can alter
    step counts — export the ladder you actually serve)."""

    def __init__(self, by_batch):
        self.by_batch = dict(sorted(by_batch.items()))
        self._jitted = {b: jax.jit(e.call) for b, e in self.by_batch.items()}

    def __call__(self, x, *args):
        b = jnp.shape(x)[0]
        for bb in self.by_batch:
            if bb >= b:
                if bb == b:
                    return self._jitted[bb](x, *args)
                pad = [(0, bb - b)] + [(0, 0)] * (jnp.ndim(x) - 1)
                y = self._jitted[bb](jnp.pad(x, pad), *args)
                # strip padding only from batch-leading outputs (scalar
                # telemetry like NFE counters passes through untouched)
                return jax.tree_util.tree_map(
                    lambda a: a[:b]
                    if jnp.ndim(a) and jnp.shape(a)[0] == bb else a,
                    y,
                )
        raise ValueError(
            f"batch {b} exceeds largest exported size "
            f"{max(self.by_batch)}"
        )


def load_exported(path: str) -> Callable:
    """Load an artifact saved by ``save_exported``.

    Returns a jitted callable: the deserialized program for single exports,
    a ``MultiExported`` dispatcher for ladders. Only ``jax`` is required —
    no framework modules are touched."""
    with open(path, "rb") as f:
        blobs = _unpack(f.read())
    if len(blobs) == 1 and blobs[0][0] == "single":
        return jax.jit(jax_export.deserialize(blobs[0][1]).call)
    return MultiExported(
        {int(name[1:]): jax_export.deserialize(blob) for name, blob in blobs}
    )
