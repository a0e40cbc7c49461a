"""jax-version compatibility shims for the parallel layer.

``shard_map`` moved from ``jax.experimental.shard_map`` to ``jax`` and
renamed its replication-check kwarg ``check_rep`` → ``check_vma``. An
import fallback alone is a trap: calling the old function with the new
keyword raises ``TypeError`` — the KEYWORD has to switch with the
import. This helper is the single place that dance lives; everything in
this repo (train steps, samplers, dryrun, tests) goes through it.
"""
from __future__ import annotations

try:  # jax >= 0.8
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover — older jax
    from jax.experimental.shard_map import shard_map as _shard_map  # type: ignore


def shard_map_nocheck(f, mesh, in_specs, out_specs):
    """``shard_map`` with replication/VMA checking disabled (the per-shard
    train step and samplers return values the checker cannot prove
    replicated), portable across the ``check_rep``/``check_vma`` rename."""
    for kwargs in ({"check_vma": False}, {"check_rep": False}):
        try:
            return _shard_map(
                f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                **kwargs,
            )
        except TypeError:  # pragma: no cover — other jax vintage
            continue
    # pragma: no cover — neither kwarg known: let the default check run
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
