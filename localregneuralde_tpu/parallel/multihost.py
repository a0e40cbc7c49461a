"""Multi-process (multi-host) training: meshes that span processes.

The reference is single-process only (one Julia process, one CUDA device —
SURVEY.md §2e); this module is the additive scaling layer for meshes that
span PROCESSES — several GPU hosts, or several CPU processes. It composes
with the existing GSPMD layer (`sharded_train.py`) unchanged: `make_mesh`
builds over the GLOBAL `jax.devices()`, `make_sharded_train_step` is
already SPMD, and XLA routes the gradient `psum` within a host and across
hosts. What this module adds is the process-boundary plumbing that
single-process code gets for free:

- **initialize()** — `jax.distributed` bring-up (coordinator handshake);
  pass the coordinator address, process count and process id.
- **place_global(tree, shardings)** — build global arrays from host values
  every process holds (params, optimizer state): works for ANY sharding —
  replicated, DP, or TP that spans process boundaries — because each
  process contributes exactly the shards it addresses.
- **place_train_state(ts, mesh, ...)** — the multi-process analog of
  `shard_train_state` (whose `jax.device_put` requires fully-addressable
  targets and therefore fails across processes).
- **global_batch(local, mesh, global_batch_size)** — assemble the global
  DP-sharded batch from each process's LOCAL slice of the data (no host
  ever materializes the full batch), with `process_batch_slice` telling
  each process which contiguous rows to load.
- **gather_to_host(tree)** — all-gather global arrays back to every host
  (checkpointing batch-sharded layer state), and **is_primary()** to gate
  checkpoint/log writes to one process.

Determinism note: initialize every process's TrainState from the SAME
PRNG seed (the framework's `create_train_state(model, optimizer, key)` is
deterministic), or broadcast with `place_global` from identical host
values — both give bitwise-identical replicated params, which GSPMD
assumes. Verified end-to-end by ``tests/test_multihost.py``: a 2-process
× 2-device run (DP×TP mesh spanning the process boundary, Gloo
collectives) reproduces the single-process 4-device loss trajectory.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               **kwargs) -> None:
    """Bring up ``jax.distributed`` (idempotent no-op if already up).

    Pass ``coordinator_address='host0:port'``, ``num_processes`` and
    ``process_id`` (cluster schedulers JAX knows, such as SLURM, fill
    them in when they are omitted). MUST run before the first backend touch (any jax
    array op) — set platform overrides (``jax.config.update``) first.
    """
    # is_initialized does NOT touch the backend (jax.process_count()
    # would initialize it, breaking the must-run-first contract)
    if jax.distributed.is_initialized() or (
        num_processes is not None and num_processes == 1
    ):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0


def place_global(tree: Any, shardings: Any) -> Any:
    """Build global arrays from host values present on EVERY process.

    Each leaf of ``tree`` is a full (unsharded) host array that all
    processes hold identically; ``shardings`` is a matching tree of
    ``NamedSharding``. Every process contributes the shards its devices
    address (``jax.make_array_from_callback`` slices the host value), so
    this works for replicated leaves AND leaves sharded across the
    process boundary (e.g. TP weights across hosts). The single-process
    ``jax.device_put`` path cannot do the latter.
    """

    def put(x, sh):
        if not hasattr(x, "shape"):
            return x
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: x[idx]
        )

    return jax.tree_util.tree_map(put, tree, shardings)


def place_train_state(ts, mesh: Mesh, rules=None, *, shardings=None):
    """Multi-process analog of ``shard_train_state``: place a host-built
    TrainState onto a (possibly process-spanning) mesh. Build ``ts`` from
    the same seed on every process first."""
    from .sharded_train import train_state_shardings

    sh = shardings if shardings is not None else train_state_shardings(
        ts, mesh, rules
    )
    return place_global(ts, sh)


def process_batch_slice(mesh: Mesh, global_batch_size: int,
                        data_axis: str = "data") -> slice:
    """The contiguous row range of the global batch this process must
    load (feed it to ``global_batch``). Derived from the sharding's own
    device→index map, so it is correct for any mesh layout where each
    process's rows are contiguous (the default device order)."""
    sharding = NamedSharding(mesh, P(data_axis))
    imap = sharding.devices_indices_map((global_batch_size,))
    rows = sorted(
        {
            (idx[0].start or 0, idx[0].stop or global_batch_size)
            for dev, idx in imap.items()
            if dev.process_index == jax.process_index()
        }
    )
    lo, hi = rows[0][0], rows[-1][1]
    covered = sorted(set(rows))
    span = sum(b - a for a, b in covered)
    if span != hi - lo:
        raise ValueError(
            f"this process's batch rows are not contiguous: {covered} — "
            "use a mesh layout with the data axis major"
        )
    return slice(lo, hi)


def global_batch(local: Any, mesh: Mesh, global_batch_size: int,
                 data_axis: str = "data") -> Any:
    """Assemble the global DP-sharded batch from this process's local
    rows (from ``process_batch_slice``). Every leaf's leading dim is the
    local row count; the result's leading dim is ``global_batch_size``."""
    sh = NamedSharding(mesh, P(data_axis))

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sh, x, (global_batch_size,) + x.shape[1:]
        )

    return jax.tree_util.tree_map(put, local)


def global_batch_stack(local: Any, mesh: Mesh, global_batch_size: int,
                       data_axis: str = "data") -> Any:
    """Assemble a K-stacked global batch (leaves ``(K, B_local, ...)`` →
    global ``(K, B, ...)`` with the BATCH axis (axis 1) sharded and the
    scan axis replicated) — the multi-process analog of
    ``shard_batch_stack`` for ``train.steps_per_call`` blocks."""
    sh = NamedSharding(mesh, P(None, data_axis))

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sh, x, (x.shape[0], global_batch_size) + x.shape[2:]
        )

    return jax.tree_util.tree_map(put, local)


def place_replicated(tree: Any, mesh: Mesh) -> Any:
    """Place host values (identical on every process) fully replicated on
    the global mesh — loop-carried accumulators, eval batches, etc. that
    must be global arrays to enter a jit alongside mesh-placed state."""
    repl = NamedSharding(mesh, P())
    return place_global(
        tree, jax.tree_util.tree_map(lambda _: repl, tree)
    )


def gather_to_host(tree: Any) -> Any:
    """Materialize global (possibly non-addressable) arrays as full host
    numpy arrays on EVERY process (all-gather over DCN) — for
    checkpointing a train state whose layer-state leaves are
    batch-sharded. Replicated/addressable leaves take the cheap path."""
    from jax.experimental import multihost_utils

    def get(x):
        if not hasattr(x, "shape"):
            return x
        if getattr(x, "is_fully_addressable", True):
            return jax.device_get(x)
        return multihost_utils.process_allgather(x, tiled=True)

    return jax.tree_util.tree_map(get, tree)
