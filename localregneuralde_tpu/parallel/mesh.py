"""Device-mesh helpers for SPMD execution.

The reference has no distributed execution (SURVEY.md §2e); this module is
the additive layer: a named ``jax.sharding.Mesh`` over the devices in
``jax.devices()`` order, with ``data`` (batch) and ``model``
(tensor-parallel) axes. The flat order suits GPUs of one host that are
joined all to all (NVLink), where no device pair is farther apart than
another. Collectives are
inserted by XLA from the sharding annotations (GSPMD), not hand-written.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_sizes: Dict[str, int], devices: Optional[Sequence] = None
) -> Mesh:
    """Create a mesh, e.g. ``make_mesh({'data': 4, 'model': 2})``."""
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(list(axis_sizes.values())))
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices, only {len(devices)} available"
        )
    dev_array = np.array(devices[:n]).reshape(tuple(axis_sizes.values()))
    return Mesh(dev_array, tuple(axis_sizes.keys()))


def data_sharding(mesh: Mesh, *, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dimension over the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh, *, axis: str = "data"):
    """Device-put a host batch with its leading dim sharded over ``axis``."""
    sh = data_sharding(mesh, axis=axis)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh), batch
    )
