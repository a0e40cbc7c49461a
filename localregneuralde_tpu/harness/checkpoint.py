"""Checkpoint save/load with best/current pointers.

Reference: ``experiments/src/utils.jl:169-191`` (JLSO blobs +
``model_best``/``model_current`` symlinks). Here: the full TrainState pytree
(params, layer state, optimizer state, step) is serialized as host numpy
arrays + a pytree treedef, written atomically (tmp + rename), with the same
best/current symlink scheme. Corrupt/missing checkpoints warn and return
``None`` → fresh start, matching reference behavior.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Optional

import jax
import numpy as np


def _to_host(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def save_checkpoint(
    state: Any, *, fdir: str, fname: str, is_best: bool = False,
    backend: str = "pickle",
) -> str:
    os.makedirs(fdir, exist_ok=True)
    path = os.path.join(fdir, fname)
    if backend == "orbax":
        _orbax_save(path, state)
    else:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(_to_host(state), f)
        os.replace(tmp, path)
    _symlink_safe(path, os.path.join(fdir, "model_current.ckpt"))
    if is_best:
        _symlink_safe(path, os.path.join(fdir, "model_best.ckpt"))
    return path


def load_checkpoint(path: str) -> Optional[Any]:
    try:
        if os.path.isdir(os.path.realpath(path)):  # orbax checkpoints are dirs
            return _orbax_load(path)
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception as e:  # warn + fresh start (reference utils.jl:182-191)
        warnings.warn(f"could not load checkpoint {path!r}: {e}")
        return None


def _orbax_save(path: str, state: Any):
    """Orbax PyTree checkpoint (async-capable backend)."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), _to_host(state), force=True)


def _orbax_load(path: str) -> Any:
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(os.path.realpath(path)))


def _symlink_safe(target: str, link: str):
    try:
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(os.path.abspath(target), link)
    except OSError as e:
        warnings.warn(f"could not create symlink {link!r}: {e}")
