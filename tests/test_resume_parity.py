"""Kill/resume exactness and the steps-per-call rule.

The reference restarts from ``model_current`` (main.jl:57-72) but its data
stream restarts from scratch; here resume is made trajectory-EXACT: the
seeded loaders fast-forward (index-only ``skip_batches``) to the resumed
step's position in the stream, and checkpoints carry the running ``best``
marker so best-checkpoint selection continues identically. These tests pin
that an interrupted+resumed run reproduces the uninterrupted run bitwise
(same jitted programs, same inputs, CPU determinism).
"""
import os

import numpy as np
import pytest

from localregneuralde_tpu.harness import load_checkpoint
from localregneuralde_tpu.harness.data import Dataloader


def _loaders():
    yield Dataloader
    from localregneuralde_tpu.native.loader import (
        NativeDataloader,
        native_available,
    )

    if native_available():
        yield NativeDataloader


def test_loader_skip_batches_equivalence():
    """A loader created with skip_batches=k yields exactly the tail of the
    stream an unskipped loader yields — across epoch boundaries, on both
    the Python and native backends."""
    x = np.arange(100 * 3, dtype=np.float32).reshape(100, 3)
    y = np.arange(100, dtype=np.int32)
    for cls in _loaders():
        full = iter(cls((x, y), 8, shuffle=True, cycle=True, seed=3))
        ref = [next(full) for _ in range(40)]
        for skip in (0, 5, 12, 25, 37):  # 12 batches/epoch: crosses epochs
            sk = iter(
                cls((x, y), 8, shuffle=True, cycle=True, seed=3,
                    skip_batches=skip)
            )
            for a, b in zip(ref[skip:], (next(sk) for _ in range(40 - skip))):
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])


def _cfg(tmp_path, total_steps, log_sub):
    from localregneuralde_tpu.harness import ExperimentConfig

    cfg = ExperimentConfig()
    cfg.model.model_type = "mlp"
    cfg.model.regularize = "unbiased"
    cfg.model.image_size = [8, 8]
    cfg.model.in_channels = 1
    cfg.model.mlp_hidden_state_size = 16
    cfg.model.solver.abstol = 1e-2
    cfg.model.solver.reltol = 1e-2
    cfg.model.solver.max_steps = 32
    cfg.model.solver.checkpoint_every = 8
    cfg.dataset.train_batchsize = 16
    cfg.dataset.eval_batchsize = 64
    cfg.train.total_steps = total_steps
    cfg.train.print_frequency = 2
    cfg.train.evaluate_every = 4
    cfg.train.checkpoint_dir = str(tmp_path / f"ckpt_{log_sub}")
    cfg.train.log_dir = str(tmp_path / f"logs_{log_sub}")
    cfg.optimizer.scheduler.lr_scheduler = "constant"
    return cfg


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Uninterrupted 8-step run == 4-step run + resumed 8-step run, leaf
    for leaf (params, opt state, EMA slot) and in the best-eval marker."""
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    out_full = run_classification_experiment(
        _cfg(tmp_path, 8, "full"), "parity"
    )

    # interrupted: the SAME 8-step config stopped at step 4 (so every
    # schedule — w_reg decay, LR — is the 8-step one; max_steps_override
    # only cuts the loop short, emulating a mid-run kill after the step-4
    # checkpoint landed)...
    run_classification_experiment(
        _cfg(tmp_path, 8, "cut"), "parity", max_steps_override=4
    )
    # ...then resume from the SAME checkpoint dir to step 8
    cfg_res = _cfg(tmp_path, 8, "cut")
    out_res = run_classification_experiment(cfg_res, "parity")

    assert out_res["final_step"] == 8
    assert out_res["best_eval_acc"] == pytest.approx(
        out_full["best_eval_acc"], abs=0.0
    )

    a = load_checkpoint(
        os.path.join(out_full["ckpt_dir"], "model_current.ckpt")
    )
    b = load_checkpoint(
        os.path.join(out_res["ckpt_dir"], "model_current.ckpt")
    )
    assert int(a["step"]) == int(b["step"]) == 8
    la = jax_leaves(a["tstate"])
    lb = jax_leaves(b["tstate"])
    assert len(la) == len(lb)
    for xa, xb in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


def jax_leaves(tree):
    import jax

    return [
        l for l in jax.tree_util.tree_leaves(tree)
        if hasattr(l, "shape")
    ]


def test_resolve_steps_per_call_auto():
    """steps_per_call=0 (auto) resolves to K=1 on every backend; explicit
    values pass through."""
    from localregneuralde_tpu.harness.runner import resolve_steps_per_call

    assert resolve_steps_per_call(4) == 4
    assert resolve_steps_per_call(1) == 1
    assert resolve_steps_per_call(0) == 1
