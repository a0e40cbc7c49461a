#!/usr/bin/env python
"""Inference/serving walkthrough: train briefly, checkpoint, reload, and
serve batched predictions on the early-exit inference path.

Eval-mode solves run the non-differentiable ``adjoint='none'`` while-loop
(early exit at t_end — no fixed-capacity scan, no adjoint bookkeeping), so
a locally regularized model's lower NFE translates directly into serving
throughput. With several devices visible the batch fans out over a data
mesh (GSPMD inserts no collectives — inference is embarrassingly data
parallel).

Run: python examples/inference.py   (CPU or GPU; ~2 min on CPU)

For a virtual N-device mesh on the CPU, run with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=N — virtual CPU devices
share the same physical cores, so the sharded row shows a real speedup
only on actual multi-device hardware.
"""
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from localregneuralde_tpu.harness import (
    ExperimentConfig,
    construct_loss,
    construct_model,
    construct_optimizer,
    create_train_state,
    load_checkpoint,
    make_eval_step,
    make_train_step,
    one_hot,
    save_checkpoint,
)
from localregneuralde_tpu.harness.data import synthetic_classification
from localregneuralde_tpu.harness.losses import accuracy
from localregneuralde_tpu.harness.train import TrainState


def flagship_config():
    cfg = ExperimentConfig()
    cfg.model.model_type = "mlp"
    cfg.model.regularize = "unbiased"
    cfg.model.image_size = [28, 28]
    cfg.model.in_channels = 1
    cfg.model.mlp_hidden_state_size = 100
    cfg.model.solver.abstol = 1e-4
    cfg.model.solver.reltol = 1e-4
    cfg.model.solver.max_steps = 64
    cfg.optimizer.learning_rate = 1e-3
    cfg.optimizer.scheduler.lr_scheduler = "constant"
    return cfg


def main():
    cfg = flagship_config()
    model = construct_model(cfg)
    loss_fn, w_sched = construct_loss(cfg)
    optimizer, lr_sched = construct_optimizer(cfg)

    x_tr, y_tr, x_te, y_te = synthetic_classification(
        (28, 28), 1, 10, n_train=4096, n_test=2048, seed=0
    )

    # --- 1. brief training (200 steps), then checkpoint -----------------
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    step_fn = make_train_step(model, loss_fn, optimizer)
    import numpy as np

    rng = np.random.RandomState(0)
    for step in range(1, 201):
        idx = rng.randint(0, len(x_tr), 256)
        batch = (jnp.asarray(x_tr[idx]), jnp.asarray(one_hot(y_tr[idx], 10)))
        ts, loss, stats = step_fn(
            ts, batch, float(w_sched(step)), float(lr_sched(step))
        )
    print(f"trained 200 steps: loss={float(loss):.4f} "
          f"train-path NFE={int(stats['nfe'])}")

    ckpt_dir = tempfile.mkdtemp(prefix="lrn_serve_")
    save_checkpoint(
        {"tstate": jax.device_get(ts), "step": 200},
        fdir=ckpt_dir, fname="model.ckpt", is_best=True,
    )

    # --- 2. reload into a fresh process-state and serve -----------------
    restored = load_checkpoint(str(Path(ckpt_dir) / "model.ckpt"))
    ts2 = jax.tree_util.tree_map(jnp.asarray, restored["tstate"])
    assert isinstance(ts2, TrainState)
    eval_step = make_eval_step(model, loss_fn)

    xe = jnp.asarray(x_te[:1024])
    ye = jnp.asarray(one_hot(y_te[:1024], 10))

    # warmup compiles the early-exit inference program
    _, st = eval_step(ts2, (xe, ye), 0.0)
    jax.block_until_ready(st["nfe"])
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        loss_e, st = eval_step(ts2, (xe, ye), 0.0)
    jax.block_until_ready(loss_e)
    dt = (time.perf_counter() - t0) / reps
    acc1 = float(accuracy(st["y_pred"], ye))
    print(
        f"serving: batch 1024 in {dt * 1e3:.1f} ms "
        f"({1024 / dt:,.0f} imgs/s), eval NFE={int(st['nfe'])}, "
        f"top-1={acc1:.1f}%"
    )

    # --- 2b. AOT export: a standalone StableHLO serving artifact ---------
    # (utils/export.py) — the serving process needs only `jax`, not the
    # framework; weights are baked into the program.
    from localregneuralde_tpu.utils.export import (
        export_model,
        load_exported,
        save_exported,
    )

    art = str(Path(ckpt_dir) / "model.stablehlo")
    save_exported(
        export_model(model, ts2.params, ts2.state, xe), art
    )
    serve = load_exported(art)
    y_art = serve(xe)
    y_live, _ = model(ts2.params, ts2.state, xe, training=False)
    assert jnp.allclose(y_art, y_live, rtol=1e-5, atol=1e-5)
    print(
        f"exported artifact: {Path(art).stat().st_size / 1e6:.2f} MB, "
        "serve parity OK"
    )

    # --- 3. multi-device fan-out (when devices are available) ------------
    n_dev = len(jax.devices())
    if n_dev > 1:
        from localregneuralde_tpu.parallel import (
            make_mesh,
            shard_batch,
            shard_train_state,
        )

        mesh = make_mesh({"data": n_dev})
        ts_sh = shard_train_state(ts2, mesh)
        batch_sh = shard_batch((xe, ye), mesh)
        loss_d, st_d = eval_step(ts_sh, batch_sh, 0.0)
        jax.block_until_ready(loss_d)
        t0 = time.perf_counter()
        for _ in range(reps):
            loss_d, st_d = eval_step(ts_sh, batch_sh, 0.0)
        jax.block_until_ready(loss_d)
        dt_d = (time.perf_counter() - t0) / reps
        print(
            f"sharded serving over {n_dev} devices: batch 1024 in "
            f"{dt_d * 1e3:.1f} ms ({1024 / dt_d:,.0f} imgs/s)"
        )


if __name__ == "__main__":
    main()
