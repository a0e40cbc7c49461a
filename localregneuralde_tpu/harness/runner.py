"""Shared experiment runner: the canonical training loop.

Reference: ``experiments/mnist_ode/main.jl`` (traced in SURVEY.md §3.2/§3.5)
— startup (config → model/loss/optimizer → warmup → dataloaders → checkpoint
resume → loggers) followed by the step loop with periodic console/CSV/wandb
logging, evaluation, and best/current checkpointing. The same loop serves
MNIST-ODE, MNIST-SDE, and CIFAR-10 (the reference duplicates it per script;
here it is factored once).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .checkpoint import load_checkpoint, save_checkpoint
from .config import ExperimentConfig, experiment_name, flatten_config
from .construct import construct_loss, construct_model, construct_optimizer
from .data import get_classification_data, make_dataloader, one_hot
from .logging import create_logger, get_loggable_values, reset_meters
from .losses import accuracy
from .train import (
    TrainState,
    create_train_state,
    init_ema,
    make_eval_step,
    make_train_step,
    swap_ema_params,
)


def _wire_data_parallel(cfg, model, loss_fn, optimizer, train_step, ts,
                        warmup_batch, w_reg0, *, settled=False,
                        check_eval_divisibility=True):
    """Swap the single-device train step for a multi-chip one per
    ``cfg.train.data_parallel`` ('none' | 'gspmd' | 'shardmap') and place
    the train state on the mesh. Returns
    ``(train_step, ts, place_batch, make_block, place_repl)`` where
    ``place_batch`` devices a host batch — sharded over the mesh's data
    axis, or plain device arrays when single-device — ``make_block(
    reduce_fn)`` builds the K-steps-per-dispatch program for
    ``train.steps_per_call``: ``(multi_step, place_block)`` with
    ``place_block`` devicing a K-stacked batch (batch axis sharded under
    gspmd), and ``place_repl`` makes host values global replicated
    arrays (identity single-process; needed so loop-carried accumulators
    can enter a jit next to mesh-placed state under multi-process).
    ``make_block`` is ``None`` for 'shardmap' (unsupported). Runs AFTER
    checkpoint resume so restored host arrays get (re)sharded. Pass
    ``settled=True`` if ``settle_state_shapes`` already ran on ``ts``.

    **Multi-process mode**: when ``jax.process_count() > 1`` (the
    entry point called ``parallel.multihost.initialize`` before touching
    the backend), the mesh spans all processes' devices; the train state
    is placed via ``multihost.place_train_state`` and each process
    contributes only its contiguous row slice of every (identical,
    seed-deterministic) host batch via ``multihost.global_batch``."""
    dp_mode = cfg.train.data_parallel
    if dp_mode not in ("none", "gspmd", "shardmap"):
        raise ValueError(
            "train.data_parallel must be 'none', 'gspmd' or 'shardmap', "
            f"got {dp_mode!r}"
        )
    tp = int(cfg.train.tensor_parallel)
    if tp < 1:
        raise ValueError(f"train.tensor_parallel must be >= 1, got {tp}")
    n_proc = jax.process_count()
    if dp_mode == "none":
        if tp != 1:
            raise ValueError(
                "train.tensor_parallel > 1 requires data_parallel='gspmd'"
            )
        if n_proc > 1:
            raise ValueError(
                f"{n_proc} jax processes require data_parallel='gspmd' "
                "or 'shardmap' (with 'none' every process would train an "
                "independent duplicate)"
            )

        def make_block(reduce_fn):
            from .train import make_multi_train_step

            return (
                make_multi_train_step(
                    model, loss_fn, optimizer, reduce_fn=reduce_fn,
                    grad_accumulation=max(
                        1, int(cfg.train.grad_accumulation)
                    ),
                    ema_decay=float(cfg.train.ema_decay),
                ),
                lambda b: jax.tree_util.tree_map(jnp.asarray, b),
            )

        return train_step, ts, (
            lambda b: jax.tree_util.tree_map(jnp.asarray, b)
        ), make_block, (lambda t: t)

    from ..parallel import (
        make_mesh,
        make_shardmap_train_step,
        make_sharded_train_step,
        shard_batch,
        shard_train_state,
        sharding_rules_for_mlp_tp,
    )
    from .train import settle_state_shapes

    n_dev = len(jax.devices())
    if dp_mode == "shardmap" and tp != 1:
        raise ValueError(
            "train.tensor_parallel > 1 requires data_parallel='gspmd' "
            "(the shardmap mode is data-parallel only)"
        )
    if n_dev % tp:
        raise ValueError(
            f"tensor_parallel={tp} does not divide the {n_dev} devices"
        )
    n_data = n_dev // tp
    if cfg.dataset.train_batchsize % n_data:
        raise ValueError(
            f"dataset.train_batchsize={cfg.dataset.train_batchsize} must "
            f"be divisible by the data-parallel degree {n_data}"
        )
    if (check_eval_divisibility and n_proc > 1
            and cfg.dataset.eval_batchsize % n_data):
        # the latent runner opts out: it clamps eval_batchsize to the test
        # split and rounds it to n_data itself (latent_runner.py eval_bs)
        raise ValueError(
            f"dataset.eval_batchsize={cfg.dataset.eval_batchsize} must be "
            f"divisible by the data-parallel degree {n_data} under "
            "multi-process training (eval batches are globally sharded)"
        )

    # settle first-call state shapes at the GLOBAL batch before tracing
    # the parallel step (required by the shardmap classifier; avoids one
    # guaranteed recompile under gspmd)
    if not settled:
        ts = settle_state_shapes(model, loss_fn, ts, warmup_batch, w_reg0)

    make_block = None
    ed = float(cfg.train.ema_decay)

    # --- batch/stack/replicated placement, single- vs multi-process ----
    if n_proc > 1:
        from ..parallel import multihost

        _rows = {}

        def _slice(gb):
            if gb not in _rows:
                _rows[gb] = multihost.process_batch_slice(mesh, gb)
            return _rows[gb]

        def place_batch(b):
            gb = jax.tree_util.tree_leaves(b)[0].shape[0]
            local = jax.tree_util.tree_map(
                lambda a: np.asarray(a)[_slice(gb)], b
            )
            return multihost.global_batch(local, mesh, gb)

        def place_stack(b):
            gb = jax.tree_util.tree_leaves(b)[0].shape[1]
            local = jax.tree_util.tree_map(
                lambda a: np.asarray(a)[:, _slice(gb)], b
            )
            return multihost.global_batch_stack(local, mesh, gb)

        def place_repl(t):
            return multihost.place_replicated(t, mesh)

        def place_state(ts, shardings=None, rules=None):
            return multihost.place_train_state(
                ts, mesh, rules, shardings=shardings
            )
    else:
        def place_batch(b):
            # non-divisible batches (e.g. an eval_batchsize that doesn't
            # split over the data axis) stay plain device arrays — the
            # jitted step reshards them; explicit P(data) placement would
            # reject the uneven split
            if jax.tree_util.tree_leaves(b)[0].shape[0] % n_data:
                return jax.tree_util.tree_map(jnp.asarray, b)
            return shard_batch(b, mesh)

        def place_stack(b):
            from ..parallel import shard_batch_stack

            return shard_batch_stack(b, mesh)

        def place_repl(t):
            return t

        def place_state(ts, shardings=None, rules=None):
            return shard_train_state(ts, mesh, rules, shardings=shardings)

    if dp_mode == "gspmd":
        from ..parallel import train_state_shardings

        axes = {"data": n_data}
        rules = None
        if tp > 1:
            axes["model"] = tp
            rules = sharding_rules_for_mlp_tp()
        mesh = make_mesh(axes)
        ga = max(1, int(cfg.train.grad_accumulation))
        ts_sh = train_state_shardings(ts, mesh, rules)
        ts = place_state(ts, shardings=ts_sh)
        step = make_sharded_train_step(
            model, loss_fn, optimizer, mesh, rules=rules,
            ts_shardings=ts_sh, ema_decay=ed, grad_accumulation=ga,
        )

        def make_block(reduce_fn):
            from ..parallel import make_sharded_multi_train_step

            return (
                make_sharded_multi_train_step(
                    model, loss_fn, optimizer, mesh, rules=rules,
                    ts_shardings=ts_sh, reduce_fn=reduce_fn, ema_decay=ed,
                    grad_accumulation=ga,
                ),
                place_stack,
            )
    else:
        mesh = make_mesh({"data": n_data})
        ts = place_state(ts)
        step = make_shardmap_train_step(model, loss_fn, optimizer, mesh,
                                        ema_decay=ed)
    print(
        f"data_parallel={dp_mode}: mesh "
        f"{dict(zip(mesh.axis_names, mesh.devices.shape))} over "
        f"{n_dev} devices"
        + (f" across {n_proc} processes" if n_proc > 1 else ""),
        flush=True,
    )
    return step, ts, place_batch, make_block, place_repl


def resolve_steps_per_call(spc) -> int:
    """Resolve ``train.steps_per_call``: 0 = auto, which is K = 1 on every
    backend until a measured rule replaces it (``chip_smoke.py`` phase (d)
    times K = 1 against K = 8 on the GPU)."""
    return max(1, int(spc))


def run_classification_experiment(
    cfg: ExperimentConfig,
    config_name: str = "run",
    *,
    normalize: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_steps_override: Optional[int] = None,
) -> dict:
    """Train a classification neural DE per config; returns summary metrics."""
    t_setup = time.perf_counter()
    name = experiment_name(cfg, config_name)
    ckpt_dir = os.path.join(cfg.train.checkpoint_dir, cfg.train.expt_subdir, name)
    log_dir = os.path.join(cfg.train.log_dir, cfg.train.expt_subdir, name)
    if jax.process_count() > 1 and jax.process_index() != 0:
        # multi-process mode: non-primary processes write checkpoints/logs to their
        # own subdirectory — the primary's layout stays canonical, and on
        # a shared filesystem nothing clobbers (every process saves the
        # same gathered global state, so per-process resume is exact)
        sub = f"proc{jax.process_index()}"
        ckpt_dir = os.path.join(ckpt_dir, sub)
        log_dir = os.path.join(log_dir, sub)

    model = construct_model(cfg)
    loss_fn, w_reg_sched = construct_loss(cfg)
    optimizer, lr_sched = construct_optimizer(cfg)

    key = jax.random.PRNGKey(cfg.seed)
    ts = create_train_state(model, optimizer, key)

    # train.grad_accumulation=N: N sequential microbatches per optimizer
    # update inside the fused step (validated before any compilation).
    ga = max(1, int(cfg.train.grad_accumulation))
    if ga > 1:
        if cfg.train.data_parallel == "shardmap":
            raise ValueError(
                "train.grad_accumulation > 1 supports data_parallel="
                "'none' or 'gspmd' (not 'shardmap')"
            )
        if cfg.dataset.train_batchsize % ga:
            raise ValueError(
                f"train.grad_accumulation={ga} must divide "
                f"dataset.train_batchsize ({cfg.dataset.train_batchsize})"
            )

    # train.ema_decay>0: params-EMA maintained inside the fused step;
    # eval/best-checkpoint use the averaged weights.
    ed = float(cfg.train.ema_decay)
    if not 0.0 <= ed < 1.0:
        raise ValueError(f"train.ema_decay must be in [0, 1), got {ed}")

    train_step = make_train_step(model, loss_fn, optimizer,
                                 grad_accumulation=ga, ema_decay=ed)
    eval_step = make_eval_step(model, loss_fn)

    # --- data
    x_train, y_train, x_test, y_test, is_real = get_classification_data(cfg)
    if normalize is not None:
        x_train = normalize(x_train)
        x_test = normalize(x_test)
    nc = cfg.model.num_classes
    eval_loader_spec = (x_test, one_hot(y_test, nc))

    # --- checkpoint resume (reference main.jl:57-72)
    initial_step = 1
    restored_best = None
    resume_path = cfg.train.resume or os.path.join(ckpt_dir, "model_current.ckpt")
    if os.path.exists(resume_path):
        restored = load_checkpoint(resume_path)
        if restored is not None:
            ts = jax.tree_util.tree_map(jnp.asarray, restored["tstate"])
            initial_step = int(restored["step"]) + 1
            restored_best = restored.get("best")
            print(f"resumed from {resume_path} at step {initial_step}")

    # train loader AFTER resume: skip_batches fast-forwards the seeded
    # stream (index-only) so a resumed run consumes the exact batch
    # sequence the uninterrupted run would have from initial_step — with
    # the restored `best` marker this makes kill/resume trajectory-exact
    train_loader = make_dataloader(
        (x_train, one_hot(y_train, nc)),
        cfg.dataset.train_batchsize,
        shuffle=True,
        cycle=True,
        seed=cfg.seed,
        skip_batches=initial_step - 1,
    )

    if ed > 0.0 and ts.ema is None:
        # fresh start, or resume from a pre-EMA checkpoint: seed at params
        ts = init_ema(ts)

    # eval-only mode (reference TrainConfig.evaluate)
    if cfg.train.evaluate:
        metrics = evaluate_classification(
            cfg, eval_step, swap_ema_params(ts), eval_loader_spec,
            float(w_reg_sched(1)),
        )
        print(f"[evaluate] {metrics}", flush=True)
        return {"eval": metrics, "real_data": bool(is_real)}

    xw = jnp.asarray(x_train[: cfg.dataset.train_batchsize])
    yw = jnp.asarray(one_hot(y_train[: cfg.dataset.train_batchsize], nc))

    # --- optional multi-device training (additive over the reference) ---
    # train.data_parallel: 'gspmd' shards the batch over a device mesh
    # with the reference-exact shared GLOBAL adaptive grid (+ optional
    # tensor parallelism over the dynamics layers); 'shardmap' runs one
    # COMPLETE per-shard solve per device (one pmean/step; documented
    # estimator deviation).
    train_step, ts, place_batch, make_block, place_repl = (
        _wire_data_parallel(
            cfg, model, loss_fn, optimizer, train_step, ts,
            (xw, yw), float(w_reg_sched(1)),
        )
    )

    # --- optional multi-step fused train call: train.steps_per_call=K
    # scans K optimizer steps inside ONE donated jit per host dispatch
    # (train.make_multi_train_step). Validated here so a bad config fails
    # before any compilation.
    spc = resolve_steps_per_call(cfg.train.steps_per_call)
    if spc > 1:
        if cfg.train.data_parallel == "shardmap":
            raise ValueError(
                "train.steps_per_call > 1 supports data_parallel="
                "'none' or 'gspmd' (not 'shardmap')"
            )
        if (cfg.train.print_frequency % spc
                or cfg.train.evaluate_every % spc):
            raise ValueError(
                f"train.steps_per_call={spc} must divide both "
                f"print_frequency ({cfg.train.print_frequency}) and "
                f"evaluate_every ({cfg.train.evaluate_every}) so the "
                "logging/eval cadence is preserved exactly"
            )

    # warmup: trigger XLA compilation before timing starts
    # (reference utils.jl:126-137). In block mode the single-step train
    # program is never used — _run_block_loop warms the scanned K-step
    # program instead (skipping a wasted full compile of the 1-step one).
    from .train import warmup_model

    warmup_model(
        train_step if spc == 1 else None, eval_step, ts,
        place_batch((xw, yw)),
        float(w_reg_sched(1)), float(lr_sched(1)),
    )
    setup_seconds = time.perf_counter() - t_setup

    total_steps = max_steps_override or cfg.train.total_steps
    loggers = create_logger(
        log_dir,
        total_steps,
        sde=cfg.model.sde,
        expt_name=name,
        config=flatten_config(cfg),
    )
    tm = loggers["train_meters"]

    best_eval_acc = -np.inf if restored_best is None else float(restored_best)
    data_iter = iter(train_loader)

    # --- device-side window accumulator: ONE host sync per print window
    # (a per-step float() would stall the host on every step)
    sde = cfg.model.sde
    stat_keys = (
        ["net_loss", "ce_loss", "reg_val", "accuracy_top1", "accuracy_top5"]
        + (["nfe_drift", "nfe_diffusion"] if sde else ["nfe"])
    )

    @jax.jit
    def window_update(acc, loss, stats, yb):
        a1, a5 = accuracy(stats["y_pred"], yb, (1, 5))
        vals = {
            "net_loss": loss,
            "ce_loss": stats["ce_loss"],
            "reg_val": stats["reg_val"],
            "accuracy_top1": a1,
            "accuracy_top5": a5,
        }
        if sde:
            vals["nfe_drift"] = stats["nfe"][0].astype(jnp.float32)
            vals["nfe_diffusion"] = stats["nfe"][1].astype(jnp.float32)
        else:
            vals["nfe"] = stats["nfe"].astype(jnp.float32)
        return {
            "sums": {k: acc["sums"][k] + vals[k] for k in stat_keys},
            "n": acc["n"] + 1,
            "ok": acc["ok"] & stats.get("solver_success", jnp.asarray(True)),
        }

    def zero_acc():
        # place_repl: under multi-process training the loop-carried
        # accumulator must be a global (replicated) array to enter the
        # window_update jit alongside mesh-placed state
        return place_repl({
            "sums": {k: jnp.zeros(()) for k in stat_keys},
            "n": jnp.zeros((), jnp.int32),
            "ok": jnp.asarray(True),
        })

    # per-phase parity probes (fwd/bwd/opt columns), run once per window
    from .train import make_phase_probes

    measure_phases = make_phase_probes(model, loss_fn, optimizer)
    # the last print window's means, surfaced in the summary
    last_window: dict = {}

    def print_window(step, sums, n, ok, window_wall, data_time_sum, bs,
                     batch, w_reg, ts):
        for k in stat_keys:
            tm[k].update(float(sums[k]) / n, n * bs)
        t_fwd, t_fwdbwd = measure_phases(ts, batch, w_reg)
        step_time = window_wall / n
        last_window.clear()
        last_window.update({k: float(sums[k]) / n for k in stat_keys})
        last_window.update(step_time=step_time, steps=n, success=bool(ok))
        tm["batch_time"].update(window_wall / n, n)
        tm["data_time"].update(data_time_sum / n, n)
        tm["step_time"].update(step_time, n)
        tm["fwd_time"].update(t_fwd, n)
        tm["bwd_time"].update(max(t_fwdbwd - t_fwd, 0.0), n)
        tm["opt_time"].update(max(step_time - t_fwdbwd, 0.0), n)
        if not ok:
            print(
                f"WARNING [{step}]: adaptive solve exhausted max_steps "
                "within this window (integration truncated; raise "
                "solver.max_steps or loosen tolerances)",
                flush=True,
            )
        row = get_loggable_values(tm, loggers["train_header"], step)
        loggers["csv_train"].log(row)
        loggers["wandb"].log(
            dict(zip(loggers["train_header"], row)), step=step
        )
        print(
            f"[{step}/{total_steps}] "
            + " ".join(
                f"{k}={tm[k].average:.4f}"
                for k in loggers["train_header"][1:]
            ),
            flush=True,
        )
        reset_meters(tm)

    final_eval: dict = {}  # last eval_metrics, surfaced in the summary

    def eval_and_checkpoint(step, w_reg, ts):
        nonlocal best_eval_acc
        # with EMA enabled, evaluation + best-checkpoint selection see the
        # averaged weights (train.ema_decay; the raw params keep training)
        eval_metrics = evaluate_classification(
            cfg, eval_step, swap_ema_params(ts), eval_loader_spec, w_reg,
            place_batch=place_batch,
        )
        em = loggers["eval_meters"]
        for k, v in eval_metrics.items():
            if k in em:
                em[k].update(v)
        row = get_loggable_values(em, loggers["eval_header"], step)
        loggers["csv_eval"].log(row)
        loggers["wandb"].log(
            {f"eval_{k}": v for k, v in eval_metrics.items()}, step=step
        )
        print(f"[eval @ {step}] {eval_metrics}", flush=True)
        reset_meters(em)
        final_eval.clear()
        final_eval.update({k: float(v) for k, v in eval_metrics.items()})

        is_best = eval_metrics["accuracy_top1"] >= best_eval_acc
        best_eval_acc = max(best_eval_acc, eval_metrics["accuracy_top1"])
        # gather_to_host == device_get single-process; under multi-process
        # it all-gathers batch-sharded state leaves so every process saves
        # the full global state
        from ..parallel.multihost import gather_to_host

        save_checkpoint(
            # "best": the running best-eval marker, so a resumed run keeps
            # best-checkpoint selection exact (absent in pre-round-5
            # checkpoints; resume treats that as -inf, the old behavior)
            {"tstate": gather_to_host(ts), "step": step,
             "best": float(best_eval_acc)},
            fdir=ckpt_dir,
            fname=f"model_step_{step}.ckpt",
            is_best=is_best,
        )

    if spc > 1:
        summary = _run_block_loop(
            cfg, make_block, spc, ts, data_iter,
            (xw, yw), w_reg_sched, lr_sched, initial_step, total_steps,
            stat_keys, print_window, eval_and_checkpoint,
            lambda: best_eval_acc, is_real, ckpt_dir, log_dir,
        )
        summary["final_eval"] = dict(final_eval)
        summary["train_window"] = dict(last_window)
        summary["setup_seconds"] = setup_seconds
        return summary

    acc = zero_acc()
    data_time_sum = 0.0
    t_window = time.perf_counter()
    # device-resident prefetch (train.device_prefetch): batches are placed
    # on device `dp` ahead so the async H2D of batch k+1 overlaps the
    # running step k; next(dev_iter) time measures the residual STALL, the
    # honest data_time under overlap
    from .data import prefetch_to_device

    dev_iter = prefetch_to_device(
        data_iter, place_batch, size=int(cfg.train.device_prefetch)
    )
    for step in range(initial_step, total_steps + 1):
        t0 = time.perf_counter()
        batch = next(dev_iter)
        data_time_sum += time.perf_counter() - t0

        w_reg = float(w_reg_sched(step))
        lr = float(lr_sched(step))
        yb_dev = batch[1]
        ts, loss, stats = train_step(ts, batch, w_reg, lr)
        acc = window_update(acc, loss, stats, yb_dev)
        bs = int(yb_dev.shape[0])

        if step % cfg.train.print_frequency == 0:
            w = jax.device_get(acc)  # the window's single host sync
            n = max(int(w["n"]), 1)
            print_window(
                step, w["sums"], n, bool(w["ok"]),
                time.perf_counter() - t_window, data_time_sum, bs,
                batch, w_reg, ts,
            )
            acc = zero_acc()
            data_time_sum = 0.0
            t_window = time.perf_counter()

        if step % cfg.train.evaluate_every == 0 or step == total_steps:
            eval_and_checkpoint(step, w_reg, ts)

    return {
        "best_eval_acc": float(best_eval_acc),
        "final_eval": dict(final_eval),
        "train_window": dict(last_window),
        "setup_seconds": setup_seconds,
        "final_step": total_steps,
        "real_data": bool(is_real),
        "ckpt_dir": ckpt_dir,
        "log_dir": log_dir,
    }


def _run_block_loop(cfg, make_block, spc, ts, data_iter,
                    warmup_batch, w_reg_sched, lr_sched,
                    initial_step, total_steps, stat_keys, print_window,
                    eval_and_checkpoint, get_best, is_real, ckpt_dir,
                    log_dir):
    """The K-steps-per-dispatch variant of the training loop
    (``train.steps_per_call`` > 1): each iteration feeds K stacked batches
    + per-step (w_reg, lr) arrays to the scanned multi-step program and
    gets back per-window stat SUMS (reduced in-kernel — no per-step stats
    traffic). Because K divides print_frequency and evaluate_every
    (validated by the caller), logging/eval/checkpoint fire at exactly the
    same step numbers as the single-step loop."""
    from .train import make_multi_train_step

    sde = cfg.model.sde

    def window_reduce(loss, stats, data):
        a1, a5 = accuracy(stats["y_pred"], data[1], (1, 5))
        vals = {
            "net_loss": loss,
            "ce_loss": stats["ce_loss"],
            "reg_val": stats["reg_val"],
            "accuracy_top1": a1,
            "accuracy_top5": a5,
        }
        if sde:
            vals["nfe_drift"] = stats["nfe"][0].astype(jnp.float32)
            vals["nfe_diffusion"] = stats["nfe"][1].astype(jnp.float32)
        else:
            vals["nfe"] = stats["nfe"].astype(jnp.float32)
        ok = stats.get("solver_success", jnp.asarray(True))
        vals["n_fail"] = 1.0 - ok.astype(jnp.float32)
        return vals

    multi_step, place_block = make_block(window_reduce)

    def stack_host(batches):
        return tuple(
            np.stack([b[i] for b in batches]) for i in range(2)
        )

    # warmup: compile the K-step program on K copies of the warmup batch
    xw, yw = warmup_batch
    wstack = place_block((
        np.broadcast_to(np.asarray(xw), (spc,) + xw.shape).copy(),
        np.broadcast_to(np.asarray(yw), (spc,) + yw.shape).copy(),
    ))
    wr0 = np.full((spc,), float(w_reg_sched(1)), np.float32)
    lr0 = np.full((spc,), float(lr_sched(1)), np.float32)
    import copy as _copy

    ts_copy = jax.tree_util.tree_map(
        lambda x: x.copy() if hasattr(x, "copy") else _copy.copy(x), ts
    )
    _, wl, _ = multi_step(ts_copy, wstack, wr0, lr0)
    wl.block_until_ready()
    del ts_copy

    # device-resident prefetch (train.device_prefetch): whole K-stacks are
    # placed ahead so the (large) stacked-batch H2D overlaps the running
    # K-step program; next(dev_stacks) measures the residual stall
    from .data import prefetch_to_device

    def _host_stacks():
        s = initial_step - 1
        while s < total_steps:
            # realign to the spc grid (a resume can land off-grid) so the
            # print/eval boundaries — multiples of spc — are always hit
            bk = min(spc - (s % spc), total_steps - s)
            stack = stack_host([next(data_iter) for _ in range(bk)])
            s += bk
            yield bk, stack

    dev_stacks = prefetch_to_device(
        _host_stacks(), lambda it: (it[0], place_block(it[1])),
        size=int(cfg.train.device_prefetch),
    )

    pending = []  # device-side per-block stat sums, synced once per window
    window_n = 0
    data_time_sum = 0.0
    t_window = time.perf_counter()
    step = initial_step - 1
    while step < total_steps:
        t0 = time.perf_counter()
        bk, batch_stack = next(dev_stacks)
        data_time_sum += time.perf_counter() - t0
        steps = range(step + 1, step + bk + 1)
        w_regs = np.asarray([w_reg_sched(s) for s in steps], np.float32)
        lrs = np.asarray([lr_sched(s) for s in steps], np.float32)
        ts, _, red = multi_step(ts, batch_stack, w_regs, lrs)
        pending.append(red)
        window_n += bk
        step += bk
        w_reg = float(w_regs[-1])

        if step % cfg.train.print_frequency == 0:
            reds = jax.device_get(pending)  # the window's single host sync
            pending = []
            sums = {
                k: sum(float(r[k]) for r in reds) for k in stat_keys
            }
            n_fail = sum(float(r["n_fail"]) for r in reds)
            last_batch = jax.tree_util.tree_map(
                lambda x: x[-1], batch_stack
            )
            print_window(
                step, sums, max(window_n, 1), n_fail == 0.0,
                time.perf_counter() - t_window, data_time_sum,
                int(jax.tree_util.tree_leaves(batch_stack)[0].shape[1]),
                last_batch, w_reg, ts,
            )
            window_n = 0
            data_time_sum = 0.0
            t_window = time.perf_counter()

        if step % cfg.train.evaluate_every == 0 or step == total_steps:
            eval_and_checkpoint(step, w_reg, ts)

    return {
        "best_eval_acc": float(get_best()),
        "final_step": total_steps,
        "real_data": bool(is_real),
        "ckpt_dir": ckpt_dir,
        "log_dir": log_dir,
        "steps_per_call": spc,
    }


def evaluate_classification(cfg, eval_step, ts: TrainState, data, w_reg,
                            place_batch=None):
    x_test, y_test = data
    # clamp to the split: with drop_last an eval_batchsize larger than the
    # test set would yield ZERO batches (empty metrics) — hit with the
    # shipped eval_batchsize=512 on small real-data artifacts (the latent
    # runner has the same clamp)
    eval_bs = min(int(cfg.dataset.eval_batchsize), int(x_test.shape[0]))
    if jax.process_count() > 1 and cfg.train.data_parallel != "none":
        # the clamp can violate the data-parallel divisibility contract
        # that _wire_data_parallel validated against the UNCLAMPED config
        # (small real-data test splits under multi-process mode): round DOWN to the
        # data-parallel degree like the latent runner, and fail clearly
        # when the split is smaller than the degree
        n_data = len(jax.devices()) // max(1, int(cfg.train.tensor_parallel))
        rounded = eval_bs - eval_bs % n_data
        if rounded == 0:
            raise ValueError(
                f"test split ({int(x_test.shape[0])} samples) is smaller "
                f"than the data-parallel degree {n_data}; multi-process "
                "eval needs at least one full global batch"
            )
        if rounded != eval_bs:
            print(
                f"[eval] eval batch rounded {eval_bs} -> {rounded} for "
                f"data-parallel degree {n_data} (globally sharded eval "
                "batches must split over the data axis)",
                flush=True,
            )
        eval_bs = rounded
    loader = make_dataloader((x_test, y_test), eval_bs, drop_last=True)
    if place_batch is None:
        def place_batch(b):
            return jax.tree_util.tree_map(jnp.asarray, b)
    # accumulate per-batch metrics ON DEVICE; one host sync at the end
    # (same hygiene as the train loop)
    device_rows = []
    count = 0
    for xb, yb in loader:
        xb_dev, yb_dev = place_batch((xb, yb))
        loss, stats = eval_step(ts, (xb_dev, yb_dev), w_reg)
        acc1, acc5 = accuracy(stats["y_pred"], yb_dev, (1, 5))
        bs = xb.shape[0]
        count += bs
        row = {
            "ce_loss": stats["ce_loss"],
            "reg_val": stats["reg_val"],
            "net_loss": loss,
            "accuracy_top1": acc1,
            "accuracy_top5": acc5,
        }
        if cfg.model.sde:
            row["nfe_drift"] = stats["nfe"][0]
            row["nfe_diffusion"] = stats["nfe"][1]
        else:
            row["nfe"] = stats["nfe"]
        device_rows.append((bs, row))
    totals: dict = {}
    rows = jax.device_get(device_rows)  # the single host sync
    for bs, row in rows:
        for k, v in row.items():
            totals[k] = totals.get(k, 0.0) + float(v) * bs
    return {k: v / count for k, v in totals.items()}
