"""Latent-ODE (PhysioNet-style) experiment runner.

Reference: ``experiments/physionet/main.jl`` (traced in SURVEY.md §3.4).
Training optimizes masked Gaussian NLL + annealed KL + local regularization;
evaluation reports masked MSE. Data tuples are
``(observed_data, observed_mask, data_to_predict, mask_predicted, dt_obs,
dt_pred)`` with the Δt channel built as forward differences of the
observation grid with a trailing zero (``physionet/main.jl:22-29``).

Documented deviation: the reference tracks the "best" checkpoint with
``loss >= best_test_loss`` (``physionet/main.jl:188``) — an as-is quirk that
marks the *worst* loss as best; here the comparison is ``<=`` (lower masked
MSE is better).
"""
from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from .checkpoint import load_checkpoint, save_checkpoint
from .config import ExperimentConfig, experiment_name, flatten_config
from .construct import construct_loss, construct_optimizer, construct_time_series
from .data import make_dataloader, synthetic_physionet
from .logging import create_logger, get_loggable_values, reset_meters
from .train import create_train_state, make_train_step, settle_state_shapes


def build_physionet_arrays(cfg: ExperimentConfig):
    """Load PhysioNet-like arrays: real artifact (physionet.npz with keys
    observed_data/observed_mask/data_to_predict/mask_predicted_data/
    observed_tp/tp_to_predict, feature-major) if present under data_root,
    else the synthetic latent-oscillator stand-in. Returns batch-major
    (data, mask, dt) train/test splits + the 49-point saveat grid."""
    root = cfg.dataset.data_root
    npz_path = os.path.join(root, "physionet.npz") if root else ""
    if npz_path and os.path.exists(npz_path):
        d = np.load(npz_path)
        # feature-major (F, T, N) → batch-major (N, T, F)
        data = np.transpose(d["observed_data"], (2, 1, 0)).astype(np.float32)
        mask = np.transpose(d["observed_mask"], (2, 1, 0)).astype(np.float32)
        tp = d["observed_tp"].astype(np.float32)  # (T, N)
        tgrid = tp[:, 0]
        real = True
    else:
        data, mask, tgrid = synthetic_physionet(
            n=2048, t_steps=49, features=cfg.model.ts_in_dims, seed=cfg.seed,
            difficulty=getattr(cfg.dataset, "difficulty", "easy"),
        )
        real = False

    # Δt channel: forward differences with trailing zero
    dt = np.concatenate([tgrid[1:] - tgrid[:-1], [0.0]]).astype(np.float32)
    dt = np.broadcast_to(dt[None, :, None], (data.shape[0], data.shape[1], 1))
    dt = np.ascontiguousarray(dt)

    n = data.shape[0]
    n_train = int(0.8 * n)
    rng = np.random.RandomState(cfg.seed)
    idx = rng.permutation(n)
    tr, te = idx[:n_train], idx[n_train:]
    train = (data[tr], mask[tr], dt[tr])
    test = (data[te], mask[te], dt[te])
    return train, test, tgrid, real


def run_latent_ode_experiment(
    cfg: ExperimentConfig, config_name: str = "physionet"
) -> dict:
    t_setup = time.perf_counter()
    name = experiment_name(cfg, config_name)
    ckpt_dir = os.path.join(cfg.train.checkpoint_dir, cfg.train.expt_subdir, name)
    log_dir = os.path.join(cfg.train.log_dir, cfg.train.expt_subdir, name)
    if jax.process_count() > 1 and jax.process_index() != 0:
        # multi-process mode: non-primary processes write checkpoints/logs under
        # their own subdirectory (same layout as the classification
        # runner — every process saves the same gathered global state)
        sub = f"proc{jax.process_index()}"
        ckpt_dir = os.path.join(ckpt_dir, sub)
        log_dir = os.path.join(log_dir, sub)

    train_arrays, test_arrays, tgrid, is_real = build_physionet_arrays(cfg)
    model = construct_time_series(cfg, saveat=jnp.asarray(tgrid))
    loss_fn, (w_reg_sched, w_kl_sched) = construct_loss(cfg)
    optimizer, lr_sched = construct_optimizer(cfg)

    ts = create_train_state(model, optimizer, jax.random.PRNGKey(cfg.seed))
    # Settle first-call-dependent state shapes (ReparameterizeLayer's (1,1)
    # mu/logvar placeholders become (B, latent)) BEFORE the donated train
    # step first traces — otherwise the step is guaranteed one recompile.
    bsz = cfg.dataset.train_batchsize
    settle_batch = tuple(jnp.asarray(a[:bsz]) for a in train_arrays)
    ts = settle_state_shapes(
        model, loss_fn, ts, settle_batch,
        (float(w_reg_sched(1)), float(w_kl_sched(1))),
    )
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
    ed = float(cfg.train.ema_decay)
    if not 0.0 <= ed < 1.0:
        raise ValueError(f"train.ema_decay must be in [0, 1), got {ed}")
    train_step = make_train_step(model, loss_fn, optimizer,
                                 grad_accumulation=ga, ema_decay=ed)

    @jax.jit
    def eval_forward(params, state, data, mask, dt):
        x = jnp.concatenate([data, mask, dt], axis=-1)
        y, st_ = model(params, state, x, training=False)
        mse = jnp.sum(
            jnp.sum(jnp.square((y - data) * mask), axis=(1, 2))
            / jnp.sum(mask, axis=(1, 2))
        ) / data.shape[0]
        return mse, st_["neural_ode"]["nfe"]

    initial_step = 1
    restored_best = None
    resume_path = cfg.train.resume or os.path.join(ckpt_dir, "model_current.ckpt")
    if os.path.exists(resume_path):
        restored = load_checkpoint(resume_path)
        if restored is not None:
            ts = jax.tree_util.tree_map(jnp.asarray, restored["tstate"])
            initial_step = int(restored["step"]) + 1
            restored_best = restored.get("best")

    # loader AFTER resume: skip_batches fast-forwards the seeded stream so
    # a resumed run consumes the exact batch sequence of an uninterrupted
    # run (same contract as the classification runner)
    train_loader = make_dataloader(
        train_arrays, cfg.dataset.train_batchsize, shuffle=True, cycle=True,
        seed=cfg.seed, skip_batches=initial_step - 1,
    )

    if ed > 0.0 and ts.ema is None:
        from .train import init_ema

        ts = init_ema(ts)

    # optional multi-chip training (same wiring as the classification
    # runner; after resume so restored host arrays get sharded).
    # settled=True: this runner already ran settle_state_shapes above.
    from .runner import _wire_data_parallel

    if jax.process_count() > 1 and cfg.train.data_parallel == "shardmap":
        raise ValueError(
            "latent multi-process mode supports train.data_parallel='gspmd' only "
            "(shardmap + multi-process is unverified for this runner; "
            "see docs/MIGRATION.md)"
        )
    # check_eval_divisibility=False: this runner clamps eval_batchsize to
    # the test split and rounds it to the data-parallel degree below
    train_step, ts, place_batch, make_block, place_repl = _wire_data_parallel(
        cfg, model, loss_fn, optimizer, train_step, ts, settle_batch,
        (float(w_reg_sched(1)), float(w_kl_sched(1))), settled=True,
        check_eval_divisibility=False,
    )

    # effective eval batch size: clamped to the test split (with drop_last
    # an oversized eval_batchsize would yield ZERO batches — hit with the
    # shipped physionet.yaml eval_batchsize=512 on the 409-sample synthetic
    # test split); under multi-process training additionally rounded DOWN
    # to the data-parallel degree so eval batches satisfy the global-shard
    # divisibility contract (they are globally sharded via place_batch)
    n_test = int(test_arrays[0].shape[0])
    eval_bs = min(int(cfg.dataset.eval_batchsize), n_test)
    if jax.process_count() > 1:
        n_data = jax.device_count() // max(1, int(cfg.train.tensor_parallel))
        rounded = eval_bs - eval_bs % n_data
        if rounded == 0:
            raise ValueError(
                f"test split ({n_test} samples) is smaller than the "
                f"data-parallel degree {n_data}; multi-process latent eval "
                "needs at least one full global batch"
            )
        if rounded != eval_bs:
            # with drop_last a single-process run ALSO skips its tail
            # partial batch (n_test % eval_bs samples), so report the
            # pod-vs-single DELTA, not the absolute skip
            skipped_pod = n_test % rounded
            skipped_single = n_test % eval_bs
            print(
                f"[latent eval] eval batch rounded {eval_bs} -> {rounded} "
                f"for data-parallel degree {n_data}; "
                f"{skipped_pod} of {n_test} test samples skipped per eval "
                f"pass ({skipped_pod - skipped_single:+d} vs a "
                "single-process run)",
                flush=True,
            )
        eval_bs = rounded

    loggers = create_logger(
        log_dir, cfg.train.total_steps, latent_ode=True, expt_name=name,
        config=flatten_config(cfg),
    )
    tm = loggers["train_meters"]

    # device-side window accumulator: ONE host sync per print window (the
    # same hygiene as the classification runner)
    stat_keys = ["net_loss", "neg_log_likelihood", "kl_div", "reg_val", "nfe"]

    @jax.jit
    def window_update(acc, loss, stats):
        vals = {
            "net_loss": loss,
            "neg_log_likelihood": stats["neg_log_likelihood"],
            "kl_div": stats["kl_div"],
            "reg_val": stats["reg_val"],
            "nfe": stats["nfe"].astype(jnp.float32),
        }
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

    from .train import make_phase_probes

    measure_phases = make_phase_probes(model, loss_fn, optimizer)
    # the last print window's means, surfaced in the summary
    last_window: dict = {}

    def print_window(step, sums, n, ok, window_wall, data_time_sum, bs,
                     batch, w, ts):
        for k in stat_keys:
            tm[k].update(float(sums[k]) / n, n * bs)
        t_fwd, t_fwdbwd = measure_phases(ts, batch, w)
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
                "within this window",
                flush=True,
            )
        row = get_loggable_values(tm, loggers["train_header"], step)
        loggers["csv_train"].log(row)
        loggers["wandb"].log(
            dict(zip(loggers["train_header"], row)), step=step
        )
        print(
            f"[{step}/{cfg.train.total_steps}] "
            + " ".join(
                f"{k}={tm[k].average:.4f}"
                for k in loggers["train_header"][1:]
            ),
            flush=True,
        )
        reset_meters(tm)

    best_test_loss = (
        np.inf if restored_best is None else float(restored_best)
    )
    final_eval_mse, final_eval_nfe = np.inf, 0.0  # last eval, for summary
    data_iter = iter(train_loader)

    # --- optional K-steps-per-dispatch block loop (train.steps_per_call;
    # same semantics/validation as the classification runner; 0 = auto)
    from .runner import resolve_steps_per_call

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
                f"evaluate_every ({cfg.train.evaluate_every})"
            )

    if spc == 1:
        # compile the train step before the loop (reference
        # utils.jl:126-137), so setup time and step time stay apart
        from .train import warmup_model

        warmup_model(
            train_step, None, ts, place_batch(settle_batch),
            (float(w_reg_sched(1)), float(w_kl_sched(1))),
            float(lr_sched(1)),
        )
    setup_seconds = time.perf_counter() - t_setup

    if spc > 1:
        def latent_reduce(loss, stats, data):
            ok = stats.get("solver_success", jnp.asarray(True))
            return {
                "net_loss": loss,
                "neg_log_likelihood": stats["neg_log_likelihood"],
                "kl_div": stats["kl_div"],
                "reg_val": stats["reg_val"],
                "nfe": stats["nfe"].astype(jnp.float32),
                "n_fail": 1.0 - ok.astype(jnp.float32),
            }

        multi_step, place_block = make_block(latent_reduce)

        from .data import prefetch_to_device

        def _host_stacks():
            s = initial_step - 1
            while s < cfg.train.total_steps:
                bk = min(spc - (s % spc), cfg.train.total_steps - s)
                host = [next(data_iter) for _ in range(bk)]
                stacked = tuple(
                    np.stack([b[i] for b in host]) for i in range(3)
                )
                s += bk
                yield bk, stacked

        dev_stacks = prefetch_to_device(
            _host_stacks(), lambda it: (it[0], place_block(it[1])),
            size=int(cfg.train.device_prefetch),
        )

        pending = []
        window_n = 0
        data_time_sum = 0.0
        t_window = time.perf_counter()
        step = initial_step - 1
        while step < cfg.train.total_steps:
            t0 = time.perf_counter()
            bk, batch_stack = next(dev_stacks)
            data_time_sum += time.perf_counter() - t0
            srange = range(step + 1, step + bk + 1)
            w_regs = (
                np.asarray([w_reg_sched(s) for s in srange], np.float32),
                np.asarray([w_kl_sched(s) for s in srange], np.float32),
            )
            lrs = np.asarray([lr_sched(s) for s in srange], np.float32)
            ts, _, red = multi_step(ts, batch_stack, w_regs, lrs)
            pending.append(red)
            window_n += bk
            step += bk
            w = (float(w_regs[0][-1]), float(w_regs[1][-1]))

            if step % cfg.train.print_frequency == 0:
                reds = jax.device_get(pending)
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
                    int(jax.tree_util.tree_leaves(
                        batch_stack)[0].shape[1]),
                    last_batch, w, ts,
                )
                window_n = 0
                data_time_sum = 0.0
                t_window = time.perf_counter()

            if (step % cfg.train.evaluate_every == 0
                    or step == cfg.train.total_steps):
                best_test_loss, final_eval_mse, final_eval_nfe = (
                    _latent_eval_ckpt(
                        cfg, eval_forward, ts, test_arrays, step,
                        best_test_loss, loggers, ckpt_dir, eval_bs,
                        place_batch,
                    )
                )

        return {
            "best_eval_mse": float(best_test_loss),
            "final_eval_mse": float(final_eval_mse),
            "final_eval_nfe": float(final_eval_nfe),
            "train_window": dict(last_window),
            "setup_seconds": setup_seconds,
            "real_data": bool(is_real),
            "ckpt_dir": ckpt_dir,
            "log_dir": log_dir,
            "steps_per_call": spc,
        }

    acc = zero_acc()
    data_time_sum = 0.0
    t_window = time.perf_counter()
    # device-resident prefetch (train.device_prefetch; see the
    # classification runner): async H2D overlaps the running step
    from .data import prefetch_to_device

    dev_iter = prefetch_to_device(
        data_iter, place_batch, size=int(cfg.train.device_prefetch)
    )
    for step in range(initial_step, cfg.train.total_steps + 1):
        t0 = time.perf_counter()
        batch = next(dev_iter)
        data_time_sum += time.perf_counter() - t0

        w = (float(w_reg_sched(step)), float(w_kl_sched(step)))
        lr = float(lr_sched(step))
        ts, loss, stats = train_step(ts, batch, w, lr)
        acc = window_update(acc, loss, stats)
        bs = int(batch[0].shape[0])

        if step % cfg.train.print_frequency == 0:
            wv = jax.device_get(acc)  # the window's single host sync
            n = max(int(wv["n"]), 1)
            print_window(
                step, wv["sums"], n, bool(wv["ok"]),
                time.perf_counter() - t_window, data_time_sum, bs,
                batch, w, ts,
            )
            acc = zero_acc()
            data_time_sum = 0.0
            t_window = time.perf_counter()

        if step % cfg.train.evaluate_every == 0 or step == cfg.train.total_steps:
            best_test_loss, final_eval_mse, final_eval_nfe = _latent_eval_ckpt(
                cfg, eval_forward, ts, test_arrays, step, best_test_loss,
                loggers, ckpt_dir, eval_bs, place_batch,
            )

    return {
        "best_eval_mse": float(best_test_loss),
        "final_eval_mse": float(final_eval_mse),
        "final_eval_nfe": float(final_eval_nfe),
        "train_window": dict(last_window),
        "setup_seconds": setup_seconds,
        "real_data": bool(is_real),
        "ckpt_dir": ckpt_dir,
        "log_dir": log_dir,
    }


def _latent_eval_ckpt(cfg, eval_forward, ts, test_arrays, step,
                      best_test_loss, loggers, ckpt_dir, eval_bs,
                      place_batch):
    """Masked-MSE evaluation over the test split + best/current
    checkpointing; returns the updated best loss. ``eval_bs`` is the
    caller-validated effective batch size (clamped to the split; a
    multiple of the data-parallel degree under multi-process training);
    eval batches go through ``place_batch`` so they are globally sharded
    on a mesh when one is configured."""
    mses, nfes, count = 0.0, 0.0, 0
    eval_loader = make_dataloader(test_arrays, eval_bs, drop_last=True)
    # with EMA enabled, evaluation + best selection see the averaged
    # weights (train.ema_decay)
    eval_params = ts.params if ts.ema is None else ts.ema
    for host_batch in eval_loader:
        xe, me, dte = place_batch(host_batch)
        mse, nfe = eval_forward(eval_params, ts.state, xe, me, dte)
        bs = host_batch[0].shape[0]
        mses += float(mse) * bs
        nfes += float(nfe) * bs
        count += bs
    eval_mse = mses / count
    print(
        f"[eval @ {step}] masked_mse={eval_mse:.5f} "
        f"nfe={nfes / count:.1f}",
        flush=True,
    )
    loggers["wandb"].log({"eval_masked_mse": eval_mse}, step=step)

    is_best = eval_mse <= best_test_loss
    best_test_loss = min(best_test_loss, eval_mse)
    # gather_to_host == device_get single-process; under multi-process it
    # all-gathers batch-sharded leaves so every process saves full state
    from ..parallel.multihost import gather_to_host

    save_checkpoint(
        {"tstate": gather_to_host(ts), "step": step,
         "best": float(best_test_loss)},
        fdir=ckpt_dir, fname=f"model_step_{step}.ckpt",
        is_best=is_best,
    )
    return best_test_loss, eval_mse, nfes / count
