#!/usr/bin/env python
"""Benchmark: Neural-DE training throughput on one NVIDIA GPU.

Headline: the flagship MNIST MLP Neural-ODE config (batch 512, hidden 100,
unbiased error-estimate regularization) trained with the fused jitted step. Because the adaptive step count drifts as
parameters evolve, the headline metric is **dynamics evaluations per
second** (NFE/s) through full training steps — forward solve + reverse
through the solver + reg step + Adam — which normalizes throughput against
NFE drift.

Each trial times N_ITERS steps with one host readback as the barrier;
the value is the median over N_TRIALS trials, and ``trial_band`` gives
their range.

Also measured (extra fields on the same JSON line):
- ``sde_evals_per_sec``: the MNIST-SDE flagship (NeuralDSDE SOSRI,
  tol 1.4e-1, batch 512) — drift+diffusion evals/s through full train
  steps.
- ``paper_tol_nfe_per_sec``: the reference's EXACT tolerance (1.4e-8,
  'highest' matmul precision, maxiters 10k) on the two-level stored
  adjoint.

Prints ONE JSON line: {"metric", "value", "unit", "device", "card", ...}.
It refuses to run without a GPU. The reference publishes no numbers
(BASELINE.md), so there is no baseline to divide by yet.
"""
import json
import statistics
import time

import jax
import jax.numpy as jnp

N_TRIALS = 10
N_ITERS = 40


def _run_training_bench(train_step, ts, make_batch, w_reg, n_trials,
                        n_iters, nfe_of):
    # warmup / compile
    ts, loss, stats = train_step(ts, make_batch(0), w_reg, 1e-3)
    loss.block_until_ready()
    rates = []
    it = 1
    for _ in range(n_trials):
        nfes = []
        t0 = time.perf_counter()
        for _ in range(n_iters):
            ts, loss, stats = train_step(ts, make_batch(it), w_reg, 1e-3)
            nfes.append(nfe_of(stats))  # stays on device; no per-iter sync
            it += 1
        _ = float(loss)  # host readback barrier
        elapsed = time.perf_counter() - t0
        total_nfe = int(jnp.sum(jnp.stack(nfes)))
        rates.append(total_nfe / elapsed)
    return statistics.median(rates), rates


def _batch_maker(batch, image_shape, n_distinct=8):
    """Pregenerated pool of device-resident batches, cycled per trial, so
    the timed loop moves no data from the host."""
    import numpy as np

    rng = np.random.RandomState(17)
    pool = []
    for _ in range(n_distinct):
        x = jnp.asarray(
            rng.rand(batch, *image_shape).astype("float32")
        )
        y = jnp.eye(10, dtype=jnp.float32)[
            jnp.asarray(rng.randint(0, 10, size=batch))
        ]
        pool.append((x, y))

    def make(i):
        return pool[(i // N_ITERS) % n_distinct]

    return make


def _flagship_ode(rtol, max_steps):
    from localregneuralde_tpu.harness.losses import logitcrossentropy
    from localregneuralde_tpu.models import (
        NeuralODE,
        TDChain,
        diffeqsol_to_array,
    )
    from localregneuralde_tpu.nn import Chain, Dense, Flatten, WrappedFunction

    F, H = 784, 100
    td = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    node = NeuralODE(
        td, regularize="unbiased", rtol=rtol, atol=rtol,
        max_steps=max_steps, checkpoint_every=0,
    )
    model = Chain(
        flatten=Flatten(),
        neural_ode=node,
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(F, 10),
    )

    def loss_fn(model, params, state, data, w_reg, *, training=True):
        x, y = data
        y_pred, st_ = model(params, state, x, training=training)
        ce = logitcrossentropy(y_pred, y)
        node_st = st_["neural_ode"]
        return ce + w_reg * node_st["reg_val"], st_, {
            "nfe": node_st["nfe"], "ce": ce,
        }

    return model, loss_fn, lambda stats: stats["nfe"]


def _flagship_sde():
    from localregneuralde_tpu.harness.losses import logitcrossentropy
    from localregneuralde_tpu.models import diffeqsol_to_array
    from localregneuralde_tpu.models.neural_sde import NeuralDSDE
    from localregneuralde_tpu.nn import Chain, Dense, Flatten, WrappedFunction

    node = NeuralDSDE(
        Chain(Dense(32, 64, "tanh"), Dense(64, 32)), Dense(32, 32),
        regularize="none", rtol=1.4e-1, atol=1.4e-1, max_steps=10000,
        solver="sosri",
    )
    model = Chain(
        flatten=Flatten(),
        downsample=Dense(784, 32),
        neural_dsde=node,
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(32, 10),
    )

    def loss_fn(model, params, state, data, w_reg, *, training=True):
        x, y = data
        y_pred, st_ = model(params, state, x, training=training)
        ce = logitcrossentropy(y_pred, y)
        st_n = st_["neural_dsde"]
        return ce, st_, {
            "nfe": st_n["nfe_drift"] + st_n["nfe_diffusion"], "ce": ce,
        }

    return model, loss_fn, lambda stats: stats["nfe"]


def _make_opt_and_state(model):
    from localregneuralde_tpu.harness.config import ExperimentConfig
    from localregneuralde_tpu.harness.construct import construct_optimizer
    from localregneuralde_tpu.harness.train import create_train_state

    cfg = ExperimentConfig()
    cfg.optimizer.optimizer = "adam"
    cfg.optimizer.learning_rate = 1e-3
    cfg.optimizer.scheduler.lr_scheduler = "constant"
    optimizer, _ = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    return optimizer, ts


def _bench(model, loss_fn, nfe_of, n_trials=N_TRIALS, n_iters=N_ITERS):
    from localregneuralde_tpu.harness.train import make_train_step

    optimizer, ts = _make_opt_and_state(model)
    train_step = make_train_step(model, loss_fn, optimizer)
    return _run_training_bench(
        train_step, ts, _batch_maker(512, (28, 28, 1)), 1.0, n_trials,
        n_iters, nfe_of,
    )


def _bench_multi(model, loss_fn, nfe_of, K=8, n_trials=N_TRIALS,
                 n_iters=N_ITERS):
    """Same training arithmetic, dispatched K steps per donated-jit call
    via ``train.steps_per_call`` (``make_multi_train_step``); per-window
    NFE reduces in-kernel so nothing ships per step."""
    from localregneuralde_tpu.harness.train import make_multi_train_step

    assert n_iters % K == 0
    optimizer, ts = _make_opt_and_state(model)

    def reduce_fn(loss, stats, data):
        return {"nfe": nfe_of(stats).astype(jnp.float32)}

    stepK = make_multi_train_step(model, loss_fn, optimizer, reduce_fn)
    make_batch = _batch_maker(512, (28, 28, 1))
    stacks = [
        (
            jnp.stack([make_batch(j * N_ITERS)[0] for j in range(s, s + K)]),
            jnp.stack([make_batch(j * N_ITERS)[1] for j in range(s, s + K)]),
        )
        for s in range(8)
    ]
    jax.block_until_ready(stacks)
    wK = jnp.full((K,), 1.0, jnp.float32)
    lrK = jnp.full((K,), 1e-3, jnp.float32)

    ts, loss, red = stepK(ts, stacks[0], wK, lrK)  # compile
    loss.block_until_ready()
    rates = []
    it = 1
    for _ in range(n_trials):
        nfes = []
        t0 = time.perf_counter()
        for _ in range(n_iters // K):
            ts, loss, red = stepK(ts, stacks[it % 8], wK, lrK)
            nfes.append(red["nfe"])  # in-kernel K-step sum, stays on device
            it += 1
        _ = float(loss)  # host readback barrier
        elapsed = time.perf_counter() - t0
        total_nfe = float(jnp.sum(jnp.stack(nfes)))
        rates.append(total_nfe / elapsed)
    return statistics.median(rates), rates


def _latent_bench(n_trials, n_iters):
    """PhysioNet-config latent-ODE train steps (tol 1.4e-8, maxiters 10k,
    B=512, adamax); returns dynamics evals/s."""
    import numpy as np

    from localregneuralde_tpu.harness.config import ExperimentConfig
    from localregneuralde_tpu.harness.construct import (
        construct_loss,
        construct_optimizer,
        construct_time_series,
    )
    from localregneuralde_tpu.harness.data import synthetic_physionet
    from localregneuralde_tpu.harness.train import (
        create_train_state,
        make_train_step,
    )

    cfg = ExperimentConfig()
    cfg.model.model_type = "time_series"
    cfg.model.regularize = "unbiased"
    cfg.model.solver.abstol = 1.4e-8
    cfg.model.solver.reltol = 1.4e-8
    cfg.model.solver.max_steps = 10000
    cfg.model.solver.checkpoint_every = 0
    cfg.model.solver.adjoint = "stored"
    cfg.loss.w_reg_start = 100.0
    cfg.loss.w_reg_end = 10.0
    cfg.optimizer.optimizer = "adamax"
    cfg.optimizer.learning_rate = 0.01

    data, mask, tgrid = synthetic_physionet(
        n=2048, t_steps=49, features=37, seed=0
    )
    dt = np.concatenate([tgrid[1:] - tgrid[:-1], [0.0]]).astype("float32")
    dtb = np.broadcast_to(dt[None, :, None], (2048, 49, 1)).copy()

    model = construct_time_series(cfg, saveat=jnp.asarray(tgrid))
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    step = make_train_step(model, loss_fn, optimizer)

    batches = []
    rng = np.random.RandomState(11)
    for _ in range(8):
        idx = rng.randint(0, 2048, 512)
        batches.append((
            jnp.asarray(data[idx]), jnp.asarray(mask[idx]),
            jnp.asarray(dtb[idx]),
        ))

    ts, loss, st = step(ts, batches[0], (100.0, 0.1), 0.01)
    loss.block_until_ready()
    rates = []
    it = 1
    for _ in range(n_trials):
        nfes = []
        t0 = time.perf_counter()
        for _ in range(n_iters):
            ts, loss, st = step(ts, batches[it % 8], (100.0, 0.1), 0.01)
            nfes.append(st["nfe"])
            it += 1
        _ = float(loss)
        rates.append(int(jnp.sum(jnp.stack(nfes))) /
                     (time.perf_counter() - t0))
    single = statistics.median(rates)

    # K=8 steps/call dispatch mode (the better of the two modes is
    # reported, as for the headline); w_reg is the latent (w_reg, w_kl)
    # tuple — scanned as a pytree with a leading K axis.
    try:
        from localregneuralde_tpu.harness.train import (
            make_multi_train_step,
            settle_state_shapes,
        )

        K = 8
        ts2 = create_train_state(model, optimizer, jax.random.PRNGKey(0))
        # the ReparameterizeLayer state holds (1,1) placeholders until the
        # first call; the K-step scan needs settled carry shapes
        ts2 = settle_state_shapes(model, loss_fn, ts2, batches[0],
                                  (100.0, 0.1))

        def reduce_fn(loss, stats, data):
            return {"nfe": stats["nfe"].astype(jnp.float32)}

        stepK = make_multi_train_step(model, loss_fn, optimizer, reduce_fn)
        stacks = [
            jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs),
                *[batches[(s + j) % 8] for j in range(K)],
            )
            for s in range(8)
        ]
        jax.block_until_ready(stacks)
        wK = (jnp.full((K,), 100.0, jnp.float32),
              jnp.full((K,), 0.1, jnp.float32))
        lrK = jnp.full((K,), 0.01, jnp.float32)
        ts2, loss, red = stepK(ts2, stacks[0], wK, lrK)
        loss.block_until_ready()
        rates_m = []
        it = 1
        for _ in range(n_trials):
            nfes = []
            t0 = time.perf_counter()
            for _ in range(max(1, n_iters // K) * 2):
                ts2, loss, red = stepK(ts2, stacks[it % 8], wK, lrK)
                nfes.append(red["nfe"])
                it += 1
            _ = float(loss)
            rates_m.append(float(jnp.sum(jnp.stack(nfes))) /
                           (time.perf_counter() - t0))
        return max(single, statistics.median(rates_m))
    except Exception:
        import sys
        import traceback

        traceback.print_exc(file=sys.stderr)
        return single


def _conv_bench(n_trials=4, n_iters=12):
    """CIFAR-10 conv-family train steps at the shipped cnn.yaml semantics
    (reference experiments/cifar10/cnn.yml: batch 32, tol 1e-4, maxiters
    10k, checkpoint_every 1) on the cuDNN conv chain + stored adjoint.
    Returns dynamics evals/s through full train steps."""
    import numpy as np

    from localregneuralde_tpu.harness.config import ExperimentConfig
    from localregneuralde_tpu.harness.construct import (
        construct_loss,
        construct_model,
        construct_optimizer,
    )
    from localregneuralde_tpu.harness.train import (
        create_train_state,
        make_train_step,
    )

    cfg = ExperimentConfig()
    cfg.model.model_type = "cifar10_cnn"
    cfg.model.image_size = [32, 32]
    cfg.model.in_channels = 3
    cfg.model.num_classes = 10
    cfg.model.regularize = "unbiased"
    cfg.model.solver.abstol = 1e-4
    cfg.model.solver.reltol = 1e-4
    cfg.model.solver.max_steps = 10000
    cfg.model.solver.checkpoint_every = 1
    cfg.loss.w_reg_start = 2.5
    cfg.loss.w_reg_end = 2.5
    cfg.optimizer.optimizer = "adam"
    cfg.optimizer.learning_rate = 0.003
    cfg.optimizer.scheduler.lr_scheduler = "constant"

    model = construct_model(cfg)
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    step = make_train_step(model, loss_fn, optimizer)

    rng = np.random.RandomState(23)
    pool = []
    for _ in range(8):
        x = jnp.asarray(rng.rand(32, 32, 32, 3).astype("float32"))
        y = jnp.eye(10, dtype=jnp.float32)[
            jnp.asarray(rng.randint(0, 10, size=32))
        ]
        pool.append((x, y))
    jax.block_until_ready(pool)

    ts, loss, st = step(ts, pool[0], 2.5, 3e-3)
    loss.block_until_ready()
    rates = []
    it = 1
    for _ in range(n_trials):
        nfes = []
        t0 = time.perf_counter()
        for _ in range(n_iters):
            ts, loss, st = step(ts, pool[it % 8], 2.5, 3e-3)
            nfes.append(st["nfe"])
            it += 1
        _ = float(loss)  # host readback barrier
        rates.append(int(jnp.sum(jnp.stack(nfes))) /
                     (time.perf_counter() - t0))
    return statistics.median(rates)


def main():
    from localregneuralde_tpu.utils.compile_cache import enable_compile_cache
    from localregneuralde_tpu.utils.device import (
        device_record,
        gpu_query,
        require_gpu,
    )

    devices = require_gpu()
    enable_compile_cache()

    # ---- headline: flagship ODE at rtol 1e-4.
    # Two dispatch modes of the SAME training arithmetic: per-step calls
    # and K=8 steps/call (train.steps_per_call); headline = the better.
    model, loss_fn, nfe_of = _flagship_ode(1e-4, 64)
    single_rate, rates = _bench(model, loss_fn, nfe_of)
    try:
        multi_rate, rates_m = _bench_multi(model, loss_fn, nfe_of)
    except Exception:
        import sys
        import traceback

        traceback.print_exc(file=sys.stderr)
        multi_rate, rates_m = None, None
    if multi_rate is not None and multi_rate > single_rate:
        nfe_per_sec, rates = multi_rate, rates_m
    else:
        nfe_per_sec = single_rate

    # ---- SDE flagship, both dispatch modes as for the headline
    try:
        m2, l2, n2 = _flagship_sde()
        sde_rate, _ = _bench(m2, l2, n2, n_trials=4, n_iters=30)
        try:
            sde_multi, _ = _bench_multi(m2, l2, n2, n_trials=4, n_iters=32)
        except Exception:
            sde_multi = None
        if sde_multi is not None:
            sde_rate = max(sde_rate, sde_multi)
    except Exception:
        import sys
        import traceback

        traceback.print_exc(file=sys.stderr)
        sde_rate = None

    # ---- the reference's exact tolerance (1.4e-8, maxiters 10k,
    # 'highest' precision) on the two-level stored adjoint
    try:
        m3, l3, n3 = _flagship_ode(1.4e-8, 10000)
        paper_rate, _ = _bench(m3, l3, n3, n_trials=3, n_iters=10)
        try:
            paper_multi, _ = _bench_multi(m3, l3, n3, n_trials=3, n_iters=16)
        except Exception:
            paper_multi = None
        if paper_multi is not None:
            paper_rate = max(paper_rate, paper_multi)
    except Exception:
        import sys
        import traceback

        traceback.print_exc(file=sys.stderr)
        paper_rate = None

    # ---- latent-ODE (PhysioNet paper config): dynamics evals/s through
    # full train steps
    try:
        latent_rate = _latent_bench(n_trials=3, n_iters=10)
    except Exception:
        import sys
        import traceback

        traceback.print_exc(file=sys.stderr)
        latent_rate = None

    # ---- CIFAR conv family (cnn.yaml semantics, cuDNN conv chain)
    try:
        conv_rate = _conv_bench()
    except Exception:
        import sys
        import traceback

        traceback.print_exc(file=sys.stderr)
        conv_rate = None

    out = {
        "metric": "mnist_node_train_nfe_per_sec",
        "value": nfe_per_sec,
        "unit": "dynamics evals/s (through full train steps)",
        "device": device_record(devices),
        "card": gpu_query(),
        "trial_band": [min(rates), max(rates)],
        "single_dispatch_nfe_per_sec": single_rate,
    }
    if multi_rate is not None:
        out["k8_dispatch_nfe_per_sec"] = multi_rate
    if sde_rate is not None:
        out["sde_evals_per_sec"] = sde_rate
    if paper_rate is not None:
        out["paper_tol_nfe_per_sec"] = paper_rate
    if latent_rate is not None:
        out["latent_nfe_per_sec"] = latent_rate
    if conv_rate is not None:
        out["conv_nfe_per_sec"] = conv_rate
    print(json.dumps(out))


if __name__ == "__main__":
    main()
