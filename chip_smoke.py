#!/usr/bin/env python
"""Bring-up check of the training path on NVIDIA GPUs, in one process.

    python chip_smoke.py          # one card: phases (a)-(e)
    python chip_smoke.py --four   # four cards: phase (a), then the two
                                  # data-parallel modes against one card

Phases (any failure ends the script with a non-zero exit code):

(a) device: JAX's platform, device kind and count, the card's name and
    power limit from ``nvidia-smi``, and the JAX version. Without a GPU the
    script stops here; it never runs on the CPU instead.
(b) families: every shipped experiment config trains a few steps through
    its ``experiments/*/main.py`` entry point at the shipped widths (data
    are the loaders' seeded synthetic stand-ins unless real data are
    present). Prints setup (compile) seconds, steady step seconds, NFE per
    step, the device's peak memory so far and the runner's ``real_data``
    flag; requires a finite loss and NFE and a successful solve.
(c) correctness: seeded flagship weights at full width, the card against
    the CPU of this process, both float32 at precision 'highest': one
    Tsit5 step, the adaptive solve at rtol 1e-4 and one train-step
    gradient, each within a stated tolerance. Then the step and the solves
    at the default precision (TF32 on the card), printed only.
(d) cost of the XLA loop: microseconds per Tsit5 attempt in the forward
    solve and per accepted step in the stored-adjoint sweep, and train-step
    time at one and at eight steps per call.
(e) the ``gpu``-marked tests, run in this process.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from localregneuralde_tpu.core.containers import (  # noqa: E402
    ArrayAndTime,
    get_array,
)
from localregneuralde_tpu.harness.config import define_configuration  # noqa: E402
from localregneuralde_tpu.harness.construct import (  # noqa: E402
    construct_loss,
    construct_model,
    construct_optimizer,
)
from localregneuralde_tpu.harness.data import (  # noqa: E402
    get_classification_data,
    one_hot,
)
from localregneuralde_tpu.harness.train import (  # noqa: E402
    create_train_state,
    make_multi_train_step,
    make_train_step,
)
from localregneuralde_tpu.ode.controller import initial_step_size  # noqa: E402
from localregneuralde_tpu.ode.solve import odesolve  # noqa: E402
from localregneuralde_tpu.ode.step import tsit5_step  # noqa: E402
from localregneuralde_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)
from localregneuralde_tpu.utils.device import (  # noqa: E402
    device_record,
    gpu_query,
    require_gpu,
)

# checkpoints and logs of the phase (b) runs (listed in .gitignore);
# emptied first, so a rerun never resumes an earlier run
RUN_DIR = os.path.join(REPO, ".smoke_runs")
MLP_YAML = os.path.join(REPO, "experiments", "mnist_ode", "mlp.yaml")
# two print windows of STEPS // 2 steps: the first also compiles the
# runner's window accumulator and phase probes, the second is steady
STEPS = 8

# (name, entry script, shipped config, overrides beyond the step count)
FAMILIES = [
    ("mnist_sde", "mnist_sde/main.py", "mnist_sde/mlp.yaml", []),
    ("latent_ode", "physionet/main.py", "physionet/physionet.yaml", []),
    ("cifar_conv", "cifar10/main.py", "cifar10/cnn.yaml", []),
    ("flagship", "mnist_ode/main.py", "mnist_ode/mlp.yaml", []),
    ("flagship_unbiased", "mnist_ode/main.py", "mnist_ode/mlp.yaml",
     ["--model.regularize=unbiased"]),
    # the old benchmark's flagship: unbiased regularization at rtol 1e-4
    ("flagship_rtol1e-4", "mnist_ode/main.py", "mnist_ode/mlp.yaml",
     ["--model.regularize=unbiased", "--model.solver.reltol=1e-4",
      "--model.solver.abstol=1e-4"]),
]

# phase (c) tolerances. Both sides run f32 matmuls at 'highest', so a step
# differs only in summation order: 1e-5 relative. The embedded estimate ũ
# is a cancelling sum that at these weights sits below f32 resolution
# (its f32 and f64 values differ by more than the value itself on the
# CPU), so its rounding is bounded against the terms it cancels,
# dt·max‖k_i‖, not against itself. A solve may flip one accept/reject
# decision near the threshold: one attempt (6 NFE) and 1e-3 relative.
STEP_RTOL = 1e-5
SOLVE_NFE_SLACK = 6
SOLVE_RTOL = 1e-3
GRAD_COSINE = 0.99999


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def peak_bytes(device) -> int:
    return int(device.memory_stats()["peak_bytes_in_use"])


# --------------------------------------------------------------------- (a)


def device_phase(count: int = 1):
    """Print the device fields and the card line; raise without a GPU."""
    devices = require_gpu()
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX sees {len(devices)}")
    d = devices[0]
    say("a", f"platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devices)} jax={jax.__version__}")
    say("a", "nvidia-smi --query-gpu=name,power.limit "
        "--format=csv,noheader:")
    print(gpu_query(), flush=True)
    return devices


# --------------------------------------------------------------------- (b)


def run_entry(script: str, config: str, overrides):
    """Call ``main(config, overrides)`` of an ``experiments/*/main.py``."""
    path = os.path.join(REPO, "experiments", script)
    name = "smoke_" + script.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(os.path.join(REPO, "experiments", config), overrides)


def step_overrides(name: str, steps: int, window: int):
    return [
        f"--train.total_steps={steps}",
        f"--train.print_frequency={window}",
        f"--train.evaluate_every={steps}",
        f"--train.checkpoint_dir={RUN_DIR}/ckpt",
        f"--train.log_dir={RUN_DIR}/logs",
        f"--train.expt_id={name}",
    ]


def train_window_nfe(window: dict) -> float:
    if "nfe" in window:
        return window["nfe"]
    return window["nfe_drift"] + window["nfe_diffusion"]


def family_phase(device, steps: int = STEPS, families=FAMILIES):
    for name, script, config, extra in families:
        summary = run_entry(
            script, config, step_overrides(name, steps, steps // 2) + extra
        )
        w = summary["train_window"]
        nfe = train_window_nfe(w)
        say("b", f"{name}: setup_s={summary['setup_seconds']:.3f} "
            f"step_s={w['step_time']:.6f} nfe_per_step={nfe:.1f} "
            f"net_loss={w['net_loss']:.6f} success={w['success']} "
            f"peak_bytes_in_use={peak_bytes(device)} "
            f"real_data={summary['real_data']}")
        check(w["steps"] == steps // 2, f"{name}: {w['steps']} steps timed")
        check(math.isfinite(w["net_loss"]), f"{name}: finite loss")
        check(math.isfinite(nfe) and nfe > 0, f"{name}: finite NFE")
        check(w["success"], f"{name}: solver success")


# --------------------------------------------------------------------- (c)


def flagship(extra):
    cfg = define_configuration(list(extra), MLP_YAML)
    model = construct_model(cfg)
    params, state = model.init(jax.random.PRNGKey(cfg.seed))
    x, y, *_ = get_classification_data(cfg)
    bs = cfg.dataset.train_batchsize
    data = (jnp.asarray(x[:bs]), jnp.asarray(one_hot(y[:bs], 10)))
    return cfg, model, params, state, data


def dynamics(node, precision):
    """The flagship vector field with every matmul at ``precision``."""

    def f(u, t, p, st):
        with jax.default_matmul_precision(precision):
            y, st = node.model(p["model"], st, ArrayAndTime(u, t),
                               training=True)
        return get_array(y), st

    return f


def correctness_phase(gpu, extra=()):
    cpu = jax.devices("cpu")[0]
    cfg, model, params, state, data = flagship(
        ["--model.regularize=unbiased", "--model.solver.reltol=1e-4",
         "--model.solver.abstol=1e-4", *extra]
    )
    node = model.layers["neural_ode"]
    p_node = params["neural_ode"]
    st_node = state["neural_ode"]["model"]
    u0 = data[0].reshape(data[0].shape[0], -1)

    def step_fn(f):
        def run(p, u, dt):
            k1, _ = f(u, 0.0, p, st_node)
            r = tsit5_step(f, u, 0.0, dt, k1, p, st_node)
            scale = dt * jnp.max(jnp.stack([jnp.linalg.norm(k) for k in r.ks]))
            return r.u_new, r.utilde, scale
        return jax.jit(run)

    def solve_fn(f, tol):
        def run(p, u):
            sol = odesolve(f, u, (0.0, 1.0), p, rtol=tol, atol=tol,
                           max_steps=10000, adjoint="none", stateful=True,
                           f_state=st_node)
            return sol.y_final, sol.nfe, sol.success
        return jax.jit(run)

    on = lambda dev, *xs: jax.device_put(xs, dev)  # noqa: E731
    f_hi = dynamics(node, "highest")
    # the first step's dt, as the solver picks it at rtol 1e-4
    with jax.default_device(cpu):
        k1, _ = f_hi(jax.device_put(u0, cpu), 0.0,
                     jax.device_put(p_node, cpu), st_node)
        dt, _ = initial_step_size(f_hi, jax.device_put(u0, cpu), 0.0,
                                  jax.device_put(p_node, cpu), st_node,
                                  order=5, rtol=1e-4, atol=1e-4, f0=k1)
    dt = float(dt)

    ref_step = step_fn(f_hi)(*on(cpu, p_node, u0), dt)
    ref_solve = solve_fn(f_hi, 1e-4)(*on(cpu, p_node, u0))
    gpu_step = step_fn(f_hi)(*on(gpu, p_node, u0), dt)
    gpu_solve = solve_fn(f_hi, 1e-4)(*on(gpu, p_node, u0))
    step_u = rel(gpu_step[0], ref_step[0])
    step_ut = float(np.linalg.norm(np.asarray(gpu_step[1], np.float64)
                                   - np.asarray(ref_step[1], np.float64))
                    / float(ref_step[2]))
    say("c", f"highest: tsit5 step dt={dt:.6g} u_new rel_err={step_u:.3e} "
        f"utilde err/(dt*max|k|)={step_ut:.3e} "
        f"(utilde rel_err={rel(gpu_step[1], ref_step[1]):.3e})")
    check(step_u <= STEP_RTOL, "step u_new within 1e-5")
    check(step_ut <= STEP_RTOL, "step utilde within 1e-5 of its terms")
    nfe_gpu, nfe_cpu = int(gpu_solve[1]), int(ref_solve[1])
    solve_rel = rel(gpu_solve[0], ref_solve[0])
    say("c", f"highest: solve rtol=1e-4 nfe gpu={nfe_gpu} cpu={nfe_cpu} "
        f"y_final rel_err={solve_rel:.3e} success={bool(gpu_solve[2])}")
    check(abs(nfe_gpu - nfe_cpu) <= SOLVE_NFE_SLACK, "solve NFE within 6")
    check(solve_rel <= SOLVE_RTOL, "solve y_final within 1e-3")
    check(bool(gpu_solve[2]) and bool(ref_solve[2]), "solves succeeded")

    # one train-step gradient (stored adjoint + regularizer + classifier)
    loss_fn, w_reg = construct_loss(cfg)

    def grad_fn(p, st, batch):
        with jax.default_matmul_precision("highest"):
            def obj(p_):
                return loss_fn(model, p_, st, batch, float(w_reg(1)),
                               training=True)[0]
            return jax.value_and_grad(obj)(p)

    grad_fn = jax.jit(grad_fn)
    l_c, g_c = grad_fn(*on(cpu, params, state, data))
    l_g, g_g = grad_fn(*on(gpu, params, state, data))
    vc = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(g_c)])
    vg = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(g_g)])
    cos = float(vc @ vg / (np.linalg.norm(vc) * np.linalg.norm(vg)))
    say("c", f"highest: train-step gradient cosine={cos:.8f} "
        f"loss gpu={float(l_g):.7f} cpu={float(l_c):.7f}")
    check(cos >= GRAD_COSINE, "gradient cosine >= 0.99999")

    # default precision (TF32 on the card): printed, not asserted
    f_def = dynamics(node, None)
    d_step = step_fn(f_def)(*on(gpu, p_node, u0), dt)
    d_ut = float(np.linalg.norm(np.asarray(d_step[1], np.float64)
                                - np.asarray(ref_step[1], np.float64))
                 / float(ref_step[2]))
    say("c", f"default: tsit5 step u_new rel_err={rel(d_step[0], ref_step[0]):.3e} "
        f"utilde err/(dt*max|k|)={d_ut:.3e}")
    for tol in (1e-4, 1.4e-8):
        hi = solve_fn(f_hi, tol)(*on(gpu, p_node, u0))
        de = solve_fn(f_def, tol)(*on(gpu, p_node, u0))
        say("c", f"default vs highest on the card: solve rtol={tol:g} "
            f"nfe default={int(de[1])} highest={int(hi[1])} "
            f"success default={bool(de[2])} highest={bool(hi[2])} "
            f"y_final rel_err={rel(de[0], hi[0]):.3e}")


# --------------------------------------------------------------------- (d)


def timed(fn, *args, reps: int):
    jax.block_until_ready(fn(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def loop_cost_phase(gpu, extra=()):
    cfg, model, params, state, data = flagship(
        ["--model.regularize=unbiased", "--model.solver.reltol=1e-4",
         "--model.solver.abstol=1e-4", *extra]
    )
    node = model.layers["neural_ode"]
    st_node = state["neural_ode"]["model"]
    f = dynamics(node, node.mm_precision)
    u0, p_node = jax.device_put((data[0].reshape(data[0].shape[0], -1),
                                 params["neural_ode"]), gpu)
    solve_kw = dict(rtol=1e-4, atol=1e-4, max_steps=10000, stateful=True,
                    f_state=st_node)

    @jax.jit
    def forward(p, u):
        sol = odesolve(f, u, (0.0, 1.0), p, adjoint="none", **solve_kw)
        return sol.y_final, sol.naccept, sol.nreject

    @jax.jit
    def stored_forward(p, u):
        return odesolve(f, u, (0.0, 1.0), p, adjoint="stored",
                        **solve_kw).y_final

    @jax.jit
    def stored_grad(p, u):
        return jax.grad(lambda p_: jnp.sum(odesolve(
            f, u, (0.0, 1.0), p_, adjoint="stored", **solve_kw
        ).y_final))(p)

    t_fwd, (_, nacc, nrej) = timed(forward, p_node, u0, reps=20)
    attempts = int(nacc) + int(nrej)
    t_sfwd, _ = timed(stored_forward, p_node, u0, reps=20)
    t_grad, _ = timed(stored_grad, p_node, u0, reps=20)
    say("d", f"flagship rtol=1e-4 precision={node.mm_precision or 'default'} "
        f"B={u0.shape[0]} F={u0.shape[1]}: attempts={attempts} "
        f"accepted={int(nacc)}")
    say("d", f"forward solve {t_fwd * 1e6:.1f} us = "
        f"{t_fwd / attempts * 1e6:.2f} us per Tsit5 attempt")
    say("d", f"stored forward {t_sfwd * 1e6:.1f} us, forward+sweep "
        f"{t_grad * 1e6:.1f} us: sweep {(t_grad - t_sfwd) / int(nacc) * 1e6:.2f}"
        " us per accepted step")

    loss_fn, w_reg = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    x, y, *_ = get_classification_data(cfg)
    bs, n = cfg.dataset.train_batchsize, 16
    xs = jnp.asarray(x[: n * bs]).reshape((n, bs) + x.shape[1:])
    ys = jnp.asarray(one_hot(y[: n * bs], 10)).reshape(n, bs, 10)
    xs, ys = jax.device_put((xs, ys), gpu)
    wr, lr = float(w_reg(1)), float(cfg.optimizer.learning_rate)

    step = make_train_step(model, loss_fn, optimizer)
    ts = jax.device_put(create_train_state(model, optimizer,
                                           jax.random.PRNGKey(0)), gpu)
    ts, loss, _ = step(ts, (xs[0], ys[0]), wr, lr)
    jax.block_until_ready(loss)
    nfe1 = []
    t0 = time.perf_counter()
    for i in range(n):
        ts, loss, stats = step(ts, (xs[i], ys[i]), wr, lr)
        nfe1.append(stats["nfe"])
    jax.block_until_ready(loss)
    t_k1 = (time.perf_counter() - t0) / n

    def reduce_fn(loss, stats, data):
        return {"nfe": stats["nfe"].astype(jnp.float32)}

    k = 8
    multi = make_multi_train_step(model, loss_fn, optimizer, reduce_fn)
    ts8 = jax.device_put(create_train_state(model, optimizer,
                                            jax.random.PRNGKey(0)), gpu)
    wk = jnp.full((k,), wr, jnp.float32)
    lk = jnp.full((k,), lr, jnp.float32)
    ts8, loss, _ = multi(ts8, (xs[:k], ys[:k]), wk, lk)
    jax.block_until_ready(loss)
    nfe8 = []
    t0 = time.perf_counter()
    for i in range(0, n, k):
        ts8, loss, red = multi(ts8, (xs[i:i + k], ys[i:i + k]), wk, lk)
        nfe8.append(red["nfe"])
    jax.block_until_ready(loss)
    t_k8 = (time.perf_counter() - t0) / n
    say("d", f"train step K=1: {t_k1 * 1e3:.3f} ms/step "
        f"nfe_per_step={float(np.mean([int(v) for v in nfe1])):.1f}")
    say("d", f"train step K=8: {t_k8 * 1e3:.3f} ms/step "
        f"nfe_per_step={float(np.sum([float(v) for v in nfe8])) / n:.1f}")


# --------------------------------------------------------------------- (e)


def gpu_tests_phase():
    import pytest

    rc = pytest.main([
        "-m", "gpu", "-q", "-p", "no:cacheprovider",
        os.path.join(REPO, "tests"),
    ])
    say("e", f"pytest -m gpu exit code {int(rc)}")
    check(int(rc) == 0, "gpu-marked tests pass")


# ------------------------------------------------------------- --four


# (name, overrides, whether gspmd must reproduce one card's NFE). At the
# shipped rtol 1.4e-8, below float32's epsilon, the error norm of an
# attempt is rounding-sized, so a different summation order (one card's
# 2048-row matmuls against four cards' 512-row ones and a cross-card sum)
# moves accept/reject decisions: the NFE is printed, not compared. At rtol
# 1e-4 the norm sits far above rounding and the shared grid must match.
FOUR_TOLERANCES = [
    ("rtol1.4e-8", [], False),
    ("rtol1e-4", ["--model.solver.reltol=1e-4",
                  "--model.solver.abstol=1e-4"], True),
]


def four_card_phase(devices, steps: int = 1, extra=()):
    """The flagship at a global batch of 2048 (512 per card) under both
    data-parallel modes, against the same global batch on one card, at the
    shipped tolerance and at rtol 1e-4."""
    for tol_name, tol_extra, same_nfe in FOUR_TOLERANCES:
        base = (["--dataset.train_batchsize=2048"] + tol_extra
                + list(extra))
        res = {}
        # shardmap first: each card's memory high-water mark then shows
        # that card ran its own solve
        for mode in ("shardmap", "none", "gspmd"):
            summary = run_entry(
                "mnist_ode/main.py", "mnist_ode/mlp.yaml",
                step_overrides(f"four_{tol_name}_{mode}", steps, steps)
                + base + [f"--train.data_parallel={mode}"],
            )
            w = summary["train_window"]
            res[mode] = w
            say("four", f"{tol_name} data_parallel={mode}: "
                f"nfe={w['nfe']:.2f} net_loss={w['net_loss']:.7f} "
                f"success={w['success']} "
                f"setup_s={summary['setup_seconds']:.3f}")
            check(math.isfinite(w["net_loss"]) and w["success"],
                  f"{tol_name} {mode}: finite loss, solver success")
            if mode == "shardmap":
                peaks = [peak_bytes(d) for d in devices]
                say("four", f"shardmap per-card peak_bytes_in_use={peaks}")
                check(all(p > 0 for p in peaks), "every card ran its solve")
        one, gs, sm = res["none"], res["gspmd"], res["shardmap"]
        gs_rel = abs(gs["net_loss"] - one["net_loss"]) / abs(one["net_loss"])
        sm_rel = abs(sm["net_loss"] - one["net_loss"]) / abs(one["net_loss"])
        say("four", f"{tol_name} gspmd vs one card: nfe {gs['nfe']:.0f} vs "
            f"{one['nfe']:.0f}, loss rel_diff={gs_rel:.3e}")
        say("four", f"{tol_name} shardmap vs one card: mean nfe "
            f"{sm['nfe']:.2f} vs {one['nfe']:.0f}, loss rel_diff={sm_rel:.3e}")
        # gspmd keeps one shared adaptive grid: a loss that differs only by
        # summation order (1e-5 relative). shardmap solves each 512-row
        # shard on its own grid to the same tolerance: 1e-3 relative.
        if same_nfe:
            check(gs["nfe"] == one["nfe"],
                  f"{tol_name}: gspmd NFE equals one card")
        check(gs_rel <= 1e-5, f"{tol_name}: gspmd loss within 1e-5")
        check(sm_rel <= 1e-3, f"{tol_name}: shardmap loss within 1e-3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel comparison")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    devices = device_phase(count=4 if args.four else 1)
    enable_compile_cache()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    phases = (
        [("four", lambda: four_card_phase(devices))] if args.four else [
            ("b", lambda: family_phase(devices[0])),
            ("c", lambda: correctness_phase(devices[0])),
            ("d", lambda: loop_cost_phase(devices[0])),
            ("e", gpu_tests_phase),
        ]
    )
    for name, run in phases:
        t = time.perf_counter()
        run()
        say(name, f"phase done in {time.perf_counter() - t:.1f} s")
    say("all", f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
