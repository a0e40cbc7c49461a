"""Coverage for auxiliary subsystems: orbax checkpoints, warmup, phase
timers, wandb no-op sink, eval-only mode, SDE solution adapters."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from localregneuralde_tpu.harness.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from localregneuralde_tpu.harness.logging import ProgressMeter, AverageMeter, WandbLogger
from localregneuralde_tpu.utils import PhaseTimer


def test_orbax_checkpoint_roundtrip(tmp_path):
    state = {"a": jnp.arange(3), "n": {"b": jnp.ones((2, 2))}, "step": 7}
    save_checkpoint(
        state, fdir=str(tmp_path), fname="s.orbax", backend="orbax",
        is_best=True,
    )
    cur = load_checkpoint(os.path.join(str(tmp_path), "model_current.ckpt"))
    np.testing.assert_array_equal(np.asarray(cur["a"]), np.arange(3))
    best = load_checkpoint(os.path.join(str(tmp_path), "model_best.ckpt"))
    np.testing.assert_allclose(np.asarray(best["n"]["b"]), 1.0)


def test_phase_timer_accumulates():
    t = PhaseTimer()
    x = jnp.ones((8, 8))
    with t.phase("mm", sync=None):
        y = x @ x
    with t.phase("mm", sync=y):
        y = x @ x
    avgs = t.averages()
    assert "mm" in avgs and avgs["mm"] >= 0
    t.reset()
    assert t.averages() == {}


def test_wandb_logger_noop_without_wandb():
    wb = WandbLogger("proj", "run", {"a": 1})
    wb.log({"x": 1.0}, step=1)  # must not raise


def test_progress_meter_prints(capsys):
    m = AverageMeter("loss")
    m.update(2.0)
    m.update(4.0)
    assert m.average == 3.0
    pm = ProgressMeter(100, [m], prefix="train ")
    pm.print(7)
    out = capsys.readouterr().out
    assert "loss" in out and "[  7/100]" in out
    pm.reset()
    assert m.count == 0


def test_eval_only_mode(tmp_path):
    from localregneuralde_tpu.harness import ExperimentConfig
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    cfg = ExperimentConfig()
    cfg.model.model_type = "mlp"
    cfg.model.regularize = "none"
    cfg.model.image_size = [8, 8]
    cfg.model.in_channels = 1
    cfg.model.mlp_hidden_state_size = 8
    cfg.model.solver.abstol = 1e-2
    cfg.model.solver.reltol = 1e-2
    cfg.model.solver.max_steps = 16
    cfg.dataset.eval_batchsize = 64
    cfg.train.evaluate = True
    cfg.train.checkpoint_dir = str(tmp_path / "c")
    cfg.train.log_dir = str(tmp_path / "l")
    out = run_classification_experiment(cfg, "evalonly")
    assert "eval" in out and "accuracy_top1" in out["eval"]


def test_sde_solution_adapters():
    from localregneuralde_tpu.models import (
        diffeqsol_to_array,
        diffeqsol_to_timeseries,
    )
    from localregneuralde_tpu.sde import sdesolve

    sol = sdesolve(
        lambda u, t, p: -u, lambda u, t, p: 0.1 * u,
        jnp.ones((4, 2)), (0.0, 1.0), None,
        noise_key=jax.random.PRNGKey(0), rtol=1e-1, atol=1e-1,
        saveat=jnp.array([0.5, 1.0]), max_steps=64, adjoint="none",
    )
    arr = diffeqsol_to_array(sol)
    assert arr.shape == (4, 2)
    ts = diffeqsol_to_timeseries(sol)
    assert ts.shape == (4, 2, 2)  # (B, T, F)
