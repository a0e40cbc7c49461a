"""Multi-step fused train call (``train.steps_per_call``).

The K-step scanned program (``train.make_multi_train_step``) must reproduce
K sequential single-step calls — same params trajectory, same step counter,
same NFE observables — and the block-mode runner must preserve the
single-step loop's logging/eval cadence and results. An addition
(amortizes per-dispatch host latency); no reference counterpart.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.harness import ExperimentConfig
from localregneuralde_tpu.harness.construct import (
    construct_loss,
    construct_model,
    construct_optimizer,
)
from localregneuralde_tpu.harness.train import (
    create_train_state,
    make_multi_train_step,
    make_train_step,
)


def _tiny_cfg():
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
    cfg.optimizer.scheduler.lr_scheduler = "constant"
    return cfg


def _clone(ts):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x).copy(), ts)


def _batches(k, b=16, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(k, b, 8, 8, 1).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, size=(k, b))]
    return jnp.asarray(xs), jnp.asarray(ys)


def test_multi_step_matches_sequential():
    cfg = _tiny_cfg()
    model = construct_model(cfg)
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)

    K = 4
    xs, ys = _batches(K)
    w_regs = jnp.asarray([0.3, 0.2, 0.1, 0.05], jnp.float32)
    lrs = jnp.asarray([1e-3, 9e-4, 8e-4, 7e-4], jnp.float32)

    ts0 = create_train_state(model, optimizer, jax.random.PRNGKey(0))

    # sequential reference (train_step donates its input — chain clones)
    train_step = make_train_step(model, loss_fn, optimizer)
    ts_seq = _clone(ts0)
    seq_losses, seq_nfes = [], []
    for i in range(K):
        ts_seq, loss, stats = train_step(
            ts_seq, (xs[i], ys[i]), w_regs[i], lrs[i]
        )
        seq_losses.append(float(loss))
        seq_nfes.append(int(stats["nfe"]))

    def reduce_fn(loss, stats, data):
        return {"loss": loss, "nfe": stats["nfe"].astype(jnp.float32)}

    multi_step = make_multi_train_step(
        model, loss_fn, optimizer, reduce_fn=reduce_fn
    )
    ts_blk, last_loss, red = multi_step(_clone(ts0), (xs, ys), w_regs, lrs)

    assert int(ts_blk.step) == int(ts_seq.step) == K
    np.testing.assert_allclose(float(last_loss), seq_losses[-1],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(red["loss"]), sum(seq_losses),
                               rtol=2e-5, atol=1e-6)
    # NFE accounting is integer-exact: identical adaptive accept/reject
    # sequences step for step
    assert float(red["nfe"]) == float(sum(seq_nfes))
    flat_a = jax.tree_util.tree_leaves(ts_seq.params)
    flat_b = jax.tree_util.tree_leaves(ts_blk.params)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-6)


def test_runner_block_mode_matches_single(tmp_path):
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )
    from localregneuralde_tpu.harness.checkpoint import load_checkpoint

    outs = {}
    for spc in (1, 2):
        cfg = _tiny_cfg()
        cfg.train.total_steps = 4
        cfg.train.print_frequency = 2
        cfg.train.evaluate_every = 4
        cfg.train.steps_per_call = spc
        cfg.train.checkpoint_dir = str(tmp_path / f"ckpt{spc}")
        cfg.train.log_dir = str(tmp_path / f"logs{spc}")
        outs[spc] = run_classification_experiment(cfg, f"spc{spc}")
        assert outs[spc]["final_step"] == 4
        assert os.path.exists(
            os.path.join(outs[spc]["log_dir"], "results_train.csv")
        )
        ck = os.path.join(outs[spc]["ckpt_dir"], "model_current.ckpt")
        assert os.path.exists(ck)
        outs[f"params{spc}"] = load_checkpoint(ck)["tstate"].params

    # same seed → same batch sequence → same trajectory (scan-fusion
    # float differences only)
    fa = jax.tree_util.tree_leaves(outs["params1"])
    fb = jax.tree_util.tree_leaves(outs["params2"])
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        outs[1]["best_eval_acc"], outs[2]["best_eval_acc"], atol=1e-3
    )


def test_latent_runner_block_mode(tmp_path):
    from localregneuralde_tpu.harness.latent_runner import (
        run_latent_ode_experiment,
    )

    outs = {}
    for spc in (1, 2):
        cfg = _tiny_cfg()
        cfg.model.model_type = "time_series"
        cfg.model.ts_in_dims = 5
        cfg.model.ts_hidden_dims = 8
        cfg.model.ts_latent_dims = 6
        cfg.model.ts_node_dims = 4
        cfg.dataset.eval_batchsize = 16
        cfg.train.total_steps = 4
        cfg.train.print_frequency = 2
        cfg.train.evaluate_every = 4
        cfg.train.steps_per_call = spc
        cfg.train.checkpoint_dir = str(tmp_path / f"ckpt{spc}")
        cfg.train.log_dir = str(tmp_path / f"logs{spc}")
        outs[spc] = run_latent_ode_experiment(cfg, f"ts_spc{spc}")
        assert np.isfinite(outs[spc]["best_eval_mse"])
    # same seed → same batches AND same Reparameterize rng chain (state
    # is carried through the scan) → matching eval MSE
    np.testing.assert_allclose(
        outs[1]["best_eval_mse"], outs[2]["best_eval_mse"],
        rtol=1e-4, atol=1e-6,
    )


def test_steps_per_call_validation(tmp_path):
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    cfg = _tiny_cfg()
    cfg.train.total_steps = 4
    cfg.train.print_frequency = 2
    cfg.train.evaluate_every = 4
    cfg.train.steps_per_call = 3  # does not divide print_frequency
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.train.log_dir = str(tmp_path / "logs")
    with pytest.raises(ValueError, match="must divide"):
        run_classification_experiment(cfg, "bad_spc")

    cfg2 = _tiny_cfg()
    cfg2.train.steps_per_call = 2
    cfg2.train.print_frequency = 2
    cfg2.train.evaluate_every = 2
    cfg2.train.data_parallel = "shardmap"
    cfg2.train.checkpoint_dir = str(tmp_path / "ckpt2")
    cfg2.train.log_dir = str(tmp_path / "logs2")
    with pytest.raises(ValueError, match="not 'shardmap'"):
        run_classification_experiment(cfg2, "bad_spc_dp")


def test_runner_block_mode_gspmd(tmp_path):
    """steps_per_call composes with GSPMD data parallelism: the scanned
    sharded program reproduces the single-step gspmd trajectory (shared
    global adaptive grid preserved under the scan)."""
    from localregneuralde_tpu.harness.checkpoint import load_checkpoint
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    outs = {}
    for spc in (1, 2):
        cfg = _tiny_cfg()
        cfg.train.total_steps = 4
        cfg.train.print_frequency = 2
        cfg.train.evaluate_every = 4
        cfg.train.steps_per_call = spc
        cfg.train.data_parallel = "gspmd"
        cfg.train.checkpoint_dir = str(tmp_path / f"ckpt{spc}")
        cfg.train.log_dir = str(tmp_path / f"logs{spc}")
        outs[spc] = run_classification_experiment(cfg, f"gspmd_spc{spc}")
        ck = os.path.join(outs[spc]["ckpt_dir"], "model_current.ckpt")
        outs[f"params{spc}"] = load_checkpoint(ck)["tstate"].params

    fa = jax.tree_util.tree_leaves(outs["params1"])
    fb = jax.tree_util.tree_leaves(outs["params2"])
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        outs[1]["best_eval_acc"], outs[2]["best_eval_acc"], atol=1e-3
    )


def test_multi_step_settled_state_required():
    """Models whose layer-state shapes settle on the first call (the
    ReparameterizeLayer's (1,1) mu/logvar placeholders) hard-fail the
    K-step scan carry unless ``settle_state_shapes`` runs first — and
    with it, the K=2 scan matches 2 sequential single steps exactly."""
    from localregneuralde_tpu.harness.construct import construct_time_series
    from localregneuralde_tpu.harness.train import settle_state_shapes

    cfg = ExperimentConfig()
    cfg.model.model_type = "time_series"
    cfg.model.regularize = "unbiased"
    cfg.model.ts_in_dims = 4
    cfg.model.ts_hidden_dims = 8
    cfg.model.ts_latent_dims = 6
    cfg.model.ts_node_dims = 5
    cfg.model.solver.abstol = 1e-2
    cfg.model.solver.reltol = 1e-2
    cfg.model.solver.max_steps = 16
    cfg.model.solver.checkpoint_every = 0
    cfg.optimizer.optimizer = "adamax"

    from localregneuralde_tpu.harness.data import synthetic_physionet

    data, mask, tgrid = synthetic_physionet(
        n=8, t_steps=6, features=4, seed=0
    )
    dt = np.concatenate([tgrid[1:] - tgrid[:-1], [0.0]]).astype("float32")
    dtb = np.broadcast_to(dt[None, :, None], (8, 6, 1)).copy()
    batch = (jnp.asarray(data[:4]), jnp.asarray(mask[:4]),
             jnp.asarray(dtb[:4]))

    model = construct_time_series(cfg, saveat=jnp.asarray(tgrid))
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    w = (10.0, 0.1)
    K = 2
    stack = jax.tree_util.tree_map(
        lambda x: jnp.stack([x] * K), batch
    )
    wK = (jnp.full((K,), w[0], jnp.float32),
          jnp.full((K,), w[1], jnp.float32))
    lrK = jnp.full((K,), 0.01, jnp.float32)

    def reduce_fn(loss, stats, data):
        return {"nfe": stats["nfe"].astype(jnp.float32)}

    # unsettled: the scan carry types mismatch (placeholder vs settled)
    ts0 = create_train_state(model, optimizer, jax.random.PRNGKey(0))
    stepK = make_multi_train_step(model, loss_fn, optimizer, reduce_fn)
    with pytest.raises(TypeError, match="carry"):
        stepK(_clone(ts0), stack, wK, lrK)

    # settled: exact parity with K sequential single steps
    ts_seq = settle_state_shapes(
        model, loss_fn, _clone(ts0), batch, w
    )
    ts_blk = _clone(ts_seq)
    step1 = make_train_step(model, loss_fn, optimizer)
    seq_nfe = 0.0
    for _ in range(K):
        ts_seq, loss_seq, st = step1(ts_seq, batch, w, 0.01)
        seq_nfe += float(st["nfe"])
    ts_blk, loss_blk, red = stepK(ts_blk, stack, wK, lrK)
    assert float(loss_seq) == pytest.approx(float(loss_blk), rel=1e-5)
    assert seq_nfe == float(red["nfe"])
    for a, b in zip(jax.tree_util.tree_leaves(ts_seq.params),
                    jax.tree_util.tree_leaves(ts_blk.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
