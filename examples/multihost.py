"""Multi-process training demo.

On several hosts, run ONE copy of this script per host, naming the
coordinator, the process count and this process's id, and the
classification runner trains one model over every device of every host:

    python examples/multihost.py experiments/mnist_ode/mlp.yaml \
        --train.data_parallel=gspmd \
        --coordinator=host0:12345 --num-processes=2 --process-id=0

For a laptop/CI demonstration, `--demo` self-launches TWO local
processes × 2 virtual CPU devices each (Gloo collectives over localhost)
and trains a tiny config over the 4-device process-spanning mesh — the
same code path several hosts take (this mirrors
``tests/test_multihost.py``). The demo workers pin the CPU, so no two
processes ever open the same GPU.

What multi-process mode does differently (all automatic once
``initialize`` ran):

- the mesh spans all processes' devices (``make_mesh`` uses the global
  ``jax.devices()``);
- every process feeds only its contiguous row slice of each
  (seed-deterministic) batch — assembled into one global DP-sharded
  array, XLA routes the gradient psum within and across hosts;
- eval batches are globally sharded; checkpoints save the all-gathered
  global state (non-primary processes under ``proc{i}/``).
"""
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _demo_worker(proc: int, port: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from localregneuralde_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=proc,
    )

    from localregneuralde_tpu.harness import define_configuration
    from localregneuralde_tpu.harness.runner import (
        run_classification_experiment,
    )

    cfg = define_configuration(
        [
            "--model.regularize=unbiased",
            "--model.mlp_hidden_state_size=16",
            "--model.solver.abstol=1e-2",
            "--model.solver.reltol=1e-2",
            "--model.solver.max_steps=16",
            "--model.solver.checkpoint_every=4",
            "--dataset.train_batchsize=16",
            "--dataset.eval_batchsize=64",
            "--train.total_steps=6",
            "--train.print_frequency=2",
            "--train.evaluate_every=6",
            "--train.data_parallel=gspmd",
            "--train.checkpoint_dir=checkpoints/mh_demo",
            "--train.log_dir=logs/mh_demo",
        ],
        os.path.join(
            os.path.dirname(__file__), "..", "experiments", "mnist_ode",
            "mlp.yaml",
        ),
    )
    cfg.model.image_size = [8, 8]
    out = run_classification_experiment(cfg, "mh_demo")
    print(f"[proc {proc}] done: {out}", flush=True)


def _demo() -> None:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--demo-worker", str(i), port],
            env=env,
        )
        for i in range(2)
    ]
    codes = [p.wait() for p in procs]
    print(f"demo exit codes: {codes}")
    sys.exit(max(codes))


if __name__ == "__main__":
    if "--demo-worker" in sys.argv:
        i = sys.argv.index("--demo-worker")
        _demo_worker(int(sys.argv[i + 1]), sys.argv[i + 2])
    elif "--demo" in sys.argv:
        _demo()
    else:
        # multi-host mode: initialize, then hand off to the standard
        # experiment entry path
        from localregneuralde_tpu.parallel import multihost

        dist = {"--coordinator": None, "--num-processes": None,
                "--process-id": None}
        overrides = []
        for arg in sys.argv[2:]:
            key, _, val = arg.partition("=")
            if key in dist:
                dist[key] = val
            else:
                overrides.append(arg)
        multihost.initialize(
            coordinator_address=dist["--coordinator"],
            num_processes=(None if dist["--num-processes"] is None
                           else int(dist["--num-processes"])),
            process_id=(None if dist["--process-id"] is None
                        else int(dist["--process-id"])),
        )

        from localregneuralde_tpu.harness import define_configuration
        from localregneuralde_tpu.harness.runner import (
            run_classification_experiment,
        )

        cfg = define_configuration(overrides, sys.argv[1])
        print(run_classification_experiment(cfg, "multihost"))
