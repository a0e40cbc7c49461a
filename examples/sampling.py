#!/usr/bin/env python
"""Score-SDE sampling: adaptive reverse-time VP-SDE and probability-flow
samplers, a score network as a module, and multi-device fan-out.

Run: python examples/sampling.py  (CPU or GPU; ~1 min on CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from localregneuralde_tpu.models import TDChain
from localregneuralde_tpu.models.score_sde import (
    gaussian_score_fn,
    sample_probability_flow,
    sample_vpsde,
)
from localregneuralde_tpu.nn import Dense


def main():
    # --- 1. Any score function works (here: the analytic score of
    # N(2, 0.25) under the VP-SDE marginals). NFE is the headline
    # observable: the adaptive solver spends steps only where the
    # reverse SDE is stiff.
    score = gaussian_score_fn(mean=2.0, var=0.25)
    s, sol = sample_vpsde(
        score, (2048,), jax.random.PRNGKey(0), rtol=3e-2, atol=3e-2,
        max_steps=512,
    )
    print(f"analytic score: mean={float(s.mean()):+.3f} (target +2.0) "
          f"std={float(s.std()):.3f} (target 0.5) "
          f"NFE={int(sol.nfe_drift) + int(sol.nfe_diffusion)}")

    # --- 2. A TDChain-of-Dense score NETWORK (the reference's
    # time-appended-channel convention) passed as score_module with its
    # raw params. Params realizing s(x, t) = -x: the exact score of
    # N(0, I) data, so samples must recover N(0, I).
    F = 8
    net = TDChain(Dense(F + 1, F))
    w = jnp.zeros((F + 1, F)).at[:F].set(-jnp.eye(F))
    params = {"layer_0": {"w": w, "b": jnp.zeros(F)}}
    s, sol = sample_vpsde(
        None, (256, F), jax.random.PRNGKey(1), params, score_module=net,
        rtol=1e-2, atol=1e-2, max_steps=512,
    )
    print(f"module SDE sampler: mean={float(s.mean()):+.3f} "
          f"std={float(s.std()):.3f} (target 0, 1) "
          f"naccept={int(sol.naccept)} nreject={int(sol.nreject)}")

    # --- 3. The deterministic probability-flow ODE sampler (adaptive
    # Tsit5; same score module).
    s, sol = sample_probability_flow(
        None, (256, F), jax.random.PRNGKey(2), params, score_module=net,
        rtol=1e-4, atol=1e-6, max_steps=512,
    )
    print(f"probability-flow:   mean={float(s.mean()):+.3f} "
          f"std={float(s.std()):.3f} NFE={int(sol.nfe)}")

    # --- 4. Inference-scale fan-out: shard_map runs one adaptive solve
    # per device, each with its own grid and noise stream — zero
    # cross-device traffic.
    n_dev = len(jax.devices())
    if n_dev > 1:
        from jax import lax
        from jax.sharding import Mesh, PartitionSpec as P

        from localregneuralde_tpu.parallel.compat import shard_map_nocheck

        mesh = Mesh(np.asarray(jax.devices()), ("data",))

        def sample_shard(p):
            key = jax.random.fold_in(
                jax.random.PRNGKey(3), lax.axis_index("data")
            )
            out, so = sample_vpsde(
                None, (32, F), key, p, score_module=net,
                rtol=1e-2, atol=1e-2, max_steps=512,
            )
            return out, so.naccept[None]

        s, naccs = jax.jit(shard_map_nocheck(
            sample_shard, mesh, in_specs=(P(),),
            out_specs=(P("data"), P("data")),
        ))(params)
        print(f"fan-out over {n_dev} devices: {s.shape[0]} samples, "
              f"mean={float(s.mean()):+.3f} std={float(s.std()):.3f}, "
              f"per-shard naccept={np.asarray(naccs).tolist()}")
    else:
        print(f"fan-out: skipped (1 device visible)")


if __name__ == "__main__":
    main()
