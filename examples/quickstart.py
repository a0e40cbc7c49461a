#!/usr/bin/env python
"""Quickstart: train a locally-regularized Neural ODE on a toy task and
watch the NFE drop.

Run: python examples/quickstart.py  (CPU or GPU; ~1 min on CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import optax

from localregneuralde_tpu.models import NeuralODE, TDChain, diffeqsol_to_array
from localregneuralde_tpu.nn import Chain, Dense, WrappedFunction


def main():
    # Toy task: classify 2-D points by quadrant after flowing through an ODE.
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (256, 2)) * 2
    y = (x[:, 0] > 0).astype(jnp.int32) * 2 + (x[:, 1] > 0).astype(jnp.int32)
    y_oh = jax.nn.one_hot(y, 4)

    dynamics = TDChain(Dense(3, 32, "tanh"), Dense(33, 2))
    node = NeuralODE(
        dynamics,
        regularize="unbiased",            # the paper's method
        regularize_type="error_estimate",
        rtol=1e-4, atol=1e-6, max_steps=64,
    )
    model = Chain(
        node=node,
        to_arr=WrappedFunction(diffeqsol_to_array),
        head=Dense(2, 4),
    )

    params, state = model.init(jax.random.PRNGKey(1))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, state, opt_state, w_reg):
        def loss_fn(params):
            logits, st_ = model(params, state, x, training=True)
            ce = -jnp.mean(
                jnp.sum(y_oh * jax.nn.log_softmax(logits), axis=-1)
            )
            node_st = st_["node"]
            return ce + w_reg * node_st["reg_val"], (st_, node_st["nfe"], ce)

        (loss, (st_, nfe, ce)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), st_, opt_state, ce, nfe

    for step in range(1, 201):
        params, state, opt_state, ce, nfe = train_step(
            params, state, opt_state, w_reg=10.0
        )
        if step % 40 == 0 or step == 1:
            print(f"step {step:4d}  ce={float(ce):.4f}  nfe={int(nfe)}")

    logits, _ = model(params, state, x, training=False)
    acc = jnp.mean(jnp.argmax(logits, -1) == y) * 100
    print(f"final accuracy: {float(acc):.1f}%  "
          "(watch nfe above fall as the dynamics learn to be easy to solve)")


if __name__ == "__main__":
    main()
