"""Tests that need an NVIDIA GPU.

Marked ``gpu``: they skip elsewhere, and ``chip_smoke.py`` runs them in
its own process on the card (``pytest -m gpu``). Each compares the card
with the CPU of the same process, or checks what runs on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.models import NeuralODE, TDChain, diffeqsol_to_array
from localregneuralde_tpu.models.neural_sde import NeuralDSDE
from localregneuralde_tpu.models.score_sde import (
    sample_probability_flow,
    sample_vpsde,
)
from localregneuralde_tpu.nn import Chain, Dense

pytestmark = pytest.mark.gpu


def _cpu():
    return jax.devices("cpu")[0]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_highest_precision_matmul_is_float32_exact(gpu):
    """The premise of precision='highest' on the card: an f32 matmul at
    that precision agrees with a float64 product to f32 rounding."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.normal(k1, (512, 785))
    b = jax.random.normal(k2, (785, 100))
    want = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    a_g, b_g = jax.device_put((a, b), gpu)
    hi = jnp.matmul(a_g, b_g, precision="highest")
    assert hi.devices() == {gpu}
    assert _rel(hi, want) < 1e-6


def _td_node(adjoint):
    dyn = TDChain(Dense(17, 32, "tanh"), Dense(33, 16))
    return NeuralODE(dyn, regularize="unbiased", adjoint=adjoint,
                     rtol=1e-5, atol=1e-5, max_steps=64, precision="highest")


@pytest.mark.parametrize("device", ["gpu", "cpu"])
def test_stored_adjoint_gradient_on_card(gpu, device):
    """Stored-adjoint gradients on the card equal the direct adjoint's on
    the card and the stored adjoint's on the CPU.

    Across devices only the solution's gradient is compared: the
    regularizer is the embedded error estimate, a cancelling sum whose
    float32 gradient moves by ~3e-4 relative when the weights move by 1e-7
    relative, so two devices' rounding alone separates it."""
    node = _td_node("stored")
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 16))
    with_reg = device == "gpu"

    def grads(node, dev):
        def loss(p):
            sol, st_ = node(p, st, x, training=True)
            out = jnp.sum(diffeqsol_to_array(sol) ** 2)
            return out + st_["reg_val"] if with_reg else out

        p_dev = jax.device_put(ps, dev)
        return jax.jit(jax.grad(loss))(p_dev)

    g = grads(node, gpu)
    ref_dev = gpu if device == "gpu" else _cpu()
    ref_node = _td_node("direct") if device == "gpu" else node
    want = grads(ref_node, ref_dev)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(want)):
        assert _rel(a, b) < 1e-4


def test_neural_dsde_trains_on_card(gpu):
    """The SOSRI stored adjoint gives the same gradients on the card as on
    the CPU (same key, same Brownian path)."""
    node = NeuralDSDE(Chain(Dense(8, 16, "tanh"), Dense(16, 8)), Dense(8, 8),
                      regularize="unbiased", rtol=1e-1, atol=1e-1,
                      max_steps=256, solver="sosri", precision="highest")
    ps, st = node.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 8))

    def grads(dev):
        def loss(p):
            sol, st_ = node(p, st, x, training=True)
            return jnp.mean(sol.ys[-1] ** 2) + st_["reg_val"]

        return jax.jit(jax.grad(loss))(jax.device_put(ps, dev))

    for a, b in zip(jax.tree_util.tree_leaves(grads(gpu)),
                    jax.tree_util.tree_leaves(grads(_cpu()))):
        assert np.isfinite(np.asarray(a)).all()
        assert _rel(a, b) < 1e-3


def test_samplers_run_the_xla_loop_on_card(gpu):
    """Both score samplers, given a score network, run the XLA loop on the
    card: no Pallas call in the traced program, finite samples there."""
    f = 8
    net = TDChain(Dense(f + 1, f))
    w = jnp.zeros((f + 1, f)).at[:f].set(-jnp.eye(f))
    params = jax.device_put({"layer_0": {"w": w, "b": jnp.zeros(f)}}, gpu)
    key = jax.device_put(jax.random.PRNGKey(1), gpu)

    def vp(p, k):
        return sample_vpsde(None, (256, f), k, p, score_module=net,
                            rtol=1e-2, atol=1e-2, max_steps=512)[0]

    def pf(p, k):
        return sample_probability_flow(None, (256, f), k, p,
                                       score_module=net, rtol=1e-4,
                                       atol=1e-6, max_steps=512)[0]

    for sampler in (vp, pf):
        assert "pallas" not in str(jax.make_jaxpr(sampler)(params, key))
        s = jax.jit(sampler)(params, key)
        assert s.devices() == {gpu}
        s = np.asarray(s)
        assert np.isfinite(s).all()
        assert abs(s.mean()) < 0.2 and abs(s.std() - 1.0) < 0.2
