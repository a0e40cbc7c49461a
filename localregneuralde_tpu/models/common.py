"""Common neural-DE layers: TDChain, AugmenterLayer, ReparameterizeLayer,
and solution→array adapters.

Reference: ``src/layers/common.jl`` and ``src/utils.jl:25-46``. Layout note:
this framework is batch-major (``(B, F)`` / NHWC), so the reference's
"concatenate along dim ndims−1" (the Julia channel dim) becomes
"concatenate along the last axis".
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.containers import ArrayAndTime, get_array
from ..nn.module import Module


def _apply_time_dependent(layer, params, state, arr, t, training):
    """Concat-free fast path for conv sublayers of a TDChain.

    ``conv(concat(x, t·1), W) = conv(x, W[:,:,:C,:]) + t·conv(1, W[:,:,C:,:])``
    exactly (linearity), so the time channel becomes a tiny 1-channel conv of
    a constant ones image — avoiding (a) materializing the (B,H,W,C+1)
    concat copy every dynamics eval and (b) the matmul-unfriendly odd channel
    count (65 instead of 64) in the CIFAR dynamics. Returns None when the
    layer has no conv fast path (generic concat applies). Parameter layout
    is IDENTICAL to the concat path (last input channel = time), so
    checkpoints and reference parity are unaffected.
    """
    from ..nn.basic import Chain, Conv
    from jax import lax as _lax

    def conv_split(conv: "Conv", p, x):
        w = p["w"]  # (kh, kw, C+1, Cout); last input channel = time
        c = x.shape[-1]
        if w.shape[2] != c + 1:
            return None
        y = _lax.conv_general_dilated(
            x, w[:, :, :c, :], window_strides=conv.stride,
            padding=conv.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=conv.precision,
        )
        ones1 = jnp.ones((1,) + x.shape[1:-1] + (1,), x.dtype)
        tmap = _lax.conv_general_dilated(
            ones1, w[:, :, c:, :], window_strides=conv.stride,
            padding=conv.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=conv.precision,
        )
        y = y + jnp.asarray(t, x.dtype) * tmap
        if conv.use_bias:
            y = y + p["b"]
        return conv.activation(y)

    if isinstance(layer, Conv):
        y = conv_split(layer, params, arr)
        return None if y is None else (y, state)

    if isinstance(layer, Chain):
        names = list(layer.layers.keys())
        if not names:
            return None
        first = layer.layers[names[0]]
        if not isinstance(first, Conv):
            return None
        y = conv_split(first, params[names[0]], arr)
        if y is None:
            return None
        new_state = {names[0]: state[names[0]]}
        for nm in names[1:]:
            y, new_state[nm] = layer.layers[nm](
                params[nm], state[nm], y, training=training
            )
        return y, new_state

    return None


class TDChain(Module):
    """Time-dependent chain (reference ``src/layers/common.jl:1-45``).

    Each sublayer's input gets a ``ones·t`` channel concatenated along the
    channel/feature (last) axis before the layer is applied — this is why
    reference layer widths look like ``Dense(3=>4), Dense(5=>2)`` and the
    CIFAR dynamics convs are 9→64, 65→64. Accepts ``ArrayAndTime`` or an
    ``(x, t)`` tuple; returns the same kind of container.
    """

    time_aware = True

    def __init__(self, *layers: Module, **named_layers: Module):
        if layers and named_layers:
            raise ValueError("pass either positional or named layers, not both")
        if named_layers:
            self.layers = dict(named_layers)
        else:
            self.layers = {f"layer_{i}": l for i, l in enumerate(layers)}

    def init(self, key):
        keys = jax.random.split(key, max(len(self.layers), 1))
        params, state = {}, {}
        for (name, layer), k in zip(self.layers.items(), keys):
            p, s = layer.init(k)
            params[name] = p
            state[name] = s
        return params, state

    def apply(self, params, state, x, *, training: bool = False):
        if isinstance(x, ArrayAndTime):
            arr, t = x.array, x.scalar
            rewrap = "aat"
        elif isinstance(x, tuple):
            arr, t = x
            rewrap = "tuple"
        else:
            raise TypeError("TDChain expects ArrayAndTime or an (x, t) tuple")

        new_state = {}
        for name, layer in self.layers.items():
            out = _apply_time_dependent(
                layer, params[name], state[name], arr, t, training
            )
            if out is None:
                # generic path: concatenate the ones·t channel.
                # full() keeps arr.dtype (ones*t would promote bf16·f32 →
                # f32 and break low-precision dynamics compute)
                t_channel = jnp.full(arr.shape[:-1] + (1,), t, arr.dtype)
                arr_t = jnp.concatenate([arr, t_channel], axis=-1)
                out = layer(
                    params[name], state[name], arr_t, training=training
                )
            arr, new_state[name] = out
            arr = get_array(arr)

        if rewrap == "aat":
            return ArrayAndTime(arr, t), new_state
        return (arr, t), new_state


class AugmenterLayer(Module):
    """ANODE-style augmentation (reference ``src/layers/common.jl:79-93``):
    run a sub-layer and concatenate its output to the input along ``axis``
    (default: the channel axis)."""

    def __init__(self, augment: Module, axis: int = -1):
        self.augment = augment
        self.axis = axis

    def init(self, key):
        return self.augment.init(key)

    def apply(self, params, state, x, *, training: bool = False):
        y, st = self.augment(params, state, x, training=training)
        return jnp.concatenate([x, y], axis=self.axis), st


class ReparameterizeLayer(Module):
    """VAE reparameterization (reference ``src/layers/common.jl:47-77``).

    Splits the last axis into (μ₀, logσ²); in training mode samples
    ``μ₀ + exp(logσ²/2)·ε`` with a fresh PRNG key from layer state, in eval
    mode returns μ₀. μ₀ and logσ² are stored in the returned state for the
    KL term of the latent-ODE loss.
    """

    def init(self, key):
        state = {
            "rng": jax.random.fold_in(key, 0),
            "mu": jnp.zeros((1, 1), jnp.float32),
            "logvar": jnp.zeros((1, 1), jnp.float32),
        }
        return {}, state

    def apply(self, params, state, x, *, training: bool = False):
        latent = x.shape[-1] // 2
        mu = x[..., :latent]
        logvar = x[..., latent:]
        if training:
            key, sub = jax.random.split(state["rng"])
            eps = jax.random.normal(sub, mu.shape, mu.dtype)
            y = mu + jnp.exp(logvar / 2) * eps
            return y, {"rng": key, "mu": mu, "logvar": logvar}
        return mu, {"rng": state["rng"], "mu": mu, "logvar": mu}


def diffeqsol_to_array(sol):
    """Last saved state of a solve (reference ``src/utils.jl:37-40``).
    Accepts ODESolution/SDESolution (anything with ``.ys``)."""
    if hasattr(sol, "ys"):
        return jax.tree_util.tree_map(lambda y: y[-1], sol.ys)
    if isinstance(sol, ArrayAndTime):
        return get_array(sol)
    return sol


def diffeqsol_to_timeseries(sol):
    """Stack saved states along a new time axis → (B, T, F...)
    (reference ``src/utils.jl:42-46``; batch-major layout here)."""
    if hasattr(sol, "ys"):
        return jax.tree_util.tree_map(lambda y: jnp.moveaxis(y, 0, 1), sol.ys)
    return sol
