"""Basic layers: Dense, Conv, BatchNorm, Flatten, WrappedFunction, Chain.

Data layout: batch-major everywhere — matrices are ``(B, F)`` and images
are NHWC ``(B, H, W, C)`` — so matmuls and convolutions map directly onto
XLA's preferred layouts (and cuDNN's NHWC convolutions on the GPU). (The reference, being Julia, is
feature-major ``(F, B)`` / WHCN; the mapping is documented per layer.)
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .module import Module

_ACTIVATIONS = {
    None: lambda x: x,
    "identity": lambda x: x,
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "sigmoid": jax.nn.sigmoid,
    "softplus": jax.nn.softplus,
    "swish": jax.nn.swish,
}


def resolve_activation(act) -> Callable:
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None


def resolve_solver_precision(precision, rtol: float):
    """Matmul input precision for solver-path layers.

    On an NVIDIA GPU since Ampere, an f32 matmul at the default precision
    runs on the tensor cores in TF32: its inputs keep 10 mantissa bits.
    The embedded error estimate ``ũ`` is a cancelling sum of stage
    derivatives, and that rounding lands on it in full. ``chip_smoke.py``
    phase (c) measures it at the flagship width (B=512, 785→100→784) on an
    H100 against float32 on the CPU: one Tsit5 step at the default
    precision is off by 7.5e-5 relative in ``u_new`` and by 2.3e-4 of
    dt·max‖k‖ in ``ũ`` (1e-7 and 3e-7 at 'highest'). At rtol 1e-4 that
    noise costs 56 dynamics evaluations per solve against 26 at 'highest';
    at the paper's rtol 1.4e-8 it costs 24,854 against 176, because the
    controller keeps rejecting steps whose estimate is rounding noise.
    'highest' runs the matmuls in full float32.

    'auto': 'highest' iff rtol < 1e-4, else None (the backend default,
    TF32 on the GPU). 'high' is accepted but no configuration uses it.
    """
    if precision == "auto":
        return "highest" if rtol < 1e-4 else None
    if precision in (None, "default"):
        return None
    if precision in ("high", "highest"):
        return precision
    raise ValueError(
        f"unknown precision {precision!r}; one of auto/default/high/highest"
    )


class Dense(Module):
    """Affine layer ``y = act(x @ W + b)`` with x of shape (..., in_dim).

    Weight init: Glorot uniform; bias zeros (Lux ``Dense`` defaults).
    Reference usage: everywhere in the model zoo (``construct.jl:180-252``).
    """

    def __init__(self, in_dim: int, out_dim: int, activation=None,
                 use_bias: bool = True, precision=None):
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.activation = resolve_activation(activation)
        self.use_bias = use_bias
        self.precision = precision

    def init(self, key):
        w_key, _ = jax.random.split(key)
        w = jax.nn.initializers.glorot_uniform()(
            w_key, (self.in_dim, self.out_dim), jnp.float32
        )
        params = {"w": w}
        if self.use_bias:
            params["b"] = jnp.zeros((self.out_dim,), jnp.float32)
        return params, {}

    def apply(self, params, state, x, *, training: bool = False):
        y = jnp.matmul(x, params["w"], precision=self.precision)
        if self.use_bias:
            y = y + params["b"]
        return self.activation(y), state


class Conv(Module):
    """2-D convolution in NHWC layout with HWIO kernels.

    ``padding='SAME'`` with 3×3 kernels matches the reference's
    ``pad=(1, 1)`` convolutions (``construct.jl:212-228``).
    """

    def __init__(self, kernel_size: Tuple[int, int], in_channels: int,
                 out_channels: int, activation=None, *, padding="SAME",
                 stride: Tuple[int, int] = (1, 1), use_bias: bool = True,
                 precision=None):
        self.kernel_size = tuple(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.activation = resolve_activation(activation)
        self.padding = padding
        self.stride = tuple(stride)
        self.use_bias = use_bias
        self.precision = precision

    def init(self, key):
        w_key, _ = jax.random.split(key)
        shape = self.kernel_size + (self.in_channels, self.out_channels)
        w = jax.nn.initializers.glorot_uniform(in_axis=(0, 1, 2), out_axis=3)(
            w_key, shape, jnp.float32
        )
        params = {"w": w}
        if self.use_bias:
            params["b"] = jnp.zeros((self.out_channels,), jnp.float32)
        return params, {}

    def apply(self, params, state, x, *, training: bool = False):
        y = lax.conv_general_dilated(
            x,
            params["w"],
            window_strides=self.stride,
            padding=self.padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=self.precision,
        )
        if self.use_bias:
            y = y + params["b"]
        return self.activation(y), state


class BatchNorm(Module):
    """Batch normalization over all axes except the channel (last) axis.

    Training mode normalizes with batch statistics and updates running
    statistics in ``state``; eval mode uses the running statistics. The
    running stats thread through solver loops as explicit carried state
    (SURVEY.md §7 hard-part 5).
    """

    def __init__(self, features: int, activation=None, *, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True,
                 eval_stats: str = "running"):
        if eval_stats not in ("running", "batch"):
            raise ValueError(
                f"eval_stats must be 'running' or 'batch', got {eval_stats!r}"
            )
        self.features = features
        self.activation = resolve_activation(activation)
        self.momentum = momentum
        self.eps = eps
        self.affine = affine
        # eval-mode statistics source. 'running' is the reference (Lux)
        # semantic. 'batch' normalizes with the CURRENT batch statistics
        # in eval mode too (running stats are kept but unused there) — an
        # opt-in escape hatch for BN-inside-ODE-dynamics models, where a
        # single running average cannot represent statistics that vary
        # along the trajectory and eval-mode flows diverge from the
        # self-normalizing training flow.
        self.eval_stats = eval_stats

    def init(self, key):
        params = {}
        if self.affine:
            params = {
                "scale": jnp.ones((self.features,), jnp.float32),
                "bias": jnp.zeros((self.features,), jnp.float32),
            }
        state = {
            "mean": jnp.zeros((self.features,), jnp.float32),
            "var": jnp.ones((self.features,), jnp.float32),
        }
        return params, state

    def apply(self, params, state, x, *, training: bool = False):
        axes = tuple(range(x.ndim - 1))
        if training:
            mean = jnp.mean(x, axis=axes)
            var = jnp.var(x, axis=axes)
            m = self.momentum
            new_state = {
                "mean": (1 - m) * state["mean"] + m * mean,
                "var": (1 - m) * state["var"] + m * var,
            }
        elif self.eval_stats == "batch":
            mean = jnp.mean(x, axis=axes)
            var = jnp.var(x, axis=axes)
            new_state = state
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * lax.rsqrt(var + self.eps)
        if self.affine:
            y = y * params["scale"] + params["bias"]
        return self.activation(y), new_state


class Flatten(Module):
    """Flatten all non-batch dims: (B, ...) → (B, prod(...)).

    Reference ``FlattenLayer`` (Julia flattens to (features, batch); here the
    batch-major equivalent).
    """

    def apply(self, params, state, x, *, training: bool = False):
        return x.reshape(x.shape[0], -1), state


class WrappedFunction(Module):
    """Lift a pure function into a parameterless layer."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def apply(self, params, state, x, *, training: bool = False):
        return self.fn(x), state


class Lambda(WrappedFunction):
    """Alias of WrappedFunction for elementwise lambdas in dynamics nets."""


class Chain(Module):
    """Sequential container with named sublayers.

    ``Chain(a=Dense(...), b=Dense(...))`` or ``Chain(Dense(...), Dense(...))``
    (auto-named ``layer_0``, ``layer_1``, ...). Params/state are nested dicts
    keyed by layer name — the analog of Lux ``Chain`` named tuples.
    """

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
        new_state = {}
        for name, layer in self.layers.items():
            x, new_state[name] = layer(
                params[name], state[name], x, training=training
            )
        return x, new_state

    # Chains forward ArrayAndTime containers to sublayers untouched so that
    # nested time-aware layers still see the time.
    time_aware = True

    def __call__(self, params, state, x, *, training: bool = False):
        return self.apply(params, state, x, training=training)
