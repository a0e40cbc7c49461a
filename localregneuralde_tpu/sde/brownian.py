"""Virtual Brownian tree: counter-based, rejection-consistent noise.

Replacement for StochasticDiffEq's NoiseProcess with
rejection-safe resampling (SURVEY.md §2d): sampling ``W(t)`` is a *pure
function* of (key, t), realized by a fixed-depth binary Brownian-bridge
descent over the time interval. Because the path is deterministic given the
key, a rejected step that retries with a smaller dt automatically sees noise
consistent with the already-"observed" path — the property the reference
gets from DiffEqNoiseProcess's bridge machinery.

``dZ`` (the independent Gaussian used for the I_(1,0) iterated-integral
approximation in SRI methods, reference ``src/perform_step.jl:57-60``) is a
second independent tree derived from the same key.

Design notes: the descent is a static-length ``fori_loop`` of
``depth`` (default 24 → dt resolution 2^-24·T); each level draws one
normal per state element with a counter-derived key — no host RNG state,
fully traceable, vmappable.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


class VirtualBrownianTree:
    """W: [t0, t1] → R^shape with W(t0) = 0, per-element independent paths."""

    def __init__(self, key, t0: float, t1: float, shape: Tuple[int, ...],
                 dtype=jnp.float32, depth: int = 24):
        self.key_w, self.key_z = jax.random.split(jax.random.fold_in(key, 7))
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.depth = int(depth)

    def _eval(self, base_key, t):
        """Evaluate the bridge at normalized time τ ∈ [0, 1] (dyadic approx)."""
        T = self.t1 - self.t0
        tau = jnp.clip((t - self.t0) / T, 0.0, 1.0)

        w_end = (
            jax.random.normal(jax.random.fold_in(base_key, 1), self.shape,
                              self.dtype)
            * jnp.sqrt(jnp.asarray(T, self.dtype))
        )

        def body(i, carry):
            a, b, wa, wb, node = carry
            m = (a + b) / 2
            # midpoint conditional: N((wa+wb)/2, (b-a)/4 * T)
            node = node * 2
            eps = jax.random.normal(
                jax.random.fold_in(base_key, node + 2), self.shape, self.dtype
            )
            wm = (wa + wb) / 2 + eps * jnp.sqrt(
                (b - a) / 4 * jnp.asarray(T, self.dtype)
            )
            go_right = tau >= m
            a_new = jnp.where(go_right, m, a)
            b_new = jnp.where(go_right, b, m)
            wa_new = jnp.where(go_right, wm, wa)
            wb_new = jnp.where(go_right, wb, wm)
            node = node + go_right.astype(jnp.int32)
            return (a_new, b_new, wa_new, wb_new, node)

        a0 = jnp.zeros((), self.dtype)
        b0 = jnp.ones((), self.dtype)
        w0 = jnp.zeros(self.shape, self.dtype)
        a, b, wa, wb, _ = lax.fori_loop(
            0, self.depth, body, (a0, b0, w0, w_end, jnp.asarray(1, jnp.int32))
        )
        # linear interpolation within the final (2^-depth) cell
        frac = jnp.where(b > a, (tau - a) / (b - a), 0.0)
        return wa + (wb - wa) * frac

    def wz(self, t):
        """(W(t), Z(t)) via ONE stacked bridge descent.

        W and Z share the dyadic traversal but use independent per-node
        noise: each node draws a (2, *shape) normal, channel 0 feeding W
        and channel 1 the independent Z process. This is the canonical
        evaluation (``w``/``z`` are views of it), and it halves the descent
        cost vs two separate trees.
        """
        out = self._eval_stacked(t)
        return out[0], out[1]

    def _eval_stacked(self, t):
        stacked = VirtualBrownianTree.__new__(VirtualBrownianTree)
        stacked.key_w = self.key_w
        stacked.key_z = self.key_z
        stacked.t0 = self.t0
        stacked.t1 = self.t1
        stacked.shape = (2,) + self.shape
        stacked.dtype = self.dtype
        stacked.depth = self.depth
        return stacked._eval(self.key_w, t)

    def w(self, t):
        return self.wz(t)[0]

    def z(self, t):
        return self.wz(t)[1]

    def increments(self, t, dt):
        """(dW, dZ) over [t, t+dt] — consistent across step rejections."""
        w0, z0 = self.wz(t)
        w1, z1 = self.wz(t + dt)
        return w1 - w0, z1 - z0
