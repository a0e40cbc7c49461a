"""Recurrence: scan an RNN cell over the time axis.

Counterpart of Lux's ``Recurrence`` used by the Latent-ODE encoder
(reference: ``experiments/src/construct.jl:231``): a single ``lax.scan`` over
the (static-length) observation grid — compiler-friendly sequential control
flow, no Python loops.

Input layout is batch-major ``(B, T, F)`` (the reference is feature-major
``(F, T, B)``); the cell sees ``(B, F)`` slices.

Cell protocol::

    carry0 = cell.initial_carry(x_t)          # from the first time slice
    (y, carry), st = cell(params, st, (x_t, carry), training=...)

The final ``y`` is returned (sequence-to-vector, as in the reference encoder).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .module import Module


class Recurrence(Module):
    def __init__(self, cell: Module):
        self.cell = cell

    def init(self, key):
        return self.cell.init(key)

    def apply(self, params, state, x, *, training: bool = False):
        # x: (B, T, F) → scan over T
        xs = jnp.moveaxis(x, 1, 0)
        carry0 = self.cell.initial_carry(xs[0])

        def step(carry, x_t):
            cell_carry, st = carry
            (y, new_carry), st = self.cell(
                params, st, (x_t, cell_carry), training=training
            )
            return (new_carry, st), y

        (final_carry, final_state), ys = lax.scan(step, (carry0, state), xs)
        return ys[-1], final_state
