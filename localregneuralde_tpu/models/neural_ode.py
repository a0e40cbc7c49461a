"""NeuralODE — the flagship locally-regularized neural ODE layer.

Reference: ``src/layers/neural_ode.jl``. Semantics preserved:

- ``regularize ∈ {'none', 'unbiased', 'biased'}`` (bool coerced to
  unbiased/none, ``neural_ode.jl:14-16``), ``regularize_type ∈
  {'error_estimate', 'stiffness_estimate'}``.
- **unbiased** training: sample ``t1 ~ U(t0, t2)``, make the solver produce
  ``u(t1)`` via dense output, then take ONE differentiable Tsit5 step from
  ``(u(t1), t1)`` with a fresh auto-selected dt; its embedded estimate is the
  regularizer (``neural_ode.jl:68-82``).
- **biased** training: ``t1`` is drawn uniformly from the solver's accepted
  step-start grid instead (``neural_ode.jl:92``) — realized here with O(1)
  memory via in-loop reservoir sampling rather than saving the trajectory.
- The regularization step's initial state, time, initial derivative
  (fsalfirst) and dt are all gradient-fenced, matching the reference's
  non-differentiable integrator re-init (``src/utils.jl:51,60``): the
  reg-value gradient flows to the *parameters only*, never to the layer
  input (asserted by tests, reference ``test/runtests.jl:127-131``).
- The regularization step is always a Tsit5 step regardless of the main
  solver (``neural_ode.jl:75``).
- NFE accounting: main solve (2 init + 6/attempt) + 8 for the reg step
  (6 stages + fsalfirst + init-dt probe), mirroring
  ``sol.destats.nf + nf2`` (``neural_ode.jl:79``, ``perform_step.jl:31``).

Layer state carries ``{model, nfe, reg_val, rng}``; training/eval mode is a
static ``training=`` kwarg rather than a state field (documented deviation —
identical semantics, idiomatic for JAX's static-argument tracing).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import jax
import jax.numpy as jnp
from jax import lax

from ..core.containers import ArrayAndTime, get_array
from ..nn.module import Module
from ..ode.controller import initial_step_size
from ..ode.solve import odesolve
from ..ode.step import regularization_value, tsit5_step

_VALID_REGULARIZE = ("none", "unbiased", "biased")
_VALID_REG_TYPE = ("error_estimate", "stiffness_estimate")


class NeuralODE(Module):
    def __init__(
        self,
        model: Module,
        *,
        tspan=(0.0, 1.0),
        regularize: Union[bool, str] = True,
        regularize_type: str = "error_estimate",
        rtol: float = 1e-3,
        atol: float = 1e-6,
        max_steps: int = 256,
        checkpoint_every: int = 16,
        saveat: Optional[Any] = None,
        adjoint: str = "stored",
        solver: str = "tsit5",
        precision: str = "auto",
        compute_dtype: Optional[str] = None,
        knot_window: Optional[int] = None,
    ):
        if isinstance(regularize, bool):
            regularize = "unbiased" if regularize else "none"
        if regularize not in _VALID_REGULARIZE:
            raise ValueError(f"regularize must be one of {_VALID_REGULARIZE}")
        if regularize_type not in _VALID_REG_TYPE:
            raise ValueError(f"regularize_type must be one of {_VALID_REG_TYPE}")
        if solver not in ("tsit5", "vcab3", "vcabm3"):
            raise ValueError(
                "solver must be 'tsit5', 'vcab3' or 'vcabm3' "
                "(reference construct.jl:154-164)"
            )
        self.model = model
        self.tspan = (float(tspan[0]), float(tspan[1]))
        self.regularize = regularize
        self.regularize_type = regularize_type
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_steps = int(max_steps)
        self.checkpoint_every = int(checkpoint_every)
        self.saveat = None if saveat is None else jnp.asarray(saveat)
        self.adjoint = adjoint
        self.solver = solver
        # stored-adjoint dense-knot capacity (default 512 in
        # ode/stored_adjoint.py); solves beyond it use windowed replay
        self.knot_window = None if knot_window is None else int(knot_window)
        # matmul input precision for all dynamics-path matmuls: at tight
        # tolerances a reduced-precision matmul (TF32 on the GPU) floods
        # the embedded error estimate with rounding noise (see
        # nn.resolve_solver_precision).
        from ..nn.basic import resolve_solver_precision

        self.mm_precision = resolve_solver_precision(precision, self.rtol)
        # optional low-precision DYNAMICS compute (bandwidth lever for the
        # conv family): u and params are cast to this dtype inside the
        # dynamics only; du is upcast back, so all solver math (error
        # estimate, controller, update) stays f32. Mutually exclusive with
        # tight-tolerance 'highest' precision — bf16 noise (~4e-3 relative)
        # would swamp the estimate there.
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32/bfloat16, got {compute_dtype!r}"
            )
        self.compute_dtype = (
            None if compute_dtype in (None, "float32") else jnp.bfloat16
        )
        if self.compute_dtype is not None and self.mm_precision is not None:
            raise ValueError(
                "compute_dtype='bfloat16' is incompatible with tight-"
                "tolerance precision='highest' (rtol < 1e-4): the bf16 "
                "dynamics noise would swamp the error estimate"
            )

    def init(self, key):
        mkey, skey = jax.random.split(key)
        mp, ms = self.model.init(mkey)
        state = {
            "model": ms,
            "nfe": jnp.asarray(-1, jnp.int32),
            "reg_val": jnp.asarray(0.0, jnp.float32),
            "rng": skey,
            "success": jnp.asarray(True),
        }
        return {"model": mp}, state

    # -- dynamics: wrap the inner model as stateful f(u, t, p, st) -> (du, st)
    def _dynamics(self, training: bool):
        prec = self.mm_precision
        cdt = self.compute_dtype

        def f(u, t, p, st):
            pm = p["model"]
            u_in = u
            if cdt is not None:
                u_in = u.astype(cdt)
                pm = jax.tree_util.tree_map(
                    lambda a: a.astype(cdt)
                    if hasattr(a, "dtype") and a.dtype == jnp.float32 else a,
                    pm,
                )
            if prec is not None:
                # bake the precision into every matmul/conv traced in the
                # dynamics (covers arbitrary user models without a
                # per-layer knob)
                with jax.default_matmul_precision(prec):
                    y, st_new = self.model(
                        pm, st, ArrayAndTime(u_in, t), training=training
                    )
            else:
                y, st_new = self.model(
                    pm, st, ArrayAndTime(u_in, t), training=training
                )
            du = get_array(y)
            if cdt is not None:
                du = du.astype(u.dtype)
            return du, st_new

        return f

    def _solve_main(self, f, x, params, model_state, *, saveat, adjoint,
                    reservoir_key=None):
        """Main solve, dispatching on the configured solver. The reg step is
        always Tsit5 regardless (reference neural_ode.jl:75)."""
        if self.solver == "tsit5":
            return odesolve(
                f, x, self.tspan, params,
                rtol=self.rtol, atol=self.atol, saveat=saveat,
                max_steps=self.max_steps,
                checkpoint_every=self.checkpoint_every,
                adjoint=adjoint, stateful=True, f_state=model_state,
                reservoir_key=reservoir_key,
                knot_window=self.knot_window,
            )
        from ..ode.multistep import adams_solve

        # multistep solvers support the scan-based adjoint only; continuous/
        # stored adjoints fall back to discretize-through
        adams_adjoint = adjoint if adjoint in ("none", "direct") else "direct"
        return adams_solve(
            f, x, self.tspan, params,
            rtol=self.rtol, atol=self.atol,
            moulton=(self.solver == "vcabm3"), saveat=saveat,
            max_steps=self.max_steps,
            checkpoint_every=max(self.checkpoint_every, 1),
            adjoint=adams_adjoint, stateful=True, f_state=model_state,
            reservoir_key=reservoir_key,
        )

    def apply(self, params, state, x, *, training: bool = False):
        t0, t2 = self.tspan
        f = self._dynamics(training)
        mode = self.regularize if training else "none"
        key = state["rng"]

        if mode == "none":
            sol = self._solve_main(
                f, x, params, state["model"], saveat=self.saveat,
                adjoint=self.adjoint if training else "none",
            )
            new_state = {
                "model": sol.f_state,
                "nfe": sol.nfe,
                "reg_val": jnp.asarray(0.0, jnp.float32),
                "rng": key,
                "success": sol.success,
            }
            return sol, new_state

        key, tkey, rkey = jax.random.split(key, 3)

        if mode == "unbiased":
            # Sample t1 ~ U(t0, t2); obtain u(t1) via dense output by
            # appending t1 to the saveat grid (reference injects t1 into
            # saveat and strips it afterwards, neural_ode.jl:72,81 /
            # utils.jl:25-33 — here the extra slot is structural, so no
            # post-hoc correction is needed).
            t1 = jax.random.uniform(
                tkey, (), jnp.float32, minval=t0, maxval=t2
            )
            user_saveat = (
                self.saveat if self.saveat is not None
                else jnp.asarray([t2], jnp.float32)
            )
            saveat_int = jnp.concatenate([user_saveat, t1[None]])
            sol = self._solve_main(
                f, x, params, state["model"], saveat=saveat_int,
                adjoint=self.adjoint,
            )
            u1 = lax.stop_gradient(sol.ys[-1])
            # strip the injected t1 slot from the user-visible outputs
            sol = _replace_ys(sol, sol.ys[:-1], user_saveat)
        else:  # biased
            sol = self._solve_main(
                f, x, params, state["model"], saveat=self.saveat,
                adjoint=self.adjoint, reservoir_key=rkey,
            )
            t1 = sol.reservoir_t
            u1 = lax.stop_gradient(sol.reservoir_u)

        # --- one differentiable Tsit5 step at (u1, t1): the local regularizer
        t1 = lax.stop_gradient(t1)
        k1, _ = f(u1, t1, params, sol.f_state)
        k1 = lax.stop_gradient(k1)  # fsalfirst computed under the init fence
        dt_r, _ = initial_step_size(
            f, u1, t1, params, sol.f_state, order=5,
            rtol=self.rtol, atol=self.atol, f0=k1,
        )
        dt_r = lax.stop_gradient(
            jnp.minimum(dt_r, jnp.asarray(t2, jnp.float32) - t1)
        )
        step = tsit5_step(f, u1, t1, dt_r, k1, params, sol.f_state)
        reg_val = regularization_value(
            self.regularize_type, step, u1, dt_r, self.atol, self.rtol
        )
        nfe = sol.nfe + 8  # 6 stages + fsalfirst + init-dt probe

        new_state = {
            "model": step.f_state,
            "nfe": nfe,
            "reg_val": reg_val,
            "rng": key,
            "success": sol.success,
        }
        return sol, new_state


def _replace_ys(sol, new_ys, new_ts):
    return dataclasses.replace(sol, ys=new_ys, ts=new_ts)
