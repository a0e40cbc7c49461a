"""NeuralDSDE — drift+diffusion neural SDE layer with local regularization.

Reference: ``src/layers/neural_sde.jl``. Diagonal noise by default
(``noise_dims`` enables the non-diagonal commutative-Milstein path); the
default solver is ``'sosri'`` — the stability-optimized four-stage SRI
tableau, matching the reference's ``SOSRI()`` default
(``neural_sde.jl:12``; our drift block is independently derived, see
``sde/tableaus.py``). ``'sri'`` selects classical SRIW1.

Semantics preserved:
- state carries ``{drift, diffusion, nfe_drift, nfe_diffusion, reg_val, rng}``
  with NFE counted separately per closure (``neural_sde.jl:44-64``);
- **unbiased** training samples ``t1 ~ U(t0, t2)``, reads ``u(t1)`` from the
  (linearly interpolating) solution, then takes ONE differentiable SRI step
  from ``(u(t1), t1)`` whose δ-weighted embedded estimate × dt is the
  regularizer (``neural_sde.jl:88-104``). The re-init is gradient-fenced and
  — as in the reference, where ``init`` builds a *fresh* noise process — the
  regularization step uses fresh ``dW, dZ ~ N(0, dt)`` from the layer RNG;
- **biased** training samples ``t1`` from the accepted step grid
  (reservoir-sampled here), excluding ``t_end``: "Accidentally sampling t2
  will lead to stability problems" (``neural_sde.jl:114-115``) — the
  reservoir only ever holds step-start points, so t_end is excluded by
  construction.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax

from ..core.containers import ArrayAndTime, get_array
from ..nn.module import Module
from ..ops.residuals import internal_norm
from ..sde.solve import sdesolve
from ..sde.step import sri_step

_VALID_REGULARIZE = ("none", "unbiased", "biased")


class NeuralDSDE(Module):
    def __init__(
        self,
        drift: Module,
        diffusion: Module,
        *,
        tspan=(0.0, 1.0),
        regularize: Union[bool, str] = "unbiased",
        rtol: float = 1e-2,
        atol: float = 1e-2,
        max_steps: int = 256,
        checkpoint_every: int = 16,
        saveat: Optional[Any] = None,
        adjoint: str = "stored",
        solver: str = "sosri",
        delta: float = 1 / 6,
        noise_dims: Optional[int] = None,
        precision: str = "auto",
    ):
        if isinstance(regularize, bool):
            regularize = "unbiased" if regularize else "none"
        if regularize not in _VALID_REGULARIZE:
            raise ValueError(f"regularize must be one of {_VALID_REGULARIZE}")
        from ..sde.solve import _SOLVERS

        if solver not in _SOLVERS:
            raise ValueError(
                f"solver must be one of {tuple(_SOLVERS)} "
                "(SOSRI/SRIW1/RKMilCommute/LambaEulerHeun — reference "
                "LocalRegNeuralDE.jl:7-9), got " f"{solver!r}"
            )
        if noise_dims is not None and solver != "milstein":
            raise ValueError(
                "non-diagonal noise (noise_dims=m) requires solver='milstein' "
                "(the commutative RKMilCommute branch, reference "
                "perform_step.jl:126-160)"
            )
        self.drift = drift
        self.diffusion = diffusion
        self.tspan = (float(tspan[0]), float(tspan[1]))
        self.regularize = regularize
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_steps = int(max_steps)
        self.checkpoint_every = int(checkpoint_every)
        self.saveat = None if saveat is None else jnp.asarray(saveat)
        self.adjoint = adjoint
        self.solver = solver
        self.delta = float(delta)
        self.noise_dims = None if noise_dims is None else int(noise_dims)
        from ..nn.basic import resolve_solver_precision

        self.mm_precision = resolve_solver_precision(precision, self.rtol)

    def init(self, key):
        dk, gk, sk = jax.random.split(key, 3)
        dp, ds = self.drift.init(dk)
        gp, gs = self.diffusion.init(gk)
        state = {
            "drift": ds,
            "diffusion": gs,
            "nfe_drift": jnp.asarray(-1, jnp.int32),
            "nfe_diffusion": jnp.asarray(-1, jnp.int32),
            "reg_val": jnp.asarray(0.0, jnp.float32),
            "rng": sk,
            "success": jnp.asarray(True),
        }
        return {"drift": dp, "diffusion": gp}, state

    def _dynamics(self, training: bool):
        prec = self.mm_precision

        def _apply(module, p, st, u, t):
            if prec is not None:
                with jax.default_matmul_precision(prec):
                    return module(p, st, ArrayAndTime(u, t), training=training)
            return module(p, st, ArrayAndTime(u, t), training=training)

        def f(u, t, p, st):
            y, st_new = _apply(self.drift, p["drift"], st, u, t)
            return get_array(y), st_new

        def g(u, t, p, st):
            y, st_new = _apply(self.diffusion, p["diffusion"], st, u, t)
            y = get_array(y)
            if self.noise_dims is not None:
                # matrix diffusion: the network emits (..., d·m) which is
                # viewed as the noise-rate matrix (..., d, m) — the analog of
                # the reference's mul! reshape shim that exists only for the
                # NeuralDSDE non-diagonal path (src/utils.jl:69-74)
                y = y.reshape(u.shape + (self.noise_dims,))
            return y, st_new

        return f, g

    def apply(self, params, state, x, *, training: bool = False):
        t0, t2 = self.tspan
        f, g = self._dynamics(training)
        mode = self.regularize if training else "none"
        key = state["rng"]
        key, noise_key, tkey, rkey, wkey = jax.random.split(key, 5)

        noise_shape = (
            None if self.noise_dims is None
            else x.shape[:-1] + (self.noise_dims,)
        )
        common = dict(
            noise_key=noise_key,
            rtol=self.rtol,
            atol=self.atol,
            solver=self.solver,
            delta=self.delta,
            max_steps=self.max_steps,
            checkpoint_every=self.checkpoint_every,
            stateful=True,
            f_state=state["drift"],
            g_state=state["diffusion"],
            noise_shape=noise_shape,
        )

        if mode == "none":
            sol = sdesolve(
                f, g, x, self.tspan, params, saveat=self.saveat,
                adjoint=self.adjoint if training else "none", **common,
            )
            new_state = {
                "drift": sol.f_state,
                "diffusion": sol.g_state,
                "nfe_drift": sol.nfe_drift,
                "nfe_diffusion": sol.nfe_diffusion,
                "reg_val": jnp.asarray(0.0, jnp.float32),
                "rng": key,
                "success": sol.success,
            }
            return sol, new_state

        if mode == "unbiased":
            t1 = jax.random.uniform(
                tkey, (), jnp.float32, minval=t0, maxval=t2
            )
            user_saveat = (
                self.saveat if self.saveat is not None
                else jnp.asarray([t2], jnp.float32)
            )
            saveat_int = jnp.concatenate([user_saveat, t1[None]])
            sol = sdesolve(
                f, g, x, self.tspan, params, saveat=saveat_int,
                adjoint=self.adjoint, **common,
            )
            u1 = lax.stop_gradient(sol.ys[-1])
            sol = dataclasses.replace(sol, ys=sol.ys[:-1], ts=user_saveat)
        else:  # biased
            sol = sdesolve(
                f, g, x, self.tspan, params, saveat=self.saveat,
                adjoint=self.adjoint, reservoir_key=rkey, **common,
            )
            t1 = sol.reservoir_t
            u1 = lax.stop_gradient(sol.reservoir_u)

        # --- one differentiable SRI step at (u1, t1): fresh noise, fenced init
        t1 = lax.stop_gradient(t1)
        f0, _ = f(u1, t1, params, sol.f_state)
        sc = self.atol + jnp.abs(u1) * self.rtol
        d0 = internal_norm(u1 / sc)
        d1 = internal_norm(f0 / sc)
        dt_r = jnp.where(
            (d0 < 1e-5) | (d1 < 1e-5), 1e-6,
            0.01 * d0 / jnp.where(d1 == 0, 1.0, d1),
        )
        dt_r = lax.stop_gradient(
            jnp.minimum(dt_r, jnp.asarray(t2, jnp.float32) - t1)
        )
        kw, kz = jax.random.split(wkey)
        sqdt = jnp.sqrt(dt_r)
        w_shape = u1.shape if noise_shape is None else noise_shape
        dW = jax.random.normal(kw, w_shape, u1.dtype) * sqdt
        dZ = jax.random.normal(kz, w_shape, u1.dtype) * sqdt
        # the reg step uses the layer's configured solver, matching the
        # reference's _perform_step dispatch on the main integrator's cache
        # (neural_sde.jl:96-98 passes n.solver to _get_dsde_integrator)
        if self.solver in ("sri", "sosri"):
            from ..sde.tableaus import get_sri_tableau

            step = sri_step(
                f, g, u1, t1, dt_r, dW, dZ, params, sol.f_state,
                sol.g_state, self.atol, self.rtol, self.delta,
                tableau=get_sri_tableau(self.solver),
            )
        elif self.solver == "milstein":
            if noise_shape is not None:
                from ..sde.step import milstein_commute_step_nondiag

                step = milstein_commute_step_nondiag(
                    f, g, u1, t1, dt_r, dW, params, sol.f_state,
                    sol.g_state, self.atol, self.rtol,
                )
            else:
                from ..sde.step import milstein_commute_step

                step = milstein_commute_step(
                    f, g, u1, t1, dt_r, dW, params, sol.f_state,
                    sol.g_state, self.atol, self.rtol,
                )
        else:
            from ..sde.step import lamba_euler_heun_step

            step = lamba_euler_heun_step(
                f, g, u1, t1, dt_r, dW, params, sol.f_state, sol.g_state,
                self.atol, self.rtol, self.delta,
            )
        reg_val = step.eest * dt_r

        new_state = {
            "drift": step.f_state,
            "diffusion": step.g_state,
            # reg-step stage evals + the init-dt drift probe
            "nfe_drift": sol.nfe_drift + step.nfe_drift + 1,
            "nfe_diffusion": sol.nfe_diffusion + step.nfe_diffusion,
            "reg_val": reg_val,
            "rng": key,
            "success": sol.success,
        }
        return sol, new_state
