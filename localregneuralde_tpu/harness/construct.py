"""Factories: config → model / loss / optimizer (reference
``experiments/src/construct.jl``)."""
from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp
import optax

from ..models import (
    AugmenterLayer,
    LatentGRUCell,
    NeuralODE,
    ReparameterizeLayer,
    TDChain,
    diffeqsol_to_array,
    diffeqsol_to_timeseries,
)
from ..nn import (
    BatchNorm,
    Chain,
    Conv,
    Dense,
    Flatten,
    Lambda,
    Recurrence,
    WrappedFunction,
)
from .config import ExperimentConfig
from .losses import kl_divergence, log_likelihood_loss, logitcrossentropy
from .schedulers import (
    Constant,
    CosineAnneal,
    ExponentialDecay,
    InverseDecay,
    Step,
)

# ---------------------------------------------------------------------------
# models


def construct_model(cfg: ExperimentConfig):
    m = cfg.model
    if m.model_type == "mlp" and not m.sde:
        return _construct_mlp_ode(cfg)
    if m.model_type == "mlp" and m.sde:
        return _construct_mlp_sde(cfg)
    if m.model_type == "cifar10_cnn":
        return _construct_cifar10_cnn(cfg)
    if m.model_type == "time_series":
        raise ValueError("time_series models need construct_time_series(cfg, saveat)")
    raise ValueError(f"unknown model_type {m.model_type!r}")


def _node_kwargs(cfg: ExperimentConfig):
    s = cfg.model.solver
    if s.ode_solver not in ("tsit5", "vcab3", "vcabm3"):
        raise ValueError(
            f"unknown ode_solver {s.ode_solver!r}; supported: tsit5, vcab3, "
            "vcabm3 (reference construct.jl:154-164)"
        )
    if s.adjoint not in ("stored", "direct", "interpolating", "backsolve"):
        raise ValueError(
            f"unknown adjoint {s.adjoint!r}; supported: stored, direct, "
            "interpolating, backsolve"
        )
    return dict(
        rtol=s.reltol,
        atol=s.abstol,
        max_steps=s.max_steps,
        checkpoint_every=s.checkpoint_every,
        regularize=cfg.model.regularize,
        regularize_type=cfg.model.regularize_type,
        solver=s.ode_solver,
        adjoint=s.adjoint,
        precision=s.precision,
        knot_window=s.knot_window if s.knot_window > 0 else None,
        compute_dtype=cfg.model.dynamics_compute_dtype,
    )


def _construct_mlp_ode(cfg: ExperimentConfig):
    """Flatten → NeuralODE(TDChain MLP) → classifier
    (reference ``construct.jl:180-200``)."""
    m = cfg.model
    hsize = m.mlp_hidden_state_size
    td = 1 if m.mlp_time_dependent else 0
    insize = m.image_size[0] * m.image_size[1] * m.in_channels
    layers = [Dense(insize + td, hsize, "tanh")]
    for _ in range(m.mlp_num_hidden_layers - 1):
        layers.append(Dense(hsize + td, hsize, "tanh"))
    layers.append(Dense(hsize + td, insize))
    dynamics = TDChain(*layers) if m.mlp_time_dependent else Chain(*layers)
    return Chain(
        flatten=Flatten(),
        neural_ode=NeuralODE(dynamics, **_node_kwargs(cfg)),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(insize, m.num_classes),
    )


def _construct_mlp_sde(cfg: ExperimentConfig):
    """784 → 32 downsample → NeuralDSDE → classifier
    (reference ``construct.jl:202-210``)."""
    from ..models.neural_sde import NeuralDSDE

    m = cfg.model
    s = m.solver
    insize = m.image_size[0] * m.image_size[1] * m.in_channels
    noise_dims = m.sde_noise_dims or None
    drift = Chain(Dense(32, 64, "tanh"), Dense(64, 32))
    diffusion = Dense(32, 32 * (noise_dims or 1))
    return Chain(
        flatten=Flatten(),
        downsample=Dense(insize, 32),
        neural_dsde=NeuralDSDE(
            drift,
            diffusion,
            rtol=s.reltol,
            atol=s.abstol,
            max_steps=s.max_steps,
            checkpoint_every=s.checkpoint_every,
            regularize=m.regularize,
            adjoint=s.adjoint,
            precision=s.precision,
            solver=m.sde_solver,
            noise_dims=noise_dims,
        ),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(32, m.num_classes),
    )


def _construct_cifar10_cnn(cfg: ExperimentConfig):
    """AugmenterLayer 3→8ch → BatchNorm → NeuralODE(TDChain convs) →
    conv classifier (reference ``construct.jl:212-228``; NHWC here)."""
    m = cfg.model
    es = m.bn_eval_stats  # 'running' (reference) | 'batch' (escape hatch
    # for the BN-inside-dynamics eval pathology — see ModelConfig)
    node_core = TDChain(
        Chain(
            Conv((3, 3), 9, 64, use_bias=False),
            BatchNorm(64, "gelu", eval_stats=es),
        ),
        Chain(
            Conv((3, 3), 65, 64, use_bias=False),
            BatchNorm(64, "gelu", eval_stats=es),
        ),
        Conv((3, 3), 65, 8, use_bias=False),
    )
    h, w = m.image_size
    return Chain(
        augment=AugmenterLayer(Conv((3, 3), 3, 5), axis=-1),
        bn=BatchNorm(8, eval_stats=es),
        neural_ode=NeuralODE(node_core, **_node_kwargs(cfg)),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Chain(
            Conv((3, 3), 8, 1, "gelu"),
            Flatten(),
            Dense(h * w, m.num_classes),
        ),
    )


def construct_time_series(cfg: ExperimentConfig, saveat):
    """Recurrence(LatentGRUCell) → rec_to_gen → Reparameterize →
    NeuralODE(gen dynamics, saveat=grid) → timeseries → decoder
    (reference ``construct.jl:230-252``)."""
    m = cfg.model
    gru = Recurrence(LatentGRUCell(m.ts_in_dims, m.ts_hidden_dims, m.ts_latent_dims))
    rec_to_gen = Chain(
        Dense(2 * m.ts_latent_dims, m.ts_latent_dims, "tanh"),
        Dense(m.ts_latent_dims, 2 * m.ts_node_dims),
    )
    gen_dynamics = Chain(
        Lambda(jnp.tanh),
        Dense(m.ts_node_dims, m.ts_hidden_dims, "tanh"),
        Dense(m.ts_hidden_dims, m.ts_node_dims, "tanh"),
        Dense(m.ts_node_dims, m.ts_hidden_dims, "tanh"),
        Dense(m.ts_hidden_dims, m.ts_node_dims, "tanh"),
        Dense(m.ts_node_dims, m.ts_hidden_dims, "tanh"),
        Dense(m.ts_hidden_dims, m.ts_node_dims, "tanh"),
        Dense(m.ts_node_dims, m.ts_hidden_dims, "tanh"),
        Dense(m.ts_hidden_dims, m.ts_node_dims, "tanh"),
    )
    return Chain(
        gru=gru,
        rec_to_gen=rec_to_gen,
        reparam=ReparameterizeLayer(),
        neural_ode=NeuralODE(gen_dynamics, saveat=saveat, **_node_kwargs(cfg)),
        sol_to_ts=WrappedFunction(diffeqsol_to_timeseries),
        gen_to_data=Dense(m.ts_node_dims, m.ts_in_dims),
    )


# ---------------------------------------------------------------------------
# losses


def construct_loss(cfg: ExperimentConfig) -> Tuple[Callable, object]:
    """Return ``(loss_fn, w_reg_schedule)``; for time-series models the
    schedule is ``(w_reg, w_kl)`` (reference ``construct.jl:78-102``)."""
    if cfg.model.model_type == "time_series":
        loss_fn = _latent_ode_loss(cfg)
    else:
        loss_fn = _classification_loss(cfg)

    if cfg.loss.w_reg_decay == "exponential":
        w_reg = ExponentialDecay(
            cfg.loss.w_reg_start, cfg.loss.w_reg_end, cfg.train.total_steps
        )
    else:
        w_reg = Constant(cfg.loss.w_reg_start)

    if cfg.model.model_type == "time_series":
        w_kl = lambda t: max(0.0, 1 - 0.99 ** (t - 100))  # noqa: E731
        return loss_fn, (w_reg, w_kl)
    return loss_fn, w_reg


def _classification_loss(cfg: ExperimentConfig):
    regularized = cfg.model.regularize != "none"
    sde = cfg.model.sde

    def loss_fn(model, params, state, data, w_reg, *, training=True):
        x, y = data
        y_pred, st_ = model(params, state, x, training=training)
        ce_loss = logitcrossentropy(y_pred, y)
        if sde:
            node_st = st_["neural_dsde"]
            # as-is reference quirk (construct.jl:9,24): the logged diffusion
            # NFE mirrors the drift NFE.
            nfe = (node_st["nfe_drift"], node_st["nfe_drift"])
        else:
            node_st = st_["neural_ode"]
            nfe = node_st["nfe"]
        reg_val = node_st["reg_val"] if regularized else jnp.zeros(())
        loss = ce_loss + w_reg * reg_val if regularized else ce_loss
        stats = {
            "y_pred": y_pred,
            "nfe": nfe,
            "ce_loss": ce_loss,
            "reg_val": reg_val,
            "solver_success": node_st.get("success", jnp.asarray(True)),
        }
        return loss, st_, stats

    return loss_fn


def _latent_ode_loss(cfg: ExperimentConfig):
    regularized = cfg.model.regularize != "none"

    def loss_fn(model, params, state, data, w, *, training=True):
        w_reg, w_kl = w
        data_arr, mask, dt = data  # each (B, T, F)-ish, dt (B, T, 1)
        x = jnp.concatenate([data_arr, mask, dt], axis=-1)
        y, st_ = model(params, state, x, training=training)
        dpred = y * mask - data_arr * mask
        ll = log_likelihood_loss(dpred, mask)
        kl = kl_divergence(st_["reparam"]["mu"], st_["reparam"]["logvar"])
        loss = -jnp.mean(ll - w_kl * kl)
        reg_val = st_["neural_ode"]["reg_val"] if regularized else jnp.zeros(())
        if regularized:
            loss = loss + w_reg * reg_val
        stats = {
            "y_pred": y,
            "neg_log_likelihood": -jnp.mean(ll),
            "kl_div": jnp.mean(kl),
            "nfe": st_["neural_ode"]["nfe"],
            "reg_val": reg_val,
            "solver_success": st_["neural_ode"].get(
                "success", jnp.asarray(True)
            ),
        }
        return loss, st_, stats

    return loss_fn


# ---------------------------------------------------------------------------
# optimizers


def construct_optimizer(cfg: ExperimentConfig):
    """Return ``(optax transform, lr_schedule)``; the LR schedule is applied
    via ``optax.inject_hyperparams`` so it can be adjusted per step
    (reference ``construct.jl:104-152``)."""
    o = cfg.optimizer
    name = o.optimizer.lower()
    if name == "adam":
        make = lambda lr: optax.adam(lr)  # noqa: E731
    elif name == "adamw":
        make = lambda lr: optax.adamw(lr)  # noqa: E731
    elif name == "adamax":
        make = lambda lr: optax.adamax(lr)  # noqa: E731
    elif name == "sgd":
        if o.nesterov:
            make = lambda lr: optax.sgd(lr, momentum=o.momentum, nesterov=True)  # noqa: E731
        elif o.momentum == 0:
            make = lambda lr: optax.sgd(lr)  # noqa: E731
        else:
            make = lambda lr: optax.sgd(lr, momentum=o.momentum)  # noqa: E731
    else:
        raise ValueError(
            f"unknown optimizer {o.optimizer!r}; supported: adam, adamw, "
            "adamax, sgd"
        )

    if o.weight_decay != 0:
        base = make

        def make(lr):  # noqa: F811
            return optax.chain(
                base(lr), optax.add_decayed_weights(o.weight_decay)
            )

    if getattr(o, "gradient_clip_norm", 0.0):
        inner = make

        def make(lr):  # noqa: F811
            return optax.chain(
                optax.clip_by_global_norm(o.gradient_clip_norm), inner(lr)
            )

    opt = optax.inject_hyperparams(
        lambda learning_rate: make(learning_rate)
    )(learning_rate=o.learning_rate)

    s = o.scheduler
    kind = s.lr_scheduler.lower()
    if kind == "cosine":
        sched = CosineAnneal(
            o.learning_rate,
            o.learning_rate / s.cosine_lr_div_factor,
            s.cosine_cycle_length,
            restart=True,
            dampen=s.cosine_dampen,
        )
    elif kind == "constant":
        sched = Constant(o.learning_rate)
    elif kind == "step":
        sched = Step(o.learning_rate, s.step_lr_step_decay, s.step_lr_steps)
    elif kind == "inverse":
        sched = InverseDecay(o.learning_rate, s.inverse_decay_factor)
    elif kind == "exponential":
        sched = ExponentialDecay(
            o.learning_rate,
            o.learning_rate / s.exponential_lr_div_factor,
            cfg.train.total_steps,
        )
    else:
        raise ValueError(
            f"unknown scheduler {s.lr_scheduler!r}; supported: constant, "
            "step, exponential, inverse, cosine"
        )
    return opt, sched
