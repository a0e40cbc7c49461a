"""AOT serving export (utils/export.py): StableHLO round-trip parity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from localregneuralde_tpu.models import (
    NeuralODE,
    TDChain,
    diffeqsol_to_array,
)
from localregneuralde_tpu.nn import Chain, Dense, Flatten, WrappedFunction
from localregneuralde_tpu.utils.export import (
    export_model,
    export_model_multi,
    load_exported,
    save_exported,
)


def _tiny_model(key):
    F, H = 12, 8
    model = Chain(
        flatten=Flatten(),
        neural_ode=NeuralODE(
            TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
            regularize="unbiased", rtol=1e-3, atol=1e-3, max_steps=32,
        ),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(F, 3),
    )
    params, state = model.init(key)
    return model, params, state


def test_export_roundtrip_matches_direct_forward(tmp_path):
    model, params, state = _tiny_model(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 3, 4, 1))
    y_direct, _ = model(params, state, x, training=False)

    exp = export_model(model, params, state, x)
    path = str(tmp_path / "m.stablehlo")
    save_exported(exp, path)
    fn = load_exported(path)
    y_loaded = fn(x)
    np.testing.assert_allclose(
        np.asarray(y_loaded), np.asarray(y_direct), rtol=1e-6, atol=1e-6
    )


def test_export_open_weights_and_state(tmp_path):
    """freeze=False exports fn(params, x); with_state returns solver
    telemetry (NFE counters) alongside predictions."""
    model, params, state = _tiny_model(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 3, 4, 1))

    exp = export_model(
        model, params, state, x, freeze=False, with_state=True
    )
    path = str(tmp_path / "open.stablehlo")
    save_exported(exp, path)
    fn = load_exported(path)
    y, st = fn(params, x)
    y_direct, st_direct = model(params, state, x, training=False)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(y_direct), rtol=1e-6, atol=1e-6
    )
    assert int(st["neural_ode"]["nfe"]) == int(st_direct["neural_ode"]["nfe"])

    # hot-swapped weights actually change the output
    params2 = jax.tree_util.tree_map(lambda a: a * 1.5, params)
    y2, _ = fn(params2, x)
    assert not np.allclose(np.asarray(y2), np.asarray(y))


def test_export_multi_batch_ladder_dispatch(tmp_path):
    model, params, state = _tiny_model(jax.random.PRNGKey(0))
    x8 = jax.random.normal(jax.random.PRNGKey(3), (8, 3, 4, 1))

    ladder = export_model_multi(model, params, state, x8, (4, 8))
    path = str(tmp_path / "ladder.stablehlo")
    save_exported(ladder, path)
    fn = load_exported(path)

    # exact-size dispatch
    y8 = fn(x8)
    y8_direct, _ = model(params, state, x8, training=False)
    np.testing.assert_allclose(
        np.asarray(y8), np.asarray(y8_direct), rtol=1e-6, atol=1e-6
    )
    # exact smaller size
    y4 = fn(x8[:4])
    assert np.asarray(y4).shape == (4, 3)
    # padded dispatch: 3 rows ride the B=4 program, tail stripped
    y3 = fn(x8[:3])
    assert np.asarray(y3).shape == (3, 3)
    # over-capacity is an explicit error
    with pytest.raises(ValueError, match="exceeds largest"):
        fn(jnp.zeros((16, 3, 4, 1)))


def test_export_sde_frozen_vs_threaded_state(tmp_path):
    """A fully frozen NeuralDSDE export bakes the PRNG state and replays
    one Brownian path (deterministic serving — documented caveat);
    freeze_state=False threads state so each call draws fresh noise."""
    from localregneuralde_tpu.models.neural_sde import NeuralDSDE

    model = Chain(
        flatten=Flatten(),
        neural_dsde=NeuralDSDE(
            Chain(Dense(6, 8, "tanh"), Dense(8, 6)), Dense(6, 6),
            regularize="none", rtol=1e-1, atol=1e-1, max_steps=64,
        ),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(6, 3),
    )
    params, state = model.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(4), (4, 2, 3, 1))

    frozen = jax.jit(export_model(model, params, state, x).call)
    assert np.allclose(np.asarray(frozen(x)), np.asarray(frozen(x)))

    exp = export_model(model, params, state, x, freeze_state=False)
    path = str(tmp_path / "sde.stablehlo")
    save_exported(exp, path)
    fn = load_exported(path)
    y1, st1 = fn(state, x)
    y2, st2 = fn(st1, x)
    # threaded state advances the PRNG chain → distinct Brownian draws
    assert not np.allclose(np.asarray(y1), np.asarray(y2))
    # and the first threaded call equals the live model exactly
    y_live, _ = model(params, state, x, training=False)
    np.testing.assert_allclose(
        np.asarray(y1), np.asarray(y_live), rtol=1e-6, atol=1e-6
    )


def test_export_fn_score_sde_sampler(tmp_path):
    """export_fn serves arbitrary jittables — here the probability-flow
    score-SDE sampler closed over an analytic score."""
    from jax import export as jax_export

    from localregneuralde_tpu.models.score_sde import (
        gaussian_score_fn,
        sample_probability_flow,
    )
    from localregneuralde_tpu.utils.export import export_fn

    score = gaussian_score_fn(mean=-1.0, var=1.0)

    def draw(key):
        s, sol = sample_probability_flow(
            score, (64,), key, rtol=1e-3, atol=1e-3, max_steps=128
        )
        return s, sol.success

    key = jax.random.PRNGKey(7)
    exp = export_fn(draw, key)
    blob = exp.serialize()
    restored = jax_export.deserialize(blob)
    s_direct, ok_direct = draw(key)
    s_exp, ok_exp = restored.call(key)
    assert bool(ok_exp) and bool(ok_direct)
    np.testing.assert_allclose(
        np.asarray(s_exp), np.asarray(s_direct), rtol=1e-6, atol=1e-6
    )


def test_export_multi_platform_artifact(tmp_path):
    """platforms=('cpu','cuda') lowers one portable artifact; it must
    load and run on the current (cpu) backend."""
    model, params, state = _tiny_model(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(5), (4, 3, 4, 1))
    exp = export_model(
        model, params, state, x, platforms=("cpu", "cuda")
    )
    path = str(tmp_path / "portable.stablehlo")
    save_exported(exp, path)
    fn = load_exported(path)
    y = fn(x)
    y_live, _ = model(params, state, x, training=False)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(y_live), rtol=1e-6, atol=1e-6
    )


def test_export_artifact_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"not an export")
    with pytest.raises(ValueError, match="not an LRNDE export"):
        load_exported(str(p))
