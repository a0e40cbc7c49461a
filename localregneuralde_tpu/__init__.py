"""localregneuralde_tpu — a neural differential equation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``avik-pal/LocalRegNeuralDE.jl`` (ICML 2023, arXiv 2303.02262): adaptive
ODE/SDE solvers as bounded reverse-differentiable XLA loops, differentiable
single solver steps whose embedded local-error / stiffness estimates act as a
local regularizer, a neural-DE layer zoo with explicit (params, state)
semantics, and a full experiment harness — designed for XLA (SPMD sharding,
static shapes, compiled loops) rather than as a translation.
"""
from .core import ArrayAndTime, get_array, get_scalar
from .models import (
    AugmenterLayer,
    LatentGRUCell,
    NeuralDSDE,
    NeuralODE,
    ReparameterizeLayer,
    TDChain,
    diffeqsol_to_array,
    diffeqsol_to_timeseries,
)
from .ode import ODESolution, PIController, odesolve
from .sde import SDESolution, sdesolve

__version__ = "0.2.0"

# same public surface as the reference module root
# (src/LocalRegNeuralDE.jl:20-22), plus the solver entry points the
# reference delegates to SciML
__all__ = [
    "ArrayAndTime",
    "AugmenterLayer",
    "LatentGRUCell",
    "NeuralDSDE",
    "NeuralODE",
    "ODESolution",
    "PIController",
    "ReparameterizeLayer",
    "SDESolution",
    "TDChain",
    "diffeqsol_to_array",
    "diffeqsol_to_timeseries",
    "get_array",
    "get_scalar",
    "odesolve",
    "sdesolve",
]
