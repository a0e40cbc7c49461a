#!/usr/bin/env python
"""PhysioNet latent-ODE experiment (reference: experiments/physionet/main.jl).

Usage: python main.py <config.yaml> [--a.b.c=value ...]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from localregneuralde_tpu.harness import define_configuration
from localregneuralde_tpu.harness.latent_runner import run_latent_ode_experiment
from localregneuralde_tpu.utils.compile_cache import enable_compile_cache


def main(config_file: str, args):
    enable_compile_cache()
    cfg = define_configuration(args, config_file)
    cfg.model.model_type = "time_series"
    name = Path(config_file).stem
    summary = run_latent_ode_experiment(cfg, name)
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python main.py <config.yaml> [--overrides]")
    main(sys.argv[1], sys.argv[2:])
