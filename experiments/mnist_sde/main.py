#!/usr/bin/env python
"""MNIST Neural SDE experiment (reference: experiments/mnist_sde/main.jl).

Usage: python main.py <config.yaml> [--a.b.c=value ...]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from localregneuralde_tpu.harness import define_configuration
from localregneuralde_tpu.harness.runner import run_classification_experiment
from localregneuralde_tpu.utils.compile_cache import enable_compile_cache


def main(config_file: str, args):
    enable_compile_cache()
    cfg = define_configuration(args, config_file)
    cfg.model.sde = True
    name = Path(config_file).stem
    summary = run_classification_experiment(cfg, name)
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python main.py <config.yaml> [--overrides]")
    main(sys.argv[1], sys.argv[2:])
