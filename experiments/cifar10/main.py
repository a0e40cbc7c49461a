#!/usr/bin/env python
"""CIFAR-10 conv Neural ODE experiment (reference: experiments/cifar10/main.jl).

Adds per-channel mean/std normalization (reference cifar10/main.jl:7-16).
Usage: python main.py <config.yaml> [--a.b.c=value ...]
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from localregneuralde_tpu.harness import define_configuration
from localregneuralde_tpu.harness.runner import run_classification_experiment
from localregneuralde_tpu.utils.compile_cache import enable_compile_cache

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def normalize(x: np.ndarray) -> np.ndarray:
    return (x - CIFAR_MEAN) / CIFAR_STD


def main(config_file: str, args):
    enable_compile_cache()
    cfg = define_configuration(args, config_file)
    cfg.model.model_type = "cifar10_cnn"
    name = Path(config_file).stem
    summary = run_classification_experiment(cfg, name, normalize=normalize)
    print("summary:", summary)
    return summary


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python main.py <config.yaml> [--overrides]")
    main(sys.argv[1], sys.argv[2:])
