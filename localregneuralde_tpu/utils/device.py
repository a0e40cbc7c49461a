"""The card a measurement runs on, and a refusal to run without one.

Every number a measurement path prints names its device: JAX's platform,
``device_kind`` and device count, and the card's name and power limit as
``nvidia-smi`` reports them (a card capped below its maximum power runs
slower under load). ``nvidia-smi`` runs as a child process, so reading
the card never touches JAX.
"""
from __future__ import annotations

import subprocess
from typing import List, Tuple

import jax

GPU_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def parse_gpu_query(text: str) -> List[Tuple[str, str]]:
    """``(name, power_limit)`` per card from the output of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    e.g. ``"NVIDIA H100 80GB HBM3, 700.00 W"``."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def gpu_query() -> str:
    """The raw ``name, power.limit`` lines of every card."""
    out = subprocess.run(
        GPU_QUERY, capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    parse_gpu_query(out)  # refuse output this code cannot read
    return out


def require_gpu():
    """JAX's device list when its first device is a GPU; raises
    ``RuntimeError`` otherwise — a measurement never falls back to the
    CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); this path measures the card and "
            "does not run elsewhere"
        )
    return devices


def device_record(devices) -> dict:
    """The device fields every printed result carries."""
    d = devices[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(devices),
    }
