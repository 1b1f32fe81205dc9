"""What the measurement entry points need to know about the card.

A measurement that finds no GPU fails; it never falls back to the CPU,
whose times say nothing about the card. Every reported number carries the
card's name and power limit, since a card set below its maximum power
runs slower under load.
"""
from __future__ import annotations

import subprocess


def require_gpu(what: str):
    """JAX's first device if it is a GPU; otherwise exit nonzero."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"{what}: needs a GPU, JAX's default device is "
                         f"{d.platform}:{d.device_kind}")
    return d


def card_line() -> str:
    """``name, power limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
