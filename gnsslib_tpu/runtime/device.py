"""The accelerator a measurement runs on.

Measurement entry points (``bench.py``, ``chip_smoke.py``) run on the GPU
or not at all: a number taken on the CPU is never reported under a device
metric, so there is no fallback.
"""
from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of the devices JAX reports.

    Raises RuntimeError when the first device is not a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devs[0].platform!r}; this "
            "measurement runs on the GPU only")
    return {"platform": "gpu", "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """Name and power limit of each card, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them.  A card set below its maximum power runs slower under
    load, so every number is kept beside this line."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
