"""What a measurement ran on.

Every number the benchmark and the chip smoke test print is reported
beside the device JAX used and, on a GPU, the card's name and power
limit as ``nvidia-smi`` reads them: a card set below its maximum power
runs slower under load, so two numbers compare only with equal limits.
"""

from __future__ import annotations

import os
import subprocess


def device_record(jax_mod) -> dict:
    """Platform, kind and count of the devices JAX uses by default, as
    the chip contract reports them."""
    devs = jax_mod.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(jax_mod) -> dict:
    """``device_record``, or RuntimeError when the default device is not
    a GPU (a device metric is never taken on another platform)."""
    rec = device_record(jax_mod)
    if rec["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {rec['platform']} "
            f"({rec['kind']}); run on a GPU host, or pass --cpu for a "
            "smoke run that reports no device metric")
    return rec


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card,
    or None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip().splitlines()[0]


def run_context(jax_mod) -> dict:
    """Everything a number needs beside it: the device record, the
    card's name and power limit, and XLA_FLAGS."""
    return {"device": device_record(jax_mod),
            "gpu": gpu_name_and_power_limit(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}
