"""Timing helpers shared by ``bench.py``, ``chip_smoke.py`` and
``benchmarks/``.

A step is timed on the host clock around work that ends in
``block_until_ready`` (JAX returns before the device finishes), after
warm-up calls that compile every shape.  Every result names the device it
ran on: ``device_record()`` gives JAX's view, ``card()`` the NVIDIA card
name and power limit as ``nvidia-smi`` reports them (a card capped below
its maximum runs slower under load, so the limit belongs beside every
number).  A measurement that finds no accelerator fails instead of
timing the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, List

import jax


class NoAcceleratorError(RuntimeError):
    """JAX found only the host CPU."""


def require_accelerator() -> None:
    """Raise unless JAX's default backend is an accelerator."""
    if jax.default_backend() == "cpu":
        raise NoAcceleratorError(
            "no accelerator: JAX's default backend is the CPU, and a CPU "
            "time is not a device measurement")


def device_record() -> dict:
    """The device as JAX reports it."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card() -> str:
    """``name, power.limit`` of the first NVIDIA card, as nvidia-smi
    prints them; "not available" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else \
        "not available"


def time_calls(fn: Callable, *args, warmup: int = 2,
               repeats: int = 20) -> List[float]:
    """Seconds per call of ``fn(*args)``, each ending in
    ``block_until_ready``, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return times


def summarize_ms(seconds: List[float]) -> dict:
    """Median and quartiles of per-call times, in milliseconds."""
    ms = sorted(s * 1e3 for s in seconds)
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3
    return {"median_ms": statistics.median(ms), "q1_ms": q[0],
            "q3_ms": q[2], "n": len(ms)}
