"""Timing / observability utilities.

The reference's only instrumentation is an FPS counter printed once per
second (src/app.rs:230-242); FpsCounter reproduces it.  `median_ms` is the
timing protocol of bench.py, chip_smoke.py and the stage breakdown, and
`profile_trace` wraps jax.profiler for full device traces (SURVEY.md
§5.1).  `device_summary` / `gpu_name_power` say what a number was
measured on.
"""

from __future__ import annotations

import contextlib
import shutil
import statistics
import subprocess
import time

import jax


def median_ms(fn, reps: int = 5):
    """Time fn() the way every number in this repo is taken.

    One untimed call first (compile + warm-up; its wall time is returned
    as `first_ms`), then `reps` calls, each ended with
    jax.block_until_ready on its result.  Returns (median_ms, first_ms).
    """
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), first_ms


def device_summary() -> dict:
    """The device as JAX reports it: platform, device_kind, count."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_power() -> str | None:
    """`name, power.limit` of the GPU(s) as nvidia-smi reports them (one
    line per card), or None where nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or None


class FpsCounter:
    """Prints `FPS --- N` once per second, like src/app.rs:230-242."""

    def __init__(self, enabled: bool = True, out=print):
        self.enabled = enabled
        self._out = out
        self._begin = time.monotonic()
        self._frames = 0

    def tick(self):
        if not self.enabled:
            return
        self._frames += 1
        now = time.monotonic()
        if now - self._begin > 1.0:
            self._out(f"FPS --- {self._frames}")
            self._begin = now
            self._frames = 0


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Optional jax.profiler trace around a block (--profile flag)."""
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
