"""Profiling and numerical-debugging hooks.

Port of `hybrid_ode_tpu/utils/profiling.py`:

  * `trace(log_dir)`: a `torch.profiler` window (the host, and the card's
    kernels where CUDA is available) exported as a Chrome trace,
    `log_dir/trace.json` (chrome://tracing or Perfetto).
  * `debug_mode(enable_x64)`: autograd anomaly detection (a backward pass
    that makes NaN raises, naming the forward op), and with `enable_x64` f64
    as the default dtype, both restored on exit.
  * `Throughput`: items per second over a window of ticks.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block and write its Chrome trace to log_dir/trace.json;
    yields the profiler (its `key_averages()` sum the kernels by name)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


@contextlib.contextmanager
def debug_mode(enable_x64: bool = False) -> Iterator[None]:
    """NaN hunting: autograd anomaly detection, optionally f64 by default."""
    previous = torch.get_default_dtype()
    if enable_x64:
        torch.set_default_dtype(torch.float64)
    try:
        with torch.autograd.detect_anomaly():
            yield
    finally:
        torch.set_default_dtype(previous)


class Throughput:
    """Rolling throughput counter: items/sec over a window of ticks."""

    def __init__(self, name: str = "steps"):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self._t0 = time.time()
        self._count = 0

    def tick(self, n: int = 1) -> None:
        self._count += n

    @property
    def per_sec(self) -> float:
        dt = time.time() - self._t0
        return self._count / dt if dt > 0 else 0.0

    def report(self) -> str:
        return f"{self.name}: {self.per_sec:,.0f}/s ({self._count} in {time.time()-self._t0:.1f}s)"
