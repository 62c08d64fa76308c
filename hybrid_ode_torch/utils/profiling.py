"""Profiling, tracing and numerical-debugging hooks.

Port of `hybrid_ode_tpu/utils/profiling.py`, with the port's own spans:

  * `span(name, **attrs)`: a named interval of the program's host time.
    While a `torch.profiler` session records, a span opens
    `torch.profiler.record_function(name)` (so it sits in the profiler's
    timeline beside the kernels it launched) and appends
    (name, start, end, parent, attrs) to an in-memory log; otherwise it is a
    shared no-op that costs a read of the profiler's flag. The first span
    to find the flag on after one found it off clears the log, as does
    `trace`, so that it holds the latest profiled window (two windows of
    torch's profiler with no span between them share one log). `set_attr`
    adds attributes to the innermost open span; `spans()` reads the log.
    The program's spans are named `hode.*`.
  * `counters()`: every counter the program keeps, by name.
  * `trace(log_dir)`: a `torch.profiler` window (the host, and the card's
    kernels where CUDA is available) exported as a Chrome trace,
    `log_dir/trace.json` (chrome://tracing or Perfetto), with the change in
    `counters()` over the window in `log_dir/counters.json`.
  * `debug_mode(enable_x64)`: autograd anomaly detection (a backward pass
    that makes NaN raises, naming the forward op), and with `enable_x64` f64
    as the default dtype, both restored on exit.

The JAX package's `Throughput` has no counterpart: on an asynchronous
device its host clock times the enqueue, not the work.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple

import torch
import torch.autograd.profiler as _profiler

#: spans the log keeps of one profiled window; later ones are counted only
LOG_CAP = 1 << 18

#: (module, name) of each counter the program keeps; `counters()` names
#: each `<module's last part>.<name>`
COUNTERS = (
    ("hybrid_ode_torch.ops.fused_rk4", "fused_rk4_fwd_launches"),
    ("hybrid_ode_torch.ops.fused_rk4", "fused_rk4_bwd_launches"),
    ("hybrid_ode_torch.ops.fused_rk4", "fused_rk4_bwd_vjp_launches"),
    ("hybrid_ode_torch.ops.fused_rk4", "fused_rk4_cluster_launches"),
    ("hybrid_ode_torch.ops.fused_rk4", "fused_rk4_cluster_narrow_launches"),
    ("hybrid_ode_torch.ops.fused_rk4", "fused_rk4_cluster_wide_launches"),
    ("hybrid_ode_torch.solvers.explicit", "host_syncs"),
    ("hybrid_ode_torch.solvers.explicit", "graph_captures"),
    ("hybrid_ode_torch.solvers.explicit", "graph_replays"),
    ("hybrid_ode_torch.inference.mcmc", "host_syncs"),
    ("hybrid_ode_torch.inference.mcmc", "grad_evals"),
    ("hybrid_ode_torch.inference.mcmc", "transitions"),
    ("hybrid_ode_torch.train.online", "adapt_steps"),
    ("hybrid_ode_torch.train.online", "subjects"),
    ("hybrid_ode_torch.train.online", "forecasts"),
)


class Span(NamedTuple):
    name: str
    start_ns: int  # the profiler's clock: Unix time in ns, as it stamps its events
    end_ns: int    # 0 while the span is open
    parent: int    # index in the log of the enclosing span, -1 at the top
    attrs: Dict[str, Any]


class _Log:
    """The spans of the latest profiled window, in the order they opened."""

    def __init__(self):
        self.entries: List[list] = []  # [name, start_ns, end_ns, parent, attrs]
        self.open: List[int] = []      # indices of the open spans, innermost last
        self.dropped = 0
        self.session = 0

    def clear(self) -> None:
        self.entries, self.open, self.dropped = [], [], 0
        self.session += 1


_LOG = _Log()


class _Recording:
    """One span while the profiler records."""

    __slots__ = ("name", "attrs", "rf", "index", "session")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Recording":
        start = time.time_ns()
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        log = _LOG
        self.session = log.session
        if len(log.entries) >= LOG_CAP:
            log.dropped += 1
            self.index = -1
        else:
            self.index = len(log.entries)
            parent = log.open[-1] if log.open else -1
            log.entries.append([self.name, start, 0, parent, self.attrs])
            log.open.append(self.index)
        return self

    def __exit__(self, *exc) -> None:
        log = _LOG
        if self.index >= 0 and self.session == log.session:
            log.entries[self.index][2] = time.time_ns()
            log.open.pop()
        self.rf.__exit__(*exc)


_OFF = contextlib.nullcontext()
_live = False  # whether the latest span found the profiler on


def span(name: str, **attrs):
    """A context manager timing the block as span `name`. `attrs` holds host
    integers or strings, or 0-d device tensors that are read only by
    `spans()`."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = False
        return _OFF
    if not _live:  # the first span of a profiled window
        _live = True
        _LOG.clear()
    return _Recording(name, attrs)


def recording() -> bool:
    """Whether spans are being recorded (a profiler session is on)."""
    return _profiler._is_profiler_enabled


def set_attr(**attrs) -> None:
    """Set attributes on the innermost open span (none where none records)."""
    if _LOG.open:
        _LOG.entries[_LOG.open[-1]][4].update(attrs)


def spans() -> List[Span]:
    """The spans of the latest profiled window, in the order they opened,
    their device attributes read now (a synchronisation: read the log once
    the window has closed)."""
    out = []
    for name, start, end, parent, attrs in _LOG.entries:
        for k, v in attrs.items():
            if isinstance(v, torch.Tensor):
                attrs[k] = v.item()
        out.append(Span(name, start, end, parent, dict(attrs)))
    return out


def dropped_spans() -> int:
    """Spans of the latest profiled window that the log had no room for."""
    return _LOG.dropped


def counters() -> Dict[str, int]:
    """Every program counter by name; 0 for a module not imported yet."""
    out = {}
    for module, name in COUNTERS:
        mod = sys.modules.get(module)
        out[f"{module.rsplit('.', 1)[1]}.{name}"] = getattr(mod, name) if mod else 0
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block and write its Chrome trace to log_dir/trace.json
    and the change in `counters()` to log_dir/counters.json; yields the
    profiler (its `key_averages()` sum the kernels by name)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    global _live
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    before = counters()
    _live = False  # the window's first span clears the log
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
        after = counters()
        (Path(log_dir) / "counters.json").write_text(
            json.dumps({k: after[k] - before[k] for k in after}, indent=1))


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
