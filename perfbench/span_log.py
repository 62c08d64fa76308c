"""The program's span log of a traced run, and the arithmetic of the metrics
that read it (`metrics/dispatch_ms.py`, `sync_wait_ms.py`,
`launches_per_field_eval.py`, `lane_use_pct.py`, `chain_use_pct.py`).

The program records its spans (`hode.*`) while the profiler runs and keeps
the latest profiled window's (`hybrid_ode_torch.utils.profiling.spans`):
after a traced run, the units that `perfbench/trace.py` profiled. A program
that records none (an older one) gives nothing to read, and each metric is
then left out of the line.
"""

from __future__ import annotations

SYNC = "hode.sync."


def spans_of(run):
    """The run's spans ([Span(name, start_ns, end_ns, parent, attrs)]), or None."""
    if run.trace is None:
        return None
    from hybrid_ode_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def units(run) -> int:
    """The run's units: its gradient calls where the driver counts them (NUTS,
    the unit of `host_ms_per_grad.nuts` too), else its traced units."""
    return run.trace.counters.get("grad_calls") or run.trace.units


def self_ns(spans):
    """Each span's duration less the durations of its children."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def _in_sync(spans, i) -> bool:
    """Whether span i lies inside a sync span (itself one included)."""
    while i >= 0:
        if spans[i].name.startswith(SYNC):
            return True
        i = spans[i].parent
    return False


def sync_ns(spans) -> int:
    """Host time blocked in sync spans (those inside another counted once)."""
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name.startswith(SYNC) and not _in_sync(spans, s.parent))


def dispatch_ns(spans) -> int:
    """Host time in the top-level spans less the sync time inside them: the
    self time of every span outside a sync span."""
    return sum(t for i, t in enumerate(self_ns(spans)) if not _in_sync(spans, i))


def attr_sum(spans, name: str, key) -> float:
    """Sum over the spans called `name` of key(attrs)."""
    return sum(key(s.attrs) for s in spans if s.name == name)
