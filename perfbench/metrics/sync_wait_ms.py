"""The program's host time blocked in device-to-host reads, per unit: the
`hode.sync.*` spans (units as `dispatch_ms`)."""

from perfbench.span_log import spans_of, sync_ns, units


def read(run):
    spans = spans_of(run)
    n = units(run) if spans else 0
    return 1e-6 * sync_ns(spans) / n if n else None
