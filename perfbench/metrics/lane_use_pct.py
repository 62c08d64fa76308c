"""The adaptive solver's trial steps of samples not yet done over all its
trial steps of all samples, in %: 100 x sum(live_steps) / sum(trial_steps x
lanes) over the `hode.solve` spans."""

from perfbench.span_log import attr_sum, spans_of


def read(run):
    spans = spans_of(run)
    if not spans:
        return None
    total = attr_sum(spans, "hode.solve", lambda a: a.get("trial_steps", 0) * a.get("lanes", 0))
    live = attr_sum(spans, "hode.solve", lambda a: a.get("live_steps", 0))
    return 100.0 * live / total if total else None
