"""Adaptive explicit Runge-Kutta integration with per-sample step control.

Port of `hybrid_ode_tpu/solvers/explicit.py`. The JAX package integrates one
trajectory and vmaps it; here batching is written out: y0 (..., n), ts (T,)
or (..., T), and every sample keeps its own clock, step size, done flag,
initial step and `StepStats`, with masks where the JAX code has per-sample
control flow. The field receives per-sample times (...).

* mode='scan': exactly `max_steps_per_interval` masked trial steps per
  output interval, differentiable; each interval is checkpointed, so
  autograd keeps O(T) interval ends instead of O(T * max_steps) stages.
  No host synchronisation.
* mode='while': trial steps until every sample has reached the interval's
  end or taken the budget. Testing that costs one device-to-host
  synchronisation per trial step (counted in `host_syncs`).

Under a profiler, a solve is a `hode.solve` span (attributes `trial_steps`,
the loop's trial steps over all intervals; `lanes`, the samples; and
`live_steps`, the trial steps of samples not yet done, summed over samples),
each batched field evaluation a `hode.solve.field` span, and each host read
of the flags a `hode.sync.solver` span (`utils/profiling.py`).

The controller's decisions are detached: the solution depends on them only
through discretisation error (kept below tolerance), and differentiating
err^(-1/(q+1)) overflows f32 near err=0.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from hybrid_ode_torch.solvers.tableaus import ERKTableau
from hybrid_ode_torch.utils.profiling import recording, set_attr, span

# Controller constants (Hairer's recommended defaults).
SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0

#: device-to-host synchronisations taken by the adaptive solvers' exit tests
#: (while mode, the batch-synchronised mesh search, the backsolve adjoint)
host_syncs = 0


class StepStats(NamedTuple):
    n_accepted: torch.Tensor  # total accepted steps, per sample (...)
    n_rejected: torch.Tensor  # total rejected steps, per sample (...)
    success: torch.Tensor     # bool: every interval reached its endpoint


def host_flags(*flags: torch.Tensor) -> List[bool]:
    """Read device booleans on the host in one synchronisation."""
    global host_syncs
    host_syncs += 1
    stacked = torch.stack([f.reshape(()) for f in flags])
    with span("hode.sync.solver"):
        values = stacked.tolist()
    return [bool(v) for v in values]


def field_spans(f: Callable) -> Callable:
    """The field f with each call timed as a `hode.solve.field` span."""

    def field(t, y, args):
        with span("hode.solve.field"):
            return f(t, y, args)

    return field


def _effective_tols(rtol: float, atol: float, dtype: torch.dtype) -> Tuple[float, float]:
    """Clamp tolerances to what the dtype can express: f32 cannot honour
    rtol=1e-6 (below ~100 eps the controller would stall rejecting steps),
    f64 uses them as given."""
    fi = torch.finfo(dtype)
    return max(float(rtol), 100.0 * float(fi.eps)), max(float(atol), 10.0 * float(fi.tiny))


def combine(weights: Sequence[float], ks: Sequence[torch.Tensor],
            skip_zeros: bool = True) -> torch.Tensor:
    """sum_j weights[j] * ks[j], left to right, without a matmul (no TF32)."""
    acc = None
    for w, k in zip(weights, ks):
        if skip_zeros and w == 0.0:
            continue
        term = float(w) * k
        acc = term if acc is None else acc + term
    return acc


def _error_norm(tab: ERKTableau, ks: Sequence[torch.Tensor], h: torch.Tensor, y0: torch.Tensor,
                y1: torch.Tensor, rtol: float, atol: float, norm_weights=None) -> torch.Tensor:
    """RMS error norm over the state axis, per sample; accept when <= 1.

    norm_weights: optional (n,) component weights turning the norm into a
    seminorm: zero-weighted components do not drive step control (Kidger,
    Chen & Lyons 2021; the backsolve adjoint excludes its parameter
    integrals this way)."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    n = y0.shape[-1]
    if norm_weights is None:
        w, w_total = None, float(n)
    else:
        w = torch.as_tensor(norm_weights, dtype=y0.dtype, device=y0.device)
        w_total = torch.clamp(w.sum(), min=1.0)
    if tab.err_weights_low is None:
        err = h[..., None] * combine(tab.err_weights, ks, skip_zeros=False)
        sq = (err / scale) ** 2
        if w is not None:
            sq = sq * w
        return torch.sqrt(sq.sum(-1) / w_total)
    # DOP853: err = err5 * |err5| / sqrt(|err5|^2 + 0.01 |err3|^2)
    v5 = combine(tab.err_weights, ks, skip_zeros=False) / scale
    v3 = combine(tab.err_weights_low, ks, skip_zeros=False) / scale
    if w is not None:
        n5, n3 = (w * v5 * v5).sum(-1), (w * v3 * v3).sum(-1)
    else:
        n5, n3 = (v5 * v5).sum(-1), (v3 * v3).sum(-1)
    denom = n5 + 0.01 * n3
    safe = torch.sqrt(torch.clamp(denom * w_total, min=torch.finfo(y0.dtype).tiny))
    return torch.where(denom > 0, h.abs() * n5 / safe, torch.zeros_like(h))


def make_erk_step(f: Callable, tab: ERKTableau, rtol: float, atol: float,
                  norm_weights=None) -> Callable:
    """One trial step: (t, y, fy, h, args) -> (y1, f1, err_norm), with t, h
    per sample (...) or shared (0-d). Zero tableau entries are skipped."""
    s = len(tab.b)
    a, c = tab.a, tab.c
    has_extra_stage = len(tab.err_weights) == s + 1

    def step(t, y, fy, h, args):
        hv = h[..., None]
        ks = [fy]
        for i in range(1, s):
            yi = y + hv * combine(a[i, :i], ks)
            ks.append(f(t + float(c[i]) * h, yi, args))
        y1 = y + hv * combine(tab.b, ks)
        if has_extra_stage:
            f1 = f(t + h, y1, args)
            ks.append(f1)
        else:
            f1 = ks[-1]  # FSAL: the final stage was evaluated at (t+h, y1)
        return y1, f1, _error_norm(tab, ks, h, y, y1, rtol, atol, norm_weights)

    return step


def _controller_factor(err_norm: torch.Tensor, accepted: torch.Tensor, error_order: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """Step-size update factor (detached; see the module docstring)."""
    expo = 1.0 / (error_order + 1.0)
    safe_err = torch.clamp(err_norm.detach(), min=torch.finfo(dtype).tiny)
    factor = torch.clamp(SAFETY * safe_err ** (-expo), MIN_FACTOR, MAX_FACTOR)
    # after a rejection never grow the step
    return torch.where(accepted, factor, torch.clamp(factor, max=1.0))


@torch.no_grad()
def initial_step_size(f, t0, y0, f0, args, error_order, rtol, atol) -> torch.Tensor:
    """Hairer-style automatic initial step per sample (one extra f eval)."""
    dtype = y0.dtype
    ftiny = torch.finfo(dtype).tiny
    scale = atol + rtol * y0.abs()
    d0 = torch.sqrt(torch.mean((y0 / scale) ** 2, -1))
    d1 = torch.sqrt(torch.mean((f0 / scale) ** 2, -1))
    tiny = y0.new_full((), 1e-6)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), tiny, 0.01 * d0 / torch.clamp(d1, min=ftiny))
    y1 = y0 + h0[..., None] * f0
    f1 = f(t0 + h0, y1, args)
    d2 = torch.sqrt(torch.mean(((f1 - f0) / scale) ** 2, -1)) / h0
    expo = 1.0 / (error_order + 1.0)
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.maximum(tiny, h0 * 1e-3),
                     (0.01 / torch.clamp(dmax, min=ftiny)) ** expo)
    return torch.minimum(100.0 * h0, h1)


def _interval(step, t0, t1, y0, fy0, h0, args, max_steps, error_order, stop_early):
    """Adaptive steps across [t0, t1]: up to `max_steps` masked trial steps
    per sample; a sample that has reached t1 is held fixed. Scan mode runs
    all of them (reverse-mode differentiable, no host sync); while mode
    (stop_early) stops once every sample is done, testing that on the host
    before each trial step. The two give the same result. Also returns the
    number of trial steps taken."""
    dtype = y0.dtype
    t, y, fy, h = t0, y0, fy0, h0
    done = torch.zeros(t0.shape, dtype=torch.bool, device=y0.device)
    nacc = torch.zeros(t0.shape, dtype=torch.int32, device=y0.device)
    nrej = torch.zeros_like(nacc)
    trials = 0
    for _ in range(max_steps):
        if stop_early and not host_flags((~done).any())[0]:
            break
        trials += 1
        remaining = t1 - t
        at_end = h >= remaining
        h_eff = torch.minimum(h, remaining)
        y1, f1, errn = step(t, y, fy, h_eff, args)
        accept = errn <= 1.0
        move = accept & ~done
        t = torch.where(move, torch.where(at_end, t1, t + h_eff), t)
        y = torch.where(move[..., None], y1, y)
        fy = torch.where(move[..., None], f1, fy)
        factor = _controller_factor(errn, accept, error_order, dtype)
        cand = h_eff * factor
        # a step clipped to the endpoint must not drag the natural step down
        h_cand = torch.where(accept & at_end, torch.maximum(h, cand), cand)
        h = torch.where(done, h, h_cand)
        nacc = nacc + move.to(torch.int32)
        nrej = nrej + (~accept & ~done).to(torch.int32)
        done = done | (move & at_end)
    return y, fy, h, done, nacc, nrej, trials


def _grid(y0: torch.Tensor, ts) -> torch.Tensor:
    """Output times (T,) or (..., T) as per-sample grids (..., T) of y0's dtype."""
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    return ts.expand(*y0.shape[:-1], ts.shape[-1])


def _intervals(one_interval, ts, carry, mode, checkpoint_intervals):
    """Run `one_interval(t0, t1, *carry) -> (*carry, y, done, nacc, nrej)`
    over the output grid; scan mode checkpoints each interval under autograd.
    Returns the interval ends' ys and the per-interval done / nacc / nrej."""
    ys, dones, naccs, nrejs = [], [], [], []
    k = len(carry)
    for i in range(ts.shape[-1] - 1):
        t0, t1 = ts[..., i], ts[..., i + 1]
        if mode == "scan" and checkpoint_intervals and torch.is_grad_enabled():
            out = checkpoint(one_interval, t0, t1, *carry, use_reentrant=False)
        else:
            out = one_interval(t0, t1, *carry)
        carry = out[:k]
        y, done, nacc, nrej = out[k:]
        ys.append(y)
        dones.append(done)
        naccs.append(nacc)
        nrejs.append(nrej)
    return ys, dones, naccs, nrejs


def _finish(y0, ys, dones, naccs, nrejs, return_stats):
    """ys (..., T, n) with y0 first, and with return_stats per-sample StepStats."""
    ys_full = torch.stack([y0] + ys, dim=-2)
    if return_stats:
        return ys_full, StepStats(n_accepted=torch.stack(naccs).sum(0, dtype=torch.int32),
                                  n_rejected=torch.stack(nrejs).sum(0, dtype=torch.int32),
                                  success=torch.stack(dones).all(0))
    return ys_full


def odeint_adaptive(f: Callable, y0: torch.Tensor, ts, args: Any, step: Callable,
                    error_order: int, rtol_e: float, atol_e: float, mode: str,
                    max_steps_per_interval: int, checkpoint_intervals: bool,
                    return_stats: bool):
    """The one-step drivers' shared loop: `step(t, y, fy, h, args) -> (y1,
    f1, err_norm)` (an explicit RK step or a Radau step) over every output
    interval with `_interval`, from the automatic initial step; one
    `hode.solve` span."""
    if mode not in ("scan", "while"):
        raise ValueError(f"unknown mode: {mode!r}")
    with span("hode.solve", lanes=y0.numel() // y0.shape[-1]):
        ts = _grid(y0, ts)
        f0 = f(ts[..., 0], y0, args)
        h = initial_step_size(f, ts[..., 0], y0, f0, args, error_order, rtol_e, atol_e)
        trials = 0

        def interval(t0, t1, y, fy, h):
            nonlocal trials
            y1, f1, h1, done, nacc, nrej, k = _interval(step, t0, t1, y, fy, h, args,
                                                        max_steps_per_interval, error_order,
                                                        stop_early=mode == "while")
            trials += k
            return y1, f1, h1, y1, done, nacc, nrej

        out = _intervals(interval, ts, (y0, f0, h), mode, checkpoint_intervals)
        if recording():
            _, _, naccs, nrejs = out
            set_attr(trial_steps=trials, live_steps=torch.stack(naccs + nrejs).sum())
        return _finish(y0, *out, return_stats)


def odeint_erk(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    tab: ERKTableau,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    mode: str = "scan",
    max_steps_per_interval: int = 32,
    checkpoint_intervals: bool = True,
    return_stats: bool = False,
    norm_weights: Optional[torch.Tensor] = None,
):
    """Integrate dy/dt = f(t, y, args) and report y at every output time.

    y0 (..., n); ts (T,) shared or (..., T) per sample, strictly increasing.
    Returns ys (..., T, n) with ys[..., 0, :] = y0, and with return_stats
    per-sample StepStats of shape (...)."""
    rtol_e, atol_e = _effective_tols(rtol, atol, y0.dtype)
    f = field_spans(f)
    step = make_erk_step(f, tab, rtol_e, atol_e, norm_weights)
    return odeint_adaptive(f, y0, ts, args, step, tab.error_order, rtol_e, atol_e, mode,
                           max_steps_per_interval, checkpoint_intervals, return_stats)
