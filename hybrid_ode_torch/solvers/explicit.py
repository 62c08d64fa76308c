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

An explicit RK solve in while mode on a CUDA device with autograd off
(`graph_route`) replays each trial step as one CUDA graph (`TrialGraph`)
instead of launching its few hundred operations one by one: the same
operations on the same data, so the same results bit for bit. The graph
reads its inputs (the field's and the args' tensors) from static copies made
once a solve, so one graph serves every solve of the same field, tableau,
tolerances and shapes; `MAX_GRAPHS` are kept. Counters `graph_captures` and
`graph_replays` say how often it engages.

Under a profiler, a solve is a `hode.solve` span (attributes `trial_steps`,
the loop's trial steps over all intervals; `lanes`, the samples; and
`live_steps`, the trial steps of samples not yet done, summed over samples),
each batched field evaluation a `hode.solve.field` span (a graph's replay
calls no field, so records none), and each host read of the flags a
`hode.sync.solver` span (`utils/profiling.py`).

The controller's decisions are detached: the solution depends on them only
through discretisation error (kept below tolerance), and differentiating
err^(-1/(q+1)) overflows f32 near err=0.
"""

from __future__ import annotations

import types
from collections import OrderedDict
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
#: trial-step graphs captured, and trial steps run by replaying one
graph_captures = 0
graph_replays = 0
#: trial-step graphs kept per process, the least recently used dropped first
MAX_GRAPHS = 4


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


def _trial(step, t1, t, y, fy, h, done, nacc, nrej, args, error_order, out=(None,) * 7):
    """One masked trial step towards t1: the carry (t, y, fy, h, done, nacc,
    nrej) after it. `out` names the tensors that receive the new carry, in
    that order (the graph route passes the carry itself: no input is read
    after it is written); by default each is a new tensor."""
    o_t, o_y, o_fy, o_h, o_done, o_nacc, o_nrej = out
    remaining = t1 - t
    at_end = h >= remaining
    h_eff = torch.minimum(h, remaining)
    y1, f1, errn = step(t, y, fy, h_eff, args)
    accept = errn <= 1.0
    move = accept & ~done
    t = torch.where(move, torch.where(at_end, t1, t + h_eff), t, out=o_t)
    y = torch.where(move[..., None], y1, y, out=o_y)
    fy = torch.where(move[..., None], f1, fy, out=o_fy)
    factor = _controller_factor(errn, accept, error_order, y.dtype)
    cand = h_eff * factor
    # a step clipped to the endpoint must not drag the natural step down
    h_cand = torch.where(accept & at_end, torch.maximum(h, cand), cand)
    h = torch.where(done, h, h_cand, out=o_h)
    nacc = torch.add(nacc, move.to(torch.int32), out=o_nacc)
    nrej = torch.add(nrej, (~accept & ~done).to(torch.int32), out=o_nrej)
    done = torch.bitwise_or(done, move & at_end, out=o_done)
    return t, y, fy, h, done, nacc, nrej


def _interval(step, t0, t1, y0, fy0, h0, args, max_steps, error_order, stop_early):
    """Adaptive steps across [t0, t1]: up to `max_steps` masked trial steps
    per sample; a sample that has reached t1 is held fixed. Scan mode runs
    all of them (reverse-mode differentiable, no host sync); while mode
    (stop_early) stops once every sample is done, testing that on the host
    before each trial step. The two give the same result. Also returns the
    number of trial steps taken."""
    t, y, fy, h = t0, y0, fy0, h0
    done = torch.zeros(t0.shape, dtype=torch.bool, device=y0.device)
    nacc = torch.zeros(t0.shape, dtype=torch.int32, device=y0.device)
    nrej = torch.zeros_like(nacc)
    trials = 0
    for _ in range(max_steps):
        if stop_early and not host_flags((~done).any())[0]:
            break
        trials += 1
        t, y, fy, h, done, nacc, nrej = _trial(step, t1, t, y, fy, h, done, nacc, nrej, args,
                                               error_order)
    return y, fy, h, done, nacc, nrej, trials


def graph_route(device: torch.device, mode: str) -> bool:
    """Whether an explicit RK solve replays its trial steps as a CUDA graph:
    in while mode, on a CUDA device, with autograd off. Every other solve
    (the CPU, scan mode, training, the implicit steps) runs them eagerly."""
    return device.type == "cuda" and mode == "while" and not torch.is_grad_enabled()


class _Same:
    """A key part that compares its object by identity (and keeps it alive)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj


def _parts(x, device, leaves: list):
    """x's structure as a hashable key, with its tensors on `device`
    appended to `leaves`: they flow into a graph as inputs. Walks tuples,
    lists, dicts and functions' closures; a tensor elsewhere is a constant,
    keyed by its values; any other object by value, else by identity."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            return (x.dtype, tuple(x.shape), tuple(x.flatten().tolist()))
        leaves.append(x)
        return (x.dtype, tuple(x.shape), x.stride(), x.requires_grad)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_parts(v, device, leaves) for v in x))
    if isinstance(x, dict):
        return (type(x), tuple((k, _parts(v, device, leaves)) for k, v in x.items()))
    if isinstance(x, types.FunctionType):
        return (x.__code__, _parts(x.__defaults__, device, leaves),
                tuple(_parts(c.cell_contents, device, leaves) for c in x.__closure__ or ()))
    try:
        hash(x)
        return x
    except TypeError:
        return _Same(x)


def _swap(x, device, leaves):
    """x with the tensors that `_parts` collected taken in turn from the
    iterator `leaves`."""
    if isinstance(x, torch.Tensor):
        return next(leaves) if x.device == device else x
    if isinstance(x, tuple):
        vals = [_swap(v, device, leaves) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    if isinstance(x, list):
        return type(x)(_swap(v, device, leaves) for v in x)
    if isinstance(x, dict):
        return type(x)((k, _swap(v, device, leaves)) for k, v in x.items())
    if isinstance(x, types.FunctionType):
        defaults = _swap(x.__defaults__, device, leaves)
        cells = tuple(types.CellType(_swap(c.cell_contents, device, leaves))
                      for c in x.__closure__ or ())
        g = types.FunctionType(x.__code__, x.__globals__, x.__name__, defaults, cells or None)
        g.__kwdefaults__ = x.__kwdefaults__
        return g
    return x


def _static(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of x's shape, strides, dtype and device that
    requires grad where x does (a field that differentiates inside, as the
    backsolve adjoint's does, accumulates its gradients in an order that
    depends on it)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device).requires_grad_(x.requires_grad)


def _load(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy src into its static twin dst; a dimension of stride 0 (an
    expanded leaf) is copied once."""
    size = [n if st else 1 for n, st in zip(src.shape, src.stride())]
    dst.as_strided(size, dst.stride()).copy_(src.as_strided(size, src.stride()))


def _capture(body: Callable[[], None], device: torch.device):
    """Run body once on a side stream (the warm-up: a real trial step), then
    capture it as a CUDA graph on that stream without running it."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        body()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        body()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph


class TrialGraph:
    """One trial step of `_interval`'s while loop as a CUDA graph.

    The step reads and writes its carry (t, y, fy, h, done, nacc, nrej) and
    the interval's end t1 in static buffers, in place, so that replays chain;
    it reads the field's and the args' tensors from static copies (`inputs`),
    refilled by `load` once a solve. Captured at the first trial step it
    runs (after a warm-up that is that step)."""

    def __init__(self, f: Callable, tab: ERKTableau, rtol: float, atol: float,
                 norm_weights, y0: torch.Tensor, args: Any, leaves: List[torch.Tensor]):
        dev = y0.device
        self.device, self.error_order = dev, tab.error_order
        self.inputs = [_static(x) for x in leaves]
        it = iter(self.inputs)
        field, self.args = _swap(f, dev, it), _swap(args, dev, it)
        if norm_weights is not None:
            norm_weights = torch.as_tensor(norm_weights, dtype=y0.dtype, device=dev)
        self.step_fn = make_erk_step(field_spans(field), tab, rtol, atol, norm_weights)
        batch = y0.shape[:-1]
        self.y, self.fy = torch.empty_like(y0), torch.empty_like(y0)
        self.t, self.t1, self.h = (y0.new_empty(batch) for _ in range(3))
        self.done = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.nacc = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.nrej = torch.zeros_like(self.nacc)
        self.graph = None

    def load(self, leaves: List[torch.Tensor]) -> None:
        for dst, src in zip(self.inputs, leaves):
            _load(dst, src)

    def _body(self) -> None:
        carry = (self.t, self.y, self.fy, self.h, self.done, self.nacc, self.nrej)
        _trial(self.step_fn, self.t1, *carry, self.args, self.error_order, out=carry)

    def step(self) -> None:
        global graph_captures, graph_replays
        if self.graph is None:
            self.graph = _capture(self._body, self.device)
            graph_captures += 1
        else:
            self.graph.replay()
            graph_replays += 1

    def interval(self, t0, t1, y, fy, h, max_steps: int):
        """`_interval` in while mode: (carry y, fy, h, then the interval's
        y, done, nacc, nrej as copies, and its trial steps). The carry is
        the graph's own buffers, loaded from y, fy, h at a solve's start."""
        if y is not self.y:
            self.y.copy_(y)
            self.fy.copy_(fy)
            self.h.copy_(h)
        self.t.copy_(t0)
        self.t1.copy_(t1)
        self.done.zero_()
        self.nacc.zero_()
        self.nrej.zero_()
        k = 0
        while k < max_steps and host_flags((~self.done).any())[0]:
            self.step()
            k += 1
        return (self.y, self.fy, self.h, self.y.clone(), self.done.clone(), self.nacc.clone(),
                self.nrej.clone(), k)


_GRAPHS: "OrderedDict[Any, TrialGraph]" = OrderedDict()


def trial_graph(f: Callable, tab: ERKTableau, rtol: float, atol: float, norm_weights,
                y0: torch.Tensor, args: Any) -> TrialGraph:
    """The trial-step graph of this field, tableau, tolerances and shapes,
    its inputs loaded from f's closure and args; made (capture deferred to
    its first step) where none is kept. Inference mode keys it too: buffers
    made there cannot be written outside it."""
    leaves: List[torch.Tensor] = []
    nw = None if norm_weights is None else tuple(
        torch.as_tensor(norm_weights).flatten().tolist())
    key = (_parts(f, y0.device, leaves), _parts(args, y0.device, leaves), _Same(tab), rtol,
           atol, nw, y0.dtype, tuple(y0.shape), y0.stride(), y0.device,
           torch.is_inference_mode_enabled())
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        graph = TrialGraph(f, tab, rtol, atol, norm_weights, y0, args, leaves)
        while len(_GRAPHS) >= MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    _GRAPHS[key] = graph
    graph.load(leaves)
    return graph


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
                    return_stats: bool, graph: Optional[TrialGraph] = None):
    """The one-step drivers' shared loop: `step(t, y, fy, h, args) -> (y1,
    f1, err_norm)` (an explicit RK step or a Radau step) over every output
    interval with `_interval`, or with `graph`'s replays of that step, from
    the automatic initial step; one `hode.solve` span."""
    if mode not in ("scan", "while"):
        raise ValueError(f"unknown mode: {mode!r}")
    with span("hode.solve", lanes=y0.numel() // y0.shape[-1]):
        ts = _grid(y0, ts)
        f0 = f(ts[..., 0], y0, args)
        h = initial_step_size(f, ts[..., 0], y0, f0, args, error_order, rtol_e, atol_e)
        trials = 0

        def interval(t0, t1, y, fy, h):
            nonlocal trials
            if graph is not None:
                *out, k = graph.interval(t0, t1, y, fy, h, max_steps_per_interval)
                trials += k
                return tuple(out)
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
    graph = None
    if graph_route(y0.device, mode):
        graph = trial_graph(f, tab, rtol_e, atol_e, norm_weights, y0, args)
    f = field_spans(f)
    step = make_erk_step(f, tab, rtol_e, atol_e, norm_weights)
    return odeint_adaptive(f, y0, ts, args, step, tab.error_order, rtol_e, atol_e, mode,
                           max_steps_per_interval, checkpoint_intervals, return_stats, graph)
