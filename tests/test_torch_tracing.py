"""The port's spans and counters (`hybrid_ode_torch/utils/profiling.py`) and
the benchmark's metrics that read them (`perfbench/span_log.py`,
`perfbench/metrics/`), on the CPU.

Without a profiler a span records nothing and opens no `record_function`.
Under a CPU `torch.profiler` session each span is one of the profiler's
events, with its name, its nesting and its times within 1 ms. The solve's
and the NUTS transition's attributes equal what their returned statistics
say; tracing changes no output and no counter. Self time and the
`dispatch_ms` / `sync_wait_ms` arithmetic are checked on a synthetic log,
and every new reader gives None on an untraced run.
"""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hybrid_ode_torch.inference import mcmc
from hybrid_ode_torch.models.hybrid import HybridConfig, init_hybrid_params
from hybrid_ode_torch.solvers import explicit
from hybrid_ode_torch.solvers.api import odeint
from hybrid_ode_torch.train.loop import TrainState, make_optimizer, make_train_step
from hybrid_ode_torch.utils import profiling
from perfbench import harness, span_log

torch.set_num_threads(2)

READERS = ("dispatch_ms", "sync_wait_ms", "launches_per_field_eval", "lane_use_pct",
           "chain_use_pct")


def _profiled(fn):
    """fn() under a CPU profiler: (its result, the profiler, the span log).
    A span first finds the profiler off, as the program's spans between two
    windows do, so that the window starts a new log."""
    with profiling.span("hode.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, profiling.spans()


def _decay(t, y, k):
    return -k * y * (1.0 + 0.5 * torch.sin(3.0 * t))[..., None]


def _solve(solver="dopri5", mode="while"):
    """Five samples of rates 0.1 to 20: their step counts differ."""
    y0 = 0.5 + torch.rand((5, 3), generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64)
    k = torch.tensor([[0.1], [0.5], [2.0], [8.0], [20.0]], dtype=torch.float64)
    ts = torch.linspace(0.0, 2.0, 7, dtype=torch.float64)
    return odeint(_decay, y0, ts, k, solver=solver, mode=mode, rtol=1e-6, atol=1e-9,
                  max_steps_per_interval=12, return_stats=True)


def _gaussian(q):
    scale = torch.tensor([1.0, 4.0, 0.25], dtype=q.dtype)
    return -0.5 * (q * q * scale).sum(-1), -q * scale


def _transition(seed=0):
    gen = torch.Generator().manual_seed(seed)
    q0 = torch.randn((6, 3), generator=gen, dtype=torch.float64)
    eps = torch.tensor([0.05, 0.2, 0.5, 0.9, 1.3, 0.3], dtype=torch.float64)
    return mcmc._nuts_step(_gaussian, q0, mcmc.TorchDraws(torch.Generator().manual_seed(seed + 1)),
                           eps, torch.ones(3, dtype=torch.float64), 5)


def _train_step():
    config = HybridConfig(solver="rk4", substeps=2, nn_hidden=8, nn_layers=2, use_pallas=True,
                          context_points=3)
    gen = torch.Generator().manual_seed(0)
    params = init_hybrid_params(gen, config, device="cpu")
    for leaves in params.values():
        for t in leaves.values():
            t.requires_grad_(True)
    B, T = 4, 9
    ts = torch.linspace(0.0, 2.0, T).expand(B, T)
    y0 = torch.tensor([5.0, 20.0, 60.0, 10.0, 0.0, 0.5]).expand(B, 6)
    batch = {"initial_state": y0, "observations": y0[:, None, :] * (1.0 + 0.01 * ts[..., None]),
             "time_points": ts, "mask": torch.ones(B, T),
             "external_inputs": {"meal": torch.zeros(B, T), "tVNS": torch.zeros(B, T)}}
    opt = make_optimizer(1e-3, 1, 10, gradient_clip=1e-3).bind(params)
    step = make_train_step(opt, config, 1.0, 0.01, True)
    return lambda: step(TrainState(params), batch, torch.Generator().manual_seed(1))


def test_without_a_profiler_spans_record_nothing(monkeypatch):
    _profiled(_solve)
    before = profiling.spans()
    opened = []
    monkeypatch.setattr(profiling._profiler, "record_function",
                        lambda name: opened.append(name))
    assert not profiling.recording()
    assert profiling.span("hode.x", n=1) is profiling.span("hode.y")
    _solve()
    _transition()
    profiling.set_attr(n=2)
    assert opened == [] and profiling.spans() == before


def test_each_span_is_a_profiler_event_with_its_nesting_and_times():
    _profiled(_train_step())  # the first record_function loads the profiler's ops
    _, prof, spans = _profiled(_train_step())
    names = [s.name for s in spans]
    assert names[0] == "hode.train.step" and spans[0].parent == -1
    parent = {s.name: (names[s.parent] if s.parent >= 0 else None) for s in spans}
    assert parent["hode.train.loss"] == parent["hode.train.backward"] == "hode.train.step"
    assert parent["hode.forward.encode"] == parent["hode.forward.fused"] == "hode.train.loss"
    assert parent["hode.train.clip"] == parent["hode.train.adam"] == "hode.train.step"
    assert parent["hode.sync.clip"] == "hode.train.clip"
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name.startswith("hode.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == names
    by_id = {e.id: e for e in events}
    for e, s in zip(events, spans):
        assert abs(t0 + 1000 * e.time_range.start - s.start_ns) < 1e6
        assert abs(t0 + 1000 * e.time_range.end - s.end_ns) < 1e6
        up = e.cpu_parent
        while up is not None and up.id not in by_id:
            up = up.cpu_parent
        assert (up.name if up is not None else None) == parent[s.name]


def test_a_new_session_clears_the_log_and_a_full_log_counts_its_drops(monkeypatch, tmp_path):
    def three():
        for _ in range(3):
            with profiling.span("hode.a"):
                pass

    _profiled(three)
    assert [s.name for s in profiling.spans()] == ["hode.a"] * 3
    with profiling.trace(str(tmp_path)):  # a window straight after another
        three()
    assert [s.name for s in profiling.spans()] == ["hode.a"] * 3
    with profile(activities=[ProfilerActivity.CPU]):  # and torch's, after it
        three()
    assert [s.name for s in profiling.spans()] == ["hode.a"] * 6
    monkeypatch.setattr(profiling, "LOG_CAP", 2)

    def spans_in_spans():
        with profiling.span("hode.b"):
            with profiling.span("hode.c"):
                with profiling.span("hode.d"):
                    pass

    _, _, spans = _profiled(spans_in_spans)
    assert [(s.name, s.parent) for s in spans] == [("hode.b", -1), ("hode.c", 0)]
    assert profiling.dropped_spans() == 1


def _log(*rows):
    return [profiling.Span(n, a, b, p, {}) for n, a, b, p in rows]


def test_self_time_and_the_dispatch_and_sync_arithmetic():
    spans = _log(("hode.solve", 0, 100, -1), ("hode.solve.field", 10, 30, 0),
                 ("hode.sync.solver", 40, 70, 0), ("hode.solve.field", 75, 80, 0),
                 ("hode.nuts.grad", 200, 260, -1), ("hode.sync.nuts", 210, 250, 4),
                 ("hode.sync.solver", 300, 310, -1))
    assert span_log.self_ns(spans) == [100 - 20 - 30 - 5, 20, 30, 5, 20, 40, 10]
    assert span_log.sync_ns(spans) == 30 + 40 + 10
    assert span_log.dispatch_ns(spans) == (100 + 60 + 10) - (30 + 40 + 10)
    run = SimpleNamespace(trace=SimpleNamespace(units=2, counters={}))
    assert span_log.units(run) == 2
    run.trace.counters["grad_calls"] = 128  # NUTS: the unit is a gradient call
    assert span_log.units(run) == 128


def _read(name, run):
    return harness._load(harness.reader_path(name), "m_" + name.replace(".", "_")).read(run)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_on_an_untraced_run(name):
    run = SimpleNamespace(trace=None)
    assert _read(name, run) is None


def test_the_readers_on_a_traced_solve_and_transition(monkeypatch):
    (_, stats), _, spans = _profiled(_solve)
    run = SimpleNamespace(trace=SimpleNamespace(units=1, launches=1000, counters={}))
    assert _read("dispatch_ms.eager", run) == pytest.approx(
        1e-6 * span_log.dispatch_ns(spans))
    assert _read("sync_wait_ms.eager", run) == pytest.approx(1e-6 * span_log.sync_ns(spans))
    solve = [s for s in spans if s.name == "hode.solve"][0]
    fields = sum(s.name == "hode.solve.field" for s in spans)
    assert _read("launches_per_field_eval.eager", run) == pytest.approx(1000 / fields)
    live = int((stats.n_accepted + stats.n_rejected).sum())
    assert _read("lane_use_pct.eager", run) == pytest.approx(
        100.0 * live / (solve.attrs["trial_steps"] * 5))
    calls = mcmc.grad_evals
    (_, _, n_lf, _), _, spans = _profiled(_transition)
    run.trace.counters["grad_calls"] = calls = mcmc.grad_evals - calls
    assert calls == sum(s.name == "hode.nuts.grad" for s in spans) > 1
    assert _read("chain_use_pct.nuts", run) == pytest.approx(
        100.0 * int(n_lf.sum()) / (int(n_lf.max()) * 6))
    assert _read("dispatch_ms.nuts", run) == pytest.approx(
        1e-6 * span_log.dispatch_ns(spans) / calls)
    assert _read("sync_wait_ms.nuts", run) == pytest.approx(1e-6 * span_log.sync_ns(spans) / calls)


@pytest.mark.parametrize("solver,mode", [("dopri5", "while"), ("dopri5", "scan"),
                                         ("radau", "while")])
def test_the_solve_span_counts_its_trial_steps_and_live_lanes(solver, mode):
    (_, stats), _, spans = _profiled(lambda: _solve(solver, mode))
    solve = [s for s in spans if s.name == "hode.solve"]
    assert len(solve) == 1 and solve[0].attrs["lanes"] == 5
    assert solve[0].attrs["live_steps"] == int((stats.n_accepted + stats.n_rejected).sum())
    fields = sum(s.name == "hode.solve.field" for s in spans)
    per_step = 6 if solver == "dopri5" else NEWTON_CALLS
    assert solve[0].attrs["trial_steps"] == (fields - 2) // per_step
    assert (fields - 2) % per_step == 0
    if mode == "scan":
        assert solve[0].attrs["trial_steps"] == 12 * 6
    syncs = [s for s in spans if s.name == "hode.sync.solver"]
    assert all(spans[s.parent].name == "hode.solve" for s in syncs)
    assert len(syncs) >= solve[0].attrs["trial_steps"] if mode == "while" else not syncs


# a Radau trial step: the Jacobian, one stage evaluation per Newton iteration
# and one after them
NEWTON_CALLS = 1 + __import__("hybrid_ode_torch.solvers.implicit",
                              fromlist=["NEWTON_ITERS"]).NEWTON_ITERS + 1


def test_the_transition_span_counts_its_iterations_and_chain_leapfrogs():
    (_, _, n_lf, _), _, spans = _profiled(_transition)
    tr = [s for s in spans if s.name == "hode.nuts.transition"]
    assert len(tr) == 1 and tr[0].attrs["chains"] == 6
    assert tr[0].attrs["chain_leapfrogs"] == int(n_lf.sum())
    assert tr[0].attrs["iterations"] == int(n_lf.max())
    assert int(n_lf.min()) < int(n_lf.max())  # chains that finished early
    grads = [s for s in spans if s.name == "hode.nuts.grad"]
    assert len(grads) == 1 + tr[0].attrs["iterations"]
    assert all(s.parent == 0 for s in grads)
    syncs = sum(s.name == "hode.sync.nuts" for s in spans)
    assert syncs == tr[0].attrs["iterations"] + 1


def test_the_fused_posteriors_gradient_holds_its_noise_copy_as_a_sync():
    config = HybridConfig(solver="rk4", substeps=2, nn_hidden=8, nn_layers=2)
    params = init_hybrid_params(torch.Generator().manual_seed(0), config, device="cpu")
    B, T = 2, 5
    ts = torch.linspace(0.0, 2.0, T).expand(B, T)
    y0 = torch.tensor([5.0, 20.0, 60.0, 10.0, 0.0, 0.5]).expand(B, 6)
    batch = {"initial_state": y0, "observations": y0[:, None, :].expand(B, T, 6),
             "time_points": ts, "mask": torch.ones(B, T),
             "external_inputs": {"meal": torch.zeros(B, T), "tVNS": torch.zeros(B, T)}}
    post = mcmc.posterior(params, batch, config, engine="fused", noise_sigma=1.0)
    q0 = post.q0[None, :].repeat(3, 1)
    _, _, spans = _profiled(lambda: mcmc._nuts_step(
        post.logp_and_grad, q0, mcmc.TorchDraws(torch.Generator().manual_seed(2)),
        torch.full((3,), 1e-3), torch.ones(q0.shape[1]), 2))
    grads = [i for i, s in enumerate(spans) if s.name == "hode.nuts.grad"]
    copies = [s for s in spans if s.name == "hode.sync.copy"]
    assert len(copies) == len(grads) > 1
    assert sorted(s.parent for s in copies) == grads
    assert span_log.sync_ns(spans) == sum(s.end_ns - s.start_ns for s in spans
                                          if s.name.startswith("hode.sync."))


@pytest.mark.parametrize("work", ["solve", "transition", "train"])
def test_tracing_changes_no_output_and_no_counter(work):
    fn = {"solve": _solve, "transition": _transition, "train": None}[work]
    if fn is None:
        def fn():
            state, metrics = _train_step()()
            return [metrics["loss"], metrics["grad_norm"]] + [
                t.detach().clone() for leaves in state.params.values() for t in leaves.values()]
    before = profiling.counters()
    off = _tensors(fn())
    mid = profiling.counters()
    on, _, spans = _profiled(fn)
    after = profiling.counters()
    assert spans
    assert {k: mid[k] - before[k] for k in mid} == {k: after[k] - mid[k] for k in mid}
    on = _tensors(on)
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(off, on))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _tensors(item)]


def test_counters_name_every_program_counter_and_trace_writes_their_change(tmp_path):
    names = profiling.counters()
    assert set(names) == {"fused_rk4.fused_rk4_fwd_launches", "fused_rk4.fused_rk4_bwd_launches",
                          "fused_rk4.fused_rk4_bwd_vjp_launches",
                          "fused_rk4.fused_rk4_cluster_launches",
                          "fused_rk4.fused_rk4_cluster_narrow_launches",
                          "fused_rk4.fused_rk4_cluster_wide_launches", "explicit.host_syncs",
                          "explicit.graph_captures", "explicit.graph_replays",
                          "mcmc.host_syncs", "mcmc.grad_evals", "mcmc.transitions",
                          "online.adapt_steps", "online.subjects", "online.forecasts"}
    syncs = explicit.host_syncs
    with profiling.trace(str(tmp_path / "tr")):
        _solve()
        _transition()
    change = json.loads((tmp_path / "tr" / "counters.json").read_text())
    assert change["explicit.host_syncs"] == explicit.host_syncs - syncs > 0
    assert change["mcmc.transitions"] == 1 and change["mcmc.grad_evals"] > 1
    # the CPU runs the plain versions: no kernel launch, on either route
    assert change["fused_rk4.fused_rk4_cluster_launches"] == 0
    # and no CUDA graph: the CPU's solves run their trial steps eagerly
    assert change["explicit.graph_captures"] == change["explicit.graph_replays"] == 0
    assert (tmp_path / "tr" / "trace.json").read_text().count('"hode.solve"') == 1
