"""Which solves replay their trial steps as a CUDA graph, and the graph
route's plumbing on the CPU.

`explicit.graph_route` sends an explicit RK solve in while mode on a CUDA
device with autograd off to `explicit.TrialGraph`; everything else runs its
trial steps eagerly. The CPU has no graphs, so the plumbing tests replace
`explicit._capture` by a stand-in whose "capture" runs the body once (the
warm-up) and whose replay runs it again: what the route adds around the
graph (static inputs loaded once a solve, the carry in place, the interval's
copies, the cache and its key) is then held bitwise to the eager loop. The
card's own capture is held to it in `tests/test_torch_trial_graph.py`.
"""

from types import SimpleNamespace

import pytest
import torch

from hybrid_ode_torch.data.fourgi_gen import simulate_cohort
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models.hybrid import (
    batched_forward,
    config_from_dict,
    forward,
    init_hybrid_params,
)
from hybrid_ode_torch.solvers import explicit
from hybrid_ode_torch.solvers.api import odeint

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


def _fake_capture(body, device):
    body()  # the warm-up is the step's real run; the capture runs nothing
    return SimpleNamespace(replay=body)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graph route on CPU tensors, with the stand-in capture and an
    empty cache."""
    monkeypatch.setattr(explicit, "graph_route",
                        lambda device, mode: mode == "while" and not torch.is_grad_enabled())
    monkeypatch.setattr(explicit, "_capture", _fake_capture)
    monkeypatch.setattr(explicit, "_GRAPHS", type(explicit._GRAPHS)())


def _eager(fn):
    """fn() with the route's rule refusing every solve."""
    route = explicit.graph_route
    explicit.graph_route = lambda device, mode: False
    try:
        return fn()
    finally:
        explicit.graph_route = route


def _model(hidden=16, layers=2, use_nn=True, seed=0):
    cfg = config_from_dict({"model": {"nn_hidden": hidden, "nn_layers": layers,
                                      "solver": "dopri5", "mode": "while",
                                      "max_steps_per_interval": 8},
                            "ablation": {"no_nn": not use_nn}})
    params = init_hybrid_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k, w in params["nn"].items():  # the last layer starts at zero: give it weight
        params["nn"][k] = w + 0.05 * torch.randn(w.shape, generator=g)
    return cfg, params


def _batch(B=6, T=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    y0 = torch.tensor([8.0, 100.0, 90.0, 20.0, 0.0, 1.2]) * (
        1.0 + 0.2 * torch.rand(B, 6, generator=g))
    ts = torch.cumsum(0.2 + 0.3 * torch.rand(B, T, generator=g), -1)
    meal = 30.0 * torch.rand(B, T, generator=g) * (torch.rand(B, T, generator=g) < 0.3)
    tvns = torch.rand(B, T, generator=g)
    return y0, ts, Controls(ts=ts, signals={"meal": meal, "tVNS": tvns})


def _solve(cfg, params, batch):
    y0, ts, ctrl = batch
    with torch.no_grad():
        return batched_forward(params, y0, ts, ctrl, cfg, return_stats=True)


def _assert_same(a, b):
    (ya, sa), (yb, sb) = a, b
    assert torch.equal(ya, yb)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("device,mode,grad,taken", [
    (CUDA, "while", False, True),
    (CPU, "while", False, False),
    (CUDA, "scan", False, False),
    (CUDA, "while", True, False),
])
def test_graph_route_rule(device, mode, grad, taken):
    with torch.set_grad_enabled(grad):
        assert explicit.graph_route(device, mode) is taken


def test_cpu_solves_never_build_a_graph(monkeypatch):
    """With the real rule, CPU solves in either mode, with grad on or off,
    ask for no graph."""
    calls = []
    monkeypatch.setattr(explicit, "trial_graph", lambda *a: calls.append(a))
    cfg, params = _model()
    batch = _batch()
    _solve(cfg, params, batch)
    y0, ts, ctrl = batch
    batched_forward(params, y0, ts, ctrl, cfg, mode="scan")
    batched_forward(params, y0, ts, ctrl, cfg)
    assert calls == []


@pytest.mark.parametrize("solver", ["radau", "bdf", "bdf2"])
def test_implicit_steps_never_take_the_graph_route(monkeypatch, solver):
    """Radau and BDF run their own steps: even a rule that accepts every
    while solve builds no graph for them, while dopri5 under it does."""
    calls = []
    monkeypatch.setattr(explicit, "graph_route", lambda device, mode: True)
    monkeypatch.setattr(explicit, "trial_graph", lambda *a: calls.append(a))
    y0 = torch.ones(3, 2, dtype=torch.float64)
    ts = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    with torch.no_grad():
        ys = odeint(lambda t, y, a: a * y, y0, ts, torch.tensor(-1.0, dtype=torch.float64),
                    solver=solver, mode="while", rtol=1e-6, atol=1e-8)
    assert calls == [] and ys.shape == (3, 4, 2)
    with torch.no_grad():  # the stand-in returns no graph: the solve runs eagerly
        odeint(lambda t, y, a: a * y, y0, ts, torch.tensor(-1.0, dtype=torch.float64),
               solver="dopri5", mode="while")
    assert len(calls) == 1


@pytest.mark.parametrize("hidden,layers,use_nn", [(16, 2, True), (8, 3, False), (32, 5, True)])
def test_graph_plumbing_equals_eager_bitwise(cpu_graphs, hidden, layers, use_nn):
    """The model's field (the baseline's, ablation_no_nn's without the NN,
    ablation_no_physics's depth): trajectories and StepStats bitwise the
    eager loop's; one capture, then a replay per trial step."""
    cfg, params = _model(hidden, layers, use_nn)
    batch = _batch()
    eager = _eager(lambda: _solve(cfg, params, batch))
    c0, r0, s0 = explicit.graph_captures, explicit.graph_replays, explicit.host_syncs
    graph = _solve(cfg, params, batch)
    _assert_same(graph, eager)
    syncs = explicit.host_syncs - s0
    assert explicit.graph_captures - c0 == 1
    # a sync before each trial step and one after each interval's last
    assert 0 < explicit.graph_replays - r0 + 1 < syncs


def test_graph_is_reused_with_new_inputs_and_recaptured_for_new_shapes(cpu_graphs):
    """A second solve with other weights, states and controls of the same
    shapes replays the same graph and still equals eager (its inputs flow
    in, none is baked); another batch size captures anew."""
    cfg, params = _model()
    _solve(cfg, params, _batch(seed=0))
    c0, r0 = explicit.graph_captures, explicit.graph_replays
    _, params2 = _model(seed=5)
    batch2 = _batch(seed=3)
    eager = _eager(lambda: _solve(cfg, params2, batch2))
    _assert_same(_solve(cfg, params2, batch2), eager)
    assert explicit.graph_captures == c0 and explicit.graph_replays > r0
    assert len(explicit._GRAPHS) == 1
    batch3 = _batch(B=5, seed=4)
    eager = _eager(lambda: _solve(cfg, params2, batch3))
    _assert_same(_solve(cfg, params2, batch3), eager)
    assert explicit.graph_captures == c0 + 1 and len(explicit._GRAPHS) == 2


def test_graph_cache_keeps_at_most_max_graphs(cpu_graphs):
    """Each batch size is a graph of its own; the least recently used go."""
    cfg, params = _model()
    c0 = explicit.graph_captures
    for B in range(2, 3 + explicit.MAX_GRAPHS):
        _solve(cfg, params, _batch(B=B))
    assert explicit.graph_captures - c0 == explicit.MAX_GRAPHS + 1
    assert len(explicit._GRAPHS) == explicit.MAX_GRAPHS
    _solve(cfg, params, _batch(B=2 + explicit.MAX_GRAPHS))  # the newest: kept
    assert explicit.graph_captures - c0 == explicit.MAX_GRAPHS + 1
    _solve(cfg, params, _batch(B=2))  # the oldest: dropped, so captured again
    assert explicit.graph_captures - c0 == explicit.MAX_GRAPHS + 2


def test_closure_tensors_flow_in_as_inputs(cpu_graphs):
    """The 4GI generator's field reads the grid from its closure: the graph
    copies it in like the args, so two cohorts on other grids of the same
    length share a graph and each equals eager."""
    def cohort(hours, minutes, seed):
        with torch.no_grad():
            return simulate_cohort(torch.Generator().manual_seed(seed), n_subjects=3,
                                   duration_hours=hours, sampling_interval_min=minutes,
                                   meal_times=(0.5,), meal_sizes=(60.0,), device="cpu",
                                   return_stats=True)

    c0 = explicit.graph_captures
    for hours, minutes, seed in ((2.0, 30.0, 0), (4.0, 60.0, 1)):  # 5 points each
        _, conc, stats = cohort(hours, minutes, seed)
        _, conc_e, stats_e = _eager(lambda: cohort(hours, minutes, seed))
        for k in conc:
            assert torch.equal(conc[k], conc_e[k]), k
        for x, y in zip(stats, stats_e):
            assert torch.equal(x, y)
    assert explicit.graph_captures - c0 == 1


def test_norm_weights_and_tableaus_key_the_graph(cpu_graphs):
    """A seminorm's weights and the tableau are baked into the step: each
    pair is a graph of its own, each bitwise eager."""
    y0 = torch.tensor([[1.0, 2.0], [0.5, -1.0]], dtype=torch.float64)
    ts = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)

    def solve(solver, nw):
        with torch.no_grad():
            return odeint(lambda t, y, a: a * y.flip(-1), y0, ts,
                          torch.tensor(-1.3, dtype=torch.float64), solver=solver, mode="while",
                          rtol=1e-7, atol=1e-9, return_stats=True, norm_weights=nw)

    c0 = explicit.graph_captures
    runs = [("dopri5", None), ("dopri5", [1.0, 0.0]), ("dop853", [1.0, 0.0]),
            ("bosh3", None), ("dopri5", None)]
    for solver, nw in runs:
        _assert_same(solve(solver, nw), _eager(lambda: solve(solver, nw)))
    assert explicit.graph_captures - c0 == 4


def test_backsolve_solves_equal_eager_bitwise(cpu_graphs):
    """adjoint='backsolve': its forward solve and its backward's augmented
    solves (vector-Jacobian products under vmap, on leaves that require
    grad) take the route; the trajectory and every gradient equal eager, and
    a second backward reuses both graphs."""
    cfg, params = _model(seed=2)
    y0, ts, ctrl = _batch(B=4, T=5, seed=9)

    def run():
        p = {g: {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
             for g, leaves in params.items()}
        ys = forward(p, y0, ts, ctrl, cfg, adjoint="backsolve")
        (ys ** 2).mean().backward()
        return [ys.detach()] + [v.grad for leaves in p.values() for v in leaves.values()]

    eager = _eager(run)
    c0 = explicit.graph_captures
    for _ in range(2):
        for x, y in zip(run(), eager):
            assert torch.equal(x, y)
    assert explicit.graph_captures - c0 == 2


def test_inference_mode_keys_the_graph(cpu_graphs):
    """A graph made under inference mode holds inference tensors, which a
    solve outside it could not write: the two modes keep a graph each, both
    bitwise eager, and each is reused within its mode."""
    cfg, params = _model()
    y0, ts, ctrl = _batch()

    def solve(ctx):
        with ctx():
            return batched_forward(params, y0, ts, ctrl, cfg, return_stats=True)

    eager = _eager(lambda: solve(torch.no_grad))
    c0 = explicit.graph_captures
    for ctx in (torch.inference_mode, torch.no_grad, torch.inference_mode, torch.no_grad):
        _assert_same(solve(ctx), eager)
    assert explicit.graph_captures - c0 == 2 and len(explicit._GRAPHS) == 2
