"""The graph route of the explicit adaptive solvers, on the card.

An explicit RK solve in while mode on a CUDA device with autograd off
replays each trial step as one CUDA graph (`explicit.TrialGraph`). The graph
runs the eager loop's operations on the same data, so trajectories and
StepStats must equal the eager loop's bitwise, solve after solve: the
benchmark cell's cohorts at their shape (8192 windows, T=61), the ablation
configs' fields (`configs/ablation_no_nn.yaml`, `ablation_no_physics.yaml`)
at a small batch, the ICU generator's field (`data/mimic.py`) at its
generator's shape, and the backsolve adjoint's solves. A second solve of
other inputs of the same shapes replays the same graph (no input is baked
into it); another shape captures anew. The eager reference is the same call
with the route's rule refusing it.

JAX-free: run on the card with
    python3 -m pytest tests/test_torch_trial_graph.py --noconftest -q
Every test is `cuda`-marked and skips without a card.
"""

import numpy as np
import pytest
import torch

from hybrid_ode_torch.data.mimic import generate_icu_cohort
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models.hybrid import (
    batched_forward,
    config_from_dict,
    forward,
    init_hybrid_params,
)
from hybrid_ode_torch.solvers import explicit

pytestmark = pytest.mark.cuda
CELL = "baseline_dopri5.cohort_sim"


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class _Eager:
    """Within the block, the route's rule refuses every solve."""

    def __enter__(self):
        self.route = explicit.graph_route
        explicit.graph_route = lambda device, mode: False

    def __exit__(self, *exc):
        explicit.graph_route = self.route


def _counts():
    return explicit.graph_captures, explicit.graph_replays


def _assert_same(a, b):
    (ya, sa), (yb, sb) = a, b
    assert torch.equal(ya, yb)
    for name, x, y in zip(("n_accepted", "n_rejected", "success"), sa, sb):
        assert torch.equal(x, y), name


def _counting_trials(fn):
    """(fn(), the trial steps its eager loop ran)."""
    trial, n = explicit._trial, [0]

    def counted(*a, **k):
        n[0] += 1
        return trial(*a, **k)

    explicit._trial = counted
    try:
        with _Eager():
            return fn(), n[0]
    finally:
        explicit._trial = trial


def test_cell_cohorts_equal_eager_bitwise_and_replay_every_trial_step(device):
    """The cell's driver at its shape: set-up's warm-up unit captures the
    graph; each later cohort replays it once per trial step, captures
    nothing, and equals the eager loop bitwise, trajectories and StepStats."""
    from perfbench.harness import PB, _load, make_env

    env = make_env(CELL, 20261018, device)
    drv = _load(PB / "drivers" / "cohort_sim.py", "trial_graph_cohort_sim")
    c0, _ = _counts()
    sim = drv.setup(env)
    assert explicit.graph_captures - c0 == 1
    for k in range(len(sim.cohorts)):
        eager, trials = _counting_trials(lambda: sim._forward(sim.cohorts[k]))
        c, r = _counts()
        graph = sim._forward(sim.cohorts[k])
        assert explicit.graph_captures == c
        assert explicit.graph_replays - r == trials > 0
        _assert_same(graph, eager)


# the ablation configs' models (the YAML files' model and ablation keys; the
# card has no YAML reader), in the forward-only mode
ABLATIONS = {
    "ablation_no_nn": {"model": {"nn_hidden": 64, "nn_layers": 4, "solver": "dopri5",
                                 "max_steps_per_interval": 8},
                       "ablation": {"no_nn": True}},
    "ablation_no_physics": {"model": {"nn_hidden": 128, "nn_layers": 5, "solver": "dopri5",
                                      "max_steps_per_interval": 8},
                            "ablation": {"no_nn": False}},
}


def _model(name, device, seed):
    cfg = config_from_dict(ABLATIONS[name], mode="while")
    params = init_hybrid_params(torch.Generator().manual_seed(seed), cfg, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    for k, w in params["nn"].items():  # the last layer starts at zero: give it weight
        params["nn"][k] = w + 0.05 * torch.randn(w.shape, generator=g).to(device)
    return cfg, params


def _batch(device, B, T=13, seed=0):
    g = torch.Generator().manual_seed(seed)
    y0 = torch.tensor([8.0, 100.0, 90.0, 20.0, 0.0, 1.2]) * (
        1.0 + 0.2 * torch.rand(B, 6, generator=g))
    ts = torch.cumsum(0.2 + 0.3 * torch.rand(B, T, generator=g), -1)
    meal = 30.0 * torch.rand(B, T, generator=g) * (torch.rand(B, T, generator=g) < 0.3)
    tvns = torch.rand(B, T, generator=g)
    y0, ts, meal, tvns = (x.to(device) for x in (y0, ts, meal, tvns))
    return y0, ts, Controls(ts=ts, signals={"meal": meal, "tVNS": tvns})


def _solve(cfg, params, batch):
    y0, ts, ctrl = batch
    with torch.no_grad():
        return batched_forward(params, y0, ts, ctrl, cfg, return_stats=True)


@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_ablation_fields_equal_eager_reuse_and_recapture(device, name):
    """Solve, then other weights and inputs of the same shapes (the same
    graph: no capture), then another batch size (one capture); each bitwise
    the eager loop's."""
    cfg, params = _model(name, device, seed=0)
    c0, _ = _counts()
    runs = [(params, _batch(device, 64, seed=0)),
            (_model(name, device, seed=7)[1], _batch(device, 64, seed=3)),
            (params, _batch(device, 48, seed=5))]
    for i, (p, batch) in enumerate(runs):
        with _Eager():
            eager = _solve(cfg, p, batch)
        _assert_same(_solve(cfg, p, batch), eager)
        assert explicit.graph_captures - c0 == (1 if i < 2 else 2)


def test_inference_mode_solves_equal_eager(device):
    """Under inference mode a graph of its own is captured and reused, and
    equals the eager loop bitwise; the no-grad graph of the same shapes is
    kept beside it."""
    cfg, params = _model("ablation_no_nn", device, seed=4)
    batch = _batch(device, 32, seed=6)
    with _Eager():
        eager = _solve(cfg, params, batch)
    c0, _ = _counts()
    for ctx in (torch.inference_mode, torch.no_grad, torch.inference_mode):
        with ctx():
            _assert_same(_solve(cfg, params, batch), eager)
    assert explicit.graph_captures - c0 == 2


def test_icu_generator_equals_eager(device, tmp_path):
    """`generate_icu_cohort` at its default 80 patients on its 5-minute grid
    (one dopri5 'while' solve an hour, 32 steps an interval), 3 h: the same
    table bitwise; its hourly solves share one graph."""
    kw = dict(n_patients=80, hours=3.0, seed=11, device=device)
    with _Eager():
        eager = generate_icu_cohort(str(tmp_path / "eager.csv"), **kw)
    c0, r0 = _counts()
    graph = generate_icu_cohort(str(tmp_path / "graph.csv"), **kw)
    assert explicit.graph_captures - c0 <= 1 and explicit.graph_replays > r0
    assert sorted(graph) == sorted(eager)
    for k in graph:
        np.testing.assert_array_equal(graph[k], eager[k], err_msg=k)


def test_backsolve_solves_equal_eager(device):
    """adjoint='backsolve': its forward solve (no grad) and its backward's
    augmented solves (vmapped vector-Jacobian products) take the route; the
    trajectory and every gradient equal the eager loop's bitwise."""
    cfg, params = _model("ablation_no_physics", device, seed=2)
    y0, ts, ctrl = _batch(device, 8, T=5, seed=9)

    def run():
        p = {g: {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
             for g, leaves in params.items()}
        ys = forward(p, y0, ts, ctrl, cfg, adjoint="backsolve")
        (ys ** 2).mean().backward()
        return ys.detach(), {(g, k): v.grad for g, leaves in p.items() for k, v in leaves.items()}

    with _Eager():
        ys_e, grads_e = run()
    c0, _ = _counts()
    ys_g, grads_g = run()
    assert explicit.graph_captures > c0
    assert torch.equal(ys_g, ys_e)
    for k in grads_e:
        if grads_e[k] is None:
            assert grads_g[k] is None, k
        else:
            assert torch.equal(grads_g[k], grads_e[k]), k
