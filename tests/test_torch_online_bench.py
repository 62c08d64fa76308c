"""Online adaptation's benchmark cell (`online_pop.adapt_b1`) and its spans,
on the CPU, without JAX.

The program (`adapt_subject` and the `Adaptation` it steps, the fused
kernels' plain versions standing in for the kernels) against the plain
reference `perfbench/reference/online.py` on seeded random weights at a
small size (H=16, 2 layers, 4 context features, T=13, 3 updates); the
cell's check through `harness.run_cell` at a small size: the program
passes, the control (the reference in TF32) fails, each fault of
`perfbench/faults_online.py` fails (one in a single leaf's gradient by the
worst leaf, where the median leaf would pass it); the `hode.online.*`
spans with their attributes, the `online.*` counters, and the
`dispatch_ms` / `sync_wait_ms` readers on those spans.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hybrid_ode_torch.models.hybrid import HybridConfig, init_hybrid_params
from hybrid_ode_torch.train import online
from hybrid_ode_torch.utils import profiling
from perfbench import faults_online, harness
from perfbench.inputs import HERE, load_source, make_windows
from perfbench.metrics import dispatch_ms, sync_wait_ms
from perfbench.reference import online as ref

torch.set_num_threads(2)

CPU = torch.device("cpu")
CELL = "online_pop.adapt_b1"
CFG = HybridConfig(solver="rk4", substeps=2, nn_hidden=16, nn_layers=2, context_points=3,
                   context_dim=4, use_pallas=True)
R, STEPS, LR, ANCHOR = 13, 3, 1e-3, 1.0
# the cell at a small size: 14 points revealed (1.1 h), 2 updates a subject,
# the checked update the second subject's second; the half-reveal fault
# needs 24 points, so that its half still holds the encoder's 12
SMALL = {"pool": 4, "reveal_hours": 1.1, "updates_per_subject": 2, "check_from": 2,
         "check_to": 3}
HALF = {**SMALL, "reveal_hours": 2.0}


def _params(seed=0):
    """Random weights; the output layer made non-zero, so that every layer
    gets a gradient at the population weights."""
    gen = torch.Generator().manual_seed(seed)
    p = init_hybrid_params(gen, CFG, device="cpu")
    p["nn"]["w2"] = 0.05 * torch.randn(p["nn"]["w2"].shape, generator=gen)
    return {g: {k: v.detach() for k, v in grp.items()} for g, grp in p.items()}


def _window(seed=0):
    """One of the stream file's subjects, normalised by its own scale."""
    src = load_source(HERE / "data" / "online_stream_s4.csv")
    flat = src["states"].reshape(-1, 6)
    mean, std = flat.mean(0), flat.std(0) + 1e-6
    zero = {"y0_sd": 0.0, "obs_sd": 0.0, "meal_shift": 0, "meal_scale": 0.0}
    w = make_windows(np.random.default_rng(seed), 1, src, mean, std, zero)
    return {"observations": w["observations"][0], "time_points": w["time_points"][0],
            "external_inputs": {"meal": w["meal"][0], "tVNS": w["tvns"][0]},
            "mask": w["mask"][0]}


def _ref_batch(w):
    t = lambda x: torch.as_tensor(np.asarray(x[:R]))[None]  # noqa: E731
    return {"initial_state": torch.as_tensor(w["observations"][0])[None],
            "observations": t(w["observations"]), "time_points": t(w["time_points"]),
            "meal": t(w["external_inputs"]["meal"]), "tvns": t(w["external_inputs"]["tVNS"]),
            "mask": t(w["mask"])}


@pytest.mark.parametrize("scope", ["nn", "last"])
def test_adaptation_matches_the_plain_reference(scope):
    params, w = _params(), _window()
    a = online.subject_adaptation(params, w, CFG, R, LR, anchor_weight=ANCHOR, adapt_scope=scope)
    losses = [float(a.step()) for _ in range(STEPS)]
    adapted = online.adapt_subject(params, w, CFG, R, STEPS, LR, anchor_weight=ANCHOR,
                                   adapt_scope=scope)
    recipe = {"context_points": CFG.context_points, "substeps": CFG.substeps,
              "learning_rate": LR, "anchor_weight": ANCHOR, "adapt_scope": scope}
    r_losses, r_after = ref.adapt(params, _ref_batch(w), recipe, STEPS)
    # f32 sums in other orders over 12 intervals x 2 RK4 substeps: the losses
    # agree to a few float32 spacings
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    # a leaf moves 3 x lr at most: its gap, over its own scale, stays within
    # f32 rounding of the leaf (Adam's normalised step hides no gradient
    # error larger than that here)
    for k, v in adapted["nn"].items():
        want = r_after.get(k, params["nn"][k])
        err = float((v - want).abs().max()) / max(float(want.abs().max()), 1e-8)
        assert err < 1e-5, (k, err)
    assert sorted(r_after) == ref.scope_names(params["nn"], scope)
    for g in ("ode", "enc"):
        for k, v in adapted[g].items():
            assert torch.equal(v, params[g][k])


def _cell(mix, control=False):
    return harness.run_cell(CELL, 2147483901, 0.0, CPU, {"mix": mix}, control=control)


def test_the_cell_passes_and_its_control_fails():
    run, correct, table, control = _cell(SMALL, control=True)
    assert run.units >= 3 and run.failed == 0 and run.workload.info()["subjects"] == 2
    assert correct, table
    limits = harness.make_env(CELL, 1, CPU).limits
    assert any(v > limits[k] for k, v in control), (control, limits)


@pytest.mark.parametrize("fault", sorted(faults_online.FAULTS))
def test_each_fault_fails(fault):
    undo = faults_online.plant(fault)
    try:
        _, correct, table, _ = _cell(HALF if fault == "online_half_reveal" else SMALL)
    finally:
        undo()
    assert not correct, table


def test_a_fault_in_one_leafs_gradient_fails_by_its_worst_leaf():
    """One leaf's gradient halved: the gradient's worst leaf reads 0.5,
    while its median leaf reads as a sound run's."""
    undo = faults_online.plant("online_layer_grad_halved")
    try:
        run, correct, table, _ = _cell(SMALL)
    finally:
        undo()
    limits = harness.make_env(CELL, 1, CPU).limits
    extra = run.workload.extra
    for at in ("first", "window"):
        assert table[f"grad_gap_{at}"]["value"] == pytest.approx(0.5, rel=1e-3)
        assert extra[f"grad_gap_{at}_median"] < limits[f"grad_gap_{at}"]
    assert not correct


def _profiled(fn):
    with profiling.span("hode.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s.parent == i]


def test_an_adaptation_and_its_guard_record_their_spans_and_counters():
    params, w = _params(), _window()
    before = profiling.counters()
    _, spans = _profiled(lambda: online.guard_candidate_arms(params, w, CFG, 16, adapt_steps=2))
    after = profiling.counters()
    change = {k: after[k] - before[k] for k in after if k.startswith("online.")}
    assert change == {"online.adapt_steps": 2, "online.subjects": 1, "online.forecasts": 4}
    names = [s.name for s in spans]
    (adapt,) = [i for i, n in enumerate(names) if n == "hode.online.adapt"]
    fit = online._split(16, 0.25)
    assert spans[adapt].attrs == {"reveal_points": fit, "steps": 2, "scope": "nn", "members": 1}
    steps = _children(spans, adapt)
    assert [names[i] for i in steps] == ["hode.online.step"] * 2
    for i in steps:
        kids = _children(spans, i)
        assert [names[j] for j in kids] == ["hode.online.loss", "hode.online.backward",
                                            "hode.online.adam"]
        inner = {names[j] for j in _children(spans, kids[0])}
        assert inner == {"hode.forward.encode", "hode.forward.fused"}
    (guard,) = [i for i, n in enumerate(names) if n == "hode.online.guard"]
    assert spans[guard].attrs == {"arms": 4}
    forecasts = _children(spans, guard)
    assert [names[i] for i in forecasts] == ["hode.online.forecast"] * 4
    assert all(spans[i].attrs == {"points": 16 - fit + 1, "members": 1} for i in forecasts)


def test_an_ensemble_adaptation_and_forecast_name_their_members():
    one, two = _params(0), _params(1)
    stacked = {g: {k: torch.stack([one[g][k], two[g][k]]) for k in one[g]} for g in one}
    w = _window()
    _, spans = _profiled(lambda: online.adapt_subject_ensemble(stacked, w, CFG, R, adapt_steps=1))
    (adapt,) = [s for s in spans if s.name == "hode.online.adapt"]
    assert adapt.attrs["members"] == 2 and adapt.attrs["steps"] == 1
    ts = torch.as_tensor(w["time_points"][:5])[None]
    ctrls = online.Controls(ts=ts, signals={"meal": ts * 0, "tVNS": ts * 0})
    ctx = {"observations": torch.as_tensor(w["observations"][:3])[None], "time_points": ts[:, :3]}
    y0 = torch.as_tensor(w["observations"][0])[None]
    preds, spans = _profiled(lambda: online._member_preds(stacked, CFG, y0, ts, ctrls, ctx))
    assert preds.shape[:2] == (2, 5)
    assert [s.attrs for s in spans if s.name == "hode.online.forecast"] == [
        {"points": 5, "members": 2}]


def test_dispatch_and_sync_wait_read_the_online_spans():
    a = online.subject_adaptation(_params(), _window(), CFG, R, LR)
    _profiled(lambda: [a.step() for _ in range(3)])
    run = SimpleNamespace(trace=SimpleNamespace(units=3, counters={}))
    assert dispatch_ms.read(run) > 0.0
    # an update reads nothing to the host: no sync span, a wait of 0
    assert sync_wait_ms.read(run) == 0.0
