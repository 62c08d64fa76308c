"""Port parity: deep ensembles (`hybrid_ode_torch/parallel/ensemble.py`), the
ensemble and identify branches of evaluation, `--ensemble K` and
`--vs-truth`, and the recalibration fits of `evals/metrics.py`.

Small cases: K=3 members, H=8, 2 hidden layers, rk4 with 2 substeps,
'params' context mode, from the JAX package's `init_ensemble` leaves (the
output layer perturbed so that the residual acts), the same numpy windows
through both packages. Full width: `checkpoints/ensemble_id/ensemble_model`
(K=8, H=128) on the seed-42 test split of `data/4gi_dataset.csv`.

Tolerances. Trajectories, predictive mean and spread, one train step's losses
and parameters, `train_ensemble`'s best values: 1e-5 relative to the largest
value; `train_ensemble`'s parameters after 6 Adam updates 5e-5. The identified ensemble: 1e-4, its spread to 1e-4 of
the mean's scale (the spread is a difference of member trajectories), and a
window's codes may differ where two iterates tie on the port's own misfit to
1e-5 (the best iterate is chosen by a strict < on f32 misfits, as in
`tests/test_torch_identify.py`). Metrics at full width: 1e-5 plain, 1e-4
after 3 identification steps. Recalibration fits: 1e-6.
"""

import csv
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.dynamics.residual import init_mlp_params as j_init_mlp_params
from hybrid_ode_tpu.evals import evaluate as jeval
from hybrid_ode_tpu.evals import metrics as jmetrics
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.parallel import ensemble as jens
from hybrid_ode_tpu.train import loop as jloop
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.evals import evaluate as teval
from hybrid_ode_torch.evals import metrics as tmetrics
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.parallel import ensemble as tens
from hybrid_ode_torch.train import cli as tcli
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "4gi_dataset.csv")
ENS_CKPT = str(ROOT / "checkpoints" / "ensemble_id" / "ensemble_model")
K, B, T = 3, 5, 9
RTOL = 1e-5
ID_RTOL = 1e-4
#: parameters after several Adam updates: a step is lr * sign(g) where a
#: gradient component is near zero, so its last bits can turn one
ADAM_RTOL = 5e-5

#: `evaluate_checkpoint(ENS_CKPT)` on the seed-42 test split, JAX package on
#: the CPU: (rmse, rmse_glucose, nll, coverage_90, glucose vs truth)
PLAIN_REF = (0.34763877, 0.57617973, 5.8058872, 0.66256831, 0.89530986)
CKPT_VAL_LOSS = 0.09992384


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _setup(seed=0, mode="params"):
    """(jax config, numpy stacked params, numpy batch)."""
    rng = np.random.default_rng(seed)
    cfg = jhyb.HybridConfig(nn_hidden=8, nn_layers=2, solver="rk4", substeps=2,
                            context_points=4, context_dim=3, context_mode=mode)
    p = jax.tree_util.tree_map(np.array, jens.init_ensemble(jax.random.PRNGKey(seed), cfg, K))
    p["nn"]["w2"] = (0.05 * rng.normal(size=p["nn"]["w2"].shape)).astype(np.float32)
    p["enc"]["w2"] = (0.1 * rng.normal(size=p["enc"]["w2"].shape)).astype(np.float32)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.5, 1.2], np.float32)
    y0 = (base * (1 + 0.1 * rng.normal(size=(B, 6)))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.05, 0.25, (B, T)), 1).astype(np.float32)
    obs = (base * (1 + 0.1 * rng.normal(size=(B, T, 6)))).astype(np.float32)
    obs[:, 0] = y0
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    batch = {
        "initial_state": y0, "observations": obs, "time_points": ts, "mask": mask,
        "loss_weights": np.array([1.0, 0.01, 0.01, 0.1, 0.0, 1.0], np.float32),
        "external_inputs": {
            "meal": np.where(rng.uniform(size=(B, T)) > 0.6, 2.0, 0.0).astype(np.float32),
            "tVNS": rng.uniform(0, 1, (B, T)).astype(np.float32)},
    }
    return cfg, p, batch


def _tcfg(cfg):
    return thyb.HybridConfig(**dataclasses.asdict(cfg))


def _tbatch(batch):
    return {k: ({n: torch.as_tensor(v) for n, v in val.items()} if isinstance(val, dict)
                else torch.as_tensor(val)) for k, val in batch.items()}


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["params", "features"])
def test_ensemble_forward_and_predictive_match_jax(mode):
    cfg, p, batch = _setup(mode=mode)
    tp = params_from_numpy(p, "cpu")
    ref = np.asarray(jens.ensemble_forward(p, batch, cfg))
    with torch.no_grad():
        got = tens.ensemble_forward(tp, batch, _tcfg(cfg)).numpy()
    assert got.shape == ref.shape == (K, B, T, 6)
    assert _rel(ref, got) < RTOL
    sigma = np.array([0.1, 0.5, 0.2, 0.3, 0.0, 0.05], np.float32)
    jm, js = jens.ensemble_predictive(p, batch, cfg, noise_sigma=sigma)
    tm, ts = tens.ensemble_predictive(tp, batch, _tcfg(cfg), noise_sigma=sigma)
    assert _rel(jm, tm.numpy()) < RTOL and _rel(js, ts.numpy()) < RTOL
    # member i of the stack is the single model with member i's params
    one = thyb.batched_forward(tens.member_params(tp, 1), torch.as_tensor(batch["initial_state"]),
                               torch.as_tensor(batch["time_points"]),
                               thyb.with_context(tens.member_params(tp, 1), _tbatch(batch),
                                                 thyb.controls_from_batch(_tbatch(batch)),
                                                 _tcfg(cfg)), _tcfg(cfg))
    np.testing.assert_allclose(got[1], one.detach().numpy(), rtol=1e-6, atol=1e-5)


def test_collect_ensemble_predictive_matches_jax():
    cfg, p, _ = _setup()
    ds = jdata.create_data_arrays(DATA, 13, 12, use_native=False)
    tds = tdata.create_data_arrays(DATA, 13, 12, use_native=False)
    sub, tsub = ds.select(np.arange(11)), tds.select(np.arange(11))
    jcfg = dataclasses.replace(cfg, context_points=4)
    ref = jens.collect_ensemble_predictive(p, sub, jcfg, noise_sigma=0.1, batch_size=4)
    got = tens.collect_ensemble_predictive(params_from_numpy(p, "cpu"), tsub, _tcfg(jcfg),
                                           noise_sigma=0.1, batch_size=4)
    for a, b in zip(ref, got):
        assert a.shape == b.shape
        assert _rel(a, b) < RTOL


def test_launches_do_not_grow_with_the_member_count():
    """All members run in one pass: one forward at K=3 runs the ATen ops of
    one at K=1 (within 5%)."""
    cfg, p, batch = _setup()
    counts = []
    for k in (1, 3):
        tp = {g: {n: torch.as_tensor(v[:k]) for n, v in grp.items()} for g, grp in p.items()}
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tens.ensemble_forward(tp, batch, _tcfg(cfg))
        counts.append(sum(e.count for e in prof.key_averages()))
    assert counts[0] > 1000
    assert abs(counts[1] - counts[0]) <= 0.05 * counts[0], counts


def test_every_ensemble_checkpoint_loads_and_runs():
    """The repo's member-stacked checkpoints (K=8, H=128): each runs a short
    forward; the one with trainable |S_I| and blinded NN inputs
    (exog_insulin 'mech_blind') against JAX."""
    from hybrid_ode_torch.utils.checkpoint import load_checkpoint

    paths = sorted((ROOT / "checkpoints").glob("*/ensemble_model"))
    assert len(paths) == 9
    # 13-point windows: the context models encode their first 12
    short = tdata.create_data_arrays(DATA, 13, 12, use_native=False).batch(np.arange(B))
    for path in paths:
        state, meta = load_checkpoint(str(path))
        cfg = thyb.config_from_dict(meta["config"], use_pallas=False)
        params = params_from_numpy(state, "cpu")
        with torch.no_grad():
            out = tens.ensemble_forward(params, short, cfg)
        assert out.shape == (meta["n_members"], B, 13, 6) and torch.isfinite(out).all(), path
        if path.parent.name == "icu_ensemble_mech_blind_varied":
            assert cfg.exog_insulin == "mech_blind" and "S_I" in params["ode"]
            ref = jens.ensemble_forward(state, short, jhyb.config_from_dict(meta["config"],
                                                                            use_pallas=False))
            assert _rel(ref, out.numpy()) < RTOL


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_matches_jax_and_skips_a_nan_member(monkeypatch):
    """Two steps with physics on; member 1 has a NaN weight, so its loss is
    NaN: its params, moments and count stay, the others match JAX."""
    cfg, p, batch = _setup()
    p["nn"]["w0"][1, 0, 0] = np.nan
    idx = np.array([3, 0, 6, 2, 7, 1, 5, 4])
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(idx[:n]))
    monkeypatch.setattr(thyb, "physics_indices", lambda g, n, k: torch.as_tensor(idx[:n][:k]))
    opt = jloop.make_optimizer(1e-2, 10, 1, 0.5, train_ode_params=True)
    state = jens.init_ensemble_state(opt, jax.tree_util.tree_map(jnp.asarray, p))
    step = jens.make_ensemble_train_step(opt, cfg, lambda1=0.5, lambda2=0.01, use_physics=True)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jmets = []
    for i in range(2):
        state, m = step(state, jb, jax.random.split(jax.random.PRNGKey(i), K))
        jmets.append(jax.tree_util.tree_map(np.asarray, m))

    topt = tens.make_ensemble_optimizer(1e-2, 10, 1, 0.5, train_ode_params=True)
    tstate = tens.init_ensemble_state(topt, params_from_numpy(p, "cpu"))
    tstep = tens.make_ensemble_train_step(topt, _tcfg(cfg), lambda1=0.5, lambda2=0.01,
                                          use_physics=True)
    gens = [torch.Generator().manual_seed(i) for i in range(K)]
    for i in range(2):
        tstate, m = tstep(tstate, _tbatch(batch), gens)
        scale = np.abs(jmets[i]["loss"][[0, 2]]).max()
        for name in ("loss", "data", "physics", "reg"):
            ref, got = jmets[i][name], m[name].numpy()
            assert np.isnan(ref[1]) and np.isnan(got[1]), name
            # each term to 1e-5 of the loss (the physics term, a residual
            # of the model's own ODE, is 1e-6 of it and cancels)
            assert np.abs(ref[[0, 2]] - got[[0, 2]]).max() < RTOL * scale, (i, name)
        np.testing.assert_array_equal(m["update_ok"].numpy(), [True, False, True])
        assert np.isnan(m["grad_norm"][1]) and np.isfinite(m["grad_norm"][[0, 2]]).all()
    np.testing.assert_array_equal(tstate.opt_state["count"].numpy(), [2, 0, 2])
    np.testing.assert_array_equal(tstate.step.numpy(), [2, 2, 2])
    for g, grp in tstate.params.items():
        for n, v in grp.items():
            got = v.detach().numpy()
            ref = np.asarray(state.params[g][n])
            assert _rel(ref[[0, 2]], got[[0, 2]]) < RTOL, (g, n)
            np.testing.assert_array_equal(got[1], p[g][n][1])  # the skipped member
            if g in tstate.opt_state["mu"]:
                assert not tstate.opt_state["mu"][g][n][1].any()
                assert not tstate.opt_state["nu"][g][n][1].any()


def test_train_ensemble_matches_jax():
    cfg, p, _ = _setup()
    batches = [_setup(seed=s)[2] for s in (1, 2)]
    val = [_setup(seed=3)[2]]
    opt = jloop.make_optimizer(1e-2, 3, len(batches), 5.0)
    jbest, jval, jm = jens.train_ensemble(jax.tree_util.tree_map(jnp.asarray, p), opt, cfg,
                                          batches, val, jax.random.PRNGKey(7), 3,
                                          lambda2=0.01, eval_every=1)
    topt = tens.make_ensemble_optimizer(1e-2, 3, len(batches), 5.0)
    tbest, tval, tm = tens.train_ensemble(params_from_numpy(p, "cpu"), topt, _tcfg(cfg),
                                          batches, val, 7, 3, lambda2=0.01, eval_every=1)
    assert tval.shape == (K,) and np.isfinite(tval).all()
    assert _rel(jval, tval) < RTOL
    assert _rel(jm["loss"], tm["loss"]) < RTOL
    for g, grp in tbest.items():
        for n, v in grp.items():
            assert _rel(np.asarray(jbest[g][n]), v.numpy()) < ADAM_RTOL, (g, n)
    # no validation batches: the final params and NaN best values
    _, nan_val, _ = tens.train_ensemble(params_from_numpy(p, "cpu"), topt, _tcfg(cfg),
                                        batches, [], 7, 1)
    assert np.isnan(nan_val).all() and nan_val.shape == (K,)


def test_init_ensemble_draws_one_generator_per_member():
    cfg = _tcfg(_setup()[0])
    a = tens.init_ensemble(0, cfg, 3, device="cpu")
    b = tens.init_ensemble(0, cfg, 3, device="cpu")
    assert a["nn"]["w0"].shape == (3, 9, 8) and a["ode"]["G_b"].shape == (3,)
    np.testing.assert_array_equal(a["nn"]["w0"].numpy(), b["nn"]["w0"].numpy())
    assert not np.array_equal(a["nn"]["w0"][0].numpy(), a["nn"]["w0"][1].numpy())


def test_prune_members_matches_jax():
    cfg, p, _ = _setup()
    tp = params_from_numpy(p, "cpu")
    for best_val in ([0.1, 0.12, 5.0], [0.1, 0.11, 0.12], [1.0, 90.0, 80.0]):
        ref = jens.prune_members(p, best_val)
        got = tens.prune_members(tp, best_val)
        for g, grp in got.items():
            for n, v in grp.items():
                np.testing.assert_array_equal(np.asarray(ref[g][n]), v.numpy())


# ---------------------------------------------------------------------------
# identification
# ---------------------------------------------------------------------------

def _misfit(preds, batch, k):
    m = batch["mask"][:, :k]
    se = (preds - batch["observations"][:, :k]) ** 2 * batch["loss_weights"] * m[..., None]
    return se.sum((-2, -1)) / np.maximum(m.sum(1) * 6, 1.0)


def _member_misfits(tp, batch, cfg, ctx, k):
    sub = {**batch, "time_points": batch["time_points"][:, :k],
           "external_inputs": {n: v[:, :k] for n, v in batch["external_inputs"].items()}}
    b = _tbatch(sub)
    Km = ctx.shape[0]
    ts = tens._members(b["time_points"], Km)
    ctrl = tens._member_controls(b, Km, torch.as_tensor(ctx), ts)
    with torch.no_grad():
        preds = thyb.batched_forward(tens._member_view(tp, 1), tens._members(b["initial_state"], Km),
                                     ts, ctrl, _tcfg(cfg)).numpy()
    return _misfit(preds, batch, k)


@pytest.mark.parametrize("variant", ["plain", "encoder", "refine_params"])
def test_identified_ensemble_predictive_matches_jax(variant):
    cfg, p, batch = _setup()
    tp = params_from_numpy(p, "cpu")
    kw = dict(id_steps=8, prior_std=5.0)
    enc = None
    if variant == "encoder":
        enc = jax.tree_util.tree_map(np.asarray, j_init_mlp_params(jax.random.PRNGKey(5), 4 * 7,
                                                                   16, K * 3, 2))
        rng = np.random.default_rng(4)
        enc["w2"] = (0.01 * rng.normal(size=enc["w2"].shape)).astype(np.float32)
    if variant == "refine_params":
        kw.update(refine_params=True, param_steps=8, param_prior_std=0.2)
    jm, js = jens.identified_ensemble_predictive(p, batch, cfg, encoder=enc, **kw)
    tm, ts = tens.identified_ensemble_predictive(
        tp, batch, _tcfg(cfg), encoder=None if enc is None else params_from_numpy(enc, "cpu"), **kw)
    jm, js, tm, ts = np.asarray(jm), np.asarray(js), tm.numpy(), ts.numpy()
    assert np.isfinite(tm).all() and (ts >= 0).all()
    if _rel(jm, tm) < ID_RTOL and np.abs(js - ts).max() < ID_RTOL * np.abs(jm).max():
        return
    # else the codes: a window may differ only by a best-iterate tie on the
    # port's own misfit
    init = None
    if enc is not None:
        init = tens.encode_ensemble_context(params_from_numpy(enc, "cpu"),
                                            torch.as_tensor(batch["observations"]),
                                            torch.as_tensor(batch["time_points"]), 4, K, 3)
    jc = np.asarray(jens.identify_ensemble_context(p, batch, cfg, steps=8, prior_std=5.0,
                                                   init=None if init is None
                                                   else jnp.asarray(init.numpy())))
    tc = tens.identify_ensemble_context(tp, batch, _tcfg(cfg), steps=8, prior_std=5.0,
                                        init=init).numpy()
    far = np.abs(jc - tc).max(-1) > 2e-4 * np.abs(jc).max()
    assert 0 < far.sum() <= 1
    np.testing.assert_allclose(_member_misfits(tp, batch, cfg, tc, 4)[far],
                               _member_misfits(tp, batch, cfg, jc, 4)[far], rtol=1e-5)


def test_encode_ensemble_context_matches_jax():
    enc = jax.tree_util.tree_map(np.asarray, j_init_mlp_params(jax.random.PRNGKey(5), 4 * 7, 16,
                                                               K * 3, 2))
    enc["w2"] = (0.01 * np.random.default_rng(4).normal(size=enc["w2"].shape)).astype(np.float32)
    _, _, batch = _setup()
    ref = jens.encode_ensemble_context(enc, jnp.asarray(batch["observations"]),
                                       jnp.asarray(batch["time_points"]), 4, K, 3)
    got = tens.encode_ensemble_context(params_from_numpy(enc, "cpu"),
                                       torch.as_tensor(batch["observations"]),
                                       torch.as_tensor(batch["time_points"]), 4, K, 3)
    assert got.shape == (K, B, 3)
    assert _rel(ref, got.numpy()) < RTOL


def test_identification_requires_context_points():
    cfg, p, batch = _setup()
    with pytest.raises(ValueError, match="context_points"):
        tens.identified_ensemble_predictive(params_from_numpy(p, "cpu"), batch,
                                            dataclasses.replace(_tcfg(cfg), context_points=0))


def test_amortize_ensemble_encoder_with_injected_targets():
    cfg, p, batch = _setup()
    tp = params_from_numpy(p, "cpu")
    targets = torch.as_tensor(0.1 * np.random.default_rng(8).normal(size=(K, B, 3)),
                              dtype=torch.float32)
    enc, info = tens.amortize_ensemble_encoder(tp, batch, _tcfg(cfg), targets=targets, hidden=16,
                                               epochs=20, generator=torch.Generator().manual_seed(1))
    assert sorted(enc) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert enc["w0"].shape == (4 * 7, 16) and enc["w2"].shape == (16, K * 3)
    assert np.isfinite(info["val_code_mse"]) and info["n_members"] == K and info["n_windows"] == B
    assert info["target_std"] == pytest.approx(float(targets.std(unbiased=False)))
    codes = tens.encode_ensemble_context(enc, torch.as_tensor(batch["observations"]),
                                         torch.as_tensor(batch["time_points"]), 4, K, 3)
    assert codes.shape == (K, B, 3) and torch.isfinite(codes).all()
    # the encoder starts an identification
    mean, std = tens.identified_ensemble_predictive(tp, batch, _tcfg(cfg), id_steps=2, encoder=enc)
    assert mean.shape == (B, T, 6) and torch.isfinite(std).all()


# ---------------------------------------------------------------------------
# evaluation at full width, the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def test_split():
    jds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tds = tdata.create_data_arrays(DATA, 61, 30, use_native=False)
    return jdata.split_dataset(jds, seed=42)[2], tdata.split_dataset(tds, seed=42)[2]


def _row(m, preds, ds):
    return (m["rmse"], m["rmse_glucose"], m["nll"], m["coverage_90"],
            teval.glucose_truth_rmse(np.asarray(preds), ds, DATA))


def test_evaluate_ensemble_checkpoint_matches_jax(test_split):
    jte, tte = test_split
    m, arrays = teval.evaluate_checkpoint(ENS_CKPT, tte, device="cpu", return_arrays=True)
    np.testing.assert_allclose(_row(m, arrays[0], tte), PLAIN_REF, rtol=RTOL)
    assert m["checkpoint_val_loss"] == pytest.approx(CKPT_VAL_LOSS, rel=1e-7)
    ref = jeval.evaluate_checkpoint(ENS_CKPT, jte)
    assert sorted(ref) == sorted(m)
    for k in ref:
        np.testing.assert_allclose(m[k], ref[k], rtol=RTOL, atol=1e-7, err_msg=k)


def test_identified_evaluation_matches_jax(test_split):
    jte, tte = test_split
    kw = dict(identify_steps=3, identify_points=36, return_arrays=True)
    ref, jarr = jeval.evaluate_checkpoint(ENS_CKPT, jte, **kw)
    got, tarr = teval.evaluate_checkpoint(ENS_CKPT, tte, device="cpu", **kw)
    np.testing.assert_allclose(_row(got, tarr[0], tte), _row(ref, jarr[0], jte), rtol=ID_RTOL)
    for k in ("rmse", "mae", "r2", "crps", "ece"):
        np.testing.assert_allclose(got[k], ref[k], rtol=ID_RTOL, err_msg=k)
    assert got["rmse"] < PLAIN_REF[0]  # identification helps


def test_glucose_truth_rmse_matches_jax(test_split, tmp_path):
    jte, tte = test_split
    rng = np.random.default_rng(3)
    # perfect predictions of the noiseless truth score 0
    truth = np.zeros((len(tte), 61, 6), np.float64)
    with open(DATA, newline="") as f:
        rows = list(csv.DictReader(f))
    for w in range(len(tte)):
        sub = [r for r in rows if int(r["subject_id"]) == int(tte.subject_ids[w])]
        t_file = np.array([float(r["time_hours"]) for r in sub])
        g = np.array([float(r["glucose_true_mmol_L"]) for r in sub])
        idx = np.abs(t_file[None] - tte.time_points[w][:, None]).argmin(1)
        truth[w, :, 0] = (g[idx] - tte.state_mean[0]) / tte.state_std[0]
    assert teval.glucose_truth_rmse(truth, tte, DATA) < 1e-5
    preds = rng.normal(size=(len(tte), 61, 6)).astype(np.float32)
    assert teval.glucose_truth_rmse(preds, tte, DATA) == pytest.approx(
        jeval.glucose_truth_rmse(preds, jte, DATA), rel=1e-12)
    path = tmp_path / "no_truth.csv"
    path.write_text(Path(DATA).read_text().replace("glucose_true_mmol_L", "g_true"))
    with pytest.raises(ValueError, match="glucose_true_mmol_L"):
        teval.glucose_truth_rmse(preds, tte, str(path))


def test_evaluate_cli_identifies_and_reports_glucose_vs_truth(tmp_path, capsys):
    out = tmp_path / "eval.csv"
    teval.main([ENS_CKPT, "--identify-steps", "2", "--identify-points", "36", "--vs-truth",
                "--device", "cpu", "--output", str(out)])
    printed = capsys.readouterr().out
    assert "glucose-vs-truth:" in printed
    assert "glucose_rmse_vs_truth_mmol" in out.read_text().splitlines()[0]


def test_ensemble_cli_writes_a_checkpoint_jax_reads(tmp_path, monkeypatch):
    cfg = {"data": {"path": DATA, "sequence_length": 13, "stride": 12},
           "model": {"nn_hidden": 8, "nn_layers": 2, "solver": "rk4", "substeps": 2,
                     "context_points": 4, "context_mode": "params", "use_pallas": True},
           "training": {"epochs": 1, "batch_size": 16, "learning_rate": 1e-3,
                        "lambda1": 0.5, "train_ode_params": True},
           "ablation": {"no_bayes": True}}
    monkeypatch.chdir(tmp_path)
    tcli.main(["--experiment-name", "ens", "--ensemble", "2", "--epochs", "1", "--device", "cpu"],
              config=cfg)
    path = tmp_path / "checkpoints" / "ens" / "ensemble_model"
    state, meta = j_load_checkpoint(str(path))
    assert meta["n_members"] == 2 and len(meta["best_val"]) == 2
    assert sorted(meta) == sorted(["config", "n_members", "val_rmse_ensemble", "best_val",
                                   "epoch", "val_loss"])
    assert np.isfinite(meta["val_rmse_ensemble"]) and meta["val_loss"] == meta["val_rmse_ensemble"]
    assert state["nn"]["w0"].shape == (2, 9, 8)
    assert json.loads((tmp_path / "checkpoints" / "ens" / "config.json").read_text())["seed"] == 0
    jds = jdata.create_data_arrays(DATA, 13, 12, use_native=False)
    ref = jeval.evaluate_checkpoint(str(path), jdata.split_dataset(jds, seed=42)[2])
    tds = tdata.create_data_arrays(DATA, 13, 12, use_native=False)
    got = teval.evaluate_checkpoint(str(path), tdata.split_dataset(tds, seed=42)[2], device="cpu")
    np.testing.assert_allclose(got["rmse"], ref["rmse"], rtol=RTOL)


def test_ensemble_cli_reads_yaml(tmp_path, monkeypatch):
    import yaml

    cfg = {"data": {"path": DATA, "sequence_length": 13, "stride": 12},
           "model": {"nn_hidden": 8, "nn_layers": 1, "solver": "euler", "substeps": 1},
           "training": {"epochs": 1, "batch_size": 32}}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    tcli.main(["--config", "tiny.yaml", "--experiment-name", "y", "--ensemble", "2",
               "--device", "cpu"])
    assert (tmp_path / "checkpoints" / "y" / "ensemble_model" / "leaves.npz").exists()
    assert (tmp_path / "checkpoints" / "y" / "config.yaml").exists()


# ---------------------------------------------------------------------------
# recalibration of the predictive spread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["none", "points", "channels"])
def test_recalibration_fits_match_jax(mask_kind):
    rng = np.random.default_rng(11)
    shape = (6, 13, 6)
    preds = rng.normal(size=shape)
    targets = preds + rng.standard_t(3, size=shape) * 0.3
    unc = np.abs(rng.normal(0.2, 0.05, size=shape))
    mask = {"none": None, "points": (rng.uniform(size=shape[:2]) > 0.3).astype(np.float32),
            "channels": (rng.uniform(size=shape) > 0.3).astype(np.float32)}[mask_kind]
    ref = jmetrics.fit_uncertainty_scale(preds, unc, targets, mask=mask)
    got = tmetrics.fit_uncertainty_scale(preds, unc, targets, mask=mask)
    assert got == pytest.approx(ref, rel=1e-6)
    ref = jmetrics.fit_per_state_recalibration(preds, unc, targets, mask=mask)
    got = tmetrics.fit_per_state_recalibration(preds, unc, targets, mask=mask)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got.shape == (6,)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 4e's constants
# ---------------------------------------------------------------------------

def test_chip_smoke_ensemble_references_are_the_jax_package_values(test_split):
    """chip_smoke.py 4e holds the card to these JAX CPU values: the plain
    and the identified evaluation, and the recipe's first ensemble train
    step (the members' losses and global gradient norms)."""
    import optax

    import chip_smoke

    jte, _ = test_split
    assert PLAIN_REF == chip_smoke.REF_ENSEMBLE_PLAIN
    ref, arr = jeval.evaluate_checkpoint(ENS_CKPT, jte, return_arrays=True,
                                         identify_steps=chip_smoke.ENSEMBLE_ID_STEPS,
                                         identify_points=chip_smoke.ENSEMBLE_ID_POINTS)
    np.testing.assert_allclose(chip_smoke.REF_ENSEMBLE_IDENTIFIED, _row(ref, arr[0], jte),
                               rtol=1e-7)
    rc = chip_smoke.ENSEMBLE_RECIPE
    jds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    train = jdata.split_dataset(jds, seed=42)[0]
    batch = jdata.pad_batch(next(jdata.batch_iterator(train, rc["batch_size"], shuffle=True,
                                                      seed=rc["seed"])), rc["batch_size"])[0]
    state, meta = j_load_checkpoint(ENS_CKPT)
    cfg = jhyb.config_from_dict(meta["config"], use_pallas=False)

    def member(p):
        loss_fn = lambda q: jhyb.hybrid_loss(q, batch, jax.random.PRNGKey(0), cfg,  # noqa: E731
                                             lambda1=rc["lambda1"], lambda2=rc["lambda2"],
                                             use_physics_loss=False)[0]
        loss, g = jax.value_and_grad(loss_fn)(p)
        return loss, optax.global_norm(g)

    loss, gnorm = jax.jit(jax.vmap(member))(jax.tree_util.tree_map(jnp.asarray, state))
    np.testing.assert_allclose(chip_smoke.REF_ENSEMBLE_STEP_LOSS, np.asarray(loss), rtol=1e-7)
    np.testing.assert_allclose(chip_smoke.REF_ENSEMBLE_STEP_GRAD_NORM, np.asarray(gnorm),
                               rtol=1e-6)
