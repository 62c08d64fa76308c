"""Port parity for online per-subject adaptation (`train/online.py`) and for
resuming training from a JAX checkpoint's optax state, on the CPU against
the JAX package.

The stream cohort is `hybrid_ode_torch/testdata/online_stream_s4.csv`: 4
subjects x 361 five-minute points (30 h) written by the JAX package's 4GI
generator with benchmarks/online_adapt.py's meals and its evaluation seed
(300); the test below regenerates it and compares the bytes. Both packages
read that file. A small model (H=16, 2 layers, 3 context points, rk4 with 2
substeps; JAX-initialised weights with a non-zero output layer) adapts on
the 6 and 12 h reveals: adapted parameters to 1e-5 (relative to each
leaf's scale), remainder RMSEs to 1e-5, the guard's arms and the policy
selectors' choices equal; the ensemble variants at K=2. The fused route
(use_pallas) runs the plain version of the kernels here, against JAX's
interpret mode. The resume case holds the port's first update from
`checkpoints/accuracy_benchmark/final_model`'s optax state to JAX's at 1e-6.
"""

import copy
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.data.fourgi_gen import generate_4gi_dataset
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.train import loop as jloop
from hybrid_ode_tpu.train import online as jon
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import loop as tloop
from hybrid_ode_torch.train import online as ton
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STREAM = ROOT / "hybrid_ode_torch" / "testdata" / "online_stream_s4.csv"
MEALS = ((1.0, 75.0), (5.0, 50.0), (9.5, 60.0), (25.0, 75.0), (28.5, 50.0))
RESUME_CKPT = str(ROOT / "checkpoints" / "accuracy_benchmark" / "final_model")
DATA = str(ROOT / "data" / "4gi_dataset.csv")
RTOL = 1e-5


def _leaf_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-8))


def _tree_close(jtree, ttree, tol, label=""):
    for g in jtree:
        for k in jtree[g]:
            e = _leaf_err(jtree[g][k], ttree[g][k].detach().cpu().numpy())
            assert e < tol, (label, g, k, e)


@pytest.fixture(scope="module")
def streams():
    """Both packages' datasets of the committed CSV (one 361-point window per
    subject), the port's as numpy arrays of the same values."""
    jds = jdata.create_data_arrays(str(STREAM), 361, 361, use_native=False)
    tds = tdata.create_data_arrays(str(STREAM), 361, 361, use_native=False)
    assert len(jds) == len(tds) == 4
    np.testing.assert_array_equal(jds.observations, tds.observations)
    return jds, tds


def _model(use_pallas=False, K=None, seed=0):
    cfg = jhyb.HybridConfig(solver="rk4", substeps=2, nn_hidden=16, nn_layers=2,
                            context_points=3, context_dim=4, use_pallas=use_pallas)

    def one(s):
        p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(s), cfg))
        p["nn"]["w2"] = (0.05 * np.random.default_rng(s).normal(size=p["nn"]["w2"].shape)
                         ).astype(np.float32)
        return p

    if K is None:
        p = one(seed)
    else:
        members = [one(seed + i) for i in range(K)]
        p = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *members)
    return cfg, thyb.HybridConfig(**dataclasses.asdict(cfg)), p


def _cut(ds, n=145):
    """The first n points of every stream (n=145: 12 h)."""
    cut = {k: getattr(ds, k)[:, :n] for k in ("observations", "time_points", "meal", "tvns",
                                                "mask")}
    return dataclasses.replace(ds, **cut)


def _window(ds, w):
    return {"observations": ds.observations[w], "time_points": ds.time_points[w],
            "external_inputs": {"meal": ds.meal[w], "tVNS": ds.tvns[w]}, "mask": ds.mask[w]}


def _jp(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def test_stream_csv_is_the_jax_generators_output(tmp_path):
    """The committed cohort: generate_4gi_dataset(seed=300, n_subjects=4,
    duration_hours=30, meal_times / meal_sizes from online_adapt.py's MEALS),
    byte for byte."""
    out = tmp_path / "stream.csv"
    generate_4gi_dataset(path=str(out), seed=300, n_subjects=4, duration_hours=30.0,
                         meal_times=[m for m, _ in MEALS], meal_sizes=[s for _, s in MEALS])
    assert out.read_bytes() == STREAM.read_bytes()


@pytest.mark.parametrize("scope,use_pallas", [("nn", False), ("last", False), ("nn", True)])
def test_adapt_subject_matches_jax(streams, scope, use_pallas):
    """Five Adam steps at lr 1e-3 (anchor 1.0) on subject 1's 6 h reveal:
    every adapted leaf to 1e-5 of its scale, the frozen leaves unchanged."""
    jds, tds = streams
    jcfg, tcfg, p = _model(use_pallas)
    reveal = 73
    ja = jon.adapt_subject(_jp(p), _window(jds, 1), jcfg, reveal, adapt_steps=5,
                           learning_rate=1e-3, adapt_scope=scope)
    ta = ton.adapt_subject(params_from_numpy(p, "cpu"), _window(tds, 1), tcfg, reveal,
                           adapt_steps=5, learning_rate=1e-3, adapt_scope=scope)
    _tree_close(ja, ta, RTOL, scope)
    moved = [k for k in p["nn"] if not np.array_equal(p["nn"][k], ta["nn"][k].numpy())]
    assert moved == (sorted(p["nn"]) if scope == "nn" else ["b2", "w2"])
    for g in ("ode", "enc"):
        for k in p[g]:
            np.testing.assert_array_equal(ta[g][k].numpy(), p[g][k])


def test_online_adaptation_eval_matches_jax(streams):
    """online_adaptation_eval at 3 and 6 h of the first 12 h, without and
    with 3 adaptation steps, on subjects 0 and 2: each horizon's RMSE to
    1e-5; the single remainder forecast over the whole stream too."""
    jds, tds = streams
    jcfg, tcfg, p = _model()
    tp = params_from_numpy(p, "cpu")
    assert ton.forecast_remainder_rmse(tp, tds, 2, 100, tcfg) == pytest.approx(
        jon.forecast_remainder_rmse(_jp(p), jds, 2, 100, jcfg), rel=RTOL)
    for steps in (0, 3):
        kw = dict(horizons_hours=(3.0, 6.0), adapt_steps=steps, learning_rate=1e-3,
                  window_indices=(0, 2))
        ref = jon.online_adaptation_eval(_jp(p), _cut(jds), jcfg, **kw)
        got = ton.online_adaptation_eval(tp, _cut(tds), tcfg, **kw)
        assert sorted(got) == sorted(ref)
        for h in ref:
            assert got[h] == pytest.approx(ref[h], rel=RTOL), (steps, h)


def test_guard_arms_and_guarded_choice_match_jax(streams):
    """guard_candidate_arms on subject 3's 12 h reveal: every arm's holdout
    squared errors to 1e-5 (relative to the arm's largest), and
    adapt_subject_guarded deploys the same arm (its nn leaves to 1e-5)."""
    jds, tds = (_cut(ds) for ds in streams)
    jcfg, tcfg, p = _model()
    kw = dict(adapt_steps=3, learning_rate=1e-3)
    jarms, jsq = jon.guard_candidate_arms(_jp(p), _window(jds, 3), jcfg, 145, **kw)
    tarms, tsq = ton.guard_candidate_arms(params_from_numpy(p, "cpu"), _window(tds, 3), tcfg,
                                          145, **kw)
    assert sorted(jsq) == sorted(tsq)
    for a in jsq:
        assert _leaf_err(jsq[a], tsq[a]) < RTOL, a
        _tree_close(jarms[a], tarms[a], RTOL, a)
    jg = jon.adapt_subject_guarded(_jp(p), _window(jds, 3), jcfg, 145, **kw)
    tg = ton.adapt_subject_guarded(params_from_numpy(p, "cpu"), _window(tds, 3), tcfg, 145,
                                   **kw)
    _tree_close(jg, tg, RTOL, "guarded")


def test_resume_from_jax_optax_state_matches_jax(monkeypatch):
    """train_model(resume_from=<a JAX checkpoint with optax state>): the
    accuracy checkpoint's final model (epoch 2999, Adam and schedule count
    3000, moments of every trainable leaf), resumed for one epoch (one
    update: the seed-42 train split is 7 windows, one batch) with the
    schedule stretched to 6000 epochs, so the step's learning rate is half
    the peak and the update moves the parameters. Every parameter after it
    to 1e-6 of its leaf's scale; the step's loss to 1e-6; the update's norm,
    which chip_smoke.py phase 4g (f) holds the card to, and the norm a fresh
    Adam would give instead (count 0, no moments), which fails that limit."""
    saved, meta = load_checkpoint(RESUME_CKPT)
    cfg = copy.deepcopy(meta["config"])
    cfg["training"]["epochs"] = 6000
    cfg["training"]["early_stopping_patience"] = 0  # stop after the one epoch
    jds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tds = tdata.create_data_arrays(DATA, 61, 30, use_native=False)
    (jtr, jva, _) = jdata.split_dataset(jds, seed=42)
    (ttr, tva, _) = tdata.split_dataset(tds, seed=42)
    jres = jloop.train_model(cfg, jtr, jva, None, None, resume_from=RESUME_CKPT)
    tres = tloop.train_model(cfg, ttr, tva, None, None, resume_from=RESUME_CKPT, device="cpu")
    assert jres.epochs_run == tres.epochs_run == 3001
    assert len(tres.history["step_loss"]) == 1
    assert tres.history["step_loss"][0] == pytest.approx(jres.history["train_loss"][0], rel=1e-6)
    # chip_smoke.py phase 4g (f) holds the card to this JAX value
    assert jres.history["train_loss"][0] == pytest.approx(chip_smoke.REF_RESUME_LOSS, rel=1e-7)
    assert chip_smoke.RESUME_EPOCHS == cfg["training"]["epochs"]
    _tree_close(jres.params, tres.params, 1e-6, "resume")
    jnorm = chip_smoke.update_norm(saved["params"], jax.tree_util.tree_map(np.asarray, jres.params))
    assert jnorm == pytest.approx(chip_smoke.REF_RESUME_UPDATE_NORM, rel=1e-7)
    tnorm = chip_smoke.update_norm(saved["params"], tres.params)
    assert tnorm == pytest.approx(jnorm, rel=chip_smoke.REF_RTOL)
    monkeypatch.setattr(tloop.Optimizer, "load_state_tree", lambda self, tree: None)
    fresh = tloop.train_model(cfg, ttr, tva, None, None, resume_from=RESUME_CKPT, device="cpu")
    fnorm = chip_smoke.update_norm(saved["params"], fresh.params)
    assert fnorm == pytest.approx(chip_smoke.RESUME_FRESH_UPDATE_NORM, rel=1e-3)
    assert abs(fnorm - jnorm) / jnorm > 100 * chip_smoke.REF_RTOL
    # the update is one of the restored optimizer: the MLP moved by far more
    # than the limit
    assert _leaf_err(saved["params"]["nn"]["w1"], tres.params["nn"]["w1"].numpy()) > 1e-4
