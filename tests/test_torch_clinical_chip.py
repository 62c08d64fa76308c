"""chip_smoke.py phase 4h's constants, recomputed from the JAX package on the
CPU, and the port's values on the CPU beside them.

(a) the MIMIC file's rows and column sums, mimic_hybrid's evaluation on the
seed-42 test split (JAX's XLA rk4 path: its interpret-mode kernel is far too
slow at H=128); (b) the committed ICU cohorts, regenerated by JAX byte for
byte, and their sums; (c) the training cohort's statistics through the port's
Parquet route, the protocol study on icu_ensemble_mech_dysglycemic and the
fused closed loop of mimic_hybrid; (d) mimic_hybrid's robustness report; (e)
the fig2 Sobol indices and the reading that sets SOBOL_ATOL. The JAX runs of
(c)-(e) at full width take minutes: they are `slow` (RUN_SLOW=1).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke as cs
from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.data import mimic as jmimic
from hybrid_ode_tpu.evals import robustness as jrob
from hybrid_ode_tpu.evals.evaluate import evaluate_checkpoint as j_evaluate_checkpoint
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.models import protocol as jprot
from hybrid_ode_tpu.parallel.ensemble import prune_members as j_prune_members
from hybrid_ode_tpu.plots import figures as jfig
from hybrid_ode_tpu.plots import sobol as jsobol
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.data import mimic as tmimic

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MIMIC_PARQUET = str(ROOT / "data" / "mimic_glucose_insulin.parquet")
TRAIN_PARQUET = str(ROOT / "data" / "icu_cohort_dysglycemic.parquet")


def _norm():
    return (np.asarray(cs.TRAIN_NORM[0], np.float64), np.asarray(cs.TRAIN_NORM[1], np.float64))


def _assert_close(got, ref, rel, label=""):
    g, r = cs._flat(got), cs._flat(ref)
    assert sorted(g) == sorted(r), label
    for k, v in r.items():
        assert g[k] == pytest.approx(v, rel=rel, abs=1e-12), (label, k, g[k], v)


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------

def jax_mimic_test_split():
    _, meta = j_load_checkpoint(str(cs.MIMIC_CKPT))
    d = meta["config"]["data"]
    ds = jdata.create_data_arrays(MIMIC_PARQUET, d["sequence_length"], d["stride"])
    return jdata.split_dataset(ds, seed=42)[2]


def jax_mimic_model():
    state, meta = j_load_checkpoint(str(cs.MIMIC_CKPT))
    return state["params"], jhyb.config_from_dict(meta["config"], use_pallas=False), meta


def jax_mimic_metrics():
    _, cfg, _ = jax_mimic_model()
    m = j_evaluate_checkpoint(str(cs.MIMIC_CKPT), jax_mimic_test_split(), config=cfg)
    return {k: float(v) for k, v in m.items()}


def jax_robustness():
    params, cfg, _ = jax_mimic_model()
    rep = jrob.robustness_report(params, jax_mimic_test_split(), cfg)
    return {k: {str(x): float(v) for x, v in d.items()} for k, d in rep.items()}


def _jb(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def jax_protocol():
    """(c)'s readings from the JAX package, on the port's numpy windows of the
    committed JAX cohorts (the CSV route reads them exactly)."""
    norm = _norm()
    state, meta = j_load_checkpoint(str(cs.PROTOCOL_CKPT))
    stacked = j_prune_members(state, meta["best_val"])
    cfg = jhyb.config_from_dict(meta["config"])
    _, batch, truth = cs.design_inputs(norm)
    jbatch, truth = _jb(batch), jnp.asarray(truth, jnp.float32)
    g, t, b = cs.PROTOCOL_DEFAULT
    loop = jprot.ensemble_closed_loop(stacked, jbatch, cfg, g, t, norm, basal=b,
                                      rate_cap=cs.MAX_RATE)
    anchor = truth - jnp.mean(loop["glucose"], axis=0)

    def rollout(gain, target, basal):
        return jprot.ensemble_closed_loop(stacked, jbatch, cfg, gain, target, norm, basal=basal,
                                          glucose_offset=anchor, rate_cap=cs.MAX_RATE)["glucose"]

    fact = jax.lax.stop_gradient(jax.jit(rollout)(*map(jnp.asarray, cs.PROTOCOL_DEFAULT)))
    opt = jprot.optimize_protocol(
        rollout, init_gain=g, init_target=t, init_basal=b, steps=cs.OPT_STEPS, lr=cs.OPT_LR,
        gain_bounds=cs.GAIN_BOUNDS, basal_bounds=cs.BASAL_BOUNDS,
        objective=lambda x: jprot.robust_delta_risk(x, fact, truth[None]))
    ci = cs.calib_inputs(norm)
    cbatch = _jb(ci.pop("batch"))
    f32 = {k: jnp.asarray(ci[k]) for k in ("gain_w", "target_w", "basal_w", "observed_glucose",
                                           "observed_mask")}
    cal = jprot.calibrate_dose_response(stacked, cbatch, cfg, norm, **f32,
                                        subject_idx=ci["subject_idx"],
                                        instruments=ci["instruments"],
                                        reference_protocol=cs.PROTOCOL_DEFAULT,
                                        scales=cs.CALIB_SCALES, rate_cap=cs.MAX_RATE)
    return {
        "loop": {"glucose": np.asarray(loop["glucose"], np.float64).mean(axis=(1, 2)).tolist(),
                 "rates": np.asarray(loop["rates"], np.float64).mean(axis=(1, 2)).tolist()},
        "opt": {"risk": [float(x) for x in opt["risk"]], "gain": float(opt["gain"]),
                "target": float(opt["target"]), "basal": float(opt["basal"])},
        "calib": {"scale": float(cal["scale"]),
                  "slopes": {str(s): float(cal["slopes"][s]["slope"]) for s in cs.CALIB_SCALES}},
    }


def jax_mimic_loop():
    params, cfg, meta = jax_mimic_model()
    norm = (np.asarray(meta["state_mean"], np.float64), np.asarray(meta["state_std"], np.float64))
    _, batch, _ = cs.design_inputs(norm)
    out = jprot.closed_loop_rollout(params, _jb(batch), cfg, cs.PROTOCOL_DEFAULT[0],
                                    cs.PROTOCOL_DEFAULT[1], norm)
    return {"glucose": float(np.asarray(out["glucose"], np.float64).mean()),
            "rates": float(np.asarray(out["rates"], np.float64).mean()),
            "insulin_total": float(np.asarray(out["insulin_total"], np.float64).sum())}


def jax_sobol(x64=False):
    state, meta = j_load_checkpoint(str(cs.SOBOL_CKPT))
    cfg = jhyb.config_from_dict(meta["config"])
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), state["params"])
        res = jsobol.sobol_sensitivity(jfig.make_fig2_simulator(params, cfg), n=cs.SOBOL_N,
                                       batch_size=cs.SOBOL_BATCH)
    return {"S1": res["S1"], "ST": res["ST"]}


# ---------------------------------------------------------------------------
# constants that are quick to recompute
# ---------------------------------------------------------------------------

def test_mimic_constants_are_the_committed_file():
    df = pd.read_parquet(MIMIC_PARQUET)
    assert len(df) == cs.MIMIC_ROWS
    sums = {c: float(np.nansum(df[c].to_numpy(np.float64))) for c in df.columns
            if c != "diabetic"}
    assert sums == cs.REF_MIMIC_SUMS


@pytest.mark.parametrize("which", ["design", "varied"])
def test_committed_icu_cohorts_are_jax_byte_for_byte(which, tmp_path):
    kw = cs.ICU_DESIGN if which == "design" else cs.ICU_VARIED
    path = cs.ICU_DESIGN_CSV if which == "design" else cs.ICU_VARIED_CSV
    df = jmimic.generate_icu_cohort_dysglycemic(str(tmp_path / "c.parquet"), **kw)
    tdata.write_table({c: df[c].to_numpy() for c in df.columns}, tmp_path / "c.csv")
    assert (tmp_path / "c.csv").read_bytes() == Path(path).read_bytes()
    if which == "design":
        sums = {c: float(np.nansum(df[c].to_numpy(np.float64))) for c in cs.REF_ICU_SUMS}
        assert sums == cs.REF_ICU_SUMS


def test_training_norm_is_the_parquet_routes():
    """TRAIN_NORM: the training cohort's statistics through the port's
    Parquet route, equal to JAX's pandas route."""
    t = tdata.create_data_arrays(TRAIN_PARQUET, cs.CALIB_T, cs.CALIB_STRIDE)
    j = jdata.create_data_arrays(TRAIN_PARQUET, cs.CALIB_T, cs.CALIB_STRIDE)
    np.testing.assert_array_equal(t.state_mean, j.state_mean)
    np.testing.assert_array_equal(t.state_std, j.state_std)
    assert cs.TRAIN_NORM == (t.state_mean.astype(np.float64).tolist(),
                             t.state_std.astype(np.float64).tolist())


def test_mimic_metrics_constants_are_jax_and_the_port_meets_them(tmp_path):
    ref = jax_mimic_metrics()
    for k, v in cs.REF_MIMIC_METRICS.items():
        assert v == pytest.approx(ref[k], rel=1e-7), k
    csv = tmimic.MIMICDownloader(output_dir=str(tmp_path)).run(
        **cs.MIMIC_RUN, filename="m.csv")
    _, _, test_ds = cs.mimic_splits(csv)
    from hybrid_ode_torch.evals.evaluate import evaluate_checkpoint

    got = evaluate_checkpoint(str(cs.MIMIC_CKPT), test_ds, device="cpu")
    _assert_close({k: got[k] for k in cs.REF_MIMIC_METRICS}, cs.REF_MIMIC_METRICS, cs.REF_RTOL)


def test_robustness_constants_are_jax_and_the_port_meets_them(tmp_path):
    _assert_close(cs.REF_ROBUSTNESS, jax_robustness(), 1e-7)
    from hybrid_ode_torch.evals import robustness
    from hybrid_ode_torch.utils.convert import params_from_numpy

    csv = tmimic.MIMICDownloader(output_dir=str(tmp_path)).run(**cs.MIMIC_RUN, filename="m.csv")
    _, _, test_ds = cs.mimic_splits(csv)
    state, meta = j_load_checkpoint(str(cs.MIMIC_CKPT))
    from hybrid_ode_torch.models.hybrid import config_from_dict

    rep = robustness.robustness_report(params_from_numpy(state["params"], device="cpu"),
                                       test_ds, config_from_dict(meta["config"]))
    _assert_close({k: {str(x): v for x, v in d.items()} for k, d in rep.items()},
                  cs.REF_ROBUSTNESS, cs.REF_RTOL)


@pytest.mark.slow
def test_protocol_constants_are_jax_and_the_port_meets_them():
    """(c) at full width: K=8, H=128, 80 design windows and 208 calibration
    windows; JAX's optimiser compiles a K=8 gradient through 6 chunks
    (minutes on the CPU)."""
    ref = jax_protocol()
    _assert_close({"loop": cs.REF_LOOP, "opt": cs.REF_OPT, "calib": cs.REF_CALIB}, ref, 1e-7)
    stacked, cfg = cs.protocol_checkpoint(torch.device("cpu"))
    got = cs.protocol_run(stacked, cfg, _norm(), torch.device("cpu"))
    _assert_close({k: got[k] for k in ("loop", "opt", "calib")}, ref, cs.REF_RTOL)


def test_fused_closed_loop_constants_are_jax_and_the_port_meets_them():
    _assert_close(cs.REF_MIMIC_LOOP, jax_mimic_loop(), 1e-7)
    from hybrid_ode_torch.models.hybrid import config_from_dict
    from hybrid_ode_torch.utils.convert import params_from_numpy

    state, meta = j_load_checkpoint(str(cs.MIMIC_CKPT))
    got = cs.mimic_loop_run(params_from_numpy(state["params"], device="cpu"),
                            config_from_dict(meta["config"]), meta, torch.device("cpu"))
    _assert_close(got, cs.REF_MIMIC_LOOP, cs.REF_RTOL)


@pytest.mark.slow
def test_sobol_constants_are_jax_and_the_limit_its_reading():
    """REF_SOBOL is JAX's f32 run; SOBOL_ATOL is three times the distance of
    JAX's f32 indices from its own f64 ones (the estimators divide f32
    output differences by small variances; the small-model reading in
    tests/test_torch_evals_plots.py: each package 8.7e-4 from its f64)."""
    f32, f64 = jax_sobol(False), jax_sobol(True)
    for k in ("S1", "ST"):
        np.testing.assert_allclose(np.asarray(cs.REF_SOBOL[k]), f32[k], rtol=1e-7, atol=1e-12)
    reading = max(float(np.abs(f32[k] - f64[k]).max()) for k in ("S1", "ST"))
    assert cs.SOBOL_ATOL == pytest.approx(3 * reading, rel=1e-6)
