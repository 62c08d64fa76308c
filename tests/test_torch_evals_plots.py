"""Port parity: robustness sweeps, latent metrics, Sobol, figures, tables, profiling.

`hybrid_ode_torch/evals/robustness.py`, `evals/latent.py`, `plots/sobol.py`,
`plots/figures.py`, `plots/intervention.py` and `utils/profiling.py` against
the JAX functions of the same names, on the same numpy inputs, at a small
size (H=16, 2 layers, rk4 with 2 substeps; 4GI windows of 13 points).

Tolerances. Sweep RMSEs (f32): 1e-5 relative (reading 3.4e-7; the
corruption draws are numpy's in both packages, so both corrupt the same
points). Sobol indices against JAX: 1e-4 absolute on the Ishigami function
(reading 3e-7); on the small model's fig2 outputs (n=256) 1e-6 in f64
(reading 1.0e-8) and 3e-3 in f32 (reading 8.1e-4, glucose AUC: each
package's f32 indices are 8.7e-4 from its own f64 ones there, the estimators
dividing f32-rounded output differences by a small variance); against the
Ishigami function's analytic indices, 0.05 at n=4096. Latent metrics, the
CSV and LaTeX tables: equal.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.evals import latent as jlatent
from hybrid_ode_tpu.evals import robustness as jrob
from hybrid_ode_tpu.models import hybrid as jhybrid
from hybrid_ode_tpu.plots import figures as jfig
from hybrid_ode_tpu.plots import sobol as jsobol
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.evals import latent as tlatent
from hybrid_ode_torch.evals import robustness as trob
from hybrid_ode_torch.models.hybrid import HybridConfig as THybridConfig
from hybrid_ode_torch.plots import figures as tfig
from hybrid_ode_torch.plots import intervention as tint
from hybrid_ode_torch.plots import sobol as tsobol
from hybrid_ode_torch.utils import profiling
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SWEEP_RTOL = 1e-5
SOBOL_ISHIGAMI_ATOL = 1e-4
SOBOL_MODEL_ATOL = 3e-3
SOBOL_F64_ATOL = 1e-6
CFG = dict(solver="rk4", substeps=2, nn_hidden=16, nn_layers=2, mode="scan",
           context_points=3, context_dim=4)


def _params(seed=0, K=None):
    jcfg = jhybrid.HybridConfig(**CFG)

    def one(s):
        p = jax.tree_util.tree_map(np.asarray, jhybrid.init_hybrid_params(jax.random.PRNGKey(s),
                                                                          jcfg))
        p["nn"]["w2"] = 0.05 * np.random.default_rng(s).standard_normal(
            p["nn"]["w2"].shape).astype(np.float32)
        return p

    if K is None:
        return one(seed)
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[one(seed + i) for i in range(K)])


def _datasets(n=24):
    path = str(ROOT / "data" / "4gi_dataset.csv")
    t = tdata.create_data_arrays(path, 13, 12)
    j = jdata.create_data_arrays(path, 13, 12, use_native=False)
    idx = np.arange(n)
    return t.select(idx), j.select(idx)


@pytest.mark.parametrize("route", ["single", "fused", "ensemble"])
def test_robustness_report_matches_jax(route, tmp_path):
    tds, jds = _datasets()
    jcfg = jhybrid.HybridConfig(**CFG)
    tcfg = THybridConfig(**CFG, use_pallas=route == "fused")
    ens = route == "ensemble"
    p = _params(K=2 if ens else None)
    sigma = np.array([0.3, 0.2, 0.1, 0.25, 0.0, 0.0], np.float32)
    t = trob.robustness_report(params_from_numpy(p, device="cpu"), tds, tcfg,
                               out_path=str(tmp_path / "t.json"), obs_sigma_z=sigma,
                               n_seeds=2, ensemble=ens)
    j = jrob.robustness_report(p, jds, jcfg, out_path=str(tmp_path / "j.json"),
                               obs_sigma_z=sigma, n_seeds=2, ensemble=ens)
    assert list(t) == list(j)
    for k in j:
        assert list(t[k]) == list(j[k])
        for x in j[k]:
            assert t[k][x] == pytest.approx(j[k][x], rel=SWEEP_RTOL), (k, x)
    tj = json.loads((tmp_path / "t.json").read_text())
    assert list(tj["missing_data"]) == ["0.0", "0.1", "0.3", "0.5"]
    # corruption degrades the conditioning: the 50% row is no better than clean
    assert t["missing_data"][0.5] >= t["missing_data"][0.0] * 0.5


def test_sweeps_with_other_fractions_and_default_sigma_match_jax():
    tds, jds = _datasets(10)
    jcfg = jhybrid.HybridConfig(**CFG)
    tcfg = THybridConfig(**CFG)
    p = _params(3)
    tp = params_from_numpy(p, device="cpu")
    t = trob.missing_data_sweep(tp, tds, tcfg, fractions=(0.0, 0.2), seed=5, state_index=1)
    j = jrob.missing_data_sweep(p, jds, jcfg, fractions=(0.0, 0.2), seed=5, state_index=1)
    for x in j:
        assert t[x] == pytest.approx(j[x], rel=SWEEP_RTOL)
    t = trob.noise_sweep(tp, tds, tcfg, noise_multipliers=(1.0, 3.0), seed=2)
    j = jrob.noise_sweep(p, jds, jcfg, noise_multipliers=(1.0, 3.0), seed=2)
    for x in j:
        assert t[x] == pytest.approx(j[x], rel=SWEEP_RTOL)


def test_estimate_obs_sigma_z_on_a_column_table_matches_jax():
    """On the 4GI file every row is charted; on an ICU cohort the observed
    columns are NaN between charting events, and both packages return NaN
    there (numpy's std of the raw residuals; ROADMAP Queue C)."""
    csv_path = str(ROOT / "data" / "4gi_dataset.csv")
    tds, jds = _datasets()
    t = trob.estimate_obs_sigma_z(tds, pd.read_csv(csv_path).to_dict("series"))
    np.testing.assert_array_equal(t, jrob.estimate_obs_sigma_z(jds, pd.read_csv(csv_path)))
    assert (t[:4] > 0).all() and (t[4:] == 0).all()
    path = str(ROOT / "data" / "icu_cohort.parquet")
    tds = tdata.create_data_arrays(path, 61, 24)
    t = trob.estimate_obs_sigma_z(tds, tdata.read_parquet_columns(path))
    np.testing.assert_array_equal(t, jrob.estimate_obs_sigma_z(jdata.create_data_arrays(
        path, 61, 24), pd.read_parquet(path)))
    assert np.isnan(t[:4]).all()


def test_latent_recovery_metrics_equal_jax():
    rng = np.random.default_rng(0)
    truth = np.cumsum(rng.standard_normal((3, 25)), axis=-1)
    pred = truth * 0.8 + 0.3 * rng.standard_normal(truth.shape)
    for p, t in ((pred, truth), (pred[0], truth[0])):
        assert tlatent.latent_recovery_metrics(p, t) == jlatent.latent_recovery_metrics(p, t)
    assert tlatent.dtw_distance(pred[1], truth[2]) == jlatent.dtw_distance(pred[1], truth[2])


# ---------------------------------------------------------------------------
# Sobol
# ---------------------------------------------------------------------------

ISHIGAMI = {"x1": (-np.pi, np.pi), "x2": (-np.pi, np.pi), "x3": (-np.pi, np.pi)}


def _ishigami_t(o):
    x1, x2, x3 = o["x1"], o["x2"], o["x3"]
    return (torch.sin(x1) + 7.0 * torch.sin(x2) ** 2 + 0.1 * x3 ** 4 * torch.sin(x1))[:, None]


def _ishigami_j(o):
    x1, x2, x3 = o["x1"], o["x2"], o["x3"]
    return jnp.stack([jnp.sin(x1) + 7.0 * jnp.sin(x2) ** 2 + 0.1 * x3 ** 4 * jnp.sin(x1)])


def test_sobol_on_ishigami_against_analytic_and_jax():
    t = tsobol.sobol_sensitivity(_ishigami_t, ISHIGAMI, n=4096, batch_size=5000, n_boot=20,
                                 device="cpu")
    # analytic indices of the Ishigami function (a=7, b=0.1)
    np.testing.assert_allclose(t["S1"][:, 0], [0.3139, 0.4424, 0.0], atol=0.05)
    np.testing.assert_allclose(t["ST"][:, 0], [0.5576, 0.4424, 0.2437], atol=0.05)
    j = jsobol.sobol_sensitivity(_ishigami_j, ISHIGAMI, n=4096, batch_size=5000, n_boot=20)
    assert t["names"] == j["names"]
    for k in ("S1", "ST", "S1_conf", "ST_conf"):
        np.testing.assert_allclose(t[k], j[k], atol=SOBOL_ISHIGAMI_ATOL)
    A, B, AB = tsobol.saltelli_sample(list(ISHIGAMI.values()), 100, seed=3)
    jA, jB, jAB = jsobol.saltelli_sample(list(ISHIGAMI.values()), 100, seed=3)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(AB, jAB)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sobol_fig2_simulator_matches_jax(dtype):
    jcfg = jhybrid.HybridConfig(**CFG)
    tcfg = THybridConfig(**CFG)
    p = _params(1)
    f64 = dtype == "f64"
    with jax.enable_x64(f64):
        jp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64 if f64 else jnp.float32), p)
        ts = tfig.make_fig2_simulator(params_from_numpy(
            p, device="cpu", dtype=torch.float64 if f64 else torch.float32), tcfg)
        t = tsobol.sobol_sensitivity(ts, n=256, batch_size=1024, device="cpu")
        j = jsobol.sobol_sensitivity(jfig.make_fig2_simulator(jp, jcfg), n=256, batch_size=1024)
    for k in ("S1", "ST"):
        np.testing.assert_allclose(t[k], j[k], atol=SOBOL_F64_ATOL if f64 else SOBOL_MODEL_ATOL)
    # the glucose-trajectory outputs, row for row
    rows = {k: torch.tensor([lo, (lo + hi) / 2], dtype=torch.float32)
            for k, (lo, hi) in tsobol.DEFAULT_PROBLEM.items()}
    tg = tfig.make_fig2_simulator(params_from_numpy(p, device="cpu"), tcfg, "glucose_t")(rows)
    jg = jfig.make_fig2_simulator(jax.tree_util.tree_map(jnp.asarray, p), jcfg, "glucose_t")
    for i in range(2):
        np.testing.assert_allclose(tg[i].numpy(), np.asarray(jg({k: v[i].numpy()
                                                                  for k, v in rows.items()})),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# figures, tables, profiling
# ---------------------------------------------------------------------------

def test_figures_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    tds, _ = _datasets(4)
    tcfg = THybridConfig(**CFG)
    tp = params_from_numpy(_params(), device="cpu")
    out = tfig.plot_fig1_predictions(tp, tds, tcfg, str(tmp_path / "f1.png"))
    assert Path(out).stat().st_size > 0
    res = tfig.plot_fig2_sensitivity(tp, tcfg, str(tmp_path / "f2.png"), n_samples=16)
    assert res["S1"].shape == (7, 3) and (tmp_path / "f2.png").stat().st_size > 0
    assert tfig.plot_fig3_posterior_bands(tp, tds, tcfg, None, str(tmp_path / "f3.png")) \
        == str(tmp_path / "f3.png")
    from hybrid_ode_torch.inference.vi import VariationalInference

    vi = VariationalInference(tp, tcfg, n_samples=2, noise_sigma=0.3)
    tfig.plot_fig3_posterior_bands(tp, tds, tcfg, vi, str(tmp_path / "f3_vi.png"),
                                   n_samples=4)
    assert (tmp_path / "f3_vi.png").stat().st_size > 0
    art = {"arms": {s: {"true_mean_glucose": 7.0 - float(s), "pred_mean_glucose": 7.1 - float(s)}
                    for s in ("0.0", "1.0", "2.0")},
           "policy_effects_vs_factual": {"0.0": {"e_true": [0.1, 0.4], "e_model": [0.2, 0.3],
                                                 "pearson_r": 0.5, "sign_agreement_pct": 100}}}
    (tmp_path / "a.json").write_text(json.dumps(art))
    assert Path(tint.fig_intervention(str(tmp_path / "a.json"), None,
                                      str(tmp_path / "fi.png"))).stat().st_size > 0


def test_performance_tables_equal_jax(tmp_path):
    pytest.importorskip("pandas")
    metrics = {"Hybrid ODE-NN": {"rmse": 0.35909, "mae": 0.1 + 0.2, "nrmse": 1 / 3, "r2": 0.9,
                                 "rmse_glucose": 0.48970083, "rmse_insulin": 2.5,
                                 "rmse_ge": 0.0},
               "Hybrid ODE-NN (VI)": {"rmse": 0.41, "ece": 0.021, "coverage_95": 0.93}}
    tfig.generate_performance_tables(metrics, str(tmp_path / "t"))
    jfig.generate_performance_tables(metrics, str(tmp_path / "j"))
    for stem in ("table3_overall", "table4_per_state", "table5_models"):
        for ext in (".csv", ".tex"):
            assert (tmp_path / "t" / f"{stem}{ext}").read_text() == \
                (tmp_path / "j" / f"{stem}{ext}").read_text(), stem + ext


def test_profiling_trace_debug_mode_and_throughput(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
    before = torch.get_default_dtype()
    with profiling.debug_mode(enable_x64=True):
        assert torch.get_default_dtype() == torch.float64
        a = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError):
            torch.sqrt(a * 0.0 - 1.0).sum().backward()
    assert torch.get_default_dtype() == before
    tp = profiling.Throughput("rows")
    tp.tick(10)
    assert tp.per_sec > 0 and "rows" in tp.report()
