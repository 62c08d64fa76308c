"""Port parity: Parquet input, the MIMIC records and the ICU cohort generators.

`hybrid_ode_torch/data/dataset.py`'s Parquet route, `data/mimic.py` and
`evals/evaluate.py::glucose_truth_rmse`, against the JAX functions of the
same names on the same seeds.

Tolerances. Datasets from Parquet and the MIMIC records: bit for bit. The ICU
generator (dopri5 'while', rtol 1e-5, closed loop) at 3 patients x 4 h, each
column's largest difference over its largest value: in f64 against the JAX
package's solve of the same field (its `icu_field` and vmapped dopri5) put in
the port's place, 1e-11 (reading 9.2e-14); in f32 against the JAX package's
f32 cohort, 1e-3 (reading 2.5e-4, observed insulin; the solves part at
1.7e-4 of glucose where rtol 1e-5 sits near f32 resolution), and for tvns 1e-2
(reading 3.7e-3: the sliding scale multiplies that glucose difference by a
gain of 900 against a column whose largest rate is a few hundred pmol/h).
Draws and schedules (carb, charting, diabetic, time): equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.data import mimic as jmimic
from hybrid_ode_tpu.dynamics import fourgi as jfourgi
from hybrid_ode_tpu.evals import evaluate as jeval
from hybrid_ode_tpu.solvers.api import odeint as j_odeint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.data import mimic as tmimic
from hybrid_ode_torch.evals import evaluate as teval

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PARQUETS = ["icu_cohort", "icu_cohort_dysglycemic", "icu_cohort_varied",
            "mimic_glucose_insulin"]
F64_LIMIT = 1e-11
F32_LIMIT = 1e-3
TVNS_F32_LIMIT = 1e-2
SCHEDULE_COLS = ("subject_id", "time_minutes", "meal_indicator", "diabetic")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isfinite(b)
    assert np.array_equal(ok, np.isfinite(a))
    return float(np.abs(a[ok] - b[ok]).max() / max(np.abs(b[ok]).max(), 1e-30))


def _assert_datasets_equal(t, j):
    for name in ("initial_state", "observations", "time_points", "meal", "tvns", "mask",
                 "state_mean", "state_std", "loss_weights"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t.subject_ids, j.subject_ids)
    if j.mask_channels is None:
        assert t.mask_channels is None
    else:
        np.testing.assert_array_equal(t.mask_channels, j.mask_channels)


# ---------------------------------------------------------------------------
# the Parquet route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PARQUETS)
@pytest.mark.parametrize("per_channel_mask", [False, True])
def test_parquet_route_matches_jax(name, per_channel_mask):
    path = str(ROOT / "data" / f"{name}.parquet")
    t = tdata.create_data_arrays(path, 61, 24, per_channel_mask=per_channel_mask)
    assert tdata.last_route == "parquet"
    j = jdata.create_data_arrays(path, 61, 24, per_channel_mask=per_channel_mask)
    _assert_datasets_equal(t, j)


@pytest.mark.parametrize("name", PARQUETS[1:])
def test_parquet_route_with_external_norm_stats_matches_jax(name):
    ref = str(ROOT / "data" / "icu_cohort.parquet")
    stats = jdata.create_data_arrays(ref, 61, 24)
    norm = (stats.state_mean.astype(np.float64), stats.state_std.astype(np.float64))
    path = str(ROOT / "data" / f"{name}.parquet")
    _assert_datasets_equal(tdata.create_data_arrays(path, 73, 72, norm_stats=norm),
                           jdata.create_data_arrays(path, 73, 72, norm_stats=norm))


def test_parquet_route_placeholders_time_and_nulls(tmp_path):
    """A file without ge / ffa / tvns / meal / time columns, with nulls,
    f32 minutes and unsorted subjects: JAX's placeholders and the groupby's
    sorted order."""
    rng = np.random.default_rng(0)
    n = 90
    df = pd.DataFrame({
        "subject_id": np.repeat([7, 2, 5], n // 3),
        "glucose_mmol_L": rng.uniform(4, 9, n),
        "insulin_pmol_L": np.where(rng.uniform(size=n) < 0.2, np.nan, rng.uniform(20, 90, n)),
        "glucagon_pmol_L": rng.uniform(20, 60, n),
        "glp1_pmol_L": rng.uniform(5, 30, n),
    })
    for time in (None, "time_minutes", "time_hours"):
        d = df.copy()
        if time == "time_minutes":
            d[time] = (np.tile(np.arange(n // 3), 3) * 5.0).astype(np.float32)
        elif time == "time_hours":
            d[time] = np.tile(np.arange(n // 3), 3) / 12.0
        path = str(tmp_path / f"t_{time}.parquet")
        d.to_parquet(path, index=False)
        for pcm in (False, True):
            _assert_datasets_equal(tdata.create_data_arrays(path, 10, 7, per_channel_mask=pcm),
                                   jdata.create_data_arrays(path, 10, 7, per_channel_mask=pcm))


def test_glucose_truth_rmse_reads_parquet_like_jax(tmp_path):
    csv_path = ROOT / "data" / "4gi_dataset.csv"
    path = str(tmp_path / "cohort.parquet")
    pd.read_csv(csv_path).to_parquet(path)   # keeps a pandas index column
    ds = tdata.create_data_arrays(path, 13, 6)
    preds = ds.observations + 0.01 * np.random.default_rng(1).standard_normal(
        ds.observations.shape).astype(np.float32)
    assert teval.glucose_truth_rmse(preds, ds, path) == jeval.glucose_truth_rmse(preds, ds, path)
    assert teval.glucose_truth_rmse(preds, ds, path) == pytest.approx(
        teval.glucose_truth_rmse(preds, ds, str(csv_path)), rel=1e-12)


def test_glucose_truth_rmse_on_icu_files_raises_like_jax():
    """ICU files carry time_minutes only: the JAX reader finds no time column
    (StopIteration), and the port follows it (ROADMAP Queue C)."""
    path = str(ROOT / "data" / "icu_cohort.parquet")
    ds = tdata.create_data_arrays(path, 61, 240)
    for fn in (teval.glucose_truth_rmse, jeval.glucose_truth_rmse):
        with pytest.raises(StopIteration):
            fn(ds.observations, ds, path)


def test_parquet_without_pyarrow_raises_naming_it(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **k):
        if name.startswith("pyarrow"):
            raise ImportError("No module named 'pyarrow'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError, match="pyarrow"):
        tdata.create_data_arrays(str(ROOT / "data" / "icu_cohort.parquet"))
    with pytest.raises(ImportError, match="pyarrow"):
        tdata.write_table({"a": np.zeros(2)}, tmp_path / "x.parquet")
    tdata.write_table({"a": np.zeros(2)}, tmp_path / "x.csv")  # CSV needs none


# ---------------------------------------------------------------------------
# MIMIC records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interpolate", [True, False])
def test_mimic_run_is_bitwise_jax(interpolate, tmp_path):
    tp = tmimic.MIMICDownloader(output_dir=str(tmp_path / "t")).run(
        n_patients=100, grid_minutes=5.0, interpolate=interpolate, seed=0)
    jp = jmimic.MIMICDownloader(output_dir=str(tmp_path / "j")).run(
        n_patients=100, grid_minutes=5.0, interpolate=interpolate, seed=0)
    t, j = pd.read_parquet(tp), pd.read_parquet(jp)
    pd.testing.assert_frame_equal(t, j, check_exact=True)
    tm, jm = pq.read_table(tp).schema.metadata, pq.read_table(jp).schema.metadata
    assert {k: v for k, v in tm.items() if k != b"generator"} == \
        {k: v for k, v in jm.items() if k not in (b"generator", b"pandas")}
    if interpolate:   # the parameters in the committed file's metadata
        committed = pd.read_parquet(ROOT / "data" / "mimic_glucose_insulin.parquet")
        pd.testing.assert_frame_equal(t, committed, check_exact=True)
        assert len(t) == 20325


def test_mimic_csv_reads_back_exactly(tmp_path):
    d = tmimic.MIMICDownloader(output_dir=str(tmp_path))
    pq_path = d.run(n_patients=6, seed=3)
    csv_path = d.run(n_patients=6, seed=3, filename="m.csv")
    _assert_datasets_equal(tdata.create_data_arrays(str(csv_path), 20, 10, use_native=False),
                           tdata.create_data_arrays(str(pq_path), 20, 10))
    back = pd.read_csv(csv_path, float_precision="round_trip")
    pd.testing.assert_frame_equal(back, pd.read_parquet(pq_path), check_exact=True)


@pytest.mark.parametrize("completeness", [0.0, 0.9])
def test_clean_matches_jax(completeness):
    """Outliers (and NaN cells) in glucose and insulin, pandas' NaN-skipping
    ddof=1 statistics, the completeness filter."""
    rng = np.random.default_rng(4)
    n = 400
    table = {"subject_id": np.repeat(np.arange(8), n // 8),
             "time_minutes": np.tile(np.arange(n // 8) * 5.0, 8),
             "glucose_mmol_L": rng.normal(6, 1, n), "insulin_pmol_L": rng.normal(60, 10, n),
             "glucagon_pmol_L": rng.normal(80, 5, n), "glp1_pmol_L": rng.normal(20, 2, n),
             "diabetic": np.zeros(n, bool)}
    table["glucose_mmol_L"][[3, 77, 200]] = [40.0, -30.0, 35.0]
    table["insulin_pmol_L"][[5, 300]] = [900.0, 800.0]
    table["glucose_mmol_L"][rng.uniform(size=n) < 0.1] = np.nan
    table["glucose_mmol_L"][:45] = np.nan            # subject 0 mostly uncharted
    t = tmimic.MIMICDownloader.clean(None, table, 4.0, completeness)
    j = jmimic.MIMICDownloader.clean(None, pd.DataFrame(table), 4.0, completeness)
    if completeness == 0:
        assert np.isnan(t["glucose_mmol_L"][[3, 77, 200]]).all()
        assert np.isnan(t["insulin_pmol_L"][[5, 300]]).all()
    else:
        assert len(t["subject_id"]) < n
    pd.testing.assert_frame_equal(pd.DataFrame(t), j.reset_index(drop=True), check_exact=True)


# ---------------------------------------------------------------------------
# ICU cohorts
# ---------------------------------------------------------------------------

def _jax_f64_solve(f, y0, ts, args, **kw):
    """The JAX package's ICU chunk solve (`hybrid_ode_tpu/data/mimic.py`'s
    icu_field and vmapped dopri5 'while') in f64 on the port's inputs."""
    params, carb, prod_mod, ts_full, _, ins_rate = args
    def to(x):
        return jnp.asarray(x.cpu().numpy())

    def field(t, y, a):
        p, carb_i, mod_i, rate_i, tsf = a
        idx = jnp.clip(jnp.searchsorted(tsf, t, side="right") - 1, 0, tsf.shape[0] - 2)
        dy = jfourgi.fourgi_field(t, y, p, {"meal_rate": carb_i[idx],
                                            "secretion_scale": p["secretion_scale"]})
        KINglc = p["BSLglc"] * (p["CLglc"] + p["CLglci"] * p["BSLins"])
        dy = dy.at[0].add(KINglc * (mod_i[idx] - 1.0))
        return dy.at[1].add(rate_i)

    with jax.enable_x64(True):
        tsf, ts_k = to(ts_full), to(ts)

        def one(y0_i, carb_i, mod_i, rate_i, p):
            return j_odeint(field, y0_i, ts_k, (p, carb_i, mod_i, rate_i, tsf),
                            solver="dopri5", rtol=1e-5, atol=1e-7, mode="while",
                            max_steps_per_interval=32, checkpoint_intervals=False)

        out = jax.vmap(one)(to(y0), to(carb), to(prod_mod), to(ins_rate),
                            {k: to(v) for k, v in params.items()})
        return torch.tensor(np.asarray(out))


ICU_KW = dict(n_patients=3, hours=4.0, seed=3)


@pytest.mark.parametrize("kind", ["standard", "dysglycemic_varied", "per_channel"])
def test_icu_cohort_f64_against_the_jax_solve(kind, tmp_path, monkeypatch):
    def gen(**kw):
        path = str(tmp_path / "c.csv")
        if kind == "dysglycemic_varied":
            return tmimic.generate_icu_cohort_dysglycemic(path, varied_protocol=True, **kw)
        return tmimic.generate_icu_cohort(path, per_channel_charting=kind == "per_channel", **kw)

    port = gen(device="cpu", dtype=torch.float64, **ICU_KW)
    monkeypatch.setattr(tmimic, "odeint", _jax_f64_solve)
    ref = gen(device="cpu", dtype=torch.float64, **ICU_KW)
    assert list(port) == list(ref)
    for c in port:
        if c in SCHEDULE_COLS:
            np.testing.assert_array_equal(port[c], ref[c])
        else:
            assert _rel(port[c], ref[c]) < F64_LIMIT, c


@pytest.mark.parametrize("kw", [dict(), dict(per_channel_charting=True),
                                dict(dose_scale=0.0), dict(protocol_basal=3000.0)])
def test_icu_cohort_matches_jax_in_f32(kw, tmp_path):
    t = tmimic.generate_icu_cohort(str(tmp_path / "t.parquet"), device="cpu", **ICU_KW, **kw)
    j = jmimic.generate_icu_cohort(str(tmp_path / "j.parquet"), **ICU_KW, **kw)
    assert list(t) == list(j.columns)
    for c in j.columns:
        assert t[c].dtype == j[c].to_numpy().dtype, c
        if c in SCHEDULE_COLS:
            np.testing.assert_array_equal(t[c], j[c].to_numpy())
        else:
            assert _rel(t[c], j[c].to_numpy()) < (TVNS_F32_LIMIT if c == "tvns" else F32_LIMIT), c
    tm = pq.read_table(tmp_path / "t.parquet").schema.metadata
    jm = pq.read_table(tmp_path / "j.parquet").schema.metadata
    assert {k: v for k, v in tm.items() if k != b"generator"} == \
        {k: v for k, v in jm.items() if k not in (b"generator", b"pandas")}


def test_paired_counterfactual_cohorts_share_their_noise(tmp_path):
    """dose_scale and the protocol draw nothing: the same patients, feeds,
    stress, charting events and assay noise; only the insulin path moves."""
    arms = [tmimic.generate_icu_cohort(str(tmp_path / f"{i}.csv"), device="cpu", **ICU_KW,
                                       **kw)
            for i, kw in enumerate([dict(), dict(dose_scale=0.0),
                                    dict(protocol_gain=1800.0, protocol_target=5.5)])]
    for c in SCHEDULE_COLS:
        for arm in arms[1:]:
            np.testing.assert_array_equal(arms[0][c], arm[c])
    for arm in arms[1:]:
        np.testing.assert_array_equal(np.isnan(arms[0]["glucose_mmol_L"]),
                                      np.isnan(arm["glucose_mmol_L"]))
        assert not np.array_equal(arms[0]["tvns"], arm["tvns"])
    assert (arms[1]["tvns"] == 0).all()
    # the assay noise is shared: observed / true is the same draw in every arm
    obs = ~np.isnan(arms[0]["glucose_mmol_L"])
    ratio = [a["glucose_mmol_L"][obs] / a["glucose_true_mmol_L"][obs] for a in arms]
    for r in ratio[1:]:
        np.testing.assert_allclose(r, ratio[0], rtol=1e-12)


def test_varied_and_dysglycemic_draws_match_jax(tmp_path):
    for n, seed in ((5, 0), (80, 0), (16, 1313)):
        t, j = tmimic.dysglycemic_severity(n, seed), jmimic.dysglycemic_severity(n, seed)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1]["CLglci"], j[1]["CLglci"])
        np.testing.assert_array_equal(t[2], j[2])
    kw = dict(n_patients=4, hours=2.0, seed=5)
    for name, extra in (("generate_icu_cohort_varied", {}),
                        ("generate_icu_cohort_dysglycemic", {"varied_protocol": True}),
                        ("generate_icu_cohort_dysglycemic", {})):
        getattr(tmimic, name)(str(tmp_path / "t.parquet"), device="cpu", **kw, **extra)
        getattr(jmimic, name)(str(tmp_path / "j.parquet"), **kw, **extra)
        tm = pq.read_table(tmp_path / "t.parquet").schema.metadata
        jm = pq.read_table(tmp_path / "j.parquet").schema.metadata
        for key in (b"protocol_gain", b"protocol_target", b"protocol_basal",
                    b"protocol_max_rate", b"secretion_scale", b"dose_scale"):
            assert tm[key] == jm[key], (name, key)


def test_files_read_back_in_the_other_package(tmp_path):
    t = tmimic.generate_icu_cohort(str(tmp_path / "t.parquet"), device="cpu", **ICU_KW)
    j = jmimic.generate_icu_cohort(str(tmp_path / "j.parquet"), **ICU_KW)
    # the port's Parquet through pandas, the JAX package's through the port
    back_t = pd.read_parquet(tmp_path / "t.parquet")
    back_j = tdata.read_parquet_columns(str(tmp_path / "j.parquet"))
    for c in j.columns:
        np.testing.assert_array_equal(back_t[c].to_numpy(), t[c])
        np.testing.assert_array_equal(back_j[c], j[c].to_numpy())
    for name in ("t", "j"):
        path = str(tmp_path / f"{name}.parquet")
        _assert_datasets_equal(tdata.create_data_arrays(path, 13, 12, per_channel_mask=True),
                               jdata.create_data_arrays(path, 13, 12, per_channel_mask=True))
    # the port's CSV: the same windows as its Parquet, in both packages' CSV readers
    tdata.write_table(t, tmp_path / "t.csv")
    _assert_datasets_equal(tdata.create_data_arrays(str(tmp_path / "t.csv"), 13, 12,
                                                    use_native=False),
                           tdata.create_data_arrays(str(tmp_path / "t.parquet"), 13, 12))
    back_csv = pd.read_csv(tmp_path / "t.csv", float_precision="round_trip")
    for c in j.columns:
        np.testing.assert_array_equal(back_csv[c].to_numpy(), t[c].astype(back_csv[c].dtype))
