"""Port parity: the 4GI generator, the native loader and the dynamics helpers.

`hybrid_ode_torch/dynamics/fourgi.py`, `data/fourgi_gen.py`,
`data/native_loader.py` with the native route of `data/dataset.py`, and
`make_controls`, `check_mass_balance`, `feature_importance` and
`mlp_apply(dropout=)`, against the JAX functions of the same names on the
same numpy inputs.

Tolerances. The 4GI field in f64: 1e-12 relative. The cohort solve (dopri5,
'while', rtol 1e-6, 64 steps per interval) in f64: equal per-subject
accepted / rejected step counts; 1e-12 before the first meal; 1e-6 over the
whole trajectory. Where a dopri5 stage lands within roundoff of a meal
pulse's edge the zero-order hold reads one interval's rate or the next, so
the last bit of a step size moves the solution: a nudge of one input by
2e-16 moves the port's own output by 1e-7, and the JAX package's alike
(`test_cohort_solve_is_ill_conditioned_at_the_meal_edges_in_both_packages`);
the two packages part by 5.4e-8 (reading). In f32 the limit is 1e-3 of each
channel's largest value (reading 4.2e-4, glucagon). Datasets: bit for bit.
"""

import csv
import dataclasses
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.data import fourgi_gen as jgen
from hybrid_ode_tpu.data import native_loader as jnative
from hybrid_ode_tpu.dynamics import controls as jcontrols
from hybrid_ode_tpu.dynamics import fourgi as jfourgi
from hybrid_ode_tpu.dynamics import ode_core as jode
from hybrid_ode_tpu.dynamics import residual as jres
from hybrid_ode_tpu.solvers.api import odeint as j_odeint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.data import fourgi_gen as tgen
from hybrid_ode_torch.data import native_loader as tnative
from hybrid_ode_torch.dynamics import controls as tcontrols
from hybrid_ode_torch.dynamics import fourgi as tfourgi
from hybrid_ode_torch.dynamics import ode_core as tode
from hybrid_ode_torch.dynamics import residual as tres

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "4gi_dataset.csv")
N_SUBJECTS = 16
F32_RTOL = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _jax_multipliers(key, n):
    """The JAX package's per-subject draws of `simulate_cohort(key, n)`."""
    keys = jax.random.split(key, len(tgen.BASELINE_CVS))
    return {name: np.asarray(1.0 + cv * jax.random.normal(k, (n,)))
            for (name, cv), k in zip(tgen.BASELINE_CVS.items(), keys)}


# ---------------------------------------------------------------------------
# the 4GI field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patient_type", ["T2DM", "HV"])
def test_fourgi_field_matches_jax_in_f64(patient_type):
    rng = np.random.default_rng(0)
    n = 64
    with jax.enable_x64(True):
        jp = jfourgi.fourgi_params(patient_type, jnp.float64)
        p = {k: np.asarray(v) for k, v in jp.items()}
        # per-sample baselines, as the cohort solve has them
        for name in tgen.BASELINE_CVS:
            p[name] = p[name] * (1 + 0.1 * rng.normal(size=n))
        y0 = np.asarray(jfourgi.fourgi_initial_state({k: jnp.asarray(v) for k, v in p.items()}))
        # states around baseline: glucose both sides of BSLglc (the glucagon
        # feedback's regime switch), meals on and off, a secretion scale
        y = y0 * rng.uniform(0.3, 2.0, size=(n, 8))
        inputs = {"meal_rate": np.where(rng.uniform(size=n) > 0.5, 900.0, 0.0),
                  "secretion_scale": rng.uniform(0.5, 1.0, size=n)}
        ref = np.asarray(jfourgi.fourgi_field(0.0, jnp.asarray(y),
                                              {k: jnp.asarray(v) for k, v in p.items()},
                                              {k: jnp.asarray(v) for k, v in inputs.items()}))
        ref_conc = {k: np.asarray(v) for k, v in jfourgi.fourgi_concentrations(
            jnp.asarray(y), {k: jnp.asarray(v) for k, v in p.items()}).items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    got = tfourgi.fourgi_field(torch.tensor(0.0, dtype=torch.float64), torch.as_tensor(y), tp,
                               {k: torch.as_tensor(v) for k, v in inputs.items()}).numpy()
    assert got.dtype == np.float64
    assert _rel(ref, got) < 1e-12
    np.testing.assert_allclose(tfourgi.fourgi_initial_state(tp).numpy(), y0, rtol=1e-15)
    for k, v in tfourgi.fourgi_concentrations(torch.as_tensor(y), tp).items():
        np.testing.assert_allclose(v.numpy(), ref_conc[k], rtol=1e-15)
    cpu = tfourgi.fourgi_params(patient_type, torch.float64, "cpu")
    assert {k: float(v) for k, v in cpu.items()} == {k: float(v) for k, v in jp.items()}


def test_fourgi_params_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tfourgi.fourgi_params()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tgen.simulate_cohort(n_subjects=2)


# ---------------------------------------------------------------------------
# the cohort solve
# ---------------------------------------------------------------------------

def _jax_cohort(mults, dtype=jnp.float64, rtol=1e-6, atol=1e-8):
    """JAX `simulate_cohort`'s solve (its field, grid and solver call) on
    given multipliers, constants in `dtype`, with per-subject step counts."""
    p = jfourgi.fourgi_params("T2DM", dtype)
    t_hours = np.arange(0.0, 5.0 + 5.0 / 60.0, 5.0 / 60.0)
    ts = jnp.asarray(t_hours, jnp.float32)
    meal_grid = jnp.asarray(jgen._meal_rate_on_grid(t_hours, (1.0, 3.0), (75.0, 50.0)),
                            jnp.float32)

    def field(t, y, args):
        params, meal = args
        idx = jnp.clip(jnp.searchsorted(ts, t, side="right") - 1, 0, len(t_hours) - 2)
        return jfourgi.fourgi_field(t, y, params, {"meal_rate": meal[idx]})

    def one(m):
        pi = dict(p)
        for name in tgen.BASELINE_CVS:
            pi[name] = p[name] * m[name]
        return j_odeint(field, jfourgi.fourgi_initial_state(pi), ts, (pi, meal_grid),
                        solver="dopri5", rtol=rtol, atol=atol, mode="while",
                        max_steps_per_interval=64, checkpoint_intervals=False,
                        return_stats=True)

    ys, st = jax.jit(jax.vmap(one))({k: jnp.asarray(v) for k, v in mults.items()})
    conc = jfourgi.fourgi_concentrations(ys, p)
    return ({k: np.asarray(v) for k, v in conc.items()}, np.asarray(st.n_accepted),
            np.asarray(st.n_rejected), np.asarray(st.success))


@pytest.fixture(scope="module")
def cohort_f64():
    with jax.enable_x64(True):
        mults = _jax_multipliers(jax.random.PRNGKey(3), N_SUBJECTS)
        ref = _jax_cohort(mults)
        # the package's own entry point, its constants as f64 numbers
        orig = jgen.fourgi_params
        try:
            jgen.fourgi_params = lambda pt: jfourgi.fourgi_params(pt, jnp.float64)
            _, via_entry = jgen.simulate_cohort(jax.random.PRNGKey(3), N_SUBJECTS)
        finally:
            jgen.fourgi_params = orig
    t_hours, conc, stats = tgen.simulate_cohort(None, N_SUBJECTS, multipliers=mults,
                                                dtype=torch.float64, device="cpu",
                                                return_stats=True)
    return mults, ref, {k: np.asarray(v) for k, v in via_entry.items()}, t_hours, conc, stats


def test_simulate_cohort_matches_jax_in_f64(cohort_f64):
    mults, (ref, nacc, nrej, success), via_entry, t_hours, conc, stats = cohort_f64
    np.testing.assert_array_equal(stats.n_accepted.numpy(), nacc)
    np.testing.assert_array_equal(stats.n_rejected.numpy(), nrej)
    # some subjects exhaust the 64-step budget of a meal interval in f64, in
    # both packages alike (the reference generator does not check)
    np.testing.assert_array_equal(stats.success.numpy(), success)
    before_meal = t_hours < 1.0
    for name, v in conc.items():
        got = v.numpy()
        assert got.dtype == np.float64 and got.shape == (N_SUBJECTS, len(t_hours))
        np.testing.assert_array_equal(ref[name], via_entry[name])
        assert _rel(ref[name][:, before_meal], got[:, before_meal]) < 1e-12, name
        assert _rel(ref[name], got) < 1e-6, name


def test_cohort_solve_is_ill_conditioned_at_the_meal_edges_in_both_packages(cohort_f64):
    """A 2e-16 nudge of one input moves either package's output by far more
    than the packages part: the f64 parity above is held at 1e-6, not 1e-9."""
    mults, (ref, *_), _, _, conc, _ = cohort_f64
    nudged = dict(mults, BSLglc=mults["BSLglc"] * (1 + 2e-16))
    with jax.enable_x64(True):
        ref_n = _jax_cohort(nudged)[0]
    _, conc_n = tgen.simulate_cohort(None, N_SUBJECTS, multipliers=nudged, dtype=torch.float64,
                                     device="cpu")
    jax_move = max(_rel(ref[k], ref_n[k]) for k in ref)
    port_move = max(_rel(conc[k].numpy(), conc_n[k].numpy()) for k in conc)
    apart = max(_rel(ref[k], conc[k].numpy()) for k in ref)
    assert jax_move > 1e-9 and port_move > 1e-9
    assert apart < 10 * max(jax_move, port_move)


def test_simulate_cohort_matches_jax_in_f32():
    key = jax.random.PRNGKey(3)
    _, ref = jgen.simulate_cohort(key, 20)
    mults = _jax_multipliers(key, 20)
    via_helper = _jax_cohort(mults, jnp.float32)[0]
    t_hours, got = tgen.simulate_cohort(None, 20, multipliers=mults, device="cpu")
    for name in ref:
        np.testing.assert_array_equal(np.asarray(ref[name]), via_helper[name])
        assert got[name].dtype == torch.float32
        assert _rel(ref[name], got[name].numpy()) < F32_RTOL, name


def test_chip_smoke_cohort_references_are_the_jax_package_values():
    """chip_smoke.py 4e (a) holds the card's 50-subject cohort to these."""
    import chip_smoke

    ref = _jax_cohort(chip_smoke.cohort_multipliers(chip_smoke.COHORT_SUBJECTS),
                      jnp.float32)[0]
    sums = {k: float(np.asarray(v, np.float64).sum()) for k, v in ref.items()}
    assert sorted(sums) == sorted(chip_smoke.REF_COHORT_SUMS)
    for k, v in sums.items():
        assert v == pytest.approx(chip_smoke.REF_COHORT_SUMS[k], rel=1e-9), k


def test_simulate_cohort_draws_from_its_generator():
    a = tgen.simulate_cohort(torch.Generator().manual_seed(1), 3, device="cpu", duration_hours=0.5)
    b = tgen.simulate_cohort(torch.Generator().manual_seed(1), 3, device="cpu", duration_hours=0.5)
    c = tgen.simulate_cohort(torch.Generator().manual_seed(2), 3, device="cpu", duration_hours=0.5)
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k].numpy(), b[1][k].numpy())
    assert not np.array_equal(a[1]["glucose"].numpy(), c[1]["glucose"].numpy())


# ---------------------------------------------------------------------------
# the dataset table and its CSV
# ---------------------------------------------------------------------------

def _jax_draws(seed, n, T):
    """JAX `generate_4gi_dataset(seed=seed)`'s multipliers and noise draws."""
    sim_key, noise_key = jax.random.split(jax.random.PRNGKey(seed))
    nkeys = jax.random.split(noise_key, len(tgen.NOISE_CV_SCALE))
    noise = {name: np.asarray(jax.random.normal(k, (n, T)))
             for name, k in zip(tgen.NOISE_CV_SCALE, nkeys)}
    return _jax_multipliers(sim_key, n), noise


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    n, T = 12, 61
    mults, noise = _jax_draws(5, n, T)
    jdf = jgen.generate_4gi_dataset(str(d / "jax.csv"), seed=5, n_subjects=n)
    table = tgen.generate_4gi_dataset(str(d / "port.csv"), n_subjects=n, multipliers=mults,
                                      noise=noise, device="cpu")
    return d, n, T, mults, noise, jdf, table


def test_generate_4gi_dataset_matches_jax(generated):
    d, n, T, mults, noise, jdf, table = generated
    assert list(table) == list(jdf.columns) == tgen.COLUMNS
    for col in ("subject_id", "time_hours", "time_minutes", "meal_indicator"):
        np.testing.assert_array_equal(table[col], jdf[col].to_numpy(), err_msg=col)
    for name, col in tgen.CHANNEL_COLUMNS.items():
        true_col = tgen.COLUMNS[9 + list(tgen.CHANNEL_COLUMNS).index(name)]
        ref, got = jdf[col].to_numpy(), table[col]
        assert got.dtype == np.float32
        assert _rel(jdf[true_col].to_numpy(), table[true_col]) < F32_RTOL, true_col
        assert _rel(ref, got) < F32_RTOL, col
        # the noise formula, bit for bit, on the port's own simulation
        conc = table[true_col].reshape(n, T)
        scale = np.float32(0.1 * tgen.NOISE_CV_SCALE[name])
        want = conc + scale * np.abs(conc) * noise[name].astype(np.float32)
        np.testing.assert_array_equal(got, want.reshape(-1), err_msg=col)
    # the file: the same header, one row per subject and time, exact values
    with open(d / "port.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == tgen.COLUMNS and len(rows) == n * T + 1
    glucose = np.array([float(r[3]) for r in rows[1:]], np.float64)
    np.testing.assert_array_equal(glucose, table["glucose_mmol_L"].astype(np.float64))


def _fields_equal(a, b, skip=()):
    for f in dataclasses.fields(jdata.GlucoseDataset):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None:
            assert y is None, f.name
            continue
        assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.fixture(scope="module")
def native_lib():
    """The port's build of native/fastwindow.cpp, also lent to the JAX
    package's binding (whose own build is opt-in: `make -C native`)."""
    so = tnative.build_library()
    return so


def test_port_csv_reads_back_like_jax_through_both_routes(generated, native_lib, monkeypatch):
    d = generated[0]
    path = str(d / "port.csv")
    ref = jdata.create_data_arrays(path, 61, 30, use_native=False)
    native = tdata.create_data_arrays(path, 61, 30)
    assert tdata.last_route == "native"
    plain = tdata.create_data_arrays(path, 61, 30, use_native=False)
    assert tdata.last_route == "csv"
    _fields_equal(ref, native)
    _fields_equal(ref, plain)
    monkeypatch.setattr(jnative, "_LIB_PATHS", [native_lib])
    monkeypatch.setattr(jnative, "_lib", None)
    _fields_equal(jdata.create_data_arrays(path, 61, 30, use_native=True), native)


# ---------------------------------------------------------------------------
# the native route
# ---------------------------------------------------------------------------

def _nan_copy(tmp_path):
    """data/4gi_dataset.csv with an empty and a 'nan' state cell."""
    with open(DATA, newline="") as f:
        rows = list(csv.reader(f))
    rows[6][3] = ""
    rows[100][4] = "nan"
    path = tmp_path / "nan.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return str(path)


@pytest.mark.parametrize("which", ["4gi_dataset", "nan_cells"])
def test_native_route_matches_jax_native_and_csv_routes(which, native_lib, tmp_path,
                                                        monkeypatch):
    path = DATA if which == "4gi_dataset" else _nan_copy(tmp_path)
    monkeypatch.setattr(jnative, "_LIB_PATHS", [native_lib])
    monkeypatch.setattr(jnative, "_lib", None)
    j_native = jdata.create_data_arrays(path, 61, 30, use_native=True)
    j_pandas = jdata.create_data_arrays(path, 61, 30, use_native=False)
    native = tdata.create_data_arrays(path, 61, 30)
    assert tdata.last_route == "native"
    plain = tdata.create_data_arrays(path, 61, 30, use_native=False)
    _fields_equal(j_native, native)
    _fields_equal(j_pandas, plain)
    # the file's cells carry more digits than f32: the native route (f32
    # windows, in both packages) and the csv route part in the observations'
    # last bit, by the same amounts in both packages
    _fields_equal(native, plain, skip=("initial_state", "observations"))
    np.testing.assert_array_equal(native.observations - plain.observations,
                                  j_native.observations - j_pandas.observations)
    assert np.abs(native.observations - plain.observations).max() <= 4.8e-7
    if which == "nan_cells":
        assert native.mask[0, 5] == 0.0 and np.isfinite(native.observations).all()


def test_route_selection_is_logged(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="hybrid_ode_torch.data"):
        tdata.create_data_arrays(DATA, 61, 30)
        assert tdata.last_route == "native"
        for kw in ({"per_channel_mask": True}, {"norm_stats": (np.zeros(6), np.ones(6))},
                   {"use_native": False}):
            tdata.create_data_arrays(DATA, 61, 30, **kw)
            assert tdata.last_route == "csv", kw
    assert any("native route" in r.getMessage() for r in caplog.records)
    # rows not grouped by subject, or a missing state column: the csv route
    with open(DATA, newline="") as f:
        rows = list(csv.reader(f))
    shuffled = tmp_path / "shuffled.csv"
    with open(shuffled, "w", newline="") as f:
        csv.writer(f).writerows([rows[0]] + rows[300:] + rows[1:300])
    missing = tmp_path / "missing.csv"
    with open(missing, "w", newline="") as f:
        csv.writer(f).writerows([r[:3] + r[4:] for r in rows])
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="hybrid_ode_torch.data"):
        ds = tdata.create_data_arrays(str(shuffled), 61, 30)
        assert tdata.last_route == "csv"
        _fields_equal(jdata.create_data_arrays(str(shuffled), 61, 30, use_native=False), ds)
        with pytest.raises(KeyError):
            tdata.create_data_arrays(str(missing), 61, 30)
        assert tdata.last_route == "csv"
    declined = [r.getMessage() for r in caplog.records if "declined" in r.getMessage()]
    assert len(declined) == 2 and "not grouped" in declined[0] and "missing" in declined[1]


@pytest.mark.parametrize("fault", ["no_compiler", "bad_flag"])
def test_a_failed_build_raises(fault, tmp_path, monkeypatch, caplog):
    """The build raises with the compiler's message; create_data_arrays then
    takes the csv route with a warning, as JAX's falls back to pandas
    (hybrid_ode_tpu/data/dataset.py:143-150)."""
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    if fault == "no_compiler":
        monkeypatch.setattr(tnative, "CXX", "no-such-compiler-x")
        match = "cannot run 'no-such-compiler-x'"
    else:
        monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-fno-such-flag-x",))
        match = "no-such-flag-x"
    with pytest.raises(RuntimeError, match=match):
        tnative.build_library()
    assert not tnative.native_available()
    with caplog.at_level(logging.WARNING, logger="hybrid_ode_torch.data"):
        ds = tdata.create_data_arrays(DATA, 61, 30)
    assert tdata.last_route == "csv"
    warned = [r for r in caplog.records if r.levelno == logging.WARNING
              and "native loader unavailable" in r.getMessage()]
    assert len(warned) == 1 and match.strip("'") in warned[0].getMessage()
    _fields_equal(tdata.create_data_arrays(DATA, 61, 30, use_native=False), ds)
    _fields_equal(jdata.create_data_arrays(DATA, 61, 30, use_native=False), ds)
    assert not list((tmp_path / "build").glob("*.so"))


def test_parse_csv_matches_jax(native_lib, tmp_path, monkeypatch):
    """native_available / parse_csv against JAX's (data/native_loader.py:63-80)."""
    monkeypatch.setattr(jnative, "_LIB_PATHS", [native_lib])
    monkeypatch.setattr(jnative, "_lib", None)
    assert tnative.native_available() and jnative.native_available()
    for path in (DATA, _nan_copy(tmp_path)):
        arr, names = tnative.parse_csv(path)
        ref, ref_names = jnative.parse_csv(path)
        assert names == ref_names and arr.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(arr, ref)
    with pytest.raises(OSError):
        tnative.parse_csv(str(tmp_path / "missing.csv"))


# ---------------------------------------------------------------------------
# dynamics helpers
# ---------------------------------------------------------------------------

def test_make_controls_and_mass_balance_match_jax():
    rng = np.random.default_rng(1)
    ts = np.linspace(0, 5, 7).astype(np.float32)
    sig = {"meal": rng.uniform(size=7).astype(np.float32), "GD": np.float32(2.0)}
    jc = jcontrols.make_controls(ts, sig)
    tc = tcontrols.make_controls(ts, sig)
    np.testing.assert_array_equal(np.asarray(jc.ts), tc.ts.numpy())
    for k in sig:
        np.testing.assert_array_equal(np.asarray(jc.signals[k]), tc.signals[k].numpy())
    for t in (0.3, 2.5, 7.0):
        for k, v in tcontrols.eval_controls(tc, torch.tensor(t)).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jcontrols.eval_controls(jc, t)[k]),
                                       rtol=1e-6)
    y = rng.uniform(-10, 1200, size=(5, 4, 6)).astype(np.float32)
    y[..., 0] = rng.uniform(0, 40, size=(5, 4))
    ref = jode.check_mass_balance(jnp.asarray(y))
    got = tode.check_mass_balance(torch.as_tensor(y))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(), err_msg=k)


def test_feature_importance_and_mlp_dropout_match_jax():
    rng = np.random.default_rng(2)
    p = jax.tree_util.tree_map(np.asarray, jres.init_mlp_params(jax.random.PRNGKey(0), 9, 16, 6, 3))
    p["w3"] = (0.1 * rng.normal(size=p["w3"].shape)).astype(np.float32)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    y = rng.normal(size=(7, 6)).astype(np.float32)
    t, glp1, tvns = np.float32(0.5), y[:, 3], rng.uniform(size=7).astype(np.float32)
    ref = np.asarray(jres.feature_importance(p, t, jnp.asarray(y), jnp.asarray(glp1),
                                             jnp.asarray(tvns)))
    got = tres.feature_importance(tp, torch.as_tensor(t), torch.as_tensor(y),
                                  torch.as_tensor(glp1), torch.as_tensor(tvns)).numpy()
    assert got.shape == (9,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    x = rng.normal(size=(11, 9)).astype(np.float32)
    ref = np.asarray(jres.mlp_apply(p, jnp.asarray(x), dropout=0.0, key=jax.random.PRNGKey(1)))
    gen = torch.Generator().manual_seed(0)
    got = tres.mlp_apply(tp, torch.as_tensor(x), dropout=0.0, generator=gen).numpy()
    # dropout=0 is the deterministic MLP, bit for bit; the two frameworks'
    # products part in the last bits only
    np.testing.assert_array_equal(got, tres.mlp_apply(tp, torch.as_tensor(x)).numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    # dropout > 0: its own keep rate and the 1 / (1 - p) scale (the RNGs differ)
    ones = {k: (torch.ones_like(v) if k.startswith("w") else torch.zeros_like(v))
            for k, v in tp.items()}
    ones["w0"] = torch.full_like(ones["w0"], 1.0 / 9)
    xs = torch.ones((4000, 9))
    h = tres.mlp_apply({"w0": ones["w0"], "b0": ones["b0"], "w1": torch.eye(16),
                        "b1": torch.zeros(16)}, xs, dropout=0.25,
                       generator=torch.Generator().manual_seed(3))
    kept = h != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    np.testing.assert_allclose(h[kept].numpy(), 1.0 / 0.75, rtol=1e-6)
    # member-stacked weights: each member's rows through its own weights
    stacked = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    xk = torch.as_tensor(rng.normal(size=(2, 3, 5, 9)).astype(np.float32))
    out = tres.mlp_apply(stacked, xk)
    assert out.shape == (2, 3, 5, 6)
    for i in range(2):
        one = {k: v[i] for k, v in stacked.items()}
        np.testing.assert_allclose(out[i].numpy(), tres.mlp_apply(one, xk[i]).numpy(),
                                   rtol=1e-6, atol=1e-7)
