"""Clinical cohorts: the synthetic MIMIC records and the ICU glucose-management cohorts.

Port of `hybrid_ode_tpu/data/mimic.py`. Tables are column tables, dicts of
numpy arrays with one row per subject and time (the JAX package returns a
DataFrame of the same columns, in the same order and types). Files are written
by their suffix: `.parquet` through pyarrow (imported when one is written,
with the JAX package's schema metadata) and `.csv` through the `csv` module,
with floats in Python's shortest round-trip form so that they read back
unchanged. The card's machine has no pyarrow: write CSV there.

  * `MIMICDownloader`: MIMIC-like irregular records gridded and cleaned on
    the host, with pandas' semantics written out (means and ddof=1 standard
    deviations skip NaN, subjects in sorted order, rows sorted by time, a NaN
    z-score is no outlier).
  * `generate_icu_cohort`: the 8-state 4GI physiology (`dynamics/fourgi.py`)
    under enteral feeding, circadian and stress modulation and a
    sliding-scale insulin protocol recomputed at hourly nurse checks; all
    patients go through one batched dopri5 'while' solve per hourly chunk on
    the device, with per-patient step control.

Every draw of `numpy.random.default_rng(seed)` comes in the JAX package's
order, so a cohort at a seed is the JAX cohort's patients, and cohorts that
differ only in their protocol (`dose_scale`, `protocol_*`) or severity knobs
are exactly paired counterfactuals. The varied protocols draw from
`seed + 10_000` and the dysglycemic severities from `seed + 20_000`.

    python -m hybrid_ode_torch.data.mimic --output-dir data --patients 100 --interpolate
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import write_table
from hybrid_ode_torch.dynamics.fourgi import fourgi_field, fourgi_initial_state, fourgi_params
from hybrid_ode_torch.solvers.api import odeint
from hybrid_ode_torch.utils.device import resolve_device

logger = logging.getLogger("hybrid_ode_torch.mimic")

Table = Dict[str, np.ndarray]

GENERATOR = "hybrid_ode_torch.data.mimic (synthetic)"
VALUE_COLS = ["glucose_mmol_L", "insulin_pmol_L", "glucagon_pmol_L", "glp1_pmol_L"]


def _concat(frames) -> Table:
    """Row-wise concatenation of column tables with the same columns."""
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


def _take(table: Table, rows: np.ndarray) -> Table:
    return {k: v[rows] for k, v in table.items()}


class MIMICDownloader:
    """MIMIC-like records (the JAX class's API: check_credentials /
    download_tables / interpolate_to_grid / clean / save_to_parquet / run).
    PhysioNet access is a stub in both packages: the records are generated."""

    def __init__(self, username: Optional[str] = None, password: Optional[str] = None,
                 output_dir: str = "data"):
        self.username = username
        self.password = password
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def check_credentials(self) -> bool:
        if not self.username:
            logger.warning("no PhysioNet credentials; generating synthetic MIMIC-like data")
        return True

    def download_tables(self, n_patients: int = 100, points_per_patient: int = 50,
                        seed: int = 0) -> Table:
        """Irregular records: about 30% diabetic patients with higher
        baselines, meal-hour glucose excursions, exponential charting gaps
        (mean 20 min), sparse glucagon / GLP-1 labs (NaN when not drawn)."""
        rng = np.random.default_rng(seed)
        n = points_per_patient
        frames = []
        for pid in range(n_patients):
            diabetic = rng.uniform() < 0.3
            base_glu = rng.normal(9.5, 1.5) if diabetic else rng.normal(5.5, 0.7)
            base_ins = rng.normal(90, 20) if diabetic else rng.normal(55, 12)
            t_min = np.cumsum(rng.exponential(20.0, n))
            hours_of_day = (t_min / 60.0) % 24
            meal_effect = 1.5 * np.exp(-0.5 * np.minimum.reduce([
                (hours_of_day - 7.5) ** 2, (hours_of_day - 12.5) ** 2,
                (hours_of_day - 18.5) ** 2]))
            glucose = base_glu + meal_effect + rng.normal(0, 0.6, n)
            insulin = base_ins + 8.0 * meal_effect + rng.normal(0, 8, n)
            glucagon = np.where(rng.uniform(size=n) < 0.2, rng.normal(80, 12, n), np.nan)
            glp1 = np.where(rng.uniform(size=n) < 0.1, rng.normal(20, 6, n), np.nan)
            frames.append({
                "subject_id": np.full(n, pid, dtype=np.int64),
                "time_minutes": t_min,
                "glucose_mmol_L": np.maximum(glucose, 2.0),
                "insulin_pmol_L": np.maximum(insulin, 5.0),
                "glucagon_pmol_L": glucagon,
                "glp1_pmol_L": glp1,
                "diabetic": np.full(n, diabetic, dtype=bool),
            })
        return _concat(frames)

    def interpolate_to_grid(self, table: Table, grid_minutes: float = 5.0,
                            interpolate: bool = False) -> Table:
        """Each subject (in sorted order) on a regular grid. interpolate=False:
        the nearest sample within half a grid step, NaN elsewhere (masked
        downstream); True: linear interpolation of the observed values."""
        frames = []
        sids = np.asarray(table["subject_id"])
        for pid in np.unique(sids):
            rows = np.nonzero(sids == pid)[0]
            rows = rows[np.argsort(table["time_minutes"][rows], kind="stable")]
            t = table["time_minutes"][rows]
            grid = np.arange(0.0, t[-1] + grid_minutes, grid_minutes)
            rec: Table = {"subject_id": np.full(len(grid), pid, dtype=np.int64),
                          "time_minutes": grid}
            for col in VALUE_COLS:
                v = table[col][rows]
                ok = np.isfinite(v)
                if interpolate and ok.sum() >= 2:
                    rec[col] = np.interp(grid, t[ok], v[ok])
                else:
                    filled = np.full_like(grid, np.nan)
                    if ok.any():
                        idx = np.clip(np.searchsorted(t[ok], grid), 0, ok.sum() - 1)
                        close = np.abs(t[ok][idx] - grid) <= grid_minutes / 2
                        filled[close] = v[ok][idx[close]]
                    rec[col] = filled
            rec["diabetic"] = np.full(len(grid), bool(table["diabetic"][rows[0]]))
            frames.append(rec)
        return _concat(frames)

    def clean(self, table: Table, outlier_threshold: float = 5.0,
              min_sequence_completeness: float = 0.0) -> Table:
        """Glucose and insulin values beyond `outlier_threshold` z-scores
        (NaN-skipping mean and ddof=1 std over the table) become NaN; with
        `min_sequence_completeness` > 0, subjects whose charted-glucose share
        is below it are dropped."""
        table = dict(table)
        for col in ("glucose_mmol_L", "insulin_pmol_L"):
            v = table[col]
            z = (v - np.nanmean(v)) / (np.nanstd(v, ddof=1) + 1e-9)
            table[col] = np.where(np.abs(z) > outlier_threshold, np.nan, v)
        if min_sequence_completeness > 0:
            sids = table["subject_id"]
            keep = [pid for pid in np.unique(sids)
                    if np.isfinite(table["glucose_mmol_L"][sids == pid]).mean()
                    >= min_sequence_completeness]
            table = _take(table, np.isin(sids, keep))
        return table

    def save_to_parquet(self, table: Table, filename: str = "mimic_glucose_insulin.parquet",
                        metadata: Optional[Dict] = None) -> Path:
        """Write under output_dir by the filename's suffix (`write_table`),
        with the metadata as strings and the generator's name."""
        meta = {k: str(v) for k, v in (metadata or {}).items()}
        meta["generator"] = GENERATOR
        path = write_table(table, self.output_dir / filename, meta)
        logger.info("wrote %s (%d rows)", path, len(table["subject_id"]))
        return path

    def run(self, n_patients: int = 100, grid_minutes: float = 5.0,
            interpolate: bool = False, outlier_threshold: float = 5.0,
            min_completeness: float = 0.0, seed: int = 0,
            filename: str = "mimic_glucose_insulin.parquet") -> Path:
        """Generate, grid, clean and write the records; returns the path
        (`filename` ending in .csv writes CSV)."""
        self.check_credentials()
        raw = self.download_tables(n_patients=n_patients, seed=seed)
        gridded = self.interpolate_to_grid(raw, grid_minutes, interpolate)
        cleaned = self.clean(gridded, outlier_threshold, min_completeness)
        return self.save_to_parquet(
            cleaned, filename,
            metadata={"n_patients": n_patients, "grid_minutes": grid_minutes,
                      "interpolated": interpolate, "seed": seed})


# ---------------------------------------------------------------------------
# the ICU cohort
# ---------------------------------------------------------------------------

#: log-normal per-patient jitter of the 4GI parameters, in draw order
JITTER_CV = {"CLglc": 0.25, "CLglci": 0.30, "CLins": 0.20,
             "BSLglc": 0.12, "BSLins": 0.20, "BSLglp": 0.15, "BSLglg": 0.15}
#: assay noise CVs and charting-gap multipliers per channel
ASSAY_CV = {"glucose": 0.02, "insulin": 0.08, "glp1": 0.12, "glucagon": 0.10}
GAP_MULT = {"glucose": 1.0, "insulin": 2.0, "glucagon": 8.0, "glp1": 10.0}


def icu_field(t, y, args):
    """The ICU cohort's field: 4GI with the patients' carb rates and
    production modulation (N, T) read at the grid interval that contains t,
    plus the IV insulin rate (N,). args = (params {name: (N,)}, carb,
    prod_mod, ts (T,), KINglc (N,), ins_rate)."""
    params, carb, prod_mod, ts, kin_glc, ins_rate = args
    rows = torch.arange(y.shape[0], device=y.device)
    idx = torch.clamp(torch.searchsorted(ts, t.contiguous(), right=True) - 1, 0, ts.shape[0] - 2)
    dy = fourgi_field(t, y, params, {"meal_rate": carb[rows, idx],
                                     "secretion_scale": params["secretion_scale"]})
    extra = torch.zeros_like(dy)
    extra[..., 0] = kin_glc * (prod_mod[rows, idx] - 1.0)   # circadian + stress
    extra[..., 1] = ins_rate                                 # IV insulin, pmol/h
    return dy + extra


def _per_patient(x, n: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(x, np.float64), (n,))


def generate_icu_cohort(
    path: Optional[str] = None,
    n_patients: int = 80,
    hours: float = 72.0,
    grid_minutes: float = 5.0,
    seed: int = 0,
    obs_gap_min: float = 40.0,
    t2dm_fraction: float = 0.7,
    output_dir: str = "data",
    per_channel_charting: bool = False,
    dose_scale=1.0,
    protocol_gain=900.0,
    protocol_target=7.0,
    protocol_basal=0.0,
    protocol_max_rate=7000.0,
    secretion_scale=1.0,
    carb_scale=1.0,
    param_scales=None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Table:
    """Synthetic ICU glucose-management cohort simulated from the 4GI
    physiology; returns the column table and writes it to `path` (default
    `output_dir/icu_cohort.parquet`, as in the JAX package) by its suffix.

    Drivers, as in the JAX generator: randomized enteral-feed blocks and IV
    dextrose boluses (`carb_scale` multiplies them), circadian and stress
    modulation of endogenous glucose production (unmodelled by the 6-state
    model), per-patient parameter jitter, and IV insulin under the sliding
    scale rate = clip(dose_scale (basal + gain (G_meter - target)), 0,
    max_rate) pmol/h, recomputed each hour from the charted glucose with 3%
    meter noise. `protocol_*`, `dose_scale`, `secretion_scale` (< 1:
    beta-cell failure), `carb_scale` and `param_scales` ({4GI parameter:
    multiplier}) take a scalar or one value per patient and draw nothing.

    The solve: all patients in one batched dopri5 'while' solve per hour
    (rtol 1e-5, atol 1e-7, 32 steps per interval, no interval checkpoints) on
    `device` (CUDA unless the caller asks for the CPU), in `dtype` (the JAX
    package's is f32). The carb and modulation rows are read at the grid
    interval that contains t (searchsorted right - 1, clamped to [0, T-2]).

    Columns: subject_id, time_minutes, the four noisy concentrations (NaN
    between charting events) each beside its noiseless `*_true_*` column,
    meal_indicator (carb rate / 20), tvns (insulin rate / 2000) and diabetic.
    `per_channel_charting` gives each channel its own event schedule."""
    dev = resolve_device(device)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    N = n_patients
    dt_h = grid_minutes / 60.0
    T = int(round(hours / dt_h)) + 1
    t_grid = np.arange(T) * dt_h
    steps_per_hour = int(round(1.0 / dt_h))

    # per-patient physiology
    diabetic = rng.uniform(size=N) < t2dm_fraction
    # the variants' f32 constants, jittered in f64 (as the JAX package draws)
    p_t2 = fourgi_params("T2DM", torch.float32, "cpu")
    p_hv = fourgi_params("HV", torch.float32, "cpu")
    base = {}
    for name in p_t2:
        b = np.where(diabetic, float(p_t2[name]), float(p_hv[name]))
        if name in JITTER_CV:
            cv = JITTER_CV[name]
            b = b * np.exp(cv * rng.standard_normal(N) - 0.5 * cv ** 2)
        base[name] = b.astype(np_dtype)
    for name, sc in (param_scales or {}).items():
        base[name] = base[name] * _per_patient(sc, N).astype(np_dtype)
    base["secretion_scale"] = _per_patient(secretion_scale, N).astype(np_dtype)
    params = {k: torch.as_tensor(v, device=dev) for k, v in base.items()}

    # enteral blocks + dextrose boluses (mmol glucose / h)
    carb = np.zeros((N, T), np.float64)
    for i in range(N):
        t = 0.0
        while t < hours:
            on = rng.uniform(4.0, 8.0)
            rate = rng.uniform(10.0, 35.0)
            i0, i1 = int(t / dt_h), min(int((t + on) / dt_h), T)
            carb[i, i0:i1] += rate
            t += on + rng.uniform(2.0, 4.0)
        for _ in range(rng.poisson(2.0)):
            i0 = int(rng.uniform(0, hours - 0.25) / dt_h)
            carb[i, i0: i0 + 3] += 25.0 / 0.25
    carb *= _per_patient(carb_scale, N)[:, None]

    # circadian + stress modulation of endogenous glucose production
    circ_amp = rng.uniform(0.08, 0.20, N)
    circ_phase = rng.uniform(0, 24, N)
    circ = circ_amp[:, None] * np.sin(2 * np.pi * (t_grid[None, :] - circ_phase[:, None]) / 24.0)
    stress = np.zeros((N, T), np.float64)
    for i in range(N):
        for _ in range(rng.poisson(2.5)):
            t0s = rng.uniform(0, hours - 1.0)
            dur = rng.uniform(1.0, 3.0)
            amp = rng.uniform(0.15, 0.45)
            i0, i1 = int(t0s / dt_h), min(int((t0s + dur) / dt_h), T)
            stress[i, i0:i1] += amp
    prod_mod = torch.as_tensor((1.0 + circ + stress).astype(np_dtype), device=dev)
    carb_t = torch.as_tensor(carb.astype(np_dtype), device=dev)
    ts = torch.as_tensor(t_grid.astype(np_dtype), device=dev)
    kin_glc = params["BSLglc"] * (params["CLglc"] + params["CLglci"] * params["BSLins"])

    y0 = fourgi_initial_state(params)
    admit = torch.as_tensor((1.0 + rng.uniform(0.0, 0.6, N) * diabetic).astype(np_dtype),
                            device=dev)
    y0 = y0.clone()
    y0[:, 0] = y0[:, 0] * admit     # T2DM patients admitted hyperglycaemic
    y0[:, 5] = y0[:, 5] * admit

    gain = _per_patient(protocol_gain, N)
    target = _per_patient(protocol_target, N)
    basal = _per_patient(protocol_basal, N)
    dose = _per_patient(dose_scale, N)
    vc_glc = base["VCglc"]
    traj = np.zeros((N, T, 8), np_dtype)
    traj[:, 0] = y0.cpu().numpy()
    ins_rate = np.zeros(N, np_dtype)
    ins_rate_grid = np.zeros((N, T), np_dtype)
    for c in range(int(round(hours))):
        i0 = c * steps_per_hour
        i1 = min(i0 + steps_per_hour, T - 1)
        with torch.no_grad():
            out = odeint(icu_field, torch.as_tensor(traj[:, i0], device=dev), ts[i0: i1 + 1],
                         (params, carb_t, prod_mod, ts, kin_glc,
                          torch.as_tensor(ins_rate, device=dev)),
                         solver="dopri5", rtol=1e-5, atol=1e-7, mode="while",
                         max_steps_per_interval=32, checkpoint_intervals=False)
        traj[:, i0: i1 + 1] = out.cpu().numpy()
        ins_rate_grid[:, i0: i1 + 1] = ins_rate[:, None]
        # nurse check: charted glucose with meter noise -> the next hour's rate
        G = traj[:, i1, 0] / vc_glc
        G_meter = G * (1.0 + 0.03 * rng.standard_normal(N))
        ins_rate = np.clip(dose * (basal + gain * (G_meter - target)), 0.0,
                           protocol_max_rate).astype(np_dtype)

    conc = {"glucose": traj[..., 0] / vc_glc[:, None],
            "insulin": traj[..., 1] / base["VCins"][:, None],
            "glp1": traj[..., 2] / base["VCglp"][:, None],
            "glucagon": traj[..., 3] / base["VCglg"][:, None]}

    # sparse irregular charting + assay noise
    frames = []
    for i in range(N):
        def event_mask(gap):
            evts = np.cumsum(rng.exponential(gap, max(int(hours * 60 / gap * 2), 4)))
            evts = evts[evts < hours * 60.0]
            idx = np.unique(np.clip(np.round(evts / grid_minutes).astype(int), 0, T - 1))
            m = np.zeros(T, bool)
            m[idx] = True
            m[0] = True
            return m

        shared = event_mask(obs_gap_min)
        cols: Table = {"subject_id": np.full(T, i, dtype=np.int64),
                       "time_minutes": t_grid * 60.0}
        for name, unit in (("glucose", "mmol_L"), ("insulin", "pmol_L"),
                           ("glucagon", "pmol_L"), ("glp1", "pmol_L")):
            obs_mask = (event_mask(obs_gap_min * GAP_MULT[name])
                        if per_channel_charting else shared)
            v = conc[name][i] * (1.0 + ASSAY_CV[name] * rng.standard_normal(T))
            cols[f"{name}_{unit}"] = np.where(obs_mask, np.maximum(v, 0.1), np.nan)
            cols[f"{name}_true_{unit}"] = conc[name][i]
        cols["meal_indicator"] = carb[i] / 20.0
        cols["tvns"] = ins_rate_grid[i] / 2000.0
        cols["diabetic"] = np.full(T, bool(diabetic[i]))
        frames.append(cols)
    table = _concat(frames)

    if path is None:
        path = str(Path(output_dir) / "icu_cohort.parquet")
    MIMICDownloader(output_dir=str(Path(path).parent)).save_to_parquet(
        table, Path(path).name,
        metadata={"n_patients": N, "hours": hours, "seed": seed, "obs_gap_min": obs_gap_min,
                  "dose_scale": dose.tolist(), "protocol_gain": gain.tolist(),
                  "protocol_target": target.tolist(), "protocol_basal": basal.tolist(),
                  "protocol_max_rate": float(protocol_max_rate),
                  "secretion_scale": base["secretion_scale"].tolist()})
    return table


def generate_icu_cohort_varied(path: Optional[str] = None, n_patients: int = 80,
                               hours: float = 72.0, seed: int = 0, **kw) -> Table:
    """ICU cohort with per-patient sliding scales (practice variation):
    gains 900 x U(0.25, 3) and targets U(5, 9), drawn from `seed + 10_000`
    so the physiology and charting stay paired with the factual cohort."""
    prng = np.random.default_rng(seed + 10_000)
    gains = 900.0 * prng.uniform(0.25, 3.0, n_patients)
    targets = prng.uniform(5.0, 9.0, n_patients)
    return generate_icu_cohort(path=path, n_patients=n_patients, hours=hours, seed=seed,
                               protocol_gain=gains, protocol_target=targets, **kw)


def dysglycemic_severity(n_patients: int, seed: int = 0):
    """(secretion_scale ~ U(0.05, 0.30), {'CLglci': logN(0, 0.55)},
    carb_scale ~ U(1.0, 1.6)) per patient, drawn from `seed + 20_000`."""
    srng = np.random.default_rng(seed + 20_000)
    secretion = srng.uniform(0.05, 0.30, n_patients)
    sens = np.exp(0.55 * srng.standard_normal(n_patients))
    carb = srng.uniform(1.0, 1.6, n_patients)
    return secretion, {"CLglci": sens}, carb


def generate_icu_cohort_dysglycemic(path: Optional[str] = None, n_patients: int = 80,
                                    hours: float = 72.0, seed: int = 0,
                                    varied_protocol: bool = False, **kw) -> Table:
    """ICU cohort of dysglycemic patients (all T2DM, beta-cell failure, a
    wide insulin-sensitivity spread, heavy feeding: `dysglycemic_severity`),
    the protocol-evaluation regime; max rate 20,000 pmol/h unless given.
    `varied_protocol` also draws per-patient (gain, target, basal) from
    `seed + 10_000` (the training regime). The default path is
    data/icu_cohort_dysglycemic.parquet."""
    secretion, pscales, carb = dysglycemic_severity(n_patients, seed)
    if path is None:
        path = "data/icu_cohort_dysglycemic.parquet"
    kw.setdefault("protocol_max_rate", 20000.0)
    if varied_protocol:
        prng = np.random.default_rng(seed + 10_000)
        kw.setdefault("protocol_gain", 900.0 * prng.uniform(0.25, 3.0, n_patients))
        kw.setdefault("protocol_target", prng.uniform(5.0, 9.0, n_patients))
        kw.setdefault("protocol_basal", prng.uniform(0.0, 12000.0, n_patients))
    return generate_icu_cohort(path=path, n_patients=n_patients, hours=hours, seed=seed,
                               t2dm_fraction=1.0, secretion_scale=secretion,
                               param_scales=pscales, carb_scale=carb, **kw)


def main(argv=None) -> None:
    import argparse
    import getpass

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="MIMIC glucose/insulin pipeline (synthetic)")
    ap.add_argument("--username", default=None)
    ap.add_argument("--password-prompt", action="store_true")
    ap.add_argument("--output-dir", default="data")
    ap.add_argument("--patients", type=int, default=100)
    ap.add_argument("--grid-minutes", type=float, default=5.0)
    ap.add_argument("--interpolate", action="store_true",
                    help="linear interpolation instead of masking")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--filename", default="mimic_glucose_insulin.parquet",
                    help="output file under --output-dir; a .csv name writes CSV")
    a = ap.parse_args(argv)
    pw = getpass.getpass("PhysioNet password: ") if a.password_prompt else None
    MIMICDownloader(a.username, pw, a.output_dir).run(
        n_patients=a.patients, grid_minutes=a.grid_minutes, interpolate=a.interpolate,
        seed=a.seed, filename=a.filename)


if __name__ == "__main__":
    main()
