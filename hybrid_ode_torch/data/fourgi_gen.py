"""4GI synthetic cohort generation: a whole cohort in one batched solve.

Port of `hybrid_ode_tpu/data/fourgi_gen.py`. The meal schedule is a
zero-order-hold control, the solver is the port's adaptive dopri5 in 'while'
mode, and the subject axis is the batch axis of one solve on the device.

  * Meals: a meal at time m of size S is a rectangular pulse S / dt over the
    sampling interval that contains m.
  * Per-subject variability: independent N(1, cv) multipliers on the five
    baselines, one draw per subject.
  * Measurement noise: multiplicative Gaussian with per-channel CVs
    (glucose 1.0x, insulin / glp1 1.5x, glucagon 1.2x, gip 1.3x of
    `noise_cv`).

Draws come from a `torch.Generator` (seeded from `seed`); `multipliers=` and
`noise=` take them as arrays instead (another framework's draws differ, so a
comparison passes both in). The CSV is written with the `csv` module, one row
per subject and time, every value exactly as simulated (floats in Python's
shortest round-trip form, so the f32 numbers read back unchanged).

    python -m hybrid_ode_torch.data.fourgi_gen --out cohort.csv --subjects 50 --seed 1
"""

from __future__ import annotations

import csv
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from hybrid_ode_torch.dynamics.fourgi import (
    fourgi_concentrations,
    fourgi_field,
    fourgi_initial_state,
    fourgi_params,
)
from hybrid_ode_torch.solvers.api import odeint
from hybrid_ode_torch.utils.device import resolve_device

#: per-subject baseline multipliers N(1, cv), in draw order
BASELINE_CVS = {"BSLglc": 0.10, "BSLins": 0.15, "BSLglp": 0.15, "BSLglg": 0.15, "BSLgip": 0.15}
#: per-channel multipliers of noise_cv, in draw order
NOISE_CV_SCALE = {"glucose": 1.0, "insulin": 1.5, "glp1": 1.5, "glucagon": 1.2, "gip": 1.3}
CHANNEL_COLUMNS = {"glucose": "glucose_mmol_L", "insulin": "insulin_pmol_L",
                   "glp1": "glp1_pmol_L", "glucagon": "glucagon_pmol_L", "gip": "gip_pmol_L"}
COLUMNS = (["subject_id", "time_hours", "time_minutes"] + list(CHANNEL_COLUMNS.values())
           + ["meal_indicator"]
           + [c.replace("_mmol_L", "_true_mmol_L").replace("_pmol_L", "_true_pmol_L")
              for c in CHANNEL_COLUMNS.values()])


def _meal_rate_on_grid(t_hours: np.ndarray, meal_times: Sequence[float],
                       meal_sizes: Sequence[float]) -> np.ndarray:
    """Rectangular meal-rate pulses (mmol/h) on the sampling grid;
    rate[i] applies on [t[i], t[i+1])."""
    rate = np.zeros_like(t_hours)
    for m, s in zip(meal_times, meal_sizes):
        for i in range(len(t_hours) - 1):
            if t_hours[i] <= m < t_hours[i + 1]:
                rate[i] = s / (t_hours[i + 1] - t_hours[i])
    return rate


def _grid(duration_hours: float, sampling_interval_min: float) -> np.ndarray:
    return np.arange(0.0, duration_hours + sampling_interval_min / 60.0,
                     sampling_interval_min / 60.0)


def simulate_cohort(
    generator: Optional[torch.Generator] = None,
    n_subjects: int = 10,
    patient_type: str = "T2DM",
    duration_hours: float = 5.0,
    sampling_interval_min: float = 5.0,
    meal_times: Sequence[float] = (1.0, 3.0),
    meal_sizes: Sequence[float] = (75.0, 50.0),
    solver: str = "dopri5",
    rtol: float = 1e-6,
    atol: float = 1e-8,
    multipliers: Optional[Mapping[str, np.ndarray]] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    return_stats: bool = False,
):
    """Simulate a cohort: (t_hours (T,) numpy, concentrations {name: (N, T)}
    on `device`), plus the solver's per-subject StepStats with `return_stats`.

    `generator` (a CPU generator; default seed 0) draws the baseline
    multipliers 1 + cv * N(0, 1), one (N,) draw per baseline in
    `BASELINE_CVS` order; `multipliers` ({name: (N,)}) supplies them instead.
    The structural constants are `dtype` numbers; the time grid and the meal
    rates are f32 numbers (as the JAX package has them), computed on in
    `dtype`."""
    dev = resolve_device(device)
    p = fourgi_params(patient_type, dtype, dev)
    t_hours = _grid(duration_hours, sampling_interval_min)
    ts = torch.tensor(t_hours, dtype=torch.float32, device=dev).to(dtype)
    meal_grid = torch.tensor(_meal_rate_on_grid(t_hours, meal_times, meal_sizes),
                             dtype=torch.float32, device=dev).to(dtype)
    if multipliers is None:
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        multipliers = {name: 1.0 + cv * torch.randn(n_subjects, generator=generator,
                                                    dtype=torch.float32)
                       for name, cv in BASELINE_CVS.items()}
    params = dict(p)
    for name in BASELINE_CVS:
        params[name] = p[name] * torch.as_tensor(np.array(multipliers[name]), device=dev).to(dtype)
    last = len(t_hours) - 2

    def field(t, y, args):
        prm, meal = args
        # zero-order hold: the rate of the interval that contains t
        idx = torch.clamp(torch.searchsorted(ts, t.contiguous(), right=True) - 1, 0, last)
        return fourgi_field(t, y, prm, {"meal_rate": meal[idx]})

    out = odeint(field, fourgi_initial_state(params), ts, (params, meal_grid), solver=solver,
                 rtol=rtol, atol=atol, mode="while", max_steps_per_interval=64,
                 checkpoint_intervals=False, return_stats=return_stats)
    trajs, stats = out if return_stats else (out, None)
    conc = fourgi_concentrations(trajs, p)
    return (t_hours, conc, stats) if return_stats else (t_hours, conc)


def generate_4gi_dataset(
    path: Optional[str] = None,
    seed: int = 0,
    n_subjects: int = 10,
    patient_type: str = "T2DM",
    duration_hours: float = 5.0,
    sampling_interval_min: float = 5.0,
    meal_times: Sequence[float] = (1.0, 3.0),
    meal_sizes: Sequence[float] = (75.0, 50.0),
    noise_cv: float = 0.1,
    multipliers: Optional[Mapping[str, np.ndarray]] = None,
    noise: Optional[Mapping[str, np.ndarray]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """Generate the 4GI cohort table: {column: (N*T,) numpy} in `COLUMNS`
    order, one row per subject and time (subject-major), written to `path`
    as CSV when given.

    Columns: subject_id, time_hours, time_minutes, the five noisy
    concentrations, meal_indicator, and the five noiseless ones
    (`*_true_*`, for truth-referenced evaluation). A generator seeded with
    `seed` draws the multipliers (see `simulate_cohort`), then the noise
    N(0, 1) per channel in `NOISE_CV_SCALE` order; `multipliers` and `noise`
    ({channel: (N, T)}) supply them instead."""
    generator = torch.Generator().manual_seed(seed)
    t_hours, conc = simulate_cohort(generator, n_subjects, patient_type, duration_hours,
                                    sampling_interval_min, meal_times, meal_sizes,
                                    multipliers=multipliers, device=device)
    conc = {name: v.cpu().numpy() for name, v in conc.items()}
    T = len(t_hours)
    noisy = {}
    for name, values in conc.items():
        eps = (np.asarray(noise[name], np.float32) if noise is not None
               else torch.randn((n_subjects, T), generator=generator, dtype=torch.float32).numpy())
        scale = np.float32(noise_cv * NOISE_CV_SCALE[name])
        noisy[name] = values + scale * np.abs(values) * eps
    meal_indicator = np.array([1 if any(abs(t - m) < 0.01 for m in meal_times) else 0
                               for t in t_hours])

    true_cols = COLUMNS[-5:]
    table = {
        "subject_id": np.repeat(np.arange(n_subjects), T),
        "time_hours": np.tile(t_hours, n_subjects),
        "time_minutes": np.tile(t_hours * 60.0, n_subjects),
        **{col: noisy[name].reshape(-1) for name, col in CHANNEL_COLUMNS.items()},
        "meal_indicator": np.tile(meal_indicator, n_subjects),
        **{col: conc[name].reshape(-1) for name, col in zip(CHANNEL_COLUMNS, true_cols)},
    }
    if path is not None:
        # floats as Python floats: their shortest round-trip decimals carry
        # the f32 values exactly
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(table))
            w.writerows(zip(*(v.tolist() for v in table.values())))
    return table


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Generate the 4GI synthetic dataset (PyTorch port)")
    ap.add_argument("--out", default="data/4gi_dataset.csv")
    ap.add_argument("--subjects", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--patient-type", default="T2DM", choices=["T2DM", "HV"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plot", action="store_true",
                    help="save an example plot of subject 0 beside --out")
    a = ap.parse_args(argv)
    table = generate_4gi_dataset(a.out, seed=a.seed, n_subjects=a.subjects,
                                 patient_type=a.patient_type, device=a.device)
    print(f"wrote {a.out}: {len(table['subject_id'])} rows, {a.subjects} subjects")
    if a.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sub0 = table["subject_id"] == 0
        t = table["time_hours"][sub0]
        titles = ["Glucose (mmol/L)", "Insulin (pmol/L)", "GLP-1 (pmol/L)",
                  "Glucagon (pmol/L)", "GIP (pmol/L)"]
        fig, axes = plt.subplots(5, 1, figsize=(10, 12), sharex=True)
        for ax, col, title in zip(axes, CHANNEL_COLUMNS.values(), titles):
            ax.plot(t, table[col][sub0], "b-", lw=2)
            ax.set_ylabel(title)
            ax.grid(True, alpha=0.3)
            for mt in t[table["meal_indicator"][sub0] == 1]:
                ax.axvline(mt, color="r", ls="--", alpha=0.5)
        axes[-1].set_xlabel("Time (hours)")
        fig.suptitle("4GI Model Simulation - Subject 0")
        fig.tight_layout()
        out_png = str(a.out).rsplit(".", 1)[0] + "_example.png"
        fig.savefig(out_png, dpi=150)
        print(f"example plot: {out_png}")


if __name__ == "__main__":
    main()
