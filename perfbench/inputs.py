"""Inputs of every cell, made by the benchmark from `--seed`.

Windows are resampled from the 4GI data file kept beside the benchmark
(`perfbench/data/4gi_dataset.csv`: 10 subjects, 61 points at 5 minutes,
two meals each). A window is one subject's, with seeded jitter:

  * initial states: the subject's first observed states scaled by
    exp(N(0, y0_sd));
  * observations: every observed state scaled by exp(N(0, obs_sd));
  * meals: each meal moved by a whole number of grid points in
    [-meal_shift, meal_shift] and scaled by a factor in
    [1 - meal_scale, 1 + meal_scale].

States are z-scored with the configuration's `state_mean` / `state_std`;
the placeholder states (GE, FFA) sit at their means. Every window is fully
observed (mask 1). The weights of the loss are the inverse variances of
the file's states under that normalisation, 0 for constant states.

Checkpoints are read here too: `load_checkpoint` rebuilds a checkpoint's
tree from its JSON spec and leaves with numpy only.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent
DATA = HERE / "data" / "4gi_dataset.csv"
STATE_COLS = ("glucose_mmol_L", "insulin_pmol_L", "glucagon_pmol_L", "glp1_pmol_L")


def load_source(path: Path = DATA) -> Dict[str, np.ndarray]:
    """The file's subjects as arrays: states (S, T, 6) in physical units
    (GE 0, FFA 1), meal (S, T), time in hours (S, T)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    subjects = sorted({int(r["subject_id"]) for r in rows})
    states, meal, time = [], [], []
    for s in subjects:
        rs = [r for r in rows if int(r["subject_id"]) == s]
        st = np.array([[float(r[c]) for c in STATE_COLS] for r in rs], np.float64)
        st = np.concatenate([st, np.zeros((len(rs), 1)), np.ones((len(rs), 1))], axis=1)
        states.append(st)
        meal.append([float(r["meal_indicator"]) for r in rs])
        time.append([float(r["time_minutes"]) / 60.0 for r in rs])
    return {"states": np.stack(states), "meal": np.array(meal), "time": np.array(time)}


def loss_weights(source: Dict[str, np.ndarray], mean, std) -> np.ndarray:
    flat = source["states"].reshape(-1, 6)
    data_std, data_mean = flat.std(0) + 1e-6, flat.mean(0)
    rel = data_std / np.asarray(std, np.float64)
    informative = rel > (1e-4 * np.abs(data_mean) + 1e-6)
    return np.where(informative, 1.0 / np.maximum(rel, 1e-12) ** 2, 0.0).astype(np.float32)


def make_windows(rng: np.random.Generator, n: int, source, mean, std,
                 jitter: Dict[str, float]) -> Dict[str, np.ndarray]:
    """n jittered windows (f32 arrays): initial_state (n, 6), observations
    (n, T, 6), time_points / meal / tvns / mask (n, T)."""
    S, T, _ = source["states"].shape
    pick = rng.integers(0, S, n)
    clean = source["states"][pick]
    y0 = clean[:, 0].copy()
    y0[:, :4] *= np.exp(jitter["y0_sd"] * rng.standard_normal((n, 4)))
    states = clean.copy()
    states[..., :4] *= np.exp(jitter["obs_sd"] * rng.standard_normal((n, T, 4)))
    meal_src = source["meal"][pick]
    meal = np.zeros_like(meal_src)
    k = int(jitter["meal_shift"])
    for w, t in zip(*np.nonzero(meal_src)):
        t2 = int(np.clip(t + rng.integers(-k, k + 1), 0, T - 1))
        meal[w, t2] += meal_src[w, t] * (1.0 + jitter["meal_scale"] * rng.uniform(-1.0, 1.0))
    mean, std = np.asarray(mean, np.float64), np.asarray(std, np.float64)
    obs = (states - mean) / std
    init = (y0 - mean) / std
    obs[..., 4:] = init[:, 4:] = 0.0  # the placeholders sit at their means
    f32 = np.float32
    return {"initial_state": init.astype(f32), "observations": obs.astype(f32),
            "time_points": source["time"][pick].astype(f32), "meal": meal.astype(f32),
            "tvns": np.zeros((n, T), f32), "mask": np.ones((n, T), f32)}


def _rebuild(spec, leaves):
    kind = spec["kind"]
    if kind == "dict":
        return {k: _rebuild(s, leaves) for k, s in spec["items"]}
    if kind == "tuple":
        return tuple(_rebuild(s, leaves) for s in spec["items"])
    if kind == "list":
        return [_rebuild(s, leaves) for s in spec["items"]]
    if kind == "leaf":
        return leaves[spec["index"]]
    return None


def load_checkpoint(directory: Path):
    """(tree {"params": {group: {name: array}}, "opt_state": ...}, metadata)
    of a checkpoint directory (`leaves.npz` + the JSON spec in
    `structure.json`; nothing is unpickled)."""
    doc = json.loads((directory / "structure.json").read_text())
    with np.load(directory / "leaves.npz", allow_pickle=False) as z:
        leaves = [z[f"leaf_{i:04d}"] for i in range(len(z.files))]
    return _rebuild(doc["spec"], leaves), doc["metadata"]

