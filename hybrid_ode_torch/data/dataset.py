"""Windowed glucose datasets as stacked numpy arrays (no pandas).

Port of `hybrid_ode_tpu/data/dataset.py`, with the semantics of its pandas
path (`create_data_arrays`) on a CSV read by the `csv` module or a Parquet
file read by `pyarrow` (imported when a Parquet file is read, and only then:
the card's machine has no pyarrow, so cohorts go there as CSV):
  * state columns [glucose, insulin, glucagon, glp1] + placeholder ge=0.0,
    ffa=1.0 when absent; tvns=0.0 when absent; meal from meal_indicator
  * time from time_minutes/60, else time_hours, else a 5-min grid over rows
  * sliding windows per subject, subjects in SORTED key order (as
    `DataFrame.groupby` walks them), rows in file order within a subject
  * z-score over all observed points; NaN states (and Parquet nulls) become
    mask=0
A CSV takes the native C++ route (`data/native_loader.py`, the JAX package's
default for CSVs) when it is grouped by subject and has the expected
columns; the route taken is logged and kept in `last_route`. Arrays go to
the device per batch (`batch_to_tensors`).
"""

from __future__ import annotations

import csv
import dataclasses
import logging
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

STATE_COLS = ["glucose_mmol_L", "insulin_pmol_L", "glucagon_pmol_L", "glp1_pmol_L"]

logger = logging.getLogger("hybrid_ode_torch.data")

#: the route the last `create_data_arrays` call took: 'native', 'csv' or 'parquet'
last_route = None


def _loss_weights_from_stats(data_std: np.ndarray, data_mean: np.ndarray) -> np.ndarray:
    """Inverse-variance per-state weights; uninformative (constant) states get 0."""
    std = np.asarray(data_std, np.float64)
    mean = np.asarray(data_mean, np.float64)
    informative = std > (1e-4 * np.abs(mean) + 1e-6)
    w = np.where(informative, 1.0 / np.maximum(std, 1e-12) ** 2, 0.0)
    return w.astype(np.float32)


@dataclasses.dataclass
class GlucoseDataset:
    """Stacked window arrays (N windows, T points per window).

    initial_state (N, 6), observations (N, T, 6), time_points (N, T) hours,
    meal / tvns (N, T), mask (N, T) 1.0 where observed, state_mean /
    state_std (6,), subject_ids (N,), loss_weights (6,), optional
    mask_channels (N, T, 6)."""

    initial_state: np.ndarray
    observations: np.ndarray
    time_points: np.ndarray
    meal: np.ndarray
    tvns: np.ndarray
    mask: np.ndarray
    state_mean: np.ndarray
    state_std: np.ndarray
    subject_ids: np.ndarray
    loss_weights: np.ndarray = None
    mask_channels: np.ndarray = None

    def __post_init__(self):
        if self.loss_weights is None:
            self.loss_weights = _loss_weights_from_stats(self.state_std, self.state_mean)

    def __len__(self) -> int:
        return self.initial_state.shape[0]

    def select(self, idx: np.ndarray) -> "GlucoseDataset":
        return GlucoseDataset(
            initial_state=self.initial_state[idx],
            observations=self.observations[idx],
            time_points=self.time_points[idx],
            meal=self.meal[idx],
            tvns=self.tvns[idx],
            mask=self.mask[idx],
            state_mean=self.state_mean,
            state_std=self.state_std,
            subject_ids=self.subject_ids[idx],
            loss_weights=self.loss_weights,
            mask_channels=None if self.mask_channels is None else self.mask_channels[idx],
        )

    def batch(self, idx: np.ndarray) -> Dict:
        """A batch dict (numpy), the `hybrid_loss` / evaluation contract."""
        return {
            "initial_state": self.initial_state[idx],
            "observations": self.observations[idx],
            "time_points": self.time_points[idx],
            "external_inputs": {"meal": self.meal[idx], "tVNS": self.tvns[idx]},
            "mask": self.mask[idx],
            "loss_weights": self.loss_weights,
            **({"mask_channels": self.mask_channels[idx]}
               if self.mask_channels is not None else {}),
        }

    def denormalize(self, states: np.ndarray) -> np.ndarray:
        return states * self.state_std + self.state_mean


def _float(s: str) -> float:
    try:
        return float(s)
    except ValueError:  # '', 'NA', 'N/A', ... are missing values
        return float("nan")


def _read_csv(path: str) -> Tuple[List[str], Dict[str, List[str]]]:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols: Dict[str, List[str]] = {h: [] for h in header}
        for row in reader:
            if not row:
                continue
            for h, v in zip(header, row):
                cols[h].append(v)
    return header, cols


def _subject_keys(raw: List[str]) -> np.ndarray:
    """The subject_id column typed as pandas infers it: int, float or str."""
    try:
        return np.array([int(v) for v in raw], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(v) if v.strip() else np.nan for v in raw], dtype=np.float64)
    except ValueError:
        return np.array(raw, dtype=object)


def read_parquet_columns(path: str) -> Dict[str, np.ndarray]:
    """A Parquet file's columns as numpy arrays of their stored types (nulls
    of a float or int column read as NaN); pyarrow is imported here, and a
    missing pyarrow raises naming it."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(f"reading {path} needs pyarrow, which is not installed; "
                          "write the cohort as CSV instead") from e
    table = pq.read_table(path)
    return {name: table.column(name).to_numpy() for name in table.column_names}


def read_columns(path: str):
    """(column names, col, subject keys) of a CSV or Parquet file: col(name)
    gives a column as numpy, Parquet columns in their stored type and CSV
    cells as f64 (through `_float`); subject keys typed as pandas has them."""
    path = str(path)
    if path.endswith(".parquet"):
        cols = read_parquet_columns(path)
        return list(cols), cols.__getitem__, cols["subject_id"]
    if path.endswith(".csv"):
        header, raw = _read_csv(path)
        return (header, lambda name: np.array([_float(v) for v in raw[name]], dtype=np.float64),
                _subject_keys(raw["subject_id"]))
    raise ValueError(f"unsupported file format (the port reads CSV and Parquet): {path}")


def write_table(table: Mapping[str, np.ndarray], path: Union[str, Path],
                metadata: Optional[Mapping[str, str]] = None) -> Path:
    """Write a column table ({column: (rows,) numpy}) by `path`'s suffix:
    `.parquet` through pyarrow (imported here; `metadata` as the schema's
    metadata; a missing pyarrow raises naming it), anything else as CSV
    through the `csv` module, floats as Python floats (their shortest
    round-trip decimals carry f32 and f64 values exactly; NaN as 'nan')."""
    path = Path(path)
    if path.suffix == ".parquet":
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError as e:
            raise ImportError(f"writing {path} needs pyarrow, which is not installed; "
                              "write the table as CSV instead") from e
        arrow = pa.table({k: np.asarray(v) for k, v in table.items()})
        arrow = arrow.replace_schema_metadata(
            {k.encode(): str(v).encode() for k, v in (metadata or {}).items()})
        pq.write_table(arrow, path)
        return path
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(table))
        w.writerows(zip(*(np.asarray(v).tolist() for v in table.values())))
    return path


def create_data_arrays(
    data_path: str,
    sequence_length: int = 61,
    stride: int = 30,
    normalize: bool = True,
    dtype=np.float32,
    per_channel_mask: bool = False,
    norm_stats=None,
    use_native: bool = True,
) -> GlucoseDataset:
    """Load a CSV or Parquet file and build the window arrays.

    With `use_native`, no `per_channel_mask` and no `norm_stats` (the JAX
    package's conditions) the native C++ engine parses the file and builds
    the windows; a file that is not grouped by ascending integer subject id,
    or lacks a state column, takes the `csv`-module route instead (logged).
    The native route reads values as f32, as the JAX package's does: on a
    file whose numbers are f32 values written exactly (as
    `data/fourgi_gen.py` writes them) it gives the csv route's arrays bit
    for bit; where a cell holds more digits, an observation can differ from
    the csv route's in its last f32 bit.

    A Parquet file is read through pyarrow (`read_parquet_columns`), as the
    JAX package reads it through pandas: columns cast to f64, nulls as NaN.

    `norm_stats=(mean, std)` normalizes with external stats (e.g. the
    training cohort's) instead of this file's own."""
    global last_route
    if norm_stats is not None and not normalize:
        raise ValueError("norm_stats requires normalize=True")
    is_csv = str(data_path).endswith(".csv")
    if use_native and is_csv and not per_channel_mask and norm_stats is None:
        from hybrid_ode_torch.data.native_loader import NotGrouped

        try:
            ds = _create_data_arrays_native(data_path, sequence_length, stride, normalize, dtype)
            last_route = "native"
            logger.info("create_data_arrays: native route for %s", data_path)
            return ds
        except (KeyError, NotGrouped, OSError) as e:
            logger.info("create_data_arrays: csv route for %s (native route declined: %s)",
                        data_path, e)
    header, col, keys = read_columns(data_path)
    last_route = "csv" if is_csv else "parquet"
    logger.info("create_data_arrays: %s route for %s", last_route, data_path)
    n_rows = len(keys)

    def num(name, default=None):
        if name in header:
            return np.asarray(col(name), dtype=np.float64)
        if default is None:  # a state column the file lacks, as pandas reports it
            raise KeyError(f"missing column {name!r} in {data_path}")
        return np.full(n_rows, default, dtype=np.float64)

    state_arr = np.stack([num(c) for c in STATE_COLS] + [num("ge", 0.0), num("ffa", 1.0)],
                         axis=-1)
    tvns_all = num("tvns", 0.0)
    meal_all = num("meal_indicator", 0.0)
    # minutes -> hours in the column's own type, as pandas divides
    if "time_minutes" in header:
        time_all = np.asarray(col("time_minutes") / 60.0, dtype=np.float64)
    elif "time_hours" in header:
        time_all = num("time_hours")
    else:
        time_all = np.arange(n_rows) * 5.0 / 60.0

    valid_rows = np.array([not (isinstance(k, float) and np.isnan(k)) for k in keys.tolist()])
    windows = []
    for sid in sorted(set(keys[valid_rows].tolist())):
        rows = np.nonzero(valid_rows & (keys == sid))[0]
        states, meal = state_arr[rows], meal_all[rows]
        tvns, time = tvns_all[rows], time_all[rows]
        for start in range(0, len(rows) - sequence_length + 1, stride):
            end = start + sequence_length
            windows.append((sid, states[start:end], meal[start:end], tvns[start:end],
                            time[start:end]))

    if not windows:
        raise ValueError(f"no windows: need >= {sequence_length} points per subject in {data_path}")

    return _dataset(np.stack([w[1] for w in windows]), np.stack([w[2] for w in windows]),
                    np.stack([w[3] for w in windows]), np.stack([w[4] for w in windows]),
                    np.array([w[0] for w in windows]), normalize, dtype, per_channel_mask,
                    norm_stats)


def _dataset(all_states, meal, tvns, time, subject_ids, normalize, dtype,
             per_channel_mask=False, norm_stats=None) -> GlucoseDataset:
    """Windows (N, T, 6) with NaN where unobserved, and their controls and
    times (N, T), as a normalised GlucoseDataset (both routes)."""
    mask_ch = np.isfinite(all_states)
    if per_channel_mask:
        mask = mask_ch.any(axis=-1).astype(np.float64)
    else:
        mask = mask_ch.all(axis=-1).astype(np.float64)
    filled = np.nan_to_num(all_states, nan=0.0)

    C = filled.shape[-1]
    flat = filled.reshape(-1, C)
    if per_channel_mask:
        flat_m = mask_ch.reshape(-1, C)
        data_mean = np.array([flat[:, i][flat_m[:, i]].mean() if flat_m[:, i].any() else 0.0
                              for i in range(C)])
        data_std = np.array([flat[:, i][flat_m[:, i]].std() if flat_m[:, i].any() else 1.0
                             for i in range(C)]) + 1e-6
    else:
        flat_mask = mask.reshape(-1) > 0
        data_mean = flat[flat_mask].mean(axis=0)
        data_std = flat[flat_mask].std(axis=0) + 1e-6
    if norm_stats is not None:
        mean = np.asarray(norm_stats[0], dtype=np.float64)
        std = np.asarray(norm_stats[1], dtype=np.float64)
    elif normalize:
        mean, std = data_mean, data_std
    else:
        mean, std = np.zeros(C), np.ones(C)

    norm_states = (filled - mean) / std
    # masked entries were zero-filled; re-zero them after the shift
    norm_states = norm_states * (mask_ch if per_channel_mask else mask[..., None])
    weights = _loss_weights_from_stats(data_std / std, data_mean)

    return GlucoseDataset(
        initial_state=norm_states[:, 0].astype(dtype),
        observations=norm_states.astype(dtype),
        time_points=time.astype(dtype),
        meal=meal.astype(dtype),
        tvns=tvns.astype(dtype),
        mask=mask.astype(dtype),
        state_mean=mean.astype(dtype),
        state_std=std.astype(dtype),
        subject_ids=subject_ids,
        loss_weights=weights,
        mask_channels=mask_ch.astype(dtype) if per_channel_mask else None,
    )


def _create_data_arrays_native(data_path: str, sequence_length: int, stride: int,
                               normalize: bool, dtype) -> GlucoseDataset:
    """The native route: one C++ pass builds f32 windows of the columns the
    file has; placeholders, time and statistics as in the csv route."""
    from hybrid_ode_torch.data.native_loader import build_windows

    with open(data_path) as f:
        have = set(f.readline().strip().split(","))
    if "subject_id" not in have:
        raise KeyError("subject_id")
    missing = [c for c in STATE_COLS if c not in have]
    if missing:
        raise KeyError(f"missing state columns {missing}")
    fetch = list(STATE_COLS) + [c for c in ("ge", "ffa", "meal_indicator", "tvns") if c in have]
    time_col = next((c for c in ("time_minutes", "time_hours") if c in have), None)
    if time_col is not None:
        fetch.append(time_col)
    wins, subs, _ = build_windows(data_path, fetch, seq_len=sequence_length, stride=stride)
    N, T, _ = wins.shape
    if N == 0:
        raise ValueError(f"no windows: need >= {sequence_length} points per subject in {data_path}")
    idx = {c: i for i, c in enumerate(fetch)}

    def col(name, default):
        return wins[..., idx[name]].astype(np.float64) if name in idx else np.full((N, T), default)

    states = np.empty((N, T, 6), np.float64)
    for i, c in enumerate(STATE_COLS):
        states[..., i] = wins[..., idx[c]]
    states[..., 4] = col("ge", 0.0)
    states[..., 5] = col("ffa", 1.0)
    meal, tvns = col("meal_indicator", 0.0), col("tvns", 0.0)
    if time_col == "time_minutes":
        time = wins[..., idx[time_col]].astype(np.float64) / 60.0
    elif time_col == "time_hours":
        time = wins[..., idx[time_col]].astype(np.float64)
    else:
        time = np.broadcast_to(np.arange(T) * 5.0 / 60.0, (N, T)).copy()

    return _dataset(states, meal, tvns, time, subs, normalize, dtype)


def split_dataset(ds: GlucoseDataset, train_frac: float = 0.7, val_frac: float = 0.15,
                  seed: int = 42, level: str = "window"
                  ) -> Tuple[GlucoseDataset, GlucoseDataset, GlucoseDataset]:
    """70/15/15 random split with a fixed seed; level='window' (reference
    behaviour) or 'subject' (no subject in two splits)."""
    n = len(ds)
    rng = np.random.default_rng(seed)
    if level == "subject":
        subjects = np.unique(ds.subject_ids)
        perm_s = rng.permutation(len(subjects))
        n_tr = int(train_frac * len(subjects))
        n_va = int(val_frac * len(subjects))
        groups = (subjects[perm_s[:n_tr]], subjects[perm_s[n_tr: n_tr + n_va]],
                  subjects[perm_s[n_tr + n_va:]])
        return tuple(ds.select(np.where(np.isin(ds.subject_ids, g))[0]) for g in groups)
    if level != "window":
        raise ValueError(f"unknown split level {level!r} (window|subject)")
    perm = rng.permutation(n)
    n_train = int(train_frac * n)
    n_val = int(val_frac * n)
    return (ds.select(perm[:n_train]), ds.select(perm[n_train: n_train + n_val]),
            ds.select(perm[n_train + n_val:]))


def batch_iterator(ds: GlucoseDataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_remainder: bool = False) -> Iterator[Dict]:
    """Yield batch dicts in a seeded order (or file order)."""
    n = len(ds)
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        idx = order[start: start + batch_size]
        if drop_remainder and len(idx) < batch_size:
            break
        yield ds.batch(idx)


def batch_to_tensors(batch: Dict, device) -> Dict:
    """Batch dict of arrays or tensors -> tensors on `device` (nested dicts
    included)."""
    return {k: batch_to_tensors(v, device) if isinstance(v, dict)
            else torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v),
                                 device=device)
            for k, v in batch.items()}


def pad_batch(batch: Dict, batch_size: int) -> Tuple[Dict, np.ndarray]:
    """Pad a ragged final batch to batch_size by repeating its last sample;
    returns the sample-validity mask (folded into batch['mask'])."""
    b = batch["initial_state"].shape[0]
    if b == batch_size:
        return batch, np.ones(batch_size, np.float32)
    pad = batch_size - b

    def _pad(x):
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)

    padded = {
        "initial_state": _pad(batch["initial_state"]),
        "observations": _pad(batch["observations"]),
        "time_points": _pad(batch["time_points"]),
        "external_inputs": {k: _pad(v) for k, v in batch["external_inputs"].items()},
        "mask": _pad(batch["mask"]),
    }
    if "mask_channels" in batch:
        padded["mask_channels"] = _pad(batch["mask_channels"])
    if "loss_weights" in batch:
        padded["loss_weights"] = batch["loss_weights"]
    valid = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    padded["mask"] = padded["mask"] * valid[:, None]
    return padded, valid
