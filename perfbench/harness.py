"""One run of one cell: set-up, the measured window or the traced units, the
check against the plain reference, and the result line.

Everything that belongs to one cell is found by name:
  * `BENCHMARK.json` at the checkout's root: the cell's configuration and
    traffic, and the metrics it reports;
  * `perfbench/configs/<config>.json`: the configuration as it is run,
    with its weights in `perfbench/weights/<config>/`;
  * `perfbench/traffic/<traffic>.json`: the traffic mix, naming its driver
    `perfbench/drivers/<driver>.py` and giving the driver's parameters;
  * `perfbench/workloads/<cell>.json`: the cell's limits of the check,
    the readings they were set from, and the units a traced run profiles;
  * `perfbench/metrics/<metric>.py`: the reader of each metric; a metric
    `<quantity>.<part>` with no file of its own reads `<quantity>.py`.
A later cell, configuration, mix or metric is new files of these kinds.

A driver module has `setup(env) -> workload`; the workload has
`unit_name`, `run_unit() -> (attempted, failed)` (one whole unit of work,
ending synchronised with the card), `counters()` (the program's counters),
`ops(units, counters)` (operations the units needed, or None),
optionally `min_units` (the window runs at least that many units),
`kernel_bounds` ({kernel name: least seconds a launch}), `check()` ->
[(name, value)], run once the window has closed, which frees what it can of
the program's state and runs the reference, and `control()`, the same
numbers with the reference in TF32 in the program's place (readings only).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hybrid_ode_tpu")


def _load(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def benchmark() -> Dict[str, Any]:
    return read_json(ROOT / "BENCHMARK.json")


def cell_entry(doc: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in doc["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def cell_metrics(doc: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of the cell reports: end-to-end ones untraced,
    per-layer ones traced; a metric with a `workloads` list only there."""
    return [m for m in doc["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Env:
    """What a driver gets: the configuration, the mix, the seed, the device."""

    cell: str
    config_name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    device: Any
    limits: Dict[str, float] = field(default_factory=dict)
    trace_units: int = 1
    traced: bool = False  # a traced run: the units are the trace's

    def rng(self, stream: int) -> np.random.Generator:
        """A numpy generator of this seed, one independent stream per use."""
        return np.random.default_rng([self.seed % 2 ** 64, stream])

    def torch_seed(self, stream: int) -> int:
        return int(self.rng(stream).integers(0, 2 ** 62))

    def checkpoint(self):
        """(the configuration's checkpoint tree, its metadata)."""
        from perfbench.inputs import load_checkpoint
        return load_checkpoint(PB / "weights" / self.config_name)

    def weights(self):
        """(params {group: {name: array}}, metadata) of the configuration."""
        tree, meta = self.checkpoint()
        return tree["params"], meta

    def params(self, requires_grad: bool = False):
        """The weights as f32 tensors on the device, one copy per leaf."""
        import torch
        tree, _ = self.weights()
        return {g: {n: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                    .requires_grad_(requires_grad)
                    for n, v in leaves.items()} for g, leaves in tree.items()}


def make_env(cell: str, seed: int, device, overrides: Optional[Dict[str, Any]] = None) -> Env:
    doc = benchmark()
    entry = cell_entry(doc, cell)
    config = read_json(PB / "configs" / f"{entry['config']}.json")
    mix = read_json(PB / "traffic" / f"{entry['traffic']}.json")
    spec = read_json(PB / "workloads" / f"{cell}.json")
    if overrides:
        mix = {**mix, **overrides.get("mix", {})}
    return Env(cell, entry["config"], config, mix, seed, device, spec["limits"],
               int(spec["trace_units"]))


@dataclass
class Run:
    env: Env
    workload: Any
    setup_s: float
    window_s: float = 0.0
    units: int = 0
    attempted: int = 0
    failed: int = 0
    trace: Any = None
    power: str = ""


def measure(env: Env, seconds: float, trace: bool, t_start: float) -> Run:
    """Set up the cell's workload, then run its window or its traced units."""
    import torch

    drv = _load(PB / "drivers" / f"{env.mix['driver']}.py", f"perfbench_driver_{env.mix['driver']}")
    env.traced = trace
    workload = drv.setup(env)
    if env.device.type == "cuda":
        torch.cuda.synchronize()
    run = Run(env, workload, setup_s=time.perf_counter() - t_start)
    if trace:
        from perfbench.trace import profile_units

        counts = []

        def unit():
            counts.append(workload.run_unit())

        run.trace = profile_units(unit, env.trace_units, workload.counters)
        run.window_s, run.units = run.trace.window_s, len(counts)
        run.attempted, run.failed = sum(a for a, _ in counts), sum(f for _, f in counts)
        return run
    need = getattr(workload, "min_units", 1)  # a unit that the check compares is in the window
    t0 = time.perf_counter()
    while True:
        a, f = workload.run_unit()
        run.units += 1
        run.attempted += a
        run.failed += f
        if time.perf_counter() - t0 >= seconds and run.units >= need:
            break
    if env.device.type == "cuda":
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    return run


def reader_path(name: str) -> Path:
    """`metrics/<name>.py`, else the reader of the quantity the name splits
    by cells (`idle_pct.train` -> `metrics/idle_pct.py`)."""
    own = PB / "metrics" / f"{name}.py"
    return own if own.is_file() else PB / "metrics" / f"{name.split('.')[0]}.py"


def read_metrics(run: Run, metrics: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in metrics:
        reader = _load(reader_path(m["name"]), "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: List[Tuple[str, float]], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): each number at most its limit."""
    table, ok = {}, True
    for name, value in checks:
        limit = float(limits[name])
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": float(value), "limit": limit}
    missing = set(limits) - {n for n, _ in checks}
    if missing:
        raise RuntimeError(f"the check gave no reading of {sorted(missing)}")
    return ok, table


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def breakdown(trace) -> Dict[str, Any]:
    return {"device_ops": trace.top_ops(10), "idle_gaps": [[n, s] for n, s in trace.idle_gaps]}


def run_cell(cell: str, seed: int, seconds: float, device, overrides=None, control=False):
    """Set up and run one cell without the command line's checks of the
    card (tests on the CPU, readings of the limits): returns (run, correct,
    checks table, the control's numbers or None)."""
    env = make_env(cell, seed, device, overrides)
    run = measure(env, seconds, False, time.perf_counter())
    correct, table = judge(run.workload.check(), env.limits)
    return run, correct, table, (run.workload.control() if control else None)
