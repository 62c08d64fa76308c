"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. With --trace 0 the result holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics from a profiled run of whole units. Every
run checks what its timed path produced against the plain reference
(`perfbench/reference/`) and prints each number compared beside its limit,
as the last lines on standard error and under "checks" in the result.
The run exits non-zero, with no result, where there is no card, too few
cards, or a JAX module in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    doc = harness.benchmark()
    entry = harness.cell_entry(doc, args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < entry["chips"]:
        return fail(f"the cell needs {entry['chips']} cards, "
                    f"{torch.cuda.device_count()} are visible")
    torch.set_num_threads(2)
    from perfbench.reference.model import set_precision
    set_precision()
    device = torch.device("cuda", 0)
    env = harness.make_env(args.workload, args.seed, device)
    run = harness.measure(env, args.seconds, bool(args.trace), T_START)
    peak = torch.cuda.max_memory_allocated(device)
    run.power = power_limit()
    metrics = harness.read_metrics(run, harness.cell_metrics(doc, args.workload, bool(args.trace)))
    checks = run.workload.check()
    correct, table = harness.judge(checks, env.limits)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"JAX modules loaded in the benchmark's process: {bad}")
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": entry["chips"], "memory_peak_bytes": int(peak)}}
    if args.trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = harness.breakdown(run.trace)
    result["checks"] = table
    print(f"perfbench: {args.workload} seed {args.seed}: {run.units} units, {run.attempted} "
          f"{run.workload.unit_name}, {run.failed} failed, window {run.window_s:.3f} s, set-up "
          f"{run.setup_s:.3f} s, card {run.power or 'unknown'}; program counters "
          f"{run.workload.counters()}; {getattr(run.workload, 'info', dict)()}", file=sys.stderr)
    if run.trace is not None:
        seen = {k: run.trace.kernel(k)[1] for k in run.workload.kernel_bounds}
        print(f"perfbench: trace: program counters {run.trace.counters}, kernel launches in "
              f"the trace {seen}, device operations {run.trace.launches}, host "
              f"{run.trace.host_s:.3f} s", file=sys.stderr)
    for name, row in table.items():
        verdict = "ok" if row["value"] <= row["limit"] else "FAIL"
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r}) {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
