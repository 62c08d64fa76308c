"""Readings that set a cell's limits: the numbers its check compares, for the
program on many seeds and for the control (the plain reference in TF32 in
the program's place) on a few, in one process on the card.

    python3 -m perfbench.readings --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 --seconds 2 [--fault <name>]

Each seed's run sets up the cell at its own size and load, runs a short
window and checks it, as a benchmark run does; one JSON line per seed.
With --fault, a fault of `perfbench/faults.py` is planted under the timed
path first, and the program's numbers are the fault's readings. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("perfbench.readings: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.reference.model import set_precision
    set_precision()
    device = torch.device("cuda", 0)
    if args.fault:
        from perfbench import faults
        faults.plant(args.fault)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        run, correct, table, ctrl = harness.run_cell(args.workload, seed, args.seconds, device,
                                                     control=seed in args.control_seeds)
        line = {"workload": args.workload, "fault": args.fault, "seed": seed, "correct": correct,
                "program": {k: v["value"] for k, v in table.items()},
                "units": run.units, "attempted": run.attempted, "failed": run.failed,
                "seconds": time.perf_counter() - t0}
        if ctrl is not None:
            line["control"] = dict(ctrl)
        line["extra"] = dict(getattr(run.workload, "extra", {}))
        info = getattr(run.workload, "info", None)
        if info is not None:
            line["info"] = info()
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
