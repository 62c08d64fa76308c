"""What each part of the forward kernel and of the hand adjoint costs, on one
CUDA card: the kernels timed whole and with a part left out.

    python3 kernel_cuts.py

The kernels have no run-time switch for this. `csrc/fused_rk4_wide.cuh` reads
the macro FUSED_RK4_CUT, a set of bits that each leave one part out of the
compiled kernel. This script builds the libraries once more for every set in
CUTS (all nvcc runs start together), points the wrappers of
`hybrid_ode_torch.ops.fused_rk4` at each build in turn and times both kernels
at chip_smoke.py's cohort shape (the accuracy checkpoint, B=8192, T=61,
substeps=4, H=128, 16 context features; CUDA events, median of 20), the whole
kernels first and once more at the end. A cut kernel's outputs are wrong by
design and are not looked at; the whole kernels are checked by chip_smoke.py.

It prints a line per build, the differences that split the adjoint's time into
its phases, the card's name and power limit, and writes all of it to
chiprun_out/kernel_cuts.json. What is left out no longer overlaps with what
stays, so the parts need not add up to what they cost inside the whole kernel.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import CKPT, COHORT, DATA, SUBSTEPS, bwd_inputs, cohort_inputs, nvidia_smi, time_ms
from hybrid_ode_torch.data.dataset import create_data_arrays
from hybrid_ode_torch.models.hybrid import config_from_dict
from hybrid_ode_torch.ops import fused_rk4
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

OUT = Path(__file__).resolve().parent / "chiprun_out" / "kernel_cuts.json"
# name -> bits of FUSED_RK4_CUT (csrc/fused_rk4_wide.cuh)
CUTS = {
    "whole": 0,
    "operands not saved": 1,
    "no weight cotangents": 4,
    "no weight cotangents, no reverse sweep": 4 | 2,
    "forward products only": 4 | 2 | 1,
    "operand loads at every 4th k": 8,
}


def defines(bits):
    return (f"-DFUSED_RK4_CUT={bits}",) if bits else ()


def main():
    if not torch.cuda.is_available():
        print("kernel_cuts: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    with ThreadPoolExecutor(len(CUTS)) as pool:
        list(pool.map(fused_rk4.build_library, [defines(b) for b in CUTS.values()]))

    state, meta = load_checkpoint(str(CKPT))
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(meta["config"], use_pallas=True)
    batch, ctrl = cohort_inputs(create_data_arrays(str(DATA), 61, 30), params, config, device)
    sig = ctrl.signals
    packed = fused_rk4.pack(batch["initial_state"], batch["time_points"], sig["meal"],
                            sig["tVNS"], params["ode"], params["nn"], config.nn_layers,
                            sig["context"])
    T = batch["time_points"].shape[1]
    traj, gbar = bwd_inputs(packed, T, SUBSTEPS)

    def time_both(bits):
        fused_rk4.KERNEL_DEFINES = defines(bits)
        with torch.no_grad():
            fwd = time_ms(lambda: fused_rk4.fused_rk4_fwd(*packed, SUBSTEPS), 2, 20)
            bwd = time_ms(lambda: fused_rk4.fused_rk4_bwd(traj, gbar, *packed[1:], SUBSTEPS), 2, 20)
        return {"fwd_ms": fwd, "bwd_ms": bwd}

    times = {name: time_both(bits) for name, bits in CUTS.items()}
    times["whole, again"] = time_both(0)
    for name, t in times.items():
        print(f"cuts ({smi}) B={COHORT} T={T}: {name}: forward kernel {t['fwd_ms']:.3f} ms, "
              f"hand adjoint {t['bwd_ms']:.3f} ms")
    bwd = {name: t["bwd_ms"] for name, t in times.items()}
    phases = {
        "forward products (phase 1 without its saves)": bwd["forward products only"],
        "phase 1's saves": (bwd["no weight cotangents, no reverse sweep"]
                            - bwd["forward products only"]),
        "reverse sweep with its saves (phase 2)": (bwd["no weight cotangents"]
                                                   - bwd["no weight cotangents, no reverse sweep"]),
        "weight and bias cotangents (phase 3)": bwd["whole"] - bwd["no weight cotangents"],
        "all saves, everything else in place": bwd["whole"] - bwd["operands not saved"],
    }
    print(f"hand adjoint by parts ({smi}): " + "; ".join(f"{k} {v:.3f} ms" for k, v in phases.items()))
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                               "times": times, "adjoint_parts_ms": phases}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
