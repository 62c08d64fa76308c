"""Where a stage of the cluster route spends its cycles, on one CUDA card: the
route's kernels built with clock64 probes and read part by part.

    python3 kernel_probes.py

`csrc/fused_rk4_wide.cuh` reads the macro FUSED_RK4_PROBE: built with it, thread
0 of a launch's first CTA adds the cycles of each part of a stage (the drift,
each product, each exchange, the last layer, phase 2's transposed products,
phase 3) to a device array that the library's `fused_rk4_probes` returns.
Built without it (the default) the kernels hold none of it. This script builds
the libraries both ways, then at the two shapes of chip_smoke.py phase 3e (the
cohort's first 32 windows, T=61, tile width 32; one window over a day, B=1,
T=289, tile width 4) launches the forward and the hand adjoint once on the
cluster route in the probe build, prints the mean cycles of each part, and
times both kernels in both builds (CUDA events, median of 5): the probes cost
a barrier at the end of each part that has none. The report names the
product variant the libraries take at each shape (`fused_rk4.PRODUCTS`).
Writes all of it to kernel_probes.json beside chip_smoke.py's report.
"""

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chip_smoke import OUT as SMOKE_OUT
from chip_smoke import CKPT, DATA, SUBSTEPS, cohort_inputs, nvidia_smi, one_day, time_ms
from hybrid_ode_torch.data.dataset import create_data_arrays
from hybrid_ode_torch.models.hybrid import config_from_dict
from hybrid_ode_torch.ops import fused_rk4
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

OUT = SMOKE_OUT.parent / "kernel_probes.json"
PROBE = ("-DFUSED_RK4_PROBE=1",)
#: the header's ProbePart, in order
PARTS = ("drift", "layer 0", "hidden product", "exchange", "last layer", "stage rest",
         "T first product", "T hidden product", "T input product", "T exchange", "T stage rest",
         "phase 3")


def read_probes(lib):
    out = (ctypes.c_longlong * (2 * len(PARTS)))()
    err = lib.fused_rk4_probes(out)
    if err:
        raise RuntimeError(f"fused_rk4_probes failed: cudaError {err}")
    return {name: {"cycles": out[i] / out[len(PARTS) + i], "calls": out[len(PARTS) + i]}
            for i, name in enumerate(PARTS) if out[len(PARTS) + i]}


def measure(p, gbar):
    """Both kernels on the cluster route at inputs p: their times in the plain
    and the probe build, and the probes' cycles a part."""
    fwd = lambda: fused_rk4._fwd_cuda(*p, SUBSTEPS, route="cluster")  # noqa: E731
    got = {}
    for build, defines in (("plain build", ()), ("probe build", PROBE)):
        fused_rk4.KERNEL_DEFINES = defines
        with torch.no_grad():
            traj = fwd()
            bwd = lambda: fused_rk4._bwd_cuda(traj, gbar, *p[1:], SUBSTEPS,  # noqa: E731
                                              route="cluster")
            got[build] = {"fwd_ms": time_ms(fwd, 1, 5), "bwd_ms": time_ms(bwd, 1, 5)}
            if defines:
                libs = fused_rk4._libraries()
                for kernel, run in (("fwd", fwd), ("bwd", bwd)):
                    lib = f"fused_rk4_{kernel}"
                    read_probes(libs[lib])
                    run()
                    got[f"{kernel}_cycles"] = read_probes(libs[lib])
    fused_rk4.KERNEL_DEFINES = ()
    return got


def main():
    if not torch.cuda.is_available():
        print("kernel_probes: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(fused_rk4.build_library, [(), PROBE]))

    state, meta = load_checkpoint(str(CKPT))
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(meta["config"], use_pallas=True)
    batch, ctrl = cohort_inputs(create_data_arrays(str(DATA), 61, 30), params, config, device)
    sig = ctrl.signals
    packed = fused_rk4.pack(batch["initial_state"], batch["time_points"], sig["meal"],
                            sig["tVNS"], params["ode"], params["nn"], config.nn_layers,
                            sig["context"])
    head = (packed[0][:32].contiguous(), *(x[:, :32].contiguous() for x in packed[1:5]),
            packed[5], packed[6])
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "shapes": {}}
    for name, p in (("B32", head), ("B1", one_day(packed))):
        B, T = p[0].shape[0], p[1].shape[0]
        gbar = torch.as_tensor(np.random.default_rng(0).normal(size=(T, 6, B)).astype(np.float32),
                               device=device)
        tw = fused_rk4._cluster_tile(B, fused_rk4.fwd_tile())
        chosen = fused_rk4._fwd_cluster(p[5].in_pad, p[5].hidden, p[5].n_layers, tw,
                                        torch.cuda.current_device())[2]
        report["shapes"][name] = {"B": B, "T": T, "tw": tw}
        got = report["shapes"][name][chosen] = measure(p, gbar)
        for kernel in ("fwd", "bwd"):
            print(f"probes ({smi}) {name} (B={B} T={T}, tile {tw}) '{chosen}' {kernel}: "
                  + "; ".join(f"{n} {v['cycles']:.0f} x{v['calls']}"
                              for n, v in got[f"{kernel}_cycles"].items()))
        print(f"probes {name} '{chosen}': forward {got['plain build']['fwd_ms']:.3f} ms "
              f"({got['probe build']['fwd_ms']:.3f} with probes), adjoint "
              f"{got['plain build']['bwd_ms']:.3f} ms ({got['probe build']['bwd_ms']:.3f})")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
