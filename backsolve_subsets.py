"""Backsolve against the discrete scan adjoint on several window subsets.

    python3 backsolve_subsets.py [--device cuda]

The gradients of one MSE through adjoint='backsolve' and through the discrete
scan adjoint, with checkpoints/4gi_baseline_full on the first three 256-window
subsets of chip_smoke.py's 8192-window cohort (subset 0 is the one phase 4d
checks). Prints, per subset, the worst ODE parameter against the JAX suite's
limit (with its two gradients) and the worst MLP leaf's _rel_err: the readings behind chip_smoke.py's
BACKSOLVE_NN_RTOL. Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from hybrid_ode_torch.data.dataset import create_data_arrays
from hybrid_ode_torch.models.hybrid import config_from_dict
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy
from hybrid_ode_torch.utils.device import resolve_device

WINDOWS, SUBSETS = 256, 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = create_data_arrays(str(chip_smoke.DATA), 61, 30)
    state, meta = load_checkpoint(str(chip_smoke.ADAPTIVE_CKPT))
    params = params_from_numpy(state["params"], device)
    config = config_from_dict(meta["config"])
    batch, ctrl = chip_smoke.cohort_inputs(ds, params, config, device)
    readings = []
    for k in range(SUBSETS):
        sel = slice(k * WINDOWS, (k + 1) * WINDOWS)
        (worst_ode, name, gd, gb), worst_nn, seconds = chip_smoke.backsolve_vs_discrete(
            params, config, batch, ctrl, sel)
        print(f"subset {k} (windows {sel.start}-{sel.stop - 1}) on {device.type}: ODE parameters "
              f"worst |b-d|/(1e-8+1e-3|d|)={worst_ode:.3f} ({name}: d={gd:.6e} b={gb:.6e}); "
              f"MLP leaves worst _rel_err {worst_nn:.3e}; {seconds['discrete']:.2f} s discrete, "
              f"{seconds['backsolve']:.2f} s backsolve", flush=True)
        readings.append({"subset": k, "worst_ode": worst_ode, "worst_ode_param": [name, gd, gb],
                         "worst_nn": worst_nn})
    print(json.dumps({"device": device.type, "readings": readings}))


if __name__ == "__main__":
    main()
