"""Rank worker of the port's multi-process tests (no JAX: it runs where the
port runs).

    python tests/_torch_parallel_worker.py <scenario> <rank> <world> <store> <inputs.npz> <out_dir>

Each of `world` processes joins a gloo world on the CPU through a file store,
runs one scenario of `hybrid_ode_torch/parallel/` on the inputs the test
wrote, and saves what it got to <out_dir>/<scenario>_r<rank>.npz. The test
(`run_world`) starts the processes and compares their results with the JAX
package's and with the port's unsharded runs:

  train    the data-parallel train step (shard_batch, process_local_batch
           with unequal mask counts, a replicated non-divisible batch),
           shard_batch's rules, process_local_batch, parallel_cohort_sim
  ens_nuts the member-sharded ensemble step on ('ens',), chain-sharded
           nuts_sample and run_nuts(engine='fused'), the non-dividing chain
           count
  ens2d    the ensemble step on an (ens, data) mesh of shape (2, 2)
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hybrid_ode_torch.data.dataset import batch_to_tensors  # noqa: E402
from hybrid_ode_torch.inference import mcmc  # noqa: E402
from hybrid_ode_torch.models import hybrid as thyb  # noqa: E402
from hybrid_ode_torch.models.hybrid import HybridConfig  # noqa: E402
from hybrid_ode_torch.parallel import distributed, ensemble  # noqa: E402
from hybrid_ode_torch.parallel.mesh import (  # noqa: E402
    local_slice,
    make_mesh,
    replicate,
    shard_batch,
)
from hybrid_ode_torch.parallel.train_parallel import (  # noqa: E402
    make_parallel_train_step,
    parallel_cohort_sim,
)
from hybrid_ode_torch.train.loop import TrainState, _to_params, make_optimizer  # noqa: E402

CPU = torch.device("cpu")


def flatten(tree, prefix=""):
    """Nested dicts -> {'a/b': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def unflatten(flat, prefix):
    """{'prefix/a/b': leaf} -> {'a': {'b': leaf}}."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return out


def config(inp, name):
    return HybridConfig(**json.loads(str(inp[f"{name}_config"])))


def rows(tree, sl):
    """The rows `sl` of every leaf but the per-state `loss_weights`."""
    return {k: rows(v, sl) if isinstance(v, dict) else (v if k == "loss_weights" else v[sl])
            for k, v in tree.items()}


def fixed_physics_indices(idx):
    """The physics term's intervals, handed to the JAX package and the port alike."""
    thyb.physics_indices = lambda generator, n, k: torch.as_tensor(idx[:k])


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_step_result(mesh, inp, batch, key, out):
    cfg = config(inp, "train")
    params = replicate(mesh, unflatten(inp, "params"))
    state = TrainState(_to_params(params, CPU))
    opt = make_optimizer(1e-3, 1, 1, 5.0).bind(state.params)
    step = make_parallel_train_step(mesh, opt, cfg, 1.0, 0.01, True)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    out.update(flatten(metrics, f"{key}/metrics/"))
    out.update(flatten(state.params, f"{key}/params/"))


def train(rank, world, inp, out, info):
    fixed_physics_indices(inp["physics_idx"])
    mesh = make_mesh(world, device="cpu")
    batch = unflatten(inp, "batch")
    train_step_result(mesh, inp, batch, "equal", out)                     # sharded here
    train_step_result(mesh, inp, shard_batch(mesh, batch), "equal_placed", out)
    unequal = unflatten(inp, "unequal")
    half = unequal["initial_state"].shape[0] // world
    placed = distributed.process_local_batch(rows(unequal, slice(rank * half, (rank + 1) * half)),
                                             mesh)
    info["unequal_global_size"] = placed.global_size
    train_step_result(mesh, inp, placed, "unequal", out)

    # shard_batch's rules
    handler = Warnings()
    logging.getLogger("hybrid_ode_torch.parallel.mesh").addHandler(handler)
    rules = shard_batch(mesh, {"initial_state": np.ones((8, 6), np.float32),
                               "observations": np.ones((8, 5, 6), np.float32),
                               "loss_weights": np.ones(6, np.float32)})
    info["rules"] = {"axis": rules.axis, "global_size": rules.global_size,
                     "sharded_dim0": [p.is_shard(0) for p in rules.placements],
                     "shapes": {k: list(v.shape) for k, v in rules.items()}}
    odd = shard_batch(mesh, {"initial_state": np.ones((7, 6), np.float32),
                             "observations": np.ones((7, 5, 6), np.float32)})
    info["odd"] = {"axis": odd.axis, "global_size": odd.global_size,
                   "shapes": {k: list(v.shape) for k, v in odd.items()}}
    replicated_batch = unflatten(inp, "odd_batch")
    train_step_result(mesh, inp, replicated_batch, "replicated", out)
    info["warnings"] = handler.messages

    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    placed = distributed.process_local_batch({"x": x[rank * 8:(rank + 1) * 8]}, mesh)
    info["process_local"] = {"axis": placed.axis, "global_size": placed.global_size}
    out["process_local_x"] = placed["x"].numpy()

    sim = parallel_cohort_sim(mesh, config(inp, "cohort"))
    cohort_params = replicate(mesh, unflatten(inp, "cohort_params"))
    out["cohort"] = sim(cohort_params, inp["cohort_y0s"], inp["cohort_ts"]).numpy()


def _ensemble_steps(mesh, inp, data_axis, out):
    """One ensemble step with the physics term (per-member generators) and
    one without, each from the same members."""
    cfg = config(inp, "ens")
    for key, use_physics in (("ens", True), ("ens_nophys", False)):
        opt = ensemble.make_ensemble_optimizer(1e-3, 1, 1, 5.0)
        state = ensemble.init_ensemble_state(
            opt, shard_batch(mesh, unflatten(inp, "ens_params"), "ens"))
        gens = [torch.Generator().manual_seed(int(s))
                for s in inp["ens_seeds"][local_slice(mesh, len(inp["ens_seeds"]), "ens")]]
        step = ensemble.make_ensemble_train_step(opt, cfg, 1.0, 0.01, use_physics, mesh=mesh,
                                                 data_axis=data_axis)
        state, metrics = step(state, batch_to_tensors(unflatten(inp, "ens_batch"), CPU), gens)
        out.update(flatten(metrics, f"{key}/metrics/"))
        out.update(flatten(state.params, f"{key}/params/"))


def ens_nuts(rank, world, inp, out, info):
    _ensemble_steps(make_mesh(world, ("ens",), device="cpu"), inp, None, out)

    mesh = make_mesh(world, device="cpu")
    mu = torch.as_tensor(inp["nuts_mu"])
    prec = torch.as_tensor(inp["nuts_prec"])

    def logp(q):
        d = q - mu
        return -0.5 * torch.einsum("ci,ij,cj->c", d, prec, d)

    res = mcmc.nuts_sample(logp, torch.as_tensor(inp["nuts_q0"]),
                           torch.Generator().manual_seed(1), mesh=mesh,
                           **json.loads(str(inp["nuts_kwargs"])))
    out.update(flatten(res, "nuts/"))

    params = _to_params(unflatten(inp, "fused_params"), CPU)
    res = mcmc.run_nuts(params, unflatten(inp, "fused_batch"), config(inp, "fused"),
                        torch.Generator().manual_seed(3), mesh=mesh,
                        **json.loads(str(inp["fused_kwargs"])))
    out.update(flatten(res, "fused/"))

    try:
        mcmc.nuts_sample(logp, torch.zeros((3, 3), dtype=torch.float64), mesh=mesh,
                         num_samples=2, num_warmup=2)
        info["non_dividing"] = None
    except ValueError as e:
        info["non_dividing"] = str(e)


def ens2d(rank, world, inp, out, info):
    _ensemble_steps(make_mesh(world, ("ens", "data"), shape=(2, 2), device="cpu"), inp,
                    "data", out)


SCENARIOS = {"train": train, "ens_nuts": ens_nuts, "ens2d": ens2d}


def run_world(scenario, world, inputs, tmp_path, timeout=240):
    """Start `world` workers on `inputs` (a flat dict of arrays), wait for
    them, and return each rank's (arrays, info)."""
    tmp_path = Path(tmp_path)
    np.savez(tmp_path / f"{scenario}_in.npz", **inputs)
    store = tmp_path / f"{scenario}_store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), scenario, str(r), str(world),
         str(store), str(tmp_path / f"{scenario}_in.npz"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{log}"
    results = []
    for r in range(world):
        with np.load(tmp_path / f"{scenario}_r{r}.npz") as f:
            arrays = dict(f)
        results.append((arrays, json.loads((tmp_path / f"{scenario}_r{r}.json").read_text())))
    return results


def main(argv):
    scenario, rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    assert distributed.initialize(f"file://{store}", world, rank, device="cpu")
    try:
        with np.load(inputs) as f:
            inp = dict(f)
        out, info = {}, {}
        SCENARIOS[scenario](rank, world, inp, out, info)
        np.savez(Path(out_dir) / f"{scenario}_r{rank}.npz", **out)
        (Path(out_dir) / f"{scenario}_r{rank}.json").write_text(json.dumps(info))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
