"""Port parity for the multi-device layer: the data-parallel train step,
`shard_batch`, `distributed`, `parallel_cohort_sim`.

A world of 2 processes (gloo on the CPU, `_torch_parallel_worker.py`) runs
the port; the JAX package runs the same inputs on its 8-device virtual CPU
mesh (`tests/conftest.py`), as `tests/test_parallel_and_misc.py` does. The
train step is held to JAX's `make_parallel_train_step` at the tolerance
`tests/test_torch_training.py` holds the unsharded step to (1e-5 relative),
and to the port's unsharded step at 1e-6, also where the two shards carry
different mask counts (the global denominator). The cohort simulator is
held to JAX's `shard_map` one in f64 at the adaptive solvers' 1e-10.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import flatten, run_world
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.parallel import distributed as jdist
from hybrid_ode_tpu.parallel.mesh import make_mesh as j_make_mesh
from hybrid_ode_tpu.parallel.mesh import replicate as j_replicate
from hybrid_ode_tpu.parallel.mesh import shard_batch as j_shard_batch
from hybrid_ode_tpu.parallel.train_parallel import make_parallel_train_step as j_pstep
from hybrid_ode_tpu.parallel.train_parallel import parallel_cohort_sim as j_cohort_sim
from hybrid_ode_tpu.train import loop as jloop
from hybrid_ode_torch.data.dataset import batch_to_tensors
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.parallel import distributed
from hybrid_ode_torch.train import loop as tloop
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

FAST = dict(solver="rk4", substeps=2, nn_hidden=8, nn_layers=2, mode="scan")
COHORT = dict(solver="dopri5", rtol=1e-8, atol=1e-10, max_steps_per_interval=64,
              nn_hidden=8, nn_layers=2, mode="while")
B, T = 16, 6
JAX_RTOL = 1e-5      # tests/test_torch_training.py's port-vs-JAX step tolerance
UNSHARDED_RTOL = 1e-6
TRAJ_RTOL = 1e-10    # tests/test_torch_solvers.py's f64 trajectory tolerance


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-8)


def _params(cfg, seed=1):
    """JAX-initialised params with a non-zero last layer, as numpy."""
    p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(seed),
                                                                   cfg))
    last = f"w{cfg.nn_layers}"
    p["nn"][last] = (0.05 * np.random.default_rng(seed).normal(
        size=p["nn"][last].shape)).astype(np.float32)
    return p


def _batch(n=B, seed=0, unequal=False):
    """The JAX suite's batch layout (tests/_distributed_worker.py) with drawn
    observations and a mask; `unequal` masks most of the first half out."""
    rng = np.random.default_rng(seed)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2], np.float32)
    y0 = np.abs(base[None, :] * (1 + 0.05 * rng.standard_normal((n, 6)))).astype(np.float32)
    obs = (y0[:, None, :] * (1 + 0.05 * rng.standard_normal((n, T, 6)))).astype(np.float32)
    mask = (rng.uniform(size=(n, T)) > 0.2).astype(np.float32)
    if unequal:
        mask[: n // 2] = (rng.uniform(size=(n // 2, T)) > 0.8).astype(np.float32)
    return {"initial_state": y0, "observations": obs,
            "time_points": np.broadcast_to(np.linspace(0, 1, T, dtype=np.float32),
                                           (n, T)).copy(),
            "external_inputs": {"meal": (rng.uniform(size=(n, T)) > 0.7).astype(np.float32),
                                "tVNS": rng.uniform(0, 1, (n, T)).astype(np.float32)},
            "mask": mask}


def _jax_step(cfg, params, batch, monkeypatch, idx):
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(idx[:n]))
    mesh = j_make_mesh(8)
    opt = jloop.make_optimizer(1e-3, 1, 1, 5.0)
    pstep = j_pstep(mesh, opt, cfg, 1.0, 0.01, True)
    state = jloop.TrainState(j_replicate(mesh, params), j_replicate(mesh, opt.init(params)),
                             j_replicate(mesh, jnp.asarray(0, jnp.int32)))
    key = jax.device_put(jax.random.PRNGKey(0),
                         jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    new, metrics = pstep(state, j_shard_batch(mesh, batch), key)
    return (jax.tree_util.tree_map(np.asarray, new.params),
            {k: float(v) for k, v in metrics.items()})


def _port_unsharded(cfg, params, batch, monkeypatch, idx):
    monkeypatch.setattr(thyb, "physics_indices", lambda gen, n, k: torch.as_tensor(idx[:k]))
    state = tloop.TrainState(tloop._to_params(params, torch.device("cpu")))
    opt = tloop.make_optimizer(1e-3, 1, 1, 5.0).bind(state.params)
    step = tloop.make_train_step(opt, thyb.HybridConfig(**cfg), 1.0, 0.01, True)
    state, metrics = step(state, batch_to_tensors(batch, "cpu"), torch.Generator().manual_seed(0))
    return ({g: {k: v.detach().numpy() for k, v in grp.items()}
             for g, grp in state.params.items()},
            {k: float(v.detach()) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 2-process run of every scenario of this file."""
    cfg = jhyb.HybridConfig(**FAST)
    inputs = {"train_config": json.dumps(FAST), "cohort_config": json.dumps(COHORT),
              "physics_idx": np.random.default_rng(1).permutation(T - 1)}
    inputs.update(flatten(_params(cfg), "params/"))
    inputs.update(flatten(_batch(), "batch/"))
    inputs.update(flatten(_batch(seed=2, unequal=True), "unequal/"))
    inputs.update(flatten(_batch(n=15, seed=3), "odd_batch/"))
    ccfg = jhyb.HybridConfig(**COHORT)
    inputs.update(flatten(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                                 _params(ccfg, seed=4)), "cohort_params/"))
    inputs["cohort_y0s"] = _batch(seed=5)["initial_state"].astype(np.float64)
    inputs["cohort_ts"] = np.linspace(0.0, 1.0, 5)
    ranks = run_world("train", 2, inputs, tmp_path_factory.mktemp("train_world"))
    return inputs, ranks


def _unflat(arrays, prefix):
    out = {}
    for k, v in arrays.items():
        if k.startswith(prefix):
            g, name = k[len(prefix):].split("/")
            out.setdefault(g, {})[name] = v
    return out


def _check_step(ranks, key, ref_params, ref_metrics, rtol):
    (a0, _), (a1, _) = ranks
    for k in a0:
        if k.startswith(f"{key}/"):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=f"ranks differ at {k}")
    for k in ("loss", "data", "physics", "reg"):
        got = float(a0[f"{key}/metrics/{k}"])
        assert abs(got - ref_metrics[k]) <= rtol * abs(ref_metrics[k]) + 1e-12, (key, k)
    got = _unflat(a0, f"{key}/params/")
    for g in ref_params:
        for name in ref_params[g]:
            assert _rel_err(ref_params[g][name], got[g][name]) < rtol, (key, g, name)


@pytest.mark.parametrize("placement", ["equal", "equal_placed"])
def test_sharded_train_step_matches_jax_and_the_unsharded_step(world, placement, monkeypatch):
    """Mirrors test_sharded_train_step_matches_single_device and
    test_two_process_distributed_matches_single (tests/test_parallel_and_misc.py)."""
    inputs, ranks = world
    cfg = jhyb.HybridConfig(**FAST)
    params, batch, idx = _params(cfg), _batch(), inputs["physics_idx"]
    jp, jm = _jax_step(cfg, params, batch, monkeypatch, idx)
    _check_step(ranks, placement, jp, jm, JAX_RTOL)
    tp, tm = _port_unsharded(FAST, params, batch, monkeypatch, idx)
    _check_step(ranks, placement, tp, tm, UNSHARDED_RTOL)
    assert abs(float(ranks[0][0][f"{placement}/metrics/grad_norm"]) - tm["grad_norm"]) <= (
        UNSHARDED_RTOL * tm["grad_norm"])


def test_unequal_mask_counts_take_the_global_denominator(world, monkeypatch):
    inputs, ranks = world
    batch = _batch(seed=2, unequal=True)
    counts = batch["mask"][:8].sum(), batch["mask"][8:].sum()
    assert counts[0] < 0.5 * counts[1]  # the shards' denominators differ
    assert ranks[0][1]["unequal_global_size"] == B
    cfg = jhyb.HybridConfig(**FAST)
    params, idx = _params(cfg), inputs["physics_idx"]
    _check_step(ranks, "unequal", *_port_unsharded(FAST, params, batch, monkeypatch, idx),
                UNSHARDED_RTOL)
    _check_step(ranks, "unequal", *_jax_step(cfg, params, batch, monkeypatch, idx), JAX_RTOL)


def test_shard_batch_dominant_dim_and_divisibility(world, monkeypatch):
    """Mirrors test_shard_batch_dominant_dim_and_divisibility: the batch leaves
    shard, the (6,) leaf stays whole although 2 divides 6, a non-divisible
    batch replicates with the warning and the step on it equals the
    unsharded one."""
    inputs, ranks = world
    for _, info in ranks:
        rules = info["rules"]
        assert rules["axis"] == "data" and rules["global_size"] == 8
        assert rules["sharded_dim0"] == [True]
        assert rules["shapes"] == {"initial_state": [4, 6], "observations": [4, 5, 6],
                                   "loss_weights": [6]}
        assert info["odd"] == {"axis": None, "global_size": 7,
                               "shapes": {"initial_state": [7, 6], "observations": [7, 5, 6]}}
        assert sum("not divisible" in m for m in info["warnings"]) == 2
    params = _params(jhyb.HybridConfig(**FAST))
    _check_step(ranks, "replicated",
                *_port_unsharded(FAST, params, _batch(n=15, seed=3), monkeypatch,
                                 inputs["physics_idx"]), UNSHARDED_RTOL)


def test_distributed_initialize_single_process_noop(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert jdist.initialize() is False
    assert not torch.distributed.is_initialized()


def test_process_local_batch_places_each_shard(world):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for r, (arrays, info) in enumerate(world[1]):
        assert info["process_local"] == {"axis": "data", "global_size": 16}
        np.testing.assert_array_equal(arrays["process_local_x"], x[r * 8:(r + 1) * 8])
    placed = jdist.process_local_batch({"x": x}, j_make_mesh(8))
    np.testing.assert_array_equal(
        np.concatenate([a["process_local_x"] for a, _ in world[1]]), np.asarray(placed["x"]))


def test_parallel_cohort_sim_matches_jax_shard_map(world, x64):
    inputs, ranks = world
    cfg = jhyb.HybridConfig(**COHORT)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                                           _params(cfg, seed=4)))
    mesh = j_make_mesh(8)
    ts = jax.device_put(jnp.asarray(inputs["cohort_ts"]),
                        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    ref = np.asarray(j_cohort_sim(mesh, cfg)(j_replicate(mesh, params),
                                             j_shard_batch(mesh, inputs["cohort_y0s"]), ts))
    assert ref.dtype == np.float64 and ref.shape == (B, 5, 6)
    for arrays, _ in ranks:
        assert arrays["cohort"].shape == ref.shape
        assert _rel_err(ref, arrays["cohort"]) < TRAJ_RTOL
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu",
                                dtype=torch.float64)
    alone = thyb.forward(tparams, torch.as_tensor(inputs["cohort_y0s"]),
                         torch.as_tensor(inputs["cohort_ts"]), None,
                         thyb.HybridConfig(**dataclasses.asdict(cfg)), mode="while")
    np.testing.assert_array_equal(ranks[0][0]["cohort"], alone.numpy())
