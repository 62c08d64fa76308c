"""Port parity for the member-sharded ensemble step and chain-sharded NUTS.

Worlds of 2 and 4 processes (gloo on the CPU, `_torch_parallel_worker.py`)
run the port; the references are the port's unsharded runs on the same
members, generators and draws (at 1e-6 relative), and the JAX package's
unsharded ensemble step (its own suite holds sharded to unsharded,
`tests/test_parallel_and_misc.py:649`, `:696`) at 1e-5. NUTS's reference is
JAX's own property, sharded equals unsharded (`:757`): the port's sharded
run must equal its unsharded one draw for draw, with the mass adapting
(num_warmup > 10, so the Welford all-reduces run), through `nuts_sample` and
`run_nuts(engine='fused')` (the kernels' plain versions on the CPU).
"""

import json

import jax
import numpy as np
import pytest
import torch

from _torch_parallel_worker import flatten, run_world
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.parallel import ensemble as jens
from hybrid_ode_tpu.train import loop as jloop
from hybrid_ode_torch.data.dataset import batch_to_tensors
from hybrid_ode_torch.inference import mcmc
from hybrid_ode_torch.models.hybrid import HybridConfig
from hybrid_ode_torch.parallel import ensemble as tens
from hybrid_ode_torch.train.loop import _to_params

torch.set_num_threads(1)

FAST = dict(solver="rk4", substeps=2, nn_hidden=8, nn_layers=2, mode="scan")
T = 6
JAX_RTOL = 2e-5      # the JAX suite's 2D ensemble tolerance
UNSHARDED_RTOL = 1e-6
NUTS_KW = dict(num_samples=6, num_warmup=14, max_depth=4, init_step_size=0.5, adapt_mass=True)
FUSED_KW = dict(n_chains=4, num_warmup=12, num_samples=2, max_depth=2, engine="fused")


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-8)


def _members(K, seed):
    """The port's stacked members (non-zero output layers), as numpy."""
    stacked = tens.init_ensemble(seed, HybridConfig(**FAST), K, device="cpu")
    out = {g: {k: v.numpy().copy() for k, v in grp.items()} for g, grp in stacked.items()}
    last = f"w{FAST['nn_layers']}"
    out["nn"][last] = (0.05 * np.random.default_rng(seed).normal(
        size=out["nn"][last].shape)).astype(np.float32)
    return out


def _batch(n, seed, loss_weights=False):
    rng = np.random.default_rng(seed)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2], np.float32)
    y0 = np.abs(base[None, :] * (1 + 0.05 * rng.standard_normal((n, 6)))).astype(np.float32)
    obs = (y0[:, None, :] * (1 + 0.05 * rng.standard_normal((n, T, 6)))).astype(np.float32)
    mask = (rng.uniform(size=(n, T)) > 0.2).astype(np.float32)
    mask[: n // 2] = (rng.uniform(size=(n // 2, T)) > 0.7).astype(np.float32)  # unequal shards
    b = {"initial_state": y0, "observations": obs,
         "time_points": np.broadcast_to(np.linspace(0, 1, T, dtype=np.float32), (n, T)).copy(),
         "external_inputs": {"meal": (rng.uniform(size=(n, T)) > 0.7).astype(np.float32),
                             "tVNS": rng.uniform(0, 1, (n, T)).astype(np.float32)},
         "mask": mask}
    if loss_weights:
        b["loss_weights"] = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    return b


def _gaussian():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 3))
    return np.array([1.0, -2.0, 0.5]), a @ a.T + 3 * np.eye(3), 0.1 * rng.normal(size=(8, 3))


def _ens_inputs(K, seed, n, loss_weights):
    inputs = {"ens_config": json.dumps(FAST),
              "ens_seeds": np.random.SeedSequence(seed).generate_state(K).astype(np.int64)}
    inputs.update(flatten(_members(K, seed), "ens_params/"))
    inputs.update(flatten(_batch(n, seed, loss_weights), "ens_batch/"))
    return inputs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    inputs = _ens_inputs(4, 11, 8, False)
    mu, prec, q0 = _gaussian()
    inputs.update(nuts_mu=mu, nuts_prec=prec, nuts_q0=q0, nuts_kwargs=json.dumps(NUTS_KW),
                  fused_config=json.dumps(FAST), fused_kwargs=json.dumps(FUSED_KW))
    inputs.update(flatten(_fused_params(), "fused_params/"))
    inputs.update(flatten(_batch(2, 5), "fused_batch/"))
    return inputs, run_world("ens_nuts", 2, inputs, tmp_path_factory.mktemp("ens_nuts"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    inputs = _ens_inputs(2, 13, 8, True)
    return inputs, run_world("ens2d", 4, inputs, tmp_path_factory.mktemp("ens2d"))


def _fused_params():
    p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(
        jax.random.PRNGKey(2), jhyb.HybridConfig(**FAST)))
    p["nn"]["w2"] = (0.05 * np.random.default_rng(2).normal(size=p["nn"]["w2"].shape)
                     ).astype(np.float32)
    return p


def _port_ensemble_step(inputs, use_physics):
    K = len(inputs["ens_seeds"])
    stacked = {}
    for key, v in inputs.items():
        if key.startswith("ens_params/"):
            g, name = key.split("/")[1:]
            stacked.setdefault(g, {})[name] = torch.as_tensor(v)
    batch = _unflat_batch(inputs)
    opt = tens.make_ensemble_optimizer(1e-3, 1, 1, 5.0)
    state = tens.init_ensemble_state(opt, stacked)
    gens = [torch.Generator().manual_seed(int(s)) for s in inputs["ens_seeds"]]
    step = tens.make_ensemble_train_step(opt, HybridConfig(**FAST), 1.0, 0.01, use_physics)
    state, metrics = step(state, batch_to_tensors(batch, "cpu"), gens)
    assert metrics["loss"].shape == (K,)
    return ({g: {k: v.detach().numpy() for k, v in grp.items()}
             for g, grp in state.params.items()},
            {k: v.numpy() for k, v in metrics.items()})


def _unflat_batch(inputs):
    batch = {}
    for key, v in inputs.items():
        if key.startswith("ens_batch/"):
            *path, leaf = key.split("/")[1:]
            node = batch
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return batch


def _jax_ensemble_step(inputs):
    """JAX's unsharded ensemble step without the physics term (whose draws
    come from keys in JAX and generators in the port)."""
    params = {}
    for key, v in inputs.items():
        if key.startswith("ens_params/"):
            g, name = key.split("/")[1:]
            params.setdefault(g, {})[name] = v
    K = len(inputs["ens_seeds"])
    opt = jloop.make_optimizer(1e-3, 1, 1, 5.0)
    step = jens.make_ensemble_train_step(opt, jhyb.HybridConfig(**FAST), 1.0, 0.01, False)
    state, metrics = step(jens.init_ensemble_state(opt, params), _unflat_batch(inputs),
                          jax.random.split(jax.random.PRNGKey(7), K))
    return (jax.tree_util.tree_map(np.asarray, state.params),
            {k: np.asarray(v) for k, v in metrics.items()})


def _sharded(ranks, key, member_ranks):
    """(params stacked in member order, metrics) of a sharded run: metrics
    from rank 0 (gathered, equal on every rank), params from the ranks that
    hold the successive members."""
    a0 = ranks[0][0]
    for arrays, _ in ranks[1:]:
        for k in a0:
            if k.startswith(f"{key}/metrics/"):
                np.testing.assert_array_equal(a0[k], arrays[k], err_msg=k)
    metrics = {k.split("/")[-1]: v for k, v in a0.items() if k.startswith(f"{key}/metrics/")}
    params = {}
    for k in a0:
        if k.startswith(f"{key}/params/"):
            g, name = k.split("/")[2:]
            params.setdefault(g, {})[name] = np.concatenate(
                [ranks[r][0][k] for r in member_ranks])
    return params, metrics


def _check(params, metrics, ref_params, ref_metrics, rtol, keys=("loss", "data", "physics",
                                                                  "reg", "grad_norm")):
    for k in keys:
        assert _rel_err(ref_metrics[k], metrics[k]) < rtol, k
    np.testing.assert_array_equal(metrics["update_ok"], ref_metrics["update_ok"])
    for g in ref_params:
        for name in ref_params[g]:
            assert _rel_err(ref_params[g][name], params[g][name]) < rtol, (g, name)


@pytest.mark.parametrize("mesh_shape", ["ens", "ens_data"])
def test_member_sharded_ensemble_step_matches_unsharded(mesh_shape, world2, world4):
    """Mirrors test_ensemble_step_matches_single_member_and_shards (world 2 on
    ('ens',), 2 members per rank) and test_ensemble_2d_mesh_ens_by_data (world
    4 on (ens, data) of shape (2, 2), unequal mask counts on the data shards,
    a (6,) loss_weights leaf)."""
    inputs, ranks = world2 if mesh_shape == "ens" else world4
    member_ranks = (0, 1) if mesh_shape == "ens" else (0, 2)
    for key, use_physics in (("ens", True), ("ens_nophys", False)):
        params, metrics = _sharded(ranks, key, member_ranks)
        _check(params, metrics, *_port_ensemble_step(inputs, use_physics), UNSHARDED_RTOL)
    params, metrics = _sharded(ranks, "ens_nophys", member_ranks)
    _check(params, metrics, *_jax_ensemble_step(inputs), JAX_RTOL,
           keys=("loss", "data", "reg"))
    if mesh_shape == "ens_data":  # both data ranks of a member hold the same update
        for k in ranks[0][0]:
            if k.startswith("ens/params/"):
                np.testing.assert_array_equal(ranks[0][0][k], ranks[1][0][k])
                np.testing.assert_array_equal(ranks[2][0][k], ranks[3][0][k])


def test_chain_sharded_nuts_equals_unsharded(world2):
    inputs, ranks = world2
    mu, prec = torch.as_tensor(inputs["nuts_mu"]), torch.as_tensor(inputs["nuts_prec"])

    def logp(q):
        d = q - mu
        return -0.5 * torch.einsum("ci,ij,cj->c", d, prec, d)

    ref = mcmc.nuts_sample(logp, torch.as_tensor(inputs["nuts_q0"]),
                           torch.Generator().manual_seed(1), **NUTS_KW)
    assert ref["samples"].shape == (8, NUTS_KW["num_samples"], 3)
    assert not np.allclose(ref["inv_mass"], 1.0)  # the mass adapted
    for arrays, _ in ranks:
        for k, v in ref.items():
            got = arrays[f"nuts/{k}"]
            assert got.shape == v.shape, k
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(got, v, err_msg=k)
            else:
                assert _rel_err(v, got) < UNSHARDED_RTOL, k


def test_chain_sharded_fused_run_nuts_equals_unsharded(world2):
    inputs, ranks = world2
    params = _to_params(_fused_params(), torch.device("cpu"))
    ref = mcmc.run_nuts(params, _batch(2, 5), HybridConfig(**FAST),
                        torch.Generator().manual_seed(3), **FUSED_KW)
    for arrays, _ in ranks:
        for k, v in ref.items():
            got = arrays[f"fused/{k}"]
            assert got.shape == np.shape(v), k
            if np.asarray(v).dtype.kind in "biu":
                np.testing.assert_array_equal(got, v, err_msg=k)
            else:
                assert _rel_err(v, got) < UNSHARDED_RTOL, k


def test_nuts_rejects_non_divisible_chain_count(world2):
    """Mirrors test_nuts_rejects_non_divisible_chain_count: 3 chains on 2 ranks."""
    for _, info in world2[1]:
        assert info["non_dividing"] is not None and "multiple of" in info["non_dividing"]
