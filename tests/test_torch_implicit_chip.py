"""chip_smoke.py phase 4g's implicit-solver constants, recomputed from the JAX
package on the CPU, and the port's values on the CPU beside them.

(b) `evaluate_checkpoint` of checkpoints/4gi_baseline_full with solver radau
and with bdf (12 steps per interval, while mode) on the seed-42 test split;
(c) one scan-mode radau train step's loss and gradient norm on the seed-42
train split's first batch of 16 cut to 13 points (lambda1 0.5, lambda2 2.0,
the physics intervals of the port's generator seeded 0 handed to JAX).
"""

import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import chip_smoke
from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.evals.evaluate import evaluate_checkpoint as j_evaluate_checkpoint
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.evals import evaluate as teval
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import loop as tloop

torch.set_num_threads(2)

CKPT = str(chip_smoke.ADAPTIVE_CKPT)
DATA = str(chip_smoke.DATA)


@pytest.fixture(scope="module")
def splits():
    jds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tds = tdata.create_data_arrays(DATA, 61, 30, use_native=False)
    return jdata.split_dataset(jds, seed=42), tdata.split_dataset(tds, seed=42)


def _port_meets(splits, solver):
    (_, _, _), (_, tva, tte) = splits
    _, meta = j_load_checkpoint(CKPT)
    kw = dict(solver=solver, mode="while", max_steps_per_interval=chip_smoke.IMPLICIT_STEPS)
    out = teval.evaluate_checkpoint(CKPT, tte, config=thyb.config_from_dict(meta["config"], **kw),
                                    val_ds=tva, device="cpu")
    limit = chip_smoke.BDF_EVAL_RTOL if solver == "bdf" else chip_smoke.REF_RTOL
    for k, v in chip_smoke.REF_IMPLICIT_METRICS[solver].items():
        assert abs(out[k] - v) <= limit * max(abs(v), 1e-12), k


@pytest.mark.parametrize("solver", ["radau", "bdf"])
def test_implicit_evaluation_constants_are_jax_and_the_port_meets_them(splits, solver):
    """Every constant is the JAX package's value to 1e-7; the port on the CPU
    meets radau's to chip_smoke's REF_RTOL (1e-4). bdf's port run is the
    slow test below."""
    (_, jva, jte), _ = splits
    _, meta = j_load_checkpoint(CKPT)
    kw = dict(solver=solver, mode="while", max_steps_per_interval=chip_smoke.IMPLICIT_STEPS)
    ref = j_evaluate_checkpoint(CKPT, jte, config=jhyb.config_from_dict(meta["config"], **kw),
                                val_ds=jva)
    consts = chip_smoke.REF_IMPLICIT_METRICS[solver]
    assert sorted(consts) == sorted(ref)
    for k, v in consts.items():
        assert v == pytest.approx(float(ref[k]), rel=1e-7), k
    if solver == "radau":
        _port_meets(splits, solver)


@pytest.mark.slow
def test_bdf_evaluation_on_the_port_meets_its_limit(splits):
    """The port's bdf evaluation on the CPU meets BDF_EVAL_RTOL (5e-2: bdf
    spends its 12-step budget on every interval in both packages; the port
    reads 4.85e-3 on nll here). About 30 s of eager trial steps."""
    _port_meets(splits, "bdf")


def test_radau_train_step_constants_are_jax_and_the_port_meets_them(splits, monkeypatch):
    """The loss and global gradient norm of phase 4g (c)'s step: the
    constants are JAX's to 1e-7, the port's train step on the CPU meets them
    to 1e-4."""
    (jtr, _, _), (ttr, _, _) = splits
    state, meta = j_load_checkpoint(CKPT)
    batch = chip_smoke.implicit_train_batch(jtr, None)
    idx = thyb.physics_indices(torch.Generator().manual_seed(0),
                               chip_smoke.IMPLICIT_TRAIN_POINTS - 1, 20).numpy()
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(idx[:n]))
    cfg = jhyb.config_from_dict(meta["config"], solver="radau", mode="scan",
                                max_steps_per_interval=chip_smoke.IMPLICIT_STEPS)
    (jl, _), jg = jax.value_and_grad(
        lambda q: jhyb.hybrid_loss(q, jax.tree_util.tree_map(jnp.asarray, batch),
                                   jax.random.PRNGKey(0), cfg, lambda1=chip_smoke.MIMIC_LAMBDA1,
                                   lambda2=chip_smoke.MIMIC_LAMBDA2),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, state["params"]))
    assert float(jl) == pytest.approx(chip_smoke.REF_RADAU_TRAIN_LOSS, rel=1e-7)
    assert float(optax.global_norm(jg)) == pytest.approx(chip_smoke.REF_RADAU_GRAD_NORM, rel=1e-7)

    tstate = tloop.TrainState(tloop._to_params(state["params"], torch.device("cpu")))
    tcfg = thyb.config_from_dict(meta["config"], solver="radau", mode="scan",
                                 max_steps_per_interval=chip_smoke.IMPLICIT_STEPS)
    opt = tloop.make_optimizer(1e-3, 1, 1, chip_smoke.MIMIC_CLIP).bind(tstate.params)
    step = tloop.make_train_step(opt, tcfg, chip_smoke.MIMIC_LAMBDA1, chip_smoke.MIMIC_LAMBDA2,
                                 True)
    _, m = step(tstate, chip_smoke.implicit_train_batch(ttr, torch.device("cpu")),
                torch.Generator().manual_seed(0))
    assert float(m["loss"]) == pytest.approx(chip_smoke.REF_RADAU_TRAIN_LOSS, rel=1e-4)
    assert float(m["grad_norm"]) == pytest.approx(chip_smoke.REF_RADAU_GRAD_NORM, rel=1e-4)
