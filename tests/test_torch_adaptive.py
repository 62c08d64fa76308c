"""Port parity for the adaptive solvers inside the model, in float32 on the CPU.

Against the JAX package with the same inputs and parameters:
`evaluate_checkpoint` on the dopri5 checkpoint `checkpoints/4gi_baseline_full`
(every metric to 1e-5 relative), `hybrid_loss` on its first train batch
(value and components with `solver_success` to 1e-5, every gradient leaf
to 1e-4),
`batched_forward` in 'sync', 'dense' and 'while' on a small model with meal
and insulin controls (f32 1e-5, f64 1e-7; StepStats equal), the backsolve adjoint through
the model with per-sample controls (f64, 1e-8), the train loop's step-budget
warning,
and the CLI training a point model for `--mcmc` / `--vi` when the config
sets `no_bayes`. chip_smoke.py's phase 4d constants are checked to be the
JAX package's values.
"""

import dataclasses
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.dynamics.controls import Controls as JControls
from hybrid_ode_tpu.evals.evaluate import evaluate_checkpoint as j_evaluate_checkpoint
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.evals import evaluate as teval
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import cli as tcli
from hybrid_ode_torch.train import loop as tloop
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "checkpoints" / "4gi_baseline_full" / "best_model")
DATA = str(ROOT / "data" / "4gi_dataset.csv")


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-8))


@pytest.fixture(scope="module")
def splits():
    jds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tds = tdata.create_data_arrays(DATA, 61, 30, use_native=False)
    return jdata.split_dataset(jds, seed=42), tdata.split_dataset(tds, seed=42)


def test_evaluate_dopri5_checkpoint_matches_jax(splits):
    """The checkpoint's own config (dopri5, scan, 8 steps per interval):
    every metric to 1e-5 relative (atol 1e-6 as the serving test allows for
    nll), and chip_smoke.py's constants are JAX's to 1e-7."""
    (_, jva, jte), (_, tva, tte) = splits
    ref = j_evaluate_checkpoint(CKPT, jte, val_ds=jva)
    out = teval.evaluate_checkpoint(CKPT, tte, val_ds=tva, device="cpu")
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert ref["rmse"] == pytest.approx(1.1807069, rel=1e-6)
    assert sorted(chip_smoke.REF_ADAPTIVE_METRICS) == sorted(ref)
    for k, v in chip_smoke.REF_ADAPTIVE_METRICS.items():
        assert v == pytest.approx(float(ref[k]), rel=1e-7), k


def test_hybrid_loss_first_train_batch_matches_jax(splits, monkeypatch):
    """The first update of train_model from the checkpoint: the seed-42 train
    split's first shuffled batch, the physics intervals the port's seeded
    generator draws first (handed to JAX too). Loss and components to 1e-5
    (solver_success exactly); every gradient leaf to 1e-4 (480 masked f32
    trial steps per window, summed in other orders: nn.b1 comes to 2.2e-5,
    every other leaf below 1e-5); chip_smoke.py's loss and
    gradient-norm constants are JAX's to 1e-7."""
    (jtr, _, _), _ = splits
    state, meta = j_load_checkpoint(CKPT)
    cfg = meta["config"]
    T = jtr.time_points.shape[1]
    idx = thyb.physics_indices(torch.Generator().manual_seed(cfg.get("seed", 0)), T - 1,
                               20).numpy()
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(idx[:n]))
    batch, _ = jdata.pad_batch(next(jdata.batch_iterator(jtr, 32, shuffle=True, seed=0)), 32)
    kw = dict(lambda1=cfg["training"]["lambda1"], lambda2=cfg["training"]["lambda2"])
    (jl, jc), jg = jax.value_and_grad(
        lambda q: jhyb.hybrid_loss(q, jax.tree_util.tree_map(jnp.asarray, batch),
                                   jax.random.PRNGKey(0), jhyb.config_from_dict(cfg), **kw),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, state["params"]))
    assert float(jl) == pytest.approx(chip_smoke.REF_ADAPTIVE_TRAIN_LOSS, rel=1e-7)
    assert float(optax.global_norm(jg)) == pytest.approx(chip_smoke.REF_ADAPTIVE_GRAD_NORM,
                                                         rel=1e-7)

    params = params_from_numpy(state["params"], "cpu")
    for group in params.values():
        for t in group.values():
            t.requires_grad_(True)
    tl, tc = thyb.hybrid_loss(params, tdata.batch_to_tensors(batch, "cpu"),
                              torch.Generator().manual_seed(cfg.get("seed", 0)),
                              thyb.config_from_dict(cfg), **kw)
    tl.backward()
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    for k in ("data", "physics", "reg"):
        assert abs(tc[k].item() - float(jc[k])) <= 1e-5 * abs(float(jc[k])) + 1e-12, k
    assert float(jc["solver_success"]) == 1.0 and tc["solver_success"].item() == 1.0
    for g in jg:
        for name in jg[g]:
            assert _rel_err(jg[g][name], params[g][name].grad.numpy()) < 1e-4, (g, name)


def _small_model(hidden=16, **overrides):
    """JAX-initialised small model (non-zero last layer) and both configs."""
    kw = dict(solver="dopri5", rtol=1e-5, atol=1e-7, nn_hidden=hidden, nn_layers=2,
              max_steps_per_interval=8)
    cfg = jhyb.HybridConfig(**dict(kw, **overrides))
    p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(0), cfg))
    p["nn"]["w2"] = (0.05 * np.random.default_rng(0).normal(size=p["nn"]["w2"].shape)
                     ).astype(np.float32)
    return cfg, thyb.HybridConfig(**dataclasses.asdict(cfg)), p


def _small_batch(B=4, T=13, seed=0):
    """Per-sample clocks; a meal bump and an insulin-rate wave on the grid.
    Smooth signals: across a gridded impulse the f32 controllers of the two
    packages can take other steps (the error norm sits near 1 there)."""
    rng = np.random.default_rng(seed)
    y0 = (0.5 * rng.normal(size=(B, 6))).astype(np.float32)
    ts = (np.linspace(0.0, 3.0, T)[None] + rng.uniform(0.0, 1.0, (B, 1))).astype(np.float32)
    rel = ts - ts[:, :1]
    meal = (2.0 * np.exp(-((rel - 1.0) / 0.6) ** 2)).astype(np.float32)
    tvns = (0.5 + 0.4 * np.sin(rel + rng.uniform(0, 3, (B, 1)))).astype(np.float32)
    return y0, ts, {"meal": meal, "tVNS": tvns}


def _both_forward(jcfg, tcfg, p, y0, ts, sig, **overrides):
    jout = jhyb.batched_forward(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(y0), jnp.asarray(ts),
        JControls(ts=jnp.asarray(ts), signals={k: jnp.asarray(v) for k, v in sig.items()}),
        jcfg, **overrides)
    t = torch.as_tensor
    tout = thyb.batched_forward(params_from_numpy(p, "cpu", dtype=t(y0).dtype), t(y0), t(ts),
                                Controls(ts=t(ts), signals={k: t(v) for k, v in sig.items()}),
                                tcfg, **overrides)
    return jout, tout


def _as_f64(*trees):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), trees)


@pytest.mark.parametrize("mode,dtype", [("sync", "f32"), ("while", "f32"), ("sync", "f64"),
                                        ("dense", "f64"), ("while", "f64")])
def test_batched_forward_adaptive_modes_match_jax(mode, dtype):
    """The model's adaptive modes with meal / insulin controls (sync: the
    shared controller with the controls' kink stops; dense and while: per
    sample), StepStats equal. f32, the card's dtype: trajectories to 1e-5.
    f64: to 1e-7 (dense: a third of the trial steps are rejected on this
    model, each step size set from an error estimate whose last digits
    depend on the summation order). Dense output is held in f64 only: its
    f32 error norms sit near 1 on so many steps that the two packages'
    rounding takes other steps (stats differ; in f64 they are equal)."""
    jcfg, tcfg, p = _small_model(mode=mode)
    y0, ts, sig = _small_batch()
    with jax.enable_x64(dtype == "f64"):
        if dtype == "f64":
            p, y0, ts, sig = _as_f64(p, y0, ts, sig)
        (jys, jst), (tys, tst) = _both_forward(jcfg, tcfg, p, y0, ts, sig, return_stats=True)
    assert tys.shape == (4, 13, 6) and tys.dtype == (torch.float64 if dtype == "f64"
                                                      else torch.float32)
    assert _rel_err(jys, tys.numpy()) < (1e-5 if dtype == "f32" else 1e-7)
    for field in ("n_accepted", "n_rejected", "success"):
        np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                      np.asarray(getattr(jst, field)), err_msg=field)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sync_step_budget_overflow_and_loss_success_match_jax(dtype):
    """One trial step per interval cannot cover the sync span: success is
    False in both packages with equal step counts; in f64 the truncated
    trajectories agree to 1e-10 (in f32 the last accepted steps, sized from
    error norms near 1, differ by rounding and so does how far the span
    got). hybrid_loss reports the same solver_success for the per-sample
    scan mode."""
    jcfg, tcfg, p = _small_model(mode="sync", max_steps_per_interval=1, rtol=1e-7, atol=1e-9)
    y0, ts, sig = _small_batch()
    with jax.enable_x64(dtype == "f64"):
        if dtype == "f64":
            p, y0, ts, sig = _as_f64(p, y0, ts, sig)
        (jys, jst), (tys, tst) = _both_forward(jcfg, tcfg, p, y0, ts, sig, return_stats=True)
        assert not bool(jst.success) and not bool(tst.success)
        assert int(tst.n_accepted) == int(jst.n_accepted)
        if dtype == "f64":
            assert _rel_err(jys, tys.numpy()) < 1e-10

        jcfg, tcfg = (dataclasses.replace(c, mode="scan") for c in (jcfg, tcfg))
        batch = {"initial_state": y0, "observations": np.repeat(y0[:, None], 13, 1),
                 "time_points": ts, "external_inputs": sig}
        _, jc = jhyb.hybrid_loss(jax.tree_util.tree_map(jnp.asarray, p),
                                 jax.tree_util.tree_map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0), jcfg, use_physics_loss=False)
    _, tc = thyb.hybrid_loss(params_from_numpy(p, "cpu", dtype=torch.as_tensor(y0).dtype),
                             tdata.batch_to_tensors(batch, "cpu"), None, tcfg,
                             use_physics_loss=False)
    assert float(jc["solver_success"]) < 1.0
    assert tc["solver_success"].item() == pytest.approx(float(jc["solver_success"]))


def test_backsolve_through_the_model_matches_jax(x64):
    """adjoint='backsolve' with per-sample controls: each window integrates
    its own parameter cotangents (the vmapped JAX custom VJP). In f64, where
    both packages take the same steps: every gradient leaf to 1e-8."""
    jcfg, tcfg, p = _small_model(adjoint="backsolve", rtol=1e-7, atol=1e-9)
    y0, ts, sig = _small_batch(B=3, T=7, seed=1)
    p, y0, ts, sig = _as_f64(p, y0, ts, sig)
    jg = jax.grad(lambda q: jnp.sum(jhyb.batched_forward(
        q, jnp.asarray(y0), jnp.asarray(ts),
        JControls(ts=jnp.asarray(ts), signals={k: jnp.asarray(v) for k, v in sig.items()}),
        jcfg) ** 2))(jax.tree_util.tree_map(jnp.asarray, p))
    params = params_from_numpy(p, "cpu", dtype=torch.float64)
    for group in params.values():
        for t in group.values():
            t.requires_grad_(True)
    t = torch.as_tensor
    ys = thyb.batched_forward(params, t(y0), t(ts),
                              Controls(ts=t(ts), signals={k: t(v) for k, v in sig.items()}),
                              tcfg)
    torch.sum(ys ** 2).backward()
    for g in jg:
        for name in jg[g]:
            assert _rel_err(jg[g][name], params[g][name].grad.numpy()) < 1e-8, (g, name)


def _tiny_cfg(**model):
    return {"data": {"path": DATA, "sequence_length": 13, "stride": 12},
            "model": dict({"nn_hidden": 16, "nn_layers": 2, "solver": "rk4", "substeps": 2},
                          **model),
            "training": {"epochs": 1, "batch_size": 36, "learning_rate": 3e-3,
                         "lambda1": 0.0, "lambda2": 0.01, "gradient_clip": 5.0,
                         "early_stopping_patience": 10},
            "ablation": {"no_nn": False, "no_bayes": False, "no_physics": True},
            "logging": {"tensorboard": False, "save_interval": 1}, "seed": 0}


def test_train_loop_warns_when_the_step_budget_is_exhausted(caplog):
    """max_steps_per_interval=1 cannot reach the interval ends: the epoch's
    minimum solver_success is below 1 and train_model logs the warning."""
    cfg = _tiny_cfg(solver="dopri5", rtol=1e-7, atol=1e-9, max_steps_per_interval=1)
    ds = tdata.create_data_arrays(DATA, 13, 12)
    tr, va, _ = tdata.split_dataset(ds, seed=42)
    with caplog.at_level(logging.WARNING, logger="hybrid_ode_torch.train"):
        res = tloop.train_model(cfg, tr, va, device="cpu")
    assert res.epochs_run == 1 and np.isfinite(res.history["step_loss"]).all()
    assert min(res.history["solver_success"]) < 1.0
    assert any("solver step budget exhausted" in r.getMessage() for r in caplog.records)


def test_cli_trains_a_point_model_for_mcmc_and_vi_when_no_bayes(tmp_path, monkeypatch):
    """As the JAX CLI: the merged config's ablation.no_bayes (here from the
    YAML, not the flag) turns --mcmc / --vi into point-model training."""
    import yaml

    cfg = _tiny_cfg()
    cfg["ablation"]["no_bayes"] = True
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    for flag in ("--mcmc", "--vi"):
        name = f"run{flag.strip('-')}"
        tcli.main(["--config", "tiny.yaml", flag, "--experiment-name", name, "--device", "cpu"])
        assert (tmp_path / "checkpoints" / name / "final_model" / "leaves.npz").exists()
