"""Port parity: variational inference (`hybrid_ode_torch/models/bayes.py`,
`inference/vi.py`), `forward_with_params`, the CLI's `--vi` and the VI
branch of evaluation.

Small cases: the JAX suite's FAST model (rk4, 2 substeps, H=8, 2 layers) and
a numpy-seeded version of its `_tiny_batch`, from JAX-initialised params
(output layer perturbed so that the residual acts). The standard normal
draws of the JAX package's key schedule are replayed into the port (`eps`).

Tolerances (relative to the largest value): the primitives (selection,
initial state, samples, KL) 1e-6 in f32; `elbo` and its gradients 1e-5; one
VI train step's new state and log_noise 1e-5; forwards and the posterior
predictive mean 1e-5, its std 1e-6 of the predictions' scale (a spread is a
difference of trajectories). Checkpoints cross-load both ways; evaluation's VI branch
equals the JAX package's where the posterior is a point (log_stds -30, so
both packages' draws give the same predictions): every metric to 1e-5, the
counts (ECE, coverage) to one point. chip_smoke.py's phase 4f (f)
constants are recomputed here.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.evals import evaluate as jeval
from hybrid_ode_tpu.inference import vi as jvi
from hybrid_ode_tpu.models import bayes as jbayes
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.evals import evaluate as teval
from hybrid_ode_torch.inference import vi as tvi
from hybrid_ode_torch.models import bayes as tbayes
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import cli as tcli
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "4gi_dataset.csv")
FAST = jhyb.HybridConfig(solver="rk4", substeps=2, nn_hidden=8, nn_layers=2, mode="scan")
PRIORS = {"ode_a_GI": {"mean": 0.0104, "std": 0.002}, "k_I": {"mean": 0.025, "std": 0.005},
          "V_max": {"mean": 9.0, "std": 2.0}}
SIGMA6 = np.array([0.5, 3.0, 2.0, 1.0, 0.3, 0.2], np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _spread_err(preds, std):
    """The predictive std against numpy's, relative to the predictions'
    scale: the spread is a difference of trajectories of size ~100 (insulin)."""
    return float(np.abs(preds.std(0) - np.asarray(std)).max() / np.abs(preds).max())


def _tcfg(cfg):
    return thyb.HybridConfig(**dataclasses.asdict(cfg))


def _params(seed=0, cfg=FAST):
    p = jax.tree_util.tree_map(np.array, jhyb.init_hybrid_params(jax.random.PRNGKey(seed), cfg))
    last = f"w{cfg.nn_layers}"
    p["nn"][last] = (0.05 * np.random.default_rng(seed).normal(
        size=p["nn"][last].shape)).astype(np.float32)
    return p


def _tiny_batch(seed=2, B=4, T=8):
    """The JAX suite's `_tiny_batch` with numpy draws, noisy observations
    and a mask."""
    rng = np.random.default_rng(seed)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2], np.float32)
    y0 = np.abs(base * (1 + 0.05 * rng.normal(size=(B, 6)))).astype(np.float32)
    obs = (base * (1 + 0.02 * rng.normal(size=(B, T, 6)))).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 3:5] = 0.0
    return {"initial_state": y0, "observations": obs,
            "time_points": np.broadcast_to(np.linspace(0.0, 1.0, T, dtype=np.float32),
                                           (B, T)).copy(),
            "external_inputs": {"meal": np.where(rng.uniform(size=(B, T)) > 0.7, 1.0, 0.0)
                                .astype(np.float32), "tVNS": np.zeros((B, T), np.float32)},
            "mask": mask}


def _tb(batch):
    return tdata.batch_to_tensors(batch, "cpu")


def _jax_eps(key, means, n_samples=None):
    """The standard normal draws of JAX's `sample_variational` (one key per
    sorted leaf), for one sample or for the n_samples of `elbo`'s key split."""
    names = sorted(means)

    def one(k):
        ks = jax.random.split(k, len(names))
        return {n: np.array(jax.random.normal(kk, np.shape(means[n]), jnp.float32))
                for kk, n in zip(ks, names)}

    if n_samples is None:
        return one(key)
    draws = [one(k) for k in jax.random.split(key, n_samples)]
    return {n: np.stack([d[n] for d in draws]) for n in names}


def _port_state(jstate):
    return tbayes.VariationalState(
        means={k: torch.tensor(np.asarray(v)) for k, v in jstate.means.items()},
        log_stds={k: torch.tensor(np.asarray(v)) for k, v in jstate.log_stds.items()})


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include_nn", [False, True, "last"])
def test_selection_and_initial_state_match_jax(include_nn):
    p = _params()
    jflat = jhyb.params_to_flat(p)
    tflat = thyb.params_to_flat(params_from_numpy(p, "cpu"))
    assert sorted(jbayes.select_bayes_params(jflat, include_nn)) == sorted(
        tbayes.select_bayes_params(tflat, include_nn))
    js, jp = jbayes.init_variational(jflat, PRIORS, include_nn=include_nn)
    ts, tp = tbayes.init_variational(tflat, PRIORS, include_nn=include_nn)
    assert jp == tp
    assert tp["ode_a_GI"] == (0.0104, 0.002) and tp["ode_k_I"] == (0.025, 0.005)
    for name in js.means:
        assert _rel(js.means[name], ts.means[name]) < 1e-6, name
        assert _rel(js.log_stds[name], ts.log_stds[name]) < 1e-6, name
    # the port's state is a copy: updating it leaves the params alone
    ts.means["ode_a_GI"].add_(1.0)
    assert float(tflat["ode_a_GI"]) == pytest.approx(float(jflat["ode_a_GI"]))


@pytest.mark.parametrize("include_nn", [False, "last"])
def test_samples_kl_and_flattening_match_jax_with_replayed_draws(include_nn):
    p = _params()
    js, jp = jbayes.init_variational(jhyb.params_to_flat(p), PRIORS, include_nn=include_nn)
    # move the state off its initial point so that every term of the KL acts
    rng = np.random.default_rng(1)
    js = jbayes.VariationalState(
        means={k: np.asarray(v) * (1 + 0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
               for k, v in js.means.items()},
        log_stds={k: np.asarray(v) + (0.3 * rng.normal(size=np.shape(v))).astype(np.float32)
                  for k, v in js.log_stds.items()})
    ts = _port_state(js)
    key = jax.random.PRNGKey(7)
    ref = jbayes.sample_variational(js, key)
    got = tbayes.sample_variational(ts, eps=_jax_eps(key, js.means))
    assert sorted(ref) == sorted(got)
    for name in ref:
        assert _rel(ref[name], got[name]) < 1e-6, name
    assert _rel(jbayes.kl_divergence(js, jp), tbayes.kl_divergence(ts, jp)) < 1e-6
    for a, b in zip(jbayes.flatten_variational(js), tbayes.flatten_variational(ts)):
        assert _rel(a, b) < 1e-6
    # from a generator: n samples at once, reproducible per seed
    g1 = tbayes.sample_variational(ts, torch.Generator().manual_seed(3), n_samples=4)
    g2 = tbayes.sample_variational(ts, torch.Generator().manual_seed(3), n_samples=4)
    for name in g1:
        assert g1[name].shape == (4,) + tuple(ts.means[name].shape)
        assert torch.equal(g1[name], g2[name])


def test_forward_with_params_matches_jax():
    p = _params()
    batch = _tiny_batch()
    flat = {"ode_V_max": np.float32(7.5), "nn_b2": np.full(6, 0.01, np.float32)}
    ctrl = jhyb.controls_from_batch(batch)
    ref = jhyb.forward_with_params(flat, p, batch["initial_state"], batch["time_points"],
                                   ctrl, FAST)
    tb = _tb(batch)
    tflat = {k: torch.as_tensor(v) for k, v in flat.items()}
    tp = params_from_numpy(p, "cpu")
    got = thyb.forward_with_params(tflat, tp, tb["initial_state"], tb["time_points"],
                                   thyb.controls_from_batch(tb), _tcfg(FAST))
    assert _rel(ref, got) < 1e-5
    one = thyb.forward_with_params(tflat, tp, tb["initial_state"][0], tb["time_points"][0],
                                   None, _tcfg(FAST))
    ref1 = jhyb.forward_with_params(flat, p, batch["initial_state"][0],
                                    batch["time_points"][0], None, FAST)
    assert _rel(ref1, one) < 1e-5


def test_posterior_predictive_matches_jax_per_sample():
    """The samples on the member axis in one solve, and one fused call per
    sample, each equal JAX's forward of each sample (mean, population std)."""
    p = _params()
    batch = _tiny_batch()
    tb = _tb(batch)
    vi = tvi.VariationalInference(params_from_numpy(p, "cpu"), _tcfg(FAST), PRIORS,
                                  include_nn="last")
    with torch.no_grad():
        for v in vi.vstate.log_stds.values():
            v.add_(1.0)  # a spread worth measuring
    ctrl = thyb.controls_from_batch(tb)
    samples = vi.sample_posterior(torch.Generator().manual_seed(5), 6)
    preds = np.stack([np.asarray(jhyb.forward_with_params(
        {k: v[s].numpy() for k, v in samples.items()}, p, batch["initial_state"],
        batch["time_points"], jhyb.controls_from_batch(batch), FAST)) for s in range(6)])
    for use_pallas in (False, True):
        vi.config = dataclasses.replace(vi.config, use_pallas=use_pallas)
        mean, std = vi.posterior_predictive(torch.Generator().manual_seed(5),
                                            tb["initial_state"], tb["time_points"], ctrl, 6)
        assert _rel(preds.mean(0), mean) < 1e-5, use_pallas
        assert _spread_err(preds, std) < 1e-6, use_pallas
    # bayes.posterior_predictive on the same draws
    vi.config = _tcfg(FAST)
    mean_b, std_b = tbayes.posterior_predictive(
        vi.vstate, torch.Generator().manual_seed(5),
        lambda s: tbayes.forward_samples(s, vi.template, tb["initial_state"],
                                         tb["time_points"], ctrl, vi.config), 6)
    assert _rel(preds.mean(0), mean_b) < 1e-5 and _spread_err(preds, std_b) < 1e-6


# ---------------------------------------------------------------------------
# the ELBO and one VI step
# ---------------------------------------------------------------------------

ELBO_CASES = [("ode", False, 1.0, False), ("last", "last", SIGMA6, False),
              ("fused", False, 0.7, True)]


@pytest.mark.parametrize("name,include_nn,sigma,use_pallas", ELBO_CASES,
                         ids=[c[0] for c in ELBO_CASES])
def test_elbo_and_gradients_match_jax(name, include_nn, sigma, use_pallas):
    p = _params()
    batch = _tiny_batch()
    cfg = dataclasses.replace(FAST, use_pallas=use_pallas)
    js, priors = jbayes.init_variational(jhyb.params_to_flat(p), PRIORS, include_nn=include_nn)
    key, S = jax.random.PRNGKey(3), 3

    (_, comps), jgrad = jax.value_and_grad(
        lambda st: jvi.elbo(st, priors, p, batch, key, cfg, S, jnp.asarray(sigma), 0.7),
        has_aux=True)(js)
    ts = _port_state(js)
    leaves = [*ts.means.values(), *ts.log_stds.values()]
    for x in leaves:
        x.requires_grad_(True)
    tvalue, tcomps = tvi.elbo(ts, priors, params_from_numpy(p, "cpu"), _tb(batch), None,
                              _tcfg(cfg), S, sigma, 0.7, eps=_jax_eps(key, js.means, S))
    for k in ("elbo", "kl", "log_likelihood"):
        assert _rel(comps[k], tcomps[k].detach()) < 1e-5, k
    tvalue.backward()
    for group, jg in (("means", jgrad.means), ("log_stds", jgrad.log_stds)):
        for leaf, g in jg.items():
            assert _rel(g, getattr(ts, group)[leaf].grad) < 1e-5, (group, leaf)


@pytest.mark.parametrize("learn_noise", [False, True, "per_state"])
def test_vi_train_step_matches_jax(learn_noise):
    """Two updates (clip over (vstate, log_noise), Adam on each): the metrics,
    the new state and log_noise to 1e-5."""
    p = _params()
    batch = _tiny_batch()
    kw = dict(prior_params=PRIORS, learning_rate=3e-3, n_samples=3, noise_sigma=0.8,
              include_nn="last", learn_noise=learn_noise)
    j = jvi.VariationalInference(p, FAST, **kw)
    t = tvi.VariationalInference(params_from_numpy(p, "cpu"), _tcfg(FAST), **kw)
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        jm = j.train_step(batch, key, kl_scale=0.5)
        tm = t.train_step(batch, kl_scale=0.5, eps=_jax_eps(key, j.vstate.means, 3))
        for k in jm:
            assert _rel(jm[k], tm[k]) < 1e-5, (step, k)
    for group in ("means", "log_stds"):
        for leaf, v in getattr(j.vstate, group).items():
            assert _rel(v, getattr(t.vstate, group)[leaf]) < 1e-5, (group, leaf)
    assert _rel(j.log_noise, t.log_noise) < 1e-5
    np.testing.assert_allclose(t.noise_sigma, j.noise_sigma, rtol=1e-5)


def test_vi_train_improves_and_keeps_the_best_state(monkeypatch):
    p = _params()
    batch = _tiny_batch(B=8)
    ds = tdata.GlucoseDataset(
        initial_state=batch["initial_state"], observations=batch["observations"],
        time_points=batch["time_points"], meal=batch["external_inputs"]["meal"],
        tvns=batch["external_inputs"]["tVNS"], mask=batch["mask"],
        state_mean=np.zeros(6, np.float32), state_std=np.ones(6, np.float32),
        subject_ids=np.arange(8))
    vi = tvi.VariationalInference(params_from_numpy(p, "cpu"), _tcfg(FAST), n_samples=2,
                                  learning_rate=1e-2)
    hist = vi.train(ds, None, epochs=5, batch_size=8, seed=0)
    assert len(hist["elbo"]) == 5 and hist["elbo"][-1] > hist["elbo"][0]
    mean, std = vi.posterior_predictive(torch.Generator().manual_seed(9),
                                        torch.as_tensor(ds.initial_state),
                                        torch.as_tensor(ds.time_points), None, n_samples=4)
    assert mean.shape == std.shape == (8, 8, 6) and torch.isfinite(mean).all()

    # validation ELBO falling every epoch: the state after the first epoch
    # (one step) is kept, not an alias of the live, updated one
    vi = tvi.VariationalInference(params_from_numpy(p, "cpu"), _tcfg(FAST), n_samples=2,
                                  learning_rate=1e-2)
    after_first, calls = [], []
    step = vi.train_step

    def spy(*a, **k):
        out = step(*a, **k)
        if not after_first:
            after_first.append([x.clone() for x in vi._leaves()])
        return out

    monkeypatch.setattr(vi, "train_step", spy)
    monkeypatch.setattr(vi, "evaluate_elbo", lambda b, g: (
        calls.append(1) or torch.tensor(-float(len(calls))), {}))
    vi.train(ds, ds, epochs=3, batch_size=8, early_stopping_patience=10, seed=0)
    final = vi._leaves()
    assert all(torch.equal(a, b) for a, b in zip(after_first[0], final))
    assert vi._adam.count == 3  # the optimizer went on; only the kept state reverted


def test_vi_checkpoints_cross_load_both_ways(tmp_path):
    p = _params()
    batch = _tiny_batch()
    kw = dict(prior_params=PRIORS, n_samples=2, include_nn="last", learn_noise="per_state")
    t = tvi.VariationalInference(params_from_numpy(p, "cpu"), _tcfg(FAST), **kw)
    t.train_step(batch, torch.Generator().manual_seed(0))
    t.save_checkpoint(str(tmp_path / "port"))
    # the JAX package restores the port's checkpoint (a fresh optax state)
    j = jvi.VariationalInference.restore(str(tmp_path / "port"))
    for leaf, v in t.vstate.means.items():
        np.testing.assert_array_equal(np.asarray(j.vstate.means[leaf]), v.numpy())
        np.testing.assert_array_equal(np.asarray(j.vstate.log_stds[leaf]),
                                      t.vstate.log_stds[leaf].numpy())
    np.testing.assert_allclose(j.noise_sigma, t.noise_sigma, rtol=1e-7)
    assert j.learn_noise == "per_state" and j.priors == t.priors
    assert all(int(np.asarray(c)) == 0 for c in jax.tree_util.tree_leaves(j.opt_state)
               if np.ndim(c) == 0 and np.asarray(c).dtype.kind == "i")
    j.train_step(batch, jax.random.PRNGKey(1))
    j.save_checkpoint(str(tmp_path / "jax"))
    # the port restores JAX's (optax state of another layout: a fresh one)
    r = tvi.VariationalInference.restore(str(tmp_path / "jax"), device="cpu")
    for leaf, v in j.vstate.means.items():
        np.testing.assert_array_equal(r.vstate.means[leaf].numpy(), np.asarray(v))
    assert r.config == _tcfg(FAST) and r.learn_noise == "per_state"
    assert r._adam.count == 0 and all(float(m.abs().sum()) == 0 for m in r._adam.mu)
    # within the port the optimizer state resumes
    r2 = tvi.VariationalInference.restore(str(tmp_path / "port"), device="cpu")
    assert r2._adam.count == 1
    for a, b in zip(r2._adam.nu + r2._noise_adam.nu, t._adam.nu + t._noise_adam.nu):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(r2.noise_sigma, t.noise_sigma)


# ---------------------------------------------------------------------------
# evaluation and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def splits():
    jds = jdata.create_data_arrays(DATA, 13, 12, use_native=False)
    tds = tdata.create_data_arrays(DATA, 13, 12, use_native=False)
    return jdata.split_dataset(jds, seed=42), tdata.split_dataset(tds, seed=42)


def test_evaluate_model_vi_branch_matches_jax(splits, tmp_path):
    """With log_stds at -30 every draw is the mean in both packages: every
    metric to 1e-5. With a spread: finite, repeatable under one generator
    seed, and the same after save -> restore."""
    (_, _, jte), (_, _, tte) = splits
    p = _params()
    cfg = FAST
    j = jvi.VariationalInference(p, cfg, PRIORS, include_nn="last")
    j.vstate = jbayes.VariationalState(j.vstate.means, {k: jnp.full_like(v, -30.0)
                                                        for k, v in j.vstate.log_stds.items()})
    t = tvi.VariationalInference(params_from_numpy(p, "cpu"), _tcfg(cfg), PRIORS,
                                 include_nn="last")
    with torch.no_grad():
        for v in t.vstate.log_stds.values():
            v.fill_(-30.0)
    sigma = SIGMA6 / 10
    ref = jeval.evaluate_model(p, jte, cfg, batch_size=4, variational=j, n_posterior_samples=3,
                               obs_sigma=sigma)
    got = teval.evaluate_model(t.template, tte, t.config, batch_size=4, variational=t,
                               n_posterior_samples=3, obs_sigma=sigma)
    assert sorted(ref) == sorted(got) and "ece" in got
    n_points = float(tte.mask.sum()) * 6
    for k in ref:
        # a count (ECE, coverage) moves by one point where a residual sits on
        # an interval's edge within the packages' f32 rounding
        limit = 1.0 / n_points if k == "ece" or k.startswith("coverage") else 1e-5
        assert abs(got[k] - ref[k]) <= limit * max(abs(ref[k]), 1.0), (k, ref[k], got[k])

    with torch.no_grad():
        for v in t.vstate.log_stds.values():
            v.fill_(-2.0)
    a = teval.evaluate_model(t.template, tte, t.config, batch_size=4, variational=t,
                             n_posterior_samples=5, obs_sigma=0.1,
                             generator=torch.Generator().manual_seed(4))
    t.save_checkpoint(str(tmp_path / "vi"))
    r = tvi.VariationalInference.restore(str(tmp_path / "vi"), device="cpu")
    b = teval.evaluate_model(r.template, tte, r.config, batch_size=4, variational=r,
                             n_posterior_samples=5, obs_sigma=0.1,
                             generator=torch.Generator().manual_seed(4))
    assert all(np.isfinite(v) for v in a.values()) and a == b
    assert a["sharpness"] > got["sharpness"]


def _tiny_cfg():
    return {"data": {"path": DATA, "sequence_length": 13, "stride": 12},
            "model": {"nn_hidden": 8, "nn_layers": 2, "solver": "rk4", "substeps": 2},
            "training": {"epochs": 1, "batch_size": 36, "learning_rate": 3e-3,
                         "lambda1": 0.0, "lambda2": 0.01, "gradient_clip": 5.0,
                         "early_stopping_patience": 10},
            "ode_param_priors": {"a_GI": {"mean": 0.0104, "std": 0.002}},
            "vi_settings": {"n_samples": 2, "noise_sigma": 0.35, "include_nn": "last"},
            "ablation": {"no_nn": False, "no_bayes": False, "no_physics": True},
            "logging": {"tensorboard": False, "save_interval": 1}, "seed": 0}


def test_cli_vi_and_evaluate_vi_checkpoint(tmp_path, monkeypatch, capsys):
    """`--vi` trains and writes vi_model, which the JAX package restores and
    `evaluate --vi-checkpoint` scores."""
    monkeypatch.chdir(tmp_path)
    tcli.main(["--vi", "--experiment-name", "vi", "--device", "cpu"], config=_tiny_cfg())
    path = tmp_path / "checkpoints" / "vi" / "vi_model"
    assert (tmp_path / "checkpoints" / "vi" / "best_model" / "leaves.npz").exists()
    j = jvi.VariationalInference.restore(str(path))
    t = tvi.VariationalInference.restore(str(path), device="cpu")
    assert sorted(j.vstate.means) == sorted(t.vstate.means)
    assert "nn_w2" in t.vstate.means and len(t.history["elbo"]) == 1
    for leaf, v in t.vstate.means.items():
        np.testing.assert_array_equal(np.asarray(j.vstate.means[leaf]), v.numpy())
    out = tmp_path / "eval.csv"
    teval.main(["-", "--data", DATA, "--sequence-length", "13", "--stride", "12",
                "--vi-checkpoint", str(path), "--posterior-samples", "4", "--output", str(out),
                "--device", "cpu"])
    assert "RMSE:" in capsys.readouterr().out
    header = out.read_text().splitlines()[0].split(",")
    assert "ece" in header and "coverage_90" in header


# ---------------------------------------------------------------------------
# chip_smoke.py phase 4f (f)
# ---------------------------------------------------------------------------

def test_chip_smoke_vi_draws_and_constants_are_the_jax_package_values():
    """The recipe's first VI step on the JAX CPU: `configs/4gi_vi.yaml`'s
    settings and priors, the template `checkpoints/4gi_baseline_full`, the
    seed-42 train split's first batch; the draws of the step's key."""
    import yaml

    recipe = yaml.safe_load((ROOT / "configs" / "4gi_vi.yaml").read_text())
    assert chip_smoke.VI_PRIORS == recipe["ode_param_priors"]
    for k, v in chip_smoke.VI_SETTINGS.items():
        assert recipe["vi_settings"][k] == v
    assert chip_smoke.VI_LR == recipe["training"]["learning_rate"]
    assert chip_smoke.VI_BATCH == recipe["training"]["batch_size"]
    state, meta = j_load_checkpoint(str(chip_smoke.VI_CKPT))
    cfg = jhyb.config_from_dict(meta["config"])
    assert (cfg.solver, cfg.nn_hidden, cfg.max_steps_per_interval) == (
        recipe["model"]["solver"], recipe["model"]["nn_hidden"],
        recipe["model"]["max_steps_per_interval"])
    ds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tr, _, _ = jdata.split_dataset(ds, seed=42)
    batch, _ = jdata.pad_batch(next(jdata.batch_iterator(tr, chip_smoke.VI_BATCH, shuffle=True,
                                                         seed=0)), chip_smoke.VI_BATCH)
    vi = jvi.VariationalInference(state["params"], cfg, prior_params=recipe["ode_param_priors"],
                                  learning_rate=chip_smoke.VI_LR,
                                  **{k: v for k, v in chip_smoke.VI_SETTINGS.items()})
    key = jax.random.split(jax.random.PRNGKey(0))[1]  # the first step's key of train(seed=0)
    eps = _jax_eps(key, vi.vstate.means, chip_smoke.VI_SETTINGS["n_samples"])
    assert sorted(eps) == sorted(chip_smoke.VI_EPS)
    for k, v in eps.items():
        np.testing.assert_array_equal(np.float32(chip_smoke.VI_EPS[k]), v)
    m = vi.train_step(batch, key)
    np.testing.assert_allclose(m["elbo"], chip_smoke.REF_VI_ELBO, rtol=1e-7)
    np.testing.assert_allclose(m["kl"], chip_smoke.REF_VI_KL, rtol=1e-7)
    np.testing.assert_allclose(m["log_likelihood"], chip_smoke.REF_VI_LOGLIK, rtol=1e-7)
