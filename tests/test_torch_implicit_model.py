"""Port parity for the implicit solvers inside the model, on the CPU
against the JAX package: a small hybrid model (H=16, 2 layers, JAX-initialised
weights) on the data file's windows with radau, bdf and bdf2 (f64
trajectories 1e-7 with equal step counts; f32 RMSE 1e-5), VI's first ELBO
through radau on JAX's replayed draws (1e-5), and the training CLI with
--solver radau. The solver-level cases are in tests/test_torch_implicit.py.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.dynamics.controls import Controls as JControls
from hybrid_ode_tpu.inference import vi as jvi
from hybrid_ode_tpu.models import bayes as jbayes
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.inference import vi as tvi
from hybrid_ode_torch.models import bayes as tbayes
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import cli as tcli
from hybrid_ode_torch.utils.checkpoint import load_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data" / "4gi_dataset.csv")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _stats_equal(tst, jst):
    for field in ("n_accepted", "n_rejected", "success"):
        np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                      np.asarray(getattr(jst, field)), err_msg=field)


# ---------------------------------------------------------------------------

def _small_model(**overrides):
    """JAX-initialised H=16, 2-layer model with a non-zero last layer."""
    cfg = jhyb.HybridConfig(**dict(dict(nn_hidden=16, nn_layers=2, rtol=1e-5, atol=1e-7,
                                        max_steps_per_interval=12), **overrides))
    p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(0), cfg))
    p["nn"]["w2"] = (0.05 * np.random.default_rng(0).normal(size=p["nn"]["w2"].shape)
                     ).astype(np.float32)
    return cfg, thyb.HybridConfig(**dataclasses.asdict(cfg)), p


def _windows(n=4):
    ds = jdata.create_data_arrays(DATA, 13, 12, use_native=False)
    sig = {"meal": ds.meal[:n], "tVNS": ds.tvns[:n]}
    return ds.initial_state[:n], ds.time_points[:n], sig, ds.observations[:n]


@pytest.mark.parametrize("solver,mode,dtype", [("radau", "while", "f64"), ("bdf", "while", "f64"),
                                               ("radau", "scan", "f64"), ("bdf2", "while", "f64"),
                                               ("radau", "while", "f32"), ("bdf", "while", "f32")])
def test_model_on_data_windows_matches_jax(solver, mode, dtype):
    """batched_forward of the small model on the data file's first 4 windows
    (meal and insulin controls): f64 trajectories to 1e-7 with equal step
    counts; f32, the card's dtype: equal step counts, the RMSE against the
    observations to 1e-5 and the trajectories to 1e-4 (bdf reads 3.5e-5:
    each rescaling of its difference array sums its f32 products in another
    order than XLA's)."""
    jcfg, tcfg, p = _small_model(solver=solver, mode=mode)
    y0, ts, sig, obs = _windows()
    with jax.enable_x64(dtype == "f64"):
        if dtype == "f64":
            p, y0, ts, sig = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                                    (p, y0, ts, sig))
        jys, jst = jhyb.batched_forward(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(y0), jnp.asarray(ts),
            JControls(ts=jnp.asarray(ts), signals={k: jnp.asarray(v) for k, v in sig.items()}),
            jcfg, return_stats=True)
    t = torch.as_tensor
    tys, tst = thyb.batched_forward(params_from_numpy(p, "cpu", dtype=t(y0).dtype), t(y0), t(ts),
                                    Controls(ts=t(ts), signals={k: t(v) for k, v in sig.items()}),
                                    tcfg, return_stats=True)
    if dtype == "f64":
        assert _rel(jys, tys.detach()) < 1e-7
        _stats_equal(tst, jst)
    else:
        assert _rel(jys, tys.detach()) < 1e-4
        _stats_equal(tst, jst)
        rm = lambda ys: float(np.sqrt(np.mean((np.asarray(ys) - obs) ** 2)))  # noqa: E731
        assert rm(tys.detach()) == pytest.approx(rm(jys), rel=1e-5)


def test_vi_first_elbo_through_radau_matches_jax():
    """VI's ELBO with the model's solver set to radau (scan): the same
    variational state and JAX's draws replayed, ELBO / KL / log-likelihood
    to 1e-5."""
    jcfg, tcfg, p = _small_model(solver="radau", max_steps_per_interval=6)
    y0, ts, sig, obs = _windows(2)
    ts, obs = ts[:, :5], obs[:, :5]
    batch = {"initial_state": y0, "observations": obs, "time_points": ts,
             "external_inputs": {k: v[:, :5] for k, v in sig.items()},
             "mask": np.ones(ts.shape, np.float32)}
    priors = {"ode_a_GI": {"mean": 0.0104, "std": 0.002}, "k_I": {"mean": 0.025, "std": 0.005}}
    js, jp = jbayes.init_variational(jhyb.params_to_flat(p), priors)
    key, S = jax.random.PRNGKey(3), 2
    _, comps = jvi.elbo(js, jp, p, batch, key, jcfg, S, jnp.asarray(1.0), 0.7)
    names = sorted(js.means)
    eps = {n: [] for n in names}
    for k in jax.random.split(key, S):
        for kk, n in zip(jax.random.split(k, len(names)), names):
            eps[n].append(np.array(jax.random.normal(kk, np.shape(js.means[n]), jnp.float32)))
    ts_state = tbayes.VariationalState(
        means={k: torch.tensor(np.asarray(v)) for k, v in js.means.items()},
        log_stds={k: torch.tensor(np.asarray(v)) for k, v in js.log_stds.items()})
    _, tcomps = tvi.elbo(ts_state, jp, params_from_numpy(p, "cpu"),
                         tdata.batch_to_tensors(batch, "cpu"), None, tcfg, S, 1.0, 0.7,
                         eps={n: np.stack(v) for n, v in eps.items()})
    for k in ("elbo", "kl", "log_likelihood"):
        assert _rel(comps[k], tcomps[k].detach()) < 1e-5, k


def test_cli_trains_with_solver_radau(tmp_path, monkeypatch):
    """`train.cli --solver radau` trains a point model for one epoch on a cut
    config, and its checkpoint reloads with solver 'radau'."""
    import yaml

    cfg = {"data": {"path": DATA, "sequence_length": 7, "stride": 24},
           "model": {"nn_hidden": 8, "nn_layers": 2, "solver": "rk4", "rtol": 1e-4,
                     "atol": 1e-6, "max_steps_per_interval": 4},
           "training": {"epochs": 1, "batch_size": 64, "learning_rate": 1e-3, "lambda1": 0.0,
                        "lambda2": 0.01, "gradient_clip": 5.0, "early_stopping_patience": 5},
           "ablation": {"no_nn": False, "no_bayes": True, "no_physics": True},
           "logging": {"tensorboard": False, "save_interval": 1}, "seed": 0}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    tcli.main(["--config", "tiny.yaml", "--solver", "radau", "--experiment-name", "rad",
               "--device", "cpu"])
    state, meta = load_checkpoint(str(tmp_path / "checkpoints" / "rad" / "final_model"))
    assert meta["config"]["model"]["solver"] == "radau"
    assert all(np.isfinite(v).all() for g in state["params"].values() for v in g.values())
    tcfg = thyb.config_from_dict(meta["config"])
    assert tcfg.solver == "radau"
