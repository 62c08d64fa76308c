"""Port parity for the training path as a whole: loss -> optimizer -> loop.

Against the JAX package on the CPU, with the same inputs and parameters:
`hybrid_loss` value and gradients (scan and fused paths, context and masks,
the same physics intervals handed to both), `make_optimizer` against optax
over 5 updates, and 3 steps of `train_model` from JAX-initialised params,
each to 1e-5 relative. Also: checkpoints cross-load both ways, the
optimizer state resumes within the port, the CLI trains on the CPU, and
chip_smoke.py's first-step reference constants are the JAX package's.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.train import loop as jloop
from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import cli as tcli
from hybrid_ode_torch.train import loop as tloop
from hybrid_ode_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "checkpoints" / "accuracy_benchmark" / "best_model")
DATA = str(ROOT / "data" / "4gi_dataset.csv")


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(cfg, seed=0):
    """JAX-initialised params with a non-zero last layer, as numpy."""
    p = _np(jhyb.init_hybrid_params(jax.random.PRNGKey(seed), cfg))
    last = f"w{cfg.nn_layers}"
    p["nn"][last] = (0.05 * np.random.default_rng(seed).normal(
        size=p["nn"][last].shape)).astype(np.float32)
    return p


def _batch(B=4, T=9, masks="mask", seed=0):
    rng = np.random.default_rng(seed)
    obs = (rng.normal(size=(B, T, 6)) * 0.5).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.05, 0.2, (B, T)), 1).astype(np.float32)
    b = {"initial_state": obs[:, 0], "observations": obs, "time_points": ts,
         "external_inputs": {"meal": np.where(rng.uniform(size=(B, T)) > 0.6, 1.0, 0.0)
                             .astype(np.float32),
                             "tVNS": rng.uniform(0, 1, (B, T)).astype(np.float32)},
         "loss_weights": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    if masks == "mask":
        b["mask"] = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    elif masks == "channels":
        b["mask"] = np.ones((B, T), np.float32)
        b["mask_channels"] = (rng.uniform(size=(B, T, 6)) > 0.3).astype(np.float32)
    return b


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("context,masks", [("features", "mask"), ("params", "channels"),
                                           ("none", "none")])
def test_hybrid_loss_matches_jax(context, masks, use_pallas, monkeypatch):
    cfg = jhyb.HybridConfig(solver="rk4", substeps=2, nn_hidden=16, nn_layers=2,
                            context_points=3 if context != "none" else 0, context_dim=4,
                            context_mode=context if context != "none" else "features",
                            n_physics_points=5, use_pallas=use_pallas)
    p = _jax_params(cfg)
    batch = _batch(masks=masks)
    T = batch["time_points"].shape[1]
    idx = np.random.default_rng(1).permutation(T - 1)
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(idx[:n]))
    monkeypatch.setattr(thyb, "physics_indices", lambda gen, n, k: torch.as_tensor(idx[:n][:k]))
    kw = dict(lambda1=0.7, lambda2=0.01)

    (jl, jc), jg = jax.value_and_grad(
        lambda q: jhyb.hybrid_loss(q, jax.tree_util.tree_map(jnp.asarray, batch),
                                   jax.random.PRNGKey(0), cfg, **kw), has_aux=True)(p)
    params = params_from_numpy(p, "cpu")
    for group in params.values():
        for t in group.values():
            t.requires_grad_(True)
    tl, tc = thyb.hybrid_loss(params, tdata.batch_to_tensors(batch, "cpu"), None,
                              thyb.HybridConfig(**dataclasses.asdict(cfg)), **kw)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("data", "physics", "reg"):
        assert abs(tc[k].item() - float(jc[k])) <= 1e-5 * abs(float(jc[k])) + 1e-12, k
    for g in p:
        for name in p[g]:
            assert _rel_err(jg[g][name], params[g][name].grad.numpy()) < 1e-5, (g, name)


def test_segment_batch_matches_jax():
    batch = _batch(T=9, masks="channels")
    ref = jhyb.segment_batch(jax.tree_util.tree_map(jnp.asarray, batch), 4)
    out = thyb.segment_batch(tdata.batch_to_tensors(batch, "cpu"), 4)
    assert sorted(ref) == sorted(out)
    for k in ("observations", "time_points", "initial_state", "mask", "mask_channels"):
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k].numpy())
    np.testing.assert_array_equal(np.asarray(ref["external_inputs"]["meal"]),
                                  out["external_inputs"]["meal"].numpy())


def test_make_optimizer_matches_optax():
    """5 updates: clip active, selective ode training, a frozen 'norm' group."""
    rng = np.random.default_rng(0)
    p = {"ode": {"V_max": np.float32(1.5), "k_L": np.float32(0.3), "G_b": np.float32(5.0)},
         "nn": {"w0": rng.normal(size=(3, 4)).astype(np.float32),
                "b0": rng.normal(size=4).astype(np.float32)},
         "norm": {"mean": rng.normal(size=6).astype(np.float32)}}
    kw = dict(learning_rate=1e-2, epochs=2, steps_per_epoch=3, gradient_clip=0.5,
              train_ode_params=["V_max", "k_L"])
    tx = jloop.make_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = tx.init(jp)
    tp = tloop._to_params(p, torch.device("cpu"))
    opt = tloop.make_optimizer(**kw).bind(tp)
    for step in range(5):
        g = jax.tree_util.tree_map(lambda x: (rng.normal(size=np.shape(x)) * (step + 1))
                                   .astype(np.float32), p)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for grp in tp:
            for name, t in tp[grp].items():
                t.grad = torch.as_tensor(g[grp][name]).reshape(t.shape).clone()
        opt.step()
        for grp in p:
            for name in p[grp]:
                np.testing.assert_allclose(tp[grp][name].detach().numpy(), np.asarray(jp[grp][name]),
                                           rtol=1e-5, atol=1e-7, err_msg=f"{step} {grp} {name}")
    np.testing.assert_array_equal(tp["norm"]["mean"].detach().numpy(), p["norm"]["mean"])
    assert tp["ode"]["G_b"].item() == float(p["ode"]["G_b"])
    tree = opt.state_tree()
    assert int(tree["count"]) == 5 and sorted(tree["mu"]) == ["nn", "ode"]
    assert sorted(tree["mu"]["ode"]) == ["V_max", "k_L"]


def _small_cfg():
    return {"data": {"path": DATA, "sequence_length": 13, "stride": 12},
           "model": {"nn_hidden": 16, "nn_layers": 2, "solver": "rk4", "substeps": 2,
                     "context_points": 3, "context_dim": 4, "use_pallas": True},
           "training": {"epochs": 3, "batch_size": 36, "learning_rate": 3e-3, "lambda1": 0.0,
                        "lambda2": 0.01, "gradient_clip": 5.0, "train_ode_params": True,
                        "early_stopping_patience": 10},
           "ablation": {"no_nn": False, "no_bayes": False, "no_physics": False},
           "logging": {"tensorboard": False, "save_interval": 10}, "seed": 0}


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """3 steps of JAX train_model and the port's from the same params."""
    cfg = _small_cfg()
    jds = jdata.create_data_arrays(DATA, 13, 12, use_native=False)
    tds = tdata.create_data_arrays(DATA, 13, 12, use_native=False)
    (jtr, jva, _), (ttr, tva, _) = jdata.split_dataset(jds, seed=42), tdata.split_dataset(tds, seed=42)
    assert len(ttr) <= 36  # one step per epoch
    p = _jax_params(jhyb.config_from_dict(cfg))
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    jres = jloop.train_model(cfg, jtr, jva, str(jdir), None,
                             params=jax.tree_util.tree_map(jnp.asarray, p))
    tres = tloop.train_model(cfg, ttr, tva, str(tdir), str(tdir / "logs"), params=p, device="cpu")
    return cfg, jres, tres, jdir, tdir, (ttr, tva)


def test_train_model_loss_curve_matches_jax(small_run):
    _, jres, tres, _, tdir, _ = small_run
    assert tres.epochs_run == jres.epochs_run == 3
    assert len(tres.history["step_loss"]) == 3
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(tres.history[key], jres.history[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tres.best_val_loss, jres.best_val_loss, rtol=1e-5)
    assert (tdir / "logs" / "metrics.jsonl").read_text().count("\n") == 3


def test_checkpoints_cross_load_both_ways(small_run):
    _, jres, tres, jdir, tdir, _ = small_run
    # port-written -> JAX reader
    jstate, jmeta = j_load_checkpoint(str(tdir / "best_model"))
    for g in tres.params:
        for name, t in tres.params[g].items():
            np.testing.assert_array_equal(np.asarray(jstate["params"][g][name]), t.numpy())
    assert jmeta["epoch"] == int(np.argmin(tres.history["val_loss"]))
    assert jmeta["config"]["model"]["nn_hidden"] == 16
    # JAX-written -> port reader
    state, meta = load_checkpoint(str(jdir / "best_model"))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jres.params),
                            jax.tree_util.tree_leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    assert meta == j_load_checkpoint(str(jdir / "best_model"))[1]


def test_resume_continues_the_optimizer(small_run, tmp_path):
    cfg, _, tres, _, tdir, (ttr, tva) = small_run
    saved, meta = load_checkpoint(str(tdir / "final_model"))
    assert meta["epoch"] == 2 and int(saved["opt_state"]["count"]) == 3
    res = tloop.train_model(cfg, ttr, tva, str(tmp_path), None, max_epochs=4,
                            resume_from=str(tdir / "final_model"), device="cpu")
    assert res.epochs_run == 4 and len(res.history["step_loss"]) == 1
    after, _ = load_checkpoint(str(tmp_path / "final_model"))
    assert int(after["opt_state"]["count"]) == 4
    # the resumed step used the saved moments: mu moved from the saved value
    assert not np.allclose(after["opt_state"]["mu"]["nn"]["w0"], saved["opt_state"]["mu"]["nn"]["w0"])
    # a JAX checkpoint's optax state does not resume in the port
    with pytest.raises(ValueError, match="not ported"):
        tloop.train_model(cfg, ttr, tva, None, None, max_epochs=1, resume_from=CKPT, device="cpu")


def test_save_checkpoint_spec_matches_jax(tmp_path):
    from hybrid_ode_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint

    tree = {"b": (np.arange(3.0, dtype=np.float32), [np.ones(2, np.float32), None]),
            "a": {"z": np.float32(2.0), "y": np.zeros((2, 2), np.float32)}}
    j_save_checkpoint(str(tmp_path / "j"), tree, {"epoch": 1})
    save_checkpoint(str(tmp_path / "t"), jax.tree_util.tree_map(torch.as_tensor, tree), {"epoch": 1})
    import json
    js = json.loads((tmp_path / "j" / "structure.json").read_text())
    ts = json.loads((tmp_path / "t" / "structure.json").read_text())
    assert js["spec"] == ts["spec"] and js["metadata"] == ts["metadata"]
    assert js["n_leaves"] == ts["n_leaves"]


def test_cli_trains_on_cpu(tmp_path, monkeypatch):
    import yaml

    cfg = _small_cfg()
    cfg["training"]["epochs"] = 1
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    tcli.main(["--config", "tiny.yaml", "--experiment-name", "tiny", "--device", "cpu"])
    assert (tmp_path / "checkpoints" / "tiny" / "final_model" / "leaves.npz").exists()
    assert (tmp_path / "checkpoints" / "tiny" / "config.yaml").exists()
    assert (tmp_path / "runs" / "tiny" / "metrics.jsonl").exists()
    # the Bayesian branches are ported (tests/test_torch_bayes.py and
    # tests/test_torch_mcmc.py hold them to the JAX package)
    tcli.main(["--config", "tiny.yaml", "--experiment-name", "vi", "--device", "cpu", "--vi"])
    assert (tmp_path / "checkpoints" / "vi" / "vi_model" / "leaves.npz").exists()
    tcli.main(["--config", "tiny.yaml", "--experiment-name", "mcmc", "--device", "cpu",
               "--mcmc", "--mcmc-chains", "2", "--mcmc-warmup", "2", "--mcmc-samples", "2"])
    assert (tmp_path / "checkpoints" / "mcmc" / "mcmc_samples.npz").exists()
    assert tcli.build_parser().parse_args([]).device == "cuda"


def test_chip_smoke_first_step_references_are_the_jax_package_values():
    """chip_smoke.py holds the card's first train step to these constants."""
    import chip_smoke

    state, meta = j_load_checkpoint(CKPT)
    cfg = meta["config"]
    ds = jdata.create_data_arrays(DATA, 61, 30, use_native=False)
    tr, _, _ = jdata.split_dataset(ds, seed=42)
    batch, _ = jdata.pad_batch(next(jdata.batch_iterator(tr, 32, shuffle=True, seed=0)), 32)
    config = jhyb.config_from_dict(cfg, use_pallas=True)
    (loss, _), g = jax.value_and_grad(
        lambda q: jhyb.hybrid_loss(q, batch, jax.random.PRNGKey(0), config,
                                   lambda1=cfg["training"]["lambda1"],
                                   lambda2=cfg["training"]["lambda2"]), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, state["params"]))
    np.testing.assert_allclose(float(loss), chip_smoke.REF_TRAIN_LOSS, rtol=1e-7)
    np.testing.assert_allclose(float(optax.global_norm(g)), chip_smoke.REF_GRAD_NORM, rtol=1e-7)
