"""Port parity: test-time identification (`hybrid_ode_torch/models/hybrid.py`).

`identify_context`, `identify_params` / `forward_with_param_deltas` and
`amortize_encoder` against the JAX functions of the same names at a small
size and a few steps, the same numpy-seeded model and windows through both.
With `use_pallas` the JAX side runs its Pallas kernels in interpret mode and
the port the kernels' plain versions (a CPU tensor never reaches a kernel).

Tolerances. Data misfits of the returned codes: 1e-5 relative. Returned
codes and deltas: 2e-4 of the largest value, looser than the misfits because
Adam divides the gradient by the root of its second moment: in the first
steps an update is lr * sign(g) whatever the gradient's size, so where a
gradient component is near zero a difference in the last bit can turn a
step. And a window's returned code is its best iterate by a strict < on f32
misfits: where two iterates tie to 1e-5 the two frameworks may return
different ones. Such a window passes if the port's own misfit at the JAX
code equals its misfit at the code it returned, to 1e-5 (`_assert_codes`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.dynamics.controls import Controls as JControls
from hybrid_ode_tpu.dynamics.residual import init_mlp_params as j_init_mlp_params
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

CODE_TOL = 2e-4
MISFIT_RTOL = 1e-5
K = 4  # context_points


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-8)


def _setup(mode, use_pallas=False, seed=0, B=6, T=9, H=8):
    """(jax config, numpy params, numpy batch) for one case."""
    rng = np.random.default_rng(seed)
    cfg = jhyb.HybridConfig(nn_hidden=H, nn_layers=2, solver="rk4", substeps=2,
                            context_points=K, context_dim=3, context_mode=mode,
                            use_pallas=use_pallas)
    p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(seed), cfg))
    p["nn"]["w2"] = (0.05 * rng.normal(size=p["nn"]["w2"].shape)).astype(np.float32)
    if mode == "features":
        # feature codes act through the MLP only: hidden layers of unit gain,
        # and context rows that weigh as much as the O(100) state inputs
        for name in ("w0", "w1"):
            w = rng.normal(size=p["nn"][name].shape) / np.sqrt(p["nn"][name].shape[0])
            p["nn"][name] = w.astype(np.float32)
        p["nn"]["w0"][9:] *= 50.0
    p["enc"]["w2"] = (0.1 * rng.normal(size=p["enc"]["w2"].shape)).astype(np.float32)
    base = np.array([8.0, 100.0, 90.0, 20.0, 0.5, 1.2], np.float32)
    y0 = (base * (1 + 0.1 * rng.normal(size=(B, 6)))).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.05, 0.25, (B, T)), 1).astype(np.float32)
    ext = {"meal": np.where(rng.uniform(size=(B, T)) > 0.6, 2.0, 0.0).astype(np.float32),
           "tVNS": rng.uniform(0, 1, (B, T)).astype(np.float32)}
    # observations: the model's own rollout under codes the encoder does not
    # produce, plus 5% noise (residuals well above f32 rounding of the O(100)
    # states), so that refinement has a real descent direction
    true_ctx = (0.4 * rng.normal(size=(B, 3))).astype(np.float32)
    sig = {k: jnp.asarray(v) for k, v in dict(ext, context=true_ctx).items()}
    clean = jhyb.batched_forward(p, jnp.asarray(y0), jnp.asarray(ts),
                                 JControls(ts=jnp.asarray(ts), signals=sig),
                                 dataclasses.replace(cfg, use_pallas=False))
    obs = (np.asarray(clean) * (1 + 0.05 * rng.normal(size=(B, T, 6)))).astype(np.float32)
    obs[:, 0] = y0
    mask = (rng.uniform(size=(B, T)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    batch = {
        "initial_state": y0, "observations": obs, "time_points": ts, "mask": mask,
        "loss_weights": np.array([1.0, 0.01, 0.01, 0.1, 0.0, 1.0], np.float32),
        "external_inputs": ext,
    }
    return cfg, p, batch


def _tcfg(cfg):
    return thyb.HybridConfig(**dataclasses.asdict(cfg))


def _tbatch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items() if k != "external_inputs"}
    out["external_inputs"] = {k: torch.as_tensor(v) for k, v in batch["external_inputs"].items()}
    return out


def _misfit_jax(p, batch, cfg, ctx, k, deltas=None):
    """Per-window masked, weighted misfit over the first k points (JAX side)."""
    sig = {n: jnp.asarray(v)[:, :k] for n, v in batch["external_inputs"].items()}
    if ctx is not None:
        sig["context"] = jnp.asarray(ctx)
    ts_k = jnp.asarray(batch["time_points"])[:, :k]
    ctrl = JControls(ts=ts_k, signals=sig)
    y0 = jnp.asarray(batch["initial_state"])
    if deltas is None:
        preds = jhyb.batched_forward(p, y0, ts_k, ctrl, cfg)
    else:
        preds = jhyb.forward_with_param_deltas(p, jnp.asarray(deltas), y0, ts_k, ctrl, cfg)
    return np.asarray(_misfit(np.asarray(preds), batch, k))


def _misfit_torch(p, batch, cfg, ctx, k, deltas=None):
    tb = _tbatch(batch)
    sig = {n: v[:, :k] for n, v in tb["external_inputs"].items()}
    if ctx is not None:
        sig["context"] = torch.as_tensor(ctx)
    ts_k = tb["time_points"][:, :k]
    ctrl = Controls(ts=ts_k, signals=sig)
    with torch.no_grad():
        if deltas is None:
            preds = thyb.batched_forward(p, tb["initial_state"], ts_k, ctrl, cfg)
        else:
            preds = thyb.forward_with_param_deltas(p, torch.as_tensor(deltas), tb["initial_state"],
                                                   ts_k, ctrl, cfg)
    return _misfit(preds.numpy(), batch, k)


def _assert_codes(ref, got, misfit_of):
    """Codes agree to CODE_TOL window by window; a window may differ only if
    the two codes tie on the port's own misfit (another best iterate)."""
    ref, got = np.asarray(ref), np.asarray(got)
    far = np.abs(ref - got).max(1) > CODE_TOL * np.abs(ref).max()
    if far.any():
        np.testing.assert_allclose(misfit_of(got)[far], misfit_of(ref)[far], rtol=MISFIT_RTOL)
    assert far.sum() <= 1, f"{far.sum()} windows returned another iterate"


def _misfit(preds, batch, k):
    m = batch["mask"][:, :k]
    se = (preds - batch["observations"][:, :k]) ** 2 * batch["loss_weights"] * m[..., None]
    return se.sum((1, 2)) / np.maximum(m.sum(1) * 6, 1.0)


@pytest.mark.parametrize("mode,use_pallas,variant", [
    ("features", False, "encoder"),
    ("features", True, "encoder"),
    ("params", False, "encoder"),
    ("params", True, "encoder"),
    ("params", True, "init"),
    ("params", False, "long"),
    ("features", False, "no_encoder"),
])
def test_identify_context_matches_jax(mode, use_pallas, variant):
    cfg, p, batch = _setup(mode, use_pallas)
    # a weak trust region, so that the data term drives a descent over all 6
    # steps (the last iterate is the best one); 'init' keeps the default, under
    # which the trust term turns the search back after the first step
    kw = dict(steps=6, lr=0.02, prior_std=5.0)
    k = K
    if variant == "init":
        kw["prior_std"] = 0.2
        kw["init"] = (0.1 * np.random.default_rng(9).normal(size=(6, 3))).astype(np.float32)
    elif variant == "long":
        kw["points"] = k = 7  # more than context_points: the encoder still reads K
    elif variant == "no_encoder":
        p = {g: v for g, v in p.items() if g != "enc"}
    jkw = {n: (jnp.asarray(v) if n == "init" else v) for n, v in kw.items()}
    ref = np.asarray(jhyb.identify_context(p, batch, cfg, **jkw))
    tp = params_from_numpy(p, "cpu")
    tkw = {n: (torch.as_tensor(v) if n == "init" else v) for n, v in kw.items()}
    got = thyb.identify_context(tp, _tbatch(batch), _tcfg(cfg), **tkw).numpy()
    assert got.shape == ref.shape == (6, 3)
    _assert_codes(ref, got, lambda c: _misfit_torch(tp, batch, _tcfg(cfg), c, k))
    np.testing.assert_allclose(_misfit_torch(tp, batch, _tcfg(cfg), got, k),
                               _misfit_jax(p, batch, cfg, ref, k), rtol=MISFIT_RTOL)
    # the refinement moved the codes and did not raise any window's misfit
    if variant == "init":
        start = kw["init"]
    elif variant == "no_encoder":
        start = np.zeros((6, 3), np.float32)
    else:
        tb = _tbatch(batch)
        start = thyb.encode_context(tp["enc"], tb["observations"], tb["time_points"], K).numpy()
    assert np.abs(got - start).max() > 1e-3
    assert (_misfit_torch(tp, batch, _tcfg(cfg), got, k)
            <= _misfit_torch(tp, batch, _tcfg(cfg), start, k)).all()


def test_identify_context_requires_context_points():
    cfg, p, batch = _setup("features")
    with pytest.raises(ValueError, match="context_points"):
        thyb.identify_context(params_from_numpy(p, "cpu"), _tbatch(batch),
                              dataclasses.replace(_tcfg(cfg), context_points=0))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_diverging_refinement_keeps_the_initial_code(use_pallas):
    """lr so large that the first step sends every code to +-1e3: e^delta
    overflows, the trajectories are not finite, the misfit counts as 1e6 and
    never beats the start, so each window keeps its encoder code exactly."""
    cfg, p, batch = _setup("params", use_pallas)
    tp, tb = params_from_numpy(p, "cpu"), _tbatch(batch)
    start = thyb.encode_context(tp["enc"], tb["observations"], tb["time_points"], K).numpy()
    got = thyb.identify_context(tp, tb, _tcfg(cfg), steps=3, lr=1e3).numpy()
    np.testing.assert_array_equal(got, start)
    ref = np.asarray(jhyb.identify_context(p, batch, cfg, steps=3, lr=1e3))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_one_diverging_window_does_not_poison_the_others():
    """A window with a non-finite observation inside the identification
    window: its misfit is 1e6 from the start and stays, it keeps its code,
    and the other windows are refined as if it were not there."""
    cfg, p, batch = _setup("params", True)
    bad = {**batch, "observations": batch["observations"].copy()}
    bad["observations"][2, 2, 0] = np.nan
    tp = params_from_numpy(p, "cpu")
    init = (0.1 * np.random.default_rng(4).normal(size=(6, 3))).astype(np.float32)
    clean = thyb.identify_context(tp, _tbatch(batch), _tcfg(cfg), steps=4, init=torch.as_tensor(init))
    got = thyb.identify_context(tp, _tbatch(bad), _tcfg(cfg), steps=4, init=torch.as_tensor(init))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[2].numpy(), init[2])
    others = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(got[others].numpy(), clean[others].numpy())


@pytest.mark.parametrize("with_context", [False, True])
def test_identify_params_matches_jax(with_context):
    cfg, p, batch = _setup("params")
    ctx = ((0.1 * np.random.default_rng(3).normal(size=(6, 3))).astype(np.float32)
           if with_context else None)
    kw = dict(steps=5, lr=0.02, prior_std=1.0, points=6)
    ref = np.asarray(jhyb.identify_params(p, batch, cfg, context=None if ctx is None
                                          else jnp.asarray(ctx), **kw))
    tp = params_from_numpy(p, "cpu")
    got = thyb.identify_params(tp, _tbatch(batch), _tcfg(cfg), context=None if ctx is None
                               else torch.as_tensor(ctx), **kw).numpy()
    assert got.shape == ref.shape == (6, len(p["ode"]))
    _assert_codes(ref, got, lambda d: _misfit_torch(tp, batch, _tcfg(cfg), ctx, 6, deltas=d))
    np.testing.assert_allclose(_misfit_torch(tp, batch, _tcfg(cfg), ctx, 6, deltas=got),
                               _misfit_jax(p, batch, cfg, ctx, 6, deltas=ref), rtol=MISFIT_RTOL)
    zero = np.zeros_like(got)
    assert (_misfit_torch(tp, batch, _tcfg(cfg), ctx, 6, deltas=got)
            <= _misfit_torch(tp, batch, _tcfg(cfg), ctx, 6, deltas=zero)).all()


def test_forward_with_param_deltas_matches_jax():
    cfg, p, batch = _setup("params")
    rng = np.random.default_rng(7)
    deltas = (0.1 * rng.normal(size=(6, len(p["ode"])))).astype(np.float32)
    ctx = (0.1 * rng.normal(size=(6, 3))).astype(np.float32)
    sig = dict(batch["external_inputs"], context=ctx)
    ref = jhyb.forward_with_param_deltas(
        p, jnp.asarray(deltas), jnp.asarray(batch["initial_state"]), jnp.asarray(batch["time_points"]),
        JControls(ts=jnp.asarray(batch["time_points"]),
                  signals={k: jnp.asarray(v) for k, v in sig.items()}), cfg)
    with torch.no_grad():
        got = thyb.forward_with_param_deltas(
            params_from_numpy(p, "cpu"), torch.as_tensor(deltas), torch.as_tensor(batch["initial_state"]),
            torch.as_tensor(batch["time_points"]),
            Controls(ts=torch.as_tensor(batch["time_points"]),
                     signals={k: torch.as_tensor(v) for k, v in sig.items()}), _tcfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    # zero deltas are the plain rollout
    with torch.no_grad():
        tb = _tbatch(batch)
        ctrl = Controls(ts=tb["time_points"], signals={k: torch.as_tensor(v) for k, v in sig.items()})
        a = thyb.forward_with_param_deltas(params_from_numpy(p, "cpu"), torch.zeros_like(torch.as_tensor(deltas)),
                                           tb["initial_state"], tb["time_points"], ctrl, _tcfg(cfg))
        b = thyb.batched_forward(params_from_numpy(p, "cpu"), tb["initial_state"], tb["time_points"],
                                 ctrl, _tcfg(cfg))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def _jax_encoder_draws(key, k, n, hidden, n_layers, out_dim, B):
    """The initial encoder and the permutation `jhyb.amortize_encoder` draws
    from `key` (hybrid.py:825-835), as numpy, to hand to the port."""
    key, ik, sk = jax.random.split(key, 3)
    enc = j_init_mlp_params(ik, input_dim=k * (n + 1), hidden_dim=hidden, output_dim=out_dim,
                            n_layers=n_layers, dtype=jnp.float32)
    wlast = f"w{n_layers}"
    enc[wlast] = 0.05 * jax.random.normal(jax.random.fold_in(ik, 1), enc[wlast].shape, jnp.float32)
    return ({name: np.asarray(v) for name, v in enc.items()},
            np.asarray(jax.random.permutation(sk, B)))


@pytest.mark.parametrize("epochs,finetune_epochs,poison", [
    (1, 0, False), (4, 0, False), (12, 3, False), (4, 3, True)])
def test_amortize_encoder_matches_jax(epochs, finetune_epochs, poison):
    """Stage 1's loss after 1, 4 and 12 epochs (its curve) and its held-out
    best; stage 2's first and last train loss and held-out losses. The same
    initial encoder, permutation and targets go into both. `poison`: one
    window has a non-finite observation after the encoder's window; its
    squared error counts as 1e6 before the sum, so stage 2's loss stays
    finite and the other windows' gradients still train the encoder."""
    cfg, p, batch = _setup("params", use_pallas=True, B=8)
    if poison:
        batch = {**batch, "observations": batch["observations"].copy(),
                 "mask": np.ones_like(batch["mask"])}
        batch["observations"][:, 7, 0] = np.nan  # every window: train and held-out alike
    targets = (0.3 * np.random.default_rng(11).normal(size=(8, 3))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(points=5, hidden=8, n_layers=2, epochs=epochs, lr=1e-2, weight_decay=0.3,
              val_frac=0.25, finetune_epochs=finetune_epochs, finetune_lr=1e-3, finetune_chunk=2)
    jenc, jinfo = jhyb.amortize_encoder(p, batch, cfg, key=key, targets=jnp.asarray(targets), **kw)
    enc0, perm = _jax_encoder_draws(key, 5, 6, 8, 2, 3, 8)
    tenc, tinfo = thyb.amortize_encoder(
        params_from_numpy(p, "cpu"), _tbatch(batch), _tcfg(cfg), targets=torch.as_tensor(targets),
        init_encoder=params_from_numpy(enc0, "cpu"), permutation=torch.as_tensor(perm.copy()), **kw)
    assert set(tinfo) == set(jinfo)
    assert tinfo["points"] == jinfo["points"] and tinfo["n_windows"] == jinfo["n_windows"]
    for name in set(jinfo) - {"points", "n_windows"}:
        np.testing.assert_allclose(tinfo[name], jinfo[name], rtol=1e-4, err_msg=name)
    assert set(tenc) == set(jenc)
    for name in jenc:
        assert _rel_err(np.asarray(jenc[name]), tenc[name].numpy()) < 1e-3, name
    assert all(not v.requires_grad for v in tenc.values())
    assert np.isfinite(list(tinfo.values())).all()
    if finetune_epochs and not poison:  # stage 2 trained: its loss moved
        assert tinfo["finetune_train_last"] != tinfo["finetune_train_first"]


def test_amortize_encoder_draws_its_own_encoder_and_targets():
    """Without the parity hooks: the generator draws the encoder and the
    split, `identify_context` supplies the targets; same seed, same result."""
    cfg, p, batch = _setup("params", use_pallas=True, B=8)
    tp, tb = params_from_numpy(p, "cpu"), _tbatch(batch)
    kw = dict(points=5, id_steps=2, hidden=8, epochs=3, finetune_epochs=1)
    runs = [thyb.amortize_encoder(tp, tb, _tcfg(cfg), generator=torch.Generator().manual_seed(3), **kw)
            for _ in range(2)]
    (enc_a, info_a), (enc_b, info_b) = runs
    assert sorted(enc_a) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert enc_a["w0"].shape == (5 * 7, 8) and enc_a["w2"].shape == (8, 3)
    assert info_a == info_b and all(torch.equal(enc_a[k], enc_b[k]) for k in enc_a)
    assert np.isfinite(list(info_a.values())).all()
    codes = thyb.encode_context(enc_a, tb["observations"], tb["time_points"], 5)
    assert codes.shape == (8, 3)


def test_chip_smoke_identification_references_are_the_jax_package_values():
    """chip_smoke.py holds the card's identification misfits to these constants."""
    import chip_smoke
    from hybrid_ode_tpu.data import dataset as jdata
    from hybrid_ode_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint

    state, meta = j_load_checkpoint(str(chip_smoke.CKPT_R2))
    ds = jdata.create_data_arrays(str(chip_smoke.DATA), 61, 30, use_native=False)
    _, _, te = jdata.split_dataset(ds, seed=42)
    batch = next(jdata.batch_iterator(te, len(te), shuffle=False))
    config = jhyb.config_from_dict(meta["config"])
    assert config.use_pallas and config.context_mode == "params"
    p = jax.tree_util.tree_map(jnp.asarray, state["params"])
    k = config.context_points
    enc = jhyb.encode_context(p["enc"], jnp.asarray(batch["observations"]),
                              jnp.asarray(batch["time_points"]), k)
    ctx = jhyb.identify_context(p, batch, config, steps=chip_smoke.ID_STEPS)

    def mean_misfit(c):  # chip_smoke.id_misfit's formula
        sig = {n: jnp.asarray(v)[:, :k] for n, v in batch["external_inputs"].items()}
        ts_k = jnp.asarray(batch["time_points"])[:, :k]
        preds = jhyb.batched_forward(p, jnp.asarray(batch["initial_state"]), ts_k,
                                     JControls(ts=ts_k, signals=dict(sig, context=c)), config)
        return float(_misfit(np.asarray(preds), batch, k).mean())

    np.testing.assert_allclose(mean_misfit(enc), chip_smoke.REF_ID_MISFIT_ENCODER, rtol=1e-6)
    np.testing.assert_allclose(mean_misfit(ctx), chip_smoke.REF_ID_MISFIT_IDENTIFIED, rtol=1e-6)
