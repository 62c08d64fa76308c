"""Port parity: closed-loop dosing and its optimisation (`models/protocol.py`).

The counterparts of the JAX suite's protocol tests (the protocol law, the
in-loop anchoring, the calibration's known attenuation, the optimiser) run on
the port and are each held against the JAX function on the same numpy
parameters, at a small size (H=16, 2 layers, rk4 with 2 substeps).

Tolerances (f32), each difference over the reference's largest value.
Rollouts: 1e-5 (reading 5.6e-7). The optimiser's risk trace and final
parameters: 1e-4 per entry (Adam in torch and in optax round in other
orders; reading 4.4e-6). Calibration scale and slopes: 1e-4 (reading 2.0e-7).
Risk functions and their gradients: 1e-6 (reading 3.3e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.models import hybrid as jhybrid
from hybrid_ode_tpu.models import protocol as jprot
from hybrid_ode_torch.models import protocol as tprot
from hybrid_ode_torch.models.hybrid import HybridConfig as THybridConfig
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

PHYS = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2])
ROLLOUT_RTOL = 1e-5
TRACE_RTOL = 1e-4
SLOPE_RTOL = 1e-4
RISK_RTOL = 1e-6
CFG = dict(solver="rk4", substeps=2, nn_hidden=16, nn_layers=2, mode="scan")


def _configs(**kw):
    return jhybrid.HybridConfig(**CFG, **kw), THybridConfig(**CFG, **kw)


def _params(jcfg, seed=0, k_ex=10.0, K=None):
    """JAX-initialised params (numpy) with a non-zero last MLP layer; K
    stacks K members with their own weights."""
    def one(s):
        p = jax.tree_util.tree_map(np.asarray, jhybrid.init_hybrid_params(jax.random.PRNGKey(s),
                                                                          jcfg))
        last = f"w{jcfg.nn_layers}"
        p["nn"][last] = 0.05 * np.random.default_rng(s).standard_normal(
            p["nn"][last].shape).astype(np.float32)
        if "k_ex" in p["ode"]:
            p["ode"]["k_ex"] = np.float32(k_ex * (1 + 0.1 * s))
        return p

    if K is None:
        return one(seed)
    members = [one(seed + i) for i in range(K)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *members)


def _batch(B=3, hours=2, steps_per_h=4, seed=0):
    T = hours * steps_per_h + 1
    ts = np.broadcast_to(np.linspace(0.0, float(hours), T, dtype=np.float32), (B, T)).copy()
    rng = np.random.default_rng(seed)
    y0 = (PHYS * (1 + 0.1 * np.arange(B)[:, None])).astype(np.float32)
    obs = (y0[:, None] * (1 + 0.02 * rng.standard_normal((B, T, 6)))).astype(np.float32)
    meal = np.zeros((B, T), np.float32)
    meal[:, 1] = 0.5
    return {"initial_state": y0, "observations": obs, "time_points": ts,
            "external_inputs": {"meal": meal}, "mask": np.ones((B, T), np.float32)}


def _jb(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale, (np.abs(a - b).max() / scale)


def _assert_rollouts(t, j, rtol=ROLLOUT_RTOL):
    assert set(t) == set(j)
    for k in j:
        assert tuple(t[k].shape) == tuple(np.shape(j[k])), k
        _close(t[k].detach().numpy(), j[k], rtol)


NORM = (np.zeros(6), np.ones(6))


def test_closed_loop_rollout_protocol_law():
    jcfg, tcfg = _configs(exog_insulin="mech")
    p = _params(jcfg)
    batch = _batch()
    tp = params_from_numpy(p, device="cpu")
    out = tprot.closed_loop_rollout(tp, batch, tcfg, gain=900.0, target=7.0, norm=NORM,
                                    check_every=4)
    _assert_rollouts(out, jprot.closed_loop_rollout(p, _jb(batch), jcfg, 900.0, 7.0, NORM,
                                                    check_every=4))
    B, T = batch["time_points"].shape
    assert out["trajectory"].shape == (B, T, 6) and out["rates"].shape == (B, 2)
    expect0 = np.clip(900.0 * (batch["initial_state"][:, 0] - 7.0), 0.0, 7000.0)
    np.testing.assert_allclose(out["rates"][:, 0].numpy(), expect0, rtol=1e-5)
    expect1 = np.clip(900.0 * (out["glucose"][:, 4].numpy() - 7.0), 0.0, 7000.0)
    np.testing.assert_allclose(out["rates"][:, 1].numpy(), expect1, rtol=1e-5)
    hi = tprot.closed_loop_rollout(tp, batch, tcfg, gain=900.0, target=20.0, norm=NORM,
                                   check_every=4)
    assert float(hi["insulin_total"].sum()) == 0.0
    assert float(hi["glucose"][:, -1].mean()) > float(out["glucose"][:, -1].mean())
    with pytest.raises(ValueError, match="divisible"):
        tprot.closed_loop_rollout(tp, batch, tcfg, 900.0, 7.0, NORM, check_every=3)


@pytest.mark.parametrize("basal", [0.0, 2500.0])
def test_per_patient_protocol_with_context_matches_jax(basal):
    jcfg, tcfg = _configs(exog_insulin="mech", context_points=3, context_dim=4)
    p = _params(jcfg, seed=2)
    batch = _batch(B=4, seed=1)
    gain = np.array([300.0, 900.0, 1800.0, 0.0], np.float32)
    target = np.array([6.0, 7.0, 8.5, 5.0], np.float32)
    norm = (PHYS * 0.9, PHYS * 0.2 + 1.0)
    z_batch = dict(batch, initial_state=((batch["initial_state"] - norm[0]) / norm[1]).astype(
        np.float32))
    t = tprot.closed_loop_rollout(params_from_numpy(p, device="cpu"), z_batch, tcfg,
                                  torch.tensor(gain), torch.tensor(target), norm,
                                  check_every=2, basal=basal, rate_cap=20000.0)
    j = jprot.closed_loop_rollout(p, _jb(z_batch), jcfg, jnp.asarray(gain), jnp.asarray(target),
                                  norm, check_every=2, basal=basal, rate_cap=20000.0)
    _assert_rollouts(t, j)


def test_closed_loop_rollout_glucose_offset_anchoring():
    jcfg, tcfg = _configs(exog_insulin="mech")
    p = _params(jcfg)
    tp = params_from_numpy(p, device="cpu")
    batch = _batch()
    batch["initial_state"][:, 0] = 7.0
    B, T = batch["time_points"].shape
    base = tprot.closed_loop_rollout(tp, batch, tcfg, 900.0, 7.0, NORM, check_every=4)
    assert float(base["rates"][:, 0].max()) == 0.0
    off = np.full((B, T), 4.0, np.float32)
    anch = tprot.closed_loop_rollout(tp, batch, tcfg, 900.0, 7.0, NORM, check_every=4,
                                     glucose_offset=off)
    _assert_rollouts(anch, jprot.closed_loop_rollout(p, _jb(batch), jcfg, 900.0, 7.0, NORM,
                                                     check_every=4,
                                                     glucose_offset=jnp.asarray(off)))
    np.testing.assert_allclose(anch["rates"][:, 0].numpy(), 3600.0, rtol=1e-5)
    assert float(anch["glucose"][:, -1].mean()) < float(base["glucose"][:, -1].mean())
    zero = tprot.closed_loop_rollout(tp, batch, tcfg, 900.0, 7.0, NORM, check_every=4,
                                     glucose_offset=np.zeros((B, T), np.float32))
    np.testing.assert_array_equal(zero["trajectory"].numpy(), base["trajectory"].numpy())


def test_fused_path_rollout_matches_jax_scan():
    """use_pallas with exog_insulin='nn': each chunk through the fused
    forward (its plain version on CPU tensors), against JAX's rk4 scan."""
    jcfg, tcfg = _configs(exog_insulin="nn", context_points=3, context_dim=4)
    p = _params(jcfg, seed=4)
    batch = _batch(B=5, seed=2)
    tcfg_fused = THybridConfig(**dict(CFG, nn_layers=2), context_points=3, context_dim=4,
                               use_pallas=True)
    t = tprot.closed_loop_rollout(params_from_numpy(p, device="cpu"), batch, tcfg_fused, 400.0,
                                  6.0, NORM, check_every=4)
    j = jprot.closed_loop_rollout(p, _jb(batch), jcfg, 400.0, 6.0, NORM, check_every=4)
    _assert_rollouts(t, j)


@pytest.mark.parametrize("exog", ["mech", "mech_blind"])
def test_ensemble_closed_loop_matches_jax_at_k3(exog):
    jcfg, tcfg = _configs(exog_insulin=exog, context_points=3, context_dim=4)
    stacked = _params(jcfg, seed=0, K=3)
    batch = _batch(B=4, seed=3)
    gain = np.array([300.0, 900.0, 1800.0, 600.0], np.float32)
    off = 0.3 * np.random.default_rng(5).standard_normal((4, 9)).astype(np.float32)
    kw = dict(check_every=4, basal=1000.0, rate_cap=20000.0)
    t = tprot.ensemble_closed_loop(params_from_numpy(stacked, device="cpu"), batch, tcfg,
                                   torch.tensor(gain), 7.0, NORM, glucose_offset=off, **kw)
    j = jprot.ensemble_closed_loop(stacked, _jb(batch), jcfg, jnp.asarray(gain), 7.0, NORM,
                                   glucose_offset=jnp.asarray(off), **kw)
    _assert_rollouts(t, j)
    assert t["rates"].shape == (3, 4, 2)
    # each member its own loop: the members' insulin differs
    assert not torch.equal(t["rates"][0], t["rates"][1])


def test_risk_functions_match_jax():
    rng = np.random.default_rng(0)
    g = (7.0 + 3.5 * rng.standard_normal((5, 4, 9))).astype(np.float32)
    fact = (g + 0.4 * rng.standard_normal(g.shape)).astype(np.float32)
    obs = (7.0 + 2.0 * rng.standard_normal((4, 9))).astype(np.float32)
    tg = torch.tensor(g, requires_grad=True)
    pairs = [
        (lambda x: tprot.glycemic_risk(x), lambda x: jprot.glycemic_risk(x)),
        (lambda x: tprot.glycemic_risk(x, hypo=4.5, hyper=9.0, hypo_weight=10.0),
         lambda x: jprot.glycemic_risk(x, hypo=4.5, hyper=9.0, hypo_weight=10.0)),
        (lambda x: tprot.cvar_glycemic_risk(x, alpha=0.4),
         lambda x: jprot.cvar_glycemic_risk(x, alpha=0.4)),
        (lambda x: tprot.robust_delta_risk(x, torch.tensor(fact), torch.tensor(obs)),
         lambda x: jprot.robust_delta_risk(x, jnp.asarray(fact), jnp.asarray(obs))),
        (lambda x: tprot.robust_delta_risk(
            x, torch.tensor(fact), torch.tensor(obs),
            objective=lambda gc: tprot.cvar_glycemic_risk(gc, alpha=0.25)),
         lambda x: jprot.robust_delta_risk(
             x, jnp.asarray(fact), jnp.asarray(obs),
             objective=lambda gc: jprot.cvar_glycemic_risk(gc, alpha=0.25))),
    ]
    for tf, jf in pairs:
        tg.grad = None
        val = tf(tg)
        val.backward()
        jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(g))
        _close(val.detach().numpy(), jval, RISK_RTOL)
        _close(tg.grad.numpy(), jgrad, RISK_RTOL)
    assert float(tprot.time_in_range(torch.tensor(g))) == float(jprot.time_in_range(g))
    np.testing.assert_array_equal(
        tprot.counterfactual_delta_correction(torch.tensor(g), torch.tensor(fact),
                                              torch.tensor(obs)).numpy(),
        np.asarray(jprot.counterfactual_delta_correction(jnp.asarray(g), jnp.asarray(fact),
                                                         jnp.asarray(obs))))
    assert float(tprot.glycemic_risk(torch.full((4, 5), 6.0))) == 0.0


@pytest.mark.parametrize("space", ["2d_log_gain", "2d_boxed", "3d_basal", "per_patient"])
def test_optimize_protocol_trace_matches_jax(space):
    jcfg, tcfg = _configs(exog_insulin="mech")
    p = _params(jcfg)
    tp = params_from_numpy(p, device="cpu")
    batch = _batch()
    batch["initial_state"][:, 0] += 6.0
    jbatch = _jb(batch)
    kw = dict(init_gain=100.0, init_target=8.5)
    if space == "2d_boxed":
        kw = dict(init_gain=900.0, init_target=7.0, gain_bounds=(0, 3600))
    elif space == "3d_basal":
        kw = dict(init_gain=900.0, init_target=7.0, gain_bounds=(0, 3600), init_basal=500.0)
    elif space == "per_patient":
        kw = dict(init_gain=np.full(3, 900.0, np.float32),
                  init_target=np.full(3, 7.0, np.float32), gain_bounds=(0, 3600),
                  init_basal=np.full(3, 1.0, np.float32))

    def t_roll(gain, target, basal=0.0):
        return tprot.closed_loop_rollout(tp, batch, tcfg, gain, target, NORM, check_every=4,
                                         basal=basal, rate_cap=20000.0)["glucose"]

    def j_roll(gain, target, basal=0.0):
        return jprot.closed_loop_rollout(p, jbatch, jcfg, gain, target, NORM, check_every=4,
                                         basal=basal, rate_cap=20000.0)["glucose"]

    t = tprot.optimize_protocol(t_roll, steps=5, lr=0.1, device="cpu", **kw)
    j = jprot.optimize_protocol(j_roll, steps=5, lr=0.1, **kw)
    assert len(t["risk"]) == 6
    np.testing.assert_allclose(t["risk"], j["risk"], rtol=TRACE_RTOL)
    assert t["final_risk"] < t["init_risk"]
    for k in ("gain", "target") + (("basal",) if "init_basal" in kw else ()):
        np.testing.assert_allclose(t[k], j[k], rtol=TRACE_RTOL)
    assert 4.5 <= np.min(t["target"]) and np.max(t["target"]) <= 9.0


def test_calibrate_dose_response_recovers_known_attenuation():
    jcfg, tcfg = _configs(exog_insulin="mech_blind")
    p_true = _params(jcfg, k_ex=12.0)
    B, hours, sph = 12, 4, 4
    T = hours * sph + 1
    rng = np.random.default_rng(3)
    y0 = np.stack([PHYS * (1 + 0.15 * rng.standard_normal(6)) for _ in range(B)]).astype(
        np.float32)
    y0[:, 0] += 4.0
    ts = np.broadcast_to(np.linspace(0.0, float(hours), T, dtype=np.float32), (B, T)).copy()
    batch = {"initial_state": y0, "observations": np.broadcast_to(y0[:, None], (B, T, 6)).copy(),
             "time_points": ts, "external_inputs": {"meal": np.zeros((B, T), np.float32)},
             "mask": np.ones((B, T), np.float32)}
    gain_w = (900.0 * rng.uniform(0.25, 3.0, B)).astype(np.float32)
    target_w = rng.uniform(5.0, 9.0, B).astype(np.float32)
    basal_w = np.zeros(B, np.float32)
    obs = np.asarray(jprot.closed_loop_rollout(
        p_true, _jb(batch), jcfg, jnp.asarray(gain_w), jnp.asarray(target_w), NORM,
        check_every=sph, basal=jnp.asarray(basal_w), rate_cap=20000.0)["glucose"])
    stacked = jax.tree_util.tree_map(lambda a: np.broadcast_to(a, (2,) + np.shape(a)).copy(),
                                     p_true)
    stacked["ode"]["k_ex"] = np.full((2,), 12.0 / 4.0, np.float32)
    kw = dict(observed_glucose=obs, observed_mask=np.ones((B, T), np.float32),
              subject_idx=np.arange(B), scales=(1.0, 2.0, 4.0, 8.0), rate_cap=20000.0,
              check_every=sph)
    for instruments in (None, np.stack([gain_w, target_w], axis=1)):
        t = tprot.calibrate_dose_response(params_from_numpy(stacked, device="cpu"), batch, tcfg,
                                          NORM, gain_w, target_w, basal_w,
                                          instruments=instruments, **kw)
        j = jprot.calibrate_dose_response(stacked, _jb(batch), jcfg, NORM, jnp.asarray(gain_w),
                                          jnp.asarray(target_w), jnp.asarray(basal_w),
                                          instruments=instruments, **kw)
        assert t["scale"] == pytest.approx(j["scale"], rel=SLOPE_RTOL)
        for s in j["slopes"]:
            assert t["slopes"][s]["slope"] == pytest.approx(j["slopes"][s]["slope"],
                                                            rel=SLOPE_RTOL, abs=1e-4)
        assert t["slope_at_scale"]["nearest_scanned_scale"] == \
            j["slope_at_scale"]["nearest_scanned_scale"]
        np.testing.assert_allclose(t["stacked_calibrated"]["ode"]["k_ex"].numpy(),
                                   3.0 * t["scale"], rtol=1e-6)
        if instruments is None:
            assert 2.5 < t["scale"] < 6.5, t["slopes"]
            assert t["slopes"][1.0]["slope"] > 1.2
