"""Port parity for online adaptation's policy selectors and ensemble
variants (`train/online.py`), on the CPU against the JAX package: the
small models and the committed stream cohort of tests/test_torch_online.py
(cut to its first 12 h), select_guard_policy / tune_online_policy choices
and tables equal, the K=2 ensemble's adapted members and RMSEs to 1e-5.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.data import dataset as jdata
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.train import online as jon
from hybrid_ode_torch.data import dataset as tdata
from hybrid_ode_torch.models import hybrid as thyb
from hybrid_ode_torch.train import online as ton
from hybrid_ode_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STREAM = ROOT / "hybrid_ode_torch" / "testdata" / "online_stream_s4.csv"
RTOL = 1e-5


def _leaf_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-8))


def _tree_close(jtree, ttree, tol, label=""):
    for g in jtree:
        for k in jtree[g]:
            e = _leaf_err(jtree[g][k], ttree[g][k].detach().cpu().numpy())
            assert e < tol, (label, g, k, e)


@pytest.fixture(scope="module")
def streams():
    """Both packages' datasets of the committed CSV (one 361-point window per
    subject), the port's as numpy arrays of the same values."""
    jds = jdata.create_data_arrays(str(STREAM), 361, 361, use_native=False)
    tds = tdata.create_data_arrays(str(STREAM), 361, 361, use_native=False)
    assert len(jds) == len(tds) == 4
    np.testing.assert_array_equal(jds.observations, tds.observations)
    return jds, tds


def _model(use_pallas=False, K=None, seed=0):
    cfg = jhyb.HybridConfig(solver="rk4", substeps=2, nn_hidden=16, nn_layers=2,
                            context_points=3, context_dim=4, use_pallas=use_pallas)

    def one(s):
        p = jax.tree_util.tree_map(np.asarray, jhyb.init_hybrid_params(jax.random.PRNGKey(s), cfg))
        p["nn"]["w2"] = (0.05 * np.random.default_rng(s).normal(size=p["nn"]["w2"].shape)
                         ).astype(np.float32)
        return p

    if K is None:
        p = one(seed)
    else:
        members = [one(seed + i) for i in range(K)]
        p = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *members)
    return cfg, thyb.HybridConfig(**dataclasses.asdict(cfg)), p


def _cut(ds, n=145):
    """The first n points of every stream (n=145: 12 h)."""
    cut = {k: getattr(ds, k)[:, :n] for k in ("observations", "time_points", "meal", "tvns",
                                                "mask")}
    return dataclasses.replace(ds, **cut)


def _window(ds, w):
    return {"observations": ds.observations[w], "time_points": ds.time_points[w],
            "external_inputs": {"meal": ds.meal[w], "tVNS": ds.tvns[w]}, "mask": ds.mask[w]}


def _jp(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def test_select_and_tune_policies_match_jax(streams):
    """select_guard_policy and tune_online_policy at 6 h of the first 12 h
    over 3 subjects (2 adaptation steps; two candidates): the same policies,
    and the selection table's numbers (rounded to 4 places by both) equal."""
    jds, tds = (_cut(ds) for ds in streams)
    jcfg, tcfg, p = _model()
    tp = params_from_numpy(p, "cpu")
    kw = dict(horizons_hours=(6.0,), adapt_steps=2, learning_rate=1e-3,
              window_indices=(0, 1, 2))
    jpol, jtab = jon.select_guard_policy(_jp(p), jds, jcfg, **kw)
    tpol, ttab = ton.select_guard_policy(tp, tds, tcfg, **kw)
    assert tpol == jpol and ttab == jtab
    cands = [{"adapt_steps": 0}, {"adapt_steps": 2, "learning_rate": 1e-3,
                                  "anchor_weight": 1.0, "adapt_scope": "last"}]
    kw = dict(candidates=cands, window_indices=(0, 1, 2))
    assert (ton.tune_online_policy(tp, tds, tcfg, (6.0,), **kw)
            == jon.tune_online_policy(_jp(p), jds, jcfg, (6.0,), **kw))


def test_ensemble_online_adaptation_matches_jax(streams):
    """K=2 members: adapt_subject_ensemble's members to 1e-5,
    ensemble_online_adaptation_eval at 6 h of the first 12 h (2 steps,
    plain and guarded, both blend modes) to 1e-5."""
    jds, tds = (_cut(ds) for ds in streams)
    jcfg, tcfg, p = _model(K=2)
    tp = params_from_numpy(p, "cpu")
    ja = jon.adapt_subject_ensemble(_jp(p), _window(jds, 0), jcfg, 73, adapt_steps=2,
                                    learning_rate=1e-3)
    ta = ton.adapt_subject_ensemble(tp, _window(tds, 0), tcfg, 73, adapt_steps=2,
                                    learning_rate=1e-3)
    _tree_close(ja, ta, RTOL, "ensemble")
    for guard, blend in ((False, "mean"), (True, "mean"), (True, "per_member")):
        kw = dict(horizons_hours=(6.0,), adapt_steps=2, learning_rate=1e-3,
                  window_indices=(0,), guard=guard, blend_mode=blend)
        ref = jon.ensemble_online_adaptation_eval(_jp(p), jds, jcfg, **kw)
        got = ton.ensemble_online_adaptation_eval(tp, tds, tcfg, **kw)
        assert got[6.0] == pytest.approx(ref[6.0], rel=RTOL), (guard, blend)
