"""chip_smoke.py phase 4g's online-adaptation constants, recomputed from the
JAX package on the CPU: checkpoints/online_population on the committed
stream cohort rebased to its statistics (`chip_smoke.online_stream`),
online_adaptation_eval at 6 / 12 / 24 h with 0 and 5 Adam steps, the arm
adapt_subject_guarded deploys for subject 0 at 24 h, and the K=8 ensemble's
RMSE for subject 0 at 24 h after 1 step; the nudge readings that set the
adapted RMSE's limits. The JAX values come from its XLA
path (use_pallas off): its interpret-mode kernel at H=128 and 289 points
would take hours here. About 2 and 4.5 minutes on the CPU, so marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from hybrid_ode_tpu.models import hybrid as jhyb
from hybrid_ode_tpu.train import online as jon
from hybrid_ode_torch.utils.checkpoint import load_checkpoint


def _score(e, k=2.0):
    n = len(e)
    return np.inf if n < 2 else e.mean() + k * e.std(ddof=1) / np.sqrt(n)


@pytest.mark.slow
def test_online_constants_are_the_jax_packages():
    state, meta = load_checkpoint(str(chip_smoke.ONLINE_CKPT))
    ds = chip_smoke.online_stream(meta["state_mean"], meta["state_std"])
    cfg = jhyb.config_from_dict(meta["config"], use_pallas=False)
    p = jax.tree_util.tree_map(jnp.asarray, state["params"])
    for steps, ref in chip_smoke.REF_ONLINE_RMSE.items():
        got = jon.online_adaptation_eval(p, ds, cfg, horizons_hours=chip_smoke.ONLINE_HORIZONS,
                                         adapt_steps=steps, learning_rate=chip_smoke.ONLINE_LR,
                                         anchor_weight=chip_smoke.ONLINE_ANCHOR)
        for h in chip_smoke.ONLINE_HORIZONS:
            assert ref[h] == pytest.approx(got[h], rel=1e-7), (steps, h)
    window = {"observations": ds.observations[0], "time_points": ds.time_points[0],
              "external_inputs": {"meal": ds.meal[0], "tVNS": ds.tvns[0]}, "mask": ds.mask[0]}
    reveal = int(np.clip(np.searchsorted(ds.time_points[0], float(ds.time_points[0, 0]) + 24.0),
                         4, ds.time_points.shape[1] - 4))
    _, sq = jon.guard_candidate_arms(p, window, cfg, reveal, chip_smoke.ONLINE_STEPS,
                                     chip_smoke.ONLINE_LR)
    assert min(sq, key=lambda a: _score(sq[a])) == chip_smoke.REF_GUARD_ALPHA
    est, emeta = load_checkpoint(str(chip_smoke.ONLINE_ENS_CKPT))
    got = jon.ensemble_online_adaptation_eval(
        jax.tree_util.tree_map(jnp.asarray, est), ds,
        jhyb.config_from_dict(emeta["config"], use_pallas=False), horizons_hours=(24.0,),
        adapt_steps=chip_smoke.ENSEMBLE_ONLINE_STEPS, learning_rate=chip_smoke.ONLINE_LR,
        window_indices=(0,))
    assert chip_smoke.REF_ENSEMBLE_ONLINE_RMSE == pytest.approx(got[24.0], rel=1e-7)


@pytest.mark.slow
def test_online_adapted_limits_are_twice_jax_nudged_move():
    """chip_smoke.REF_ONLINE_NUDGE: the larger relative move of the JAX
    package's adapted RMSE (5 steps) at each horizon when every MLP leaf is
    scaled by 1 + 1e-7 or 1 - 1e-7; ONLINE_ADAPTED_RTOL is twice it. Three
    adaptation runs of about 90 s each on the CPU."""
    state, meta = load_checkpoint(str(chip_smoke.ONLINE_CKPT))
    ds = chip_smoke.online_stream(meta["state_mean"], meta["state_std"])
    cfg = jhyb.config_from_dict(meta["config"], use_pallas=False)

    def rmse(scale):
        p = dict(state["params"], nn={k: (np.asarray(v) * np.float32(scale)).astype(np.float32)
                                      for k, v in state["params"]["nn"].items()})
        return jon.online_adaptation_eval(
            jax.tree_util.tree_map(jnp.asarray, p), ds, cfg,
            horizons_hours=chip_smoke.ONLINE_HORIZONS, adapt_steps=chip_smoke.ONLINE_STEPS,
            learning_rate=chip_smoke.ONLINE_LR, anchor_weight=chip_smoke.ONLINE_ANCHOR)

    base = rmse(1.0)
    moved = [rmse(s) for s in (1 + 1e-7, 1 - 1e-7)]
    for h in chip_smoke.ONLINE_HORIZONS:
        assert base[h] == pytest.approx(chip_smoke.REF_ONLINE_RMSE[chip_smoke.ONLINE_STEPS][h],
                                        rel=1e-7)
        nudge = max(abs(m[h] - base[h]) / base[h] for m in moved)
        assert chip_smoke.REF_ONLINE_NUDGE[h] == pytest.approx(nudge, rel=1e-2), h
        assert chip_smoke.ONLINE_ADAPTED_RTOL[h] == 2 * chip_smoke.REF_ONLINE_NUDGE[h]


def test_online_stream_is_the_committed_csv_rebased():
    """`chip_smoke.online_stream`: every subject's 361 points in the
    population model's frame, the same physical values as the CSV's own
    normalisation encodes (to f32 rounding of two normalisations, 2.7e-5)."""
    from hybrid_ode_torch.data.dataset import create_data_arrays

    _, meta = load_checkpoint(str(chip_smoke.ONLINE_CKPT))
    ds = chip_smoke.online_stream(meta["state_mean"], meta["state_std"])
    raw = create_data_arrays(str(chip_smoke.ONLINE_STREAM), 361, 361, use_native=False)
    assert ds.observations.shape == (4, 361, 6) and ds.observations.dtype == np.float32
    mean, std = (np.asarray(meta[k], np.float32) for k in ("state_mean", "state_std"))
    np.testing.assert_allclose(ds.observations * std + mean,
                               raw.observations * raw.state_std + raw.state_mean,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ds.state_std, std)
