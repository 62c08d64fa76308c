"""Online per-subject adaptation: streaming fine-tuning of a trained model.

Port of `hybrid_ode_tpu/train/online.py`. Given a population-trained
parameter set and one subject's stream, reveal the observations up to a
horizon, take `adapt_steps` Adam steps on the revealed window (small lr,
NN-only by default, an L2 anchor to the population weights), and measure
the prediction RMSE on the REMAINDER of the stream, re-anchored at the last
revealed observation. The guarded variant picks a shrinkage of the adapted
delta from held-out revealed data only; the policy selectors tune per
horizon on validation subjects; the ensemble variants adapt every member of
a stacked population ensemble at once (the member axis written out, as in
`parallel/ensemble.py`) and forecast with the members' mean.

Everything runs on the device that holds the parameters. With a config
that says `use_pallas` (rk4), every adaptation step is one fused forward
and one hand-adjoint launch (`FusedRK4`) and every forecast one forward
launch, at B=1. The loss reads no random draws here (no physics term), so
the JAX package's per-step PRNG keys have no counterpart.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models.hybrid import HybridConfig, batched_forward, hybrid_loss, with_context
from hybrid_ode_torch.parallel import ensemble as _ens

logger = logging.getLogger("hybrid_ode_torch.online")

Params = Dict[str, Dict[str, torch.Tensor]]


def _device(params: Params) -> torch.device:
    return next(iter(params["nn"].values())).device


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _reveal_batch(subject_window: Dict[str, Any], R: int, device) -> Dict[str, Any]:
    """The first R points of one subject's stream as a batch of one."""
    t = lambda x: _tensor(x, device)[None]  # noqa: E731
    return {
        "initial_state": t(subject_window["observations"][0]),
        "observations": t(subject_window["observations"][:R]),
        "time_points": t(subject_window["time_points"][:R]),
        "external_inputs": {k: t(v[:R]) for k, v in subject_window["external_inputs"].items()},
        "mask": t(subject_window["mask"][:R]),
    }


def _trained_names(nn: Dict[str, torch.Tensor], adapt_scope: str):
    """The MLP leaves that adapt: all of them ('nn') or the output layer's
    weight and bias ('last')."""
    n_last = max(int(k[1:]) for k in nn if k.startswith("w"))
    return [k for k in nn if adapt_scope == "nn" or k in (f"w{n_last}", f"b{n_last}")]


def _copy(params: Params) -> Params:
    return {g: {k: v.detach().clone() for k, v in grp.items()} for g, grp in params.items()}


def _adapt(params: Params, adapt_scope: str, adapt_steps: int, learning_rate: float,
           anchor_weight: float, loss_fn) -> Params:
    """Adam (optax.adam's defaults) on the adapted MLP leaves of a copy of
    params, minimising loss_fn(p) + anchor_weight * sum ||nn - nn_pop||^2
    (one scalar; for a stacked ensemble the members' terms are summed, so
    each member's leaves get its own gradient); the rest stays frozen."""
    pop_nn = {k: v.detach() for k, v in params["nn"].items()}
    p = _copy(params)
    train = [p["nn"][k].requires_grad_(True) for k in _trained_names(p["nn"], adapt_scope)]
    opt = torch.optim.Adam(train, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(adapt_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(p)
        anchor = sum(torch.sum((p["nn"][k] - pop_nn[k]) ** 2) for k in pop_nn)
        (loss + anchor_weight * anchor).backward()
        opt.step()
        losses.append(loss.detach())
    if losses:
        logger.debug("adaptation loss %0.4f -> %0.4f", float(losses[0]), float(losses[-1]))
    return _copy(p)


def adapt_subject(
    params: Params,
    subject_window: Dict[str, np.ndarray],
    config: HybridConfig,
    reveal_points: int,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    generator: Optional[torch.Generator] = None,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
) -> Params:
    """Fine-tune on the first `reveal_points` observations of one subject.

    subject_window: single-subject arrays over T points (observations,
    time_points, external_inputs, mask). anchor_weight: L2 pull toward the
    population parameters (Bayesian shrinkage in point-estimate form: a few
    dozen steps on a short noisy reveal otherwise overfit the noise).
    adapt_scope: 'nn' trains the whole residual MLP, 'last' only its output
    layer. generator: unused (the loss has no physics term); kept where the
    JAX package takes its PRNG key."""
    batch = _reveal_batch(subject_window, reveal_points, _device(params))

    def loss_fn(p):
        return hybrid_loss(p, batch, generator, config, lambda1=0.0, lambda2=0.0,
                           use_physics_loss=False)[0]

    return _adapt(params, adapt_scope, adapt_steps, learning_rate, anchor_weight, loss_fn)


def adapt_subject_ensemble(
    stacked_params: Params,
    subject_window: Dict[str, np.ndarray],
    config: HybridConfig,
    reveal_points: int,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    generator: Optional[torch.Generator] = None,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
) -> Params:
    """Per-subject adaptation of EVERY member of a stacked ensemble at once:
    each member anchors to its OWN population weights and takes its own
    Adam steps (Adam acts elementwise, so one optimizer over the stacked
    leaves is K independent ones). The member axis is written out: K=8 runs
    the launches of K=1."""
    batch = _reveal_batch(subject_window, reveal_points, _device(stacked_params))

    def loss_fn(p):
        losses, _ = _ens.ensemble_loss(p, batch, generator, config, lambda1=0.0, lambda2=0.0,
                                       use_physics_loss=False)
        return losses.sum()

    return _adapt(stacked_params, adapt_scope, adapt_steps, learning_rate, anchor_weight,
                  loss_fn)


def _blend_nn(base: Params, adapted: Params, alpha: float) -> Params:
    """theta_pop + alpha * (theta_adapted - theta_pop), NN group only."""
    out = dict(base)
    out["nn"] = {k: p0 + alpha * (adapted["nn"][k] - p0) for k, p0 in base["nn"].items()}
    return out


def _split(R: int, holdout_frac: float):
    n_hold = max(int(round(holdout_frac * R)), 3)
    return max(R - n_hold, 4)


def _holdout_inputs(subject_window, fit: int, R: int, device):
    """(y0, ts, controls, ctx_batch) of the forecast of the held-out reveal
    tail from the last fit observation."""
    t = lambda x: _tensor(x, device)[None]  # noqa: E731
    ts = t(subject_window["time_points"][fit - 1:R])
    ctrls = Controls(ts=ts, signals={k: t(v[fit - 1:R])
                                     for k, v in subject_window["external_inputs"].items()})
    ctx_batch = {"observations": t(subject_window["observations"][:fit]),
                 "time_points": t(subject_window["time_points"][:fit])}
    return t(subject_window["observations"][fit - 1]), ts, ctrls, ctx_batch


def guard_candidate_arms(
    params: Params,
    subject_window: Dict[str, np.ndarray],
    config: HybridConfig,
    reveal_points: int,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    holdout_frac: float = 0.25,
    state_index: int = 0,
    shrink_candidates: Sequence[float] = (0.25, 0.5, 1.0),
):
    """Measure the guard's candidate arms from REVEALED data only.

    Adapt on the first (1 - holdout_frac) of the reveal, forecast the
    held-out reveal tail from its left edge with every shrinkage blend
    theta_pop + alpha (theta_adapted - theta_pop), and return (arms,
    sqerrs): arms maps alpha -> candidate params (alpha 0.0 = the population
    model), sqerrs maps alpha -> per-point squared glucose errors on the
    holdout tail (f64 numpy)."""
    R = reveal_points
    fit = _split(R, holdout_frac)
    adapted_fit = adapt_subject(params, subject_window, config, fit, adapt_steps,
                                learning_rate, anchor_weight=anchor_weight,
                                adapt_scope=adapt_scope)
    y0, ts, ctrls, ctx_batch = _holdout_inputs(subject_window, fit, R, _device(params))
    obs = subject_window["observations"][fit:R, state_index]
    m = subject_window["mask"][fit:R] > 0

    @torch.no_grad()
    def tail_sqerr(p):
        ctl = with_context(p, ctx_batch, ctrls, config)
        pred = batched_forward(p, y0, ts, ctl, config)[0].cpu().numpy()
        err = pred[1:, state_index] - obs
        return (err[m] ** 2).astype(np.float64)

    arms = {0.0: params}
    sqerrs = {0.0: tail_sqerr(params)}
    for alpha in shrink_candidates:
        arms[alpha] = _blend_nn(params, adapted_fit, alpha)
        sqerrs[alpha] = tail_sqerr(arms[alpha])
    return arms, sqerrs


def _ucb(e: np.ndarray, k: float) -> float:
    """mean + k * sem of the holdout squared errors (inf below 2 points)."""
    n = len(e)
    return np.inf if n < 2 else e.mean() + k * e.std(ddof=1) / np.sqrt(n)


def adapt_subject_guarded(
    params: Params,
    subject_window: Dict[str, np.ndarray],
    config: HybridConfig,
    reveal_points: int,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    holdout_frac: float = 0.25,
    state_index: int = 0,
    shrink_candidates: Sequence[float] = (0.25, 0.5, 1.0),
    ucb_k: float = 2.0,
    **_legacy,
) -> Params:
    """Per-subject GUARDED adaptation: deploy the validated fit-adapted blend
    (no re-adaptation on the full reveal) whose holdout squared errors have
    the lowest UCB score mean + ucb_k * sem. The population arm carries
    almost no adaptation-induced variance penalty, so noisy short-reveal
    wins collapse to alpha = 0; horizons where even this is net-harmful are
    switched off at the policy level by `select_guard_policy`."""
    arms, sqerrs = guard_candidate_arms(
        params, subject_window, config, reveal_points, adapt_steps, learning_rate,
        anchor_weight=anchor_weight, adapt_scope=adapt_scope, holdout_frac=holdout_frac,
        state_index=state_index, shrink_candidates=shrink_candidates)
    best = min(sqerrs, key=lambda a: _ucb(sqerrs[a], ucb_k))
    return arms[best]


def _remainder_inputs(ds, w: int, reveal: int, config: HybridConfig, stop: int, device):
    """(ts, y0, controls, ctx_batch) for the re-anchored remainder rollout;
    the context prefix is padded with its last point up to context_points."""
    r0 = reveal - 1
    t = lambda x: _tensor(x, device)  # noqa: E731
    ts = t(ds.time_points[w:w + 1, r0:stop])
    y0 = t(ds.observations[w:w + 1, r0])
    controls = Controls(ts=ts, signals={"meal": t(ds.meal[w:w + 1, r0:stop]),
                                        "tVNS": t(ds.tvns[w:w + 1, r0:stop])})
    k = max(reveal, config.context_points)
    obs_r = np.asarray(ds.observations[w, :reveal])
    tp_r = np.asarray(ds.time_points[w, :reveal])
    if k > reveal:
        obs_r = np.concatenate([obs_r, np.repeat(obs_r[-1:], k - reveal, 0)])
        tp_r = np.concatenate([tp_r, np.repeat(tp_r[-1:], k - reveal, 0)])
    return ts, y0, controls, {"observations": t(obs_r[None]), "time_points": t(tp_r[None])}


@torch.no_grad()
def _forecast_preds(params, config, ts, y0, controls, ctx_batch) -> torch.Tensor:
    c = with_context(params, ctx_batch, controls, config)
    return batched_forward(params, y0, ts, c, config)[0]


def _remainder_rmse(preds: np.ndarray, ds, w: int, reveal: int, stop: int,
                    state_index: int) -> float:
    err = preds[1:, state_index] - ds.observations[w, reveal:stop, state_index]
    m = ds.mask[w, reveal:stop] > 0
    return float(np.sqrt(np.mean(err[m] ** 2))) if m.any() else float("nan")


def forecast_remainder_rmse(
    params: Params,
    ds,
    w: int,
    reveal: int,
    config: HybridConfig,
    state_index: int = 0,
    stop: Optional[int] = None,
) -> float:
    """Glucose RMSE (normalized units) of window w's remaining stream,
    re-anchored at the last revealed observation; a context-conditioned
    model encodes the subject from the revealed prefix only."""
    stop = len(ds.time_points[w]) if stop is None else stop
    inputs = _remainder_inputs(ds, w, reveal, config, stop, _device(params))
    preds = _forecast_preds(params, config, *inputs).cpu().numpy()
    return _remainder_rmse(preds, ds, w, reveal, stop, state_index)


@torch.no_grad()
def _member_preds(stacked: Params, config: HybridConfig, y0, ts, controls, ctx_batch):
    """Every member's forecast (K, T', n) on one subject's grid, each member
    encoding the subject with its own context head."""
    cfg = _ens._no_pallas(config)
    K = _ens._n_members(stacked)
    kts = _ens._members(ts, K)
    signals = {n: _ens._members(v, K) for n, v in controls.signals.items()}
    if cfg.context_points > 0 and "enc" in stacked:
        signals["context"] = _ens._member_codes(stacked["enc"], ctx_batch["observations"],
                                                ctx_batch["time_points"], cfg.context_points,
                                                cfg.activation)
    return batched_forward(_ens._member_view(stacked, 1), _ens._members(y0, K), kts,
                           Controls(ts=kts, signals=signals), cfg)[:, 0]


def ensemble_forecast_remainder_rmse(
    stacked_params: Params,
    ds,
    w: int,
    reveal: int,
    config: HybridConfig,
    state_index: int = 0,
    stop: Optional[int] = None,
) -> float:
    """Remainder RMSE of the ensemble-MEAN forecast."""
    stop = len(ds.time_points[w]) if stop is None else stop
    ts, y0, controls, ctx_batch = _remainder_inputs(ds, w, reveal, config, stop,
                                                    _device(stacked_params))
    preds_k = _member_preds(stacked_params, config, y0, ts, controls, ctx_batch)
    return _remainder_rmse(torch.mean(preds_k, dim=0).cpu().numpy(), ds, w, reveal, stop,
                           state_index)


def guard_candidate_arms_ensemble(
    stacked_params: Params,
    subject_window: Dict[str, np.ndarray],
    config: HybridConfig,
    reveal_points: int,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    holdout_frac: float = 0.25,
    state_index: int = 0,
    shrink_candidates: Sequence[float] = (0.25, 0.5, 1.0),
):
    """`guard_candidate_arms` for a population ensemble: every member adapts
    on the fit portion, the arms blend the PER-MEMBER deltas, and the holdout
    squared errors are scored on the ensemble-MEAN forecast (the deployed
    estimator). Returns (arms, sqerrs, member_sqerrs), the last (K, n_holdout)
    per alpha."""
    R = reveal_points
    fit = _split(R, holdout_frac)
    adapted_fit = adapt_subject_ensemble(
        stacked_params, subject_window, config, fit, adapt_steps, learning_rate,
        anchor_weight=anchor_weight, adapt_scope=adapt_scope)
    y0, ts, ctrls, ctx_batch = _holdout_inputs(subject_window, fit, R, _device(stacked_params))
    obs = subject_window["observations"][fit:R, state_index]
    m = subject_window["mask"][fit:R] > 0

    def member_preds(p):
        return _member_preds(p, config, y0, ts, ctrls, ctx_batch).cpu().numpy()

    def tail_sqerr_from(preds_k):
        err = preds_k.mean(axis=0)[1:, state_index] - obs
        return (err[m] ** 2).astype(np.float64)

    def member_sqerr_from(preds_k):
        err = preds_k[:, 1:, state_index] - obs[None]
        return (err[:, m] ** 2).astype(np.float64)

    arms = {0.0: stacked_params}
    preds0 = member_preds(stacked_params)
    sqerrs = {0.0: tail_sqerr_from(preds0)}
    member_sqerrs = {0.0: member_sqerr_from(preds0)}
    for alpha in shrink_candidates:
        arms[alpha] = _blend_nn(stacked_params, adapted_fit, alpha)
        preds_a = member_preds(arms[alpha])
        sqerrs[alpha] = tail_sqerr_from(preds_a)
        member_sqerrs[alpha] = member_sqerr_from(preds_a)
    return arms, sqerrs, member_sqerrs


def adapt_subject_guarded_ensemble(
    stacked_params: Params,
    subject_window: Dict[str, np.ndarray],
    config: HybridConfig,
    reveal_points: int,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    holdout_frac: float = 0.25,
    state_index: int = 0,
    shrink_candidates: Sequence[float] = (0.25, 0.5, 1.0),
    ucb_k: float = 0.5,
    blend_mode: str = "mean",
    **_legacy,
) -> Params:
    """Ensemble counterpart of `adapt_subject_guarded` (the same UCB rule on
    the ensemble-mean forecast's holdout errors). blend_mode='per_member':
    each member picks its OWN alpha by the UCB score of its own holdout
    forecast."""
    arms, sqerrs, member_sqerrs = guard_candidate_arms_ensemble(
        stacked_params, subject_window, config, reveal_points, adapt_steps, learning_rate,
        anchor_weight=anchor_weight, adapt_scope=adapt_scope, holdout_frac=holdout_frac,
        state_index=state_index, shrink_candidates=shrink_candidates)
    if blend_mode == "mean":
        return arms[min(sqerrs, key=lambda a: _ucb(sqerrs[a], ucb_k))]
    if blend_mode != "per_member":
        raise ValueError(f"unknown blend_mode {blend_mode!r}")
    K = member_sqerrs[0.0].shape[0]
    alphas = np.asarray([min(member_sqerrs, key=lambda a: _ucb(member_sqerrs[a][mi], ucb_k))
                         for mi in range(K)])
    a_max = max(a for a in arms if a > 0)
    adapted_full = arms[a_max]  # at alpha=1.0 these are the fit-adapted members
    a_col = torch.as_tensor(alphas / a_max, dtype=torch.float32,
                            device=_device(stacked_params))
    out = dict(stacked_params)
    out["nn"] = {k: p0 + a_col.reshape((K,) + (1,) * (p0.ndim - 1)) * (adapted_full["nn"][k] - p0)
                 for k, p0 in stacked_params["nn"].items()}
    return out


def _subject_window(ds, w: int) -> Dict[str, Any]:
    return {"observations": ds.observations[w], "time_points": ds.time_points[w],
            "external_inputs": {"meal": ds.meal[w], "tVNS": ds.tvns[w]}, "mask": ds.mask[w]}


def _reveal_at(ds, w: int, h: float) -> int:
    """Points revealed after h hours of window w, kept 4 points from either end."""
    reveal = int(np.searchsorted(ds.time_points[w], float(ds.time_points[w, 0]) + h))
    return int(np.clip(reveal, 4, len(ds.time_points[w]) - 4))


def ensemble_online_adaptation_eval(
    stacked_params: Params,
    ds,
    config: HybridConfig,
    horizons_hours: Sequence[float] = (6.0, 12.0, 24.0),
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    state_index: int = 0,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    window_indices: Optional[Sequence[int]] = None,
    guard: bool = False,
    ucb_k: float = 0.5,
    blend_mode: str = "mean",
    policy: Optional[Dict[float, Dict[str, Any]]] = None,
) -> Dict[float, float]:
    """`online_adaptation_eval` with a K-member population ensemble: every
    member adapts on the revealed window and the deployed forecast is the
    members' mean; guard=True applies the UCB shrinkage guard to the
    ensemble delta; `policy` overrides hyperparameters per horizon."""
    results: Dict[float, list] = {h: [] for h in horizons_hours}
    for w in (range(len(ds)) if window_indices is None else window_indices):
        window = _subject_window(ds, w)
        for h in horizons_hours:
            hp = dict(adapt_steps=adapt_steps, learning_rate=learning_rate,
                      anchor_weight=anchor_weight, adapt_scope=adapt_scope, guard=guard,
                      ucb_k=ucb_k, blend_mode=blend_mode)
            if policy and h in policy:
                hp.update(policy[h])
            reveal = _reveal_at(ds, w, h)
            if hp["adapt_steps"] > 0 and hp["guard"]:
                adapted = adapt_subject_guarded_ensemble(
                    stacked_params, window, config, reveal, hp["adapt_steps"],
                    hp["learning_rate"], anchor_weight=hp["anchor_weight"],
                    adapt_scope=hp["adapt_scope"], state_index=state_index,
                    ucb_k=hp["ucb_k"], blend_mode=hp["blend_mode"])
            elif hp["adapt_steps"] > 0:
                adapted = adapt_subject_ensemble(
                    stacked_params, window, config, reveal, hp["adapt_steps"],
                    hp["learning_rate"], anchor_weight=hp["anchor_weight"],
                    adapt_scope=hp["adapt_scope"])
            else:
                adapted = stacked_params
            rmse_n = ensemble_forecast_remainder_rmse(adapted, ds, w, reveal, config,
                                                      state_index)
            if np.isfinite(rmse_n):
                results[h].append(rmse_n * float(ds.state_std[state_index]))
    return {h: float(np.mean(v)) if v else float("nan") for h, v in results.items()}


def select_guard_policy(
    params: Params,
    ds,
    config: HybridConfig,
    horizons_hours: Sequence[float] = (6.0, 12.0, 24.0),
    window_indices: Optional[Sequence[int]] = None,
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    ucb_ks: Sequence[float] = (0.5, 2.0),
    t_min: float = 2.0,
    state_index: int = 0,
    verbose: bool = False,
):
    """Per-horizon guard meta-policy, selected on VALIDATION subjects: the
    guard is ENABLED at a horizon only when the true remaining-horizon RMSE
    of its best candidate (one per ucb_ks) improves on the population model
    with a paired t >= t_min; among enabled candidates the best mean wins.

    Returns (policy, table): policy maps horizon -> hyperparameters for
    `online_adaptation_eval`; table records the per-horizon, per-candidate
    validation measurements."""
    idx = list(range(len(ds))) if window_indices is None else list(window_indices)
    table: Dict[str, Dict] = {}
    policy: Dict[float, Dict[str, Any]] = {}
    for h in horizons_hours:
        picks: Dict[float, list] = {k: [] for k in ucb_ks}
        base_rems = []
        for w in idx:
            reveal = _reveal_at(ds, w, h)
            arms, sqerrs = guard_candidate_arms(
                params, _subject_window(ds, w), config, reveal, adapt_steps, learning_rate,
                anchor_weight=anchor_weight, adapt_scope=adapt_scope, state_index=state_index)
            chosen = {k: min(sqerrs, key=lambda a: _ucb(sqerrs[a], k)) for k in ucb_ks}
            rems = {a: forecast_remainder_rmse(arms[a], ds, w, reveal, config, state_index)
                    for a in {0.0} | set(chosen.values())}
            base_rems.append(rems[0.0])
            for k in ucb_ks:
                picks[k].append(rems[chosen[k]])
        base_arr = np.asarray(base_rems)
        table[str(h)] = {"no_adapt_val_rmse": round(float(base_arr.mean()), 4),
                         "n": len(idx), "candidates": {}}
        best_k, best_mean, best_t = None, np.inf, 0.0
        for k in ucb_ks:
            d = base_arr - np.asarray(picks[k])
            t_stat = float(d.mean() / (d.std(ddof=1) / np.sqrt(len(d)) + 1e-12))
            mean_rmse = float(np.mean(picks[k]))
            table[str(h)]["candidates"][f"ucb_k={k}"] = {
                "val_rmse": round(mean_rmse, 4),
                "paired_improvement": round(float(d.mean()), 4),
                "t": round(t_stat, 2),
            }
            if verbose:
                print(f"  guard-select h={h} k={k}: val {mean_rmse:.4f} "
                      f"(base {base_arr.mean():.4f}), t={t_stat:.2f}", flush=True)
            if mean_rmse < best_mean:
                best_k, best_mean, best_t = k, mean_rmse, t_stat
        enabled = best_t >= t_min and best_mean < float(base_arr.mean())
        table[str(h)]["selected"] = {"enabled": bool(enabled), "ucb_k": best_k,
                                     "t": round(best_t, 2)}
        policy[h] = ({"adapt_steps": adapt_steps, "learning_rate": learning_rate,
                      "anchor_weight": anchor_weight, "adapt_scope": adapt_scope,
                      "guard": True, "ucb_k": best_k}
                     if enabled else {"adapt_steps": 0})
    return policy, table


def online_adaptation_eval(
    params: Params,
    ds,
    config: HybridConfig,
    horizons_hours: Sequence[float] = (6.0, 12.0, 24.0),
    adapt_steps: int = 50,
    learning_rate: float = 1e-3,
    state_index: int = 0,
    anchor_weight: float = 1.0,
    adapt_scope: str = "nn",
    policy: Optional[Dict[float, Dict[str, Any]]] = None,
    window_indices: Optional[Sequence[int]] = None,
) -> Dict[float, float]:
    """Per-subject adaptation RMSE (physical units) at each reveal horizon:
    for each window, adapt on the observations within the horizon, then
    forecast the remainder re-anchored at the last revealed observation and
    measure the glucose RMSE there. policy: per-horizon hyperparameter
    overrides, e.g. {6.0: {'adapt_steps': 20, 'anchor_weight': 3.0,
    'adapt_scope': 'last'}} (`tune_online_policy`, `select_guard_policy`)."""
    results: Dict[float, list] = {h: [] for h in horizons_hours}
    for w in (range(len(ds)) if window_indices is None else window_indices):
        window = _subject_window(ds, w)
        for h in horizons_hours:
            hp = dict(adapt_steps=adapt_steps, learning_rate=learning_rate,
                      anchor_weight=anchor_weight, adapt_scope=adapt_scope, guard=False)
            if policy and h in policy:
                hp.update(policy[h])
            reveal = _reveal_at(ds, w, h)
            if hp["adapt_steps"] > 0 and hp["guard"]:
                adapted = adapt_subject_guarded(
                    params, window, config, reveal, hp["adapt_steps"], hp["learning_rate"],
                    anchor_weight=hp["anchor_weight"], adapt_scope=hp["adapt_scope"],
                    state_index=state_index, ucb_k=hp.get("ucb_k", 2.0))
            elif hp["adapt_steps"] > 0:
                adapted = adapt_subject(params, window, config, reveal, hp["adapt_steps"],
                                        hp["learning_rate"], anchor_weight=hp["anchor_weight"],
                                        adapt_scope=hp["adapt_scope"])
            else:
                adapted = params  # the no-adaptation baseline row
            rmse_n = forecast_remainder_rmse(adapted, ds, w, reveal, config, state_index)
            if np.isfinite(rmse_n):
                results[h].append(rmse_n * float(ds.state_std[state_index]))
    return {h: float(np.mean(v)) if v else float("nan") for h, v in results.items()}


def tune_online_policy(
    params: Params,
    val_ds,
    config: HybridConfig,
    horizons_hours: Sequence[float] = (6.0, 12.0, 24.0),
    candidates: Optional[Sequence[Dict[str, Any]]] = None,
    state_index: int = 0,
    window_indices: Optional[Sequence[int]] = None,
    verbose: bool = False,
) -> Dict[float, Dict[str, Any]]:
    """Pick per-horizon adaptation hyperparameters on VALIDATION subjects from
    a small grid that includes no adaptation (adapt_steps=0) and the
    conservative last-layer scope. Returns {horizon: hyperparameters}."""
    if candidates is None:
        candidates = [
            {"adapt_steps": 0},                                        # off
            {"adapt_steps": 20, "learning_rate": 5e-4,
             "anchor_weight": 3.0, "adapt_scope": "last"},             # gentle
            {"adapt_steps": 50, "learning_rate": 1e-3,
             "anchor_weight": 1.0, "adapt_scope": "last"},
            {"adapt_steps": 50, "learning_rate": 1e-3,
             "anchor_weight": 1.0, "adapt_scope": "nn"},
            {"adapt_steps": 100, "learning_rate": 1e-3,
             "anchor_weight": 0.3, "adapt_scope": "nn"},               # strong
        ]
    policy: Dict[float, Dict[str, Any]] = {}
    for h in horizons_hours:
        best, best_rmse = None, float("inf")
        for cand in candidates:
            r = online_adaptation_eval(params, val_ds, config, horizons_hours=(h,),
                                       state_index=state_index, policy={h: cand},
                                       window_indices=window_indices)[h]
            logger.info("tune h=%s cand=%s -> %.4f", h, cand, r)
            if verbose:
                print(f"  tune h={h} {cand} -> {r:.4f}", flush=True)
            if r < best_rmse:
                best, best_rmse = dict(cand), r
        policy[h] = best
    return policy
