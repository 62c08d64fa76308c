"""Deep ensembles: K hybrid models trained, identified and evaluated in one pass.

Port of `hybrid_ode_tpu/parallel/ensemble.py`. The JAX package vmaps one
member's program over a member axis; here the member axis is written out,
so that all K members run the launches of one:

  * every parameter leaf carries a leading (K,): ODE scalars (K,), MLP
    weights (K, in, out), biases (K, out) (the layout of the JAX package's
    stacked pytree, so its checkpoints load as they are);
  * states are (K, B, n), times and control signals (K, B, T) (views of the
    shared batch's (B, T));
  * inside the field the ODE scalars are viewed (K, 1) (or (K, 1, 1) at the
    physics term's (K, B, P) points) and broadcast against the states, and
    the MLP products are batched (K, N, in) x (K, in, out) matmuls
    (`dynamics/residual.py::mlp_apply`);
  * a loss is a (K,) vector, one entry per member; one backward pass of its
    sum gives every member its own gradients, since members share nothing.

The path never reaches the fused RK4 kernels: `use_pallas` is switched off,
as the JAX package does (its kernel stages one weight set per launch).

Per-member training keeps the JAX protocol: clip by each member's global
norm, Adam with a cosine schedule on a per-member update count, and a member
whose loss or gradient norm is not finite skips its update (parameters,
moments and count stay), so it falls one step behind the others.

Across devices (`make_ensemble_train_step(mesh=)`) the members shard over
the mesh dim 'ens' with no traffic between its ranks, and on a 2D
(ens, data) mesh the batch shards over 'data', whose ranks sum their
gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import batch_iterator, batch_to_tensors, pad_batch
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.dynamics.residual import init_mlp_params, mlp_apply
from hybrid_ode_torch.models import hybrid
from hybrid_ode_torch.models.hybrid import (
    HybridConfig,
    _Adam,
    _frozen,
    _identification_window,
    _refine,
    _total,
    _window_misfit,
    batched_forward,
    context_features,
    forward_with_param_deltas,
    hybrid_field,
    init_hybrid_params,
    segment_batch,
)
from hybrid_ode_torch.parallel.mesh import (
    DataShards,
    ShardedBatch,
    all_gather_cat,
    all_reduce_sum,
    all_reduce_tensors,
    shard_batch,
)
from hybrid_ode_torch.train.loop import _leaves, _snapshot, trains
from hybrid_ode_torch.utils.device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]
Generators = Union[torch.Generator, Sequence[torch.Generator], None]


def _n_members(stacked: Params) -> int:
    return next(iter(stacked["ode"].values())).shape[0]


def _device(stacked: Params) -> torch.device:
    return next(iter(stacked["ode"].values())).device


def _no_pallas(config: HybridConfig) -> HybridConfig:
    return dataclasses.replace(config, use_pallas=False) if config.use_pallas else config


def _member_view(stacked: Params, nd: int) -> Params:
    """The stacked params with the ODE scalars (K,) viewed (K,) + (1,) * nd
    and the 'norm' leaves (K, n) viewed (K,) + (1,) * nd + (n,), so that they
    broadcast against states (K, ..., n) with nd axes after the member's."""
    out = dict(stacked)
    out["ode"] = {k: v.reshape(v.shape[:1] + (1,) * nd) for k, v in stacked["ode"].items()}
    if "norm" in stacked:
        out["norm"] = {k: v.reshape(v.shape[:1] + (1,) * nd + v.shape[1:])
                       for k, v in stacked["norm"].items()}
    return out


def _members(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, ...) -> a (K, B, ...) view."""
    return x.unsqueeze(0).expand((K,) + tuple(x.shape))


def _member_codes(enc: Mapping[str, torch.Tensor], observations, time_points, k: int,
                  activation: str) -> torch.Tensor:
    """Each member's own encoder on the shared windows: (K, B, C)."""
    feats = context_features(observations, time_points, k)
    return mlp_apply(enc, _members(feats, enc["w0"].shape[0]), activation)


def _member_controls(b: Mapping[str, Any], K: int, context: Optional[torch.Tensor],
                     ts: torch.Tensor) -> Optional[Controls]:
    """Controls on the members' (K, B, T) grids from the batch's external
    inputs (B, T), with the (K, B, C) codes as the 'context' signal."""
    signals = {n: _members(v, K) for n, v in (b.get("external_inputs") or {}).items()}
    if context is not None:
        signals["context"] = context
    if not signals:
        return None
    return Controls(ts=ts, signals=signals)


def _rollout_inputs(stacked: Params, b: Mapping[str, Any], config: HybridConfig):
    """(y0 (K, B, n), ts (K, B, T), controls) of a tensor batch, each
    member's context encoded from its own 'enc' head."""
    K = _n_members(stacked)
    ts = _members(b["time_points"], K)
    context = None
    if config.context_points > 0 and "enc" in stacked:
        context = _member_codes(stacked["enc"], b["observations"], b["time_points"],
                                config.context_points, config.activation)
    return _members(b["initial_state"], K), ts, _member_controls(b, K, context, ts)


# ---------------------------------------------------------------------------
# initialisation and prediction
# ---------------------------------------------------------------------------

def _stack(members: Sequence[Params]) -> Params:
    """K params trees of one structure -> one tree with (K,)-stacked leaves."""
    return {g: {n: torch.stack([m[g][n] for m in members]) for n in members[0][g]}
            for g in members[0]}


def init_ensemble(seed: int, config: HybridConfig, n_members: int,
                  ode_params: Optional[Mapping[str, float]] = None, norm_stats=None,
                  device="cuda") -> Params:
    """Stacked params: member i drawn by `init_hybrid_params` from its own
    CPU generator, seeded with the i-th word of numpy's SeedSequence(seed).
    Members differ by their init draws only (and by their physics-term
    draws in training)."""
    dev = resolve_device(device)
    seeds = np.random.SeedSequence(seed).generate_state(n_members)
    return _stack([
        init_hybrid_params(torch.Generator().manual_seed(int(s)), config, ode_params,
                           norm_stats=norm_stats, device=dev)
        for s in seeds])


def member_params(stacked: Params, i: int) -> Params:
    """Member i's (unstacked) params tree."""
    return {g: {n: v[i] for n, v in grp.items()} for g, grp in stacked.items()}


def ensemble_forward(stacked: Params, batch: Mapping[str, Any],
                     config: HybridConfig) -> torch.Tensor:
    """All members' trajectories for one batch: (K, B, T, n), each member
    conditioned on its own context encoding; one batched solve."""
    cfg = _no_pallas(config)
    b = batch_to_tensors(batch, _device(stacked))
    y0, ts, controls = _rollout_inputs(stacked, b, cfg)
    return batched_forward(_member_view(stacked, 1), y0, ts, controls, cfg)


def _predictive(trajs: torch.Tensor, noise_sigma) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.mean(trajs, dim=0)
    # the population variance about this mean (as jnp.var): where the
    # members agree (the initial point) the spread then matches the mean's
    # rounding, and the interval still covers the observation
    var = torch.mean((trajs - mean) ** 2, dim=0)
    if noise_sigma is not None:
        var = var + torch.as_tensor(noise_sigma, dtype=var.dtype, device=var.device) ** 2
    return mean, torch.sqrt(var)


@torch.no_grad()
def ensemble_predictive(stacked: Params, batch: Mapping[str, Any], config: HybridConfig,
                        noise_sigma=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean and std over members, (B, T, n) each: the member
    mean, and the root of the members' population variance plus
    noise_sigma ** 2 (per state (n,) or scalar; observation noise in
    quadrature)."""
    return _predictive(ensemble_forward(stacked, batch, config), noise_sigma)


def collect_ensemble_predictive(stacked: Params, ds, config: HybridConfig, noise_sigma=None,
                                batch_size: int = 8):
    """(mean, std, targets, masks) numpy arrays over a dataset split, in
    dataset order; per-channel masks where the dataset carries them."""
    preds, uncs, targs, masks = [], [], [], []
    for batch in batch_iterator(ds, batch_size, shuffle=False):
        b, valid = pad_batch(batch, batch_size)
        nb = int(valid.sum())
        mean, std = ensemble_predictive(stacked, b, config, noise_sigma=noise_sigma)
        preds.append(mean.cpu().numpy()[:nb])
        uncs.append(std.cpu().numpy()[:nb])
        targs.append(np.asarray(b["observations"])[:nb])
        masks.append(np.asarray(b.get("mask_channels", b["mask"]))[:nb])
    return (np.concatenate(preds), np.concatenate(uncs), np.concatenate(targs),
            np.concatenate(masks))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _physics_index(generators: Generators, K: int, n_intervals: int, n_pts: int,
                   device: torch.device) -> torch.Tensor:
    """(K, n_pts) interval indices of the physics term: member i's from
    generators[i], or one draw for every member from a single generator."""
    if isinstance(generators, Sequence):
        idx = torch.stack([hybrid.physics_indices(g, n_intervals, n_pts) for g in generators])
    else:
        idx = _members(hybrid.physics_indices(generators, n_intervals, n_pts), K)
    return idx.to(device)


def _per_point(controls: Optional[Controls], n_pts: int) -> Optional[Controls]:
    """Member controls (K, B, ...) broadcast to the physics points (K, B, P, ...)."""
    if controls is None:
        return None

    def at_points(v):
        return v[:, :, None].expand(v.shape[:2] + (n_pts,) + v.shape[2:])

    return Controls(ts=at_points(controls.ts),
                    signals={k: at_points(v) for k, v in controls.signals.items()})


def _member_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.reshape(x.shape[0], -1), dim=1)


def _member_mean(x: torch.Tensor, shards) -> torch.Tensor:
    """Each member's mean of x (K, ...), or its shard's share of the mean
    over all shards' elements."""
    if shards is None:
        return torch.mean(x.reshape(x.shape[0], -1), dim=1)
    return _member_sum(x) / shards.total(x[0].numel())


def ensemble_loss(
    stacked: Params,
    batch: Mapping[str, torch.Tensor],
    generators: Generators = None,
    config: HybridConfig = HybridConfig(),
    lambda1: float = 1.0,
    lambda2: float = 1.0,
    use_physics_loss: bool = True,
    shards=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`hybrid_loss` of every member on a shared batch: (K,) totals and (K,)
    components {'data', 'physics', 'reg', 'solver_success'}, each term
    reduced per member with the single-model loss's masks and weights. The
    physics term's intervals come from `generators` (one per member, or one
    draw for all). shards: the batch is this rank's shard of one sharded
    over a mesh dim; each term is its share of the whole batch's, as in
    `hybrid_loss(shards=)`."""
    cfg = _no_pallas(config)
    if cfg.shooting_segments > 1:
        batch = segment_batch(batch, cfg.shooting_segments)
    K = _n_members(stacked)
    obs = batch["observations"]
    y0, ts, controls = _rollout_inputs(stacked, batch, cfg)
    view = _member_view(stacked, 1)
    if hybrid._has_step_stats(cfg):
        preds, stats = batched_forward(view, y0, ts, controls, cfg, return_stats=True)
        solver_success = torch.mean(stats.success.to(preds.dtype), dim=1)
    else:
        preds = batched_forward(view, y0, ts, controls, cfg)
        solver_success = torch.ones((K,), dtype=preds.dtype, device=preds.device)

    w_state = batch.get("loss_weights")
    se = (preds - obs) ** 2
    if w_state is not None:
        se = se * w_state
    mask = batch.get("mask")
    mask_ch = batch.get("mask_channels")
    if mask_ch is not None:
        data_loss = _member_sum(mask_ch * se) / (_total(torch.sum(mask_ch), shards) + 1e-8)
    elif mask is None:
        data_loss = _member_mean(se, shards)
    else:
        w = mask[..., None]
        data_loss = _member_sum(w * se) / (_total(torch.sum(w), shards) * obs.shape[-1] + 1e-8)

    zeros = torch.zeros((K,), dtype=preds.dtype, device=preds.device)
    physics_loss = zeros
    if use_physics_loss and lambda1 > 0:
        T = obs.shape[1]
        n_pts = min(cfg.n_physics_points, T - 1)
        idx = _physics_index(generators, K, T - 1, n_pts, preds.device)  # (K, P)
        B = obs.shape[0]
        it = idx[:, None, :].expand(K, B, n_pts)
        iy = it[..., None].expand(K, B, n_pts, preds.shape[-1])
        t_l, t_r = torch.gather(ts, 2, it), torch.gather(ts, 2, it + 1)
        y_l, y_r = torch.gather(preds, 2, iy), torch.gather(preds, 2, iy + 1)
        dt = (t_r - t_l)[..., None]
        fd = (y_r - y_l) / torch.where(dt == 0, torch.ones_like(dt), dt)
        rhs = hybrid_field(0.5 * (t_l + t_r), 0.5 * (y_l + y_r), _member_view(stacked, 2),
                           _per_point(controls, n_pts), cfg)
        pe = (fd - rhs) ** 2
        if w_state is not None:
            pe = pe * w_state
        physics_loss = _member_mean(pe, shards)

    reg_loss = zeros
    if lambda2 > 0 and cfg.use_nn:
        reg_loss = lambda2 * sum(_member_sum(v * v) for k, v in stacked["nn"].items()
                                 if k.startswith("w"))
        if shards is not None:
            reg_loss = reg_loss / shards.size

    total = data_loss + lambda1 * physics_loss + lambda2 * reg_loss
    return total, {"data": data_loss, "physics": physics_loss, "reg": reg_loss,
                   "solver_success": solver_success}


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K,) -> (K, 1, ..., 1) against a leaf of `like`'s rank."""
    return x.reshape(x.shape[:1] + (1,) * (like.ndim - 1))


class EnsembleOptimizer:
    """The single-model optimizer (`train/loop.py`: global-norm clip, Adam
    b1 0.9, b2 0.999, eps 1e-8, cosine decay of the learning rate, frozen
    groups) applied to each member on its own: the clip norm, the update
    count of the bias correction and of the schedule are per member (K,)."""

    def __init__(self, learning_rate: float, decay_steps: int, gradient_clip: float = 5.0,
                 train_ode_params=False, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.decay_steps = max(1, decay_steps)
        self.gradient_clip = gradient_clip
        self.train_ode_params = train_ode_params
        self.b1, self.b2, self.eps = b1, b2, eps

    def trains(self, group: str, name: str) -> bool:
        return trains(self.train_ode_params, group, name)

    def init(self, stacked: Params) -> Dict[str, Any]:
        """{'count' (K,) int32, 'mu', 'nu'}: moments of the trainable leaves."""
        mu: Params = {}
        nu: Params = {}
        for g, n, t in _leaves(stacked):
            if self.trains(g, n):
                mu.setdefault(g, {})[n] = torch.zeros_like(t, requires_grad=False)
                nu.setdefault(g, {})[n] = torch.zeros_like(t, requires_grad=False)
        count = torch.zeros((_n_members(stacked),), dtype=torch.int32, device=_device(stacked))
        return {"count": count, "mu": mu, "nu": nu}

    @torch.no_grad()
    def update(self, stacked: Params, grads: Params, state: Dict[str, Any],
               ok: torch.Tensor) -> None:
        """One update of every member whose `ok` is set, in place on the
        params and on `state`; the others keep params, moments and count."""
        train = [(g, n) for g, n, _ in _leaves(stacked) if self.trains(g, n)]
        if not train:
            return
        gs = {(g, n): grads[g][n] for g, n in train}
        if self.gradient_clip > 0:
            norm = torch.sqrt(sum(_member_sum(x * x) for x in gs.values()))
            trigger = norm < self.gradient_clip  # as optax: a NaN norm clips too
            gs = {key: torch.where(_per_member(trigger, x), x,
                                   (x / _per_member(norm, x)) * self.gradient_clip)
                  for key, x in gs.items()}
        count = state["count"]
        c_new = (count + 1).to(torch.float32)
        cnt = torch.clamp(count, max=self.decay_steps).to(torch.float32)
        lr = self.learning_rate * (0.5 * (1.0 + torch.cos(math.pi * cnt / self.decay_steps)))
        bc1 = 1.0 - torch.pow(torch.full_like(c_new, self.b1), c_new)
        bc2 = 1.0 - torch.pow(torch.full_like(c_new, self.b2), c_new)
        for (g, n), grad in gs.items():
            p, mu, nu = stacked[g][n], state["mu"][g][n], state["nu"][g][n]
            mu_new = (1.0 - self.b1) * grad + self.b1 * mu
            nu_new = (1.0 - self.b2) * grad ** 2 + self.b2 * nu
            upd = ((mu_new / _per_member(bc1, p))
                   / (torch.sqrt(nu_new / _per_member(bc2, p)) + self.eps))
            keep = _per_member(ok, p)
            p.copy_(torch.where(keep, p + _per_member(-lr, p) * upd, p))
            mu.copy_(torch.where(keep, mu_new, mu))
            nu.copy_(torch.where(keep, nu_new, nu))
        state["count"] = torch.where(ok, count + 1, count)


def make_ensemble_optimizer(learning_rate: float, epochs: int, steps_per_epoch: int,
                            gradient_clip: float = 5.0,
                            train_ode_params=False) -> EnsembleOptimizer:
    """`train/loop.py::make_optimizer`'s settings, per member."""
    return EnsembleOptimizer(learning_rate, epochs * steps_per_epoch, gradient_clip,
                             train_ode_params)


@dataclasses.dataclass
class EnsembleState:
    params: Params           # (K,)-stacked leaves requiring grad, updated in place
    opt_state: Dict[str, Any]
    step: torch.Tensor       # (K,) int32


def _trainable_copy(stacked: Params) -> Params:
    return {g: {n: v.detach().to(torch.float32).clone().requires_grad_(True)
                for n, v in grp.items()} for g, grp in stacked.items()}


def init_ensemble_state(optimizer: EnsembleOptimizer, stacked: Params) -> EnsembleState:
    """Trainable copies of the stacked params, zero moments and counts."""
    params = _trainable_copy(stacked)
    return EnsembleState(params=params, opt_state=optimizer.init(params),
                         step=torch.zeros((_n_members(params),), dtype=torch.int32,
                                          device=_device(params)))


def make_ensemble_train_step(optimizer: EnsembleOptimizer, config: HybridConfig,
                             lambda1: float = 0.0, lambda2: float = 0.01,
                             use_physics: bool = False, mesh=None, member_axis: str = "ens",
                             data_axis: Optional[str] = None):
    """(state, batch, generators) -> (state, metrics): one update of ALL
    members in one pass. `batch` is shared (tensors, unstacked);
    `generators` are one CPU generator per member, so that members draw
    their own physics-term intervals. Metrics are (K,) each: the loss
    components, 'loss', 'grad_norm' (all leaves) and 'update_ok' (a member
    whose loss or gradient norm is not finite skips its update).

    mesh: the members are sharded over its dim `member_axis`: each rank's
    state holds its K / size members (`shard_batch(mesh, stacked,
    member_axis)` before `init_ensemble_state`) and `generators` theirs;
    the metrics are gathered over the dim in rank order, (K,) on every rank.
    No traffic crosses `member_axis` during the update. data_axis: a 2D
    (ens, data) mesh's batch dim; the batch is sharded over it (a plain dict
    here by `shard_batch`), each member's loss is its shard's share of the
    whole batch's (`ensemble_loss(shards=)`) and the gradients are summed
    over the dim before the per-member clip and the non-finite skip."""

    def step(state: EnsembleState, batch: Mapping[str, torch.Tensor], generators):
        shards = None
        if mesh is not None and data_axis is not None:
            if not isinstance(batch, ShardedBatch):
                batch = shard_batch(mesh, batch, data_axis)
            if batch.axis == data_axis:
                shards = DataShards(mesh, data_axis)
        leaves = list(_leaves(state.params))
        losses, comps = ensemble_loss(state.params, batch, generators, config,
                                      lambda1=lambda1, lambda2=lambda2,
                                      use_physics_loss=use_physics, shards=shards)
        grads = torch.autograd.grad(torch.sum(losses), [t for _, _, t in leaves],
                                    allow_unused=True)
        tree: Params = {}
        for (g, n, t), gr in zip(leaves, grads):
            tree.setdefault(g, {})[n] = torch.zeros_like(t) if gr is None else gr
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in comps.items()}
            metrics["loss"] = losses.detach()
            if shards is not None:
                flat = [x for grp in tree.values() for x in grp.values()]
                for x, y in zip(flat, all_reduce_tensors(mesh, data_axis, flat)):
                    x.copy_(y)
                share = batch["initial_state"].shape[0] / batch.global_size
                metrics["solver_success"] = metrics["solver_success"] * share
                keys = sorted(metrics)
                summed = all_reduce_sum(mesh, data_axis, torch.stack([metrics[k] for k in keys]))
                metrics = dict(zip(keys, summed))
            gnorm = torch.sqrt(sum(_member_sum(x * x) for grp in tree.values()
                                   for x in grp.values()))
            ok = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        optimizer.update(state.params, tree, state.opt_state, ok)
        state.step = state.step + 1
        metrics.update(grad_norm=gnorm, update_ok=ok)
        if mesh is not None:
            metrics = {k: all_gather_cat(mesh, member_axis, v) for k, v in metrics.items()}
        return state, metrics

    return step


def train_ensemble(
    stacked_params: Params,
    optimizer: EnsembleOptimizer,
    config: HybridConfig,
    train_batches,
    val_batches,
    seed: int,
    epochs: int,
    lambda1: float = 0.0,
    lambda2: float = 0.01,
    use_physics: bool = False,
    eval_every: int = 20,
    generators: Optional[Sequence[torch.Generator]] = None,
):
    """Host loop training all K members, each keeping the params of its own
    best validation epoch (the single model's selection protocol).

    The batches (numpy or tensor dicts) are composed once by the caller; their
    ORDER is permuted every epoch by `np.random.default_rng(seed)`, as the JAX
    package does with the last word of its key (`seed` for PRNGKey(seed)).
    Validation runs at epochs divisible by `eval_every` and at the last; its
    physics intervals are one draw shared by the members. `generators` (one
    per member; default from `seed`) draw the training physics intervals.
    Returns (best_params, best_val (K,) numpy, final metrics numpy); with no
    validation batches the final params and NaN best values."""
    K = _n_members(stacked_params)
    dev = _device(stacked_params)
    step = make_ensemble_train_step(optimizer, config, lambda1, lambda2, use_physics)
    state = init_ensemble_state(optimizer, stacked_params)
    # one generator per member for training, one for validation
    *member_gens, val_gen = [torch.Generator().manual_seed(int(s))
                             for s in np.random.SeedSequence(seed).generate_state(K + 1)]
    generators = list(generators) if generators is not None else member_gens
    train_batches = [batch_to_tensors(b, dev) for b in train_batches]
    val_batches = [batch_to_tensors(b, dev) for b in (val_batches or [])]
    best_params = _snapshot(state.params)
    best_val = torch.full((K,), float("inf"), device=dev)
    metrics: Dict[str, torch.Tensor] = {}
    order_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        for bi in order_rng.permutation(len(train_batches)):
            state, metrics = step(state, train_batches[int(bi)], generators)
        if val_batches and (epoch % eval_every == 0 or epoch == epochs - 1):
            with torch.no_grad():
                vl = torch.mean(torch.stack([
                    ensemble_loss(state.params, vb, val_gen, config, lambda1=lambda1,
                                  lambda2=lambda2, use_physics_loss=use_physics)[0]
                    for vb in val_batches]), dim=0)
                improved = vl < best_val
                best_val = torch.where(improved, vl, best_val)
                for g, n, t in _leaves(state.params):
                    best_params[g][n] = torch.where(_per_member(improved, t), t.detach(),
                                                    best_params[g][n])
    if not val_batches:
        best_params = _snapshot(state.params)
        best_val = torch.full((K,), float("nan"))
    return (best_params, best_val.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# test-time identification
# ---------------------------------------------------------------------------

def _members_window(stacked: Params, batch, k: int):
    """The identification window on the members' axes: y0 (K, B, n), obs_k
    (B, k, n), ts_k (K, B, k), signals (K, B, k), mask_k, denom, w_state."""
    K = _n_members(stacked)
    y0, obs_k, ts_k, sig_k, mask_k, denom, w_state = _identification_window(stacked, batch, k)
    return (_members(y0, K), obs_k, _members(ts_k, K),
            {n: _members(v, K) for n, v in sig_k.items()}, mask_k, denom, w_state)


def identify_ensemble_context(
    stacked: Params,
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    steps: int = 150,
    lr: float = 0.02,
    prior_std: float = 0.3,
    points: Optional[int] = None,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-member test-time identification (`models/hybrid.py::identify_context`
    for every member at once, each member frozen): (K, B, ctx_dim) codes.
    Each (member, window) keeps the iterate with the lowest data misfit it
    ever had. `init`: optional (K, B, ctx_dim) starting codes (e.g.
    `encode_ensemble_context`'s), else each member's encoder's, else zeros."""
    cfg = _no_pallas(config)
    k = points if points is not None else cfg.context_points
    if k <= 0:
        raise ValueError("identify_ensemble_context requires context_points > 0")
    params = _frozen(stacked)
    K = _n_members(params)
    y0, obs_k, ts_k, sig_k, mask_k, denom, w_state = _members_window(params, batch, k)
    dev = obs_k.device
    if init is not None:
        ctx0 = torch.as_tensor(init, device=dev).detach()
    elif "enc" in params:
        ctx0 = _member_codes(params["enc"], torch.as_tensor(batch["observations"], device=dev),
                             torch.as_tensor(batch["time_points"], device=dev),
                             cfg.context_points, cfg.activation)
    else:
        dim = len(cfg.context_params) if cfg.context_mode == "params" else cfg.context_dim
        ctx0 = torch.zeros((K, obs_k.shape[0], dim), dtype=obs_k.dtype, device=dev)
    view = _member_view(params, 1)

    def data_vec(ctx):
        return _window_misfit(lambda c: batched_forward(view, y0, ts_k, c, cfg), obs_k, ts_k,
                              dict(sig_k, context=ctx), mask_k, denom, w_state)

    def trust(ctx):
        return torch.mean((ctx - ctx0) ** 2, dim=-1) / (2.0 * prior_std ** 2)

    return _refine(ctx0, data_vec, trust, steps, lr)


def identify_ensemble_params(
    stacked: Params,
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    contexts: Optional[torch.Tensor] = None,
    steps: int = 150,
    lr: float = 0.02,
    prior_std: float = 0.1,
    points: Optional[int] = None,
) -> torch.Tensor:
    """Per-member refinement of log-scale multipliers on ALL mechanistic
    parameters (`models/hybrid.py::identify_params` for every member at
    once): (K, B, P) deltas for each member's sorted ODE parameter names,
    optionally on top of (K, B, ctx_dim) `contexts`."""
    cfg = _no_pallas(config)
    k = points if points is not None else max(cfg.context_points, 12)
    params = _frozen(stacked)
    K = _n_members(params)
    y0, obs_k, ts_k, sig_k, mask_k, denom, w_state = _members_window(params, batch, k)
    if contexts is not None:
        sig_k["context"] = torch.as_tensor(contexts, device=obs_k.device).detach()
    view = _member_view(params, 1)

    def data_vec(deltas):
        return _window_misfit(
            lambda c: forward_with_param_deltas(view, deltas, y0, ts_k, c, cfg),
            obs_k, ts_k, sig_k, mask_k, denom, w_state)

    def trust(deltas):
        return torch.mean(deltas ** 2, dim=-1) / (2.0 * prior_std ** 2)

    d0 = torch.zeros((K, obs_k.shape[0], len(params["ode"])), dtype=obs_k.dtype,
                     device=obs_k.device)
    return _refine(d0, data_vec, trust, steps, lr)


def encode_ensemble_context(enc_params: Mapping[str, torch.Tensor], observations: torch.Tensor,
                            time_points: torch.Tensor, k: int, n_members: int, ctx_dim: int,
                            activation: str = "relu") -> torch.Tensor:
    """A shared amortised encoder for a K-member ensemble: one MLP pass maps
    each window's first k observations to every member's code, (K, B, ctx_dim)
    (its output head is K * ctx_dim wide: each member's latent space is its
    own)."""
    flat = mlp_apply(enc_params, context_features(observations, time_points, k), activation)
    B = flat.shape[0]
    return flat.reshape(B, n_members, ctx_dim).permute(1, 0, 2)


def identified_ensemble_predictive(
    stacked: Params,
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    id_steps: int = 150,
    id_lr: float = 0.02,
    prior_std: float = 0.3,
    points: Optional[int] = None,
    encoder: Optional[Mapping[str, torch.Tensor]] = None,
    noise_sigma=None,
    refine_params: bool = False,
    param_steps: int = 150,
    param_prior_std: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean and std (B, T, n) of the IDENTIFIED ensemble: each
    member's subject codes refined at test time on the window's first
    `points` observations, then per-member rollouts conditioned on them.

    `encoder` (an `amortize_ensemble_encoder` result) starts every member's
    codes from one MLP pass (the semi-amortised path). `refine_params`
    further refines per-window multipliers on all mechanistic parameters
    after the codes (`param_steps` steps, trust region `param_prior_std`)."""
    if config.context_points <= 0:
        raise ValueError("identified ensemble requires context_points > 0 "
                         "(params-mode subject conditioning)")
    cfg = _no_pallas(config)
    K = _n_members(stacked)
    b = batch_to_tensors(batch, _device(stacked))
    init = None
    if encoder is not None:
        init = encode_ensemble_context(encoder, b["observations"], b["time_points"],
                                       cfg.context_points, K, cfg.context_dim, cfg.activation)
    ctxs = identify_ensemble_context(stacked, b, cfg, steps=id_steps, lr=id_lr,
                                     prior_std=prior_std, points=points, init=init)
    deltas = None
    if refine_params:
        deltas = identify_ensemble_params(stacked, b, cfg, contexts=ctxs, steps=param_steps,
                                          lr=id_lr, prior_std=param_prior_std, points=points)
    params = _frozen(stacked)
    view = _member_view(params, 1)
    ts = _members(b["time_points"], K)
    controls = _member_controls(b, K, ctxs, ts)
    y0 = _members(b["initial_state"], K)
    with torch.no_grad():
        if deltas is not None:
            trajs = forward_with_param_deltas(view, deltas, y0, ts, controls, cfg)
        else:
            trajs = batched_forward(view, y0, ts, controls, cfg)
    return _predictive(trajs, noise_sigma)


def amortize_ensemble_encoder(
    stacked_params: Params,
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    points: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    id_steps: int = 150,
    id_lr: float = 0.02,
    prior_std: float = 0.3,
    hidden: int = 128,
    n_layers: int = 2,
    epochs: int = 3000,
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    val_frac: float = 0.15,
    targets: Optional[torch.Tensor] = None,
    init_encoder: Optional[Mapping[str, torch.Tensor]] = None,
    permutation: Optional[torch.Tensor] = None,
):
    """Distil the members' `identify_ensemble_context` into ONE shared
    encoder with a K * ctx_dim head (`encode_ensemble_context`), so that
    deployment pays one MLP pass and a few refinement steps.

    The targets are each member's identified codes on `batch` (a simulated
    cohort) with the models frozen, or `targets` (K, B, D). AdamW regresses
    them; a `val_frac` split keeps the iterate with the best held-out code
    MSE. `generator` (a CPU generator, default seed 0) draws the encoder's
    initial weights, then the split's permutation; `init_encoder` and
    `permutation` supply them instead. Returns (enc_params, info)."""
    cfg = _no_pallas(config)
    k = points if points is not None else cfg.context_points
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    dev = _device(stacked_params)
    K = _n_members(stacked_params)
    if targets is None:
        targets = identify_ensemble_context(stacked_params, batch, cfg, steps=id_steps,
                                            lr=id_lr, prior_std=prior_std, points=k)
    targets = torch.as_tensor(targets, device=dev).detach()
    _, B, D = targets.shape
    tgt_flat = targets.permute(1, 0, 2).reshape(B, K * D)
    obs = torch.as_tensor(batch["observations"], device=dev)
    ts = torch.as_tensor(batch["time_points"], device=dev)
    feats = context_features(obs, ts, k)

    if init_encoder is not None:
        enc = {n: torch.as_tensor(v, device=dev).detach().clone() for n, v in init_encoder.items()}
    else:
        enc = init_mlp_params(generator, feats.shape[-1], hidden, K * D, n_layers,
                              dtype=obs.dtype, device=dev)
    names = sorted(enc)
    for v in enc.values():
        v.requires_grad_(True)
    n_val = max(1, int(val_frac * B))
    perm = (torch.randperm(B, generator=generator) if permutation is None
            else torch.as_tensor(permutation)).to(dev)
    tr_idx, va_idx = perm[n_val:], perm[:n_val]

    def loss_fn(idx):
        return torch.mean((mlp_apply(enc, feats[idx], cfg.activation) - tgt_flat[idx]) ** 2)

    opt = _Adam([enc[n] for n in names], lr, weight_decay=weight_decay)
    best, best_val = {n: enc[n].detach().clone() for n in names}, float("inf")
    for _ in range(epochs):
        opt.step(torch.autograd.grad(loss_fn(tr_idx), [enc[n] for n in names]))
        with torch.no_grad():
            v = float(loss_fn(va_idx))
        if v < best_val:
            best, best_val = {n: enc[n].detach().clone() for n in names}, v
    info = {"val_code_mse": best_val, "target_std": float(torch.std(targets, unbiased=False)),
            "n_windows": int(B), "n_members": int(K)}
    return best, info


def prune_members(stacked: Params, best_val, factor: float = 5.0, min_keep: int = 2) -> Params:
    """Drop diverged members: keep those whose best validation loss is at
    most `factor` times the best member's, and always the `min_keep` best
    (in their original order). Returns the pruned stacked params."""
    bv = np.asarray(best_val, np.float64)
    keep = np.where(bv <= factor * bv.min())[0]
    if len(keep) < min_keep:
        keep = np.sort(np.argsort(bv)[:min_keep])
    if len(keep) == len(bv):
        return stacked
    idx = torch.as_tensor(keep, device=_device(stacked))
    return {g: {n: v.index_select(0, idx) for n, v in grp.items()} for g, grp in stacked.items()}
