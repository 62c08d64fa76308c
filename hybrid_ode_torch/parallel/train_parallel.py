"""Sharded training and cohort simulation over a device mesh.

Port of `hybrid_ode_tpu/parallel/train_parallel.py` to `torch.distributed`.
Data-parallel training: every rank holds the parameters (`replicate`) and
its shard of the batch (`shard_batch`). The JAX package's GSPMD program
computes the loss of the WHOLE batch; so does this step:

  * each rank's loss is its share of the global loss (`hybrid_loss(
    shards=)`): its sums over the global mask counts and physics points, the
    L2 term over the number of ranks. The physics intervals are one draw
    for the whole batch: every rank seeds its generator alike;
  * the shares' gradients are all-reduced with SUM (one flat buffer), so
    every rank holds the gradient of the global loss;
  * clip and Adam then run on identical gradients on every rank.

With `config.use_pallas` each rank runs the fused forward and hand-adjoint
kernels on its shard. `parallel_cohort_sim` integrates each rank's shard of
the subjects and gathers the trajectories in rank order.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from hybrid_ode_torch.models.hybrid import HybridConfig, forward, hybrid_loss
from hybrid_ode_torch.parallel.mesh import (
    DataShards,
    ShardedBatch,
    all_gather_cat,
    all_reduce_sum,
    all_reduce_tensors,
    axis_size,
    local_slice,
    mesh_device,
    shard_batch,
)
from hybrid_ode_torch.train.loop import Optimizer, TrainState, _global_norm, _leaves

METRICS = ("data", "physics", "reg")


def make_parallel_train_step(
    mesh,
    optimizer: Optimizer,
    config: HybridConfig,
    lambda1: float = 1.0,
    lambda2: float = 1.0,
    use_physics: bool = True,
    axis: str = "data",
) -> Callable:
    """A data-parallel train step with the contract of
    `train.loop.make_train_step`: (state, batch, generator) -> (state,
    metrics), updating the params `optimizer` is bound to in place.

    state.params must be equal on every rank (`replicate`); `batch` is this
    rank's `shard_batch` / `process_local_batch` result (a plain dict is
    sharded here, every rank passing the whole batch); `generator` is seeded
    alike on every rank. A batch that `shard_batch` replicated (its size does
    not divide the axis) is the whole batch on every rank: no reduction,
    each rank computes the unsharded step. Metrics are the global loss, its
    components, solver_success (over all windows) and grad_norm."""

    def step(state: TrainState, batch: Dict, generator: torch.Generator):
        if not isinstance(batch, ShardedBatch):
            batch = shard_batch(mesh, batch, axis)
        shards = DataShards(mesh, axis) if batch.axis == axis else None
        leaves = [t for _, _, t in _leaves(state.params)]
        for t in leaves:
            t.grad = None
        loss, comps = hybrid_loss(state.params, batch, generator, config, lambda1=lambda1,
                                  lambda2=lambda2, use_physics_loss=use_physics, shards=shards)
        loss.backward()
        with torch.no_grad():
            parts = torch.stack([loss.detach()] + [comps[k].detach() for k in METRICS]
                                + [comps["solver_success"].detach()])
            if shards is not None:
                grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
                for t, g in zip(leaves, all_reduce_tensors(mesh, axis, grads)):
                    t.grad = g
                local = batch["initial_state"].shape[0]
                parts = all_reduce_sum(mesh, axis, parts * parts.new_tensor(
                    [1.0] * (1 + len(METRICS)) + [local / batch.global_size]))
            gnorm = _global_norm([t.grad for t in leaves if t.grad is not None])
        optimizer.step()
        state.step += 1
        metrics = dict(zip(METRICS, parts[1:-1]))
        metrics.update(loss=parts[0], solver_success=parts[-1], grad_norm=gnorm)
        return state, metrics

    return step


def parallel_cohort_sim(mesh, config: HybridConfig, axis: str = "data") -> Callable:
    """sim(params, y0s, ts) -> (B, T, n) on every rank: each rank integrates
    its contiguous shard of the subjects y0s (B, n) (every rank passes all
    of them; B a multiple of the axis size) with `forward(mode='while')` on
    the shared grid ts (T,), and the shards are gathered in rank order. No
    traffic during the solve."""

    @torch.no_grad()
    def sim(params, y0s, ts):
        dev = mesh_device(mesh)
        y0s = torch.as_tensor(y0s, device=dev)
        ts = torch.as_tensor(ts, device=dev)
        if y0s.shape[0] % axis_size(mesh, axis):
            raise ValueError(f"parallel_cohort_sim: {y0s.shape[0]} subjects do not divide "
                             f"over mesh axis {axis!r} (size {axis_size(mesh, axis)})")
        local = y0s[local_slice(mesh, y0s.shape[0], axis)]
        out = forward(params, local, ts, None, config, mode="while")
        return all_gather_cat(mesh, axis, out, dim=0)

    return sim
