"""Training steps of the hybrid model in plain PyTorch, resumed from a
checkpoint's Adam state.

One step: context codes from the encoder, RK4 trajectories, the loss

    data MSE (masked, state-weighted) + lambda2 * (lambda2 * sum of squared MLP weights)

(the recipe's physics term is off), gradients of every trainable leaf by
autograd, one clip of their global norm to `clip` (scaled by clip / norm
where norm >= clip), then Adam (b1 0.9, b2 0.999, eps 1e-8 added to the
bias-corrected root; bias corrections by the update's number counted from
the saved count) at lr * (1 + cos(pi k / decay_steps)) / 2, k the saved
schedule count plus the updates taken.

The saved state is the JAX optimizer's: multi_transform({'train':
chain(clip, adam(schedule)), 'freeze': ...}), written as nested tuples
(((clip state, ((count, mu, nu), (schedule count,))),), ...); a frozen
leaf's moment is an empty tuple.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference import model

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss_fn(params, batch, recipe, arith=model.F32) -> torch.Tensor:
    ctx = None
    if "enc" in params:
        ctx = model.encode(params["enc"], batch["observations"], batch["time_points"],
                           recipe["context_points"], arith)
    preds = model.rk4(batch["initial_state"], batch["time_points"], batch["meal"],
                      batch["tvns"], ctx, params["ode"], params["nn"], recipe["substeps"], arith)
    lam2 = recipe["lambda2"]
    return (model.data_loss(preds, batch["observations"], batch["mask"], batch["loss_weights"])
            + lam2 * (lam2 * model.l2(params["nn"])))


def saved_adam(opt_state, device):
    """(count, schedule count, mu, nu) of a saved JAX optimizer state; the
    moments as {(group, name): tensor} of the leaves that train."""
    (_clip, ((count, mu, nu), (sched,))), = opt_state[0]["train"]

    def leaves(tree):
        return {(g, n): torch.as_tensor(v, dtype=torch.float32).to(device)
                for g, grp in tree.items() for n, v in grp.items() if not isinstance(v, tuple)}

    return int(count), int(sched), leaves(mu), leaves(nu)


def train_steps(params0: Dict[str, Dict[str, torch.Tensor]], batches: List[Dict],
                recipe: Dict, saved, arith=model.F32):
    """Run len(batches) updates from params0 (not modified) and the saved
    Adam state `saved` (`saved_adam`). Returns (losses [float], the first
    update's clipped gradient {(group, name): tensor}, the parameters after
    the last update {(group, name): tensor})."""
    count0, sched0, mu0, nu0 = saved
    leaves = {(g, n): v.detach().clone().requires_grad_(True)
              for g, grp in params0.items() for n, v in grp.items()
              if g != "norm" and (g != "ode" or recipe["train_ode_params"])}
    frozen = {(g, n): v for g, grp in params0.items() for n, v in grp.items()
              if (g, n) not in leaves}
    m = {k: mu0[k].clone() for k in leaves}
    s = {k: nu0[k].clone() for k in leaves}
    losses, first = [], None
    for k, batch in enumerate(batches):
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        for (g, n), v in list(leaves.items()) + list(frozen.items()):
            tree.setdefault(g, {})[n] = v
        loss = loss_fn(tree, batch, recipe, arith)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), grads)]
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = dict(zip(leaves, grads))
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if not float(norm) < recipe["clip"]:
                grads = {key: g / norm * recipe["clip"] for key, g in grads.items()}
            if first is None:
                first = {key: g.clone() for key, g in grads.items()}
            decay = recipe["decay_steps"]
            lr = recipe["learning_rate"] * 0.5 * (
                1.0 + math.cos(math.pi * min(sched0 + k, decay) / decay))
            n = count0 + k + 1
            bc1, bc2 = 1.0 - B1 ** n, 1.0 - B2 ** n
            for key, v in leaves.items():
                g = grads[key]
                m[key].mul_(B1).add_(g, alpha=1.0 - B1)
                s[key].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = s[key].sqrt() / math.sqrt(bc2) + EPS
                v.addcdiv_(m[key], denom, value=-lr / bc1)
    return losses, first, {k: v.detach() for k, v in leaves.items()}
