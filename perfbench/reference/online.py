"""One subject's online adaptation in plain PyTorch, float32, TF32 off.

The upstream paper's online adaptation protocol (`manuscript.tex:642-654`,
run by `benchmarks/online_adapt.py`): a population model adapts to one
subject on the revealed start of the subject's stream by Adam steps on

    data MSE over the reveal (masked, every state weighted 1)
      + anchor * sum over the MLP's leaves of ||nn - nn_pop||^2

with gradients of the adapted scope's MLP leaves only ('nn': all of them,
'last': the output layer's weight and bias); the encoder and the
mechanistic parameters stay the population's. Adam: b1 0.9, b2 0.999, eps
1e-8 added to the bias-corrected root, bias corrections by the update's
number counted from the subject's start, a fixed learning rate. The model's
equations are `model.py`'s.

Departures from the description: the anchor sums over every MLP leaf, the
biases included (the description names the weights); outside the scope
those terms are 0 and carry no gradient. The physics term and the L2 term
of training are off, as the protocol runs them (lambda1 = lambda2 = 0).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from perfbench.reference import model

B1, B2, EPS = 0.9, 0.999, 1e-8

Tree = Dict[str, Dict[str, torch.Tensor]]


def scope_names(nn: Dict[str, torch.Tensor], scope: str):
    """The MLP leaves that adapt: all ('nn') or the output layer's ('last')."""
    last = max(int(k[1:]) for k in nn if k.startswith("w"))
    return sorted(k for k in nn if scope == "nn" or k in (f"w{last}", f"b{last}"))


def loss_fn(params: Tree, batch: Dict[str, torch.Tensor], recipe: Dict,
            arith: model.Arith = model.F32) -> torch.Tensor:
    """The data loss over the reveal (no anchor)."""
    ctx = None
    if "enc" in params:
        ctx = model.encode(params["enc"], batch["observations"], batch["time_points"],
                           recipe["context_points"], arith)
    preds = model.rk4(batch["initial_state"], batch["time_points"], batch["meal"],
                      batch["tvns"], ctx, params["ode"], params["nn"], recipe["substeps"], arith)
    ones = torch.ones(preds.shape[-1], dtype=preds.dtype, device=preds.device)
    return model.data_loss(preds, batch["observations"], batch["mask"], ones)


def update(params: Tree, pop_nn: Dict[str, torch.Tensor], batch, recipe: Dict,
           moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]], count: int,
           arith: model.Arith = model.F32):
    """One update from `params` (not modified), Adam's moments {name: (mu,
    nu)} of the scope's leaves and `count` updates of this subject before
    it. Returns (the data loss before it, the gradient {name: tensor}, the
    scope's leaves after {name: tensor}, the moments after)."""
    names = scope_names(params["nn"], recipe["adapt_scope"])
    leaves = {k: params["nn"][k].detach().clone().requires_grad_(True) for k in names}
    tree = {g: dict(grp) for g, grp in params.items()}
    tree["nn"].update(leaves)
    loss = loss_fn(tree, batch, recipe, arith)
    anchor = sum(torch.sum((tree["nn"][k] - pop_nn[k]) ** 2) for k in sorted(pop_nn))
    grads = torch.autograd.grad(loss + recipe["anchor_weight"] * anchor, list(leaves.values()))
    n = count + 1
    bc1, bc2 = 1.0 - B1 ** n, 1.0 - B2 ** n
    lr = recipe["learning_rate"]
    after, moved = {}, {}
    with torch.no_grad():
        for (k, v), g in zip(leaves.items(), grads):
            m, s = (t.clone() for t in moments[k])
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            s.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            denom = s.sqrt() / math.sqrt(bc2) + EPS
            after[k] = (v - lr / bc1 * m / denom).detach()
            moved[k] = (m, s)
    return float(loss.detach()), dict(zip(names, (g.detach() for g in grads))), after, moved


def fresh_moments(params: Tree, scope: str):
    """Adam's moments at a subject's start: zeros."""
    return {k: (torch.zeros_like(params["nn"][k]), torch.zeros_like(params["nn"][k]))
            for k in scope_names(params["nn"], scope)}


def adapt(params: Tree, batch, recipe: Dict, steps: int, arith: model.Arith = model.F32):
    """`steps` updates from the population weights `params` with a fresh
    Adam: (losses [float], the scope's leaves after {name: tensor})."""
    pop_nn = {k: v.detach() for k, v in params["nn"].items()}
    tree = {g: {k: v.detach() for k, v in grp.items()} for g, grp in params.items()}
    moments = fresh_moments(params, recipe["adapt_scope"])
    losses, after = [], {}
    for count in range(steps):
        loss, _, after, moments = update(tree, pop_nn, batch, recipe, moments, count, arith)
        losses.append(loss)
        tree["nn"].update(after)
    return losses, after
