"""Faults planted under the timed path, by name: the check has to come out
not correct under each one that its cell can have. The CPU tests plant them
at a small size; `python3 -m perfbench.readings --fault <name>` reads them
at the cell's size on the card, where they set a number's upper reading.

`plant(name)` patches the program's module and returns a callable that
undoes the patch. Every fault is planted before the cell's set-up.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def _patch(patches: List[Tuple[object, str, object]]) -> Callable[[], None]:
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)

    def undo():
        for obj, name, value in saved:
            setattr(obj, name, value)
    return undo


def _half(batch):
    """The first half of a batch's windows (loss weights are per state)."""
    h = batch["initial_state"].shape[0] // 2
    return {k: (v if k == "loss_weights" else
                {n: x[:h] for n, x in v.items()} if isinstance(v, dict) else v[:h])
            for k, v in batch.items()}


# ---- training -------------------------------------------------------------

def train_state_unchanged():
    """The update leaves the parameters and the optimizer's state as they were."""
    from hybrid_ode_torch.train import loop
    return _patch([(loop.Optimizer, "step", lambda self: None)])


def train_half_batch():
    """The loss is the mean over the first half of the batch's windows."""
    from hybrid_ode_torch.train import loop
    real = loop.hybrid_loss
    return _patch([(loop, "hybrid_loss", lambda params, batch, *a, **k:
                    real(params, _half(batch), *a, **k))])


def train_stale_batch():
    """Every update after the first reuses the first batch it was given."""
    from hybrid_ode_torch.train import loop
    real = loop.make_train_step

    def make(*a, **k):
        step, first = real(*a, **k), []

        def stale(state, batch, gen):
            first.append(batch)
            return step(state, first[0], gen)
        return stale
    return _patch([(loop, "make_train_step", make)])


def train_moments_frozen():
    """Adam's moments stop advancing: the update uses them, then they revert."""
    from hybrid_ode_torch.train import loop
    real = loop.Optimizer.step

    def step(self):
        keep = {id(t): (s["exp_avg"].clone(), s["exp_avg_sq"].clone())
                for t, s in self._adam.state.items()}
        real(self)
        for t, s in self._adam.state.items():
            if id(t) in keep:
                s["exp_avg"].copy_(keep[id(t)][0])
                s["exp_avg_sq"].copy_(keep[id(t)][1])
    return _patch([(loop.Optimizer, "step", step)])


def train_schedule_frozen():
    """The learning rate stays where set-up left it."""
    from hybrid_ode_torch.train import loop
    real = loop.Optimizer.step

    def step(self):
        lrs = [g["lr"] for g in self._adam.param_groups]
        real(self)
        for g, lr in zip(self._adam.param_groups, lrs):
            g["lr"] = lr
    return _patch([(loop.Optimizer, "step", step)])


# ---- NUTS -----------------------------------------------------------------

def nuts_state_unchanged():
    """A transition returns every chain's start."""
    from hybrid_ode_torch.inference import mcmc
    real = mcmc._nuts_step

    def stuck(lg, q0, *a, **k):
        _, astat, n_lf, div = real(lg, q0, *a, **k)
        return q0, astat, n_lf, div
    return _patch([(mcmc, "_nuts_step", stuck)])


def nuts_answer_altered():
    """The fused forward's first lane is 1% off where the kernel produces it."""
    from hybrid_ode_torch.ops import fused_rk4
    real = fused_rk4.fused_rk4_hybrid

    def broken(*a, **k):
        out = real(*a, **k)
        scale = torch.ones_like(out)
        scale[0] = 1.01
        return out * scale
    return _patch([(fused_rk4, "fused_rk4_hybrid", broken)])


def nuts_half_batch():
    """The log density sees the first half of the batch's windows."""
    from hybrid_ode_torch.inference import mcmc
    real = mcmc.posterior
    return _patch([(mcmc, "posterior", lambda params, batch, *a, **k:
                    real(params, _half(batch), *a, **k))])


def nuts_leapfrog():
    """The leapfrog drops its first half kick: q moves with the old momentum."""
    from hybrid_ode_torch.inference import mcmc

    def leapfrog(logp_and_grad, state, eps, inv_mass):
        e = eps[:, None]
        q_new = state.q + e * inv_mass * state.p
        logp_new, grad_new = mcmc._logp_and_grad(logp_and_grad, q_new)
        return mcmc._LFState(q_new, state.p + e * grad_new, grad_new, logp_new)
    return _patch([(mcmc, "_leapfrog", leapfrog)])


def nuts_weights():
    """The multinomial and acceptance weights leave out the kinetic energy."""
    from hybrid_ode_torch.inference import mcmc
    return _patch([(mcmc, "_energy", lambda state, inv_mass: -state.logp)])


def nuts_no_uturn():
    """The U-turn rule never fires: every tree runs to the depth cap."""
    from hybrid_ode_torch.inference import mcmc
    return _patch([(mcmc, "_is_turning",
                    lambda q_minus, p_minus, q_plus, p_plus, inv_mass:
                    torch.zeros(q_plus.shape[:-1], dtype=torch.bool, device=q_plus.device))])


# ---- cohorts --------------------------------------------------------------

def _cohort(kind):
    from hybrid_ode_torch.models import hybrid
    real = hybrid.batched_forward

    def broken(*a, **k):
        out = real(*a, **k)
        traj = (out[0] if isinstance(out, tuple) else out).clone()
        if kind == "altered":
            traj[3, -1, 0] += 1.0
        else:
            traj[traj.shape[0] // 2:] = traj[: traj.shape[0] - traj.shape[0] // 2]
        return (traj,) + tuple(out[1:]) if isinstance(out, tuple) else traj
    return _patch([(hybrid, "batched_forward", broken)])


def cohort_answer_altered():
    """One window's last glucose value is off by 1 where it is produced."""
    return _cohort("altered")


def cohort_half_batch():
    """The second half of the cohort repeats the first half's trajectories."""
    return _cohort("half")


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "train_state_unchanged": train_state_unchanged,
    "train_half_batch": train_half_batch,
    "train_stale_batch": train_stale_batch,
    "train_moments_frozen": train_moments_frozen,
    "train_schedule_frozen": train_schedule_frozen,
    "nuts_state_unchanged": nuts_state_unchanged,
    "nuts_answer_altered": nuts_answer_altered,
    "nuts_half_batch": nuts_half_batch,
    "nuts_leapfrog": nuts_leapfrog,
    "nuts_weights": nuts_weights,
    "nuts_no_uturn": nuts_no_uturn,
    "cohort_answer_altered": cohort_answer_altered,
    "cohort_half_batch": cohort_half_batch,
}


def plant(name: str) -> Callable[[], None]:
    return FAULTS[name]()
