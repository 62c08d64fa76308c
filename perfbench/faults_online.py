"""Faults that only the online adaptation cell can have, planted under its
timed path (`perfbench/drivers/online.py`), with `perfbench/faults.py`'s
convention: `plant(name)` patches the program's module before the cell's
set-up and returns a callable that undoes the patch. The CPU tests plant
them at a small size; `python3 -m perfbench.readings_online --fault <name>`
reads them at the cell's size on the card.
"""

from __future__ import annotations

from typing import Callable, Dict

from perfbench.faults import _patch


def _after_init(then):
    """Patch `Adaptation.__init__` to run `then(adaptation)` after it."""
    from hybrid_ode_torch.train import online
    real = online.Adaptation.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        then(self)
    return _patch([(online.Adaptation, "__init__", init)])


def online_anchor_dropped():
    """The adaptation's objective loses its pull to the population weights."""
    def drop(a):
        a.anchor_weight = 0.0
    return _after_init(drop)


def online_scope_last():
    """Only the output layer adapts where the configuration adapts the whole MLP."""
    from hybrid_ode_torch.train import online
    real = online._trained_names
    return _patch([(online, "_trained_names", lambda nn, scope: real(nn, "last"))])


def online_moments_carried():
    """A subject's Adam starts from the previous subject's moments and count."""
    previous = []

    def carry(a):
        if previous:
            old = previous[-1]
            for name, t in a.trained.items():
                if old.trained.get(name) in old.opt.state:
                    a.opt.state[t] = old.opt.state[old.trained[name]]
        previous[:] = [a]
    return _after_init(carry)


def online_half_reveal():
    """The loss covers the first half of the reveal's points only."""
    from hybrid_ode_torch.train import online
    real = online.hybrid_loss

    def half(batch):
        h = batch["time_points"].shape[1] // 2
        return {k: (v if k == "initial_state" else
                    {n: x[:, :h] for n, x in v.items()} if isinstance(v, dict) else v[:, :h])
                for k, v in batch.items()}
    return _patch([(online, "hybrid_loss", lambda params, batch, *a, **k:
                    real(params, half(batch), *a, **k))])


def online_layer_grad_halved():
    """One hidden layer's weight gets half its gradient, as an adjoint whose
    cotangent for that layer's weight missed half its terms would give; the
    other leaves' gradients stay right."""
    def halve(a):
        a.trained["w1"].register_hook(lambda g: 0.5 * g)
    return _after_init(halve)


def online_state_unchanged():
    """The update leaves the parameters and Adam's state as they were."""
    def freeze(a):
        a.opt.step = lambda *args, **kwargs: None
    return _after_init(freeze)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "online_anchor_dropped": online_anchor_dropped,
    "online_scope_last": online_scope_last,
    "online_moments_carried": online_moments_carried,
    "online_half_reveal": online_half_reveal,
    "online_layer_grad_halved": online_layer_grad_halved,
    "online_state_unchanged": online_state_unchanged,
}


def plant(name: str) -> Callable[[], None]:
    return FAULTS[name]()
