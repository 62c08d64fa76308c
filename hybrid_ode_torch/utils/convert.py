"""Carry parameters across between the JAX pytree and the port's tensors.

The JAX params pytree {'ode', 'nn', ['enc'], ['norm']} (nested dicts of
numpy arrays, as `load_checkpoint` gives them) maps one to one onto nested
dicts of tensors with the same keys and shapes.
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from hybrid_ode_torch.utils.device import resolve_device


def params_from_numpy(tree: Mapping[str, Any], device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.float32) -> Any:
    """Nested dicts of arrays -> nested dicts of `dtype` tensors on `device`."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return conv(tree)


def params_to_numpy(tree: Mapping[str, Any]) -> Any:
    """Nested dicts of tensors -> nested dicts of numpy arrays (on the host)."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def optax_state_to_port(opt_state: Any) -> dict:
    """The JAX `train_model`'s saved optax state -> the port optimizer's tree.

    JAX `make_optimizer` builds multi_transform({'train': chain(clip (or
    identity), adam(cosine schedule)), 'freeze': set_to_zero()}), so the
    saved tree (as `load_checkpoint` rebuilds it: NamedTuples as tuples) is
    (inner_states,) with inner_states['train'] = (masked inner state,) =
    ((clip state, (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))),).
    mu and nu are trees of the params' groups by name, where a frozen leaf is
    optax's MaskedNode, saved as an empty tuple; those are dropped.

    Returns {"count", "schedule_count", "mu", "nu"}: Adam's update count (its
    bias correction), the schedule's count (the cosine decay's position) and
    the moments of the trainable leaves, as {group: {name: array}}."""
    def fail(what):
        return ValueError(f"not a JAX train_model optimizer state: {what}")

    if not (isinstance(opt_state, tuple) and len(opt_state) == 1
            and isinstance(opt_state[0], Mapping) and "train" in opt_state[0]):
        raise fail("no multi_transform state with a 'train' branch")
    train = opt_state[0]["train"]
    try:
        ((_clip, (adam, schedule)),) = train
        count, mu, nu = adam
        (schedule_count,) = schedule
    except (TypeError, ValueError):
        raise fail("the 'train' branch is not chain(clip, adam(schedule))") from None

    def kept(tree, name):
        if not isinstance(tree, Mapping):
            raise fail(f"Adam's {name} is not a tree of parameter groups")
        out = {}
        for group, leaves in tree.items():
            for leaf, v in leaves.items():
                if not (isinstance(v, tuple) and len(v) == 0):  # MaskedNode: frozen
                    out.setdefault(group, {})[leaf] = np.asarray(v)
        return out

    return {"count": np.asarray(count), "schedule_count": np.asarray(schedule_count),
            "mu": kept(mu, "mu"), "nu": kept(nu, "nu")}
