"""Reader and writer of the JAX package's checkpoint format.

A checkpoint is a directory:

    <dir>/leaves.npz      flattened pytree leaves, keyed leaf_0000...
    <dir>/structure.json  JSON tree spec + metadata (epoch, val_loss, config,
                          state_mean/std, ...)

(`hybrid_ode_tpu/utils/checkpoint.py`). The tree is rebuilt from the JSON
spec only, as numpy arrays; nothing is ever unpickled. Tensors are made
from the result by `hybrid_ode_torch.utils.convert.params_from_numpy`.
`save_checkpoint` writes the same two files, leaves numbered in the order
the JSON spec walks the tree (dict keys sorted, as jax flattens them), so
params and metadata cross-load both ways. The port's optimizer state is
{"count", "mu", "nu"} (`hybrid_ode_torch/train/loop.py`); the port also
resumes from the JAX package's optax state
(`hybrid_ode_torch/utils/convert.py::optax_state_to_port`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _default_json(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serialisable: {type(o)}")


def _build_spec(tree: Any, leaves: list) -> Any:
    """JSON spec of `tree`, appending its leaves (as numpy) in spec order."""
    if tree is None:
        return {"kind": "none"}
    if isinstance(tree, dict):
        return {"kind": "dict", "items": [[k, _build_spec(tree[k], leaves)] for k in sorted(tree)]}
    if isinstance(tree, (tuple, list)):
        return {"kind": "tuple" if isinstance(tree, tuple) else "list",
                "items": [_build_spec(c, leaves) for c in tree]}
    leaves.append(tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                  else np.asarray(tree))
    return {"kind": "leaf", "index": len(leaves) - 1}


def save_checkpoint(path: str, state: Any, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Save a tree of tensors / arrays (dicts, tuples, lists) plus JSON-able
    metadata in the JAX package's format."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves: list = []
    spec = _build_spec(state, leaves)
    np.savez(path / "leaves.npz", **{f"leaf_{i:04d}": l for i, l in enumerate(leaves)})
    with open(path / "structure.json", "w") as f:
        json.dump({"spec": spec, "n_leaves": len(leaves), "metadata": metadata or {}},
                  f, default=_default_json)


def _rebuild_from_spec(spec: Any, leaves) -> Any:
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _rebuild_from_spec(s, leaves) for k, s in spec["items"]}
    if kind == "tuple":
        return tuple(_rebuild_from_spec(s, leaves) for s in spec["items"])
    if kind == "list":
        return [_rebuild_from_spec(s, leaves) for s in spec["items"]]
    if kind == "leaf":
        return leaves[spec["index"]]
    raise ValueError(f"unknown spec kind: {kind}")


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load (state tree of numpy arrays, metadata)."""
    path = Path(path)
    with open(path / "structure.json") as f:
        doc = json.load(f)
    if "spec" not in doc:
        raise ValueError(f"{path} is a legacy checkpoint without a JSON tree spec; "
                         "the port reads JSON-spec checkpoints only")
    with np.load(path / "leaves.npz", allow_pickle=False) as data:
        leaves = [data[f"leaf_{i:04d}"] for i in range(len(data.files))]
    return _rebuild_from_spec(doc["spec"], leaves), doc["metadata"]
