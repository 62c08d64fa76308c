"""Device meshes, batch placement and the collectives of the sharded steps.

Port of `hybrid_ode_tpu/parallel/mesh.py` to `torch.distributed`. The JAX
package runs one process over many devices and lets XLA insert the
collectives; here one process drives one device, as torch does, and the
steps call the collectives themselves:

  * `make_mesh` builds a `torch.distributed.device_mesh.DeviceMesh` over the
    world with named dims ('data' for batch / cohort / chain parallelism,
    'ens' for ensemble members). With no process group running it starts a
    world of one on an in-process store, so one-process code needs no
    launcher.
  * `shard_batch` gives each rank its contiguous slice (in rank order) of
    the leaves that carry the batch dimension and replicates the rest. Its
    result records whether it is sharded and the global batch size, so a
    replicated batch is not counted once per rank by a step.
  * `replicate` broadcasts a tree from rank 0 onto each rank's device.
  * `all_reduce_sum`, `all_reduce_tensors` and `all_gather_cat` are the
    collectives the sharded train step, the ensemble step and NUTS use, over
    one dim of the mesh.

`batch_sharding` and `replicated` are torch's own placement descriptors
(`Shard(0)` on the named dim, `Replicate()` elsewhere).
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from hybrid_ode_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank drives on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    device: Union[str, torch.device, None] = None,
) -> DeviceMesh:
    """A mesh over the world's ranks (one device each), dims `axis_names`.

    shape defaults to (world,) + (1,) * (len(axis_names) - 1). Without a
    process group, a world of one starts on an in-process store: NCCL for a
    CUDA device, gloo for the CPU. `device` (default: the one
    `distributed.initialize` chose, else CUDA) sets the mesh's device type.
    n_devices, where given, must be the world size: every rank of a torch
    world takes part in a mesh over it."""
    from hybrid_ode_torch.parallel import distributed

    if device is None:
        device = distributed.rank_device() or "cuda"
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        distributed.set_rank_device(dev)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the world has {n} ranks "
                         "(one device each); start the world with that many processes")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"make_mesh: shape {tuple(shape)} does not cover the {n} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def local_slice(mesh: DeviceMesh, n: int, axis: str) -> slice:
    """This rank's contiguous block of n items split evenly over `axis`."""
    k = n // axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)
    return slice(r * k, (r + 1) * k)


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> Tuple:
    """Placements of a leaf sharded on its leading dim over `axis`."""
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple:
    """Placements of a leaf held whole on every rank."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


class ShardedBatch(dict):
    """A batch dict on this rank's device with its placement: `axis` the
    mesh dim its batch leaves are sharded over (None: replicated),
    `global_size` the batch size over all ranks (None: no batch leaves),
    `placements` the sharded leaves' placements."""

    def __init__(self, leaves, axis: Optional[str], global_size: Optional[int],
                 placements: Tuple):
        super().__init__(leaves)
        self.axis = axis
        self.global_size = global_size
        self.placements = placements


def _tree_map(fn, tree):
    """fn over the leaves of nested dicts (batches, params trees)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


def _as_tensor(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (np.ndarray, np.generic, float, int, bool)):
        return torch.as_tensor(np.asarray(x), device=device)
    return x


def _lead(x) -> Optional[int]:
    shape = getattr(x, "shape", None)
    return int(shape[0]) if shape is not None and len(shape) >= 1 and shape[0] > 0 else None


def _batch_dim(tree) -> Optional[int]:
    """The most common leading dimension of the leaves (ties toward the larger)."""
    counts = Counter(d for d in map(_lead, _tree_leaves(tree)) if d is not None)
    return max(counts, key=lambda d: (counts[d], d)) if counts else None


def _wrap(tree, axis, global_size, placements):
    return ShardedBatch(tree, axis, global_size, placements) if isinstance(tree, dict) else tree


def shard_batch(mesh: DeviceMesh, batch: Any, axis: str = "data") -> Any:
    """This rank's part of a batch every rank holds whole (arrays or tensors).

    The batch dimension is the most common leading dimension among the
    leaves (ties toward the larger): the leaves that carry it are sliced,
    each rank keeping its contiguous block in rank order; the others (the
    (6,) `loss_weights`, even where the axis size divides 6) are kept whole.
    If the batch dimension does not divide the axis size, the whole batch is
    replicated with a warning. A dict comes back as a `ShardedBatch`."""
    dev = mesh_device(mesh)
    size = axis_size(mesh, axis)
    tree = _tree_map(lambda x: _as_tensor(x, dev), batch)
    batch_dim = _batch_dim(tree)
    if batch_dim is None:
        return _wrap(tree, None, None, replicated(mesh))
    if batch_dim % size != 0:
        logger.warning(
            "shard_batch: batch dim %d is not divisible by mesh axis %r "
            "(size %d) — replicating the whole batch, data parallelism is "
            "LOST for this step. Pad the batch (data.dataset.pad_batch) to "
            "a multiple of the axis size.", batch_dim, axis, size)
        return _wrap(tree, None, batch_dim, replicated(mesh))
    sl = local_slice(mesh, batch_dim, axis)
    local = _tree_map(lambda x: x[sl] if _lead(x) == batch_dim else x, tree)
    return _wrap(local, axis, batch_dim, batch_sharding(mesh, axis))


def replicate(mesh: DeviceMesh, tree: Any) -> Any:
    """A tree (arrays or tensors) on every rank's device, rank 0's values."""
    dev = mesh_device(mesh)

    def put(x):
        x = _as_tensor(x, dev)
        if isinstance(x, torch.Tensor):
            x = x.clone(memory_format=torch.contiguous_format)
            dist.broadcast(x, src=0)
        return x

    return _tree_map(put, tree)


# ---------------------------------------------------------------------------
# Collectives over one mesh dim
# ---------------------------------------------------------------------------

def all_reduce_sum(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks of `axis` (a new tensor)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def all_reduce_tensors(mesh: DeviceMesh, axis: str, tensors) -> list:
    """Each tensor summed over the ranks of `axis`, through one flat buffer."""
    flat = all_reduce_sum(mesh, axis, torch.cat([t.reshape(-1) for t in tensors]))
    return [f.view_as(t) for t, f in zip(tensors, torch.split(flat, [t.numel() for t in tensors]))]


def all_gather_cat(mesh: DeviceMesh, axis: str, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` along `axis`, concatenated on `dim` in rank order
    (every rank's `x` of one shape)."""
    x = x.detach().contiguous()
    flags = x.dtype == torch.bool
    if flags:  # not every backend gathers bool
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    out = torch.cat(parts, dim=dim)
    return out.bool() if flags else out


class DataShards:
    """This rank's share of a batch sharded over the mesh dim `axis`, as the
    losses take it (`models/hybrid.py::hybrid_loss(shards=)`): `total` sums
    a count over the dim's ranks, `size` is their number."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.size = axis_size(mesh, axis)

    def total(self, x):
        """The sum over the dim's ranks of a tensor (no gradient) or number."""
        if isinstance(x, torch.Tensor):
            return all_reduce_sum(self.mesh, self.axis, x)
        t = torch.tensor(float(x), dtype=torch.float64, device=mesh_device(self.mesh))
        return all_reduce_sum(self.mesh, self.axis, t).item()
