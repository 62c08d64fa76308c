"""Multi-process start-up and per-process batches.

Port of `hybrid_ode_tpu/parallel/distributed.py` to `torch.distributed`:
one process per device, as torch does it. A launcher (torchrun, or one
process per card started by hand) runs the same script in every process;
each joins the world here and then builds its mesh with `make_mesh`:

    from hybrid_ode_torch.parallel import distributed
    distributed.initialize()               # no-op for a single process
    mesh = make_mesh()                     # spans every process's device

The JAX package's third source of settings, the TPU pod's auto-discovery
(`TPU_WORKER_HOSTNAMES`, `MEGASCALE_COORDINATOR_ADDRESS`), has no
counterpart on a CUDA host and is not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from hybrid_ode_torch.utils.device import resolve_device

logger = logging.getLogger("hybrid_ode_torch.distributed")

_rank_device: Optional[torch.device] = None


def rank_device() -> Optional[torch.device]:
    """The device `initialize` (or a mesh's world of one) gave this process."""
    return _rank_device


def set_rank_device(device: Optional[torch.device]) -> None:
    global _rank_device
    _rank_device = device


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> bool:
    """Join the process group; returns True if distributed.

    Resolution order: explicit arguments > torchrun's MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK (in place of the JAX package's
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) >
    single-process no-op (False). coordinator_address is "host:port" or an
    init-method URL ("tcp://...", "file://..."). backend: "nccl" for CUDA
    ranks and "gloo" for CPU ranks unless given (gloo also serves CUDA
    ranks, e.g. two processes on one card, where NCCL refuses). A CUDA
    rank's device is cuda:{LOCAL_RANK (else the rank) % device_count}."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        logger.debug("single-process run (no coordinator configured)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator address needs the world size and this "
                         "process's rank (arguments, or WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local_rank = _env_int("LOCAL_RANK")
        index = (process_id if local_rank is None else local_rank) % torch.cuda.device_count()
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)
    set_rank_device(dev)
    logger.info("joined the process group: rank %d/%d via %s (%s on %s)",
                dist.get_rank(), dist.get_world_size(), coordinator_address, backend, dev)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    set_rank_device(None)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def process_local_batch(global_batch: Any, mesh) -> Any:
    """Place this process's shard of a global batch (its leading-axis slice
    of global_B / processes, in rank order) on its device, marked as sharded
    over 'data' with the global batch size, for the parallel train step."""
    from hybrid_ode_torch.parallel.mesh import (
        ShardedBatch, _as_tensor, _batch_dim, _tree_map, axis_size, batch_sharding, mesh_device)

    dev = mesh_device(mesh)
    tree = _tree_map(lambda x: _as_tensor(x, dev), global_batch)
    local = _batch_dim(tree) or 0
    return ShardedBatch(tree, "data", local * axis_size(mesh, "data"),
                        batch_sharding(mesh, "data"))
