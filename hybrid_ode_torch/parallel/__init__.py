"""Deep ensembles and the multi-device layer on `torch.distributed`: meshes,
batch placement, the data-parallel train step and cohort simulator."""

from hybrid_ode_torch.parallel import distributed
from hybrid_ode_torch.parallel.ensemble import (
    ensemble_forward,
    ensemble_predictive,
    init_ensemble,
    init_ensemble_state,
    make_ensemble_train_step,
    member_params,
)
from hybrid_ode_torch.parallel.mesh import make_mesh, shard_batch, replicate
from hybrid_ode_torch.parallel.train_parallel import make_parallel_train_step, parallel_cohort_sim

__all__ = [
    "distributed",
    "make_mesh",
    "shard_batch",
    "replicate",
    "make_parallel_train_step",
    "parallel_cohort_sim",
    "init_ensemble",
    "init_ensemble_state",
    "make_ensemble_train_step",
    "ensemble_forward",
    "ensemble_predictive",
    "member_params",
]
