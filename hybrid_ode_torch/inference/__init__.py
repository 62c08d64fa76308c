"""Bayesian inference: variational inference and NUTS (port of
`hybrid_ode_tpu/inference/`)."""

from hybrid_ode_torch.inference.vi import VariationalInference, elbo
from hybrid_ode_torch.inference.mcmc import (
    run_nuts,
    compute_ess,
    ess_bulk,
    ess_tail,
    rhat,
    split_rhat,
    posterior_summary,
    save_mcmc_results,
    load_mcmc_results,
)

__all__ = [
    "VariationalInference",
    "elbo",
    "run_nuts",
    "compute_ess",
    "ess_bulk",
    "ess_tail",
    "rhat",
    "split_rhat",
    "posterior_summary",
    "save_mcmc_results",
    "load_mcmc_results",
]
