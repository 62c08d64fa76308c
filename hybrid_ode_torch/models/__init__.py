"""Hybrid model composition, closed-loop protocols, Bayesian parameters."""

from hybrid_ode_torch.models.hybrid import (
    HybridConfig,
    init_hybrid_params,
    hybrid_field,
    forward,
    batched_forward,
    hybrid_loss,
    params_to_flat,
    flat_to_params,
    forward_with_params,
)
from hybrid_ode_torch.models.protocol import (
    closed_loop_rollout,
    counterfactual_delta_correction,
    cvar_glycemic_risk,
    ensemble_closed_loop,
    glycemic_risk,
    optimize_protocol,
    robust_delta_risk,
    time_in_range,
)
from hybrid_ode_torch.models.bayes import (
    VariationalState,
    init_variational,
    sample_variational,
    kl_divergence,
    flatten_variational,
    posterior_predictive,
)

__all__ = [
    "HybridConfig",
    "init_hybrid_params",
    "hybrid_field",
    "forward",
    "batched_forward",
    "hybrid_loss",
    "params_to_flat",
    "flat_to_params",
    "forward_with_params",
    "closed_loop_rollout",
    "cvar_glycemic_risk",
    "ensemble_closed_loop",
    "glycemic_risk",
    "optimize_protocol",
    "counterfactual_delta_correction",
    "robust_delta_risk",
    "time_in_range",
    "VariationalState",
    "init_variational",
    "sample_variational",
    "kl_divergence",
    "flatten_variational",
    "posterior_predictive",
]
