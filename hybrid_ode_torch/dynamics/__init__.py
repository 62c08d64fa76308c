"""Vector fields: mechanistic core, MLP residual, controls, the 4GI simulator."""

from hybrid_ode_torch.dynamics.ode_core import (
    DEFAULT_ODE_PARAMS,
    mechanistic_field,
    steady_state,
    check_mass_balance,
)
from hybrid_ode_torch.dynamics.residual import init_mlp_params, mlp_apply, feature_importance
from hybrid_ode_torch.dynamics.controls import Controls, eval_controls
from hybrid_ode_torch.dynamics.fourgi import (
    FOURGI_PARAMS_T2DM,
    FOURGI_PARAMS_HV,
    fourgi_field,
    fourgi_initial_state,
)

__all__ = [
    "DEFAULT_ODE_PARAMS",
    "mechanistic_field",
    "steady_state",
    "check_mass_balance",
    "init_mlp_params",
    "mlp_apply",
    "feature_importance",
    "Controls",
    "eval_controls",
    "FOURGI_PARAMS_T2DM",
    "FOURGI_PARAMS_HV",
    "fourgi_field",
    "fourgi_initial_state",
]
