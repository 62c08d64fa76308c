"""ODE solvers: fixed-grid RK4 / Euler, the adaptive explicit Runge-Kutta
family (scan, while, dense, sync, backsolve) and the implicit Radau IIA,
BDF 1-5 and BDF2."""

from hybrid_ode_torch.solvers.api import odeint, SOLVERS
from hybrid_ode_torch.solvers.sync import odeint_erk_sync
from hybrid_ode_torch.solvers.tableaus import TABLEAUS, ERKTableau

__all__ = ["odeint", "odeint_erk_sync", "SOLVERS", "TABLEAUS", "ERKTableau"]
