"""`odeint` front-end with the reference solver names.

Port of `hybrid_ode_tpu/solvers/api.py`: the adaptive explicit solvers
(dopri5, rk45, dop853, bosh3) and the implicit ones (radau, variable-order
bdf, bdf2) in 'scan' / 'while' modes, dense output ('dense': dopri5, rk45,
dop853, radau, bdf), the backsolve adjoint and the fixed-grid 'rk4' /
'euler'.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from hybrid_ode_torch.solvers.bdf import odeint_bdf
from hybrid_ode_torch.solvers.explicit import odeint_erk
from hybrid_ode_torch.solvers.fixed import odeint_fixed
from hybrid_ode_torch.solvers.implicit import odeint_bdf2, odeint_radau
from hybrid_ode_torch.solvers.tableaus import TABLEAUS

SOLVERS = ("dopri5", "rk45", "dop853", "bosh3", "radau", "bdf", "bdf2", "rk4", "euler")


def odeint(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any = None,
    *,
    solver: str = "dopri5",
    rtol: float = 1e-6,
    atol: float = 1e-8,
    mode: str = "scan",
    max_steps_per_interval: int = 32,
    substeps: int = 4,
    checkpoint_intervals: bool = True,
    adjoint: str = "discrete",
    return_stats: bool = False,
    norm_weights=None,
    args_axes: Any = None,
):
    """Solve dy/dt = f(t, y, args), reporting y(ts[..., i]) for every time.

    Same signature as the JAX `odeint`, with batching written out: y0
    (..., n), ts (T,) or (..., T), and f takes per-sample times (...).
    mode: 'scan' (differentiable) | 'while' (fast forward) | 'dense'
    (free-running steps + dense output; max_steps_per_interval * (T-1) // 4
    trial steps). adjoint='backsolve': continuous adjoint on a while-mode
    forward; args_axes (a vmap in_dims prefix of args, None = shared by the
    batch) tells it which leaves of args are per sample. return_stats: also
    return per-sample StepStats (adaptive solvers only). norm_weights: (n,)
    error-seminorm weights (explicit adaptive solvers, scan/while only)."""
    solver = solver.lower()
    if norm_weights is not None and (
        mode == "dense" or adjoint == "backsolve" or solver not in TABLEAUS
    ):
        raise ValueError(
            "norm_weights is supported for the explicit adaptive solvers "
            "(scan/while modes) only"
        )
    if mode == "dense":
        # free-running steps + dense interpolation: the step size is set by
        # the dynamics, not by the observation grid
        if adjoint == "backsolve":
            raise ValueError(
                "mode='dense' uses discretize-then-optimize gradients; "
                "adjoint='backsolve' is unsupported with dense output"
            )
        if solver not in ("dopri5", "rk45", "dop853", "radau", "bdf"):
            raise ValueError("mode='dense' is implemented for dopri5/rk45/dop853/radau/bdf")
        from hybrid_ode_torch.solvers.dense import (
            odeint_bdf_dense,
            odeint_dop853_dense,
            odeint_dopri5_dense,
            odeint_radau_dense,
        )

        dense_fn = {"dop853": odeint_dop853_dense,
                    "radau": odeint_radau_dense,
                    "bdf": odeint_bdf_dense}.get(solver, odeint_dopri5_dense)
        return dense_fn(
            f, y0, ts, args, rtol=rtol, atol=atol,
            max_steps=max_steps_per_interval * max(ts.shape[-1] - 1, 1) // 4,
            return_stats=return_stats,
        )
    if adjoint == "backsolve":
        from hybrid_ode_torch.solvers.adjoint import odeint_backsolve

        if return_stats:
            raise ValueError("return_stats is unsupported with adjoint='backsolve'")
        return odeint_backsolve(
            f, y0, ts, args, solver=solver, rtol=rtol, atol=atol,
            max_steps_per_interval=max_steps_per_interval, substeps=substeps,
            args_axes=args_axes,
        )
    if solver in TABLEAUS:
        return odeint_erk(
            f, y0, ts, args, TABLEAUS[solver],
            rtol=rtol, atol=atol, mode=mode,
            max_steps_per_interval=max_steps_per_interval,
            checkpoint_intervals=checkpoint_intervals,
            return_stats=return_stats,
            norm_weights=norm_weights,
        )
    implicit = {"radau": odeint_radau, "bdf": odeint_bdf, "bdf2": odeint_bdf2}
    if solver in implicit:
        # 'bdf' is the variable-order BDF(1-5), the scipy.BDF-class method the
        # reference maps the name to; 'bdf2' the cheap variable-step BDF2
        return implicit[solver](
            f, y0, ts, args, rtol=rtol, atol=atol, mode=mode,
            max_steps_per_interval=max_steps_per_interval,
            checkpoint_intervals=checkpoint_intervals,
            return_stats=return_stats,
        )
    if solver in ("rk4", "euler"):
        if return_stats:
            raise ValueError("fixed-grid solvers have no step stats")
        return odeint_fixed(f, y0, ts, args, method=solver, substeps=substeps,
                            checkpoint_intervals=checkpoint_intervals)
    raise ValueError(f"unknown solver {solver!r}; available: {SOLVERS}")
