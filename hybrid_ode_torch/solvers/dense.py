"""Dense-output adaptive solvers: free-running steps plus interpolation.

Port of the dopri5 and dop853 parts of `hybrid_ode_tpu/solvers/dense.py`.
Every other adaptive solver forces steps onto the observation grid; these
integrate the whole span [ts[0], ts[-1]] with free step-size control and
report each output through the method's continuous extension (CONTD5 for
dopri5, the 7th-order extension of DOP853), so the number of field
evaluations is set by accuracy, not by the grid.

Batching is written out: y0 (..., n), ts (T,) or (..., T); each sample has
its own clock, step size and done flag. The loop runs exactly `max_steps`
masked trial steps (no host sync), each checkpointed under autograd; the
controller is detached as in the other solvers.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from hybrid_ode_torch.solvers import explicit as _exp
from hybrid_ode_torch.solvers.tableaus import (
    DOP853_A_EXTRA,
    DOP853_C_EXTRA,
    DOP853_D,
    TABLEAUS,
)

#: CONTD5 coefficients (Hairer's dopri5.f): rcont5 = h * (D . K)
D_CONT5 = np.array([
    -12715105075.0 / 11282082432.0,
    0.0,
    87487479700.0 / 32700410799.0,
    -10690763975.0 / 1880347072.0,
    701980252875.0 / 199316789632.0,
    -1453857185.0 / 822651844.0,
    69997945.0 / 29380423.0,
])


def _dense_solve(step_fn, f, y0, ts, args, error_order, rtol_e, atol_e, max_steps,
                 checkpoint_body, return_stats):
    """The masked free-running loop both methods share. step_fn(t, y, fy,
    h_eff, theta) -> (y1, f_new, err_norm, interp (..., T, n)), theta the
    outputs' step fractions (..., T).

    This is not `explicit._interval` with an output write: the two follow the
    JAX package's two loops, which take other steps. After a step clipped to
    the end, the interval loop keeps the natural step (max(h, h_eff *
    factor)) where this one takes h_eff * factor; this one floors the step at
    `tiny` so a finished sample's theta is never 0 / 0, and it is
    checkpointed per trial step, the interval loop per output interval."""
    dtype = y0.dtype
    batch = y0.shape[:-1]
    ts = torch.as_tensor(ts, dtype=dtype, device=y0.device)
    ts = ts.expand(*batch, ts.shape[-1])
    T, n = ts.shape[-1], y0.shape[-1]
    t0, t_end = ts[..., 0], ts[..., -1]
    f0 = f(t0, y0, args)
    h0 = _exp.initial_step_size(f, t0, y0, f0, args, error_order, rtol_e, atol_e)
    ys0 = torch.cat([y0[..., None, :], y0.new_zeros(*batch, T - 1, n)], dim=-2)
    tiny = torch.finfo(dtype).tiny

    def body(t, y, fy, h, ys, done, nacc, nrej):
        remaining = t_end - t
        at_end = h >= remaining
        h_eff = torch.minimum(h, torch.clamp(remaining, min=tiny))
        theta = (ts - t[..., None]) / h_eff[..., None]          # (..., T)
        y1, f_new, err_norm, interp = step_fn(t, y, fy, h_eff, theta)
        accept = err_norm <= 1.0
        move = accept & ~done
        finish = move & at_end
        in_span = (theta > 0.0) & (theta <= 1.0) & move[..., None]
        ys = torch.where(in_span[..., None], interp, ys)
        factor = _exp._controller_factor(err_norm, accept, error_order, dtype)
        t = torch.where(finish, t_end, torch.where(move, t + h_eff, t))
        y = torch.where(move[..., None], y1, y)
        fy = torch.where(move[..., None], f_new, fy)
        h = torch.where(done, h, h_eff * factor)
        nacc = nacc + move.to(torch.int32)
        nrej = nrej + (~accept & ~done).to(torch.int32)
        return t, y, fy, h, ys, done | finish, nacc, nrej

    zeros = torch.zeros(batch, dtype=torch.int32, device=y0.device)
    carry = (t0, y0, f0, h0, ys0, torch.zeros(batch, dtype=torch.bool, device=y0.device),
             zeros, zeros)
    for _ in range(max_steps):
        if checkpoint_body and torch.is_grad_enabled():
            carry = checkpoint(body, *carry, use_reentrant=False)
        else:
            carry = body(*carry)
    _, _, _, _, ys, done, nacc, nrej = carry
    if return_stats:
        return ys, _exp.StepStats(n_accepted=nacc, n_rejected=nrej, success=done)
    return ys


def odeint_dopri5_dense(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 256,
    checkpoint_body: bool = True,
    return_stats: bool = False,
):
    """Integrate [ts[0], ts[-1]] freely; interpolate y(ts) through CONTD5.
    Returns (..., T, n)."""
    tab = TABLEAUS["dopri5"]
    rtol_e, atol_e = _exp._effective_tols(rtol, atol, y0.dtype)

    def step(t, y, fy, h_eff, theta):
        hv = h_eff[..., None]
        # k1 = FSAL'd f(t, y); stage 7 is f(t+h, y1) (a[6,:] equals b)
        ks = [fy]
        for i in range(1, 7):
            yi = y + hv * _exp.combine(tab.a[i, :i], ks, skip_zeros=False)
            ks.append(f(t + float(tab.c[i]) * h_eff, yi, args))
        y1 = y + hv * _exp.combine(tab.b, ks, skip_zeros=False)
        err = hv * _exp.combine(tab.err_weights, ks, skip_zeros=False)
        scale = atol_e + rtol_e * torch.maximum(y.abs(), y1.abs())
        err_norm = torch.sqrt(torch.mean((err / scale) ** 2, -1)).detach()
        # CONTD5: fill every output point inside (t, t+h]
        ydiff = y1 - y
        bspl = hv * ks[0] - ydiff
        r4 = ydiff - hv * ks[6] - bspl
        r5 = hv * _exp.combine(D_CONT5, ks, skip_zeros=False)
        th = torch.clamp(theta, 0.0, 1.0)[..., None]
        u = lambda x: x[..., None, :]  # noqa: E731
        interp = u(y) + th * (u(ydiff) + (1.0 - th) * (u(bspl) + th * (u(r4) + (1.0 - th)
                                                                       * u(r5))))
        return y1, ks[6], err_norm, interp

    return _dense_solve(step, f, y0, ts, args, tab.error_order, rtol_e, atol_e, max_steps,
                        checkpoint_body, return_stats)


def odeint_dop853_dense(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 256,
    checkpoint_body: bool = True,
    return_stats: bool = False,
):
    """Dense-output DOP853: free-running 8th-order steps, 7th-order continuous
    extension (Hairer's dop853.f; scipy's Dop853DenseOutput). Three extra
    field evaluations per trial step for the dense stages 14-16."""
    tab = TABLEAUS["dop853"]
    dtype = y0.dtype
    rtol_e, atol_e = _exp._effective_tols(rtol, atol, dtype)
    n = y0.shape[-1]

    def step(t, y, fy, h_eff, theta):
        hv = h_eff[..., None]
        # 12 core stages (not FSAL) + f_new as row 12
        ks = [fy]
        for i in range(1, 12):
            yi = y + hv * _exp.combine(tab.a[i, :i], ks)
            ks.append(f(t + float(tab.c[i]) * h_eff, yi, args))
        y1 = y + hv * _exp.combine(tab.b, ks, skip_zeros=False)
        f_new = f(t + h_eff, y1, args)
        k13 = ks + [f_new]
        # DOP853 error: err5*|err5|/sqrt(|err5|^2 + 0.01|err3|^2) (scipy's rule)
        scale = atol_e + rtol_e * torch.maximum(y.abs(), y1.abs())
        v5 = _exp.combine(tab.err_weights, k13, skip_zeros=False) / scale
        v3 = _exp.combine(tab.err_weights_low, k13, skip_zeros=False) / scale
        n5, n3 = (v5 * v5).sum(-1), (v3 * v3).sum(-1)
        denom = n5 + 0.01 * n3
        safe = torch.sqrt(torch.clamp(denom * n, min=torch.finfo(dtype).tiny))
        err_norm = torch.where(denom > 0, h_eff.abs() * n5 / safe,
                               torch.zeros_like(h_eff)).detach()
        # dense stages 14-16, each may use the ones before it
        k_rows = list(k13)
        for s in range(3):
            yi = y + hv * _exp.combine(DOP853_A_EXTRA[s, :13 + s], k_rows)
            k_rows.append(f(t + float(DOP853_C_EXTRA[s]) * h_eff, yi, args))
        # continuous extension rows (scipy Dop853DenseOutput._call_impl)
        ydiff = y1 - y
        F = [ydiff, hv * ks[0] - ydiff, 2.0 * ydiff - hv * (f_new + ks[0])]
        F += [hv * _exp.combine(DOP853_D[r], k_rows, skip_zeros=False) for r in range(4)]
        th = torch.clamp(theta, 0.0, 1.0)[..., None]
        acc = y.new_zeros(*theta.shape, n)
        for i in range(6, -1, -1):  # reversed(F) Horner scheme
            acc = acc + F[i][..., None, :]
            acc = acc * (th if (6 - i) % 2 == 0 else (1.0 - th))
        return y1, f_new, err_norm, acc + y[..., None, :]

    return _dense_solve(step, f, y0, ts, args, tab.error_order, rtol_e, atol_e, max_steps,
                        checkpoint_body, return_stats)
