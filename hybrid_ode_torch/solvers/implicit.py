"""Implicit stiff solvers: Radau IIA (order 5) and variable-step BDF2.

Port of `hybrid_ode_tpu/solvers/implicit.py`. Each implicit step is a
simplified-Newton solve with a dense LU factored once per step and reused
for all NEWTON_ITERS iterations. Batching is written out as in the explicit
solvers: y0 (..., n), per-sample times and step sizes (...), masks where the
JAX code has per-sample control flow. The Jacobian df/dy is (..., n, n),
taken by n forward-mode products vmapped over the basis tangents (one field
call on an n-times larger batch); the 3 Radau stages are one field call on a
3-times larger batch. Both stay differentiable (reverse over forward), so
scan-mode gradients flow through J as the JAX package's do.

LU runs through `lu_factor_ex` / `lu_solve` / `solve_ex` without error
checks: no host synchronisation, and a singular matrix gives inf / NaN that
the masks discard, as the JAX LU does. Small products (the 3x3 Butcher
matrix against the stages) are written out elementwise, so a sample's bits
do not depend on the batch it is in and no matmul can take TF32.

Radau IIA(3 stages, order 5):
  * collocation nodes c = [(4-sqrt6)/10, (4+sqrt6)/10, 1]; stiffly accurate.
  * simplified Newton on the stacked stage increments Z (3, n) with iteration
    matrix M = I - h (A (x) J), J = df/dy at (t0, y0), stage-major like
    Z.reshape(-1).
  * embedded 3rd-order error estimate (weights from the order conditions
    with bhat_0 = gamma0, the real eigenvalue of A), smoothed by
    (I - h gamma0 J)^-1 as in Hairer-Wanner's RADAU5; a Newton solve that
    does not converge inflates the error norm to at least 2.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from hybrid_ode_torch.solvers import explicit as _exp

# Radau IIA coefficients (order 5, 3 stages), computed at import.
_SQ6 = np.sqrt(6.0)
RADAU_C = np.array([(4.0 - _SQ6) / 10.0, (4.0 + _SQ6) / 10.0, 1.0])
RADAU_A = np.array(
    [
        [(88.0 - 7.0 * _SQ6) / 360.0, (296.0 - 169.0 * _SQ6) / 1800.0, (-2.0 + 3.0 * _SQ6) / 225.0],
        [(296.0 + 169.0 * _SQ6) / 1800.0, (88.0 + 7.0 * _SQ6) / 360.0, (-2.0 - 3.0 * _SQ6) / 225.0],
        [(16.0 - _SQ6) / 36.0, (16.0 + _SQ6) / 36.0, 1.0 / 9.0],
    ]
)
RADAU_B = RADAU_A[-1]  # stiffly accurate

# gamma0 = the real eigenvalue of A (~0.27489); bhat solves the order-3
# conditions sum_i bhat_i c_i^{k-1} = 1/k - gamma0*delta_{k1}.
_eigs = np.linalg.eigvals(RADAU_A)
RADAU_GAMMA0 = float(np.real(_eigs[np.argmin(np.abs(np.imag(_eigs)))]))
_V = np.vander(RADAU_C, 3, increasing=True).T  # rows: c^0, c^1, c^2
_rhs = np.array([1.0 - RADAU_GAMMA0, 0.5, 1.0 / 3.0])
RADAU_BHAT = np.linalg.solve(_V, _rhs)
RADAU_ERR_W = RADAU_BHAT - RADAU_B  # stage-weight part of the error estimate

NEWTON_ITERS = 7
NEWTON_TOL_FACTOR = 0.03  # converged when |dZ|_rms <= factor * tol scale


def jacobian(f: Callable, t: torch.Tensor, y: torch.Tensor, args: Any) -> torch.Tensor:
    """df/dy (..., n, n) of the field at per-sample (t, y): column j is the
    forward-mode product with the basis tangent e_j broadcast over the
    batch; the n products run as one vmapped field call."""
    n = y.shape[-1]
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    basis = eye.reshape(n, *([1] * (y.ndim - 1)), n).expand(n, *y.shape).contiguous()
    y = y.contiguous()  # forward mode writes tangents into the primal's layout

    def column(v):
        return torch.func.jvp(lambda yy: f(t, yy, args), (y,), (v,))[1]

    return torch.movedim(torch.func.vmap(column)(basis), 0, -1)


def _stages(f: Callable, ts: torch.Tensor, ys: torch.Tensor, args: Any) -> torch.Tensor:
    """f at stacked stage points: ts (s, ...), ys (s, ..., n) -> (s, ..., n),
    one field call vmapped over the stage axis."""
    return torch.func.vmap(lambda ti, yi: f(ti, yi, args))(ts, ys)


def _lu_solve(lu, b: torch.Tensor) -> torch.Tensor:
    """Solve with factors (LU, pivots) for right-hand sides b (..., m)."""
    return torch.linalg.lu_solve(lu[0], lu[1], b[..., None])[..., 0]


def _lu(M: torch.Tensor):
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    return LU, piv


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x, dim=-1))


def make_radau_step(f: Callable, rtol: float, atol: float) -> Callable:
    """(t, y, fy, h, args) -> (y1, f1, err_norm), plug-compatible with the
    explicit interval driver `explicit._interval`."""
    full = make_radau_step_full(f, rtol, atol)

    def step(t, y, fy, h, args):
        y1, f1, err_norm, _Z = full(t, y, fy, h, args)
        return y1, f1, err_norm

    return step


def make_radau_step_full(f: Callable, rtol: float, atol: float) -> Callable:
    """Like make_radau_step but also returns the stage increments Z (..., 3, n),
    the collocation values y(t + c_i h) - y the dense-output driver
    interpolates (solvers/dense.py odeint_radau_dense)."""
    A, c, ew = RADAU_A.tolist(), RADAU_C.tolist(), RADAU_ERR_W.tolist()
    g0 = RADAU_GAMMA0

    def step(t, y, fy, h, args):
        n = y.shape[-1]
        hv = h[..., None]
        J = jacobian(f, t, y, args)                                   # (..., n, n)
        A_t = torch.as_tensor(RADAU_A, dtype=y.dtype, device=y.device)
        kron = (A_t[:, None, :, None] * J[..., None, :, None, :]).reshape(
            *J.shape[:-2], 3 * n, 3 * n)
        eye3n = torch.eye(3 * n, dtype=y.dtype, device=y.device)
        lu = _lu(eye3n - h[..., None, None] * kron)
        stage_ts = torch.stack([t + ci * h for ci in c])              # (3, ...)

        def F_of_Z(Z):  # (3, ..., n) -> stage derivatives (3, ..., n)
            return _stages(f, stage_ts, y + Z, args)

        def times_A(F, row):  # sum_j A[row][j] F[j], left to right
            return A[row][0] * F[0] + A[row][1] * F[1] + A[row][2] * F[2]

        Z = y.new_zeros((3, *y.shape))
        for _ in range(NEWTON_ITERS):
            Fz = F_of_Z(Z)
            G = torch.stack([Z[i] - hv * times_A(Fz, i) for i in range(3)])
            # stage-major right-hand side, as Z.reshape(-1) in the JAX package
            rhs = torch.movedim(G, 0, -2).reshape(*y.shape[:-1], 3 * n)
            dZ = torch.movedim(-_lu_solve(lu, rhs).reshape(*y.shape[:-1], 3, n), -2, 0)
            Z = Z + dZ
            dz_rms = _rms(torch.movedim(dZ, 0, -2).flatten(-2))

        y1 = y + Z[2]  # stiffly accurate: c3 = 1
        Fz = F_of_Z(Z)
        f1 = Fz[2]
        # embedded error, smoothed through (I - h gamma0 J)
        err_raw = hv * (g0 * fy + (ew[0] * Fz[0] + ew[1] * Fz[1] + ew[2] * Fz[2]))
        eye_n = torch.eye(n, dtype=y.dtype, device=y.device)
        Msm = eye_n - (h * g0)[..., None, None] * J
        err = torch.linalg.solve_ex(Msm, err_raw[..., None])[0][..., 0]
        scale = atol + rtol * torch.maximum(y.abs(), y1.abs())
        err_norm = _rms(err / scale)
        # a Newton solve that did not converge is rejected through its norm
        newton_ok = dz_rms <= NEWTON_TOL_FACTOR * _rms(scale)
        err_norm = torch.where(newton_ok, err_norm, torch.clamp(err_norm, min=2.0))
        return y1, f1, err_norm, torch.movedim(Z, 0, -2)

    return step


def odeint_radau(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    mode: str = "scan",
    max_steps_per_interval: int = 32,
    checkpoint_intervals: bool = True,
    return_stats: bool = False,
):
    """Radau IIA(5) over the output grid; the driver contract of
    `explicit.odeint_erk` (y0 (..., n), ts (T,) or (..., T))."""
    rtol_e, atol_e = _exp._effective_tols(rtol, atol, y0.dtype)
    f = _exp.field_spans(f)
    return _exp.odeint_adaptive(f, y0, ts, args, make_radau_step(f, rtol_e, atol_e), 3, rtol_e,
                                atol_e, mode, max_steps_per_interval, checkpoint_intervals,
                                return_stats)


# ---------------------------------------------------------------------------
# BDF2 (variable step, Newton-corrected): the stiff alternative with cheap steps.
# ---------------------------------------------------------------------------

def _bdf_newton(f, t1, y_pred, rhs_const, beta, h, args, rtol, atol):
    """Solve y = rhs_const + beta*h*f(t1, y) by simplified Newton from y_pred.

    Also returns the LU of (I - beta*h*J), through which the caller smooths
    its error estimate (stiff problems: raw predictor differences
    overestimate the error in the fast-decaying directions)."""
    n = y_pred.shape[-1]
    bh = beta * h
    J = jacobian(f, t1, y_pred, args)
    lu = _lu(torch.eye(n, dtype=y_pred.dtype, device=y_pred.device) - bh[..., None, None] * J)
    yk = y_pred
    for _ in range(NEWTON_ITERS):
        G = yk - rhs_const - bh[..., None] * f(t1, yk, args)
        dy = -_lu_solve(lu, G)
        yk = yk + dy
        dy_rms = _rms(dy)
    scale = atol + rtol * yk.abs()
    ok = dy_rms <= NEWTON_TOL_FACTOR * _rms(scale)
    return yk, ok, lu


def odeint_bdf2(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    mode: str = "scan",
    max_steps_per_interval: int = 64,
    checkpoint_intervals: bool = True,
    return_stats: bool = False,
):
    """Variable-step BDF2 on the output grid.

    Formula (step ratio r = h_n / h_{n-1}):
        y_{n+1} = [(1+r)^2 y_n - r^2 y_{n-1}] / (1 + 2r)
                  + h_n (1+r)/(1+2r) f(t_{n+1}, y_{n+1})
    The first step of the trajectory is implicit Euler. The local error is
    the Milne difference against a quadratic predictor, filtered through
    the Newton LU. Scan mode runs every trial step; while mode stops once
    every sample has reached the interval's end (the same result: a finished
    sample is held fixed)."""
    if mode not in ("scan", "while"):
        raise ValueError(f"unknown mode: {mode!r}")
    dtype = y0.dtype
    ts = _exp._grid(y0, ts)
    rtol_e, atol_e = _exp._effective_tols(rtol, atol, dtype)
    error_order = 2
    tiny = torch.finfo(dtype).tiny
    f0 = f(ts[..., 0], y0, args)
    h_init = _exp.initial_step_size(f, ts[..., 0], y0, f0, args, error_order, rtol_e, atol_e)

    def attempt_step(t, y, y_prev, h, h_prev, have_hist):
        t1 = t + h
        hp = torch.clamp(h_prev, min=tiny)
        r = h / hp
        # BDF2 coefficients (implicit Euler without history)
        denom = 1.0 + 2.0 * r
        rv, hist = r[..., None], have_hist[..., None]
        rhs_bdf2 = ((1.0 + rv) ** 2 * y - rv ** 2 * y_prev) / denom[..., None]
        beta_bdf2 = (1.0 + r) / denom
        rhs_c = torch.where(hist, rhs_bdf2, y)
        beta = torch.where(have_hist, beta_bdf2, torch.ones_like(r))
        # quadratic predictor through (y_prev, y, f(t, y)): O(h^3), so the
        # Milne difference is order-consistent with BDF2's local error
        fy = f(t, y, args)
        hpv, hv = hp[..., None], h[..., None]
        a_quad = (y_prev - y + fy * hpv) / hpv ** 2
        y_quad = y + fy * hv + a_quad * hv ** 2
        y_pred = torch.where(hist, y_quad, y + hv * fy)
        y1, ok, lu = _bdf_newton(f, t1, y_pred, rhs_c, beta, h, args, rtol_e, atol_e)
        milne = (1.0 + r) / torch.clamp(r, min=tiny)
        err = (y1 - y_pred) * torch.where(have_hist, milne, torch.full_like(r, 0.5))[..., None]
        err = _lu_solve(lu, err)  # stiff smoothing through (I - beta h J)^-1
        scale = atol_e + rtol_e * torch.maximum(y.abs(), y1.abs())
        errn = _rms(err / scale)
        errn = torch.where(ok, errn, torch.clamp(errn, min=2.0))
        return y1, errn

    def interval(t0, t1, y, y_prev, h, h_prev, have_hist):
        t = t0
        done = torch.zeros(t0.shape, dtype=torch.bool, device=y.device)
        nacc = torch.zeros(t0.shape, dtype=torch.int32, device=y.device)
        nrej = torch.zeros_like(nacc)
        for _ in range(max_steps_per_interval):
            if mode == "while" and not _exp.host_flags((~done).any())[0]:
                break
            remaining = t1 - t
            at_end = h >= remaining
            h_eff = torch.minimum(h, remaining)
            y1, errn = attempt_step(t, y, y_prev, h_eff, h_prev, have_hist)
            accept = errn <= 1.0
            move = accept & ~done
            mv = move[..., None]
            t = torch.where(move, torch.where(at_end, t1, t + h_eff), t)
            y_prev = torch.where(mv, y, y_prev)
            y = torch.where(mv, y1, y)
            h_prev = torch.where(move, h_eff, h_prev)
            have_hist = have_hist | move
            factor = _exp._controller_factor(errn, accept, error_order, dtype)
            cand = h_eff * factor
            h_cand = torch.where(accept & at_end, torch.maximum(h, cand), cand)
            h = torch.where(done, h, h_cand)
            nacc = nacc + move.to(torch.int32)
            nrej = nrej + (~accept & ~done).to(torch.int32)
            done = done | (move & at_end)
        return y, y_prev, h, h_prev, have_hist, y, done, nacc, nrej

    have_hist = torch.zeros(y0.shape[:-1], dtype=torch.bool, device=y0.device)
    out = _exp._intervals(interval, ts, (y0, y0, h_init, h_init, have_hist), mode,
                          checkpoint_intervals)
    return _exp._finish(y0, *out, return_stats)
