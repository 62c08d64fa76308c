"""Variable-order BDF (orders 1-5) with quasi-constant step size.

Port of `hybrid_ode_tpu/solvers/bdf.py`: the fixed-leading-coefficient
method of scipy's BDF (Shampine & Reichelt's ode15s family) with the whole
multistep machinery (backward-difference array, Newton correction, order
selection, difference-array rescaling on every step change) in masked
fixed-shape updates. Batching is written out: y0 (..., n), and every sample
carries its own difference array D (..., MAX_ORDER+3, n), order k (...),
step size, equal-step counter and clock.

Per step:
  * predict   y_pred = sum_{i<=k} D[i]
  * correct   d = y_new - y_pred from the simplified-Newton solve of
              d = c f(t+h, y_pred+d) - psi,  c = h/alpha_k
  * error     ||err_const_k * d|| (order k); orders k+-1 estimated from
              D[k], D[k+2] once k+1 equal steps have been taken
  * adapt     order += argmax of the three step factors; h *= factor; D is
              rescaled by R(k, r) R(k, 1) whenever h changes.

As in the JAX package, steps are clamped onto the output grid with the
free-running step size restored after each interval, and the Newton loop
is fixed-length with its convergence folded into the error norm. Scan mode
runs every trial step of the budget; while mode stops once every sample
has reached the interval's end (the same result: a finished sample is held
fixed). Row sums and the 6x6 products are written out elementwise, so a
sample's bits do not depend on its batch and no matmul can take TF32.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from hybrid_ode_torch.solvers import explicit as _exp
from hybrid_ode_torch.solvers.implicit import (NEWTON_ITERS, NEWTON_TOL_FACTOR, _lu, _lu_solve,
                                               jacobian)

MAX_ORDER = 5
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
SAFETY = 0.9

# Fixed-leading-coefficient BDF constants (Shampine & Reichelt 1997, eq. 2):
# kappa tunes the stability of orders 1-5; alpha_k is the leading
# coefficient; error_const_k scales the local truncation error err = C_k d.
_KAPPA = np.array([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0])
_GAMMA = np.hstack([0.0, np.cumsum(1.0 / np.arange(1, MAX_ORDER + 1))])
_ALPHA = (1.0 - _KAPPA) * _GAMMA
_ERR_CONST = _KAPPA * _GAMMA + 1.0 / np.arange(1, MAX_ORDER + 2)

_ROWS = MAX_ORDER + 3


def _table(values, k: torch.Tensor, dtype) -> torch.Tensor:
    """values[k] per sample; indices past the end clamp, as JAX gathers do."""
    v = torch.as_tensor(values, dtype=dtype, device=k.device)
    return v[torch.clamp(k, 0, len(values) - 1)]


def _row(D: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """D[..., i, :] for per-sample row indices i (...)."""
    idx = i[..., None, None].expand(*i.shape, 1, D.shape[-1])
    return torch.gather(D, -2, idx)[..., 0, :]


def _weighted_rows(w: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """sum_i w[..., i] D[..., i, :] over the rows, left to right."""
    acc = w[..., 0, None] * D[..., 0, :]
    for i in range(1, w.shape[-1]):
        acc = acc + w[..., i, None] * D[..., i, :]
    return acc


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., p, q) @ b (..., q, r), the sum over q left to right."""
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., :, j, None] * b[..., None, j, :]
    return acc


def _R_matrix(k: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Difference-array rescaling matrices (..., MO+1, MO+1) for step ratios
    `factor` (...), the identity outside each sample's leading (k+1)x(k+1)
    block so rows above the current order pass through unchanged."""
    dtype, dev = factor.dtype, factor.device
    mo1 = MAX_ORDER + 1
    I = torch.arange(1, mo1, dtype=dtype, device=dev)[:, None]
    J = torch.arange(1, mo1, dtype=dtype, device=dev)[None, :]
    body = (I - 1.0 - factor[..., None, None] * J) / I                 # (..., MO, MO)
    # M[0] = 1, M[1:, 0] = 0, M[1:, 1:] = body
    zeros = torch.zeros((*factor.shape, MAX_ORDER, 1), dtype=dtype, device=dev)
    M = torch.cat([torch.ones((*factor.shape, 1, mo1), dtype=dtype, device=dev),
                   torch.cat([zeros, body], dim=-1)], dim=-2)
    R = torch.cumprod(M, dim=-2)
    ii = torch.arange(mo1, device=dev)[:, None]
    jj = torch.arange(mo1, device=dev)[None, :]
    kk = k[..., None, None]
    keep = (ii <= kk) & (jj <= kk)
    return torch.where(keep, R, torch.eye(mo1, dtype=dtype, device=dev))


def _rescale_D(D: torch.Tensor, k: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """D <- the change-of-step-size transform (scipy BDF's change_D)."""
    RU = _matmul(_R_matrix(k, factor), _R_matrix(k, torch.ones_like(factor)))
    head = _matmul(RU.transpose(-1, -2), D[..., :MAX_ORDER + 1, :])
    return torch.cat([head, D[..., MAX_ORDER + 1:, :]], dim=-2)


def _maybe_rescale(D, k, factor, n_eq):
    """Rescale only where the ratio is materially != 1 (a ratio within 1e-5
    of 1 rescales D by about the identity); a change of h resets the
    equal-step counter that gates order adaptation."""
    changed = (factor - 1.0).abs() > 1e-5
    D_new = _rescale_D(D, k, factor)
    return (torch.where(changed[..., None, None], D_new, D),
            torch.where(changed, torch.zeros_like(n_eq), n_eq))


def _masked_rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((x / scale) ** 2, dim=-1))


def _attempt_bdf_step(f, t, D, k, h, args, rtol, atol):
    """One BDF step attempt at order k: (y1, d, err_norm, scale); the error
    norm and scale are detached (step control is auxiliary: differentiating
    the controller's factors poisons the cotangents)."""
    dtype = D.dtype
    n = D.shape[-1]
    alpha = _table(_ALPHA, k, dtype)
    err_c = _table(_ERR_CONST, k, dtype)
    rows = torch.arange(_ROWS, device=D.device)
    gamma = torch.as_tensor(np.hstack([_GAMMA, np.zeros(2)]), dtype=dtype, device=D.device)
    kk = k[..., None]
    y_pred = _weighted_rows((rows <= kk).to(dtype), D)
    psi = _weighted_rows(((rows >= 1) & (rows <= kk)).to(dtype) * gamma, D) / alpha[..., None]

    c = h / alpha
    cv = c[..., None]
    t1 = t + h
    J = jacobian(f, t1, y_pred, args)
    lu = _lu(torch.eye(n, dtype=dtype, device=D.device) - c[..., None, None] * J)
    d = torch.zeros_like(y_pred)
    for _ in range(NEWTON_ITERS):
        G = cv * f(t1, y_pred + d, args) - psi - d
        dd = _lu_solve(lu, G)
        d = d + dd
        dd_rms = torch.sqrt(torch.mean(dd ** 2, dim=-1))
    y1 = y_pred + d
    scale = atol + rtol * torch.maximum(y_pred.abs(), y1.abs())
    err_norm = _masked_rms(err_c[..., None] * d, scale)
    ok = dd_rms <= NEWTON_TOL_FACTOR * torch.sqrt(torch.mean(scale ** 2, dim=-1))
    err_norm = torch.where(ok, err_norm, torch.clamp(err_norm, min=2.0))
    return y1, d, err_norm.detach(), scale.detach()


def _update_D_accept(D, k, d):
    """Post-acceptance difference update: D[k+2] = d - D[k+1]; D[k+1] = d;
    D[i] += D[i+1] cascading from i=k down to 0 (masked)."""
    old_k1 = _row(D, k + 1)
    rows = torch.arange(_ROWS, device=D.device)
    sel = rows[:, None] == (k + 2)[..., None, None]
    D = torch.where(sel, (d - old_k1)[..., None, :], D)
    D = torch.where(rows[:, None] == (k + 1)[..., None, None], d[..., None, :], D)
    out = list(D.unbind(-2))
    for i in range(MAX_ORDER, -1, -1):
        out[i] = out[i] + torch.where((i <= k)[..., None], out[i + 1], torch.zeros_like(d))
    return torch.stack(out, dim=-2)


def _order_and_step_adapt(D, k, h, err_norm, scale, n_eq):
    """After k+1 equal steps: pick the order (k-1, k, k+1) whose controller
    factor is largest, rescale D, and apply the step factor."""
    dtype = D.dtype
    tiny = torch.finfo(dtype).tiny
    inf = torch.full_like(err_norm, float("inf"))
    Dk = _row(D, k).detach()
    Dk2 = _row(D, k + 2).detach()
    err_m = torch.where(k > 1, _masked_rms(_table(_ERR_CONST, k - 1, dtype)[..., None] * Dk, scale),
                        inf)
    err_p = torch.where(k < MAX_ORDER,
                        _masked_rms(_table(_ERR_CONST, k + 1, dtype)[..., None] * Dk2, scale), inf)
    kf = k.to(dtype)
    f_m = torch.clamp(err_m, min=tiny) ** (-1.0 / kf)
    f_0 = torch.clamp(err_norm, min=tiny) ** (-1.0 / (kf + 1.0))
    f_p = torch.clamp(err_p, min=tiny) ** (-1.0 / (kf + 2.0))
    factors = torch.stack([f_m, f_0, f_p], dim=-1)
    delta = torch.argmax(factors, dim=-1).to(k.dtype) - 1  # the first maximum, as jnp
    k_new = torch.clamp(k + delta, 1, MAX_ORDER)
    factor = torch.clamp(SAFETY * factors.max(dim=-1).values, max=MAX_FACTOR)
    D_new, _ = _maybe_rescale(D, k_new, factor, n_eq)
    return D_new, k_new, h * factor


def _reject_factor(errn, k):
    """Shrink factor after a rejection; a non-finite error norm takes the
    largest shrink, so the step size stays finite and can recover."""
    dtype = errn.dtype
    fac = torch.clamp(SAFETY * torch.clamp(errn, min=torch.finfo(dtype).tiny)
                      ** (-1.0 / (k.to(dtype) + 1.0)), min=MIN_FACTOR)
    return torch.where(torch.isfinite(errn), fac, torch.full_like(fac, MIN_FACTOR))


def _bdf_trial(f, t, t_end, D, k, h, n_eq, done, args, rtol, atol):
    """One masked trial step toward t_end, shared by the interval driver and
    the dense-output driver: (h_eff, accept, d, move, finish, D_acc, then the
    acceptance path's D_a, k_a, h_a, ready, n_eq_a, then the rejection
    path's D_rej, h_rej). D_acc is the difference array after the accepted
    step, before any order or step change."""
    dtype = D.dtype
    remaining = t_end - t
    h_eff = torch.minimum(h, torch.clamp(remaining, min=torch.finfo(dtype).tiny))
    at_end = h >= remaining
    # clamp => step-size change => rescale the difference array
    D_c, n_eq_c = _maybe_rescale(D, k, h_eff / h, n_eq)
    y1, d, errn, scale = _attempt_bdf_step(f, t, D_c, k, h_eff, args, rtol, atol)
    accept = errn <= 1.0
    move = accept & ~done
    finish = move & at_end
    # acceptance path
    D_acc = _update_D_accept(D_c, k, d)
    n_eq_acc = n_eq_c + 1
    ready = n_eq_acc >= k + 1
    D_ad, k_ad, h_ad = _order_and_step_adapt(D_acc, k, h_eff, errn, scale, n_eq_acc)
    D_a = torch.where(ready[..., None, None], D_ad, D_acc)
    k_a = torch.where(ready, k_ad, k)
    h_a = torch.where(ready, h_ad, h_eff)
    n_eq_a = torch.where(ready, torch.zeros_like(n_eq_acc), n_eq_acc)
    # rejection path: shrink and rescale
    fac_rej = _reject_factor(errn, k)
    D_rej, _ = _maybe_rescale(D_c, k, fac_rej, n_eq_c)
    return (h_eff, accept, d, move, finish, D_acc, D_a, k_a, h_a, ready, n_eq_a, D_rej,
            h_eff * fac_rej)


def _select(done, move, keep, acc, rej):
    """where(done, keep, where(move, acc, rej)) with the masks broadcast."""
    extra = (None,) * (keep.ndim - done.ndim)
    return torch.where(done[(..., *extra)], keep,
                       torch.where(move[(..., *extra)], acc, rej))


def odeint_bdf(
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
    """Variable-order BDF(1-5) on the output grid; `odeint` driver contract
    (y0 (..., n), ts (T,) or (..., T))."""
    if mode not in ("scan", "while"):
        raise ValueError(f"unknown mode: {mode!r}")
    dtype = y0.dtype
    ts = _exp._grid(y0, ts)
    rtol_e, atol_e = _exp._effective_tols(rtol, atol, dtype)
    f0 = f(ts[..., 0], y0, args)
    h_init = _exp.initial_step_size(f, ts[..., 0], y0, f0, args, 1, rtol_e, atol_e)

    def interval(t0, t1, D, k, h_free, n_eq):
        t, h_cur = t0, h_free
        done = torch.zeros(t0.shape, dtype=torch.bool, device=y0.device)
        nacc = torch.zeros(t0.shape, dtype=torch.int32, device=y0.device)
        nrej = torch.zeros_like(nacc)
        for _ in range(max_steps_per_interval):
            if mode == "while" and not _exp.host_flags((~done).any())[0]:
                break
            (h_eff, accept, _d, move, finish, _D_acc, D_a, k_a, h_a, ready, n_eq_a, D_rej,
             h_rej) = _bdf_trial(f, t, t1, D, k, h_cur, n_eq, done, args, rtol_e, atol_e)
            t = torch.where(finish, t1, torch.where(move, t + h_eff, t))
            D = _select(done, move, D, D_a, D_rej)
            k = _select(done, move, k, k_a, k)
            h_new = _select(done, move, h_cur, h_a, h_rej)
            n_eq = _select(done, move, n_eq, n_eq_a, torch.zeros_like(n_eq))
            # the free-running step size survives interval-end clamping
            h_free = torch.where(done, h_free, torch.where(
                move & ready, h_new, torch.where(finish, h_free, h_new)))
            h_cur = h_new
            nacc = nacc + move.to(torch.int32)
            nrej = nrej + (~accept & ~done).to(torch.int32)
            done = done | finish
        # restore the free-running step for the next interval (h_cur may have
        # been clamped to a sliver at the interval end)
        h_next = torch.maximum(h_free, h_cur)
        D, n_eq = _maybe_rescale(D, k, h_next / h_cur, n_eq)
        return D, k, h_next, n_eq, D[..., 0, :], done, nacc, nrej

    batch = y0.shape[:-1]
    D0 = torch.cat([y0[..., None, :], (h_init[..., None] * f0)[..., None, :],
                    y0.new_zeros((*batch, _ROWS - 2, y0.shape[-1]))], dim=-2)
    k0 = torch.ones(batch, dtype=torch.int64, device=y0.device)
    n_eq0 = torch.zeros(batch, dtype=torch.int64, device=y0.device)
    out = _exp._intervals(interval, ts, (D0, k0, h_init, n_eq0), mode, checkpoint_intervals)
    return _exp._finish(y0, *out, return_stats)
