"""Batch-synchronised adaptive Runge-Kutta integration (two-pass gradients).

Port of `hybrid_ode_tpu/solvers/sync.py`. One step controller serves the
whole batch:

  PASS 1 (mesh search, no autograd): every trial step advances all samples
  together in normalised time sigma; it is accepted on the batch-maximum of
  the per-sample RMS error norms, so the mesh honours the tolerance for the
  worst sample. The loop takes exactly the steps the batch needs; deciding
  to go on costs one device-to-host synchronisation per trial step.

  PASS 2 (differentiable re-integration): the accepted mesh, a compacted list
  of (interval, sigma, h) steps, is data (step sizes are detached everywhere
  in this package), and the trajectory is recomputed as plain ERK steps on it
  with autograd.

Static-budget contract: at most `total_step_budget` accepted steps are kept.
If the batch needs more, the tail is dropped and `StepStats.success` is
False.

Batching is written out: the field takes y (B, n) and per-sample times
(B,), so the JAX signature's `args_axes` has no role and is not taken.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import tree_leaves

from hybrid_ode_torch.solvers.dense import D_CONT5
from hybrid_ode_torch.solvers.explicit import (
    StepStats,
    _controller_factor,
    _effective_tols,
    combine,
    host_flags,
    initial_step_size,
    make_erk_step,
)
from hybrid_ode_torch.solvers.tableaus import TABLEAUS, ERKTableau


def _sigma_field(f: Callable) -> Callable:
    """The field in normalised interval time: sigma in [0, 1] spans
    [t0_i, t1_i] and dy/dsigma = f(t, y) * dt_i, each sample on its own
    clock."""

    def fs(sigma, y, sargs):
        t0, dt, args = sargs
        return f(t0 + sigma * dt, y, args) * dt[..., None]

    return fs


def _is_dopri5(tab: ERKTableau) -> bool:
    return tab is TABLEAUS["dopri5"]


def odeint_erk_sync(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    tab: ERKTableau,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps_per_interval: int = 32,
    total_step_budget: Optional[int] = None,
    span: str = "auto",
    max_step_intervals: float = 4.0,
    stop_signals: Optional[Any] = None,
    return_stats: bool = False,
):
    """Batch-synchronised adaptive ERK solve: (B, n) x (B, T) -> (B, T, n).

    Args:
        f: batched field `(t (B,), y (B, n), args) -> dy (B, n)`.
        ts: output times (B, T) per sample or (T,) shared, increasing.
        max_steps_per_interval: pass-1 trial-step budget per output interval.
        total_step_budget: most accepted steps kept (default 4 * (T-1) for
            span='interval', (T-1) + 16 for span='global').
        span: 'interval' lands a step on every output point (any tableau);
            'global' free-runs the shared controller over the whole span and
            reports outputs through dopri5's CONTD5 dense interpolant, with a
            forced step boundary where `stop_signals` kink; 'auto' is
            'global' for the dopri5 tableau object, else 'interval'.

    Returns ys (B, T, n), and with return_stats batch-level StepStats
    (accepted / rejected shared steps; success = every interval reached its
    end and the budget held)."""
    dtype = y0.dtype
    B, n = y0.shape
    ts = torch.as_tensor(ts, dtype=dtype, device=y0.device)
    if ts.ndim == 1:
        ts = ts[None, :].expand(B, ts.shape[0])
    T = ts.shape[1]
    n_int = T - 1
    if span not in ("auto", "interval", "global"):
        raise ValueError(f"span must be 'auto'|'interval'|'global', got {span!r}")
    is_dopri5 = _is_dopri5(tab)
    if span == "auto":
        span = "global" if is_dopri5 else "interval"
    if span == "global":
        if not is_dopri5:
            raise ValueError(
                "span='global' needs dopri5's CONTD5 dense interpolant; "
                "use span='interval' for other tableaus")
        return _sync_global_dopri5(
            f, y0, ts, args, tab, rtol=rtol, atol=atol,
            total_step_budget=total_step_budget,
            max_trial_steps=max_steps_per_interval * n_int,
            max_step_intervals=max_step_intervals, stop_signals=stop_signals,
            return_stats=return_stats)
    budget = int(total_step_budget) if total_step_budget else 4 * n_int
    rtol_e, atol_e = _effective_tols(rtol, atol, dtype)
    fs = _sigma_field(f)
    step = make_erk_step(fs, tab, rtol_e, atol_e)
    dts = ts[:, 1:] - ts[:, :-1]                      # (B, n_int)

    # ---- pass 1: shared-controller mesh search, no autograd ---------------
    mesh, dones = [], []   # mesh: per interval, the accepted (sigma, h) steps
    with torch.no_grad():
        f_phys = f(ts[:, 0], y0, args)
        zero = torch.zeros((), dtype=dtype, device=y0.device)
        h = initial_step_size(fs, zero, y0, f_phys * dts[:, :1], (ts[:, 0], dts[:, 0], args),
                              tab.error_order, rtol_e, atol_e).min()
        y = y0
        for k in range(n_int):
            sargs = (ts[:, k], dts[:, k], args)
            fy = f_phys * dts[:, k, None]
            sigma, done, hs = zero, False, []
            for _ in range(max_steps_per_interval):
                remaining = 1.0 - sigma
                at_end = h >= remaining
                h_eff = torch.minimum(h, remaining)
                y1, f1, errn = step(sigma, y, fy, h_eff, sargs)
                err_max = errn.max()                # batch-synchronised accept
                accept_t = err_max <= 1.0
                accept, end = host_flags(accept_t, at_end)
                if accept:
                    hs.append(h_eff)
                    sigma = torch.ones_like(sigma) if end else sigma + h_eff
                    y, fy = y1, f1
                cand = h_eff * _controller_factor(err_max, accept_t, tab.error_order, dtype)
                h = torch.maximum(h, cand) if accept and end else cand
                if accept and end:
                    done = True
                    break
            f_phys = fy / dts[:, k, None]
            hrow = torch.stack(hs) if hs else h.new_zeros(0)
            mesh.append([(k, s, hh) for s, hh in zip(torch.cumsum(hrow, 0) - hrow, hrow)])
            dones.append(done)

    # ---- pass 2: differentiable re-integration on the kept mesh -----------
    kept = [s for row in mesh for s in row][:budget]
    y, f_phys = y0, f(ts[:, 0], y0, args)
    ys_flat = []
    for k, sigma, hh in kept:
        dt = dts[:, k]
        y, f1, _ = step(sigma, y, f_phys * dt[:, None], hh, (ts[:, k], dt, args))
        f_phys = f1 / dt[:, None]
        ys_flat.append(y)
    outs, offset = [], 0
    for row in mesh:
        offset += len(row)
        end = min(max(offset - 1, 0), budget - 1)   # a dropped tail keeps the last kept y
        outs.append(ys_flat[min(end, len(ys_flat) - 1)] if ys_flat else y0)
    ys_full = torch.stack([y0] + outs, dim=1)
    if return_stats:
        total = sum(len(row) for row in mesh)
        dev = y0.device
        return ys_full, StepStats(
            n_accepted=torch.tensor(total, dtype=torch.int32, device=dev),
            n_rejected=torch.tensor(0, dtype=torch.int32, device=dev),  # shared rejects not logged
            success=torch.tensor(all(dones) and total <= budget, device=dev))
    return ys_full


def _control_kink_stops(stop_signals: Any, T: int, dtype: torch.dtype, device=None,
                        kink_tol: float = 1e-3) -> torch.Tensor:
    """Grid sigmas where any control signal kinks; big elsewhere. (T,).

    Grid point k is a forced step boundary when the normalised second
    difference |s[k+1] - 2 s[k] + s[k-1]| / max|s| of any signal for any
    sample exceeds kink_tol: the linearly interpolated signal's slope changes
    there, so free-running stages could straddle it unsampled."""
    big = torch.tensor(2.0 * T + 4.0, dtype=dtype, device=device)
    sig_list = [s for s in tree_leaves(stop_signals)
                if torch.is_tensor(s) and s.ndim >= 1 and s.shape[-1] == T]
    if not sig_list:
        return big.expand(T).clone()
    kink = torch.zeros(T - 2, dtype=dtype, device=device)
    for s in sig_list:
        flat = s.detach().to(dtype).reshape(-1, T)
        d2 = (flat[:, 2:] - 2.0 * flat[:, 1:-1] + flat[:, :-2]).abs()
        scale = torch.clamp(flat.abs().max(), min=torch.finfo(dtype).tiny)
        kink = torch.maximum(kink, d2.max(0).values / scale)
    inner = torch.where(kink > kink_tol, torch.arange(1, T - 1, dtype=dtype, device=device), big)
    return torch.cat([big[None], inner, big[None]])


def _sync_global_dopri5(f, y0, ts, args, tab, *, rtol, atol, total_step_budget,
                        max_trial_steps, max_step_intervals, stop_signals, return_stats):
    """Batch-synchronised free-running dopri5 with CONTD5 dense output.

    Integrates global normalised time sigma in [0, T-1]: per sample,
    t_i(sigma) = ts[i,k] + (sigma-k) * dt_i[k] with k = floor(sigma), so
    per-sample grids synchronise; outputs are interpolation reads, as
    `scipy.integrate.solve_ivp(t_eval=...)` gives them. Grid points where a
    control signal kinks are forced step boundaries and elsewhere a step
    spans at most `max_step_intervals` output intervals (a step over a meal
    bolus could otherwise straddle it with no stage sampling it)."""
    dtype, dev = y0.dtype, y0.device
    B, n = y0.shape
    T = ts.shape[1]
    n_int = T - 1
    budget = int(total_step_budget) if total_step_budget else n_int + 16
    rtol_e, atol_e = _effective_tols(rtol, atol, dtype)
    S_end = torch.tensor(float(n_int), dtype=dtype, device=dev)
    dts = ts[:, 1:] - ts[:, :-1]                      # (B, n_int)

    def at_k(x, k):
        return x.index_select(1, k.reshape(1)).squeeze(1)

    def k_of(sigma):
        return torch.clamp(torch.floor(sigma).to(torch.int64), 0, n_int - 1)

    def dopri5_step(sigma, y, f_phys, h):
        """One shared trial step: y1, f1 (physical), K (7 sigma-scaled stages)."""
        ks = [f_phys * at_k(dts, k_of(sigma))[:, None]]
        fp_last = f_phys
        for i in range(1, 7):
            yi = y + h * combine(tab.a[i, :i], ks)
            sigma_s = sigma + float(tab.c[i]) * h
            k = k_of(sigma_s)
            dt_k = at_k(dts, k)
            fp_last = f(at_k(ts, k) + (sigma_s - k.to(dtype)) * dt_k, yi, args)
            ks.append(fp_last * dt_k[:, None])
        return y + h * combine(tab.b, ks, skip_zeros=False), fp_last, ks

    # ---- pass 1: shared free-running mesh search, no autograd -------------
    with torch.no_grad():
        f_phys = f(ts[:, 0], y0, args)
        zero = torch.zeros((), dtype=dtype, device=dev)
        h = initial_step_size(_sigma_field(f), zero, y0, f_phys * dts[:, :1],
                              (ts[:, 0], dts[:, 0], args), tab.error_order, rtol_e, atol_e).min()
        kink_sigma = _control_kink_stops(stop_signals, T, dtype, dev)
        big_sig = torch.tensor(2.0 * n_int + 4.0, dtype=dtype, device=dev)
        y, sigma, done, trials = y0, zero, False, 0
        sig_buf, h_buf = [], []
        while not done and trials < max_trial_steps and len(h_buf) < budget:
            cand_stop = torch.where(kink_sigma > sigma + 1e-6, kink_sigma, big_sig)
            stop = torch.minimum(cand_stop.min(), S_end)
            remaining = stop - sigma
            h_free = torch.clamp(h, max=float(max_step_intervals))
            clipped_t = h_free >= remaining
            h_eff = torch.minimum(h_free, remaining)
            y1, f1, ks = dopri5_step(sigma, y, f_phys, h_eff)
            err = h_eff * combine(tab.err_weights, ks, skip_zeros=False)
            scale = atol_e + rtol_e * torch.maximum(y.abs(), y1.abs())
            err_max = torch.sqrt(torch.mean((err / scale) ** 2, -1)).max()
            accept_t = err_max <= 1.0
            accept, clipped, last = host_flags(accept_t, clipped_t, stop >= S_end)
            if accept:
                sig_buf.append(sigma)
                h_buf.append(h_eff)
                sigma = stop if clipped else sigma + h_eff
                y, f_phys = y1, f1
            cand = h_eff * _controller_factor(err_max, accept_t, tab.error_order, dtype)
            # forced landings must not shrink the controller's preferred step
            h = torch.maximum(h_free, cand) if accept and clipped else cand
            done = accept and clipped and last
            trials += 1
        cnt = len(h_buf)

    # ---- pass 2: differentiable re-integration on the accepted mesh -------
    if not h_buf:  # nothing accepted: one padding step, as the fixed-shape scan has
        sig_buf, h_buf = [zero], [zero]
    y, f_phys = y0, f(ts[:, 0], y0, args)
    coeffs = []
    for sigma, hh in zip(sig_buf, h_buf):
        h_safe = torch.where(hh == 0.0, torch.ones_like(hh), hh)
        y1, f1, ks = dopri5_step(sigma, y, f_phys, h_safe)
        # CONTD5 coefficients (Hairer's dopri5.f; solvers/dense.py)
        ydiff = y1 - y
        bspl = h_safe * ks[0] - ydiff
        r4 = ydiff - h_safe * ks[6] - bspl
        r5 = h_safe * combine(D_CONT5, ks, skip_zeros=False)
        coeffs.append(torch.stack([y, ydiff, bspl, r4, r5]))
        if cnt:
            y, f_phys = y1, f1
    coeffs = torch.stack(coeffs)                      # (steps, 5, B, n)

    # ---- outputs: one gather + quartic polynomial per output point --------
    sig_t, h_t = torch.stack(sig_buf), torch.stack(h_buf)
    sig_end = torch.where(h_t > 0.0, sig_t + h_t, big_sig)
    m = torch.arange(1, T, dtype=dtype, device=dev)  # output sigmas
    j_m = torch.clamp(torch.searchsorted(sig_end, m), 0, max(cnt - 1, 0))
    theta = (m - sig_t[j_m]) / torch.clamp(h_t[j_m], min=torch.finfo(dtype).tiny)
    th = torch.clamp(theta, 0.0, 1.0)[:, None, None]  # (n_int, 1, 1)
    yj, ydiff, bspl, r4, r5 = coeffs[j_m].unbind(1)   # each (n_int, B, n)
    interp = yj + th * (ydiff + (1.0 - th) * (bspl + th * (r4 + (1.0 - th) * r5)))
    ys_full = torch.cat([y0[:, None], interp.transpose(0, 1)], dim=1)
    if return_stats:
        return ys_full, StepStats(
            n_accepted=torch.tensor(cnt, dtype=torch.int32, device=dev),
            n_rejected=torch.tensor(trials - cnt, dtype=torch.int32, device=dev),
            success=torch.tensor(done and cnt <= budget, device=dev))
    return ys_full
