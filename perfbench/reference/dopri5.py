"""Dormand-Prince 5(4) with per-window step control, in plain PyTorch.

The solver the dopri5 configurations state, written out for a batch of
windows, each with its own clock, step size and step budget:

  * tolerances clamped to what f32 can express: rtol >= 100 eps,
    atol >= 10 tiny;
  * Hairer's automatic initial step (one extra field evaluation);
  * per output interval at most `max_steps` trial steps; a step reaching
    the interval's end is clipped to it; a step is accepted where the RMS
    error norm over the 6 states, scaled by atol + rtol max(|y0|, |y1|),
    is at most 1; the step size then changes by 0.9 err^(-1/5) within
    [0.2, 10], never growing after a rejection, and a step clipped to the
    end keeps the larger of its natural size and the update;
  * a window whose interval did not reach its end within the budget has
    failed (`success` False) and continues from where it stopped;
  * the controls are linear interpolants on each window's grid, clamped at
    its ends.
"""

from __future__ import annotations

import torch

from perfbench.reference import model

SAFETY, MIN_FACTOR, MAX_FACTOR = 0.9, 0.2, 10.0
C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
A = ((),
     (1 / 5,),
     (3 / 40, 9 / 40),
     (44 / 45, -56 / 15, 32 / 9),
     (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
     (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656))
B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
E = tuple(b - bh for b, bh in zip(B5 + (0.0,), B4))


def interp(t, ts, values):
    """Linear interpolation of values (B, T) on grids ts (B, T) at t (B,),
    clamped to the end values outside the grid."""
    T = ts.shape[1]
    i = torch.searchsorted(ts.contiguous(), t[:, None].contiguous(), right=True).clamp(1, T - 1)
    xl, xr = ts.gather(1, i - 1)[:, 0], ts.gather(1, i)[:, 0]
    fl, fr = values.gather(1, i - 1)[:, 0], values.gather(1, i)[:, 0]
    f = fl + (t - xl) / (xr - xl) * (fr - fl)
    f = torch.where(t < ts[:, 0], values[:, 0], f)
    return torch.where(t > ts[:, -1], values[:, -1], f)


def weighted(ws, ks):
    acc = None
    for w, k in zip(ws, ks):
        if w != 0.0:
            acc = w * k if acc is None else acc + w * k
    return acc


@torch.no_grad()
def solve(y0, ts, meal, tvns, P, nn, rtol: float, atol: float, max_steps: int,
          arith=model.F32):
    """(trajectories (B, T, 6), accepted steps (B,), rejected steps (B,),
    success (B,)) of the hybrid model without context."""
    fi = torch.finfo(y0.dtype)
    rtol, atol = max(rtol, 100.0 * fi.eps), max(atol, 10.0 * fi.tiny)

    def f(t, y):
        return model.field(t, y, interp(t, ts, meal), interp(t, ts, tvns), None, P, nn, arith)

    # automatic initial step
    t0 = ts[:, 0]
    f0 = f(t0, y0)
    scale = atol + rtol * y0.abs()
    d0 = torch.sqrt(torch.mean((y0 / scale) ** 2, -1))
    d1 = torch.sqrt(torch.mean((f0 / scale) ** 2, -1))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp(d1, min=fi.tiny))
    f1 = f(t0 + h0, y0 + h0[:, None] * f0)
    d2 = torch.sqrt(torch.mean(((f1 - f0) / scale) ** 2, -1)) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.clamp(dmax, min=fi.tiny)) ** 0.2)
    h = torch.minimum(100.0 * h0, h1)

    y, fy = y0, f0
    n_acc = torch.zeros(y0.shape[0], dtype=torch.int32, device=y0.device)
    n_rej = torch.zeros_like(n_acc)
    success = torch.ones(y0.shape[0], dtype=torch.bool, device=y0.device)
    out = [y0]
    for i in range(ts.shape[1] - 1):
        t, t1 = ts[:, i], ts[:, i + 1]
        done = torch.zeros_like(success)
        for _ in range(max_steps):
            if bool(done.all()):
                break
            rem = t1 - t
            at_end = h >= rem
            he = torch.minimum(h, rem)
            hv = he[:, None]
            ks = [fy]
            for s in range(1, 6):
                ks.append(f(t + C[s] * he, y + hv * weighted(A[s], ks)))
            y1 = y + hv * weighted(B5, ks)
            fn = f(t + he, y1)
            ks.append(fn)
            err = hv * sum(w * k for w, k in zip(E, ks))
            sc = atol + rtol * torch.maximum(y.abs(), y1.abs())
            errn = torch.sqrt(((err / sc) ** 2).sum(-1) / 6.0)
            accept = errn <= 1.0
            move = accept & ~done
            t = torch.where(move, torch.where(at_end, t1, t + he), t)
            y = torch.where(move[:, None], y1, y)
            fy = torch.where(move[:, None], fn, fy)
            fac = torch.clamp(SAFETY * torch.clamp(errn, min=fi.tiny) ** -0.2,
                              MIN_FACTOR, MAX_FACTOR)
            fac = torch.where(accept, fac, torch.clamp(fac, max=1.0))
            cand = he * fac
            h = torch.where(done, h, torch.where(accept & at_end, torch.maximum(h, cand), cand))
            n_acc += move.to(torch.int32)
            n_rej += (~accept & ~done).to(torch.int32)
            done = done | (move & at_end)
        success &= done
        out.append(y)
    return torch.stack(out, dim=1), n_acc, n_rej, success
