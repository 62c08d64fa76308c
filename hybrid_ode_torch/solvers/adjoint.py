"""Continuous-adjoint (backsolve) gradients for the adaptive solvers.

Port of `hybrid_ode_tpu/solvers/adjoint.py`. The forward pass is the
while-mode solve without autograd; the backward pass integrates the adjoint
ODE

    dy/dt      = f(t, y, args)
    da/dt      = -a^T (df/dy)
    dgrad_args = -a^T (df/dargs)

backwards over each output interval, injecting each observation's
cotangent as it passes. Memory is O(1) in the number of steps.

As under the JAX package's vmap, every sample integrates its own augmented
state [y, a, g] with its own steps: g holds the sample's cotangents of every
floating-point leaf of `args` (its own row of a per-sample leaf, its own
contribution to a shared one), computed by `torch.func.vjp` under
`torch.func.vmap`. Shared leaves' integrals are summed over the batch at the
end. `args_axes` says which leaves are per sample (a vmap `in_dims` prefix
of `args`: None shared, 0 a leading batch axis), since the port writes
batching out instead of vmapping the solver.

Notes:
  * cotangents for `ts` are zeros (observation times are data).
  * seminorm=True (default): the backward solve's step control uses an error
    seminorm over [y, a] only; the parameter integrals are passive
    (Kidger, Chen & Lyons 2021, arXiv:2009.09457).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import _broadcast_to_and_flatten, tree_flatten, tree_unflatten


class _Backsolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, y0, ts, *leaves):
        with torch.no_grad():
            ys = spec["solve"](spec["f"], y0, ts, spec["rebuild"](leaves), **spec["fwd_kw"])
        ctx.spec = spec
        ctx.save_for_backward(ys, ts, *leaves)
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        spec = ctx.spec
        ys, ts, *leaves = ctx.saved_tensors
        f, rebuild, axes = spec["f"], spec["rebuild"], spec["axes"]
        batched = ys.ndim == 3
        if not batched:
            ys, g_ys = ys[None], g_ys[None]
        B, T, n = ys.shape
        ts_b = ts.expand(B, T)
        # per-sample layout of g: each leaf's per-sample numel, in leaf order
        shapes = [x.shape if ax is None else x.shape[1:] for x, ax in zip(leaves, axes)]
        sizes = [int(torch.Size(s).numel()) for s in shapes]
        m = sum(sizes)

        def aug_one(tau, aug, *leaves_i):
            # tau = -t: integrating forward in tau is integrating back in t
            y, a = aug[:n], aug[n:2 * n]
            fy, vjp_fn = torch.func.vjp(lambda yy, *pp: f(-tau, yy, rebuild(pp)), y, *leaves_i)
            cots = vjp_fn(a)
            # d/dtau [y, a, g_args] = [-f, +a^T df/dy, +a^T df/dargs]
            return torch.cat([-fy, cots[0]] + [c.reshape(-1) for c in cots[1:]])

        aug_v = torch.func.vmap(aug_one, in_dims=(0, 0, *axes))

        def aug_field(tau, aug, _):
            return aug_v(tau, aug, *leaves)

        bwd_kw = dict(spec["fwd_kw"])
        if spec["seminorm"]:
            # weight [y, a] = 1, parameter cotangents = 0
            bwd_kw["norm_weights"] = torch.cat([ys.new_ones(2 * n), ys.new_zeros(m)])
        aug = ys.new_zeros(B, 2 * n + m)
        for idx in range(T - 2, -1, -1):
            aug = torch.cat([ys[:, idx + 1], aug[:, n:2 * n] + g_ys[:, idx + 1], aug[:, 2 * n:]],
                            dim=-1)
            tau_grid = torch.stack([-ts_b[:, idx + 1], -ts_b[:, idx]], dim=-1)
            aug = spec["solve"](aug_field, aug, tau_grid, None, **bwd_kw)[:, -1]

        g_y0 = aug[:, n:2 * n] + g_ys[:, 0]
        grads = []
        for g, x, ax, need in zip(torch.split(aug[:, 2 * n:], sizes, dim=-1), leaves, axes,
                                  ctx.needs_input_grad[3:]):
            if not need:
                grads.append(None)
            elif ax is None:
                grads.append(g.sum(0).reshape(x.shape))
            else:
                grads.append(g.reshape(x.shape))
        return (None, g_y0 if batched else g_y0[0], torch.zeros_like(ts), *grads)


def odeint_backsolve(
    f: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args: Any,
    *,
    solver: str = "dopri5",
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps_per_interval: int = 32,
    substeps: int = 4,
    seminorm: bool = True,
    args_axes: Any = None,
) -> torch.Tensor:
    """`odeint` with continuous-adjoint gradients. y0 (n,) or (B, n); ts
    (T,) or (B, T); args_axes a vmap `in_dims` prefix of args (default:
    every leaf shared by the batch). Returns ys (..., T, n)."""
    from hybrid_ode_torch.solvers.api import odeint as _odeint
    from hybrid_ode_torch.solvers.tableaus import TABLEAUS

    if y0.ndim not in (1, 2):
        raise ValueError(f"backsolve takes y0 of shape (n,) or (B, n), got {tuple(y0.shape)}")
    if solver in ("rk4", "euler"):
        fwd_kw = dict(solver=solver, substeps=substeps, checkpoint_intervals=False)
    else:
        fwd_kw = dict(solver=solver, rtol=rtol, atol=atol, mode="while",
                      max_steps_per_interval=max_steps_per_interval, substeps=substeps,
                      checkpoint_intervals=False)
    flat, treespec = tree_flatten(args)
    axes_all = _broadcast_to_and_flatten(args_axes, treespec)
    if axes_all is None:
        raise ValueError("args_axes is not a prefix of args")
    if y0.ndim == 1 and any(ax is not None for ax in axes_all):
        raise ValueError("per-sample args (args_axes 0) need a batched y0 (B, n)")
    diff = [i for i, x in enumerate(flat) if torch.is_tensor(x) and x.is_floating_point()]

    def rebuild(leaves):
        out = list(flat)
        for i, x in zip(diff, leaves):
            out[i] = x
        return tree_unflatten(out, treespec)

    spec = dict(f=f, solve=_odeint, fwd_kw=fwd_kw, rebuild=rebuild,
                axes=[axes_all[i] for i in diff], seminorm=seminorm and solver in TABLEAUS)
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    return _Backsolve.apply(spec, y0, ts, *[flat[i] for i in diff])
