"""Time-varying external inputs as piecewise-linear interpolants.

Port of `hybrid_ode_tpu/dynamics/controls.py`. Signals may carry leading
batch dims: `ts` (..., T) with `signals[name]` (..., T) is evaluated at
per-sample times `t` (...), which is how the batched solve uses it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class Controls(NamedTuple):
    """Piecewise-linear control signals on a time grid.

    Attributes:
        ts: time knots, shape (..., T).
        signals: dict name -> values, each (..., T) (time-varying) or 0-d
            (constant). Names used by the hybrid model: 'meal', 'tVNS',
            'GD', and 'context' (per-sample features, not interpolated).
    """

    ts: torch.Tensor
    signals: Dict[str, torch.Tensor]


def make_controls(ts, signals: Optional[Dict[str, torch.Tensor]] = None) -> Controls:
    """Controls from array-likes: `ts` and every signal become tensors (a
    tensor keeps its device)."""
    return Controls(ts=torch.as_tensor(ts),
                    signals={k: torch.as_tensor(v) for k, v in (signals or {}).items()})


def interp(t: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp` along the last axis with endpoint clamping.

    xp, fp: (..., T); t broadcastable to xp.shape[:-1]. Same formula as
    `jnp.interp`: right-sided search, degenerate intervals take the left
    value, and points outside [xp[0], xp[-1]] clamp to the end values."""
    batch = xp.shape[:-1]
    x = torch.as_tensor(t, dtype=xp.dtype, device=xp.device).expand(batch).contiguous()
    T = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.unsqueeze(-1).contiguous(), right=True).clamp(1, T - 1)
    xl = torch.gather(xp, -1, i - 1).squeeze(-1)
    xr = torch.gather(xp, -1, i).squeeze(-1)
    fl = torch.gather(fp, -1, i - 1).squeeze(-1)
    fr = torch.gather(fp, -1, i).squeeze(-1)
    dx = xr - xl
    dx0 = dx.abs() <= _spacing_of_eps(xp.dtype)
    f = torch.where(dx0, fl, fl + ((x - xl) / torch.where(dx0, torch.ones_like(dx), dx)) * (fr - fl))
    f = torch.where(x < xp[..., 0], fp[..., 0], f)
    return torch.where(x > xp[..., -1], fp[..., -1], f)


def _spacing_of_eps(dtype: torch.dtype) -> float:
    """np.spacing(finfo(dtype).eps): the threshold `jnp.interp` uses."""
    eps = torch.tensor(torch.finfo(dtype).eps, dtype=dtype)
    return float(torch.nextafter(eps, torch.tensor(float("inf"), dtype=dtype)) - eps)


def eval_controls(controls: Optional[Controls], t) -> Dict[str, torch.Tensor]:
    """Evaluate every control signal at time(s) t."""
    if controls is None:
        return {}
    out = {}
    for name, values in controls.signals.items():
        if values.ndim == 0:
            out[name] = values
        else:
            out[name] = interp(t, controls.ts, values)
    return out
