"""Hybrid mechanistic-ODE + NN-residual model: dx/dt = f_physio + g_NN.

Port of `hybrid_ode_tpu/models/hybrid.py`, serving, training and test-time
identification paths: configuration, parameter initialisation, the hybrid
field, single and batched forward solves, the fused-kernel dispatch
(differentiable through the adjoint kernel), the context encoder, test-time
identification of context codes and of per-window parameter multipliers, the
amortised encoder, the multiple-shooting view and `hybrid_loss`. Parameters are a
nested dict {'ode': {...}, 'nn': {...}, ['enc'], ['norm']} of tensors, the
JAX pytree's layout, so JAX checkpoints load as they are
(`hybrid_ode_torch/utils/convert.py`).

Batching is written out, not vmapped: `hybrid_field` takes states (..., 6)
with per-sample times (...), and control signals (..., T) on per-sample
grids; 'context' signals are (..., C).

Under a profiler the context encoder is a `hode.forward.encode` span and
the fused kernel's dispatch a `hode.forward.fused` span.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from hybrid_ode_torch.dynamics.controls import Controls, eval_controls
from hybrid_ode_torch.dynamics.ode_core import make_ode_params, mechanistic_field
from hybrid_ode_torch.dynamics.residual import (
    init_mlp_params,
    mlp_apply,
    mlp_l2,
    residual_apply,
)
from hybrid_ode_torch.solvers.api import odeint
from hybrid_ode_torch.utils.device import resolve_device
from hybrid_ode_torch.utils.profiling import span

STATE_NAMES = ("Glucose", "Insulin", "Glucagon", "GLP1", "GE", "FFA")


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Static model/solver configuration; fields as in the JAX package.

    exog_insulin routes the 'tVNS' channel (the IV insulin rate on ICU
    cohorts): 'nn' (an NN feature only), 'mech' (mechanistic input via the
    gain k_ex, NN blinded to the rate), 'both', 'mech_blind' (also blinds
    the NN to the insulin state and derivative; trainable |S_I|).
    use_pallas selects the fused RK4 kernel path (the YAML key is kept)."""

    nn_hidden: int = 64
    nn_layers: int = 4
    activation: str = "relu"
    use_nn: bool = True
    use_mech: bool = True
    solver: str = "dopri5"
    rtol: float = 1e-6
    atol: float = 1e-8
    mode: str = "scan"
    max_steps_per_interval: int = 8
    substeps: int = 4
    adjoint: str = "discrete"
    n_states: int = 6
    n_physics_points: int = 20
    shooting_segments: int = 1
    context_points: int = 0
    context_dim: int = 8
    context_mode: str = "features"
    context_params: tuple = ("G_b", "I_b", "Glu_b")
    exog_insulin: str = "nn"
    use_pallas: bool = False


def config_from_dict(cfg: Mapping[str, Any], use_nn: Optional[bool] = None,
                     **overrides) -> HybridConfig:
    """Config dict (a YAML file's, or a checkpoint's metadata['config']) ->
    HybridConfig, with the JAX package's defaults."""
    m = cfg.get("model", {})
    abl = cfg.get("ablation", {})
    kw = dict(
        nn_hidden=m.get("nn_hidden", 64),
        nn_layers=m.get("nn_layers", 4),
        activation=m.get("activation", "relu"),
        use_nn=(not abl.get("no_nn", False)) if use_nn is None else use_nn,
        use_mech=not abl.get("no_mech", False),
        solver=m.get("solver", "dopri5"),
        rtol=m.get("rtol", 1e-6),
        atol=m.get("atol", 1e-8),
        mode=m.get("mode", "scan"),
        max_steps_per_interval=m.get("max_steps_per_interval", 8),
        substeps=m.get("substeps", 4),
        adjoint=m.get("adjoint", "discrete"),
        n_physics_points=m.get("n_physics_points", 20),
        shooting_segments=m.get("shooting_segments", 1),
        context_points=m.get("context_points", 0),
        context_dim=m.get("context_dim", 8),
        context_mode=m.get("context_mode", "features"),
        context_params=tuple(m.get("context_params", ("G_b", "I_b", "Glu_b"))),
        exog_insulin=m.get("exog_insulin", "nn"),
        use_pallas=m.get("use_pallas", False),
    )
    kw.update(overrides)
    return HybridConfig(**kw)


def init_hybrid_params(
    generator: torch.Generator,
    config: HybridConfig = HybridConfig(),
    ode_params: Optional[Mapping[str, float]] = None,
    dtype: torch.dtype = torch.float32,
    norm_stats: Optional[Tuple] = None,
    device="cuda",
) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'ode': 17 scalars, 'nn': zero-output MLP} (+ 'enc', 'norm', k_ex,
    S_I as the config asks), drawn from `generator` (a CPU generator) and
    placed on `device`: CUDA unless the caller asks for the CPU, raising
    where there is none. The numbers differ from the JAX initialiser's
    (other RNG); the structure and scales match."""
    device = resolve_device(device)
    feat_ctx = (config.context_dim
                if config.context_points > 0 and config.context_mode == "features" else 0)
    nn = init_mlp_params(generator, input_dim=3 + config.n_states + feat_ctx,
                         hidden_dim=config.nn_hidden, output_dim=config.n_states,
                         n_layers=config.nn_layers, dtype=dtype, device=device)
    params = {"ode": make_ode_params(ode_params, dtype=dtype, device=device), "nn": nn}
    if config.exog_insulin != "nn" and "k_ex" not in params["ode"]:
        params["ode"]["k_ex"] = torch.tensor(1.0, dtype=dtype, device=device)
    if config.exog_insulin == "mech_blind" and "S_I" not in params["ode"]:
        params["ode"]["S_I"] = torch.tensor(0.01, dtype=dtype, device=device)
    if config.context_points > 0:
        out_dim = (config.context_dim if config.context_mode == "features"
                   else len(config.context_params))
        params["enc"] = init_mlp_params(
            generator, input_dim=config.context_points * (config.n_states + 1),
            hidden_dim=32, output_dim=out_dim, n_layers=2, dtype=dtype, device=device)
        if config.context_mode == "features":
            # non-zero output init: the context is a feature, not a residual
            w2 = params["enc"]["w2"]
            params["enc"]["w2"] = 0.1 * torch.randn(w2.shape, generator=generator,
                                                    dtype=dtype).to(device)
    if norm_stats is not None:
        mean = torch.as_tensor(norm_stats[0], dtype=dtype, device=device)
        std = torch.as_tensor(norm_stats[1], dtype=dtype, device=device)
        # near-constant placeholder states keep an identity scale
        informative = std > (1e-4 * mean.abs() + 1e-6)
        params["norm"] = {"mean": mean,
                          "std": torch.where(informative, std, torch.ones_like(std))}
    return params


def hybrid_field(t, y: torch.Tensor, params: Mapping[str, Any],
                 controls: Optional[Controls], config: HybridConfig) -> torch.Tensor:
    """dx/dt = f_physio(t, x; theta) + g_NN(t, x, GLP1, tVNS[, ctx]; phi).

    With params['norm'] (physical-core mode) y is z-scored and the
    mechanistic field runs on de-normalised states: dz/dt = f(z*std+mean)/std."""
    context = None
    if controls is not None and "context" in controls.signals:
        context = controls.signals["context"]  # (..., C)
        controls = Controls(ts=controls.ts, signals={
            k: v for k, v in controls.signals.items() if k != "context"})
    inputs = eval_controls(controls, t)
    if config.exog_insulin != "nn" and "tVNS" in inputs:
        inputs = dict(inputs, I_ex=inputs["tVNS"])
    ode_p = params["ode"]
    if config.context_points > 0 and config.context_mode == "params":
        # per-subject parameters p_i <- p_i * e^{delta_i}
        delta = (context if context is not None else
                 torch.zeros((len(config.context_params),), dtype=y.dtype, device=y.device))
        ode_p = dict(ode_p)
        for i, name in enumerate(config.context_params):
            ode_p[name] = ode_p[name] * torch.exp(delta[..., i])
        context = None  # consumed; the NN sees no extra features
    if not config.use_mech:
        dy = torch.zeros_like(y)
    elif "norm" in params:
        mean, std = params["norm"]["mean"], params["norm"]["std"]
        dy = mechanistic_field(t, y * std + mean, ode_p, inputs) / std
    else:
        dy = mechanistic_field(t, y, ode_p, inputs)
    if config.use_nn:
        glp1 = y[..., 3]
        tvns = inputs.get("tVNS", torch.zeros_like(glp1))
        y_nn = y
        if config.exog_insulin in ("mech", "mech_blind"):
            tvns = torch.zeros_like(glp1)  # NN blinded to the raw rate
        if config.exog_insulin == "mech_blind":
            y_nn = y.clone()
            y_nn[..., 1] = 0.0  # ...and to the insulin state
        if (config.context_points > 0 and config.context_mode == "features"
                and context is None):
            context = torch.zeros((config.context_dim,), dtype=y.dtype, device=y.device)
        dy_nn = residual_apply(params["nn"], t, y_nn, glp1, tvns, config.activation,
                               extra=context)
        if config.exog_insulin == "mech_blind":
            dy_nn = dy_nn.clone()
            dy_nn[..., 1] = 0.0  # insulin dynamics stay purely mechanistic
        dy = dy + dy_nn
    return dy


def forward(params: Mapping[str, Any], y0: torch.Tensor, ts: torch.Tensor,
            controls: Optional[Controls] = None, config: HybridConfig = HybridConfig(),
            **solver_overrides) -> torch.Tensor:
    """Solve (..., n) x (..., T) -> (..., T, n); one trajectory or a batch."""

    def field(t, y, args):
        p, c = args
        return hybrid_field(t, y, p, c, config)

    kw = dict(solver=config.solver, rtol=config.rtol, atol=config.atol, mode=config.mode,
              max_steps_per_interval=config.max_steps_per_interval,
              substeps=config.substeps, adjoint=config.adjoint)
    kw.update(solver_overrides)
    if kw["mode"] == "sync":
        kw["mode"] = "scan"  # batch synchronisation is meaningless for one trajectory
    if kw["adjoint"] == "backsolve" and controls is not None and y0.ndim > 1:
        # the backsolve adjoint integrates per-sample cotangents: the
        # controls are per sample, the params shared by the batch
        kw["args_axes"] = (None, Controls(ts=0, signals={k: 0 for k in controls.signals}))
    return odeint(field, y0, ts, (params, controls), **kw)


def _has_step_stats(config: HybridConfig) -> bool:
    return config.solver not in ("rk4", "euler") and config.adjoint != "backsolve"


def batched_forward(params: Mapping[str, Any], y0: torch.Tensor, ts: torch.Tensor,
                    controls: Optional[Controls] = None,
                    config: HybridConfig = HybridConfig(), **solver_overrides) -> torch.Tensor:
    """Batch of trajectories: (B, n) -> (B, T, n).

    With config.use_pallas (solver='rk4'), routes through the fused RK4
    kernel: one launch integrates the whole batch."""
    if ts.ndim == 1:
        ts = ts[None, :].expand(y0.shape[0], ts.shape[0])
    if config.use_pallas and not solver_overrides:
        with span("hode.forward.fused"):
            return _fused_forward(params, y0, ts, controls, config)
    if solver_overrides.get("mode", config.mode) == "sync":
        # batch-synchronised adaptive stepping: one shared controller for the
        # batch, two-pass gradients on the accepted mesh (solvers/sync.py)
        from hybrid_ode_torch.solvers.sync import odeint_erk_sync
        from hybrid_ode_torch.solvers.tableaus import TABLEAUS

        if config.solver not in TABLEAUS:
            raise ValueError(
                f"mode='sync' supports the explicit adaptive solvers "
                f"{sorted(TABLEAUS)}, got {config.solver!r}")

        def field(t, y, args):
            p, c = args
            return hybrid_field(t, y, p, c, config)

        # span='auto' free-runs dopri5 across output points with CONTD5 dense
        # output; the time-gridded control signals make their kinks (boluses,
        # stepwise rates) forced step boundaries
        time_signals = None
        if controls is not None:
            time_signals = [v for v in controls.signals.values()
                            if v.ndim >= 1 and v.shape[-1] == ts.shape[-1]]
        return odeint_erk_sync(
            field, y0, ts, (params, controls), TABLEAUS[config.solver],
            rtol=config.rtol, atol=config.atol,
            max_steps_per_interval=config.max_steps_per_interval,
            stop_signals=time_signals,
            return_stats=solver_overrides.get("return_stats", False),
        )
    return forward(params, y0, ts, controls, config, **solver_overrides)


def _fused_forward(params: Mapping[str, Any], y0: torch.Tensor, ts: torch.Tensor,
                   controls: Optional[Controls], config: HybridConfig) -> torch.Tensor:
    """Dispatch to the fused RK4 kernel (the JAX `_pallas_forward`), with its
    guards. The kernel runs on CUDA tensors, its plain version on CPU ones."""
    from hybrid_ode_torch.ops.fused_rk4 import PARAM_ORDER, fused_rk4_hybrid

    if config.solver != "rk4":
        raise ValueError(f"use_pallas requires solver='rk4', got {config.solver!r}")
    if config.activation != "relu":
        raise ValueError("use_pallas supports activation='relu' only")
    if "norm" in params:
        raise ValueError("use_pallas does not support the 'norm' physical-core mode")
    if not config.use_nn:
        raise ValueError("use_pallas requires use_nn=True (kernel fuses the MLP)")
    if not config.use_mech:
        raise ValueError("use_pallas requires use_mech=True (kernel fuses the mechanistic drift)")
    if config.exog_insulin != "nn":
        raise ValueError("use_pallas does not implement mechanistic "
                         "exogenous-insulin routing (exog_insulin="
                         f"{config.exog_insulin!r}); use the scan path")
    ctx_param_idx = ()
    if config.context_points > 0 and config.context_mode == "params":
        try:
            ctx_param_idx = tuple(PARAM_ORDER.index(n) for n in config.context_params)
        except ValueError as e:
            raise ValueError(
                f"use_pallas context_mode='params': every conditioned "
                f"parameter must be in the kernel's PARAM_ORDER ({e})") from None
    signals = dict(controls.signals) if controls is not None else {}
    context = signals.pop("context", None)
    if ctx_param_idx and context is None:
        raise ValueError(
            "context_mode='params' model called without a 'context' control "
            "signal — inject the subject codes first (with_context); the "
            "kernel's per-sample parameter path cannot run unconditioned")
    B, T = ts.shape
    meal = signals.pop("meal", None)
    tvns = signals.pop("tVNS", None)
    if signals:
        raise ValueError(f"use_pallas supports meal/tVNS/context controls only, got {sorted(signals)}")
    zeros = torch.zeros((B, T), dtype=y0.dtype, device=y0.device)
    return fused_rk4_hybrid(
        y0, ts, zeros if meal is None else meal, zeros if tvns is None else tvns,
        params["ode"], params["nn"], substeps=config.substeps,
        n_layers=config.nn_layers, context=context, context_param_idx=ctx_param_idx)


def context_features(observations: torch.Tensor, time_points: torch.Tensor,
                     k: int) -> torch.Tensor:
    """The context encoder's input: each window's first k observations and
    their times since the window's start, flattened (B, k * (n + 1))."""
    obs_k = observations[:, :k, :]
    t_rel = (time_points[:, :k] - time_points[:, :1])[..., None]
    return torch.cat([obs_k, t_rel], dim=-1).reshape(obs_k.shape[0], -1)


def encode_context(enc_params: Mapping[str, torch.Tensor], observations: torch.Tensor,
                   time_points: torch.Tensor, k: int, activation: str = "relu") -> torch.Tensor:
    """Latent subject code from the first k observations of each window."""
    return mlp_apply(enc_params, context_features(observations, time_points, k), activation)


def with_context(params: Mapping[str, Any], batch: Mapping[str, Any],
                 controls: Optional[Controls], config: HybridConfig) -> Optional[Controls]:
    """Inject the encoded subject context into the controls."""
    if config.context_points <= 0 or "enc" not in params:
        return controls
    with span("hode.forward.encode"):
        ctx = encode_context(params["enc"], batch["observations"], batch["time_points"],
                             config.context_points, config.activation)
    if controls is None:
        controls = Controls(ts=batch["time_points"], signals={})
    return Controls(ts=controls.ts, signals=dict(controls.signals, context=ctx))


class _Adam:
    """optax's `adam` / `adamw` on a list of tensors, written out: moments
    mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, both bias-corrected
    by 1 - b^count, update mu_hat / (sqrt(nu_hat) + eps) with eps outside the
    root, plus weight_decay * x (decoupled), times -lr. No clipping and no
    schedule. Updates the tensors in place."""

    def __init__(self, tensors, lr: float, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.tensors = list(tensors)
        self.lr, self.weight_decay, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(x) for x in self.tensors]
        self.nu = [torch.zeros_like(x) for x in self.tensors]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for x, g, mu, nu in zip(self.tensors, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * x
            x.sub_(self.lr * upd)


def _frozen(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The params tree with every leaf detached: the model is held fixed."""
    return {g: {k: v.detach() for k, v in grp.items()} for g, grp in params.items()}


def _window_misfit(rollout, obs, ts, signals, mask, denom, w_state):
    """Per-window masked, weighted data misfit (..., B) of `rollout(controls)`;
    non-finite squared errors count as 1e6 BEFORE the sum, so a diverged
    window neither poisons the batch's values nor, through the masked
    branch, its gradients."""
    preds = rollout(Controls(ts=ts, signals=signals))
    se = ((preds - obs) ** 2) * w_state * mask[..., None]
    se = torch.nan_to_num(se, nan=1e6, posinf=1e6)
    return torch.sum(se, dim=(-2, -1)) / denom


def _refine(x0: torch.Tensor, data_vec, trust, steps: int, lr: float) -> torch.Tensor:
    """`steps` Adam iterations on sum(data_vec(x) + trust(x)) from x0, keeping
    for every window the iterate with the lowest data misfit it ever had
    (strict <, the final candidate included): a window whose refinement
    diverges or overfits keeps an earlier code."""
    x = x0.detach().clone().requires_grad_(True)
    opt = _Adam([x], lr)
    best_x = x0.detach().clone()
    with torch.no_grad():
        best_data = data_vec(x0.detach())
    for _ in range(steps):
        dvec = data_vec(x)
        (g,) = torch.autograd.grad(torch.sum(dvec + trust(x)), x)
        with torch.no_grad():
            improved = dvec.detach() < best_data
            best_x = torch.where(improved[..., None], x.detach(), best_x)
            best_data = torch.where(improved, dvec.detach(), best_data)
        opt.step([torch.nan_to_num(g)])
    with torch.no_grad():
        dvec = data_vec(x.detach())
        return torch.where((dvec < best_data)[..., None], x.detach(), best_x)


def _identification_window(params, batch, k: int):
    """The first k points of a batch as tensors on the params' device:
    (y0, obs_k, ts_k, signals_k, mask_k, denom, w_state)."""
    dev = next(iter(params["ode"].values())).device

    def t(x):
        return torch.as_tensor(x, device=dev)

    obs_k = t(batch["observations"])[:, :k]
    ts_k = t(batch["time_points"])[:, :k]
    mask = batch.get("mask")
    mask_k = t(mask)[:, :k] if mask is not None else torch.ones_like(ts_k, dtype=obs_k.dtype)
    sig_k = {n: t(v)[:, :k] for n, v in (batch.get("external_inputs") or {}).items()}
    denom = torch.clamp(torch.sum(mask_k, dim=1) * obs_k.shape[-1], min=1.0)  # (B,)
    # the same per-state weighting as training (zero for placeholder channels)
    w_state = batch.get("loss_weights")
    w_state = (t(w_state) if w_state is not None
               else torch.ones((obs_k.shape[-1],), dtype=obs_k.dtype, device=dev))
    return t(batch["initial_state"]), obs_k, ts_k, sig_k, mask_k, denom, w_state


def identify_context(
    params: Mapping[str, Any],
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    steps: int = 100,
    lr: float = 0.02,
    prior_std: float = 0.2,
    points: Optional[int] = None,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Test-time subject identification: refine each window's context code by
    Adam on the masked data misfit over its first `points` observations
    (default `config.context_points`; may exceed it: the encoder is fixed to
    its trained input length, the identification solve is not), with the
    trained model frozen. Returns the refined (B, context_dim) codes; inject
    them as `Controls(signals={'context': ctx, ...})`.

    The start is `init` (e.g. an `amortize_encoder` output), else the
    encoder's codes, else zeros. `prior_std` is a Gaussian trust region
    around that start, ||ctx - ctx0||^2 / (2 sigma^2), not a zero-centred
    prior: a trained encoder's operating point can sit at large codes. Each
    window returns the code with the lowest data misfit it ever saw, so a
    window whose refinement diverges keeps its initial code.

    With config.use_pallas the gradient with respect to the codes comes out
    of the fused adjoint kernel's context cotangent ('params' mode: through
    its per-sample parameter path)."""
    k = points if points is not None else config.context_points
    if k <= 0:
        raise ValueError("identify_context requires context_points > 0")
    params = _frozen(params)
    y0, obs_k, ts_k, sig_k, mask_k, denom, w_state = _identification_window(params, batch, k)
    if init is not None:
        ctx0 = torch.as_tensor(init, device=obs_k.device).detach()
    elif "enc" in params:
        # the encoder reads its trained window even when the solve is longer
        ctx0 = encode_context(params["enc"], torch.as_tensor(batch["observations"], device=obs_k.device),
                              torch.as_tensor(batch["time_points"], device=obs_k.device),
                              config.context_points, config.activation)
    else:
        dim = (len(config.context_params) if config.context_mode == "params"
               else config.context_dim)
        ctx0 = torch.zeros((obs_k.shape[0], dim), dtype=obs_k.dtype, device=obs_k.device)

    def data_vec(ctx):
        return _window_misfit(lambda c: batched_forward(params, y0, ts_k, c, config), obs_k,
                              ts_k, dict(sig_k, context=ctx), mask_k, denom, w_state)

    def trust(ctx):
        return torch.mean((ctx - ctx0) ** 2, dim=-1) / (2.0 * prior_std ** 2)

    return _refine(ctx0, data_vec, trust, steps, lr)


def forward_with_param_deltas(
    params: Mapping[str, Any],
    deltas: torch.Tensor,           # (B, P) log-scale multipliers
    y0: torch.Tensor,               # (B, n)
    ts: torch.Tensor,               # (B, T)
    controls: Optional[Controls],
    config: HybridConfig,
) -> torch.Tensor:
    """Batched rollout with per-window mechanistic parameters: window b
    integrates with `ode[k] * exp(deltas[b, i])` for the i-th sorted ODE
    parameter name; the decode side of `identify_params`. (B, T, n). The
    per-window parameters are (B,) tensors that broadcast over the batch in
    the field; this is the scan solver, never the fused kernel."""
    names = sorted(params["ode"].keys())
    ode = {k: params["ode"][k] * torch.exp(deltas[..., i]) for i, k in enumerate(names)}
    return forward({**params, "ode": ode}, y0, ts, controls, config)


def identify_params(
    params: Mapping[str, Any],
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    context: Optional[torch.Tensor] = None,
    steps: int = 150,
    lr: float = 0.02,
    prior_std: float = 0.1,
    points: Optional[int] = None,
) -> torch.Tensor:
    """Test-time identification beyond the context code: refine per-window
    log-scale multipliers on all mechanistic parameters against the first
    `points` observations (default max(context_points, 12)), model frozen.
    Returns (B, P) deltas for the sorted `params['ode']` names; roll out with
    `forward_with_param_deltas`. The trust region is zero-centred,
    ||delta||^2 / (2 sigma^2); the best-iterate guard is `identify_context`'s.
    `context`: optional (B, ctx_dim) codes from `identify_context`; the
    deltas then refine on top of them."""
    k = points if points is not None else max(config.context_points, 12)
    params = _frozen(params)
    y0, obs_k, ts_k, sig_k, mask_k, denom, w_state = _identification_window(params, batch, k)
    if context is not None:
        sig_k["context"] = torch.as_tensor(context, device=obs_k.device).detach()

    def data_vec(deltas):
        return _window_misfit(
            lambda c: forward_with_param_deltas(params, deltas, y0, ts_k, c, config),
            obs_k, ts_k, sig_k, mask_k, denom, w_state)

    def trust(deltas):
        return torch.mean(deltas ** 2, dim=-1) / (2.0 * prior_std ** 2)

    d0 = torch.zeros((obs_k.shape[0], len(params["ode"])), dtype=obs_k.dtype,
                     device=obs_k.device)
    return _refine(d0, data_vec, trust, steps, lr)


def amortize_encoder(
    params: Mapping[str, Any],
    batch: Mapping[str, Any],
    config: HybridConfig,
    *,
    points: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    id_steps: int = 150,
    id_lr: float = 0.02,
    prior_std: float = 0.3,
    hidden: int = 64,
    n_layers: int = 2,
    epochs: int = 3000,
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    val_frac: float = 0.15,
    targets: Optional[torch.Tensor] = None,
    finetune_epochs: int = 400,
    finetune_lr: float = 3e-4,
    finetune_chunk: int = 50,
    init_encoder: Optional[Mapping[str, torch.Tensor]] = None,
    permutation: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Distill `identify_context` into a feed-forward encoder over a
    `points`-long window, so that deployment pays one MLP pass and not an
    inner optimisation. Returns `(enc_params, info)`; the encoder works with
    `encode_context(enc_params, obs, ts, points)`.

    Stage 1: regress the identified codes (`targets`, else `identify_context`
    on `batch`) with AdamW; a `val_frac` split keeps the iterate with the
    best held-out code MSE. Stage 2 (`finetune_epochs` > 0): fine-tune the
    encoder through the frozen model on the full-window masked data loss
    (the encoder still reads only the first `points` observations), again
    keeping the best held-out iterate, starting from stage 1's.
    `finetune_chunk` is kept for the signature only and is unused: every step
    reads its held-out loss on the host, which already paces the device, so
    there is nothing left to chunk.

    `generator` (a CPU generator, default seed 0) draws the encoder's
    initial weights and the train / validation permutation; `init_encoder`
    and `permutation` supply them instead (another framework's draws differ,
    so a comparison passes both in)."""
    k = points if points is not None else config.context_points
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    params = _frozen(params)
    dev = next(iter(params["ode"].values())).device
    if targets is None:
        targets = identify_context(params, batch, config, steps=id_steps, lr=id_lr,
                                   prior_std=prior_std, points=k)
    targets = torch.as_tensor(targets, device=dev).detach()
    B, out_dim = targets.shape
    obs = torch.as_tensor(batch["observations"], device=dev)
    ts = torch.as_tensor(batch["time_points"], device=dev)
    n = obs.shape[-1]

    if init_encoder is not None:
        enc = {name: torch.as_tensor(v, device=dev).detach().clone()
               for name, v in init_encoder.items()}
    else:
        enc = init_mlp_params(generator, input_dim=k * (n + 1), hidden_dim=hidden,
                              output_dim=out_dim, n_layers=n_layers, dtype=obs.dtype, device=dev)
        # regression head: small non-zero output init (a zero init would start
        # at the population code and stall)
        wlast = f"w{n_layers}"
        enc[wlast] = (0.05 * torch.randn(enc[wlast].shape, generator=generator,
                                         dtype=obs.dtype)).to(dev)
    names = sorted(enc)
    for v in enc.values():
        v.requires_grad_(True)

    perm = (torch.randperm(B, generator=generator) if permutation is None
            else torch.as_tensor(permutation)).to(dev)
    n_val = max(1, int(val_frac * B)) if B > 4 else 0
    val_idx, tr_idx = perm[:n_val], perm[n_val:]

    def snapshot():
        return {name: enc[name].detach().clone() for name in names}

    def code_mse(idx):
        pred = encode_context(enc, obs[idx], ts[idx], k, config.activation)
        return torch.mean((pred - targets[idx]) ** 2)

    opt = _Adam([enc[name] for name in names], lr, weight_decay=weight_decay)
    best_enc, best_val = snapshot(), float("inf")
    loss = torch.zeros(())
    for _ in range(epochs):
        loss = code_mse(tr_idx)
        opt.step(torch.autograd.grad(loss, [enc[name] for name in names]))
        with torch.no_grad():
            v = float(code_mse(val_idx)) if n_val else float(loss.detach())
        if v < best_val:
            best_enc, best_val = snapshot(), v

    info = {
        "points": k,
        "n_windows": int(B),
        "val_code_mse": float(best_val),
        "final_train_mse": float(loss.detach()),
        "target_code_std": float(torch.std(targets, unbiased=False)),
    }

    if finetune_epochs > 0:
        # stage 2: decoder-aware fine-tune on the full-window data loss
        y0 = torch.as_tensor(batch["initial_state"], device=dev)
        mask = batch.get("mask")
        mask_f = (torch.as_tensor(mask, device=dev) if mask is not None
                  else torch.ones_like(ts, dtype=obs.dtype))
        sig = {nm: torch.as_tensor(v, device=dev)
               for nm, v in (batch.get("external_inputs") or {}).items()}
        w_state = batch.get("loss_weights")
        w_state = (torch.as_tensor(w_state, device=dev) if w_state is not None
                   else torch.ones((n,), dtype=obs.dtype, device=dev))
        denom = torch.clamp(torch.sum(mask_f, dim=1) * n, min=1.0)  # (B,)

        def data_loss(idx):
            ctx = encode_context(enc, obs[idx], ts[idx], k, config.activation)
            signals = dict({nm: v[idx] for nm, v in sig.items()}, context=ctx)
            return torch.mean(_window_misfit(
                lambda c: batched_forward(params, y0[idx], ts[idx], c, config),
                obs[idx], ts[idx], signals, mask_f[idx], denom[idx], w_state))

        with torch.no_grad():
            for name in names:  # start from the distilled encoder
                enc[name].copy_(best_enc[name])
        val_or_tr = val_idx if n_val else tr_idx
        with torch.no_grad():
            val0 = float(data_loss(val_or_tr))
        opt_ft = _Adam([enc[name] for name in names], finetune_lr)
        best_ft = val0
        ft_losses = []
        for _ in range(finetune_epochs):
            loss = data_loss(tr_idx)
            grads = torch.autograd.grad(loss, [enc[name] for name in names])
            opt_ft.step([torch.nan_to_num(g) for g in grads])
            with torch.no_grad():
                v = float(data_loss(val_or_tr))
            if v < best_ft:
                best_enc, best_ft = snapshot(), v
            ft_losses.append(float(loss.detach()))
        info["val_data_loss_distilled"] = val0
        info["val_data_loss_finetuned"] = float(best_ft)
        info["finetune_train_first"] = ft_losses[0]
        info["finetune_train_last"] = ft_losses[-1]

    return best_enc, info


def controls_from_batch(batch: Mapping[str, Any]) -> Optional[Controls]:
    """Per-sample Controls from a batch's external inputs."""
    ext = batch.get("external_inputs")
    if not ext:
        return None
    return Controls(ts=batch["time_points"], signals=dict(ext))


def segment_batch(batch: Mapping[str, Any], k: int) -> Dict[str, Any]:
    """Multiple-shooting view: split each T-point window into k segments,
    each re-initialised from the OBSERVED state at its left edge; a virtual
    batch of B*k windows with (T-1)/k + 1 points each."""
    obs = batch["observations"]
    ts = batch["time_points"]
    B, T = ts.shape
    if (T - 1) % k != 0:
        raise ValueError(f"shooting_segments={k} must divide T-1={T-1}")
    L = (T - 1) // k
    idx = (torch.arange(k)[:, None] * L + torch.arange(L + 1)[None, :]).reshape(-1).to(ts.device)

    def seg(x):
        return x.index_select(1, idx).reshape((B * k, L + 1) + tuple(x.shape[2:]))

    out: Dict[str, Any] = {
        "observations": seg(obs),
        "time_points": seg(ts),
        "external_inputs": {n: seg(v) for n, v in (batch.get("external_inputs") or {}).items()},
    }
    out["initial_state"] = out["observations"][:, 0]
    if batch.get("loss_weights") is not None:
        out["loss_weights"] = batch["loss_weights"]
    if batch.get("mask") is not None:
        m = seg(batch["mask"])
        m = m * m[:, :1]  # a segment with an unobserved left edge cannot be shot from it
        out["mask"] = m
        if batch.get("mask_channels") is not None:
            out["mask_channels"] = seg(batch["mask_channels"]) * m[..., None]
    return out


def physics_indices(generator: Optional[torch.Generator], n_intervals: int,
                    n_pts: int) -> torch.Tensor:
    """The intervals the physics term samples, shared across the batch (the
    JAX package draws `jax.random.permutation(key, T-1)[:n_pts]`)."""
    return torch.randperm(n_intervals, generator=generator)[:n_pts]


def _per_point_controls(controls: Optional[Controls], n_pts: int) -> Optional[Controls]:
    """Controls with (B, ...) signals broadcast to (B, n_pts, ...)."""
    if controls is None:
        return None

    def at_points(v):
        return v if v.ndim == 0 else v[:, None].expand(v.shape[0], n_pts, *v.shape[1:])

    return Controls(ts=at_points(controls.ts),
                    signals={k: at_points(v) for k, v in controls.signals.items()})


def _total(x: torch.Tensor, shards) -> torch.Tensor:
    """A denominator over the whole batch: `x` summed over the shards."""
    return x if shards is None else shards.total(x.detach())


def _share_mean(x: torch.Tensor, shards) -> torch.Tensor:
    """The mean of x, or this shard's share of the mean over all shards' elements."""
    return torch.mean(x) if shards is None else torch.sum(x) / shards.total(x.numel())


def hybrid_loss(
    params: Mapping[str, Any],
    batch: Mapping[str, Any],
    generator: Optional[torch.Generator] = None,
    config: HybridConfig = HybridConfig(),
    lambda1: float = 1.0,
    lambda2: float = 1.0,
    use_physics_loss: bool = True,
    shards=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss; returns (total, components dict).

    batch (tensors): initial_state (B,n), observations (B,T,n), time_points
    (B,T), external_inputs {name: (B,T)}, optional mask (B,T), mask_channels
    (B,T,n) and loss_weights (n,). Data term: masked / channel-masked /
    weighted MSE; physics term: finite differences against the field at
    interval midpoints, on intervals drawn from `generator`; L2 on the MLP
    weights (weighted by lambda2 twice, as in the JAX package).

    shards (`parallel/mesh.py::DataShards`): the batch is this rank's shard
    of one sharded over a mesh dim. Each term is then its share of the whole
    batch's term: sums over the shard divided by the denominators summed
    over the dim's ranks (the mask counts, the physics points), and the L2
    term over the number of ranks, so that the shares (and their gradients)
    sum to the loss of the whole batch. `solver_success` stays the shard's."""
    if config.shooting_segments > 1:
        batch = segment_batch(batch, config.shooting_segments)
    y0 = batch["initial_state"]
    obs = batch["observations"]
    ts = batch["time_points"]
    controls = with_context(params, batch, controls_from_batch(batch), config)
    mask = batch.get("mask")
    # solver health: the share of windows whose every adaptive interval
    # reached its end within the step budget (the train loop warns below 1)
    if _has_step_stats(config) and not config.use_pallas:
        preds, stats = batched_forward(params, y0, ts, controls, config, return_stats=True)
        solver_success = torch.mean(stats.success.to(preds.dtype))
    else:
        preds = batched_forward(params, y0, ts, controls, config)
        solver_success = torch.ones((), dtype=preds.dtype, device=preds.device)

    w_state = batch.get("loss_weights")
    se = (preds - obs) ** 2
    if w_state is not None:
        se = se * w_state
    mask_ch = batch.get("mask_channels")
    if mask_ch is not None:
        data_loss = torch.sum(mask_ch * se) / (_total(torch.sum(mask_ch), shards) + 1e-8)
    elif mask is None:
        data_loss = _share_mean(se, shards)
    else:
        w = mask[..., None]
        data_loss = torch.sum(w * se) / (_total(torch.sum(w), shards) * obs.shape[-1] + 1e-8)

    physics_loss = torch.zeros((), dtype=preds.dtype, device=preds.device)
    if use_physics_loss and lambda1 > 0:
        T = obs.shape[1]
        n_pts = min(config.n_physics_points, T - 1)
        idx = physics_indices(generator, T - 1, n_pts).to(ts.device)
        t_l, t_r = ts[:, idx], ts[:, idx + 1]
        y_l, y_r = preds[:, idx], preds[:, idx + 1]
        dt = (t_r - t_l)[..., None]
        fd = (y_r - y_l) / torch.where(dt == 0, torch.ones_like(dt), dt)
        # field at the interval MIDPOINT: O(h^2)-consistent with the difference
        rhs = hybrid_field(0.5 * (t_l + t_r), 0.5 * (y_l + y_r), params,
                           _per_point_controls(controls, n_pts), config)
        pe = (fd - rhs) ** 2
        if w_state is not None:
            pe = pe * w_state
        physics_loss = _share_mean(pe, shards)

    reg_loss = torch.zeros((), dtype=preds.dtype, device=preds.device)
    if lambda2 > 0 and config.use_nn:
        reg_loss = mlp_l2(params["nn"], l2_weight=lambda2)
        if shards is not None:
            reg_loss = reg_loss / shards.size

    total = data_loss + lambda1 * physics_loss + lambda2 * reg_loss
    return total, {"data": data_loss, "physics": physics_loss, "reg": reg_loss,
                   "solver_success": solver_success}


def params_to_flat(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested {'ode': {...}, 'nn': {...}} -> flat {'ode_a_GI': ..., 'nn_w0': ...}."""
    flat = {f"ode_{k}": v for k, v in params["ode"].items()}
    flat.update({f"nn_{k}": v for k, v in params["nn"].items()})
    return flat


def flat_to_params(flat: Mapping[str, torch.Tensor],
                   template: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Merge flat-named overrides onto a nested template (all groups kept)."""
    out = {k: dict(v) for k, v in template.items()}
    for name, value in flat.items():
        if name.startswith("ode_"):
            out["ode"][name[4:]] = value
        elif name.startswith("nn_"):
            out["nn"][name[3:]] = value
        else:
            raise KeyError(f"unknown parameter prefix: {name}")
    return out


def forward_with_params(flat_params: Mapping[str, torch.Tensor], template: Mapping[str, Any],
                        y0: torch.Tensor, ts: torch.Tensor, controls: Optional[Controls] = None,
                        config: HybridConfig = HybridConfig(), **solver_overrides) -> torch.Tensor:
    """Forward pass under substituted parameters: `flat_params` (flat names,
    'ode_a_GI', 'nn_w0', ...) merged onto `template`; a batch (B, n) or one
    trajectory (n,)."""
    merged = flat_to_params(flat_params, template)
    if y0.ndim == 2:
        return batched_forward(merged, y0, ts, controls, config, **solver_overrides)
    return forward(merged, y0, ts, controls, config, **solver_overrides)
