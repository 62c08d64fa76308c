"""Mean-field variational primitives over flat-named parameter dicts.

Port of `hybrid_ode_tpu/models/bayes.py`. The variational state is
{means, log_stds}, two dicts of tensors keyed by flat names ('ode_a_GI',
'nn_w4', ...); a sample is mu + sigma * eps per leaf (the reparameterisation
trick), the KL is closed-form Gaussian-Gaussian. Posterior means start at
the current parameter values, as in the JAX package.

Several samples are one solve: `forward_samples` puts them on a leading
member axis in the layout of `parallel/ensemble.py` (every leaf (S, ...), the
sampled ones drawn, the others the template's, viewed), so S samples cost
the launches of one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.dynamics.ode_core import BAYES_ODE_PARAM_NAMES
from hybrid_ode_torch.models.hybrid import HybridConfig, batched_forward, flat_to_params
from hybrid_ode_torch.parallel import ensemble as _ens


class VariationalState(NamedTuple):
    """Diagonal-Gaussian posterior q(psi) = N(means, exp(log_stds)^2)."""

    means: Dict[str, torch.Tensor]
    log_stds: Dict[str, torch.Tensor]


def select_bayes_params(flat_params: Mapping[str, torch.Tensor],
                        include_nn=True) -> Dict[str, torch.Tensor]:
    """The parameters under the posterior: the 8 selected ODE parameters,
    plus per `include_nn` every NN leaf (True), none (False), or the MLP's
    output layer (its weights and bias; "last")."""
    last_idx = -1
    if include_nn == "last":
        for name in flat_params:
            if name.startswith("nn_w"):
                try:
                    last_idx = max(last_idx, int(name[4:]))
                except ValueError:
                    pass
    chosen = {}
    for name, v in flat_params.items():
        if name.startswith("ode_") and name[4:] in BAYES_ODE_PARAM_NAMES:
            chosen[name] = v
        elif include_nn is True and name.startswith("nn_"):
            chosen[name] = v
        elif include_nn == "last" and name in (f"nn_w{last_idx}", f"nn_b{last_idx}"):
            chosen[name] = v
    return chosen


def init_variational(flat_params: Mapping[str, torch.Tensor],
                     prior_params: Optional[Mapping[str, Mapping[str, float]]] = None,
                     include_nn=True) -> Tuple[VariationalState, Dict[str, Tuple[float, float]]]:
    """(state, priors): priors maps name -> (prior mean, prior std), looked up
    by the full name, then by the name without its prefix, N(0, 1) where
    neither is given. Means start at the parameter values; a parameter with
    a prior starts at std 0.1 * prior std, one with the default prior at
    max(0.01 * its RMS, 1e-4) (0.1 would be ten times a hidden weight's scale)."""
    prior_params = prior_params or {}
    selected = select_bayes_params(flat_params, include_nn=include_nn)
    means, log_stds, priors = {}, {}, {}
    for name, value in selected.items():
        pp = prior_params.get(name) or prior_params.get(name.split("_", 1)[1], {})
        p_mean, p_std = float(pp.get("mean", 0.0)), float(pp.get("std", 1.0))
        priors[name] = (p_mean, p_std)
        value = value.detach().clone()
        means[name] = value
        if pp:
            init_std = 0.1 * p_std
        else:
            init_std = max(0.01 * float(torch.sqrt(torch.mean(value ** 2))), 1e-4)
        log_stds[name] = torch.full_like(value, math.log(init_std))
    return VariationalState(means=means, log_stds=log_stds), priors


def sample_variational(state: VariationalState, generator: Optional[torch.Generator] = None,
                       eps: Optional[Mapping[str, torch.Tensor]] = None,
                       n_samples: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Reparameterised samples psi = mu + sigma * eps of every leaf, the
    leaves taken in sorted order, one normal draw from `generator` each;
    `eps` supplies the standard normal draws instead (name -> tensor of the
    sample's shape). With `n_samples`, every leaf gets a leading (n_samples,)."""
    lead = () if n_samples is None else (n_samples,)
    out = {}
    for name in sorted(state.means):
        mu = state.means[name]
        if eps is not None:
            e = torch.as_tensor(eps[name], dtype=mu.dtype, device=mu.device)
        else:
            e = torch.randn(lead + tuple(mu.shape), generator=generator, dtype=mu.dtype,
                            device=generator.device).to(mu.device)
        out[name] = mu + torch.exp(state.log_stds[name]) * e
    return out


def kl_divergence(state: VariationalState,
                  priors: Mapping[str, Tuple[float, float]]) -> torch.Tensor:
    """KL[q || p] summed over the parameters, closed form between diagonal
    Gaussians."""
    kl = 0.0
    for name in state.means:
        mu, log_std = state.means[name], state.log_stds[name]
        p_mean, p_std = priors[name]
        term = (math.log(p_std) - log_std
                + (torch.exp(log_std) ** 2 + (mu - p_mean) ** 2) / (2.0 * p_std ** 2) - 0.5)
        kl = kl + torch.sum(term)
    return kl


def flatten_variational(state: VariationalState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, log_sigma) flattened in sorted name order."""
    names = sorted(state.means)
    return (torch.cat([state.means[n].reshape(-1) for n in names]),
            torch.cat([state.log_stds[n].reshape(-1) for n in names]))


def posterior_predictive(state: VariationalState, generator: torch.Generator,
                         forward_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                         n_samples: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior-predictive mean and (population) std over `n_samples`
    samples: `forward_fn` takes the samples with their leading (n_samples,)
    axis and returns the predictions (n_samples, ...) in one call."""
    preds = forward_fn(sample_variational(state, generator, n_samples=n_samples))
    return preds.mean(dim=0), preds.std(dim=0, correction=0)


def forward_samples(samples: Mapping[str, torch.Tensor], template: Mapping[str, Any],
                    y0: torch.Tensor, ts: torch.Tensor, controls: Optional[Controls],
                    config: HybridConfig) -> torch.Tensor:
    """Trajectories of n samples (flat leaves with a leading (n,)) for one
    batch y0 (B, 6), ts (B, T) or (T,): (n, B, T, 6), all samples in one
    batched solve on the member axis (the plain solvers; the fused kernel
    stages one weight set per launch)."""
    n = next(iter(samples.values())).shape[0]
    if ts.ndim == 1:
        ts = ts[None, :].expand(y0.shape[0], ts.shape[0])
    # the member-stacked layout: every leaf (n, ...), the template's viewed
    stacked = flat_to_params(samples, {g: {k: _ens._members(v, n) for k, v in grp.items()}
                                       for g, grp in template.items()})
    if controls is not None:
        controls = Controls(ts=_ens._members(controls.ts, n),
                            signals={k: _ens._members(v, n) for k, v in controls.signals.items()})
    return batched_forward(_ens._member_view(stacked, 1), _ens._members(y0, n),
                           _ens._members(ts, n), controls, _ens._no_pallas(config))
