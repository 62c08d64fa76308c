"""Mean-field variational inference over the hybrid model's parameters.

Port of `hybrid_ode_tpu/inference/vi.py`. The ELBO's likelihood term is a
Monte-Carlo mean over S reparameterised samples, the KL closed form; one
training step differentiates through the ODE solve into the variational
means and log-stds (and, with `learn_noise`, the observation noise):

    ELBO = E_q[log p(x | psi)] - kl_scale * KL[q(psi) || p(psi)]
    log p(x | psi) = -0.5 sum((x - x_hat)^2 / sigma^2)
                     - 0.5 n_obs sum_c log(2 pi sigma_c^2)

How the S samples are solved:
  * `config.use_pallas`: each sample is one call of the fused RK4 kernel
    (`batched_forward`, the forward kernel and, when training, the hand
    adjoint), S calls per ELBO;
  * otherwise all S samples are one batched solve on a leading member axis
    (`models/bayes.py::forward_samples`, the stacked-leaf layout of
    `parallel/ensemble.py`): S samples cost the launches of one.

The update is the JAX package's: clip by the global norm (5.0) over the
variational leaves and log_noise together, then Adam(learning_rate) on the
variational leaves and Adam(noise_learning_rate) on log_noise. Samples are
drawn from CPU generators (a few numbers per step), so a seed gives the same
draws on the card and on the CPU.

Checkpoints are written in the JAX package's format
(`utils/checkpoint.py`): `VariationalInference.restore` of either package
reads the other's. The optimizer state is the port's {"count", "mu", "nu"}
here and optax's there; each side starts a fresh one from a foreign layout.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import GlucoseDataset, batch_iterator, batch_to_tensors, pad_batch
from hybrid_ode_torch.dynamics.controls import Controls
from hybrid_ode_torch.models.bayes import (
    VariationalState,
    forward_samples,
    init_variational,
    kl_divergence,
    sample_variational,
)
from hybrid_ode_torch.models.hybrid import (
    HybridConfig,
    _Adam,
    _frozen,
    batched_forward,
    controls_from_batch,
    flat_to_params,
    params_to_flat,
    with_context,
)
from hybrid_ode_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from hybrid_ode_torch.utils.convert import params_from_numpy

logger = logging.getLogger("hybrid_ode_torch.vi")

GRADIENT_CLIP = 5.0


def predict_samples(samples: Mapping[str, torch.Tensor], template: Mapping[str, Any],
                    y0: torch.Tensor, ts: torch.Tensor, controls: Optional[Controls],
                    config: HybridConfig) -> torch.Tensor:
    """Trajectories (S, B, T, 6) of S samples (flat leaves with a leading
    (S,)): one fused-kernel call per sample with `config.use_pallas`, else
    one batched solve of all S on the member axis."""
    if not config.use_pallas:
        return forward_samples(samples, template, y0, ts, controls, config)
    n = next(iter(samples.values())).shape[0]
    return torch.stack([batched_forward(flat_to_params({k: v[s] for k, v in samples.items()},
                                                       template), y0, ts, controls, config)
                        for s in range(n)])


def elbo(vstate: VariationalState, priors: Mapping[str, Tuple[float, float]],
         template_params: Mapping[str, Any], batch: Mapping[str, Any],
         generator: Optional[torch.Generator], config: HybridConfig, n_samples: int = 5,
         noise_sigma=1.0, kl_scale: float = 1.0,
         eps: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Dict]:
    """Monte-Carlo ELBO of a tensor batch; returns (elbo, {elbo, kl,
    log_likelihood}). The S = `n_samples` standard normal draws come from
    `generator`, or from `eps` (name -> (S, ...) tensors). `noise_sigma` is
    a scalar or a per-state (C,) vector. A context-conditioned model encodes
    the context with the template's encoder (a point estimate outside the
    posterior). Each sample's squared error is clamped to 1e6 per element
    (NaN and inf too), so one exploding sampled trajectory costs a penalty
    instead of poisoning the ELBO."""
    obs = batch["observations"]
    mask = batch.get("mask")
    controls = with_context(template_params, batch, controls_from_batch(batch), config)
    kl = kl_divergence(vstate, priors)
    samples = sample_variational(vstate, generator, eps=eps, n_samples=n_samples)
    preds = predict_samples(samples, template_params, batch["initial_state"],
                            batch["time_points"], controls, config)
    sigma = torch.as_tensor(noise_sigma, dtype=obs.dtype, device=obs.device)
    se = ((obs - preds) / sigma) ** 2
    se = torch.clamp(torch.nan_to_num(se, nan=1e6, posinf=1e6), max=1e6)
    if mask is not None:
        se = se * mask[..., None]
    log_lik = torch.mean(-0.5 * se.sum(dim=(-3, -2, -1)))
    # the mask is shared across channels: each channel has the same count
    sigma_vec = sigma.expand((obs.shape[-1],))
    n_per_ch = torch.sum(mask) if mask is not None else float(np.prod(obs.shape[:-1]))
    log_lik = log_lik - 0.5 * n_per_ch * torch.sum(math.log(2.0 * math.pi)
                                                   + 2.0 * torch.log(sigma_vec))
    value = log_lik - kl_scale * kl
    return value, {"elbo": value, "kl": kl, "log_likelihood": log_lik}


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on the same device, seeded from one draw of `generator`."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
    return torch.Generator(generator.device).manual_seed(seed)


class VariationalInference:
    """VI trainer over a VariationalState (the JAX package's API: train,
    train_step, sample_posterior, posterior_predictive, save_checkpoint,
    load_checkpoint, restore). The tensors live on the template's device.

    include_nn: False (ODE parameters only), True (every NN leaf too) or
    "last" (the ODE parameters and the MLP's output layer). learn_noise:
    False (a fixed sigma), True (one learned sigma) or "per_state" (a
    learned sigma per state channel), with its own, faster Adam."""

    def __init__(self, template_params: Mapping[str, Any], config: HybridConfig,
                 prior_params: Optional[Mapping[str, Mapping[str, float]]] = None,
                 learning_rate: float = 1e-3, n_samples: int = 5, noise_sigma=1.0,
                 kl_annealing: bool = False, annealing_epochs: int = 50, include_nn=False,
                 learn_noise=False, noise_learning_rate: float = 0.05):
        self.template = _frozen(template_params)
        self.config = config
        self.n_samples = n_samples
        self.kl_annealing = kl_annealing
        self.annealing_epochs = annealing_epochs
        self.learn_noise = learn_noise
        self.learning_rate, self.noise_learning_rate = learning_rate, noise_learning_rate
        self.device = next(iter(self.template["ode"].values())).device
        log_s0 = np.log(np.maximum(np.asarray(noise_sigma, np.float32), 1e-6))
        if learn_noise == "per_state" and log_s0.ndim == 0:
            log_s0 = np.full((6,), log_s0, np.float32)  # the mechanistic core has 6 states
        self.log_noise = torch.tensor(log_s0, dtype=torch.float32, device=self.device)
        self.vstate, self.priors = init_variational(params_to_flat(self.template), prior_params,
                                                    include_nn=include_nn)
        self._init_optimizer()
        self.history = {"elbo": [], "kl": [], "log_likelihood": []}

    # -- state --------------------------------------------------------------
    def _leaves(self):
        names = sorted(self.vstate.means)
        return [self.vstate.means[n] for n in names] + [self.vstate.log_stds[n] for n in names]

    def _init_optimizer(self) -> None:
        """Fresh Adam moments on the current leaves (updated in place)."""
        self._adam = _Adam(self._leaves(), self.learning_rate)
        self._noise_adam = _Adam([self.log_noise], self.noise_learning_rate)

    @property
    def opt_state(self) -> Dict[str, Any]:
        """The port's {"count", "mu", "nu"}; moments as {"vstate": (means,
        log_stds), "log_noise": tensor}."""
        names = sorted(self.vstate.means)
        k = len(names)

        def tree(moments, noise):
            return {"vstate": (dict(zip(names, moments[:k])), dict(zip(names, moments[k:]))),
                    "log_noise": noise[0]}

        return {"count": torch.tensor(self._adam.count, dtype=torch.int32),
                "mu": tree(self._adam.mu, self._noise_adam.mu),
                "nu": tree(self._adam.nu, self._noise_adam.nu)}

    def _load_opt_state(self, saved: Any) -> bool:
        """Take a saved port optimizer state whose leaves match the current
        state's shapes; False (and nothing changed) for any other layout."""
        want = self.opt_state
        try:
            flat = [(saved[m]["vstate"][i][n], want[m]["vstate"][i][n])
                    for m in ("mu", "nu") for i in (0, 1) for n in sorted(self.vstate.means)]
            flat += [(saved[m]["log_noise"], want[m]["log_noise"]) for m in ("mu", "nu")]
            count = int(np.asarray(saved["count"]))
        except (KeyError, IndexError, TypeError):
            return False
        if set(saved) != {"count", "mu", "nu"} or any(np.shape(a) != tuple(b.shape)
                                                      for a, b in flat):
            return False
        for src, dst in flat:  # `want` holds the live moment tensors
            dst.copy_(torch.as_tensor(np.asarray(src), dtype=dst.dtype))
        self._adam.count = self._noise_adam.count = count
        return True

    @property
    def noise_sigma(self):
        """float for a scalar noise model, (C,) np.ndarray for 'per_state'."""
        s = np.exp(self.log_noise.detach().cpu().numpy())
        return float(s) if s.ndim == 0 else s

    @noise_sigma.setter
    def noise_sigma(self, value) -> None:
        v = np.maximum(np.asarray(value, np.float32), 1e-6)
        self.log_noise = torch.tensor(np.log(v), dtype=torch.float32, device=self.device)
        self._noise_adam = _Adam([self.log_noise], self.noise_learning_rate)

    # -- training -------------------------------------------------------------
    def train_step(self, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                   kl_scale: float = 1.0,
                   eps: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, float]:
        """One update on `batch` (arrays or tensors) with S samples drawn from
        `generator` (or given as `eps`)."""
        b = batch_to_tensors(batch, self.device)
        leaves = self._leaves()
        for x in leaves:
            x.requires_grad_(True)
        log_noise = self.log_noise.requires_grad_(True) if self.learn_noise else self.log_noise
        value, comps = elbo(self.vstate, self.priors, self.template, b, generator, self.config,
                            self.n_samples, torch.exp(log_noise), kl_scale, eps)
        loss = -value
        wrt = leaves + ([self.log_noise] if self.learn_noise else [])
        grads = list(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
        g_noise = grads.pop() if self.learn_noise else torch.zeros_like(self.log_noise)
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads + [g_noise]))
            if not float(norm) < GRADIENT_CLIP:  # as optax: a NaN norm clips too
                grads = [g / norm * GRADIENT_CLIP for g in grads]
                g_noise = g_noise / norm * GRADIENT_CLIP
            self._adam.step(grads)
            self._noise_adam.step([g_noise])
        for x in leaves:
            x.requires_grad_(False)
        self.log_noise.requires_grad_(False)
        return {"loss": float(loss.detach()),
                **{k: float(comps[k].detach()) for k in ("elbo", "kl", "log_likelihood")}}

    @torch.no_grad()
    def evaluate_elbo(self, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                      eps: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Dict]:
        """The ELBO of `batch` at the current state (kl_scale 1), its samples
        drawn from `generator` (or given as `eps`)."""
        b = batch_to_tensors(batch, self.device)
        return elbo(self.vstate, self.priors, self.template, b, generator, self.config,
                    self.n_samples, torch.exp(self.log_noise), eps=eps)

    def train(self, train_ds: GlucoseDataset, val_ds: Optional[GlucoseDataset] = None,
              epochs: int = 100, batch_size: int = 16, early_stopping_patience: int = 10,
              seed: int = 0, log_every: int = 10) -> Dict[str, list]:
        """Epochs over `train_ds` (batches shuffled with seed + epoch, padded
        to batch_size), KL annealing when asked; with `val_ds`, the state of
        the best validation ELBO is kept and training stops after
        `early_stopping_patience` epochs without a better one. Samples come
        from a CPU generator seeded with `seed`."""
        generator = torch.Generator().manual_seed(seed)
        best_val = -float("inf")
        best_state = self._snapshot()
        patience = 0
        for epoch in range(epochs):
            kl_scale = (min(1.0, (epoch + 1) / self.annealing_epochs)
                        if self.kl_annealing else 1.0)
            t0 = time.time()
            acc = {"elbo": 0.0, "kl": 0.0, "log_likelihood": 0.0}
            nb = 0
            for batch in batch_iterator(train_ds, batch_size, shuffle=True, seed=seed + epoch):
                batch, _ = pad_batch(batch, batch_size)
                m = self.train_step(batch, split_generator(generator), kl_scale)
                for k in acc:
                    acc[k] += m[k]
                nb += 1
            for k in acc:
                acc[k] /= max(nb, 1)
                self.history[k].append(acc[k])

            val_elbo = None
            if val_ds is not None and len(val_ds):
                vtotal, vb = 0.0, 0
                for batch in batch_iterator(val_ds, batch_size, shuffle=False):
                    batch, _ = pad_batch(batch, batch_size)
                    v, _ = self.evaluate_elbo(batch, split_generator(generator))
                    vtotal += float(v)
                    vb += 1
                val_elbo = vtotal / max(vb, 1)
                if val_elbo > best_val:
                    best_val = val_elbo
                    best_state = self._snapshot()  # the leaves are updated in place
                    patience = 0
                else:
                    patience += 1
                if patience >= early_stopping_patience:
                    logger.info("VI early stopping at epoch %d", epoch)
                    break
            if (epoch + 1) % log_every == 0:
                logger.info("VI epoch %d: ELBO=%.2f KL=%.2f LL=%.2f val=%s (%.2fs)",
                            epoch, acc["elbo"], acc["kl"], acc["log_likelihood"],
                            f"{val_elbo:.2f}" if val_elbo is not None else "-", time.time() - t0)
        if val_ds is not None and len(val_ds):
            with torch.no_grad():
                for live, best in zip(self._leaves(), best_state):
                    live.copy_(best)
        return self.history

    def _snapshot(self):
        return [x.detach().clone() for x in self._leaves()]

    # -- prediction -----------------------------------------------------------
    @torch.no_grad()
    def sample_posterior(self, generator: torch.Generator,
                         n_samples: int = 100) -> Dict[str, torch.Tensor]:
        """n_samples draws of every leaf: name -> (n_samples, ...)."""
        return sample_variational(self.vstate, generator, n_samples=n_samples)

    @torch.no_grad()
    def posterior_predictive(self, generator: torch.Generator, initial_state: torch.Tensor,
                             time_points: torch.Tensor, controls: Optional[Controls] = None,
                             n_samples: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive mean and population std over n_samples posterior
        samples, for a batch y0 (B, 6) or one trajectory (6,)."""
        one = initial_state.ndim == 1
        if one:
            initial_state, time_points = initial_state[None], time_points[None]
            if controls is not None:
                controls = Controls(ts=controls.ts[None],
                                    signals={k: v[None] for k, v in controls.signals.items()})
        preds = predict_samples(self.sample_posterior(generator, n_samples), self.template,
                                initial_state, time_points, controls, self.config)
        if one:
            preds = preds[:, 0]
        return preds.mean(dim=0), preds.std(dim=0, correction=0)

    # -- persistence ----------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Self-contained checkpoint in the JAX package's layout: vstate as
        (means, log_stds), the optimizer state, the template params and the
        model config, so that evaluation restores the posterior predictive
        without the training session."""
        save_checkpoint(
            path,
            {"vstate": (self.vstate.means, self.vstate.log_stds), "opt_state": self.opt_state,
             "template": self.template},
            {"history": self.history,
             "priors": {k: list(v) for k, v in self.priors.items()},
             "noise_sigma": np.asarray(self.noise_sigma).tolist(),
             "learn_noise": self.learn_noise,
             "model_config": dataclasses.asdict(self.config)})

    def load_checkpoint(self, path: str) -> None:
        """Load a VI checkpoint of either package: vstate as a dict
        {means, log_stds} or a (means, log_stds) tuple; an optimizer state of
        another layout (optax's) starts afresh."""
        state, meta = load_checkpoint(path)
        loaded = state["vstate"]
        if isinstance(loaded, dict):
            means, log_stds = loaded["means"], loaded["log_stds"]
        else:
            means, log_stds = loaded
        self.vstate = VariationalState(means=params_from_numpy(dict(means), self.device),
                                       log_stds=params_from_numpy(dict(log_stds), self.device))
        self.history = meta.get("history", self.history)
        if "template" in state:
            self.template = params_from_numpy(state["template"], self.device)
        if "priors" in meta:
            self.priors = {k: tuple(v) for k, v in meta["priors"].items()}
        if "noise_sigma" in meta:
            self.noise_sigma = meta["noise_sigma"]
        self.learn_noise = meta.get("learn_noise", False)
        self._init_optimizer()
        if not self._load_opt_state(state.get("opt_state")):
            logger.info("VI checkpoint %s: optimizer state of another layout; started afresh",
                        path)

    @classmethod
    def restore(cls, path: str, template_params: Optional[Mapping[str, Any]] = None,
                config: Optional[HybridConfig] = None, device="cuda") -> "VariationalInference":
        """Rebuild a VI trainer on `device` from a self-contained checkpoint;
        template_params / config only for checkpoints that embed none."""
        state, meta = load_checkpoint(path)
        if template_params is None:
            if "template" not in state:
                raise ValueError(f"{path} is a legacy VI checkpoint without an embedded "
                                 "template — pass template_params explicitly")
            template_params = params_from_numpy(state["template"], device)
        if config is None:
            if "model_config" not in meta:
                raise ValueError(f"{path} has no embedded model config — pass config")
            mc = dict(meta["model_config"])
            mc["context_params"] = tuple(mc.get("context_params", ()))
            config = HybridConfig(**mc)
        vi = cls(template_params, config, noise_sigma=meta.get("noise_sigma", 1.0),
                 learn_noise=meta.get("learn_noise", False))
        vi.load_checkpoint(path)
        return vi
