"""Training loop: global-norm clip, Adam with a cosine schedule, early stopping.

Port of `hybrid_ode_tpu/train/loop.py`. One update is forward solve -> loss
-> backward through the integrator (the fused kernels' adjoint when the
config says `use_pallas`) -> clip -> Adam, run eagerly on the device that
holds the parameters. Optimizer parity with the JAX package's optax chain:
  * the global-norm clip covers the TRAINABLE leaves only, and scales by
    max_norm / norm when norm >= max_norm (no epsilon);
  * Adam b1 0.9, b2 0.999, eps 1e-8 (eps_root 0), learning rate
    init * 0.5 * (1 + cos(pi * count / decay_steps)) at the update count
    before the increment, decay_steps = epochs * steps_per_epoch;
  * frozen groups get no update and no Adam moments: 'norm' always, 'ode'
    unless `train_ode_params` is True or names the parameter;
  * the logged grad_norm covers all gradients.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import GlucoseDataset, batch_iterator, batch_to_tensors, pad_batch
from hybrid_ode_torch.models.hybrid import HybridConfig, config_from_dict, hybrid_loss, init_hybrid_params
from hybrid_ode_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from hybrid_ode_torch.utils.convert import optax_state_to_port
from hybrid_ode_torch.utils.device import resolve_device
from hybrid_ode_torch.utils.logging import MetricsLogger

logger = logging.getLogger("hybrid_ode_torch.train")

Params = Dict[str, Dict[str, torch.Tensor]]


def _leaves(tree: Params) -> Iterator[Tuple[str, str, torch.Tensor]]:
    for group in sorted(tree):
        for name in sorted(tree[group]):
            yield group, name, tree[group][name]


def trains(train_ode_params, group: str, name: str) -> bool:
    """Whether a leaf trains: never 'norm'; 'ode' per `train_ode_params`
    (False, True, or the names that train); everything else."""
    if group == "norm":
        return False
    if group == "ode":
        if isinstance(train_ode_params, (list, tuple, set)):
            return name in train_ode_params
        return bool(train_ode_params)
    return True


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """Clip then Adam on the trainable leaves of a params tree (see module
    docstring); `bind` attaches it to the leaves it updates in place."""

    def __init__(self, learning_rate: float, decay_steps: int, gradient_clip: float = 5.0,
                 train_ode_params=False):
        self.learning_rate = learning_rate
        self.decay_steps = max(1, decay_steps)
        self.gradient_clip = gradient_clip
        self.train_ode_params = train_ode_params
        self.count = 0  # updates taken, optax's count

    def trains(self, group: str, name: str) -> bool:
        return trains(self.train_ode_params, group, name)

    def schedule(self, count: int) -> float:
        """Learning-rate factor of the cosine decay (alpha 0) at `count`."""
        return 0.5 * (1.0 + math.cos(math.pi * min(count, self.decay_steps) / self.decay_steps))

    def bind(self, params: Params) -> "Optimizer":
        self._train = {(g, n): t for g, n, t in _leaves(params) if self.trains(g, n)}
        self._adam = torch.optim.Adam(list(self._train.values()), lr=self.learning_rate,
                                      betas=(0.9, 0.999), eps=1e-8)
        self._sched = torch.optim.lr_scheduler.LambdaLR(self._adam, self.schedule)
        self.count = 0
        return self

    @torch.no_grad()
    def step(self) -> None:
        """One update from the leaves' `.grad` (a missing gradient is zero)."""
        grads = []
        for t in self._train.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        if self.gradient_clip > 0 and grads:
            norm = _global_norm(grads)
            if not float(norm) < self.gradient_clip:  # as optax: a NaN norm clips too
                for g in grads:
                    g.div_(norm).mul_(self.gradient_clip)
        self._adam.step()
        self._sched.step()
        self.count += 1

    def state_tree(self) -> Dict[str, Any]:
        """{"count", "mu", "nu"}: moments as trees of the trainable leaves."""
        mu: Dict[str, Dict[str, torch.Tensor]] = {}
        nu: Dict[str, Dict[str, torch.Tensor]] = {}
        for (g, n), t in self._train.items():
            st = self._adam.state.get(t, {})
            mu.setdefault(g, {})[n] = st.get("exp_avg", torch.zeros_like(t)).detach().clone()
            nu.setdefault(g, {})[n] = st.get("exp_avg_sq", torch.zeros_like(t)).detach().clone()
        return {"count": torch.tensor(self.count, dtype=torch.int32), "mu": mu, "nu": nu}

    def load_state_tree(self, tree: Any) -> None:
        """Restore the state a checkpoint saved: the port's {"count", "mu",
        "nu"} tree, or the JAX train_model's optax state
        (`utils.convert.optax_state_to_port`), whose schedule count places
        the cosine decay where it stopped."""
        if not (isinstance(tree, dict) and set(tree) == {"count", "mu", "nu"}):
            tree = optax_state_to_port(tree)
        self.count = int(np.asarray(tree["count"]))
        schedule_count = int(np.asarray(tree.get("schedule_count", self.count)))
        for (g, n), t in self._train.items():
            if n not in tree["mu"].get(g, {}) or n not in tree["nu"].get(g, {}):
                raise ValueError(f"the saved optimizer state has no moments for {g}.{n}, "
                                 "which trains under this config")
            self._adam.state[t] = {
                "step": torch.tensor(float(self.count)),
                "exp_avg": torch.as_tensor(np.asarray(tree["mu"][g][n]), dtype=t.dtype,
                                           device=t.device).clone(),
                "exp_avg_sq": torch.as_tensor(np.asarray(tree["nu"][g][n]), dtype=t.dtype,
                                              device=t.device).clone(),
            }
        self._sched.last_epoch = schedule_count
        for group in self._adam.param_groups:
            group["lr"] = self.learning_rate * self.schedule(schedule_count)


def make_optimizer(learning_rate: float, epochs: int, steps_per_epoch: int,
                   gradient_clip: float = 5.0, train_ode_params=False) -> Optimizer:
    """train_ode_params: False (ODE params frozen), True (all train), or a
    list of parameter NAMES to train selectively."""
    return Optimizer(learning_rate, epochs * steps_per_epoch, gradient_clip, train_ode_params)


@dataclasses.dataclass
class TrainState:
    params: Params  # leaves require grad; the bound optimizer updates them in place
    step: int = 0


def make_train_step(optimizer: Optimizer, config: HybridConfig, lambda1: float,
                    lambda2: float, use_physics: bool) -> Callable:
    """(state, batch, generator) -> (state, metrics): one update of the
    params `optimizer` is bound to."""

    def step(state: TrainState, batch: Dict, generator: torch.Generator):
        leaves = [t for _, _, t in _leaves(state.params)]
        for t in leaves:
            t.grad = None
        loss, comps = hybrid_loss(state.params, batch, generator, config, lambda1=lambda1,
                                  lambda2=lambda2, use_physics_loss=use_physics)
        loss.backward()
        with torch.no_grad():
            gnorm = _global_norm([t.grad for t in leaves if t.grad is not None])
        optimizer.step()
        state.step += 1
        return state, dict(comps, loss=loss.detach(), grad_norm=gnorm)

    return step


def make_eval_step(config: HybridConfig, lambda1: float, lambda2: float,
                   use_physics: bool) -> Callable:
    @torch.no_grad()
    def step(params: Params, batch: Dict, generator: torch.Generator):
        return hybrid_loss(params, batch, generator, config, lambda1=lambda1, lambda2=lambda2,
                           use_physics_loss=use_physics)

    return step


@dataclasses.dataclass
class TrainResult:
    params: Any
    best_val_loss: float
    history: Dict[str, list]
    epochs_run: int


def _to_params(tree: Any, device: torch.device) -> Params:
    """Trainable copies on `device` of a params tree (tensors or arrays)."""
    out = {}
    for group, leaves in tree.items():
        out[group] = {}
        for name, v in leaves.items():
            t = (v.detach().to(device, torch.float32).clone() if isinstance(v, torch.Tensor)
                 else torch.tensor(np.asarray(v), dtype=torch.float32, device=device))
            out[group][name] = t.requires_grad_(True)
    return out


def _snapshot(params: Params) -> Params:
    return {g: {n: t.detach().clone() for n, t in leaves.items()} for g, leaves in params.items()}


def train_model(
    cfg: Dict[str, Any],
    train_ds: GlucoseDataset,
    val_ds: GlucoseDataset,
    checkpoint_dir: Optional[str] = None,
    log_dir: Optional[str] = None,
    params: Any = None,
    max_epochs: Optional[int] = None,
    resume_from: Optional[str] = None,
    device="cuda",
) -> TrainResult:
    """Point-estimate training with best / final checkpoints and early
    stopping, on `device` (CUDA unless the caller asks for the CPU).

    resume_from: a checkpoint written by this function or by the JAX
    package's train_model (optax state); restores params AND optimizer state
    and continues from the epoch after the saved one.
    history holds per-epoch train_loss / val_loss / epoch_time and per-step
    step_loss / grad_norm / solver_success (the share of windows whose
    adaptive solve stayed within its step budget; 1 for fixed-grid solvers)."""
    dev = resolve_device(device)
    tcfg, mcfg, abl = cfg["training"], cfg["model"], cfg["ablation"]
    config = config_from_dict(cfg)
    seed = cfg.get("seed", 0)
    generator = torch.Generator().manual_seed(seed)
    if params is None:
        norm_stats = None
        ode_overrides = cfg.get("ode_params")
        if mcfg.get("physical_core", False):
            norm_stats = (train_ds.state_mean, train_ds.state_std)
            # basal parameters at the data's operating point
            ode_overrides = dict(ode_overrides or {})
            for i, name in enumerate(("G_b", "I_b", "Glu_b")):
                ode_overrides[name] = float(train_ds.state_mean[i])
        params = init_hybrid_params(generator, config, ode_overrides, norm_stats=norm_stats,
                                    device=dev)

    batch_size = tcfg["batch_size"]
    epochs = max_epochs if max_epochs is not None else tcfg["epochs"]
    steps_per_epoch = max(1, len(train_ds) // batch_size)
    optimizer = make_optimizer(tcfg["learning_rate"], epochs, steps_per_epoch,
                               tcfg.get("gradient_clip", 5.0),
                               train_ode_params=tcfg.get("train_ode_params", False))
    lambda1 = tcfg.get("lambda1", 1.0)
    lambda2 = tcfg.get("lambda2", 1.0)
    use_physics = not abl.get("no_physics", False)
    train_step = make_train_step(optimizer, config, lambda1, lambda2, use_physics)
    eval_step = make_eval_step(config, lambda1, lambda2, use_physics)

    start_epoch = 0
    saved_opt = None
    if resume_from is not None:
        saved, meta = load_checkpoint(resume_from)
        params, saved_opt = saved["params"], saved["opt_state"]
        start_epoch = int(meta.get("epoch", -1)) + 1
        logger.info("resumed from %s at epoch %d", resume_from, start_epoch)
    state = TrainState(_to_params(params, dev))
    optimizer.bind(state.params)
    if saved_opt is not None:
        optimizer.load_state_tree(saved_opt)
    mlogger = MetricsLogger(log_dir, cfg["logging"].get("tensorboard", False)) if log_dir else None

    def meta_for(epoch, val_loss):
        return {"epoch": epoch, "val_loss": val_loss, "config": cfg,
                "state_mean": train_ds.state_mean, "state_std": train_ds.state_std}

    best_val = float("inf")
    best = {"params": _snapshot(state.params), "opt_state": optimizer.state_tree()}
    best_meta = meta_for(-1, None)
    best_dirty = False
    patience = tcfg.get("early_stopping_patience", 20)
    patience_counter = 0
    history = {"train_loss": [], "val_loss": [], "epoch_time": [], "step_loss": [],
               "grad_norm": [], "solver_success": []}
    epoch = -1

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        total, nb = 0.0, 0
        min_success = 1.0
        for batch in batch_iterator(train_ds, batch_size, shuffle=True, seed=seed + epoch):
            batch, _ = pad_batch(batch, batch_size)
            state, metrics = train_step(state, batch_to_tensors(batch, dev), generator)
            loss = float(metrics["loss"])
            history["step_loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["solver_success"].append(float(metrics["solver_success"]))
            min_success = min(min_success, history["solver_success"][-1])
            total += loss
            nb += 1
        train_loss = total / max(nb, 1)
        if min_success < 1.0:
            # an adaptive interval exhausted its step budget somewhere this
            # epoch; raise max_steps_per_interval or loosen the tolerances
            logger.warning("epoch %d: solver step budget exhausted in >=1 batch "
                           "(min success fraction %.3f)", epoch, min_success)

        vtotal, vb = 0.0, 0
        for batch in batch_iterator(val_ds, batch_size, shuffle=False):
            batch, _ = pad_batch(batch, batch_size)
            vloss, _ = eval_step(state.params, batch_to_tensors(batch, dev), generator)
            vtotal += float(vloss)
            vb += 1
        val_loss = vtotal / max(vb, 1)

        dt = time.time() - t0
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        history["epoch_time"].append(dt)
        if mlogger:
            mlogger.log(epoch, {"train/epoch_loss": train_loss, "val/epoch_loss": val_loss,
                                "epoch_time_s": dt})
        logger.info("epoch %d: train=%.4f val=%.4f (%.2fs)", epoch, train_loss, val_loss, dt)

        if val_loss < best_val:
            best_val = val_loss
            best = {"params": _snapshot(state.params), "opt_state": optimizer.state_tree()}
            best_meta = meta_for(epoch, val_loss)
            best_dirty = True
            patience_counter = 0
            # write at most every save_interval epochs (and in the first 5);
            # the held best is flushed after the loop, so best_model is never stale
            save_every = max(1, int(cfg["logging"].get("save_interval", 1)))
            if checkpoint_dir and (epoch % save_every == 0 or epoch < 5):
                save_checkpoint(Path(checkpoint_dir) / "best_model", best, best_meta)
                best_dirty = False
        else:
            patience_counter += 1
        if patience_counter >= patience:
            logger.info("early stopping at epoch %d", epoch)
            break

    if checkpoint_dir:
        if best_dirty:
            save_checkpoint(Path(checkpoint_dir) / "best_model", best, best_meta)
        save_checkpoint(Path(checkpoint_dir) / "final_model",
                        {"params": state.params, "opt_state": optimizer.state_tree()},
                        meta_for(epoch, history["val_loss"][-1] if history["val_loss"] else None))
    if mlogger:
        mlogger.close()
    return TrainResult(best["params"], best_val, history, epoch + 1)
