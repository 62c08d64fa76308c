"""Training: a closed loop of updates through `make_train_step`, as
`train_model` runs them.

Set-up builds one training object (the model's leaves, the clip + Adam
optimizer bound to them, the step), resumed from the configuration's
checkpoint and its saved optimizer state, as `train_model(resume_from=...)`
continues a job, for `epochs` epochs of `steps_per_epoch` updates in all;
makes a pool of `pool` batches of `batch_size` windows; and drives the
object through its first update on the pool's first batch. The window
continues with the same object, one update per unit, on the next batches of
the pool in turn. A step whose loss or gradient norm is not finite has
failed.

Check, by one update each, every leaf compared by the gap of the norms of
the program's and the reference's values over the larger of the reference
leaf's norm and the median leaf's, worst leaf; leaves whose reference
gradient is under a thousandth of the median leaf's (no gradient reaches
them) are left out of the gradient and the change:
  * the start: the reference repeats set-up's update from the checkpoint's
    weights and optimizer state on the same batch; compared are its loss,
    the gradient as the optimizer got it (from Adam's first moment before
    and after the update: mu1 = b1 mu0 + (1 - b1) g) and each leaf's change;
  * the window: at an update drawn from the seed (from `check_from` to
    `check_to`, or among a traced run's units), the benchmark copies the
    program's trained leaves and Adam moments before and after it. The
    reference takes one update from the copy before, on the batch that the
    window's feed gave that update, with Adam's count and the learning
    rate's schedule at the updates that the benchmark has issued, and its
    loss, gradient and change are compared as at the start.
The reference follows the program from the program's own state in the
window because later updates part on some batches: the second step's
gradient moves by tens of percent under a rounding-level change of the
weights there (PERF.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import flops
from perfbench.inputs import load_source, loss_weights, make_windows
from perfbench.reference import model
from perfbench.reference import train as ref_train

B1 = 0.9
# the leaf each update's gradient and change are judged by: the worst at the
# start; the median in the window, where the worst leaf's gap is rounding
# noise of small leaves that the TF32 control does not exceed (PERF.md)
LEAF = {"first": "worst", "window": "median"}


def leaf_gaps(prog, ref, rule):
    """|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖) of each leaf in `rule`."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    median = float(np.median([norms[k] for k in rule]))
    return [abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], median)
            for k in rule]


class Train:
    unit_name = "steps"

    def __init__(self, env):
        from hybrid_ode_torch.models.hybrid import config_from_dict
        from hybrid_ode_torch.train.loop import TrainState, make_optimizer, make_train_step

        self.env, mix, cfg = env, env.mix, env.config
        tc = cfg["training"]
        self.config = config_from_dict(cfg)
        tree, meta = env.checkpoint()
        self.saved = tree["opt_state"]
        mean, std = meta["state_mean"], meta["state_std"]
        src = load_source()
        rng = env.rng(1)
        lw = torch.as_tensor(loss_weights(src, mean, std)).to(env.device)
        self.batches = []
        for _ in range(int(mix["pool"])):
            w = make_windows(rng, int(tc["batch_size"]), src, mean, std, mix["jitter"])
            w = {k: torch.as_tensor(v[:, : int(mix.get("points", v.shape[1]))]).to(env.device)
                 for k, v in w.items()}
            self.batches.append({
                "initial_state": w["initial_state"], "observations": w["observations"],
                "time_points": w["time_points"], "mask": w["mask"], "loss_weights": lw,
                "external_inputs": {"meal": w["meal"], "tVNS": w["tvns"]}})
        self.recipe = {"learning_rate": tc["learning_rate"], "clip": tc["gradient_clip"],
                       "lambda2": tc["lambda2"], "train_ode_params": tc["train_ode_params"],
                       "decay_steps": int(mix["epochs"]) * int(mix["steps_per_epoch"]),
                       "context_points": self.config.context_points,
                       "substeps": self.config.substeps}
        self.params0 = env.params()
        self.state = TrainState(env.params(requires_grad=True))
        self.opt = make_optimizer(tc["learning_rate"], int(mix["epochs"]),
                                  int(mix["steps_per_epoch"]), tc["gradient_clip"],
                                  tc["train_ode_params"]).bind(self.state.params)
        self.opt.load_state_tree(self.saved)
        self.step = make_train_step(self.opt, self.config, tc["lambda1"], tc["lambda2"],
                                    not cfg["ablation"]["no_physics"])
        self.gen = torch.Generator().manual_seed(env.torch_seed(3))
        self.i = 0
        mu0 = self.opt.state_tree()["mu"]
        self.loss_first, _ = self._update()
        self.first_grad = self._grad(mu0, self.opt.state_tree()["mu"])
        self.after = self._trained()
        lo, hi = ((0, env.trace_units) if env.traced else
                  (int(mix["check_from"]), int(mix["check_to"])))
        self.check_at = int(env.rng(5).integers(lo, hi))
        self.min_units = self.check_at + 1
        self.window_steps, self.snap, self.extra = 0, None, {}

    @staticmethod
    def _grad(mu0, mu1):
        """The gradient Adam got: mu1 = b1 mu0 + (1 - b1) g."""
        return {(g, n): (t - B1 * mu0[g][n]) / (1.0 - B1)
                for g, grp in mu1.items() for n, t in grp.items()}

    def _trained(self):
        return {(g, n): t.detach().clone() for g, grp in self.state.params.items()
                for n, t in grp.items() if (g, n) in self.first_grad}

    def _update(self):
        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        self.state, m = self.step(self.state, batch, self.gen)
        return float(m["loss"]), float(m["grad_norm"])

    def run_unit(self):
        if self.window_steps == self.check_at:
            before, opt0, batch = self._trained(), self.opt.state_tree(), self.i
            loss, gnorm = self._update()
            self.snap = (batch, before, opt0, loss, self._trained(), self.opt.state_tree())
        else:
            loss, gnorm = self._update()
        self.window_steps += 1
        return 1, int(not (math.isfinite(loss) and math.isfinite(gnorm)))

    def counters(self):
        from hybrid_ode_torch.ops import fused_rk4
        return {"fused_rk4_fwd_launches": fused_rk4.fused_rk4_fwd_launches,
                "fused_rk4_bwd_launches": fused_rk4.fused_rk4_bwd_launches}

    def _dims(self):
        B, T = self.batches[0]["time_points"].shape
        m = self.config
        ctx = m.context_dim if m.context_points > 0 else 0
        return B, T, ctx, flops.field_widths(9 + ctx, m.nn_hidden, m.nn_layers)

    def ops(self, units, counters):
        """Forward and adjoint kernels, and the encoder forward and backward,
        over `units` steps."""
        B, T, ctx, widths = self._dims()
        m = self.config
        ops = sum(flops.kernel_ops(widths, m.nn_layers, m.nn_hidden, B, T, m.substeps, ctx))
        if "enc" in self.params0:
            enc = [(v.shape[0], v.shape[1]) for k, v in sorted(self.params0["enc"].items())
                   if k.startswith("w")]
            ops += 3 * flops.mlp_ops(enc, B)
        return units * ops

    @property
    def kernel_bounds(self):
        B, T, ctx, widths = self._dims()
        m = self.config
        macs, outs = flops.mlp_sizes(widths)
        fo, bo = flops.kernel_ops(widths, m.nn_layers, m.nn_hidden, B, T, m.substeps, ctx)
        fb, bb = flops.kernel_bytes(macs + outs, B, T, ctx)
        return {"fused_rk4_fwd_kernel": flops.bound(fo, fb)[0] * 1e-3,
                "fused_rk4_bwd_kernel": flops.bound(bo, bb)[0] * 1e-3}

    def _ref_tree(self, trained):
        """A reference start: the leaves in `trained`, the rest the checkpoint's."""
        return {g: {n: trained.get((g, n), t).detach() for n, t in grp.items()}
                for g, grp in self.params0.items()}

    def _feed(self, i):
        b = self.batches[i % len(self.batches)]
        return {"initial_state": b["initial_state"], "observations": b["observations"],
                "time_points": b["time_points"], "mask": b["mask"],
                "loss_weights": b["loss_weights"], "meal": b["external_inputs"]["meal"],
                "tvns": b["external_inputs"]["tVNS"]}

    def _references(self, arith):
        """The reference's update at the start and at the window's checked
        update: (losses, clipped gradient, leaves after) of each."""
        if self.snap is None:
            raise RuntimeError(f"the window ended before its update {self.check_at}, "
                               "which the check compares")
        saved = ref_train.saved_adam(self.saved, self.env.device)
        start = ref_train.train_steps(self._ref_tree({}), [self._feed(0)], self.recipe, saved,
                                      arith)
        batch, before, opt0, _, _, _ = self.snap
        issued = 1 + self.check_at  # updates before the checked one: set-up's, the window's
        moments = [{(g, n): t for g, grp in opt0[k].items() for n, t in grp.items()}
                   for k in ("mu", "nu")]
        window = ref_train.train_steps(self._ref_tree(before), [self._feed(batch)], self.recipe,
                                       (saved[0] + issued, saved[1] + issued, *moments), arith)
        return start, window

    def _numbers(self, name, loss, grad, before, after, ref, tag=""):
        r_losses, r_grad, r_after = ref
        norms = {k: float(v.double().norm()) for k, v in r_grad.items()}
        med = float(np.median(list(norms.values())))
        moved = [k for k in r_grad if norms[k] >= 1e-3 * med]
        change_p = {k: after[k] - before[k] for k in moved}
        change_r = {k: r_after[k] - before[k] for k in moved}
        grads, change = leaf_gaps(grad, r_grad, moved), leaf_gaps(change_p, change_r, moved)
        by = {"worst": max, "median": lambda x: float(np.median(x))}
        for leaf, f in by.items():
            self.extra[f"{tag}grad_gap_{name}_{leaf}"] = f(grads)
            self.extra[f"{tag}change_gap_{name}_{leaf}"] = f(change)
        leaf = by[LEAF[name]]
        return [(f"loss_gap_{name}", abs(loss - r_losses[0]) / abs(r_losses[0])),
                (f"grad_gap_{name}", leaf(grads)), (f"change_gap_{name}", leaf(change))]

    def _judged(self, start, window, programs, tag=""):
        """The numbers of the start and the window; `programs` the values
        judged at each, (loss, gradient, leaves after)."""
        before = {(g, n): t for g, grp in self.params0.items() for n, t in grp.items()}
        (l0, g0, a0), (l1, g1, a1) = programs
        return (self._numbers("first", l0, g0, before, a0, start, tag)
                + self._numbers("window", l1, g1, self.snap[1], a1, window, tag))

    def check(self):
        self.state = None
        if self.env.device.type == "cuda":
            torch.cuda.empty_cache()
        start, window = self._references(model.F32)
        _, _, opt0, loss, after, opt1 = self.snap
        return self._judged(start, window, [
            (self.loss_first, self.first_grad, self.after),
            (loss, self._grad(opt0["mu"], opt1["mu"]), after)])

    def control(self):
        """The reference in TF32 stands in for the program at both updates."""
        self.state = None
        start, window = self._references(model.F32)
        t_start, t_window = self._references(model.Arith(tf32=True))
        return self._judged(start, window, [
            (r[0][0], r[1], r[2]) for r in (t_start, t_window)], "control_")


def setup(env):
    return Train(env)
