"""Online adaptation: one subject after another adapts the population model
on the revealed start of its stream, one update a unit, through
`hybrid_ode_torch.train.online`'s `subject_adaptation` and the
`Adaptation` it builds, as `adapt_subject` runs them.

Set-up loads the configuration's weights, makes a pool of `pool` subjects'
streams from the stream file beside the benchmark (`data/<stream>`, rebased
to the checkpoint's state_mean / state_std and jittered from the seed by
`perfbench/inputs.py`; the initial state is the jittered first observation,
so `y0_sd` has no effect), reveals each for `reveal_hours` (the program's
`_reveal_at` rule: 288 points at 24 h), builds the first subject's
adaptation and takes its first update. The window continues one update a
unit: each subject takes `updates_per_subject` updates, then the next
subject of the pool starts from the population weights with a fresh Adam.
An update whose loss is not finite has failed. As in `_adapt`, nothing of
an update is read to the host while the card runs it: a unit queues its
update, then waits for the previous update's loss (copied to the host
behind that update), so the card always holds the next update; the
window's closing synchronisation ends the last, whose loss `check()` reads.

Check, by one update each, every adapted leaf compared by the norm of the
gap between the program's and the reference's values over the larger of
the reference leaf's norm and the median leaf's; a leaf that the program
did not adapt has a gradient and a change of 0. The gradients are judged
by the worst leaf, so that a fault in one leaf's gradient shows. The
changes are judged by the median leaf: a change is Adam's normalised
step, which magnifies rounding where it divides by little. At the start
it is lr x sign(g) bar eps, so on the entries whose gradient lies within
rounding of 0 the sign, and with it a whole step, flips between two sound
sums. The worst leaf's gap, the flipped entries' count, their largest |g|
over their leaf's, and the worst leaf's gap without them are kept beside
it (PERF.md, section 2).
  * the start: the reference (`perfbench/reference/online.py`) repeats
    set-up's update from the population weights on the first subject's
    reveal; compared are its loss, the gradient as Adam got it (from Adam's
    first moment: with a fresh Adam, mu1 = (1 - b1) g) and each leaf's
    change;
  * the window: at an update drawn from the seed (from `check_from` to
    `check_to`, which lie inside the second subject, or among a traced
    run's units), the benchmark copies the program's leaves and Adam
    moments before and after it. The reference takes the same update from
    the copy before (at a subject's first update: the population weights
    and zero moments), with the Adam count that the subject's updates so
    far give, on that subject's reveal, and the same numbers are compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import flops
from perfbench.inputs import HERE, load_source, make_windows
from perfbench.reference import model
from perfbench.reference import online as ref

B1 = 0.9


def reveal_points(time_points, hours: float) -> int:
    """Points revealed after `hours` of a stream, kept 4 from either end."""
    r = int(np.searchsorted(time_points, float(time_points[0]) + hours))
    return int(np.clip(r, 4, len(time_points) - 4))


def gaps(prog, ref_, names, rule):
    """||p - r|| / max(||r||, median ||r||) of each leaf, by `rule`."""
    norms = {k: float(ref_[k].double().norm()) for k in names}
    median = float(np.median(list(norms.values())))
    out = [float((prog[k].double() - ref_[k].double()).norm()) / max(norms[k], median, 1e-30)
           for k in names]
    return max(out) if rule == "worst" else float(np.median(out))


class Online:
    unit_name = "updates"

    def __init__(self, env):
        # a program without the step object fails here, before any work
        from hybrid_ode_torch.models.hybrid import config_from_dict
        from hybrid_ode_torch.train.online import subject_adaptation

        self.env, mix, cfg = env, env.mix, env.config
        self.adapt_new = subject_adaptation
        self.config = config_from_dict(cfg)
        proto = cfg["online"]
        self.recipe = {"context_points": self.config.context_points,
                       "substeps": self.config.substeps,
                       "learning_rate": float(proto["learning_rate"]),
                       "anchor_weight": float(proto["anchor_weight"]),
                       "adapt_scope": proto["adapt_scope"]}
        _, meta = env.checkpoint()
        src = load_source(HERE / "data" / mix["stream"])
        self.R = reveal_points(src["time"][0], float(mix["reveal_hours"]))
        w = make_windows(env.rng(1), int(mix["pool"]), src, meta["state_mean"],
                         meta["state_std"], mix["jitter"])
        self.streams = [{"observations": w["observations"][i], "time_points": w["time_points"][i],
                         "external_inputs": {"meal": w["meal"][i], "tVNS": w["tvns"][i]},
                         "mask": w["mask"][i]} for i in range(len(w["mask"]))]
        self.per_subject = int(mix["updates_per_subject"])
        self.params0 = env.params()
        self.pop_nn = dict(self.params0["nn"])
        self.names = ref.scope_names(self.pop_nn, self.recipe["adapt_scope"])
        self.i, self.adaptation = 0, None
        first = self._update(snap=True)
        self.first = (float(first[0]), first[2])
        self.pending = None
        lo, hi = ((0, env.trace_units) if env.traced else
                  (int(mix["check_from"]), int(mix["check_to"])))
        self.check_at = int(env.rng(5).integers(lo, hi))
        self.min_units = self.check_at + 1
        self.window_updates, self.snap, self.extra, self.f32 = 0, None, {}, None

    # ---- the program -----------------------------------------------------

    def _subject(self, s):
        return self.adapt_new(self.params0, self.streams[s % len(self.streams)], self.config,
                              self.R, self.recipe["learning_rate"],
                              anchor_weight=self.recipe["anchor_weight"],
                              adapt_scope=self.recipe["adapt_scope"])

    def _state(self):
        """(leaves, {name: (mu, nu)}) of the scope's leaves, copied; a leaf
        the program does not adapt has zero moments."""
        a = self.adaptation
        leaves = {k: a.p["nn"][k].detach().clone() for k in self.names}
        moments = {}
        for k in self.names:
            st = a.opt.state.get(a.trained[k], {}) if k in a.trained else {}
            z = torch.zeros_like(leaves[k])
            moments[k] = (st.get("exp_avg", z).detach().clone(),
                          st.get("exp_avg_sq", z).detach().clone())
        return leaves, moments

    def _update(self, snap=False):
        """One update: (loss, the subject's updates before it, (state before,
        state after) or None)."""
        k = self.i % self.per_subject
        if k == 0:
            self.adaptation = self._subject(self.i // self.per_subject)
        before = self._state() if snap else None
        loss = self.adaptation.step()
        self.i += 1
        return loss, k, (before, self._state()) if snap else None

    @staticmethod
    def _copy_out(loss):
        """The loss, copied to the host behind its update: (copy, event)."""
        if loss.device.type != "cuda":
            return loss, None
        host = loss.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _read(pending) -> float:
        host, done = pending
        if done is not None:
            done.synchronize()
        return float(host)

    def run_unit(self):
        """Queue one update, then read the previous one's loss: the failed
        count of a unit is its predecessor's (the first unit's: none)."""
        snap = self.window_updates == self.check_at
        i = self.i
        loss, k, states = self._update(snap)
        if snap:
            self.snap = (i, k, loss, states)
        previous, self.pending = self.pending, self._copy_out(loss)
        self.window_updates += 1
        return 1, int(previous is not None and not math.isfinite(self._read(previous)))

    def counters(self):
        from hybrid_ode_torch.ops import fused_rk4
        return {"fused_rk4_fwd_launches": fused_rk4.fused_rk4_fwd_launches,
                "fused_rk4_bwd_launches": fused_rk4.fused_rk4_bwd_launches}

    def info(self):
        return {"reveal_points": self.R, "updates": self.i,
                "subjects": -(-self.i // self.per_subject), "check_at": self.check_at}

    def _dims(self):
        m = self.config
        ctx = m.context_dim if m.context_points > 0 else 0
        return 1, self.R, ctx, flops.field_widths(9 + ctx, m.nn_hidden, m.nn_layers)

    def ops(self, units, counters):
        """Forward and adjoint kernels, and the encoder forward and backward,
        over `units` updates."""
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

    # ---- the reference -----------------------------------------------------

    def _batch(self, s):
        """Subject s's reveal as the reference takes it (its first
        observation the initial state, as the program's)."""
        w = self.streams[s % len(self.streams)]

        def t(x):
            return torch.as_tensor(np.asarray(x))[None].to(self.env.device)
        return {"initial_state": t(w["observations"][0]),
                "observations": t(w["observations"][: self.R]),
                "time_points": t(w["time_points"][: self.R]),
                "meal": t(w["external_inputs"]["meal"][: self.R]),
                "tvns": t(w["external_inputs"]["tVNS"][: self.R]), "mask": t(w["mask"][: self.R])}

    def _tree(self, leaves):
        return {g: {n: (leaves.get(n, t) if g == "nn" else t).detach() for n, t in grp.items()}
                for g, grp in self.params0.items()}

    def _references(self, arith):
        """The reference's update at the start and at the window's checked
        one: (loss, gradient, leaves after) of each."""
        if self.snap is None:
            raise RuntimeError(f"the window ended before its update {self.check_at}, "
                               "which the check compares")
        zero = ref.fresh_moments(self.params0, self.recipe["adapt_scope"])
        start = ref.update(self._tree({}), self.pop_nn, self._batch(0), self.recipe, zero, 0,
                           arith)[:3]
        i, k, _, ((leaves, moments), _) = self.snap
        if k == 0:  # a subject's first update starts from the population
            leaves, moments = {}, zero
        window = ref.update(self._tree(leaves), self.pop_nn, self._batch(i // self.per_subject),
                            self.recipe, moments, k, arith)[:3]
        return start, window

    def _flips(self, name, change_p, change_r, r_grad, tag):
        """Kept beside the change's gap: the entries whose change has
        another sign than the reference's, their largest |g| over their
        leaf's largest, and the worst leaf's gap without them."""
        flip = {k: torch.sign(change_p[k]) != torch.sign(change_r[k]) for k in self.names}
        share = [float(r_grad[k].abs()[flip[k]].max() / r_grad[k].abs().max().clamp_min(1e-30))
                 for k in self.names if bool(flip[k].any())]
        kept = [{k: c[k].masked_fill(flip[k], 0.0) for k in self.names}
                for c in (change_p, change_r)]
        self.extra[f"{tag}change_{name}_flipped"] = int(sum(int(f.sum()) for f in flip.values()))
        self.extra[f"{tag}change_{name}_flipped_grad_share"] = max(share, default=0.0)
        self.extra[f"{tag}change_gap_{name}_worst_unflipped"] = gaps(*kept, self.names, "worst")

    def _numbers(self, name, prog, before, reference, tag=""):
        """The loss's gap, the gradient's by the worst leaf, the change's by
        the median leaf."""
        loss, grad, after = prog
        r_loss, r_grad, r_after = reference
        change_p = {k: after[k] - before[k] for k in self.names}
        change_r = {k: r_after[k] - before[k] for k in self.names}
        for rule in ("worst", "median"):
            self.extra[f"{tag}grad_gap_{name}_{rule}"] = gaps(grad, r_grad, self.names, rule)
            self.extra[f"{tag}change_gap_{name}_{rule}"] = gaps(change_p, change_r, self.names,
                                                               rule)
        self._flips(name, change_p, change_r, r_grad, tag)
        return [(f"loss_gap_{name}", abs(loss - r_loss) / abs(r_loss)),
                (f"grad_gap_{name}", self.extra[f"{tag}grad_gap_{name}_worst"]),
                (f"change_gap_{name}", self.extra[f"{tag}change_gap_{name}_median"])]

    def _judged(self, start, window, programs, tag=""):
        """The numbers of the start and the window; `programs` the values
        judged at each, (loss, gradient, leaves after)."""
        i, k, _, ((leaves, _), _) = self.snap
        before = {n: self.pop_nn[n] for n in self.names}
        window_before = before if k == 0 else leaves
        return (self._numbers("first", programs[0], before, start, tag)
                + self._numbers("window", programs[1], window_before, window, tag))

    @staticmethod
    def _grad(m0, m1):
        """The gradient Adam got: mu1 = b1 mu0 + (1 - b1) g."""
        return {k: (m1[k][0] - B1 * m0[k][0]) / (1.0 - B1) for k in m1}

    def check(self):
        if self.pending is not None and not math.isfinite(self._read(self.pending)):
            raise RuntimeError("the window's last update has a loss that is not finite")
        self.adaptation = None
        if self.env.device.type == "cuda":
            torch.cuda.empty_cache()
        self.f32 = start, window = self._references(model.F32)
        loss0, ((_, m0), (after0, m1)) = self.first
        _, _, loss1, ((_, w0), (after1, w1)) = self.snap
        return self._judged(start, window, [(loss0, self._grad(m0, m1), after0),
                                            (float(loss1), self._grad(w0, w1), after1)])

    def control(self):
        """The reference in TF32 stands in for the program at both updates."""
        self.adaptation = None
        start, window = self.f32 or self._references(model.F32)
        t_start, t_window = self._references(model.Arith(tf32=True))
        return self._judged(start, window, [t_start, t_window], "control_")


def setup(env):
    return Online(env)
