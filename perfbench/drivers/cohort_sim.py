"""Cohort simulation: a closed loop of forward-only `batched_forward` calls.

Unit: one cohort of `windows` windows (context encoded where the model has
an encoder), integrated without gradients and copied to the host, as a
study saves it. `cohorts` distinct cohorts are made in set-up and cycled.
A window whose adaptive solve ran out of its step budget (`success`
False) has failed.

Check: after the window, `check_windows` windows of each unit are drawn
from the seed (their host copies kept), and the plain reference integrates
them again: RK4 for a fixed-step configuration, dopri5 for an adaptive one.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import flops
from perfbench.inputs import load_source, make_windows
from perfbench.reference import dopri5, model


class CohortSim:
    unit_name = "windows"

    def __init__(self, env):
        from hybrid_ode_torch.models.hybrid import config_from_dict

        self.env, mix, cfg = env, env.mix, env.config
        self.params = env.params()
        _, meta = env.weights()
        self.mean, self.std = meta["state_mean"], meta["state_std"]
        self.config = config_from_dict(cfg)
        self.adaptive = self.config.solver != "rk4"
        src = load_source()
        rng = env.rng(1)
        self.cohorts = []
        for _ in range(int(mix["cohorts"])):
            w = make_windows(rng, int(mix["windows"]), src, self.mean, self.std, mix["jitter"])
            w = {k: v[:, : int(mix.get("points", v.shape[1]))] if v.ndim > 1 else v
                 for k, v in w.items()}
            self.cohorts.append({k: torch.as_tensor(v).to(env.device) for k, v in w.items()})
        self.pick = env.rng(2)
        self.samples = []   # (cohort, windows, host trajectories, accepted, rejected, success)
        self.i = 0
        self.warm = True
        for _ in range(int(mix.get("warmup_units", 1))):
            self.run_unit()
        self.warm, self.i = False, 0

    def _forward(self, c):
        from hybrid_ode_torch.dynamics.controls import Controls
        from hybrid_ode_torch.models.hybrid import batched_forward, with_context

        batch = {"observations": c["observations"], "time_points": c["time_points"]}
        ctrl = Controls(ts=c["time_points"], signals={"meal": c["meal"], "tVNS": c["tvns"]})
        with torch.no_grad():
            ctrl = with_context(self.params, batch, ctrl, self.config)
            if self.adaptive:
                return batched_forward(self.params, c["initial_state"], c["time_points"], ctrl,
                                       self.config, return_stats=True)
            return batched_forward(self.params, c["initial_state"], c["time_points"], ctrl,
                                   self.config), None

    def run_unit(self):
        k = self.i % len(self.cohorts)
        self.i += 1
        traj, stats = self._forward(self.cohorts[k])
        host = traj.cpu()
        n = host.shape[0]
        failed = 0
        st = None
        if stats is not None:
            st = [x.cpu() for x in stats]
            failed = int((~st[2]).sum())
        if not self.warm:
            sel = np.sort(self.pick.choice(n, int(self.env.mix["check_windows"]), replace=False))
            idx = torch.as_tensor(sel)
            row = (k, sel, host.index_select(0, idx))
            row += tuple(x.index_select(0, idx) for x in st) if st is not None else (None, None, None)
            self.samples.append(row)
        return n, failed

    def counters(self):
        from hybrid_ode_torch.ops import fused_rk4
        from hybrid_ode_torch.solvers import explicit
        return {"fused_rk4_fwd_launches": fused_rk4.fused_rk4_fwd_launches,
                "host_syncs": explicit.host_syncs}

    @property
    def _shape(self):
        c = self.cohorts[0]
        return c["time_points"].shape

    def ops(self, units, counters):
        """The forward kernel's operations and the encoder's over `units`
        cohorts (fixed-step configurations only: adaptive work depends on
        the data)."""
        if self.adaptive:
            return None
        B, T = self._shape
        m = self.config
        ctx = m.context_dim if m.context_points > 0 else 0
        widths = flops.field_widths(9 + ctx, m.nn_hidden, m.nn_layers)
        ops = flops.kernel_ops(widths, m.nn_layers, m.nn_hidden, B, T, m.substeps, ctx)[0]
        if ctx:
            enc = [(v.shape[0], v.shape[1]) for k, v in sorted(self.params["enc"].items())
                   if k.startswith("w")]
            ops += flops.mlp_ops(enc, B)
        return units * ops

    @property
    def kernel_bounds(self):
        """{trace pattern: least seconds per launch} of the fused kernels."""
        if self.adaptive:
            return {}
        B, T = self._shape
        m = self.config
        ctx = m.context_dim if m.context_points > 0 else 0
        widths = flops.field_widths(9 + ctx, m.nn_hidden, m.nn_layers)
        macs, outs = flops.mlp_sizes(widths)
        fwd_ops, _ = flops.kernel_ops(widths, m.nn_layers, m.nn_hidden, B, T, m.substeps, ctx)
        fwd_bytes, _ = flops.kernel_bytes(macs + outs, B, T, ctx)
        return {"fused_rk4_fwd_kernel": flops.bound(fwd_ops, fwd_bytes)[0] * 1e-3}

    def _reference(self, picks, arith):
        """The reference's trajectories (and for an adaptive solve its step
        counts and success) of the windows `picks` = [(cohort, window)], in
        one batch."""
        sub = {k: torch.cat([self.cohorts[c][k][w:w + 1] for c, w in picks])
               for k in self.cohorts[0]}
        ref = {g: {n: t.detach() for n, t in leaves.items()} for g, leaves in self.params.items()}
        m = self.config
        if self.adaptive:
            return dopri5.solve(sub["initial_state"], sub["time_points"], sub["meal"], sub["tvns"],
                                ref["ode"], ref["nn"], m.rtol, m.atol, m.max_steps_per_interval,
                                arith)
        with torch.no_grad():
            ctx = None
            if m.context_points > 0:
                ctx = model.encode(ref["enc"], sub["observations"], sub["time_points"],
                                   m.context_points, arith)
            return (model.rk4(sub["initial_state"], sub["time_points"], sub["meal"], sub["tvns"],
                              ctx, ref["ode"], ref["nn"], m.substeps, arith), None, None, None)

    def _sampled(self):
        """{(cohort, window): (host trajectory, (success, accepted, rejected)
        or None)} of the windows drawn in the window's units."""
        out = {}
        for k, sel, host, acc, rej, succ in self.samples:
            for j, w in enumerate(sel):
                out[(k, int(w))] = (host[j], None if succ is None else
                                    (bool(succ[j]), int(acc[j]), int(rej[j])))
        return out

    def compare(self, outputs):
        """The numbers compared: per window, the worst |p - r| / (1 + |r|)
        over its trajectory. For adaptive solves (where the reference and the
        program take other steps in some windows: an accepted step flips on
        rounding where an error norm sits near 1): the median window's gap;
        the worst gap of the windows whose step counts agree (of all windows
        where none agree); the share of windows whose step counts differ;
        the windows whose success differs."""
        picks = sorted(outputs)
        ref, acc, rej, succ = self._reference(picks, model.F32)
        ref = ref.double().cpu()
        gaps, same_gaps, steps_differ, success_differ = [], [], 0, 0
        for j, key in enumerate(picks):
            p, st = outputs[key]
            e = float(((p.double() - ref[j]).abs() / (1.0 + ref[j].abs())).max())
            gaps.append(e)
            if st is not None:
                same = st[1] == int(acc[j]) and st[2] == int(rej[j])
                steps_differ += not same
                success_differ += st[0] != bool(succ[j])
                if same:
                    same_gaps.append(e)
        if not self.adaptive:
            return [("traj_gap", max(gaps))]
        return [("traj_gap_median", float(np.median(gaps))),
                ("traj_gap_same_steps", max(same_gaps or gaps)),
                ("steps_differ_share", steps_differ / len(picks)),
                ("success_differ", float(success_differ))]

    def check(self):
        return self.compare(self._sampled())

    def control(self):
        """The same numbers with the reference in TF32 in the program's place."""
        picks = sorted(self._sampled())
        traj, acc, rej, succ = self._reference(picks, model.Arith(tf32=True))
        traj = traj.cpu()
        return self.compare({key: (traj[j], None if acc is None else
                                   (bool(succ[j]), int(acc[j]), int(rej[j])))
                             for j, key in enumerate(picks)})


def setup(env):
    return CohortSim(env)
