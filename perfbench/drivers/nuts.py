"""NUTS through the fused engine: transitions of `chains` chains over a batch
of `windows` windows (chains x windows lanes of one fused launch pair per
gradient call), the log density and gradient of
`posterior(..., engine='fused')`.

Set-up runs the sampler's own warmup through its entry point,
`nuts_sample`, as `run_nuts` does: chains start at the checkpoint's values
plus `jitter_start` x N(0, 1), `warmup` transitions of dual averaging from
`init_step_size` with the diagonal inverse mass estimated over the first
half and dual averaging restarted around it, then one draw; the warmup
runs at `warmup_depth` to keep set-up short. Unit: one NUTS transition of
every chain at `max_depth`, at the averaged step sizes and the adapted mass:
the step that `nuts_sample`'s sampling loop takes for each draw
(`mcmc._nuts_step`, which has no public entry that keeps the adapted step
sizes and mass across calls). The benchmark draws the sampler's random
numbers (`Draws`) and counts the gradient evaluations, summed over chains,
with its own wrapper around the callable handed to the sampler; a chain
whose log density or gradient is not finite at a call has failed there.

Check, on a transition of the window drawn from the seed: (1) the plain
reference replays it for `replay_chains` chains drawn from the seed, from
the same start, draws, step sizes and mass, on the log densities and
gradients the program evaluated (`reference/nuts.py`): the leapfrog's
positions, the number of leaves and the proposal the transition took;
(2) the log density and gradient at `check_calls` of that transition's
calls, `check_chains` of those chains each, against the plain reference.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import flops
from perfbench.inputs import load_source, make_windows
from perfbench.reference import model, posterior
from perfbench.reference import nuts as ref_nuts


class Draws:
    """The sampler's random numbers from one generator on the card, with the
    interface the sampler takes (`nuts_sample(draws=...)`): a transition's
    standard normal momentum (C, dim), then per loop iteration a direction
    bit and two uniforms, each (C,). Kept while `record` is a list."""

    def __init__(self, generator: torch.Generator):
        self.generator, self.record = generator, None

    def momentum(self, n_chains, dim, dtype):
        g = self.generator
        z = torch.randn((n_chains, dim), generator=g, dtype=dtype, device=g.device)
        if self.record is not None:
            self.record.append(z)
        return z

    def iteration(self, active):
        g = self.generator
        u = torch.rand((3, active.shape[0]), generator=g, dtype=torch.float64, device=g.device)
        if self.record is not None:
            self.record.append(u)
        return u[0] < 0.5, u[1], u[2]


class Counted:
    """The sampler's log density and gradient, counting calls and chains
    whose values are not finite, and keeping each call's values while
    `record` is a list."""

    def __init__(self, fn):
        self.fn, self.calls, self.record = fn, 0, None
        self.bad_dev = None  # on the card: read once a unit, not once a call

    @property
    def bad(self):
        return 0 if self.bad_dev is None else int(self.bad_dev)

    def __call__(self, Q):
        lp, g = self.fn(Q)
        self.calls += 1
        bad = (~(torch.isfinite(lp) & torch.isfinite(g).all(-1))).sum()
        self.bad_dev = bad if self.bad_dev is None else self.bad_dev + bad
        if self.record is not None:
            self.record.append((Q.detach().clone(), lp.detach().clone(), g.detach().clone()))
        return lp, g


class Nuts:
    unit_name = "grads"

    def __init__(self, env):
        from hybrid_ode_torch.inference import mcmc
        from hybrid_ode_torch.models.hybrid import config_from_dict

        self.env, mix, cfg = env, env.mix, env.config
        self.mcmc = mcmc
        self.config = config_from_dict(cfg)
        self.params = env.params()
        _, meta = env.weights()
        w = make_windows(env.rng(1), int(mix["windows"]), load_source(), meta["state_mean"],
                         meta["state_std"], mix["jitter"])
        w = {k: torch.as_tensor(v[:, : int(mix.get("points", v.shape[1]))]).to(env.device)
             for k, v in w.items()}
        self.batch = w
        self.sigma = float(cfg["posterior"]["noise_sigma"])
        batch = {"initial_state": w["initial_state"], "observations": w["observations"],
                 "time_points": w["time_points"], "mask": w["mask"],
                 "external_inputs": {"meal": w["meal"], "tVNS": w["tvns"]}}
        post = mcmc.posterior(self.params, batch, self.config, engine="fused",
                              noise_sigma=self.sigma)
        names = [f"ode_{n}" for n in posterior.SAMPLED]
        if list(post.layout.names) != names:
            raise RuntimeError(f"the posterior samples {post.layout.names}, the reference {names}")
        self.C = int(mix["chains"])
        self.f = Counted(post.logp_and_grad)
        self.draws = Draws(torch.Generator(env.device).manual_seed(env.torch_seed(3)))
        noise = torch.as_tensor(env.rng(2).standard_normal((self.C, post.layout.dim)),
                                dtype=torch.float32).to(env.device)
        out = mcmc.nuts_sample(None, post.q0[None, :] + float(mix["jitter_start"]) * noise,
                               num_samples=1, num_warmup=int(mix["warmup"]),
                               max_depth=int(mix["warmup_depth"]),
                               target_accept=float(mix["target_accept"]),
                               init_step_size=float(mix["init_step_size"]), adapt_mass=True,
                               logp_and_grad_fn=self.f, draws=self.draws)
        dev = env.device
        self.q = torch.as_tensor(out["samples"][:, -1]).to(dev)
        self.eps = torch.as_tensor(out["step_size"]).to(dev)
        self.inv_mass = torch.as_tensor(out["inv_mass"]).to(dev)
        self.records = []

    def run_unit(self):
        calls, bad = self.f.calls, self.f.bad
        rec = {"start": self.q, "calls": [], "draws": []}
        self.f.record, self.draws.record = rec["calls"], rec["draws"]
        q, _, n_lf, _ = self.mcmc._nuts_step(self.f, self.q, self.draws, self.eps, self.inv_mass,
                                             int(self.env.mix["max_depth"]))
        self.f.record = self.draws.record = None
        rec["q_new"], rec["n_lf"] = q, n_lf
        self.records.append(rec)
        self.q = q
        return (self.f.calls - calls) * self.C, self.f.bad - bad

    def info(self):
        n_lf = [float(r["n_lf"].double().mean()) for r in self.records]
        return {"step_size_median": float(self.eps.median()),
                "step_size_range": [float(self.eps.min()), float(self.eps.max())],
                "inv_mass": [float(x) for x in self.inv_mass],
                "leapfrogs_mean_per_transition": n_lf}

    def counters(self):
        from hybrid_ode_torch.ops import fused_rk4
        return {"fused_rk4_fwd_launches": fused_rk4.fused_rk4_fwd_launches,
                "fused_rk4_bwd_launches": fused_rk4.fused_rk4_bwd_launches,
                "grad_calls": self.f.calls, "host_syncs": self.mcmc.host_syncs}

    def _dims(self):
        B, T = self.batch["time_points"].shape
        m = self.config
        return self.C * B, T, flops.field_widths(9, m.nn_hidden, m.nn_layers)

    def ops(self, units, counters):
        """Forward and adjoint kernels of every gradient call (a transition's
        length varies, so the calls are counted, not the units)."""
        L, T, widths = self._dims()
        m = self.config
        per_call = sum(flops.kernel_ops(widths, m.nn_layers, m.nn_hidden, L, T, m.substeps))
        return counters["grad_calls"] * per_call

    @property
    def kernel_bounds(self):
        L, T, widths = self._dims()
        m = self.config
        macs, outs = flops.mlp_sizes(widths)
        fo, bo = flops.kernel_ops(widths, m.nn_layers, m.nn_hidden, L, T, m.substeps)
        n_rows = len(posterior.SAMPLED)
        fb, bb = flops.kernel_bytes(macs + outs, L, T, n_rows)
        return {"fused_rk4_fwd_kernel": flops.bound(fo, fb)[0] * 1e-3,
                "fused_rk4_bwd_kernel": flops.bound(bo, bb)[0] * 1e-3}

    def _ref_fn(self, arith):
        P = {n: t.detach() for n, t in self.params["ode"].items()}
        nn = {n: t.detach() for n, t in self.params["nn"].items()}
        b = self.batch
        sub = self.config.substeps
        return lambda Q: posterior.log_density_and_grad(Q, b, P, nn, sub, self.sigma, arith)

    def _pick(self):
        """(the checked transition's record, the replayed chains), from the seed."""
        rng = self.env.rng(4)
        rec = self.records[int(rng.integers(len(self.records)))]
        n = min(int(self.env.mix["replay_chains"]), self.C)
        return rec, np.sort(rng.choice(self.C, n, replace=False)), rng

    def _rows(self, rec, chains, rng):
        """The program's values at `check_calls` of the transition's calls
        drawn from the seed, `check_chains` of the replayed chains each."""
        calls = rec["calls"]
        n = min(int(self.env.mix["check_chains"]), len(chains))
        out = []
        for k in np.sort(rng.choice(len(calls), min(int(self.env.mix["check_calls"]), len(calls)),
                                    replace=False)):
            idx = torch.as_tensor(np.sort(rng.choice(chains, n, replace=False)),
                                  device=calls[k][0].device)
            Q, lp, g = calls[k]
            out.append((Q[idx], lp[idx], g[idx]))
        return out

    def compare(self, kept):
        """Numbers: the log density's gap |p - r| / (1 + |r|), worst row; the
        gradient's gap, |p - r| over the parameter's largest |r| across the
        rows, its 90th percentile over the rows, worst parameter. (A few rows
        hold a gradient that is a nearly cancelling sum, where two f32
        computations part by up to a percent of the largest: PERF.md.)"""
        Q = torch.cat([k[0] for k in kept])
        lp_r, g_r = self._ref_fn(model.F32)(Q)
        lp_p = torch.cat([k[1] for k in kept]).double()
        g_p = torch.cat([k[2] for k in kept]).double()
        lp_r, g_r = lp_r.double(), g_r.double()
        logp_gap = float(((lp_p - lp_r).abs() / (1.0 + lp_r.abs())).max())
        rel = (g_p - g_r).abs() / g_r.abs().max(0).values.clamp_min(1e-30)
        grad_gap = float(torch.quantile(rel, 0.9, dim=0).max())
        return [("logp_gap", logp_gap), ("grad_gap", grad_gap)]

    def replay(self, rec, chains):
        """(the worst leapfrog gap, the share of replayed chains whose number
        of leaves or proposal differs from the reference's)."""
        idx = torch.as_tensor(chains, device=rec["start"].device)

        def host(t):
            return t[idx].cpu().numpy()

        Q = np.stack([host(c[0]) for c in rec["calls"]])
        LP = np.stack([host(c[1]) for c in rec["calls"]])
        G = np.stack([host(c[2]) for c in rec["calls"]])
        z = host(rec["draws"][0])
        U = (np.stack([u[:, idx].cpu().numpy() for u in rec["draws"][1:]])
             if len(rec["draws"]) > 1 else np.zeros((0, 3, len(chains))))
        start, q_new, n_lf = host(rec["start"]), host(rec["q_new"]), host(rec["n_lf"])
        eps, inv_mass = host(self.eps), self.inv_mass.cpu().numpy()
        worst, differ = 0.0, 0
        for c in range(len(chains)):
            def leaf(k, c=c):
                if k >= len(Q) or k > len(U):
                    return None
                u = U[k - 1][:, c]
                return Q[k, c], LP[k, c], G[k, c], u[0] < 0.5, u[1], u[2]
            n, prop, gap = ref_nuts.transition(start[c], LP[0, c], G[0, c], z[c], float(eps[c]),
                                               inv_mass, int(self.env.mix["max_depth"]), leaf)
            worst = max(worst, gap)
            chosen = start[c] if prop == 0 else Q[prop, c]
            if n != int(n_lf[c]) or not np.array_equal(q_new[c], chosen):
                differ += 1
        return worst, differ / len(chains)

    def check(self):
        rec, chains, rng = self._pick()
        leapfrog_gap, tree_differ = self.replay(rec, chains)
        return self.compare(self._rows(rec, chains, rng)) + [
            ("leapfrog_gap", leapfrog_gap), ("tree_differ", tree_differ)]

    def control(self):
        """The reference in TF32 stands in for the program's log density and
        gradient."""
        rec, chains, rng = self._pick()
        tf = self._ref_fn(model.Arith(tf32=True))
        return self.compare([(Q,) + tuple(tf(Q)) for Q, _, _ in self._rows(rec, chains, rng)])


def setup(env):
    return Nuts(env)
