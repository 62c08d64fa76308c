"""No-U-Turn Sampler over a chain axis, the hybrid model's posterior, and
rank-normalised diagnostics.

Port of `hybrid_ode_tpu/inference/mcmc.py`:

  * multinomial NUTS with iterative tree doubling (Hoffman & Gelman 2014;
    progressive biased sampling as in Stan), sub-tree U-turns checked with
    the checkpoint scheme of Phan & Pradhan (O(max_depth) saved states);
    dual-averaging step sizes and a Welford diagonal mass matrix in warmup.
  * The JAX package vmaps one chain's `lax.while_loop` over the chains. Here
    the chain axis is written out: every carry holds (C, ...) tensors, the
    loop body runs for all chains, and a chain keeps its new carry only
    while it is active (`~done & depth < max_depth`), behind `torch.where`.
    The loop ends when no chain is active: one host synchronisation per
    leapfrog (counted in `host_syncs`). A chain's result does not depend on
    the others'.
  * Random numbers come from a draw source: the momentum (C, dim) per
    transition, then per loop iteration a direction bit and two uniforms
    per chain (drawn every iteration, as the JAX package's key schedule
    does; a finished chain's draws go unused). The default source is a
    `torch.Generator` on the device; a test source can replay JAX's keys.
  * Log-posteriors are batched: (C, dim) -> (C,), with their gradient
    (C, dim). Engine 'xla' (the JAX name, kept for the CLI) is the generic
    path: `batched_forward` with the chains as a member axis
    (`models/bayes.py::forward_samples`). Engine 'fused' puts chain c,
    window b on lane c*B + b of one fused RK4 launch, the chains' 7 sampled
    ODE parameters as per-lane context rows applied absolutely
    (`ctx_param_mode='abs'`): every leapfrog of all chains is one forward
    and one hand-adjoint kernel launch.
  * Across devices (`nuts_sample(mesh=)`, `run_nuts(mesh=)`) each rank runs
    its block of the chains on the same draws the unsharded run makes; the
    tree loop's active count and the warmup's Welford sums are all-reduced,
    and the results gathered in chain order.
  * Under a profiler, a transition is a `hode.nuts.transition` span
    (attributes `iterations`, the loop's leapfrog iterations; `chains`; and
    `chain_leapfrogs`, the leapfrogs summed over chains), each batched
    log-posterior gradient a `hode.nuts.grad` span, each read of the
    active count a `hode.sync.nuts` span, and the copy of the noise scale to
    the card, which waits for the forward kernel, a `hode.sync.copy` span
    (`utils/profiling.py`).

Diagnostics (split R-hat, bulk / tail ESS on rank-normalised draws) and
persistence (an h5py NetCDF4 file, else npz + json) are numpy, as in the
JAX package.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hybrid_ode_torch.data.dataset import batch_to_tensors
from hybrid_ode_torch.models.bayes import forward_samples
from hybrid_ode_torch.models.hybrid import controls_from_batch, with_context
from hybrid_ode_torch.parallel.mesh import DataShards, all_gather_cat, axis_size, local_slice
from hybrid_ode_torch.utils.profiling import recording, set_attr, span

logger = logging.getLogger("hybrid_ode_torch.mcmc")

#: device-to-host synchronisations of the NUTS loop (one per leapfrog: the
#: test whether any chain is still active)
host_syncs = 0
#: batched log-posterior-and-gradient evaluations: the initial one of each
#: transition and one per leapfrog (each evaluates every chain)
grad_evals = 0
#: transitions taken (each advances every chain once)
transitions = 0

LogpAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# Leapfrog + energy, over a chain axis
# ---------------------------------------------------------------------------

class _LFState(NamedTuple):
    q: torch.Tensor     # (C, dim)
    p: torch.Tensor     # (C, dim)
    grad: torch.Tensor  # (C, dim): d logp / d q at q
    logp: torch.Tensor  # (C,)


def _logp_and_grad(logp_and_grad: LogpAndGrad, q: torch.Tensor):
    global grad_evals
    grad_evals += 1
    with span("hode.nuts.grad"):
        logp, grad = logp_and_grad(q)
        return logp.detach(), grad.detach()


def _leapfrog(logp_and_grad: LogpAndGrad, state: _LFState, eps: torch.Tensor,
              inv_mass: torch.Tensor) -> _LFState:
    """One leapfrog step of every chain; eps (C,) (signed: the direction)."""
    e = eps[:, None]
    p_half = state.p + 0.5 * e * state.grad
    q_new = state.q + e * inv_mass * p_half
    logp_new, grad_new = _logp_and_grad(logp_and_grad, q_new)
    p_new = p_half + 0.5 * e * grad_new
    return _LFState(q_new, p_new, grad_new, logp_new)


def _energy(state: _LFState, inv_mass: torch.Tensor) -> torch.Tensor:
    return -state.logp + 0.5 * torch.sum(inv_mass * state.p ** 2, dim=-1)


def _is_turning(q_minus, p_minus, q_plus, p_plus, inv_mass) -> torch.Tensor:
    """The classic U-turn criterion across a span (over the last axis)."""
    dq = q_plus - q_minus
    return ((torch.sum(dq * (inv_mass * p_plus), dim=-1) < 0.0)
            | (torch.sum(dq * (inv_mass * p_minus), dim=-1) < 0.0))


def _where(cond: torch.Tensor, a, b):
    """torch.where with a (C,) condition over (C, ...) tensors or _LFStates."""
    if isinstance(a, _LFState):
        return _LFState(*(_where(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)


# ---------------------------------------------------------------------------
# Random numbers
# ---------------------------------------------------------------------------

class TorchDraws:
    """The sampler's draws from one `torch.Generator` (on the chains' device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, n_chains: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
        """Standard normal (C, dim), one transition's momentum before the mass."""
        g = self.generator
        return torch.randn((n_chains, dim), generator=g, dtype=dtype, device=g.device)

    def iteration(self, active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(direction bit, uniform, uniform), each (C,), for one loop iteration."""
        g, n, dt = self.generator, active.shape[0], torch.float64
        u = torch.rand((3, n), generator=g, dtype=dt, device=g.device)
        return u[0] < 0.5, u[1], u[2]


# ---------------------------------------------------------------------------
# One NUTS transition of every chain
# ---------------------------------------------------------------------------

def _nuts_step(logp_and_grad: LogpAndGrad, q0: torch.Tensor, draws, eps: torch.Tensor,
               inv_mass: torch.Tensor, max_depth: int, chains: Optional["_ChainShard"] = None):
    """One NUTS transition of C chains: q0 (C, dim), eps (C,), inv_mass
    (dim,). Returns (q_new, accept_stat, n_leapfrog, diverged), each with a
    leading (C,).

    One loop over leapfrog steps, the doubling structure (direction, subtree
    reset, merge) from a (depth, position) counter pair per chain: a turned
    or diverged subtree ends the chain's transition and is discarded (its
    end points and weight revert). NaN energy errors give alpha = 0.

    chains: q0 is this rank's shard of chains sharded over a mesh dim. The
    loop then runs until no chain on ANY rank is active (an all-reduce of
    the active count, at the loop's host synchronisation), so that every
    rank draws as many iterations as the unsharded run; a rank with no
    active chain of its own only draws."""
    with span("hode.nuts.transition", chains=q0.shape[0]):
        return _tree_loop(logp_and_grad, q0, draws, eps, inv_mass, max_depth, chains)


def _tree_loop(logp_and_grad: LogpAndGrad, q0: torch.Tensor, draws, eps: torch.Tensor,
               inv_mass: torch.Tensor, max_depth: int, chains: Optional["_ChainShard"]):
    """The body of `_nuts_step`."""
    global host_syncs, transitions
    transitions += 1
    C, dim = q0.shape
    dtype, dev = q0.dtype, q0.device
    logp0, grad0 = _logp_and_grad(logp_and_grad, q0)
    p0 = draws.momentum(C, dim, dtype).to(dev) / torch.sqrt(inv_mass)
    init = _LFState(q0, p0, grad0, logp0)
    H0 = _energy(init, inv_mass)

    max_ck = max_depth + 1
    levels = torch.arange(max_ck, device=dev)
    pow2 = 2 ** levels
    zeros = torch.zeros((C,), dtype=dtype, device=dev)
    false = torch.zeros((C,), dtype=torch.bool, device=dev)
    izero = torch.zeros((C,), dtype=torch.int64, device=dev)
    c = dict(left=init, right=init, prop_q=q0, log_w=zeros, sum_alpha=zeros, n_lf=izero,
             diverging=false, depth=izero, pos=izero, direction=torch.ones_like(zeros),
             state=init, q_ck=torch.zeros((C, max_ck, dim), dtype=dtype, device=dev),
             p_ck=torch.zeros((C, max_ck, dim), dtype=dtype, device=dev), sub_prop=q0,
             sub_log_w=torch.full((C,), -torch.inf, dtype=dtype, device=dev),
             sub_turning=false, sub_div=false, done=false)
    iterations = 0
    while True:
        active = ~c["done"] & (c["depth"] < max_depth)
        host_syncs += 1
        count = active.sum()
        with span("hode.sync.nuts"):
            n_active = int(count)
        if chains is not None:
            if chains.total(n_active) == 0:
                break
        elif n_active == 0:
            break
        dir_bit, u_take, u_merge = (x.to(dev) for x in draws.iteration(active))
        if n_active == 0:
            continue
        iterations += 1
        # doubling start: sample a direction, reset the subtree
        starting = c["pos"] == 0
        direction = torch.where(starting, torch.where(dir_bit, 1.0, -1.0).to(dtype),
                                c["direction"])
        fwd = direction > 0
        start_state = _where(starting, _where(fwd, c["right"], c["left"]), c["state"])
        sub_log_w = torch.where(starting, -torch.inf, c["sub_log_w"])
        sub_turning = c["sub_turning"] & ~starting
        sub_div = c["sub_div"] & ~starting
        sub_prop = _where(starting, start_state.q, c["sub_prop"])

        # one leapfrog leaf
        state_new = _leapfrog(logp_and_grad, start_state, eps * direction, inv_mass)
        dH = H0 - _energy(state_new, inv_mass)  # > 0 means better
        finite = torch.isfinite(dH)
        div_new = ~finite | (dH < -1000.0)
        log_w_leaf = torch.where(div_new, -torch.inf, dH)
        alpha = torch.where(finite, torch.clamp(torch.exp(torch.clamp(dH, max=0.0)), max=1.0),
                            0.0)

        # progressive multinomial sampling within the subtree
        sub_log_w_new = torch.logaddexp(sub_log_w, log_w_leaf)
        take = torch.log(u_take).to(dtype) < (log_w_leaf - sub_log_w_new)
        sub_prop_new = _where(take, state_new.q, sub_prop)

        # checkpoints: store the post-step state at every level j with
        # pos % 2^j == 0; check the span ending here for levels j >= 1 with
        # (pos + 1) % 2^j == 0
        pos = c["pos"][:, None]
        store = ((pos % pow2) == 0)[..., None]
        q_ck = torch.where(starting[:, None, None], 0.0, c["q_ck"])
        p_ck = torch.where(starting[:, None, None], 0.0, c["p_ck"])
        q_ck_new = torch.where(store, state_new.q[:, None, :], q_ck)
        p_ck_new = torch.where(store, state_new.p[:, None, :], p_ck)
        check = (((pos + 1) % pow2) == 0) & (levels >= 1)
        f3 = fwd[:, None, None]
        qs, ps = state_new.q[:, None, :], state_new.p[:, None, :]
        span_turns = _is_turning(torch.where(f3, q_ck_new, qs), torch.where(f3, p_ck_new, ps),
                                 torch.where(f3, qs, q_ck_new), torch.where(f3, ps, p_ck_new),
                                 inv_mass)
        sub_turning_new = sub_turning | torch.any(span_turns & check, dim=-1)
        sub_div_new = sub_div | div_new

        # doubling end: merge the completed subtree into the tree
        finishing = (c["pos"] + 1) == torch.pow(2, c["depth"])
        log_w_total = torch.logaddexp(c["log_w"], sub_log_w_new)
        take_new = torch.log(u_merge).to(dtype) < (sub_log_w_new - c["log_w"])
        discard = sub_turning_new | sub_div_new
        prop_q_merged = _where(take_new & ~discard, sub_prop_new, c["prop_q"])
        left_m = _where(fwd, c["left"], state_new)
        right_m = _where(fwd, state_new, c["right"])
        turning_total = _is_turning(left_m.q, left_m.p, right_m.q, right_m.p, inv_mass)
        keep = finishing & ~discard
        new = dict(
            left=_where(keep, left_m, c["left"]), right=_where(keep, right_m, c["right"]),
            prop_q=_where(finishing, prop_q_merged, c["prop_q"]),
            log_w=torch.where(keep, log_w_total, c["log_w"]),
            sum_alpha=c["sum_alpha"] + alpha, n_lf=c["n_lf"] + 1,
            diverging=c["diverging"] | div_new,
            depth=torch.where(finishing, c["depth"] + 1, c["depth"]),
            pos=torch.where(finishing, 0, c["pos"] + 1),
            direction=direction, state=state_new, q_ck=q_ck_new, p_ck=p_ck_new,
            sub_prop=sub_prop_new, sub_log_w=sub_log_w_new, sub_turning=sub_turning_new,
            sub_div=sub_div_new,
            # a turned or diverged subtree is doomed: stop the chain now
            done=c["done"] | div_new | sub_turning_new | (finishing & (discard | turning_total)),
        )
        c = new if n_active == C else {k: _where(active, v, c[k]) for k, v in new.items()}
    if recording():
        set_attr(iterations=iterations, chain_leapfrogs=c["n_lf"].sum())
    accept_stat = c["sum_alpha"] / torch.clamp(c["n_lf"].to(dtype), min=1.0)
    return c["prop_q"], accept_stat, c["n_lf"], c["diverging"]


# ---------------------------------------------------------------------------
# Dual averaging
# ---------------------------------------------------------------------------

class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps0: torch.Tensor) -> _DAState:
    """Dual-averaging state per chain around step sizes eps0 (C,)."""
    zero = torch.zeros_like(eps0)
    return _DAState(torch.log(eps0), zero, zero, torch.log(10.0 * eps0), zero)


def _da_update(da: _DAState, accept_stat, target=0.8, gamma=0.05, t0=10.0,
               kappa=0.75) -> _DAState:
    count = da.count + 1.0
    h_bar = (1.0 - 1.0 / (count + t0)) * da.h_bar + (target - accept_stat) / (count + t0)
    log_eps = da.mu - torch.sqrt(count) / gamma * h_bar
    w = count ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, da.mu, count)


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------

class _ChainShard:
    """This rank's block of C chains sharded over the mesh dim `axis`."""

    def __init__(self, mesh, axis: str, n_chains: int):
        size = axis_size(mesh, axis)
        if n_chains % size != 0:
            raise ValueError(
                f"nuts_sample: n_chains={n_chains} must be a multiple of "
                f"mesh axis {axis!r} (size {size}) to shard the "
                f"chain axis — pad the chain count or shrink the mesh.")
        self.mesh, self.axis, self.n_chains = mesh, axis, n_chains
        self.slice = local_slice(mesh, n_chains, axis)
        self.total = DataShards(mesh, axis).total  # a sum over the dim's ranks

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks of a per-chain tensor in chain order."""
        return all_gather_cat(self.mesh, self.axis, x, dim)


class _ShardDraws:
    """A draw source for one rank's chains: every draw is made for all C
    chains from the wrapped source (seeded alike on every rank) and this
    rank keeps its block, so the draws equal the unsharded run's."""

    def __init__(self, draws, chains: _ChainShard):
        self.draws, self.chains = draws, chains

    def momentum(self, n_chains: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
        return self.draws.momentum(self.chains.n_chains, dim, dtype)[self.chains.slice]

    def iteration(self, active: torch.Tensor):
        every = active.new_ones((self.chains.n_chains,))
        return tuple(x[self.chains.slice] for x in self.draws.iteration(every))


def nuts_sample(logp_fn: Optional[Callable[[torch.Tensor], torch.Tensor]], q_init: torch.Tensor,
                generator: Optional[torch.Generator] = None, num_samples: int = 1000,
                num_warmup: int = 500, max_depth: int = 6, target_accept: float = 0.8,
                init_step_size: float = 0.1, adapt_mass: bool = True, thin: int = 1,
                logp_and_grad_fn: Optional[LogpAndGrad] = None, mesh=None,
                mesh_axis: str = "data", draws=None) -> Dict[str, np.ndarray]:
    """Vectorised NUTS from q_init (C, dim). `logp_fn` maps (C, dim) ->
    (C,) (the chains are independent; its gradient comes from autograd), or
    `logp_and_grad_fn` maps (C, dim) -> ((C,), (C, dim)) directly.

    Warmup: half of num_warmup transitions of dual averaging with a Welford
    estimate of the positions' variance over all chains; then, only when
    adapt_mass and num_warmup > 10, that variance becomes the diagonal
    inverse mass and dual averaging restarts around the current step sizes;
    then the other half. Sampling: num_samples draws at each chain's
    averaged step size, every `thin`-th transition kept. Draws come from
    `generator` (a torch.Generator on q_init's device; seed 0 if none) or a
    `draws` source.

    Returns numpy arrays: samples (chains, draws, dim); accept_stat,
    diverging, n_leapfrog (draws, chains) (n_leapfrog summed over the
    thinned transitions); step_size (chains,); inv_mass (dim,).

    mesh: shard the chains over the mesh dim `mesh_axis` (n_chains a
    multiple of its size, else ValueError). Every rank passes all of
    q_init and a generator seeded alike; it runs its block of chains (under
    engine 'fused' their windows on the lanes of one forward and one
    adjoint launch per leapfrog), drawing every random number for all chains
    and keeping its block's, and keeps iterating a transition's tree loop
    until no chain on any rank is active. The warmup's Welford moments over
    all chains take two all-reduces per transition (the sum of the
    deviations, then of their products); dual averaging is per chain. The
    results are gathered to every rank in chain order, equal to the
    unsharded run's draw for draw."""
    n_chains, dim = q_init.shape
    dtype, dev = q_init.dtype, q_init.device
    chains = _ChainShard(mesh, mesh_axis, n_chains) if mesh is not None else None
    if draws is None:
        draws = TorchDraws(generator if generator is not None
                           else torch.Generator(dev).manual_seed(0))
    if chains is not None:
        draws = _ShardDraws(draws, chains)
        q_init = q_init[chains.slice]
    if logp_and_grad_fn is None:
        logp_and_grad_fn = autograd_logp_and_grad(logp_fn)

    def total(x):
        return x if chains is None else chains.total(x)

    def gather(x, dim=0):
        return x if chains is None else chains.gather(x, dim)

    def step(q, eps, inv_mass):
        return _nuts_step(logp_and_grad_fn, q, draws, eps, inv_mass, max_depth, chains)

    def warmup(q, da, inv_mass, n, label):
        mean = torch.zeros((dim,), dtype=dtype, device=dev)
        m2 = torch.zeros_like(mean)
        cnt = 0.0
        for i in range(n):
            q, astat, _, _ = step(q, torch.exp(da.log_eps), inv_mass)
            da = _da_update(da, astat, target_accept)
            cnt += n_chains  # Welford over all chains' positions
            # the chain sums accumulate in f64, where a shard's partial sums
            # add up exactly: sharded and unsharded runs round alike
            delta = q - mean
            mean = mean + (total(delta.sum(0, dtype=torch.float64)) / cnt).to(dtype)
            m2 = m2 + total((delta * (q - mean)).sum(0, dtype=torch.float64)).to(dtype)
            logger.debug("%s %d/%d", label, i + 1, n)
        return q, da, m2, cnt

    inv_mass = torch.ones((dim,), dtype=dtype, device=dev)
    da = _da_init(torch.full((q_init.shape[0],), init_step_size, dtype=dtype, device=dev))
    half = num_warmup // 2
    with torch.no_grad():
        q, da, m2, cnt = warmup(q_init.detach(), da, inv_mass, max(half, 1), "warmup(I)")
        if adapt_mass and num_warmup > 10:
            inv_mass = torch.clamp(m2 / max(cnt - 1.0, 1.0), min=1e-6)
            # restart dual averaging around the current step sizes
            zero = torch.zeros_like(da.log_eps)
            da = _DAState(da.log_eps, zero, zero, da.log_eps + np.log(10.0), zero)
        q, da, _, _ = warmup(q, da, inv_mass, max(num_warmup - half, 1), "warmup(II)")
        eps_final = torch.exp(da.log_eps_bar)

        samples, astats, divs, n_lfs = [], [], [], []
        for i in range(num_samples):
            n_lf = 0
            for _ in range(thin):
                q, astat, lf, div = step(q, eps_final, inv_mass)
                n_lf = n_lf + lf
            samples.append(q)
            astats.append(astat)
            divs.append(div)
            n_lfs.append(n_lf)
            logger.debug("sampling %d/%d", i + 1, num_samples)

    def per_draw(xs):  # (draws, chains)
        return gather(torch.stack(xs), 1).cpu().numpy()

    return {
        "samples": gather(torch.stack(samples, 1)).cpu().numpy(),  # (chains, draws, dim)
        "accept_stat": per_draw(astats),
        "diverging": per_draw(divs),
        "n_leapfrog": per_draw(n_lfs),
        "step_size": gather(eps_final).cpu().numpy(),
        "inv_mass": inv_mass.cpu().numpy(),
    }


# ---------------------------------------------------------------------------
# Model-facing entry point
# ---------------------------------------------------------------------------

#: Gaussian priors on the sampled ODE parameters, (mean, std)
ODE_PARAM_PRIORS = {
    "a_GI": (0.0104, 0.002),
    "k_I": (0.025, 0.005),
    "rho": (0.003, 0.001),
    "E_max": (0.1, 0.02),
    "V_max": (9.0, 2.0),
    "K_m": (7.0, 1.5),
    "k_L": (0.02, 0.005),
}


class FlatLayout:
    """The flat vector q of named leaves in sorted name order (the order of
    JAX's `ravel_pytree`: 'nn_b4' < 'nn_w4' < 'ode_E_max' < ... < 'ode_rho'),
    each leaf row-major."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        self.names = sorted(leaves)
        self.shapes = [tuple(leaves[n].shape) for n in self.names]
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.dim = int(self.offsets[-1])

    def index(self, name: str) -> np.ndarray:
        """The columns of q holding leaf `name`, in the leaf's shape."""
        i = self.names.index(name)
        return np.arange(self.offsets[i], self.offsets[i + 1]).reshape(self.shapes[i])

    def ravel(self, leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([leaves[n].reshape(-1) for n in self.names])

    def unravel(self, Q: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(..., dim) -> {name: (..., *shape)}."""
        lead = tuple(Q.shape[:-1])
        return {n: Q[..., a:b].reshape(lead + s) for n, s, a, b in
                zip(self.names, self.shapes, self.offsets[:-1], self.offsets[1:])}


def _observation_terms(obs, mask, preds, noise_sigma):
    """Per-chain -0.5 sum(se) - 0.5 n_per_state sum(log 2 pi sigma^2) of
    predictions (C, B, T, n)."""
    n_factor = obs.shape[-1]
    with span("hode.sync.copy"):  # a host value to the card waits for its queue
        sigma_v = torch.as_tensor(noise_sigma, dtype=preds.dtype, device=preds.device)
    sigma_v = sigma_v.expand((n_factor,))
    se = ((obs - preds) / sigma_v) ** 2
    if mask is not None:
        se = se * mask[..., None]
        n_per_state = torch.sum(mask)
    else:
        n_per_state = float(np.prod(obs.shape[:-1]))
    return (-0.5 * se.sum(dim=(-3, -2, -1))
            - 0.5 * n_per_state * torch.sum(torch.log(2 * np.pi * sigma_v ** 2)))


def _prior_terms(flat: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Log prior of the chains' ODE parameters (C,) and, where sampled, the
    N(0, 1) prior of their NN leaves."""
    lp = 0.0
    for name, (mu, sd) in ODE_PARAM_PRIORS.items():
        v = flat[f"ode_{name}"]
        lp = lp + (-0.5 * ((v - mu) / sd) ** 2 - 0.5 * np.log(2 * np.pi * sd ** 2))
    for k, v in flat.items():
        if k.startswith("nn_"):
            n = int(np.prod(v.shape[1:]))
            lp = lp - 0.5 * (v ** 2).reshape(v.shape[0], -1).sum(-1) - 0.5 * n * np.log(2 * np.pi)
    return lp


def _make_generic_logp(params, batch, config, controls, layout: FlatLayout, noise_sigma):
    """Batched log-posterior (C, dim) -> (C,) through `batched_forward` with
    the chains on the member axis (the plain solvers, also for a
    `use_pallas` config)."""
    obs, mask = batch["observations"], batch.get("mask")

    def logp(Q):
        flat = layout.unravel(Q)
        preds = forward_samples(flat, params, batch["initial_state"], batch["time_points"],
                                controls, config)
        return _prior_terms(flat) + _observation_terms(obs, mask, preds, noise_sigma)

    return logp


def _make_fused_chain_logp(params, batch, config, controls, sample_names, layout: FlatLayout,
                           noise_sigma):
    """Chain-batched log-posterior through the fused RK4 kernels: chain c,
    window b on lane c*B + b of one launch, each chain's sampled ODE
    parameters as its lanes' context rows applied absolutely. Autograd
    carries the adjoint kernel's per-lane `dctx` back to Q: summed over each
    chain's lanes (the backward of `repeat_interleave`), scattered into the
    sampled columns, plus the prior's gradient."""
    from hybrid_ode_torch.ops.fused_rk4 import PARAM_ORDER, fused_rk4_hybrid

    if config.solver != "rk4":
        raise ValueError(f"engine='fused' requires solver='rk4', got {config.solver!r}")
    if config.activation != "relu":
        raise ValueError("engine='fused' supports activation='relu' only")
    if not (config.use_nn and config.use_mech):
        raise ValueError("engine='fused' requires use_nn=True and use_mech=True")
    if "norm" in params:
        raise ValueError("engine='fused' does not support the 'norm' physical-core mode")
    signals = dict(controls.signals) if controls is not None else {}
    if "context" in signals:
        raise ValueError(
            "engine='fused' does not support context-conditioned models: the kernel's "
            "context rows carry the per-chain sampled parameters (use engine='xla' for "
            "conditioned posteriors)")
    names = [n[4:] for n in sample_names]
    cpi = tuple(PARAM_ORDER.index(n) for n in names)
    q_idx = torch.as_tensor(np.array([int(layout.index(n)) for n in sample_names]),
                            device=batch["initial_state"].device)
    obs, mask = batch["observations"], batch.get("mask")
    y0, ts = batch["initial_state"], batch["time_points"]
    if ts.ndim == 1:
        ts = ts[None, :].expand(y0.shape[0], ts.shape[0])
    B, T = ts.shape
    meal = signals.pop("meal", None)
    tvns = signals.pop("tVNS", None)
    if signals:
        raise ValueError(f"engine='fused' supports meal/tVNS controls only, got {sorted(signals)}")
    zeros = torch.zeros((B, T), dtype=torch.float32, device=y0.device)
    meal = zeros if meal is None else meal
    tvns = zeros if tvns is None else tvns

    def logp_batched(Q):  # (C, dim) -> (C,)
        C = Q.shape[0]
        V = Q[:, q_idx]  # (C, 7): the sampled values in sample_names' order
        flat = {n: V[:, i] for i, n in enumerate(sample_names)}
        preds = fused_rk4_hybrid(
            y0.repeat(C, 1), ts.repeat(C, 1), meal.repeat(C, 1), tvns.repeat(C, 1),
            params["ode"], params["nn"], substeps=config.substeps, n_layers=config.nn_layers,
            context=V.repeat_interleave(B, 0), context_param_idx=cpi, ctx_param_mode="abs")
        preds = preds.reshape((C,) + tuple(obs.shape))
        return _prior_terms(flat) + _observation_terms(obs, mask, preds, noise_sigma)

    return logp_batched


def _dense_whitening(logp_single, q0_flat: torch.Tensor, ode_idx: np.ndarray):
    """(A, c): chol of the inverse negative Hessian of the log-posterior in
    the ODE block at the checkpoint (PD by an eigenvalue floor), and the
    block's values. The 7 x 7 Hessian is reverse over reverse (the plain
    solvers' interval checkpoints do not compose with torch.func); the rest
    is numpy f64."""
    idx = torch.as_tensor(ode_idx, device=q0_flat.device)
    with torch.enable_grad():
        v = q0_flat[idx].detach().clone().requires_grad_(True)
        q = q0_flat.detach().index_put((idx,), v)
        (g,) = torch.autograd.grad(logp_single(q), v, create_graph=True)
        rows = [torch.autograd.grad(g[i], v, retain_graph=True)[0] for i in range(len(ode_idx))]
    H = torch.stack(rows).detach().cpu().numpy().astype(np.float64)
    H = -0.5 * (H + H.T)  # negative log-posterior curvature, symmetrised
    w, V = np.linalg.eigh(H)
    w_floor = max(float(np.abs(w).max()), 1e-12) * 1e-8
    w = np.clip(w, w_floor, None)  # PD even at saddles
    cov = (V * (1.0 / w)) @ V.T
    A = np.linalg.cholesky(cov)
    logger.info("dense_mass: ODE-block Hessian eig range [%.3e, %.3e] (condition %.1e) — "
                "whitening via chol(H^-1)", w.min(), w.max(), w.max() / w.min())
    return A, H


def autograd_logp_and_grad(logp: Callable[[torch.Tensor], torch.Tensor]) -> LogpAndGrad:
    """(C, dim) -> (logp (C,), its gradient (C, dim)) by autograd of a
    batched log-posterior (the chains are independent: the gradient of the
    sum is each chain's own)."""
    def logp_and_grad(Q):
        with torch.enable_grad():
            Q = Q.detach().requires_grad_(True)
            vals = logp(Q)
            (grads,) = torch.autograd.grad(vals.sum(), Q)
        return vals.detach(), grads

    return logp_and_grad


class Posterior(NamedTuple):
    """The sampled parameters' layout and start, and the log-posterior of
    one batch: `logp` the generic one (C, dim) -> (C,), `logp_and_grad`
    the engine's."""

    layout: FlatLayout
    q0: torch.Tensor  # (dim,): the params' own values
    sample_names: list
    logp: Callable[[torch.Tensor], torch.Tensor]
    logp_and_grad: LogpAndGrad
    controls: Any


def posterior(params: Dict[str, Dict[str, torch.Tensor]], batch: Dict, config,
              engine: str = "xla", noise_sigma=1.0, include_nn=False) -> Posterior:
    """The posterior `run_nuts` samples (see there), on the device of
    `params`; `batch` of arrays or tensors."""
    dev = next(iter(params["ode"].values())).device
    batch = batch_to_tensors(batch, dev)
    sample_names = [f"ode_{n}" for n in ODE_PARAM_PRIORS]
    base = {n: params["ode"][n[4:]].detach() for n in sample_names}
    if include_nn == "last":
        last = config.nn_layers
        base[f"nn_w{last}"] = params["nn"][f"w{last}"].detach()
        base[f"nn_b{last}"] = params["nn"][f"b{last}"].detach()
    elif include_nn:
        base.update({f"nn_{k}": v.detach() for k, v in params["nn"].items()})
    layout = FlatLayout(base)
    with torch.no_grad():
        # a context-conditioned model's encoder is a point estimate outside
        # the sampled posterior: encode once with the params
        controls = with_context(params, batch, controls_from_batch(batch), config)
    logp = _make_generic_logp(params, batch, config, controls, layout, noise_sigma)
    if engine == "fused":
        if include_nn:
            raise ValueError("engine='fused' samples ODE parameters only (the kernel shares "
                             "NN weights across lanes); use engine='xla' for include_nn=True")
        logp_and_grad = autograd_logp_and_grad(_make_fused_chain_logp(
            params, batch, config, controls, sample_names, layout, noise_sigma))
    elif engine == "xla":
        logp_and_grad = autograd_logp_and_grad(logp)
    else:
        raise ValueError(f"unknown NUTS engine {engine!r} (use 'xla' or 'fused')")
    return Posterior(layout, layout.ravel(base), sample_names, logp, logp_and_grad, controls)


def run_nuts(params: Dict[str, Dict[str, torch.Tensor]], batch: Dict, config,
             generator: Optional[torch.Generator] = None, num_samples: int = 1000,
             num_warmup: int = 500, n_chains: int = 8, max_depth: int = 6,
             target_accept: float = 0.8, noise_sigma=1.0, include_nn=False,
             jitter: float = 0.01, engine: str = "xla", mesh=None, mesh_axis: str = "data",
             dense_mass: bool = False) -> Dict[str, np.ndarray]:
    """Posterior over the hybrid model's parameters given one batch (arrays
    or tensors), on the device of `params`.

    Samples the 7 ODE parameters of ODE_PARAM_PRIORS under those priors;
    include_nn "last" adds the MLP's output layer, True every NN leaf, each
    under N(0, 1). noise_sigma: scalar or per-state (6,). jitter: the chains
    start at the params' values plus jitter * N(0, 1) from `generator` (a
    torch.Generator; on the params' device, seed 0, if none), which then
    drives the sampler.

    engine: 'xla' (generic: `batched_forward` with the chains on the member
    axis, the plain solvers) or 'fused' (one fused RK4 forward and hand
    adjoint launch per leapfrog of all chains; requires solver='rk4', relu,
    the NN and the mechanistic part, no 'norm' group, no context, meal /
    tVNS controls only, include_nn False).

    dense_mass (engine 'xla'): whiten the ODE block by the Laplace
    covariance at the params, C = H^-1 (H the 7 x 7 Hessian of the negative
    log-posterior, through the plain solvers): sampling runs in z with
    q_ode = q0_ode + chol(C) z, so diagonal-mass NUTS on z is dense-mass
    NUTS on q; the samples are mapped back.

    Returns {name: (chains * draws, ...)} numpy arrays, plus '_accept_stat',
    '_diverging' (draws, chains) and '_step_size' (chains,).

    mesh: shard the chains over the mesh dim `mesh_axis` (`nuts_sample`);
    every rank passes the same arguments and gets the whole result."""
    post = posterior(params, batch, config, engine, noise_sigma, include_nn)
    layout, q0_flat = post.layout, post.q0
    dev, dim = q0_flat.device, layout.dim
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    dense_info = None
    logp_and_grad = post.logp_and_grad
    q0_sample = q0_flat
    if dense_mass:
        if engine == "fused":
            raise ValueError(
                "dense_mass requires engine='xla': the fused engine evaluates the kernel "
                "on q directly, so the z-space reparameterization never reaches it")
        ode_idx = np.array([int(layout.index(n)) for n in post.sample_names])
        A_blk, _ = _dense_whitening(lambda q: post.logp(q[None])[0], q0_flat, ode_idx)
        idx = torch.as_tensor(ode_idx, device=dev)
        A_t = torch.as_tensor(A_blk, dtype=q0_flat.dtype, device=dev)
        c_blk = q0_flat[idx]

        def sample_logp(Z):
            Q = Z.clone()
            Q[:, idx] = c_blk + Z[:, idx] @ A_t.T
            return post.logp(Q)

        logp_and_grad = autograd_logp_and_grad(sample_logp)
        q0_sample = q0_flat.clone()
        q0_sample[idx] = 0.0  # z-space origin: the ODE block at the params' values
        dense_info = (ode_idx, c_blk.cpu().numpy(), A_blk)

    noise = torch.randn((n_chains, dim), generator=generator, dtype=q0_flat.dtype,
                        device=generator.device).to(dev)
    q_init = q0_sample[None, :] + jitter * noise
    logger.info("NUTS: %d chains x (%d warmup + %d samples), dim=%d, max_depth=%d, engine=%s, "
                "dense_mass=%s", n_chains, num_warmup, num_samples, dim, max_depth, engine,
                dense_mass)
    out = nuts_sample(None, q_init, generator, num_samples=num_samples,
                      num_warmup=num_warmup, max_depth=max_depth, target_accept=target_accept,
                      logp_and_grad_fn=logp_and_grad, mesh=mesh, mesh_axis=mesh_axis)
    if dense_info is not None:
        idx_d, c_d, A_d = dense_info
        s = np.array(out["samples"])  # (chains, draws, dim) in z-space
        s[..., idx_d] = c_d + s[..., idx_d] @ A_d.T
        out["samples"] = s

    flat_samples = out["samples"].reshape(-1, dim)
    per_param: Dict[str, np.ndarray] = {}
    for name in layout.names:
        idxs = layout.index(name)
        per_param[name] = flat_samples[:, idxs.reshape(-1)].reshape(
            (-1,) + idxs.shape).squeeze()
    per_param["_accept_stat"] = out["accept_stat"]
    per_param["_diverging"] = out["diverging"]
    per_param["_step_size"] = out["step_size"]
    return per_param


# ---------------------------------------------------------------------------
# Diagnostics + persistence (numpy, as the JAX package)
# ---------------------------------------------------------------------------

def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2); 1-D input becomes one chain."""
    s = np.asarray(x, np.float64)
    if s.ndim == 1:
        s = s[None, :]
    half = s.shape[1] // 2
    return np.concatenate([s[:, :half], s[:, half: 2 * half]], axis=0)


def _rank_normalize(chains: np.ndarray) -> np.ndarray:
    """Pooled fractional ranks -> normal scores z = Phi^-1((r - 3/8)/(S + 1/4))
    (Vehtari, Gelman, Simpson, Carpenter & Bürkner 2021, eq. 14)."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    r = rankdata(chains, method="average").reshape(chains.shape)
    return ndtri((r - 0.375) / (chains.size + 0.25))


def _basic_rhat(chains: np.ndarray) -> float:
    """Classic potential-scale reduction on pre-split chains (M, N)."""
    m, n = chains.shape
    if m < 2 or n < 2:
        return float("nan")
    chain_means = chains.mean(axis=1)
    B = n * chain_means.var(ddof=1)
    W = chains.var(axis=1, ddof=1).mean()
    if W == 0:
        return 1.0
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W))


def _autocov(x: np.ndarray) -> np.ndarray:
    """Biased (1/N) autocovariance of a demeaned 1-D series via FFT."""
    n = len(x)
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    return np.fft.irfft(f * np.conj(f), m)[:n].real / n


def _ess(chains: np.ndarray) -> float:
    """Multi-chain ESS (Stan's algorithm) on split chains (M, N): combined
    autocorrelation, Geyer's initial monotone positive sequence."""
    M, N = chains.shape
    if N < 4 or not np.all(np.isfinite(chains)):
        return float("nan")
    acovs = np.stack([_autocov(c - c.mean()) for c in chains])  # (M, N)
    chain_var = acovs[:, 0] * N / (N - 1.0)
    W = chain_var.mean()
    var_plus = W * (N - 1.0) / N
    if M > 1:
        var_plus += chains.mean(axis=1).var(ddof=1)
    if var_plus == 0:
        return float("nan")
    rho = 1.0 - (W - acovs.mean(axis=0)) / var_plus  # (N,)
    pair_sums = []
    t = 0
    while t + 1 < N:
        p = rho[t] + rho[t + 1]
        if p <= 0:
            break
        pair_sums.append(p)
        t += 2
    for i in range(1, len(pair_sums)):
        pair_sums[i] = min(pair_sums[i], pair_sums[i - 1])
    tau = max(-1.0 + 2.0 * float(np.sum(pair_sums)), 1.0 / np.log10(max(M * N, 10)))
    ess = M * N / tau
    return float(min(ess, M * N * np.log10(max(M * N, 10))))


def ess_bulk(samples: np.ndarray) -> float:
    """Bulk-ESS: ESS of the rank-normalised split chains."""
    return _ess(_rank_normalize(_split_chains(samples)))


def ess_tail(samples: np.ndarray) -> float:
    """Tail-ESS: the smaller ESS of the 5% / 95% exceedance indicators."""
    s = _split_chains(samples)
    vals = []
    for q in (0.05, 0.95):
        ind = (s <= np.quantile(s, q)).astype(np.float64)
        vals.append(_ess(ind))
    return float(np.nanmin(vals))


def rhat(samples: np.ndarray) -> float:
    """Rank-normalised split R-hat: the larger of the bulk R-hat and the tail
    R-hat (of the folded draws |x - median|)."""
    s = _split_chains(samples)
    bulk = _basic_rhat(_rank_normalize(s))
    folded = _basic_rhat(_rank_normalize(np.abs(s - np.median(s))))
    return float(np.nanmax([bulk, folded]))


def compute_ess(x: np.ndarray) -> float:
    """Bulk-ESS of (chains, draws); a flat vector is one chain."""
    return ess_bulk(np.asarray(x, np.float64))


def split_rhat(samples: np.ndarray) -> float:
    """Split R-hat over (chains, draws), rank-normalised."""
    return rhat(samples)


def posterior_summary(samples: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    """Mean / std / median / 2.5% / 97.5% per parameter ('_' keys skipped)."""
    out = {}
    for name, vals in samples.items():
        if name.startswith("_"):
            continue
        v = np.asarray(vals)
        out[name] = {
            "mean": np.mean(v, axis=0),
            "std": np.std(v, axis=0),
            "median": np.median(v, axis=0),
            "q025": np.percentile(v, 2.5, axis=0),
            "q975": np.percentile(v, 97.5, axis=0),
        }
    return out


def _netcdf_path(path: str) -> str:
    return path if str(path).endswith(".nc") else str(path) + ".nc"


def _write_netcdf_h5(path: str, posterior: Dict[str, np.ndarray],
                     sample_stats: Dict[str, np.ndarray], attrs: Dict) -> None:
    """NetCDF4 (an HDF5 profile) through h5py: the posterior / sample_stats
    groups of an arviz InferenceData, each variable with named dimension
    scales, readable by any NetCDF4 or HDF5 reader."""
    import json

    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_(b"version=2,hybrid_ode_torch=h5py")
        f.attrs["created_by"] = "hybrid_ode_torch.save_mcmc_results"
        if attrs:
            f.attrs["metadata_json"] = json.dumps(attrs, default=str)
        for gname, data_vars in (("posterior", posterior), ("sample_stats", sample_stats)):
            if not data_vars:
                continue
            g = f.create_group(gname)
            # chain / draw scales are shared per (label, size), so variables
            # with other draw counts get their own coordinate
            dims_cache: Dict[Tuple[str, int], Any] = {}

            def dim_scale(g, label, size):
                if (label, size) in dims_cache:
                    return dims_cache[(label, size)]
                dsname = label if not any(
                    lab == label for (lab, s) in dims_cache if s != size) else f"{label}_{size}"
                ds = g.create_dataset(dsname, data=np.arange(size, dtype=np.int64))
                ds.make_scale(label)
                dims_cache[(label, size)] = ds
                return ds

            for name, values in data_vars.items():
                v = np.asarray(values)
                dset = g.create_dataset(name, data=v)
                labels = ["chain", "draw"] + [f"{name}_dim_{i}" for i in range(2, v.ndim)]
                for ax in range(v.ndim):
                    dset.dims[ax].attach_scale(dim_scale(g, labels[ax], v.shape[ax]))


def _read_netcdf_h5(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    import json

    import h5py

    samples: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        meta = json.loads(f.attrs["metadata_json"]) if "metadata_json" in f.attrs else {}
        for gname, prefix in (("posterior", ""), ("sample_stats", "_")):
            if gname not in f:
                continue
            for name, ds in f[gname].items():
                if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                    continue  # the coordinate variables
                v = np.asarray(ds)
                # stored with a leading chain axis of 1 (arviz layout)
                samples[prefix + name] = v[0] if v.ndim >= 1 and v.shape[0] == 1 else v
    return samples, meta


def save_mcmc_results(samples: Dict[str, np.ndarray], path: str,
                      metadata: Optional[Dict] = None) -> None:
    """Save samples as NetCDF4 through h5py (<path>.nc), sampler statistics
    ('_' keys) in the sample_stats group; where h5py is not importable,
    <path>.npz plus <path>.meta.json. The writer that ran is logged."""
    try:
        posterior, stats = {}, {}
        for name, values in samples.items():
            v = np.asarray(values)
            tgt = stats if name.startswith("_") else posterior
            tgt[name.lstrip("_")] = v.reshape((1,) + v.shape)
        _write_netcdf_h5(_netcdf_path(path), posterior, stats, metadata or {})
        logger.info("MCMC results saved to %s (h5py NetCDF)", _netcdf_path(path))
        return
    except ImportError:
        pass
    import json

    np.savez(path if str(path).endswith(".npz") else str(path) + ".npz", **samples)
    if metadata:
        with open(str(path) + ".meta.json", "w") as f:
            json.dump(metadata, f, default=str)
    logger.info("MCMC results saved to %s (npz; h5py not importable)", path)


def load_mcmc_results(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load results written by `save_mcmc_results` of either package (the
    NetCDF4 file through h5py, else the npz)."""
    import json
    from pathlib import Path

    nc = Path(_netcdf_path(path))
    if nc.exists():
        return _read_netcdf_h5(str(nc))
    p = path if str(path).endswith(".npz") else str(path) + ".npz"
    data = np.load(p)
    samples = {k: data[k] for k in data.files}
    meta_path = Path(str(path) + ".meta.json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return samples, meta
