"""Port parity for the adaptive explicit solvers, in float64 on the CPU.

The same numpy-seeded inputs go through the JAX package (`jax.enable_x64`)
and the port (torch float64): `odeint` in 'scan' and 'while' for dopri5,
rk45, bosh3 and dop853 on the mechanistic field with per-sample clocks
(trajectories to 1e-10 relative, per-sample StepStats equal), gradients
through scan mode against `jax.grad` (1e-8), dense output for dopri5 and
dop853, the backsolve adjoint with and without the seminorm, and the
batch-synchronised solver (interval and global span, kink stops, budget
overflow, rk45 taking the interval span). Also the exact and scipy oracles
of the JAX suite, and the implicit solvers still raising.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from hybrid_ode_tpu.dynamics.ode_core import make_ode_params as j_make_ode_params
from hybrid_ode_tpu.dynamics.ode_core import mechanistic_field as j_mech
from hybrid_ode_tpu.dynamics.ode_core import steady_state as j_steady_state
from hybrid_ode_tpu.solvers import odeint as j_odeint
from hybrid_ode_tpu.solvers import sync as jsync
from hybrid_ode_tpu.solvers.adjoint import odeint_backsolve as j_backsolve
from hybrid_ode_tpu.solvers.tableaus import TABLEAUS as J_TABLEAUS
from hybrid_ode_torch.dynamics.ode_core import make_ode_params as t_make_ode_params
from hybrid_ode_torch.dynamics.ode_core import mechanistic_field as t_mech
from hybrid_ode_torch.solvers import explicit as texp
from hybrid_ode_torch.solvers import sync as tsync
from hybrid_ode_torch.solvers.adjoint import odeint_backsolve as t_backsolve
from hybrid_ode_torch.solvers.api import odeint as t_odeint
from hybrid_ode_torch.solvers.tableaus import TABLEAUS as T_TABLEAUS

torch.set_num_threads(2)

EXPLICIT = ("dopri5", "rk45", "bosh3", "dop853")
TRAJ_RTOL = 1e-10
GRAD_RTOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _j_field(t, y, p):
    return j_mech(t, y, p, None)


def _t_field(t, y, p):
    return t_mech(t, y, p, None)


def _mech_case(B=5, T=5, seed=0):
    """Perturbed steady states and per-sample clocks (scaled, shifted grids).
    The offset keeps every state off 0, where a tight rtol leaves only atol
    and the error norm measures roundoff."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        yss = np.asarray(j_steady_state(j_make_ode_params(dtype=jnp.float64)))
    y0 = yss[None] * rng.uniform(0.05, 10.0, (B, 6)) + 0.3
    ts = (np.linspace(0.0, 8.0, T)[None] * rng.uniform(0.8, 1.25, (B, 1))
          + rng.uniform(0.0, 2.0, (B, 1)))
    return y0, ts


def _t_params():
    return t_make_ode_params(dtype=torch.float64, device="cpu")


def _j_solve(y0, ts, **kw):
    p = j_make_ode_params(dtype=jnp.float64)
    return jax.vmap(lambda y, t: j_odeint(_j_field, y, t, p, **kw))(
        jnp.asarray(y0), jnp.asarray(ts))


@pytest.mark.parametrize("mode", ["scan", "while"])
@pytest.mark.parametrize("solver", EXPLICIT)
def test_trajectories_and_step_stats_match_jax(solver, mode, x64):
    """Per-sample step control: trajectories to 1e-10 and every sample's
    accepted / rejected counts and success flag equal. States far from the
    steady state and a small budget make samples reject steps (dopri5,
    dop853) or exhaust the budget (bosh3)."""
    y0, ts = _mech_case()
    kw = dict(solver=solver, rtol=1e-8, atol=1e-10, mode=mode, max_steps_per_interval=10,
              return_stats=True)
    jys, jst = _j_solve(y0, ts, **kw)
    tys, tst = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(), **kw)
    assert tys.shape == jys.shape == (5, 5, 6)
    assert _rel(jys, tys) < TRAJ_RTOL
    np.testing.assert_array_equal(tst.n_accepted.numpy(), np.asarray(jst.n_accepted))
    np.testing.assert_array_equal(tst.n_rejected.numpy(), np.asarray(jst.n_rejected))
    np.testing.assert_array_equal(tst.success.numpy(), np.asarray(jst.success))
    # the controller's reject or budget path was exercised
    assert int(np.asarray(jst.n_rejected).sum()) > 0 or not np.asarray(jst.success).all()


def test_budget_exhaustion_matches_jax(x64):
    """A budget too small for the span: success is False per sample, as in
    JAX. An exhausted interval ends wherever its last step stopped, so the
    state there moves with the step sizes themselves: at a tolerance where the
    error estimate still carries roundoff (the two packages sum E.K in other
    orders), the port and JAX would stop at times that differ by that
    roundoff. rtol 1e-6 keeps the estimate well above it."""
    y0, ts = _mech_case(T=3, seed=1)
    kw = dict(solver="dopri5", rtol=1e-6, atol=1e-8, max_steps_per_interval=2,
              return_stats=True)
    for mode in ("scan", "while"):
        jys, jst = _j_solve(y0, ts, mode=mode, **kw)
        tys, tst = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(),
                            mode=mode, **kw)
        assert not np.asarray(jst.success).any()
        np.testing.assert_array_equal(tst.success.numpy(), np.asarray(jst.success))
        np.testing.assert_array_equal(tst.n_accepted.numpy(), np.asarray(jst.n_accepted))
        assert _rel(jys, tys) < TRAJ_RTOL


@pytest.mark.parametrize("solver", EXPLICIT)
def test_exponential_decay_exact(solver):
    """dy/dt = -y has y(t) = e^{-t} (the JAX suite's check, tolerance 1e-6)."""
    ts = torch.linspace(0.0, 3.0, 13, dtype=torch.float64)
    for mode in ("scan", "while"):
        ys = t_odeint(lambda t, y, a: a * y, torch.ones(4, dtype=torch.float64), ts,
                      torch.tensor(-1.0, dtype=torch.float64), solver=solver, rtol=1e-8,
                      atol=1e-10, mode=mode, max_steps_per_interval=128)
        np.testing.assert_allclose(ys.numpy(), np.exp(-ts.numpy())[:, None] * np.ones(4),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("solver,method", [("dopri5", "RK45"), ("rk45", "RK45"),
                                           ("bosh3", "RK23"), ("dop853", "DOP853")])
def test_mechanistic_vs_scipy_oracle(solver, method):
    """The real 6-state field against solve_ivp (the JAX suite's 2e-5)."""
    p = _t_params()
    y0 = np.array([8.0, 100.0, 90.0, 20.0, 0.0, 1.2])
    ts = np.linspace(0.0, 5.0, 61)
    sol = solve_ivp(lambda t, y: _t_field(torch.tensor(t), torch.tensor(y), p).numpy(),
                    (ts[0], ts[-1]), y0, t_eval=ts, method=method, rtol=1e-9, atol=1e-11)
    assert sol.success
    ys = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), p, solver=solver, rtol=1e-8,
                  atol=1e-10, max_steps_per_interval=64, mode="while")
    np.testing.assert_allclose(ys.numpy(), sol.y.T, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("solver", EXPLICIT)
def test_scan_gradients_match_jax_grad(solver, x64):
    """Reverse mode through the checkpointed scan: d loss / d (y0, every
    parameter) against jax.grad to 1e-8 relative."""
    y0, ts = _mech_case(B=3, T=4, seed=2)
    kw = dict(solver=solver, rtol=1e-7, atol=1e-9, mode="scan", max_steps_per_interval=8)
    w = np.random.default_rng(3).normal(size=(3, 4, 6))

    def j_loss(p, y):
        ys = jax.vmap(lambda yy, tt: j_odeint(_j_field, yy, tt, p, **kw))(y, jnp.asarray(ts))
        return jnp.sum(jnp.asarray(w) * ys ** 2 / (1.0 + jnp.abs(ys)))

    jg_p, jg_y = jax.grad(j_loss, argnums=(0, 1))(j_make_ode_params(dtype=jnp.float64),
                                                 jnp.asarray(y0))
    p = {k: v.clone().requires_grad_(True) for k, v in _t_params().items()}
    y = torch.tensor(y0, requires_grad=True)
    ys = t_odeint(_t_field, y, torch.tensor(ts), p, **kw)
    torch.sum(torch.tensor(w) * ys ** 2 / (1.0 + ys.abs())).backward()
    assert _rel(jg_y, y.grad) < GRAD_RTOL
    for k in jg_p:
        assert _rel(jg_p[k], p[k].grad) < GRAD_RTOL, k


def test_norm_weights_seminorm_matches_jax(x64):
    """A passive fast integral drives step control under the full norm only
    (the JAX suite's seminorm case), with equal counts in both packages.
    Hundreds of steps at rtol 1e-8, each sized from an error estimate whose
    last digits depend on the order E.K is summed in: trajectories are held
    to the solve's rtol, not to 1e-10."""
    def jf(t, y, a):
        return jnp.stack([-y[0], jnp.cos(80.0 * t)])

    def tf(t, y, a):
        return torch.stack([-y[..., 0], torch.cos(80.0 * t)], -1)

    ts = np.linspace(0.0, 2.0, 3)
    kw = dict(solver="dopri5", rtol=1e-8, atol=1e-10, max_steps_per_interval=512,
              mode="while", return_stats=True)
    counts = {}
    for w in (None, [1.0, 0.0]):
        jys, jst = j_odeint(jf, jnp.array([1.0, 0.0]), jnp.asarray(ts), None,
                            norm_weights=None if w is None else jnp.asarray(w), **kw)
        tys, tst = t_odeint(tf, torch.tensor([1.0, 0.0], dtype=torch.float64),
                            torch.tensor(ts), None,
                            norm_weights=None if w is None else torch.tensor(w), **kw)
        assert _rel(jys, tys) < 1e-8
        assert int(tst.n_accepted) == int(jst.n_accepted)
        counts[w is None] = int(tst.n_accepted)
    assert counts[False] < counts[True] // 2


@pytest.mark.parametrize("solver", ["dopri5", "dop853"])
def test_dense_output_matches_jax(solver, x64):
    """mode='dense': free-running steps + continuous extension, per sample,
    against the vmapped JAX solver (trajectories 1e-10, stats equal), and
    gradients against jax.grad (1e-8). rk45 takes dopri5's dense output in
    both packages: the port's equal each other bitwise."""
    y0, ts = _mech_case(B=3, T=13, seed=4)
    kw = dict(solver=solver, mode="dense", rtol=1e-7, atol=1e-9, max_steps_per_interval=8,
              return_stats=True)
    jys, jst = _j_solve(y0, ts, **kw)
    tys, tst = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(), **kw)
    assert _rel(jys, tys) < TRAJ_RTOL
    np.testing.assert_array_equal(tst.n_accepted.numpy(), np.asarray(jst.n_accepted))
    np.testing.assert_array_equal(tst.n_rejected.numpy(), np.asarray(jst.n_rejected))
    np.testing.assert_array_equal(tst.success.numpy(), np.asarray(jst.success))
    assert np.asarray(jst.success).all() and (np.asarray(jst.n_accepted) < 20).all()
    if solver == "dopri5":
        rk45 = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(),
                        **dict(kw, solver="rk45"))[0]
        assert torch.equal(rk45, tys)

    kw.pop("return_stats")
    jg = jax.grad(lambda p: jnp.sum(jax.vmap(lambda y, t: j_odeint(_j_field, y, t, p, **kw))(
        jnp.asarray(y0), jnp.asarray(ts))[:, -1] ** 2))(j_make_ode_params(dtype=jnp.float64))
    p = {k: v.clone().requires_grad_(True) for k, v in _t_params().items()}
    torch.sum(t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), p, **kw)[:, -1] ** 2
              ).backward()
    for k in jg:
        assert _rel(jg[k], p[k].grad) < GRAD_RTOL, k


def _backsolve_case():
    jp = j_make_ode_params(dtype=jnp.float64)
    return jp, np.linspace(0.0, 1.5, 4), np.asarray(j_steady_state(jp), np.float64) + 0.2


def test_backsolve_close_to_discrete(x64):
    """odeint(adjoint='backsolve') against the port's discrete adjoint, with
    the JAX suite's test_backsolve_adjoint_close_to_discrete limits (rtol
    1e-3, atol 1e-8 per parameter)."""
    _, ts, y0 = _backsolve_case()
    kw = dict(solver="dopri5", rtol=1e-9, atol=1e-11, max_steps_per_interval=64)
    grads = {}
    for adjoint in ("backsolve", "discrete"):
        p = {k: v.clone().requires_grad_(True) for k, v in _t_params().items()}
        ys = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), p, adjoint=adjoint, **kw)
        torch.sum(ys ** 2).backward()
        grads[adjoint] = {k: float(v.grad) for k, v in p.items()}
    for k in grads["discrete"]:
        np.testing.assert_allclose(grads["discrete"][k], grads["backsolve"][k], rtol=1e-3,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("seminorm", [True, False])
def test_backsolve_seminorm_matches_jax(seminorm, x64):
    """odeint_backsolve with and without the seminorm against the JAX one
    (1e-8), for y0 and every parameter (the seminorm is the default that
    odeint(adjoint='backsolve') takes)."""
    jp, ts, y0 = _backsolve_case()
    kw = dict(solver="dopri5", rtol=1e-9, atol=1e-11, max_steps_per_interval=64,
              seminorm=seminorm)
    jg_p, jg_y = jax.grad(lambda p, y: jnp.sum(j_backsolve(
        _j_field, y, jnp.asarray(ts), p, **kw) ** 2), argnums=(0, 1))(jp, jnp.asarray(y0))
    p = {k: v.clone().requires_grad_(True) for k, v in _t_params().items()}
    y = torch.tensor(y0, requires_grad=True)
    torch.sum(t_backsolve(_t_field, y, torch.tensor(ts), p, **kw) ** 2).backward()
    assert _rel(jg_y, y.grad) < GRAD_RTOL
    for k in jg_p:
        assert _rel(float(jg_p[k]), float(p[k].grad)) < GRAD_RTOL, k


def test_backsolve_batched_per_sample_args_matches_vmapped_jax(x64):
    """A batch with shared params and per-sample args: each sample integrates
    its own parameter cotangents (the vmapped JAX custom VJP), shared ones
    summed over the batch, per-sample ones kept per sample."""
    B, n, T = 4, 3, 5
    rng = np.random.default_rng(5)
    y0 = rng.uniform(0.5, 2.0, (B, n))
    lam = rng.uniform(0.3, 2.0, (B, n))
    ts = np.linspace(0.0, 2.0, T)[None] * rng.uniform(0.8, 1.2, (B, 1))
    k0 = 0.7
    kw = dict(solver="dopri5", rtol=1e-8, atol=1e-10, max_steps_per_interval=32)

    def jf(t, y, a):
        k, lam_i = a
        return -lam_i * y + k * jnp.sin(3.0 * t)

    def tf(t, y, a):
        k, lam_i = a
        return -lam_i * y + k * torch.sin(3.0 * t)[..., None]

    def j_loss(k, lam_, y):
        ys = jax.vmap(lambda yy, tt, ll: j_backsolve(jf, yy, tt, (k, ll), **kw))(
            y, jnp.asarray(ts), lam_)
        return jnp.sum(ys ** 2)

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(k0), jnp.asarray(lam),
                                            jnp.asarray(y0))
    k = torch.tensor(k0, dtype=torch.float64, requires_grad=True)
    lam_t = torch.tensor(lam, requires_grad=True)
    y = torch.tensor(y0, requires_grad=True)
    ys = t_backsolve(tf, y, torch.tensor(ts), (k, lam_t), args_axes=(None, 0), **kw)
    torch.sum(ys ** 2).backward()
    for ref, got in zip(jg, (k.grad, lam_t.grad, y.grad)):
        assert _rel(ref, got) < GRAD_RTOL


def _forced_decay_j(t, y, a):
    return -a * y + jnp.sin(3.0 * t)


def _forced_decay_t(t, y, a):
    return -a * y + torch.sin(3.0 * t)[..., None]


def _sync_case(B=6, n=3, T=11, seed=0):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.3, 2.0, (B, n))
    y0 = rng.uniform(0.5, 2.0, (B, n))
    ts = np.broadcast_to(np.linspace(0.0, 4.0, T), (B, T)) * rng.uniform(0.8, 1.2, (B, 1))
    return y0, ts, lam


@pytest.mark.parametrize("solver,span", [("dopri5", "interval"), ("dopri5", "global"),
                                         ("bosh3", "interval"), ("dop853", "interval")])
def test_sync_matches_jax(solver, span, x64):
    """odeint_erk_sync against the JAX one: trajectories 1e-10, the shared
    accepted / rejected counts and success equal; for dopri5 (both spans)
    gradients for y0 and the batched args against jax.grad (1e-8): pass 2
    is the same ERK step for every tableau."""
    y0, ts, lam = _sync_case()
    rtol, atol = (1e-5, 1e-7) if solver == "bosh3" else (1e-7, 1e-9)
    kw = dict(rtol=rtol, atol=atol, max_steps_per_interval=64, span=span,
              total_step_budget=64 * 10)
    jys, jst = jsync.odeint_erk_sync(_forced_decay_j, jnp.asarray(y0), jnp.asarray(ts),
                                     jnp.asarray(lam), J_TABLEAUS[solver], args_axes=0,
                                     return_stats=True, **kw)
    tys, tst = tsync.odeint_erk_sync(_forced_decay_t, torch.tensor(y0), torch.tensor(ts),
                                     torch.tensor(lam), T_TABLEAUS[solver],
                                     return_stats=True, **kw)
    assert bool(jst.success) and bool(tst.success)
    assert _rel(jys, tys) < TRAJ_RTOL
    for field in ("n_accepted", "n_rejected"):
        assert int(getattr(tst, field)) == int(getattr(jst, field))
    if solver != "dopri5":
        return
    jg = jax.grad(lambda y, a: jnp.sum(jsync.odeint_erk_sync(
        _forced_decay_j, y, jnp.asarray(ts), a, J_TABLEAUS[solver], args_axes=0,
        **kw)[:, -1] ** 2), argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(lam))
    y = torch.tensor(y0, requires_grad=True)
    a = torch.tensor(lam, requires_grad=True)
    torch.sum(tsync.odeint_erk_sync(_forced_decay_t, y, torch.tensor(ts), a,
                                    T_TABLEAUS[solver], **kw)[:, -1] ** 2).backward()
    assert _rel(jg[0], y.grad) < GRAD_RTOL and _rel(jg[1], a.grad) < GRAD_RTOL


def test_sync_span_auto_global_for_dopri5_interval_for_rk45(x64):
    """span='auto' free-runs the dopri5 tableau object only: rk45 is a tableau
    of its own and takes the interval span, as in JAX (fewer shared steps
    than T-1 for dopri5, at least T-1 for rk45; counts equal JAX's)."""
    T = 41
    y0, ts, lam = _sync_case(T=T, seed=1)
    counts = {}
    for solver in ("dopri5", "rk45"):
        _, jst = jsync.odeint_erk_sync(_forced_decay_j, jnp.asarray(y0), jnp.asarray(ts),
                                       jnp.asarray(lam), J_TABLEAUS[solver], rtol=1e-6,
                                       atol=1e-8, args_axes=0, return_stats=True)
        tys, tst = tsync.odeint_erk_sync(_forced_decay_t, torch.tensor(y0), torch.tensor(ts),
                                         torch.tensor(lam), T_TABLEAUS[solver], rtol=1e-6,
                                         atol=1e-8, return_stats=True)
        assert int(tst.n_accepted) == int(jst.n_accepted)
        counts[solver] = int(tst.n_accepted)
    assert counts["dopri5"] < T - 1 <= counts["rk45"]


def test_sync_kink_stops_match_jax(x64):
    """A gridded impulse becomes forced step boundaries: the stops and the
    global-span solve with stop_signals equal JAX's."""
    B, n, T = 4, 2, 41
    rng = np.random.default_rng(3)
    lam = rng.uniform(0.3, 1.0, (B, n))
    y0 = rng.uniform(0.5, 2.0, (B, n))
    ts = np.broadcast_to(np.linspace(0.0, 4.0, T), (B, T)).copy()
    u = np.zeros((B, T))
    u[:, 13] = 5.0

    def jf(t, y, a):
        lam_i, u_i, ts_i = a
        return -lam_i * y + jnp.interp(t, ts_i, u_i)

    from hybrid_ode_torch.dynamics.controls import interp

    def tf(t, y, a):
        lam_i, u_i, ts_i = a
        return -lam_i * y + interp(t, ts_i, u_i)[..., None]

    j_stops = jsync._control_kink_stops([jnp.asarray(u)], T, jnp.float64)
    t_stops = tsync._control_kink_stops([torch.tensor(u)], T, torch.float64)
    np.testing.assert_array_equal(t_stops.numpy(), np.asarray(j_stops))
    kw = dict(rtol=1e-7, atol=1e-9, return_stats=True, span="global")
    jys, jst = jsync.odeint_erk_sync(jf, jnp.asarray(y0), jnp.asarray(ts),
                                     (jnp.asarray(lam), jnp.asarray(u), jnp.asarray(ts)),
                                     J_TABLEAUS["dopri5"], args_axes=(0, 0, 0),
                                     stop_signals=[jnp.asarray(u)], **kw)
    targs = (torch.tensor(lam), torch.tensor(u), torch.tensor(ts))
    tys, tst = tsync.odeint_erk_sync(tf, torch.tensor(y0), torch.tensor(ts), targs,
                                     T_TABLEAUS["dopri5"], stop_signals=[targs[1]], **kw)
    assert bool(tst.success) and int(tst.n_accepted) == int(jst.n_accepted) < T - 1
    assert _rel(jys, tys) < TRAJ_RTOL


@pytest.mark.parametrize("span", ["interval", "global"])
def test_sync_budget_overflow_drops_the_tail_as_jax(span, x64):
    """total_step_budget too small: the tail is dropped, success is False,
    and the truncated trajectories equal JAX's."""
    y0, ts, lam = _sync_case(B=3, n=2, T=9, seed=2)
    kw = dict(rtol=1e-6, atol=1e-8, total_step_budget=3, span=span, return_stats=True)
    jys, jst = jsync.odeint_erk_sync(_forced_decay_j, jnp.asarray(y0), jnp.asarray(ts),
                                     jnp.asarray(lam), J_TABLEAUS["dopri5"], args_axes=0, **kw)
    tys, tst = tsync.odeint_erk_sync(_forced_decay_t, torch.tensor(y0), torch.tensor(ts),
                                     torch.tensor(lam), T_TABLEAUS["dopri5"], **kw)
    assert not bool(jst.success) and not bool(tst.success)
    assert int(tst.n_accepted) == int(jst.n_accepted)
    assert _rel(jys, tys) < TRAJ_RTOL


def test_while_mode_counts_one_host_sync_per_trial_step():
    """Scan mode never synchronises; while mode once per trial step."""
    ts = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    y0 = torch.ones(3, 2, dtype=torch.float64)
    before = texp.host_syncs
    t_odeint(lambda t, y, a: -y, y0, ts, solver="dopri5", mode="scan")
    assert texp.host_syncs == before
    _, st = t_odeint(lambda t, y, a: -y, y0, ts, solver="dopri5", mode="while",
                     return_stats=True)
    trials = int((st.n_accepted + st.n_rejected).max())
    # per interval: one test per trial step plus the one that ends the loop
    assert trials <= texp.host_syncs - before <= trials + 4


def test_implicit_solvers_still_raise_naming_item_14():
    ts = torch.linspace(0.0, 1.0, 3)
    for solver in ("radau", "bdf", "bdf2"):
        with pytest.raises(NotImplementedError, match="Queue A 14"):
            t_odeint(lambda t, y, a: -y, torch.ones(1), ts, solver=solver)
    for solver in ("radau", "bdf"):
        with pytest.raises(NotImplementedError, match="Queue A 14"):
            t_odeint(lambda t, y, a: -y, torch.ones(1), ts, solver=solver, mode="dense")
    with pytest.raises(ValueError, match="norm_weights"):
        t_odeint(lambda t, y, a: -y, torch.ones(1), ts, mode="dense", norm_weights=[1.0])
    with pytest.raises(ValueError, match="return_stats"):
        t_odeint(lambda t, y, a: -y, torch.ones(1), ts, adjoint="backsolve",
                 return_stats=True)
    with pytest.raises(ValueError, match="unknown mode"):
        t_odeint(lambda t, y, a: -y, torch.ones(1), ts, mode="nope")
