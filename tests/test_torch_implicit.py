"""Port parity for the implicit stiff solvers (Radau IIA, variable-order BDF,
BDF2) and their dense output, on the CPU against the JAX package.

The same numpy-seeded inputs go through the JAX package and the port:
  * `odeint` in 'scan' and 'while' on the mechanistic field with per-sample
    clocks, f64: trajectories to 1e-10 relative, per-sample step counts and
    success flags equal; scan-mode gradients to 1e-7; the JAX suite's stiff
    (lambda = 50) and linear problems against the exact solutions and JAX;
    a step budget that runs out; dense radau and bdf;
  * a finished sample bitwise equal to itself solved alone.
The model-level cases are in tests/test_torch_implicit_model.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ode_tpu.dynamics.ode_core import make_ode_params as j_make_ode_params
from hybrid_ode_tpu.dynamics.ode_core import mechanistic_field as j_mech
from hybrid_ode_tpu.dynamics.ode_core import steady_state as j_steady_state
from hybrid_ode_tpu.solvers import odeint as j_odeint
from hybrid_ode_torch.dynamics.ode_core import make_ode_params as t_make_ode_params
from hybrid_ode_torch.dynamics.ode_core import mechanistic_field as t_mech
from hybrid_ode_torch.solvers.api import odeint as t_odeint

torch.set_num_threads(2)

IMPLICIT = ("radau", "bdf", "bdf2")
TRAJ_RTOL = 1e-10
GRAD_RTOL = 1e-7
# per solver: rtol (atol = rtol / 100) and a step budget every sample's
# intervals fit in (BDF2 is order 2: a looser rtol, as the JAX suite runs it)
SETTINGS = {"radau": (1e-7, 16), "bdf": (1e-7, 40), "bdf2": (1e-5, 64)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _j_field(t, y, p):
    return j_mech(t, y, p, None)


def _t_field(t, y, p):
    return t_mech(t, y, p, None)


def _j_stiff(t, y, args):
    return -50.0 * (y - jnp.cos(t))


def _t_stiff(t, y, args):
    return -50.0 * (y - torch.cos(t)[..., None])


def _stiff_exact(t, lam=50.0):
    return (lam ** 2 / (lam ** 2 + 1)) * (np.cos(t) + np.sin(t) / lam - np.exp(-lam * t))


def _mech_case(B=5, T=5, seed=0):
    """Perturbed steady states and per-sample clocks (scaled, shifted grids);
    the offset keeps every state off 0."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        yss = np.asarray(j_steady_state(j_make_ode_params(dtype=jnp.float64)))
    y0 = yss[None] * rng.uniform(0.05, 10.0, (B, 6)) + 0.3
    ts = (np.linspace(0.0, 8.0, T)[None] * rng.uniform(0.8, 1.25, (B, 1))
          + rng.uniform(0.0, 2.0, (B, 1)))
    return y0, ts


def _t_params():
    return t_make_ode_params(dtype=torch.float64, device="cpu")


def _j_solve(y0, ts, p=None, **kw):
    p = j_make_ode_params(dtype=jnp.float64) if p is None else p
    return jax.vmap(lambda y, t: j_odeint(_j_field, y, t, p, **kw))(
        jnp.asarray(y0), jnp.asarray(ts))


def _stats_equal(tst, jst):
    for field in ("n_accepted", "n_rejected", "success"):
        np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                      np.asarray(getattr(jst, field)), err_msg=field)


@pytest.mark.parametrize("mode", ["scan", "while"])
@pytest.mark.parametrize("solver", IMPLICIT)
def test_trajectories_and_step_stats_match_jax(solver, mode, x64):
    """Per-sample step control on the mechanistic field far from its steady
    state: trajectories to 1e-10, each sample's accepted / rejected counts
    and success flag equal, every sample within its budget."""
    rtol, steps = SETTINGS[solver]
    y0, ts = _mech_case()
    kw = dict(solver=solver, rtol=rtol, atol=rtol / 100, mode=mode,
              max_steps_per_interval=steps, return_stats=True)
    jys, jst = _j_solve(y0, ts, **kw)
    tys, tst = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(), **kw)
    assert tys.shape == jys.shape == (5, 5, 6)
    assert _rel(jys, tys) < TRAJ_RTOL
    _stats_equal(tst, jst)
    assert np.asarray(jst.success).all()


@pytest.mark.parametrize("solver", IMPLICIT)
def test_budget_exhaustion_matches_jax(solver, x64):
    """A budget of 12 trial steps runs out on some samples: step counts and
    success flags equal. A sample that stops short of its interval's end
    stops where its step sizes took it, and a step size is a power of an
    error estimate that is a difference of Newton iterates (relative
    rounding 1e-8 at rtol 1e-8), so there the trajectories are held to
    1e-7; within the budget they agree to 1e-10 (the test above)."""
    y0, ts = _mech_case()
    kw = dict(solver=solver, rtol=1e-8, atol=1e-10, mode="while", max_steps_per_interval=12,
              return_stats=True)
    jys, jst = _j_solve(y0, ts, **kw)
    tys, tst = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(), **kw)
    _stats_equal(tst, jst)
    assert not np.asarray(jst.success).all()
    assert _rel(jys, tys) < 1e-7


@pytest.mark.parametrize("solver", IMPLICIT)
def test_scan_gradients_match_jax_grad(solver, x64):
    """Reverse mode through scan mode (through the Jacobian, the LU and the
    fixed Newton iterations): every ODE parameter's gradient to 1e-7."""
    rtol, steps = SETTINGS[solver]
    y0, ts = _mech_case(B=3, T=3)
    kw = dict(solver=solver, rtol=rtol, atol=rtol / 100, mode="scan",
              max_steps_per_interval=steps)
    jg = jax.grad(lambda p: jnp.sum(_j_solve(y0, ts, p, **kw)[:, -1] ** 2))(
        j_make_ode_params(dtype=jnp.float64))
    p = {k: v.clone().requires_grad_(True) for k, v in _t_params().items()}
    torch.sum(t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), p, **kw)[:, -1] ** 2
              ).backward()
    for k in jg:
        assert _rel(jg[k], p[k].grad) < GRAD_RTOL, k


# the JAX suite's test_stiff_problem settings and limits
STIFF = {"radau": (1e-7, 1e-9, 256, 1e-5), "bdf": (1e-7, 1e-9, 256, 1e-5),
         "bdf2": (1e-4, 1e-6, 512, 2e-3)}


@pytest.mark.parametrize("solver", IMPLICIT)
def test_stiff_problem_matches_exact_and_jax(solver, x64):
    """y' = -50 (y - cos t), y(0) = 0 (the JAX suite's test_stiff_problem):
    the exact solution within that test's limits, JAX to 1e-10 with equal
    step counts."""
    rtol, atol, steps, tol = STIFF[solver]
    ts = np.linspace(0.0, 2.0, 9)
    kw = dict(solver=solver, rtol=rtol, atol=atol, mode="while", max_steps_per_interval=steps,
              return_stats=True)
    jys, jst = j_odeint(_j_stiff, jnp.zeros(1, jnp.float64), jnp.asarray(ts), None, **kw)
    tys, tst = t_odeint(_t_stiff, torch.zeros(1, dtype=torch.float64), torch.tensor(ts), None,
                        **kw)
    assert bool(tst.success)
    np.testing.assert_allclose(tys[:, 0].numpy(), _stiff_exact(ts), rtol=tol, atol=tol)
    assert _rel(jys, tys) < TRAJ_RTOL
    _stats_equal(tst, jst)


@pytest.mark.parametrize("solver", IMPLICIT)
def test_linear_problem_matches_exact_and_jax(solver, x64):
    """dy/dt = lam y with lam = -1 (the JAX suite's test_exponential_decay_exact,
    its tolerances and limits): e^{-t} and JAX to 1e-10."""
    rtol, atol = (1e-8, 1e-10) if solver != "bdf2" else (1e-6, 1e-8)
    tol = 1e-6 if solver != "bdf2" else 1e-4
    ts = np.linspace(0.0, 3.0, 13)
    kw = dict(solver=solver, rtol=rtol, atol=atol, mode="while", max_steps_per_interval=128)
    jys = j_odeint(lambda t, y, a: a["lam"] * y, jnp.ones(4, jnp.float64), jnp.asarray(ts),
                   {"lam": jnp.asarray(-1.0, jnp.float64)}, **kw)
    tys = t_odeint(lambda t, y, a: a["lam"] * y, torch.ones(4, dtype=torch.float64),
                   torch.tensor(ts), {"lam": torch.tensor(-1.0, dtype=torch.float64)}, **kw)
    np.testing.assert_allclose(tys.numpy(), np.exp(-ts)[:, None] * np.ones(4), rtol=tol,
                               atol=tol)
    assert _rel(jys, tys) < TRAJ_RTOL


@pytest.mark.parametrize("solver", ["radau", "bdf"])
def test_dense_output_matches_jax(solver, x64):
    """mode='dense' (the JAX suite's test_dense_output_radau / _bdf): the
    stiff problem against the exact solution (their limits) and JAX; the
    mechanistic field without boluses, batched with per-sample clocks,
    against JAX (1e-10, stats equal) and a tight dopri5 run (5e-5), fewer
    than 40 accepted steps; gradients against jax.grad (1e-7), the a_GI
    gradient finite and nonzero."""
    ts = np.linspace(0.0, 2.0, 9)
    kw = dict(solver=solver, mode="dense", rtol=1e-7, atol=1e-9, return_stats=True,
              max_steps_per_interval=64 if solver == "radau" else 128)
    jys, jst = j_odeint(_j_stiff, jnp.zeros(1, jnp.float64), jnp.asarray(ts), None, **kw)
    tys, tst = t_odeint(_t_stiff, torch.zeros(1, dtype=torch.float64), torch.tensor(ts), None,
                        **kw)
    tol = 1e-5 if solver == "radau" else 2e-5
    np.testing.assert_allclose(tys[:, 0].numpy(), _stiff_exact(ts), rtol=tol, atol=tol)
    assert _rel(jys, tys) < TRAJ_RTOL
    _stats_equal(tst, jst)

    p = _t_params()
    yss = np.asarray(j_steady_state(j_make_ode_params(dtype=jnp.float64)))
    rng = np.random.default_rng(3)
    y0 = yss[None] + 0.3 + rng.uniform(0.0, 0.5, (3, 6))
    tsh = np.linspace(0.0, 5.0, 31)[None] + rng.uniform(0.0, 1.0, (3, 1))
    kw = dict(solver=solver, mode="dense", rtol=1e-7, atol=1e-9, return_stats=True)
    jys, jst = _j_solve(y0, tsh, **kw)
    tys, tst = t_odeint(_t_field, torch.tensor(y0), torch.tensor(tsh), p, **kw)
    assert _rel(jys, tys) < TRAJ_RTOL
    _stats_equal(tst, jst)
    assert tst.success.all() and (tst.n_accepted < 40).all()
    tight = t_odeint(_t_field, torch.tensor(y0), torch.tensor(tsh), p, solver="dopri5",
                     mode="while", rtol=1e-9, atol=1e-11, max_steps_per_interval=64)
    np.testing.assert_allclose(tys.numpy(), tight.numpy(), rtol=5e-5, atol=5e-5)

    # gradients over the first 6 hours (T=7: 48 trial steps, each checkpointed)
    kw = dict(solver=solver, mode="dense", rtol=1e-5, atol=1e-7, max_steps_per_interval=32)
    y0g, tsg = y0[:2], tsh[:2, :7]
    jg = jax.grad(lambda q: jnp.sum(_j_solve(y0g, tsg, q, **kw)[:, -1] ** 2))(
        j_make_ode_params(dtype=jnp.float64))
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    torch.sum(t_odeint(_t_field, torch.tensor(y0g), torch.tensor(tsg), q, **kw)[:, -1] ** 2
              ).backward()
    for k in jg:
        assert _rel(jg[k], q[k].grad) < GRAD_RTOL, k
    assert torch.isfinite(q["a_GI"].grad) and q["a_GI"].grad != 0


@pytest.mark.parametrize("solver", IMPLICIT)
def test_finished_sample_is_bitwise_itself_alone(solver):
    """A batch where samples finish at different trial steps: every sample
    of the batched solve equals its solve alone, bit for bit (masks hold a
    finished sample; no reduction crosses samples)."""
    rtol, steps = SETTINGS[solver]
    y0, ts = _mech_case(B=4, seed=2)
    kw = dict(solver=solver, rtol=rtol, atol=rtol / 100, mode="while",
              max_steps_per_interval=steps, return_stats=True)
    ys, st = t_odeint(_t_field, torch.tensor(y0), torch.tensor(ts), _t_params(), **kw)
    assert len(set(st.n_accepted.tolist())) > 1
    for i in range(4):
        one, st1 = t_odeint(_t_field, torch.tensor(y0[i]), torch.tensor(ts[i]), _t_params(), **kw)
        assert torch.equal(ys[i], one), i
        assert int(st1.n_accepted) == int(st.n_accepted[i])
