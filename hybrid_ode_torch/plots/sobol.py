"""Sobol / Saltelli global sensitivity analysis, the sweep in batched solves.

Port of `hybrid_ode_tpu/plots/sobol.py`. Saltelli's base matrices come from
a scrambled Sobol QMC sequence (`scipy.stats.qmc`, as in the JAX package, so
both packages sample the same rows); `sobol_analyze` is a numpy copy. The JAX
package vmaps a per-row `simulate`; here `simulate` takes a dict of (B,)
override tensors and the rows go through it in chunks of `batch_size`, one
batched solve per chunk (`torch.func.vmap` does not compose with the
solvers' interval checkpoints).

Estimators (Saltelli 2010 / Jansen 1999):
    S1_i = mean(f_B * (f_ABi - f_A)) / V
    ST_i = 0.5 * mean((f_A - f_ABi)^2) / V
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from hybrid_ode_torch.utils.device import resolve_device

#: Parameter names and bounds of Figure 2's sweep
DEFAULT_PROBLEM: Dict[str, Tuple[float, float]] = {
    "a_GI": (0.008, 0.012),
    "k_I": (0.02, 0.03),
    "rho": (0.002, 0.004),
    "E_max": (0.08, 0.12),
    "V_max": (7.0, 11.0),
    "K_m": (5.5, 8.5),
    "k_L": (0.015, 0.025),
}


def saltelli_sample(
    bounds: Sequence[Tuple[float, float]], n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate (A, B, AB) Saltelli matrices: A,B (n,d); AB (d,n,d) where
    AB[i] is A with column i replaced from B. Uses a scrambled Sobol
    sequence for the base matrices (n rounded up to a power of two)."""
    from scipy.stats import qmc

    d = len(bounds)
    m = int(np.ceil(np.log2(max(n, 2))))
    sampler = qmc.Sobol(2 * d, scramble=True, seed=seed)
    base = sampler.random_base2(m)[:n]  # (n, 2d) in [0,1)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    A = lo + base[:, :d] * (hi - lo)
    B = lo + base[:, d:] * (hi - lo)
    AB = np.repeat(A[None, :, :], d, axis=0)
    for i in range(d):
        AB[i, :, i] = B[:, i]
    return A, B, AB


def sobol_analyze(
    f_A: np.ndarray,
    f_B: np.ndarray,
    f_AB: np.ndarray,
    n_boot: int = 0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """First-order and total Sobol indices from model evaluations.

    f_A, f_B: (n,); f_AB: (d, n). Returns {'S1': (d,), 'ST': (d,)}; with
    n_boot > 0 also 'S1_conf'/'ST_conf' — 95% CI half-widths from n_boot
    bootstrap resamples of the sample axis."""
    d, n = f_AB.shape

    def _indices(a, b, ab):
        f_all = np.concatenate([a, b])
        mu = float(f_all.mean())
        V = float(np.var(f_all))
        # Degenerate output: if the model output barely varies across the
        # sweep, the 1/V-scaled estimators amplify pure Monte-Carlo noise
        # into garbage (indices far outside [0,1]) — report zeros instead.
        if V < 1e-10 * max(mu**2, 1e-12):
            return np.zeros(d), np.zeros(d)
        a, b, ab = a - mu, b - mu, ab - mu
        S1 = np.array([np.mean(b * (ab[i] - a)) / V for i in range(d)])
        ST = np.array([0.5 * np.mean((a - ab[i]) ** 2) / V for i in range(d)])
        return S1, ST

    S1, ST = _indices(f_A, f_B, f_AB)
    out = {"S1": S1, "ST": ST}
    if n_boot > 0:
        rng = np.random.default_rng(seed)
        bs1 = np.empty((n_boot, d))
        bst = np.empty((n_boot, d))
        for r in range(n_boot):
            idx = rng.integers(0, n, size=n)
            bs1[r], bst[r] = _indices(f_A[idx], f_B[idx], f_AB[:, idx])
        out["S1_conf"] = 1.96 * bs1.std(axis=0, ddof=1)
        out["ST_conf"] = 1.96 * bst.std(axis=0, ddof=1)
    return out


def sobol_sensitivity(
    simulate: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    problem: Dict[str, Tuple[float, float]] = None,
    n: int = 1024,
    seed: int = 0,
    batch_size: int = 4096,
    n_boot: int = 0,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """End-to-end GSA over all n (d + 2) Saltelli rows.

    simulate: {parameter: (B,) f32 tensor on `device`} -> (B, n_outputs)
    model outputs, one batched evaluation per chunk of `batch_size` rows.

    Returns {'S1': (d, n_outputs), 'ST': (d, n_outputs), 'names': [...]};
    with n_boot > 0 also 'S1_conf' / 'ST_conf' bootstrap 95% half-widths."""
    dev = resolve_device(device)
    problem = problem or DEFAULT_PROBLEM
    names: List[str] = list(problem)
    bounds = [problem[k] for k in names]
    d = len(names)

    A, B, AB = saltelli_sample(bounds, n, seed)
    rows = np.concatenate([A, B, AB.reshape(d * A.shape[0], d)], axis=0)  # (n(d+2), d)

    outs = []
    with torch.no_grad():
        for start in range(0, rows.shape[0], batch_size):
            chunk = torch.as_tensor(rows[start: start + batch_size], dtype=torch.float32,
                                    device=dev)
            y = simulate({name: chunk[:, i] for i, name in enumerate(names)})
            outs.append(y.cpu().numpy())
    Y = np.concatenate(outs)  # (n(d+2), n_outputs)

    n_actual = A.shape[0]
    f_A = Y[:n_actual]
    f_B = Y[n_actual: 2 * n_actual]
    f_AB = Y[2 * n_actual:].reshape(d, n_actual, -1)

    n_out = Y.shape[-1]
    S1 = np.zeros((d, n_out))
    ST = np.zeros((d, n_out))
    S1c = np.zeros((d, n_out))
    STc = np.zeros((d, n_out))
    for j in range(n_out):
        res = sobol_analyze(f_A[:, j], f_B[:, j], f_AB[:, :, j], n_boot=n_boot, seed=seed + j)
        S1[:, j] = res["S1"]
        ST[:, j] = res["ST"]
        if n_boot > 0:
            S1c[:, j] = res["S1_conf"]
            STc[:, j] = res["ST_conf"]
    out = {"S1": S1, "ST": ST, "names": names}
    if n_boot > 0:
        out["S1_conf"] = S1c
        out["ST_conf"] = STc
    return out
