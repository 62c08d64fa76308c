"""Butcher tableaus of the adaptive explicit Runge-Kutta solvers.

Port of `hybrid_ode_tpu/solvers/tableaus.py`:

    'dopri5' -> Dormand-Prince 5(4)
    'rk45'   -> the same pair, kept as an object of its own: batch-synchronised
                solves give the global span with dense output to 'dopri5' only
                (`sync._is_dopri5` tests identity), so 'rk45' takes the
                interval span there
    'bosh3'  -> Bogacki-Shampine 3(2)
    'dop853' -> Hairer's 8(5,3) method

The DOP853 constants come from `scipy.integrate._ivp.dop853_coefficients`
(Hairer, Norsett & Wanner, "Solving ODEs I"): rows 0-11 integrate, row 12
is the stage f(t+h, y1), rows 13-15 are the dense-output stages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
from scipy.integrate._ivp import dop853_coefficients as _d853


class ERKTableau(NamedTuple):
    """Explicit RK tableau with embedded error estimate.

    err_weights: E such that local error = h * (K^T E) with K the stage
    derivatives; for FSAL-extended tableaus E has length n_stages+1 and the
    extra row of K is f(t+h, y1)."""

    name: str
    a: np.ndarray           # (s, s) strictly lower triangular
    b: np.ndarray           # (s,)
    c: np.ndarray           # (s,)
    err_weights: np.ndarray  # (s,) or (s+1,) (E5 role)
    err_weights_low: Optional[np.ndarray]  # DOP853's E3 companion, else None
    order: int              # order of the propagated solution
    error_order: int        # order of the error estimator (controller exponent)
    fsal: bool              # last err stage is f(t+h, y1), reusable as next f0


# DOP853 dense output: the three extra stages (rows 13-15 of scipy's extended
# tableau, each may use the 13 rows before it) and the 4 interpolation rows.
DOP853_A_EXTRA = _d853.A[_d853.N_STAGES + 1:].copy()   # (3, 16)
DOP853_C_EXTRA = _d853.C[_d853.N_STAGES + 1:].copy()   # (3,)
DOP853_D = _d853.D.copy()                               # (4, 16)


def _dopri5(name: str) -> ERKTableau:
    c = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
    a = np.zeros((7, 7))
    a[1, 0] = 1 / 5
    a[2, :2] = [3 / 40, 9 / 40]
    a[3, :3] = [44 / 45, -56 / 15, 32 / 9]
    a[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
    a[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
    a[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
    b = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
    b_hat = np.array(
        [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
    )
    # stage 7 (row a[6]) equals b, so k[6] = f(t+h, y1): FSAL
    return ERKTableau(name=name, a=a, b=b, c=c, err_weights=b - b_hat, err_weights_low=None,
                      order=5, error_order=4, fsal=True)


def _bosh3() -> ERKTableau:
    c = np.array([0.0, 1 / 2, 3 / 4, 1.0])
    a = np.zeros((4, 4))
    a[1, 0] = 1 / 2
    a[2, :2] = [0.0, 3 / 4]
    a[3, :3] = [2 / 9, 1 / 3, 4 / 9]
    b = np.array([2 / 9, 1 / 3, 4 / 9, 0.0])
    b_hat = np.array([7 / 24, 1 / 4, 1 / 3, 1 / 8])
    return ERKTableau(name="bosh3", a=a, b=b, c=c, err_weights=b - b_hat, err_weights_low=None,
                      order=3, error_order=2, fsal=True)


def _dop853() -> ERKTableau:
    # 12 integration stages; the error estimate uses an extra f(t+h, y1) stage
    # combined from the 5th- and 3rd-order embedded estimators.
    s = _d853.N_STAGES
    return ERKTableau(name="dop853", a=_d853.A[:s, :s].copy(), b=_d853.B.copy(),
                      c=_d853.C[:s].copy(), err_weights=_d853.E5.copy(),
                      err_weights_low=_d853.E3.copy(), order=8, error_order=7, fsal=True)


TABLEAUS = {
    "dopri5": _dopri5("dopri5"),
    "rk45": _dopri5("rk45"),
    "bosh3": _bosh3(),
    "dop853": _dop853(),
}
