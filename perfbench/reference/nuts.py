"""One NUTS transition of one chain in plain NumPy (float64), replayed on the
log densities and gradients that the program evaluated.

The transition is the multinomial NUTS of Betancourt (2017) with the
doubling scheme of Hoffman and Gelman (2014), as the sampler states it:
  * momentum p0 = z / sqrt(inv_mass), z standard normal; energy
    H = -log p + sum(inv_mass p^2) / 2; a leaf's log weight dH = H0 - H,
    -inf where dH is not finite or below -1000 (divergent);
  * doubling d = 0, 1, ... while d < max_depth: a direction from the draw of
    the doubling's first leaf, 2^d leapfrog leaves from that end of the tree
    (p += e g / 2; q += e inv_mass p; p += e g' / 2 with e = +-eps);
  * within a doubling, progressive uniform sampling by weight: leaf k is
    the doubling's proposal when log u_take(k) < dH_k - logsumexp(dH of the
    doubling's leaves so far);
  * a U-turn check, dq . (inv_mass p) < 0 at either end, across every
    aligned block of 2^j leaves (j >= 1) as it completes; a divergent leaf
    or a turned block ends the transition and drops the doubling;
  * a doubling that completes replaces the proposal when log u_merge <
    logsumexp(its dH) - logsumexp(the tree's dH so far), grows the tree at
    that end, and ends the transition if the whole tree has turned.
Each leaf takes one draw (direction bit, u_take, u_merge) in the order the
leaves are built.

The replay takes each leaf's log density and gradient from the program's
evaluation at the program's position for that leaf (the benchmark checks
those values against `posterior.py` on their own), and computes the leaf's
position from the previous leaf's position and its own momentum: the gap
between that position and the program's is the leapfrog's error.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np


def _logaddexp(a: float, b: float) -> float:
    return float(np.logaddexp(a, b))


def _turning(q_minus, p_minus, q_plus, p_plus, inv_mass) -> bool:
    dq = q_plus - q_minus
    return bool(np.dot(dq, inv_mass * p_plus) < 0.0 or np.dot(dq, inv_mass * p_minus) < 0.0)


class Leaf:
    __slots__ = ("q", "p", "g", "logp")

    def __init__(self, q, p, g, logp):
        self.q, self.p, self.g, self.logp = q, p, g, logp


def transition(q0, logp0, g0, z, eps: float, inv_mass, max_depth: int,
               leaf: Callable[[int], Optional[Tuple]]):
    """Replay one transition. leaf(k) gives the program's k-th leaf (k >= 1)
    as (q, log p, grad, direction bit, u_take, u_merge), or None past the
    program's last. Returns (leaves taken, the proposal's leaf number, 0 for
    the start, the worst leapfrog gap); leaves taken is -1 where the
    transition needs a leaf that the program never evaluated.

    The leapfrog gap of a leaf is max over coordinates of |q_program -
    q_replay| in units of float32's spacing at the larger of |q_previous|,
    |q_replay| and the step's length: a float32 leapfrog that is right
    differs from the replay by its rounding, a few units; a wrong one by
    the size of the term it gets wrong."""
    inv_mass = np.asarray(inv_mass, np.float64)
    p0 = np.asarray(z, np.float64) / np.sqrt(inv_mass)
    start = Leaf(np.asarray(q0, np.float64), p0, np.asarray(g0, np.float64), float(logp0))
    H0 = -start.logp + 0.5 * float(np.sum(inv_mass * p0 ** 2))
    left = right = start
    log_w, proposal, n, gap = 0.0, 0, 0, 0.0
    for depth in range(max_depth):
        first = leaf(n + 1)
        if first is None:
            return -1, proposal, gap
        direction = 1.0 if first[3] else -1.0
        e = eps * direction
        cur = right if direction > 0 else left
        built = []
        sub_w, sub_prop, stop = -math.inf, None, False
        for i in range(2 ** depth):
            got = leaf(n + 1)
            if got is None:
                return -1, proposal, gap
            n += 1
            q_p, lp, g, _, u_take, u_merge = got
            q_p, g = np.asarray(q_p, np.float64), np.asarray(g, np.float64)
            p_half = cur.p + 0.5 * e * cur.g
            q_r = cur.q + e * inv_mass * p_half
            size = np.maximum(np.maximum(np.abs(cur.q), np.abs(q_r)), np.abs(q_r - cur.q))
            gap = max(gap, float(np.max(np.abs(q_p - q_r) / np.spacing(size.astype(np.float32)))))
            cur = Leaf(q_p, p_half + 0.5 * e * g, g, float(lp))
            dH = H0 - (-cur.logp + 0.5 * float(np.sum(inv_mass * cur.p ** 2)))
            diverged = not math.isfinite(dH) or dH < -1000.0
            w = -math.inf if diverged else dH
            new_w = _logaddexp(sub_w, w)
            if np.log(u_take) < w - new_w:
                sub_prop = n
            sub_w = new_w
            built.append(cur)
            j = 1
            while (i + 1) % (2 ** j) == 0:
                a = built[i + 1 - 2 ** j]
                lo, hi = (a, cur) if direction > 0 else (cur, a)
                if _turning(lo.q, lo.p, hi.q, hi.p, inv_mass):
                    stop = True
                j += 1
            if diverged or stop:
                stop = True
                break
        if stop:
            break
        if np.log(u_merge) < sub_w - log_w and sub_prop is not None:
            proposal = sub_prop
        log_w = _logaddexp(log_w, sub_w)
        if direction > 0:
            right = cur
        else:
            left = cur
        if _turning(left.q, left.p, right.q, right.p, inv_mass):
            break
    return n, proposal, gap
