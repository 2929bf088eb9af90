"""Learning-rate schedules from the paper's theory and experiments.

Remark 4.2 / 4.4 and Appendix B.1:
  * strongly convex, option 1:  η_k = 1 / (2 L K sqrt(k+1))
  * strongly convex, option 2:  η_k = 1 / (2 L K^q),   q >= 2
  * non-convex:                 K = T^{q1}, η = 1/(L T^{q2}),
                                q1 in (0,1), q2 >= q1, 1 + q1 > q2
  * experiments (B.1):          η_k = 1 / (K sqrt(k+1))   (L folded to 1)

All schedules return a function k -> eta_k for k in {0..K-1}.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def paper_sqrt_schedule(K: int, L: float = 1.0, *, half: bool = True) -> Schedule:
    """η_k = 1/(2LK sqrt(k+1)); with half=False, the B.1 variant 1/(K sqrt(k+1))."""
    denom = (2.0 if half else 1.0) * L * K

    def eta(k: int) -> float:
        return 1.0 / (denom * math.sqrt(k + 1))

    return eta


def paper_power_schedule(K: int, q: float = 2.0, L: float = 1.0) -> Schedule:
    """η_k = 1/(2 L K^q), constant in k. q >= 2 gives the O(1/K^{q-1}) rate."""
    value = 1.0 / (2.0 * L * (K ** q))
    return lambda k: value


def nonconvex_schedule(T: int, q1: float = 0.5, q2: float = 0.5, L: float = 1.0) -> Schedule:
    """η = 1/(L T^{q2}) with K = T^{q1}; validity: q1 in (0,1), q2>=q1, 1+q1>q2."""
    assert 0 < q1 < 1 and q2 >= q1 and 1 + q1 > q2, "invalid (q1, q2) per Remark 4.4"
    value = 1.0 / (L * (T ** q2))
    return lambda k: value


def constant_schedule(eta: float) -> Schedule:
    return lambda k: eta


def schedule_satisfies_theorem(K: int, sched: Schedule, L: float, *, strongly_convex: bool) -> bool:
    """Check the step-size premise of Thm 4.1 (η_k <= 1/(2LK)) / Thm 4.3 (η_k <= 1/(LK))."""
    bound = 1.0 / ((2.0 if strongly_convex else 1.0) * L * K)
    return all(sched(k) <= bound + 1e-12 for k in range(K))


def nonconvex_K(T: int, q1: float = 0.5) -> int:
    return max(1, round(T ** q1))
