"""Waudby-Smith & Ramdas betting-martingale estimator (paper §A.2).

Certifies "cascade accuracy >= target with failure probability <= delta"
from i.i.d. Bernoulli correctness samples on the validation split.  The
wealth process

    K_i = prod_{j<=i} (1 + min(lambda_j, 3/(4T)) * (X_j - T))

is a nonnegative supermartingale under H0: E[X] <= T, so by Ville's
inequality P(sup_i K_i >= 1/delta) <= delta.  The estimator returns True
(certified) iff the wealth ever crosses 1/delta.  lambda_j adapts to the
running empirical variance, which is what makes this tighter than
Hoeffding when correctness is nearly deterministic (the common case at
alpha >= 0.9).
"""
from __future__ import annotations

import numpy as np


def wsr_wealth(x: np.ndarray, target: float, delta: float,
               lam_rule: str = "paper") -> np.ndarray:
    """The wealth process K_i. x: binary [n].

    Any PREDICTABLE lambda_i in [0, 1/target) keeps K a nonnegative
    supermartingale under H0: E[X] <= target, so Ville's inequality gives
    the delta guarantee regardless of the betting rule.  Two members of
    the Waudby-Smith-Ramdas betting family are provided:

    * ``paper``  — the variance-adaptive predictable mixture restated in
      the paper's Lemma A.1 (sqrt(2 log(2/delta) / (i log(i+1) sigma^2)),
      capped at 3/(4 target)).  At the paper's own operating point
      (target 0.9, n~100, true acc 0.92-0.96) the cap binds for the first
      ~30 samples and one wrong answer multiplies wealth by 0.25 —
      near-zero power unless an early all-correct prefix certifies.
    * ``kelly``  — the log-optimal (GRO) fraction for Bernoulli bets,
      lambda_i = (mu_hat_{i-1} - target) / (target (1 - target)), clipped
      to [0, 3/(4 target)].  Measured LESS powerful than "paper" at the
      1/delta = 4 wealth bar (the sup exploits aggressive bets), so
      "paper" stays the default; kept for lower-false-positive regimes.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    if n == 0:
        return np.zeros((0,))
    idx = np.arange(1, n + 1)
    mu_hat = (0.5 + np.cumsum(x)) / (idx + 1)
    cap = 3.0 / (4.0 * target)
    if lam_rule == "paper":
        sigma2 = (0.25 + np.cumsum((x - mu_hat) ** 2)) / (idx + 1)
        # lambda_i uses sigma^2_{i-1}; sigma^2_0 = 0.25
        sigma2_prev = np.concatenate([[0.25], sigma2[:-1]])
        lam = np.sqrt(2.0 * np.log(2.0 / delta)
                      / (idx * np.log1p(idx) * sigma2_prev))
        lam = np.minimum(lam, cap)
    else:
        mu_prev = np.concatenate([[0.5], mu_hat[:-1]])     # predictable
        lam = np.clip((mu_prev - target) / (target * (1.0 - target)),
                      0.0, cap)
    factors = 1.0 + lam * (x - target)
    # wealth must stay nonnegative; clip guards numerically tiny negatives
    return np.cumprod(np.maximum(factors, 1e-12))


def wsr_certify(x: np.ndarray, target: float, delta: float,
                lam_rule: str = "paper") -> bool:
    """E(t, D_V): True iff exists i with K_i >= 1/delta."""
    if len(x) == 0:
        return False
    return bool(np.any(wsr_wealth(x, target, delta, lam_rule)
                       >= 1.0 / delta))


def hoeffding_certify(x: np.ndarray, target: float, delta: float) -> bool:
    """Baseline estimator: mean - sqrt(log(1/delta)/(2n)) >= target."""
    n = len(x)
    if n == 0:
        return False
    return bool(np.mean(x) - np.sqrt(np.log(1.0 / delta) / (2 * n)) >= target)


def wsr_lower_bound(x: np.ndarray, delta: float,
                    grid: int = 200) -> float:
    """(1-delta) lower confidence bound on the mean via grid inversion.

    Smallest target NOT rejected: sup of targets the wealth certifies.
    Used for reporting, not in the adjustment loop.
    """
    lo, hi = 0.0, 1.0
    for t in np.linspace(1e-3, 1.0 - 1e-3, grid):
        if wsr_certify(x, float(t), delta):
            lo = float(t)
    return lo
