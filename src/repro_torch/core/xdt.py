"""Xling Decision Threshold selection (paper §V-B) + Eq. 2 interpolation.

XDT converts the estimator's predicted count into a positive/negative
verdict. Both selectors need the set of ground-truth NEGATIVE training
points (<= tau true neighbors at the queried eps); for an out-of-domain eps
the true cardinalities are approximated by linear interpolation between the
two bracketing grid epsilons (Eq. 2) — the cardinality curve is monotone
non-decreasing in eps, so the approximation error is bounded by the grid
resolution and, empirically (Table V), the resulting FPR/FNR match the
exact targets at 100-2000x lower cost.
"""
from __future__ import annotations

import numpy as np


def interp_targets(eps_grid: np.ndarray, target_table: np.ndarray,
                   eps: float) -> np.ndarray:
    """Eq. 2: per-point linear interpolation of the cardinality curve.

    eps_grid [m] sorted; target_table [n, m]; returns float [n].
    Clamps to the grid edges outside the domain.
    """
    j = int(np.searchsorted(eps_grid, eps))
    if j <= 0:
        return target_table[:, 0].astype(np.float64)
    if j >= len(eps_grid):
        return target_table[:, -1].astype(np.float64)
    e1, e2 = float(eps_grid[j - 1]), float(eps_grid[j])
    t1 = target_table[:, j - 1].astype(np.float64)
    t2 = target_table[:, j].astype(np.float64)
    if e2 <= e1:
        return t1
    return t1 + (t2 - t1) * (eps - e1) / (e2 - e1)


def select_xdt(preds_on_train: np.ndarray, targets_at_eps: np.ndarray,
               tau: int, mode: str = "fpr", fpr_tolerance: float = 0.05) -> float:
    """Compute XDT from training-set predictions + (approx) true targets.

    mode="fpr":  smallest threshold such that the fraction of ground-truth
                 negatives predicted positive is <= fpr_tolerance.
    mode="mean": mean predicted value over the ground-truth negatives
                 (lower threshold -> higher recall, less speedup).
    XDT may be negative (the paper explicitly allows it).
    """
    neg = targets_at_eps <= tau
    if not neg.any():
        # no negatives to calibrate on: nothing can be filtered safely
        return -np.inf
    p = preds_on_train[neg].astype(np.float64)
    if mode == "mean":
        return float(p.mean())
    if mode == "fpr":
        # threshold at the (1 - tol) quantile of negative predictions:
        # only tol of negatives exceed it => train FPR <= tol
        return float(np.quantile(p, 1.0 - fpr_tolerance))
    raise ValueError(f"unknown XDT mode {mode!r}")


def filter_rates(verdicts: np.ndarray, true_counts: np.ndarray, tau: int
                 ) -> dict:
    """FPR/FNR of positive/negative verdicts against ground truth."""
    gt_pos = true_counts > tau
    fp = np.sum(verdicts & ~gt_pos)
    fn = np.sum(~verdicts & gt_pos)
    n_neg = max(int(np.sum(~gt_pos)), 1)
    n_pos = max(int(np.sum(gt_pos)), 1)
    return {"fpr": float(fp / n_neg), "fnr": float(fn / n_pos),
            "n_pos": int(np.sum(gt_pos)), "n_neg": int(np.sum(~gt_pos))}
