"""Adaptive Training Condition Selection (paper Algorithm 1).

Given, for each point p, the uniformly-sampled candidate conditions C_p
(the shared eps grid, |C_p| = m) and their targets T_p (ground-truth
cardinalities), pick s conditions per point:

  1. split [t_min, t_max] into s even bins,
  2. place each (c, t) pair into its bin by target,
  3. draw floor(s*|B_i|/|C_p|) pairs from each bin (density-proportional),
  4. top up to s with random draws from the not-yet-selected pairs.

The output is the per-point index set into the eps grid; the caller builds
the (p, eps, t) training tuples from it. `uniform_select` is the paper's
"fixed" baseline strategy.
"""
from __future__ import annotations

import numpy as np


def uniform_select(targets: np.ndarray, s: int, *, seed: int = 0) -> np.ndarray:
    """Evenly spaced condition indices (same for every point). [n, s] int."""
    n, m = targets.shape
    idx = np.linspace(0, m - 1, s).round().astype(np.int64)
    return np.broadcast_to(idx, (n, s)).copy()


def atcs_select(targets: np.ndarray, s: int, *, seed: int = 0) -> np.ndarray:
    """Algorithm 1 over the full table. targets: [n, m]. Returns [n, s] int
    indices into the condition grid (distinct per row)."""
    n, m = targets.shape
    if s >= m:
        return np.broadcast_to(np.arange(m), (n, m)).copy()
    rng = np.random.default_rng(seed)
    t = targets.astype(np.float64)

    t_min = t.min(axis=1, keepdims=True)                     # line 5
    t_max = t.max(axis=1, keepdims=True)
    span = np.maximum(t_max - t_min, 1e-12)
    # line 6-8: bin of each (c, t): s even bins over [t_min, t_max]
    bin_of = np.minimum((s * (t - t_min) / span).astype(np.int64), s - 1)  # [n, m]

    # line 10-11: per-bin quota floor(s * |B_i| / m); sample that many from
    # each bin. Vectorized: shuffle within rows, sort by (bin, shuffle key),
    # then mark the first quota_i entries of each bin run.
    shuffle_key = rng.random((n, m))
    order = np.lexsort((shuffle_key, bin_of), axis=1)        # [n, m] col indices
    bins_sorted = np.take_along_axis(bin_of, order, axis=1)
    # position of each element within its bin run:
    bin_counts = np.zeros((n, s), np.int64)
    for b in range(s):
        bin_counts[:, b] = (bin_of == b).sum(axis=1)
    quota = (s * bin_counts) // m                            # [n, s]
    # rank within run = index - start of run
    starts = np.concatenate([np.zeros((n, 1), np.int64),
                             np.cumsum(bin_counts, axis=1)[:, :-1]], axis=1)
    pos = np.arange(m)[None, :] - np.take_along_axis(starts, bins_sorted, axis=1)
    chosen = pos < np.take_along_axis(quota, bins_sorted, axis=1)  # [n, m] in sorted order

    # line 12-13: top up to s with random unselected pairs
    deficit = s - chosen.sum(axis=1)                         # [n]
    # random priority for the fill among unchosen
    fill_key = rng.random((n, m))
    fill_key[chosen] = np.inf                                # already selected
    fill_rank = np.argsort(np.argsort(fill_key, axis=1), axis=1)
    chosen |= fill_rank < deficit[:, None]

    sel_sorted_pos = np.argsort(~chosen, axis=1, kind="stable")[:, :s]  # positions in sorted order
    out = np.take_along_axis(order, sel_sorted_pos, axis=1)
    out.sort(axis=1)
    return out


def build_training_tuples(points: np.ndarray, eps_grid: np.ndarray,
                          targets: np.ndarray, select_idx: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Materialize (p ++ eps) features and targets from selected indices.

    Returns X [n*s, d+1] float32, y [n*s] float32.
    """
    n, s = select_idx.shape
    d = points.shape[1]
    X = np.empty((n * s, d + 1), np.float32)
    X[:, :d] = np.repeat(points, s, axis=0)
    X[:, d] = eps_grid[select_idx].reshape(-1)
    y = np.take_along_axis(targets, select_idx, axis=1).reshape(-1).astype(np.float32)
    return X, y
