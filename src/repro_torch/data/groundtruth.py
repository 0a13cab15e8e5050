"""Ground-truth cardinality pipeline (training targets for the estimator).

For the index set R and a sorted candidate-eps grid (m values), builds
t[i, j] = |{r in R : d(p_i, r) <= eps_j}| in ONE sweep through the engine
(the fused range-count kernel on the card). The table is the most
expensive offline artifact (O(|R|^2 d)), so it is cached on disk under
the port's own key prefix: the port never reads a table the JAX package
wrote.
"""
from __future__ import annotations

import numpy as np

from repro_torch.utils import cache_path

# paper §VI-B1: candidate grids per metric, m=100 evenly spaced values
EPS_RANGE = {"cosine": (0.4, 0.9), "l2": (0.5, 2.0)}


def eps_grid_for_metric(metric: str, m: int = 100) -> np.ndarray:
    """The paper's m-value candidate eps grid for `metric`, float32."""
    lo, hi = EPS_RANGE[metric]
    return np.linspace(lo, hi, m).astype(np.float32)


def cardinality_table(points: np.ndarray, index_set: np.ndarray,
                      eps_grid: np.ndarray, metric: str, *,
                      backend: str = "auto", device="cuda",
                      cache_key: tuple | None = None,
                      exclude_self: bool = False, engine=None) -> np.ndarray:
    """t[i, j] = #-neighbors of points[i] in index_set within eps_grid[j].

    engine: a prebuilt `JoinEngine` over (index_set, metric) — reuses its
    device-resident R (validated; a mismatch raises). May also be a
    zero-arg callable returning the engine, invoked only on a cache miss.
    Without one, a fresh engine is built on `device`.

    exclude_self: subtract the self-match when points IS index_set (tau=0
    then means "has some OTHER point nearby"), clamped at 0.
    """
    if cache_key is not None:
        path = cache_path("gt-torch-v1", cache_key, len(points),
                          len(index_set), len(eps_grid), metric, exclude_self)
        try:
            with np.load(path) as z:
                return z["t"]
        except (FileNotFoundError, OSError):
            pass

    from repro_torch.core.engine import JoinEngine, sharded_range_count_hist
    if callable(engine) and not isinstance(engine, JoinEngine):
        engine = engine()               # lazy factory: only on cache miss
    t = sharded_range_count_hist(points, index_set, eps_grid, metric=metric,
                                 backend=backend, device=device,
                                 engine=engine)
    if exclude_self:
        t = np.maximum(t - 1, 0)        # every point is its own 0-distance neighbor
    if cache_key is not None:
        np.savez_compressed(path, t=t)
    return t
