"""Naive brute-force nested-loop join (the paper's ground-truth method).

Exact: every query is ranged against all of R through the device-resident
`JoinEngine` — R is uploaded once at build time and every `query_counts`
call is one range-count sweep (the fused kernel on the card).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import JoinEngine


class NaiveJoin:
    """Brute-force exact join over R: `query_counts(Q, eps)`."""

    name = "naive"
    exact = True

    def __init__(self, R: np.ndarray, metric: str, *, backend: str = "auto",
                 device="cuda", engine: JoinEngine | None = None):
        self.R = np.asarray(R, np.float32)
        self.metric = metric
        self.backend = backend
        self.engine = engine if engine is not None else JoinEngine(
            self.R, metric, device=device, backend=backend)

    def query_counts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """int32 [q] neighbor counts of each query within eps."""
        return self.engine.range_count(Q, float(eps))
