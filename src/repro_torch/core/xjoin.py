"""Legacy XJoin surface — thin shims over `JoinPlan`, as in the JAX
package:

    from repro_torch.core import JoinPlan
    plan = JoinPlan(R, metric).filter("xling", tau=50, xdt="fpr").search("naive")
    res = plan.run(Q, eps)

Paper default (§VI-A): XJoin = Naive base + FPR-based XDT (5% tolerance),
tau = 50; <method>-Xling = method base + mean-based XDT, tau = 0.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np

# _bucket_size is re-exported for importers of the JAX package's layout
from repro_torch.core.api import JoinPlan, JoinResult
from repro_torch.core.engine import JoinEngine, _bucket_size  # noqa: F401
from repro_torch.core.joins import make_join
from repro_torch.core.xling import XlingConfig, XlingFilter

__all__ = ["FilteredJoin", "JoinResult", "build_xjoin", "enhance_with_xling"]


class FilteredJoin:
    """Filter-then-verify join: a naive base gated by a filter (legacy
    shim over `JoinPlan`, compiled into a plan at construction time so
    configuration errors surface immediately)."""

    def __init__(self, base, *, filter=None, tau: int = 0,
                 xdt_mode: Optional[str] = None,
                 fpr_tolerance: Optional[float] = None,
                 engine: Optional[JoinEngine] = None, verify: str = "exact"):
        self.base = base
        self.filter = filter
        self.tau = tau
        self.xdt_mode = xdt_mode
        self.fpr_tolerance = fpr_tolerance
        self.engine = engine
        self.verify = verify
        plan = JoinPlan(base.R, base.metric).search(base)
        if filter is not None:
            plan.filter(filter, tau=tau, xdt=xdt_mode,
                        fpr_tolerance=fpr_tolerance)
        plan.on(engine=engine if engine is not None else base.engine,
                backend=base.backend)
        plan.verify("auto" if verify == "exact" else verify)
        self._plan = plan.build()

    def run(self, Q: np.ndarray, eps: float) -> JoinResult:
        """One synchronous join pass over a query batch."""
        return self._plan.run(Q, eps)

    def run_stream(self, batches: Iterable[np.ndarray], eps: float, *,
                   depth: int = 2) -> Iterator[JoinResult]:
        """Serving form: one JoinResult per batch, in order, through the
        pipelined stream; bit-identical to per-batch `run`."""
        return self._plan.stream(batches, eps, depth=depth)


def build_xjoin(R: np.ndarray, metric: str, *, xling_cfg: XlingConfig | None = None,
                tau: int = 50, fpr_tolerance: float = 0.05,
                cache_key: tuple | None = None, backend: str = "auto",
                device="cuda", engine: JoinEngine | None = None,
                verify: str = "exact") -> FilteredJoin:
    """The paper's XJoin: brute-force base + Xling (FPR-XDT, tau=50) on
    one device. Equivalent to `JoinPlan(R, metric).filter("xling",
    tau=tau, xdt="fpr").search("naive").on(device=device)`."""
    cfg = xling_cfg or XlingConfig(metric=metric, xdt_mode="fpr",
                                   fpr_tolerance=fpr_tolerance,
                                   backend=backend, device=str(device))
    if engine is None:
        engine = JoinEngine(R, metric, device=cfg.device, backend=backend)
    filt = XlingFilter(cfg).fit(R, cache_key=cache_key, engine=engine)
    base = make_join("naive", R, metric, backend=backend, engine=engine)
    return FilteredJoin(base, filter=filt, tau=tau, xdt_mode="fpr",
                        fpr_tolerance=fpr_tolerance, engine=engine,
                        verify=verify)


def enhance_with_xling(base, filt: XlingFilter, *, tau: int = 0) -> FilteredJoin:
    """<method>-Xling: mean-based XDT, tau=0 (legacy shim). Only the naive
    base is ported."""
    return FilteredJoin(base, filter=filt, tau=tau, xdt_mode="mean")
