"""The paper's primary contribution, ported to PyTorch:

  api.py    — the public surface: JoinPlan + the Filter protocol
  xling.py  — the learned metric-space Bloom filter (estimator + XDT)
  atcs.py   — adaptive training-condition selection (Algorithm 1)
  xdt.py    — FPR/mean XDT selection + Eq. 2 interpolated targets
  xjoin.py  — legacy XJoin shims over JoinPlan
  engine.py — the device-resident join engine (one device, R replicated):
              the exact verify and the approximate routes with their
              index probe on the device or the host
  probe.py  — device probing: LSH hashing / multiprobe, the IVF-PQ coarse
              probe, placed probe tables, the DeviceSearcher registry
  joins/    — join methods (naive, lsh, ivfpq) behind `make_join`
"""
from repro_torch.core import atcs, xdt
from repro_torch.core.api import Filter, JoinPlan, JoinResult, as_filter
from repro_torch.core.engine import JoinEngine, sharded_range_count_hist
from repro_torch.core.joins import JOINS, make_join
from repro_torch.core.xjoin import FilteredJoin, build_xjoin, enhance_with_xling
from repro_torch.core.xling import XlingConfig, XlingFilter

__all__ = ["Filter", "JoinPlan", "JoinResult", "as_filter",
           "XlingConfig", "XlingFilter", "FilteredJoin", "build_xjoin",
           "enhance_with_xling", "JoinEngine", "sharded_range_count_hist",
           "atcs", "xdt", "JOINS", "make_join"]
