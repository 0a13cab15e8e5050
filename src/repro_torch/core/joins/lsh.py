"""LSH-based approximate join (paper baseline "LSH", FALCONN-style).

Cosine: k random-hyperplane bits per table -> bucket code.
L2:     k p-stable (Gaussian) quantized projections, combined by a random
        integer hash -> bucket id.
Multiprobe: perturb one hash coordinate at a time (bit flip / +-1) and take
the first n_probes probe buckets per table.

All hash and probe math lives in `core/probe.py` and is shared by this
host path (`candidates`) and the engine's device probe (`device_probe`),
so both routes see the same candidate sets. The projections, biases and
salts come from a numpy rng seeded as in the JAX package, so the two
packages build the same hash functions from the same seed.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.joins.common import build_capacity_table, verify_candidates
from repro_torch.core.probe import (LSHProbe, lsh_bucket_ids, lsh_hash_codes,
                                    lsh_probe, lsh_state, split_hot_buckets)
from repro_torch.utils import resolve_device, upload


class LSHJoin:
    """Multiprobe LSH over R: `candidates(Q)`, `query_counts(Q, eps)`,
    `device_probe(eps)`. `device` is where hashing and verification run
    ("cuda" default, or "cpu")."""

    name = "lsh"
    exact = False

    def __init__(self, R: np.ndarray, metric: str, *, k: int = 18, l: int = 10,
                 n_probes: int = 4, W: float = 2.5, n_buckets: int | None = None,
                 cap: int | None = None, seed: int = 0,
                 rebucket_hot: float | None = None, max_fanout: int = 8,
                 device="cuda", **_):
        self._setup(R, metric, k=k, l=l, n_probes=n_probes, W=W,
                    n_buckets=n_buckets, device=device)
        n, d = self.R.shape
        rng = np.random.default_rng(seed)
        self.proj = rng.normal(size=(l, k, d)).astype(np.float32)
        self.bias = rng.uniform(0, W, size=(l, k)).astype(np.float32)
        self.salt = rng.integers(1, 2 ** 31, size=(l, k)).astype(np.int64)
        buckets = lsh_bucket_ids(self._hash_codes(self.R), self.salt,
                                 self.n_buckets)                 # [n, l]
        #: skew-aware re-bucketing (`rebucket_hot=`): buckets hotter than
        #: rebucket_hot x the mean occupancy split on extra median-
        #: thresholded hyperplanes; `expand` maps each original bucket to
        #: its children and probing expands through it (candidate sets —
        #: hence verified counts — unchanged).
        self.expand = None
        self.rebucket_info = None
        n_total = self.n_buckets
        if rebucket_hot is not None:
            split = split_hot_buckets(buckets, self.R,
                                      n_buckets=self.n_buckets,
                                      hot_factor=float(rebucket_hot),
                                      max_fanout=int(max_fanout), seed=seed)
            if split is not None:
                buckets, self.expand, n_total, self.rebucket_info = split
        self.n_total_buckets = n_total
        occ = np.stack([np.bincount(buckets[:, t], minlength=n_total)
                        for t in range(l)])                      # [l, B]
        if cap is None:
            # the p99.9 occupancy keeps the table dense; overflow drops
            # rows, counted in overflow_frac below
            cap = int(max(2, np.quantile(occ.reshape(-1), 0.999)))
        if self.expand is not None:
            # the post-split occupancy is the binding width
            cap = int(max(2, min(cap, occ.max())))
        self.cap = cap
        self.tables = np.stack([
            build_capacity_table(buckets[:, t], n_total, cap)
            for t in range(l)])                                  # [l, B, cap]
        self._note_overflow()

    def _setup(self, R, metric, *, k, l, n_probes, W, n_buckets, device):
        self.R = np.asarray(R, np.float32)
        self.metric = metric
        self.k, self.l, self.n_probes, self.W = int(k), int(l), int(n_probes), W
        n = len(self.R)
        self.n_buckets = int(n_buckets or max(256, 2 ** int(np.ceil(np.log2(
            max(n, 1))))))
        self.device = resolve_device(device)
        self._Rdev = None
        self._state = None      # the probe tables on `device`, at first use

    def _note_overflow(self) -> None:
        #: fraction of (row, table) memberships dropped by bucket-capacity
        #: overflow at build time — the index's candidate-loss budget,
        #: surfaced by `JoinPlan.describe()`. Every row has one membership
        #: per table, so the dropped ones are those missing from the tables.
        n = len(self.R)
        kept = int((self.tables >= 0).sum())
        self.overflow_frac = float((n * self.l - kept) / max(n * self.l, 1))
        if self.overflow_frac > 0.01:
            warnings.warn(
                f"LSHJoin: bucket-capacity overflow drops "
                f"{self.overflow_frac:.1%} of row memberships (cap={self.cap}, "
                f"n_buckets={self.n_buckets}); recall degrades — raise "
                "cap= or n_buckets=", RuntimeWarning, stacklevel=3)

    @classmethod
    def from_arrays(cls, R: np.ndarray, metric: str, arrays: dict, *,
                    n_probes: int = 4, W: float = 2.5,
                    device="cuda") -> "LSHJoin":
        """An index over R from given hash functions and member tables
        (numpy `proj`, `bias`, `salt`, `tables`, optional `expand`, and
        `n_buckets`), e.g. those a JAX `LSHJoin` built."""
        self = cls.__new__(cls)
        proj = np.asarray(arrays["proj"], np.float32)
        l, k, _ = proj.shape
        self._setup(R, metric, k=k, l=l, n_probes=n_probes, W=W,
                    n_buckets=int(arrays["n_buckets"]), device=device)
        self.proj = proj
        self.bias = np.asarray(arrays["bias"], np.float32)
        self.salt = np.asarray(arrays["salt"], np.int64)
        self.tables = np.asarray(arrays["tables"], np.int32)
        expand = arrays.get("expand")
        self.expand = None if expand is None else np.asarray(expand, np.int32)
        self.rebucket_info = None
        self.n_total_buckets = self.tables.shape[1]
        self.cap = int(arrays.get("cap", self.tables.shape[2]))
        self._note_overflow()
        return self

    # -- hashing -------------------------------------------------------------
    def _hash_codes(self, X: np.ndarray) -> np.ndarray:
        return lsh_hash_codes(X, self.proj, self.bias, metric=self.metric,
                              W=self.W, device=self.device)

    # -- query ----------------------------------------------------------------
    def candidates(self, Q: np.ndarray) -> np.ndarray:
        """Multiprobe candidate ids, int32 [q, l*n_probes*fanout*cap] (-1
        padded; a repeated probe of a (query, table) pair blanked): the
        host probe, through the same `lsh_probe` as `device_probe()`, on
        the index's device."""
        Q = np.asarray(Q, np.float32)
        if self._state is None:
            self._state = lsh_state(self, self.device)
        cand = lsh_probe(upload(Q, self.device), *self._state,
                         metric=self.metric, W=self.W,
                         n_probes=self.n_probes, n_buckets=self.n_buckets)
        return cand.cpu().numpy()

    def device_probe(self, eps: float | None = None):
        """The DeviceSearcher capability: the probe spec the engine places
        on its device. Radius-free (eps is ignored); one memoized spec per
        index."""
        spec = self.__dict__.get("_probe_spec")
        if spec is None:
            spec = self._probe_spec = LSHProbe(self)
        return spec

    def _R_device(self) -> torch.Tensor:
        if self._Rdev is None:
            self._Rdev = upload(self.R, self.device)
        return self._Rdev

    def query_counts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """Exact eps-counts over the probed candidates (device verify)."""
        Q = np.asarray(Q, np.float32)
        return verify_candidates(self._R_device(), Q, self.candidates(Q),
                                 float(eps), self.metric)
