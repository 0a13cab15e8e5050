"""IVF-PQ approximate join (paper baseline "IVFPQ", FAISS-style).

IVF: coarse k-means into C lists; the query probes the n_probe nearest
     lists.
PQ:  vectors split into m segments, each quantized to 256 codes; candidate
     distances are approximated by ADC table lookups, and the best
     `n_candidates` (paper: 1000) are verified exactly against eps.

The coarse probe and the ADC ranking live in `core/probe.py`, shared by
this host path (`candidates`) and the engine's device probe
(`device_probe`), so both routes see the same candidates. The k-means
distance steps and the PQ encoding run on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.joins.common import (_nearest, assign_nearest,
                                           build_capacity_table, kmeans,
                                           verify_candidates)
from repro_torch.core.probe import IVFPQProbe, ivfpq_candidates
from repro_torch.utils import resolve_device, upload


class IVFPQJoin:
    """IVF-PQ over R: `candidates(Q)`, `query_counts(Q, eps)`,
    `device_probe(eps)`. `device` is where the build, the probe and the
    verification run ("cuda" default, or "cpu")."""

    name = "ivfpq"
    exact = False

    def __init__(self, R: np.ndarray, metric: str, *, C: int = 300, m: int = 25,
                 n_probe: int = 50, n_candidates: int = 1000, seed: int = 0,
                 device="cuda", **_):
        R = np.asarray(R, np.float32)
        n, d = R.shape
        while d % m != 0:    # paper: m=32, or 25 when dim not a multiple of 32
            m -= 1
        self._setup(R, metric, C=C, m=m, n_probe=n_probe,
                    n_candidates=n_candidates, device=device)
        self.centroids = kmeans(self.R, C, iters=8, seed=seed,
                                device=self.device)
        assign = assign_nearest(self.R, self.centroids, device=self.device)
        self.lists = build_capacity_table(assign, C)              # [C, cap]

        # PQ codebooks on residual-free raw vectors (classic ADC)
        rng = np.random.default_rng(seed + 1)
        sample = self.R[rng.choice(n, min(8192, n), replace=False)]
        self.codebooks = np.stack([
            kmeans(sample[:, s * self.seg:(s + 1) * self.seg], 256, iters=6,
                   seed=seed + 2 + s, device=self.device)
            for s in range(m)])                                   # [m, 256, seg]
        self.codes = self._encode(self.R)                         # [n, m] uint8

    def _setup(self, R, metric, *, C, m, n_probe, n_candidates, device):
        self.R = np.asarray(R, np.float32)
        self.metric = metric
        self.m, self.C = int(m), int(C)
        self.n_probe = min(int(n_probe), self.C)
        self.n_candidates = int(n_candidates)
        self.seg = self.R.shape[1] // self.m
        self.device = resolve_device(device)
        self._Rdev = None

    @classmethod
    def from_arrays(cls, R: np.ndarray, metric: str, arrays: dict, *,
                    n_probe: int = 50, n_candidates: int = 1000,
                    device="cuda") -> "IVFPQJoin":
        """An index over R from given quantizer state (numpy `centroids`,
        `lists`, `codes`, `codebooks`), e.g. that of a JAX `IVFPQJoin`."""
        self = cls.__new__(cls)
        centroids = np.asarray(arrays["centroids"], np.float32)
        codebooks = np.asarray(arrays["codebooks"], np.float32)
        self._setup(R, metric, C=len(centroids), m=codebooks.shape[0],
                    n_probe=n_probe, n_candidates=n_candidates, device=device)
        self.centroids = centroids
        self.codebooks = codebooks
        self.lists = np.asarray(arrays["lists"], np.int32)
        self.codes = np.asarray(arrays["codes"], np.uint8)
        return self

    def _encode(self, X: np.ndarray, block: int = 8192) -> np.ndarray:
        """uint8 [n, m] PQ codes: the nearest codeword of each segment."""
        codes = np.empty((len(X), self.m), np.uint8)
        for s in range(self.m):
            cb = upload(self.codebooks[s], self.device)
            for i in range(0, len(X), block):
                seg = upload(np.ascontiguousarray(
                    X[i:i + block, s * self.seg:(s + 1) * self.seg]),
                    self.device)
                codes[i:i + block, s] = _nearest(seg, cb).cpu().numpy()
        return codes

    def candidates(self, Q: np.ndarray) -> np.ndarray:
        """ADC-ranked candidate ids, int32 [q, k] (-1 padded), k =
        min(n_candidates, probed pool): the host probe, through the same
        coarse probe + ADC ranking as `device_probe()`."""
        return ivfpq_candidates(
            Q, self.centroids, self.lists, self.codes, self.codebooks,
            n_probe=self.n_probe,
            n_cand=min(self.n_candidates,
                       self.n_probe * self.lists.shape[1]),
            device=self.device)

    def device_probe(self, eps: float | None = None):
        """The DeviceSearcher capability: the probe spec the engine places
        on its device. Radius-free; one memoized spec per index."""
        spec = self.__dict__.get("_probe_spec")
        if spec is None:
            spec = self._probe_spec = IVFPQProbe(self)
        return spec

    def _R_device(self) -> torch.Tensor:
        if self._Rdev is None:
            self._Rdev = upload(self.R, self.device)
        return self._Rdev

    def query_counts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """Exact eps-counts over the ADC-ranked candidates (device verify)."""
        Q = np.asarray(Q, np.float32)
        return verify_candidates(self._R_device(), Q, self.candidates(Q),
                                 float(eps), self.metric)
