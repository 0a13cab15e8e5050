"""Shared machinery of the index-based joins: k-means, nearest-centroid
assignment, dense member tables and candidate verification.

Candidate verification is also the engine's approximate-verification
backend: `verify_candidates_device` counts, for each query row, its
unique candidate ids within eps against a device-resident R (the
engine's padded replica — candidate ids only ever name valid rows, so
the padding is inert). It is plain PyTorch, as the JAX package computes
it outside any Pallas kernel: sort -> adjacent dedup -> mask -1 ->
R[max(id, 0)] -> an fp32 batched dot (TF32 off) -> d <= eps, over the
full candidate width, in query chunks of bounded memory. It performs no
host sync, so the device-probe route stays at its two per batch.
`dispatch_verify_candidates` is the host-input form (the host-probe
route and `query_counts`), which starts the counts' readback and returns
a `PendingCounts`.

Not ported: the ring (row-sharded R) verify and the tombstone mask of a
mutable R, and the live-lane-skipping verify (`_verify_block_live`),
whose traced trip count would read the live bound back to the host.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from repro_torch.utils import resolve_device, start_host_copy, upload

#: verify chunks hold at most this many gathered R elements (f32): the
#: [rows, C, d] gather of a chunk is 256 MB at most
VERIFY_ELEMS = 1 << 26


def searcher_candidates(searcher, Q: np.ndarray, eps: float) -> np.ndarray:
    """Probe a Searcher for candidate ids, passing `eps` only when the
    probe is eps-aware (the protocol's `candidates(Q[, eps])` form)."""
    try:
        eps_aware = "eps" in inspect.signature(searcher.candidates).parameters
    except (TypeError, ValueError):         # builtins / C callables
        eps_aware = False
    if eps_aware:
        return searcher.candidates(Q, eps=float(eps))
    return searcher.candidates(Q)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[na, nb] squared L2 distances, |a|^2 - 2 a.b + |b|^2."""
    return ((a * a).sum(1)[:, None] - 2.0 * (a @ b.T)
            + (b * b).sum(1)[None, :])


def _nearest(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Index of the nearest centroid of each row (the first on ties)."""
    return torch.argmin(_sq_dists(x, c), dim=1)


def kmeans(X: np.ndarray, k: int, *, iters: int = 10, seed: int = 0,
           sample: int | None = 8192, device="cuda") -> np.ndarray:
    """Lloyd's k-means on a seeded sample of X, the distance steps on
    `device` ("cuda" default, or "cpu"). Returns centroids f32 [k, d].
    The numpy rng draws the sample, the initial centroids and the reseeds
    of empty clusters in the JAX package's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = X[rng.choice(len(X), min(sample or len(X), len(X)), replace=False)]
    cent = data[rng.choice(len(data), k, replace=False)].astype(np.float32)
    data_dev = upload(np.asarray(data, np.float32), dev)
    cent_dev = upload(cent, dev)
    clusters = torch.arange(k, device=dev)[:, None]
    for _ in range(iters):
        a = _nearest(data_dev, cent_dev)
        # cluster sums as a one-hot product: deterministic on the card,
        # where index_add_'s atomics would add in a varying order
        onehot = (a[None, :] == clusters).float()          # [k, n]
        sums = onehot @ data_dev
        counts = onehot.sum(dim=1)
        cent_dev = sums / counts.clamp(min=1)[:, None]
        for ci in np.nonzero(counts.cpu().numpy() == 0)[0]:
            # empty cluster: reseed on a random point
            cent_dev[ci] = data_dev[int(rng.integers(len(data)))]
    return cent_dev.cpu().numpy().astype(np.float32)


def assign_nearest(X: np.ndarray, centroids: np.ndarray, block: int = 4096,
                   device="cuda") -> np.ndarray:
    """Index of the nearest centroid of every row of X, int64 [n], on
    `device` ("cuda" default, or "cpu")."""
    dev = resolve_device(device)
    c = upload(np.asarray(centroids, np.float32), dev)
    out = [_nearest(upload(np.asarray(X[i:i + block], np.float32), dev), c)
           .cpu().numpy() for i in range(0, len(X), block)]
    return np.concatenate(out) if out else np.empty((0,), np.int64)


def build_capacity_table(assignments: np.ndarray, n_buckets: int,
                         cap: int | None = None) -> np.ndarray:
    """Dense [n_buckets, cap] member table (-1 padded) from bucket ids:
    each bucket holds its first `cap` rows in index order."""
    assignments = np.asarray(assignments)
    order = np.argsort(assignments, kind="stable")
    sorted_b = assignments[order]
    counts = np.bincount(assignments, minlength=n_buckets)
    if cap is None:
        cap = max(int(counts.max()) if len(counts) else 0, 1)
    table = np.full((n_buckets, cap), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(order)) - starts[sorted_b]
    keep = rank < cap
    table[sorted_b[keep], rank[keep]] = order[keep]
    return table


def _verify_block(R: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
                  eps: float, metric: str) -> torch.Tensor:
    """int32 [bq]: unique candidate ids of each row within eps."""
    cs = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(cs, dtype=torch.bool)
    dup[:, 1:] = cs[:, 1:] == cs[:, :-1]
    valid = (cs >= 0) & ~dup
    x = R[cs.clamp(min=0).long()]                        # [bq, C, d]
    dots = torch.bmm(x, q.float()[:, :, None])[:, :, 0]
    if metric == "cosine":
        d = 1.0 - dots
    else:
        d = torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
    return (valid & (d <= float(np.float32(eps)))).sum(dim=1,
                                                      dtype=torch.int32)


def verify_candidates_device(R: torch.Tensor, q: torch.Tensor,
                             cand: torch.Tensor, eps: float,
                             metric: str) -> torch.Tensor:
    """Counts of unique true neighbours among candidates, int32 [nq] on
    R's device. q f32 [nq, d], cand int32 [nq, C] (-1 padded), both on
    R's device. No host sync."""
    nq, C = cand.shape
    out = torch.zeros((nq,), dtype=torch.int32, device=R.device)
    if nq == 0 or C == 0:
        return out
    rows = max(1, VERIFY_ELEMS // (C * R.shape[1]))
    for i in range(0, nq, rows):
        out[i:i + rows] = _verify_block(R, q[i:i + rows], cand[i:i + rows],
                                        eps, metric)
    return out


class PendingCounts:
    """In-flight candidate verification: the counts' device->host copy is
    started. `result()` is the only blocking point."""

    def __init__(self, wait):
        self._wait = wait

    def result(self) -> np.ndarray:
        """Materialize the int32 [q] counts (blocking if still computing)."""
        return np.asarray(self._wait(), np.int32)


def dispatch_verify_candidates(R: torch.Tensor, Q: np.ndarray,
                               cand_ids: np.ndarray, eps: float,
                               metric: str) -> PendingCounts:
    """Non-blocking form of `verify_candidates`: uploads the queries and
    candidates to R's device, enqueues the verification, starts the
    counts' readback and returns a `PendingCounts` handle. R is a
    device-resident tensor (e.g. the engine's padded R)."""
    q = upload(np.asarray(Q, np.float32), R.device)
    cand = upload(np.asarray(cand_ids, np.int32), R.device)
    counts = verify_candidates_device(R, q, cand, eps, metric)
    return PendingCounts(start_host_copy(counts))


def verify_candidates(R: torch.Tensor, Q: np.ndarray, cand_ids: np.ndarray,
                      eps: float, metric: str) -> np.ndarray:
    """Exact verification of candidate lists: int32 [q] counts of unique
    true neighbours among cand_ids [q, C] (-1 padded)."""
    return dispatch_verify_candidates(R, Q, cand_ids, eps, metric).result()
