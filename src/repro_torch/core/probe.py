"""Device-resident probing: the index probe of the approximate verify
routes runs on the engine's device, so candidates never leave it — one
device, R and the probe tables replicated.

Three layers, as in the JAX package's `repro/core/probe.py`:

  * **Shared probing math** — `lsh_probe` and `ivfpq_probe` are plain
    functions on tensors, used by BOTH the host probe
    (`LSHJoin.candidates`, `IVFPQJoin.candidates`, on the index's
    device) and the placed device probes, so the two routes see the same
    candidates and give the same counts; `lsh_hash_codes` /
    `lsh_bucket_ids` / `lsh_probe_buckets` are their host entries for
    the table build.
  * **Probe specs + the adapter registry** — a Searcher advertises the
    capability with `device_probe(eps)`, returning a spec (`LSHProbe` /
    `IVFPQProbe`) or None; searchers that cannot grow the method
    register a builder in `PROBE_BUILDERS`; `as_device_probe` resolves
    either form.
  * **Placed probes** — `spec.place(engine)` uploads the probe tables
    once, on the engine's device. `PlacedProbe.probe(qpos)` runs the
    hashing / coarse quantizer in plain PyTorch and the two hand-written
    kernels: the LSH member-table gather with multiprobe dedup
    (`kernels/lsh_gather.py`) and the ADC ranking (`kernels/adc_rank.py`).

LSH bucket ids: the salted code sum is taken modulo 2**32 into the
int32 range (two's-complement wraparound, the salt cast from int64 the
same way) and then reduced with `torch.remainder`, which, like
`jnp.mod`, takes the sign of the divisor. The products and the sum are
formed exactly in int64 first; the wrap makes them the int32 values the
JAX package computes.

Not ported: the ring placement (per-shard LSH tables) and the compiled
program caches; plain functions on tensors replace the programs.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.joins.common import (_sq_dists,
                                           verify_candidates_device)
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device, upload

#: the positives are probed in tiles whose candidate pool [tile, C]
#: holds at most this many lanes (int32: 256 MB)
PROBE_TILE_LANES = 1 << 26


# ====================================================== shared LSH math
def salt32(salt) -> np.ndarray:
    """The int64 salts cast to int32 with wraparound."""
    return np.asarray(salt, np.int64).astype(np.int32)


def _lsh_codes(X: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor, *,
               metric: str, W: float) -> torch.Tensor:
    """int32 [n, l, k] hash codes: hyperplane sign bits (cosine) or
    p-stable quantized projections (l2)."""
    l, k, d = proj.shape
    h = (X.float() @ proj.reshape(l * k, d).float().T).reshape(-1, l, k)
    if metric == "cosine":
        return (h > 0).to(torch.int32)
    return torch.floor((h + bias[None].float()) / float(np.float32(W))) \
        .to(torch.int32)


def _lsh_combine(codes: torch.Tensor, salt: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """int32 [n, l] bucket ids from salted-code sums, wrapped to int32 and
    reduced with the divisor's sign."""
    mixed = (codes.long() * salt.long()[None]).sum(dim=2)
    mixed = torch.remainder(mixed + 2 ** 31, 2 ** 32) - 2 ** 31
    return torch.remainder(mixed, int(n_buckets)).to(torch.int32)


def _lsh_multiprobe(codes: torch.Tensor, salt: torch.Tensor, *, metric: str,
                    n_probes: int, n_buckets: int) -> torch.Tensor:
    """int32 [n, l, n_probes] probe bucket ids: the identity probe plus
    single-coordinate perturbations (bit flip / +-1), padded by repeating
    the identity probe."""
    probes = [_lsh_combine(codes, salt, n_buckets)]
    for j in range(codes.shape[2]):
        if len(probes) >= n_probes:
            break
        pert = codes.clone()
        if metric == "cosine":
            pert[:, :, j] = 1 - codes[:, :, j]
        else:
            pert[:, :, j] = codes[:, :, j] + (1 if j % 2 == 0 else -1)
        probes.append(_lsh_combine(pert, salt, n_buckets))
    while len(probes) < n_probes:
        probes.append(probes[0])
    return torch.stack(probes[:n_probes], dim=2)


def lsh_hash_codes(X, proj, bias, *, metric: str, W: float,
                   device="cuda") -> np.ndarray:
    """Host entry: int32 [n, l, k] codes, computed on `device` ("cuda"
    default, or "cpu")."""
    dev = resolve_device(device)
    return _lsh_codes(upload(np.asarray(X, np.float32), dev),
                      upload(np.asarray(proj, np.float32), dev),
                      upload(np.asarray(bias, np.float32), dev),
                      metric=metric, W=W).cpu().numpy()


def lsh_bucket_ids(codes, salt, n_buckets: int) -> np.ndarray:
    """Host entry: int32 [n, l] bucket ids for the table build (the same
    combine as probing)."""
    return _lsh_combine(torch.from_numpy(np.array(codes, np.int32)),
                        torch.from_numpy(salt32(salt)), n_buckets).numpy()


def lsh_probe_buckets(X, proj, bias, salt, *, metric: str, W: float,
                      n_probes: int, n_buckets: int,
                      device="cuda") -> np.ndarray:
    """Host entry: int32 [q, l, n_probes] multiprobe bucket ids, computed
    on `device` ("cuda" default, or "cpu")."""
    dev = resolve_device(device)
    return _lsh_pb(upload(np.asarray(X, np.float32), dev),
                   upload(np.asarray(proj, np.float32), dev),
                   upload(np.asarray(bias, np.float32), dev),
                   upload(salt32(salt), dev), None, metric=metric, W=W,
                   n_probes=n_probes, n_buckets=n_buckets).cpu().numpy()


# ==================================== bucket histograms + re-bucketing
def bucket_occupancy(tables: np.ndarray) -> np.ndarray:
    """Retained-entry occupancy histogram int64 [l, B] of a member table
    [l, B, cap] (-1 padded)."""
    return (np.asarray(tables) >= 0).sum(axis=2)


def bucket_skew_stats(occ: np.ndarray) -> dict:
    """Skew summary of an occupancy histogram [l, B] (flattened): Gini
    coefficient, top-16 mass fraction, and the max/mean-nonzero ratio
    (`hot_factor`)."""
    flat = np.sort(np.asarray(occ, np.float64).reshape(-1))
    total = float(flat.sum())
    n = len(flat)
    if total <= 0 or n == 0:
        return {"gini": 0.0, "top16_mass": 0.0, "hot_factor": 0.0,
                "mean_nonzero": 0.0, "max": 0}
    cum = np.cumsum(flat)
    gini = float(1.0 - 2.0 * np.sum(cum) / (total * n) + 1.0 / n)
    nz = flat[flat > 0]
    return {
        "gini": gini,
        "top16_mass": float(flat[-16:].sum() / total),
        "hot_factor": float(flat[-1] / nz.mean()),
        "mean_nonzero": float(nz.mean()),
        "max": int(flat[-1]),
    }


def split_hot_buckets(buckets: np.ndarray, X: np.ndarray, *,
                      n_buckets: int, hot_factor: float,
                      max_fanout: int = 8, seed: int = 0):
    """Split hot buckets of a raw assignment [n, l] on extra hyperplanes.

    A bucket is HOT when its occupancy exceeds ``max(hot_factor *
    mean-nonzero-occupancy, 4)``. Each hot bucket's rows are partitioned
    by the sign pattern of ``log2(fanout)`` fresh random projections,
    thresholded at the per-(table, bucket, plane) MEDIAN. Children are
    appended after the original ``n_buckets`` ids plus one trailing
    always-empty filler bucket (the expansion slot of non-hot buckets).

    Returns ``None`` when nothing is hot, else ``(buckets2 [n, l],
    expand [l, n_buckets, fanout] int32, n_total_buckets, info)``. The
    union of any original bucket's children is exactly that bucket's row
    set, so probing every child keeps the candidate set."""
    buckets = np.asarray(buckets)
    n, l = buckets.shape
    occ = np.stack([np.bincount(buckets[:, t], minlength=n_buckets)
                    for t in range(l)])
    nz = occ[occ > 0]
    mean_nz = float(nz.mean()) if len(nz) else 0.0
    threshold = max(hot_factor * mean_nz, 4.0)
    hot = occ > threshold
    if not hot.any():
        return None
    max_occ = int(occ.max())
    fanout = 2
    while fanout < max_fanout and max_occ / fanout > threshold:
        fanout *= 2
    s = int(math.log2(fanout))
    rng = np.random.default_rng(seed)
    proj2 = rng.normal(size=(l, s, X.shape[1])).astype(np.float32)
    H = np.einsum("nd,lsd->nls", np.asarray(X, np.float32), proj2)
    n_hot_max = int(hot.sum(axis=1).max())
    filler = n_buckets + n_hot_max * fanout
    n_total = filler + 1
    expand = np.full((l, n_buckets, fanout), filler, np.int32)
    expand[:, :, 0] = np.arange(n_buckets, dtype=np.int32)[None, :]
    buckets2 = buckets.copy()
    for t in range(l):
        for i, b in enumerate(np.nonzero(hot[t])[0]):
            base = n_buckets + i * fanout
            expand[t, b] = base + np.arange(fanout, dtype=np.int32)
            rows = np.nonzero(buckets[:, t] == b)[0]
            bits = np.zeros(len(rows), np.int32)
            for j in range(s):
                h = H[rows, t, j]
                bits |= (h > np.median(h)).astype(np.int32) << j
            buckets2[rows, t] = base + bits
    occ2 = np.stack([np.bincount(buckets2[:, t], minlength=n_total)
                     for t in range(l)])
    info = {
        "n_hot": int(hot.sum()),
        "fanout": fanout,
        "threshold": float(threshold),
        "max_occ_before": max_occ,
        "max_occ_after": int(occ2.max()),
        "n_total_buckets": n_total,
    }
    return buckets2, expand, n_total, info


def _expand_pb(pb: torch.Tensor, expand: torch.Tensor) -> torch.Tensor:
    """[q, l, p] probed bucket ids -> [q, l, p*fanout] via the re-bucket
    expansion map [l, B, fanout]."""
    q, l, p = pb.shape
    t_idx = torch.arange(l, device=pb.device)[None, :, None]
    return expand[t_idx, pb.long()].reshape(q, l, p * expand.shape[2])


def _lsh_pb(qpos: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
            salt: torch.Tensor, expand: Optional[torch.Tensor], *,
            metric: str, W: float, n_probes: int,
            n_buckets: int) -> torch.Tensor:
    """int32 [q, l, p*fanout] probed bucket ids on the queries' device:
    hash, multiprobe, then expand through the re-bucket map (if any)."""
    codes = _lsh_codes(qpos, proj, bias, metric=metric, W=W)
    pb = _lsh_multiprobe(codes, salt, metric=metric, n_probes=n_probes,
                         n_buckets=n_buckets)
    if expand is not None:
        pb = _expand_pb(pb, expand)
    return pb.to(torch.int32)


def lsh_probe(qpos: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
              salt: torch.Tensor, tables: torch.Tensor,
              expand: Optional[torch.Tensor] = None, *, metric: str,
              W: float, n_probes: int, n_buckets: int,
              backend: str = "auto") -> torch.Tensor:
    """The LSH probe, host and device routes alike: the probed bucket ids
    (`_lsh_pb`), then the member-table gather with dedup of repeated
    probes. Returns int32 [q, l*p*fanout*cap] candidate ids (-1
    padded)."""
    pb = _lsh_pb(qpos, proj, bias, salt, expand, metric=metric, W=W,
                 n_probes=n_probes, n_buckets=n_buckets)
    return ops.lsh_bucket_gather(tables, pb, backend=backend)


def lsh_state(join, device: torch.device) -> tuple:
    """An `LSHJoin`'s probe tables on `device`, in `lsh_probe`'s argument
    order: (proj, bias, int32 salt, tables, expand or None)."""
    expand = getattr(join, "expand", None)
    return (upload(join.proj, device), upload(join.bias, device),
            upload(salt32(join.salt), device),
            upload(np.asarray(join.tables, np.int32), device),
            None if expand is None
            else upload(np.asarray(expand, np.int32), device))


# =================================================== shared IVF-PQ math
def probe_tile_rows(width: int) -> int:
    """Rows per probe tile whose candidate pool [rows, width] stays under
    PROBE_TILE_LANES lanes."""
    return max(1, PROBE_TILE_LANES // max(width, 1))


def ivfpq_pool(q: torch.Tensor, centroids: torch.Tensor,
               lists: torch.Tensor, *, n_probe: int) -> torch.Tensor:
    """The coarse probe: the inverted lists of the n_probe nearest
    centroids (a stable sort: nearest first, the lower index on ties),
    pooled into int32 [q, n_probe*list_cap] candidate lanes (-1
    padded)."""
    dc = _sq_dists(q, centroids)
    probed = torch.sort(dc, dim=1, stable=True).indices[:, :n_probe]
    return lists[probed].reshape(q.shape[0], -1).to(torch.int32)


def ivfpq_probe(q: torch.Tensor, centroids: torch.Tensor,
                lists: torch.Tensor, codes: torch.Tensor,
                codebooks: torch.Tensor, *, n_probe: int, n_cand: int,
                backend: str = "auto") -> torch.Tensor:
    """The IVF-PQ probe, host and device routes alike: the coarse probe
    (`ivfpq_pool`), then the ADC ranking keeps the n_cand best ids of the
    pool. int32 [q, n_cand] (-1 padded). Rows are probed in tiles of
    `probe_tile_rows` rows."""
    tile = probe_tile_rows(n_probe * lists.shape[1])
    out = torch.empty((q.shape[0], n_cand), dtype=torch.int32,
                      device=q.device)
    for i in range(0, q.shape[0], tile):
        qb = q[i:i + tile]
        out[i:i + tile] = ops.adc_rank(
            qb, codebooks, ivfpq_pool(qb, centroids, lists, n_probe=n_probe),
            codes, n_cand=n_cand, backend=backend)
    return out


def ivfpq_state(join, device: torch.device) -> tuple:
    """An `IVFPQJoin`'s quantizer state on `device`, in `ivfpq_probe`'s
    argument order: (centroids, int32 lists, codes, codebooks)."""
    return (upload(join.centroids, device),
            upload(np.asarray(join.lists, np.int32), device),
            upload(join.codes, device), upload(join.codebooks, device))


def ivfpq_candidates(Q, centroids, lists, codes, codebooks, *, n_probe: int,
                     n_cand: int, device="cuda") -> np.ndarray:
    """Host entry: ADC-ranked candidate ids int32 [q, n_cand] (-1
    padded), through the same probe as the placed device probe, on
    `device` ("cuda" default, or "cpu")."""
    dev = resolve_device(device)
    Q = np.asarray(Q, np.float32)
    if len(Q) == 0:
        return np.empty((0, n_cand), np.int32)
    return ivfpq_probe(upload(Q, dev), upload(centroids, dev),
                       upload(np.asarray(lists, np.int32), dev),
                       upload(codes, dev), upload(codebooks, dev),
                       n_probe=n_probe, n_cand=n_cand).cpu().numpy()


# ================================================ specs + placed probes
class PlacedProbe:
    """A probe spec bound to one engine: tables uploaded to its device.
    `probe(qpos)` and `verify(...)` are separately dispatched, so the
    stream stages batch k+1's probing while batch k verifies."""

    def __init__(self, engine, *, name: str, probe_fn: Callable,
                 state: tuple, table_bytes: int, cand_width: int):
        self.engine = engine
        self.name = name
        self._probe_fn = probe_fn
        #: the uploaded tables, passed to the probe fn after the queries
        self.state = state
        #: probe-table bytes resident on the device (reported by
        #: `JoinPlan.describe()["exec"]["probe"]`)
        self.table_bytes_per_device = int(table_bytes)
        #: candidate ids produced per query
        self.cand_width = int(cand_width)

    def probe(self, qpos: torch.Tensor) -> torch.Tensor:
        """Compacted queries [n_pos, d] -> candidate ids [n_pos,
        cand_width] (-1 padded), all on device."""
        return self._probe_fn(qpos, *self.state)

    def verify(self, qpos: torch.Tensor, cand: torch.Tensor,
               idx: torch.Tensor, eps: float, *,
               out_rows: int) -> torch.Tensor:
        """Candidate verification against the engine's resident R, the
        counts scattered to rows `idx` of an int32 [out_rows] device
        tensor (the caller starts its readback)."""
        eng = self.engine
        found = verify_candidates_device(eng._Rdev, qpos, cand, eps,
                                         eng.metric)
        counts = torch.zeros((out_rows,), dtype=torch.int32,
                             device=eng.device)
        return counts.index_copy_(0, idx, found)


def _nbytes(state: tuple) -> int:
    return sum(t.numel() * t.element_size() for t in state if t is not None)


class LSHProbe:
    """Device-probe spec of `LSHJoin`: projection / bias / salt / member
    tables (and the re-bucket map) uploaded once; the gather runs by the
    engine's backend."""

    name = "lsh"

    def __init__(self, join):
        self.join = join

    def place(self, engine) -> PlacedProbe:
        """Upload the probe tables to the engine's device."""
        j = self.join
        state = lsh_state(j, engine.device)
        fn = functools.partial(lsh_probe, metric=j.metric, W=float(j.W),
                               n_probes=int(j.n_probes),
                               n_buckets=int(j.n_buckets),
                               backend=engine.backend)
        expand = state[4]
        fanout = 1 if expand is None else int(expand.shape[2])
        cand_width = j.l * j.n_probes * fanout * state[3].shape[2]
        return PlacedProbe(engine, name=self.name, probe_fn=fn, state=state,
                           table_bytes=_nbytes(state), cand_width=cand_width)


class IVFPQProbe:
    """Device-probe spec of `IVFPQJoin`: centroids / inverted lists / PQ
    codes / codebooks uploaded once; the ADC ranking runs by the engine's
    backend."""

    name = "ivfpq"

    def __init__(self, join):
        self.join = join

    def place(self, engine) -> PlacedProbe:
        """Upload the quantizer state to the engine's device."""
        j = self.join
        state = ivfpq_state(j, engine.device)
        n_cand = int(min(j.n_candidates, j.n_probe * state[1].shape[1]))
        fn = functools.partial(ivfpq_probe, n_probe=int(j.n_probe),
                               n_cand=n_cand, backend=engine.backend)
        return PlacedProbe(engine, name=self.name, probe_fn=fn, state=state,
                           table_bytes=_nbytes(state), cand_width=n_cand)


# ============================================== the adapter registry
#: Searcher type -> `builder(searcher, eps) -> spec | None` for searcher
#: classes that cannot grow a `device_probe` method themselves. Searchers
#: matching neither route keep the host probe path.
PROBE_BUILDERS: dict[type, Callable[[Any, Optional[float]], Any]] = {}


def register_probe(searcher_type: type, builder: Callable) -> None:
    """Register a device-probe builder for a searcher class."""
    PROBE_BUILDERS[searcher_type] = builder


def as_device_probe(searcher, eps: float | None = None):
    """Resolve a searcher's device-probe spec, or None for host-only
    searchers: the searcher's own `device_probe(eps)`, then the
    `PROBE_BUILDERS` registry walked over the class MRO. `eps` may be
    None (plan-build validation); the engine caches placement per
    returned spec."""
    fn = getattr(searcher, "device_probe", None)
    if fn is not None:
        return fn(eps)
    for cls in type(searcher).__mro__:
        builder = PROBE_BUILDERS.get(cls)
        if builder is not None:
            return builder(searcher, eps)
    return None
