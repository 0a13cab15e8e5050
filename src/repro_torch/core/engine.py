"""Device-resident batch-join execution engine: one device, R replicated.

The port's `repro/core/engine.py`, first cut: the replicated topology on
a single device, the exact verify, no mesh, delta shard or probes.

  * `JoinEngine` pins the (padded) index set R on its device once and runs
    every sweep against it: the ground-truth `cardinality_table`, the
    `range_count` of `NaiveJoin`, and the exact verify of `filtered_join`.
    Every sweep is the fused range-count kernel on the card
    (`kernels/range_count.py`), its plain version on the CPU.
  * `filtered_join` is the XJoin hot path. The filter stage runs the
    estimator forward (the fused MLP kernel), the XDT compare and the
    positive count on device; ONE host sync reads that count; the verify
    stage then compacts the positives (a stable sort of the verdicts —
    no further sync), range-counts only those rows at the single eps and
    scatters the counts back. Skipped queries cost nothing.
  * `stream` / `StreamSession` pipeline that path: batch k+1's filter is
    enqueued before batch k's count is read and batch k-1's verify is
    committed, results come back through pinned host buffers and CUDA
    events, and a `depth`-bounded in-flight queue caps memory; `flush()`
    is the drain barrier.

Host-sync accounting: every per-batch host synchronization is counted in
`JoinEngine.host_syncs` by kind — "n_pos" (the positive-count read) and
"result" (the counts readback). A streamed, device-filtered batch
performs exactly one of each.

Backends (`kernels/ops.py`): "auto" (the kernel on CUDA, the blocked
plain path on the CPU) or "ref" (the unblocked oracle over the raw R, the
bit-for-bit reference of the tests).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils import resolve_device


def _bucket_size(n: int, block: int) -> int:
    """Round n up to a bucketed multiple of block: power-of-two growth,
    refined with eighth steps once those are still block multiples
    (padding overshoot capped at 25%)."""
    if n <= block:
        return block
    b = block
    while b < n:
        b *= 2
    if b >= 8 * block:
        for eighths in (5, 6, 7):
            c = (b // 8) * eighths
            if c >= n:
                return c
    return b


def _pad_rows_np(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] >= n:
        return x
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad])


@dataclass
class EngineJoinResult:
    """Result of one filtered-join batch through the engine."""
    counts: np.ndarray      # int32 [n] neighbor counts (0 for skipped)
    n_searched: int         # queries that reached verification
    t_filter: float
    t_search: float
    verify: str = "exact"   # label of the backend that produced `counts`


#: Verification backends ported so far: the engine's exact sweep.
VERIFY_BACKENDS = ("exact",)


def _check_block(block) -> Optional[int]:
    if block is not None and (isinstance(block, bool) or block < 1
                              or not isinstance(block, (int, np.integer))):
        raise ValueError(f"block={block!r}: expected None or a positive int")
    return None if block is None else int(block)


def _check_verify(verify) -> str:
    if verify not in VERIFY_BACKENDS:
        raise ValueError(f"verify={verify!r} is not ported yet; ported: "
                         f"{list(VERIFY_BACKENDS)}")
    return verify


class _StagedBatch:
    """A batch whose queries are on device and whose filter is enqueued;
    `n_pos` stays None until its count is read."""
    __slots__ = ("Q", "n", "eps", "qdev", "pos_dev", "n_pos_dev", "n_pos",
                 "t_stage")


class PendingJoin:
    """A committed batch: verify enqueued, device->host copy running;
    `result()` is the only blocking point and is idempotent."""

    def __init__(self, finalize: Callable[[], np.ndarray], *, note,
                 verify: str, n_searched: int, t_filter: float,
                 t_dispatch: float):
        self._finalize = finalize
        self._note = note
        self._verify = verify
        self._n_searched = n_searched
        self._t_filter = t_filter
        self._t_dispatch = t_dispatch
        self._res: Optional[EngineJoinResult] = None

    def result(self) -> EngineJoinResult:
        """Materialize (blocking if the device is still busy)."""
        if self._res is None:
            t0 = time.perf_counter()
            self._note("result")
            counts = self._finalize()
            self._res = EngineJoinResult(
                counts, self._n_searched, self._t_filter,
                self._t_dispatch + (time.perf_counter() - t0), self._verify)
        return self._res


class StreamSession:
    """Pipelined serving session (push interface under `JoinEngine.stream`).

    Batches flow filter-staged -> counted -> committed: `submit(Q)` stages
    the new batch's filter, commits the counted batch's verify, reads the
    previously staged batch's positive count (the per-batch host sync, by
    then queued behind newer work), and returns the results forced out by
    the `depth` bound. Invariants:
      * results come back in submission order, bit-identical to per-batch
        `filtered_join` calls;
      * at most `depth` committed batches plus one counted and one staged
        batch are in flight;
      * a device-filtered batch performs exactly two host syncs, "n_pos"
        and "result";
      * after `flush()` returns, nothing of this session is outstanding.
    """

    def __init__(self, engine: "JoinEngine", eps: float, *, predict=None,
                 threshold=None, verify: str = "exact", depth: int = 2,
                 block: Optional[int] = None):
        self.engine = engine
        self.eps = float(eps)
        self.predict, self.threshold = predict, threshold
        self.verify = _check_verify(verify)
        self.block = block
        self.depth = max(int(depth), 0)
        self._staged: Optional[_StagedBatch] = None
        self._counted: Optional[_StagedBatch] = None
        self._inflight: collections.deque[PendingJoin] = collections.deque()

    def _commit_counted(self) -> None:
        if self._counted is not None:
            self._inflight.append(self.engine._commit_verify(
                self._counted, verify=self.verify, block=self.block))
            self._counted = None

    def _advance_staged(self) -> None:
        if self._staged is not None:
            self._counted = self.engine._read_n_pos(self._staged)
            self._staged = None

    def submit(self, Q, *, verdicts=None) -> list[EngineJoinResult]:
        """Feed one query batch; returns the (possibly empty) list of OLDER
        batches' results released under the depth bound. `verdicts`
        optionally carries precomputed host verdicts (plug-in filters)."""
        st = self.engine._stage_filter(
            Q, self.eps, predict=self.predict, threshold=self.threshold,
            verdicts=verdicts)
        self._commit_counted()              # batch k-1 enters verify
        self._advance_staged()              # batch k: count read
        self._staged = st
        out = []
        while len(self._inflight) > self.depth:
            out.append(self._inflight.popleft().result())
        return out

    def set_depth(self, depth: int) -> None:
        """Retarget the in-flight bound; takes effect on the next submit.
        Nothing is cancelled, so results stay FIFO and bit-identical."""
        self.depth = max(int(depth), 0)

    def flush(self) -> list[EngineJoinResult]:
        """Barrier: drain the pipeline, returning all remaining results in
        submission order. Safe to call repeatedly."""
        self._commit_counted()
        self._advance_staged()
        self._commit_counted()
        out = []
        while self._inflight:
            out.append(self._inflight.popleft().result())
        return out


#: query batches are staged in `_bucket_size` buckets of this many rows
BLOCK_Q = 256
#: R is padded with zero rows to a multiple of this (masked by nr_valid)
BLOCK_R = 512


class JoinEngine:
    """Device-resident exact join over a fixed index set R on one device.

    device: "cuda" (default) or "cpu"; a CUDA request without a GPU
    raises. backend: "auto" | "ref" (`kernels/ops.py`). R is padded to a
    BLOCK_R multiple with zero rows (masked exactly through nr_valid; the
    "ref" oracle sweeps the raw R) and pinned on the device once.

    block: the compaction quantum of the exact verify. None (default)
    verifies exactly the n_pos positives: the kernels take any row count,
    so there is no program cache to bound. An int rounds the verified
    rows up to `_bucket_size(n_pos, block)` as the reference does; the
    extra rows are swept and discarded, so the counts do not change."""

    def __init__(self, R, metric: str = "cosine", *, device="cuda",
                 backend: str = "auto", block: Optional[int] = None):
        if metric not in ("cosine", "l2"):
            raise ValueError(f"metric={metric!r}: expected 'cosine' or 'l2'")
        self.metric = metric
        self.device = resolve_device(device)
        self.backend = ops.check_backend(backend)
        self.block = _check_block(block)
        R = np.asarray(R, np.float32)
        self.nr, self.dim = R.shape
        self._R_host = R
        Rp = R if backend == "ref" else _pad_rows_np(
            R, -(-self.nr // BLOCK_R) * BLOCK_R)
        self.nr_padded = len(Rp)
        self._Rdev = self._upload(Rp)
        #: per-batch host syncs by kind ("n_pos", "result")
        self.host_syncs: collections.Counter = collections.Counter()

    # ------------------------------------------------------------- plumbing
    def _note_host_sync(self, kind: str) -> None:
        self.host_syncs[kind] += 1

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor (a copy). On the card the copy goes
        through pinned memory and does not block the host."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _start_host_copy(self, t: torch.Tensor) -> Callable[[], np.ndarray]:
        """Start the device->host copy of `t`; the returned callable waits
        for it and yields the numpy array."""
        if self.device.type != "cuda":
            return t.numpy
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def wait() -> np.ndarray:
            done.synchronize()
            return host.numpy()
        return wait

    def _pad_q(self, Q) -> np.ndarray:
        """Zero-pad a batch to its `_bucket_size` bucket of BLOCK_Q rows."""
        Q = np.asarray(Q, np.float32)
        return _pad_rows_np(Q, _bucket_size(max(len(Q), 1), BLOCK_Q))

    # ------------------------------------------------------- range counting
    def device_range_count_hist(self, Q, eps_grid) -> torch.Tensor:
        """The sweep of Q against R over eps_grid; returns the device
        tensor int32 [len(Q), m]."""
        q = self._upload(np.asarray(Q, np.float32))
        eps = self._upload(np.asarray(eps_grid, np.float32).reshape(-1))
        return ops.range_count_hist(q, self._Rdev, eps, metric=self.metric,
                                    backend=self.backend, nr_valid=self.nr)

    def range_count_hist(self, Q, eps_grid) -> np.ndarray:
        """counts[i, j] = #-neighbors of Q[i] in R within eps_grid[j]."""
        return self.device_range_count_hist(Q, eps_grid).cpu().numpy()

    def range_count(self, Q, eps: float) -> np.ndarray:
        """counts[i] = #-neighbors of Q[i] in R within a single eps."""
        return self.range_count_hist(Q, [float(eps)])[:, 0]

    def cardinality_table(self, points, eps_grid, *,
                          exclude_self: bool = False) -> np.ndarray:
        """Ground-truth target table over the eps grid (optionally with
        each point's self-match removed, for R-vs-R training tables)."""
        t = self.range_count_hist(points, eps_grid)
        if exclude_self:
            t = np.maximum(t - 1, 0)
        return t

    # --------------------------------------------- stage 1: filter dispatch
    def _stage_filter(self, Q, eps: float, *, predict=None, threshold=None,
                      verdicts=None) -> _StagedBatch:
        """Enqueue one batch's filter WITHOUT any host sync: upload the
        bucketed queries, then either the fused estimator forward + XDT
        compare + positive count (predict = (params, fn) and threshold),
        uploaded host verdicts, or no filter (every query positive)."""
        st = _StagedBatch()
        st.Q = np.asarray(Q, np.float32)
        st.n = len(st.Q)
        st.eps = float(eps)
        t0 = time.perf_counter()
        qp = self._pad_q(st.Q)
        st.qdev = self._upload(qp)
        if predict is None and verdicts is None:
            st.pos_dev = torch.zeros((len(qp),), dtype=torch.bool,
                                     device=self.device)
            st.pos_dev[:st.n] = True
            st.n_pos = st.n
        elif verdicts is not None:
            pos_host = np.zeros((len(qp),), bool)
            pos_host[:st.n] = np.asarray(verdicts, bool)
            st.n_pos = int(pos_host.sum())
            st.pos_dev = self._upload(pos_host)
        else:
            params, fn = predict
            X = torch.cat([st.qdev, torch.full((len(qp), 1), st.eps,
                                               dtype=torch.float32,
                                               device=self.device)], dim=1)
            preds = fn(params, X)
            # the threshold is compared in f32, as the reference casts it
            st.pos_dev = preds > float(np.float32(threshold))
            st.pos_dev[st.n:] = False
            st.n_pos_dev = st.pos_dev.sum(dtype=torch.int32)
            st.n_pos = None                 # read by _read_n_pos
        st.t_stage = time.perf_counter() - t0
        return st

    # ------------------------------------------ stage 2: the count read
    def _read_n_pos(self, st: _StagedBatch) -> _StagedBatch:
        """Read the staged batch's positive count: the pipeline's one
        per-batch host sync before the result, waiting on this batch's
        filter only."""
        t0 = time.perf_counter()
        if st.n_pos is None:
            self._note_host_sync("n_pos")
            st.n_pos = int(st.n_pos_dev)
        st.t_stage += time.perf_counter() - t0
        return st

    # ------------------------------------- stage 3: verify dispatch (commit)
    def _commit_verify(self, st: _StagedBatch, *, verify: str = "exact",
                       block: Optional[int] = None) -> PendingJoin:
        """Enqueue compact -> range count -> scatter for the positives and
        start the counts' readback. Compaction is a stable sort of the
        negated verdicts cut at the known n_pos (or its `block` bucket):
        positives first in index order, with no host sync."""
        label = _check_verify(verify)
        block = _check_block(block) or self.block
        self._read_n_pos(st)
        t_filter = st.t_stage
        n, n_pos = st.n, st.n_pos
        if n_pos == 0:
            return PendingJoin(lambda: np.zeros((n,), np.int32),
                               note=self._note_host_sync, verify=label,
                               n_searched=0, t_filter=t_filter,
                               t_dispatch=0.0)
        t1 = time.perf_counter()
        order = torch.argsort(torch.logical_not(st.pos_dev).to(torch.uint8),
                              stable=True)
        capacity = n_pos if block is None else min(
            _bucket_size(n_pos, block), len(order))
        idx = order[:capacity]
        qpos = st.qdev.index_select(0, idx)
        eps1 = torch.full((1,), st.eps, dtype=torch.float32, device=self.device)
        found = ops.range_count_hist(qpos, self._Rdev, eps1,
                                     metric=self.metric, backend=self.backend,
                                     nr_valid=self.nr)[:n_pos, 0]
        counts = torch.zeros((st.n,), dtype=torch.int32, device=self.device)
        # every positive index is < n; bucket rows past n_pos are dropped
        counts.index_copy_(0, idx[:n_pos], found)
        wait = self._start_host_copy(counts)
        return PendingJoin(wait, note=self._note_host_sync, verify=label,
                           n_searched=n_pos, t_filter=t_filter,
                           t_dispatch=time.perf_counter() - t1)

    # --------------------------------------------------- one-shot join call
    def filtered_join(self, Q, eps: float, *, predict=None, threshold=None,
                      verdicts=None, verify: str = "exact",
                      block: Optional[int] = None) -> EngineJoinResult:
        """One synchronous filter -> count read -> verify pass.

        Pass `predict` = (params, fn) from an estimator's
        `device_predict_fn()` plus the XDT `threshold` (fused path), or a
        host bool `verdicts` array (plug-in filters), or neither (every
        query is verified). `block` overrides the engine's compaction
        quantum. `stream` pipelines the same stages."""
        _check_verify(verify)
        st = self._stage_filter(Q, eps, predict=predict, threshold=threshold,
                                verdicts=verdicts)
        return self._commit_verify(st, verify=verify, block=block).result()

    # ------------------------------------------------------------ streaming
    def stream_session(self, eps: float, *, predict=None, threshold=None,
                       verify: str = "exact", depth: int = 2,
                       block: Optional[int] = None) -> StreamSession:
        """Open a `StreamSession` (push interface) over this engine."""
        return StreamSession(self, eps, predict=predict, threshold=threshold,
                             verify=verify, depth=depth, block=block)

    def stream(self, batches: Iterable, eps: float, *, predict=None,
               threshold=None, verify: str = "exact", depth: int = 2,
               block: Optional[int] = None) -> Iterator[EngineJoinResult]:
        """Serving loop: pipeline query batches through the engine; yields
        results in submission order, bit-identical to per-batch
        `filtered_join` calls. `depth=0` still keeps one staged batch of
        lookahead."""
        sess = self.stream_session(eps, predict=predict, threshold=threshold,
                                   verify=verify, depth=depth, block=block)
        for Q in batches:
            yield from sess.submit(Q)
        yield from sess.flush()


def sharded_range_count_hist(Q, R, eps_grid, *, metric: str = "cosine",
                             backend: str = "auto", device="cuda",
                             engine: "JoinEngine | None" = None) -> np.ndarray:
    """One-shot functional form of `JoinEngine.range_count_hist` (used by
    `data.groundtruth.cardinality_table`). A pre-built `engine=` over the
    same (R, metric) reuses its device-resident R; a mismatch raises."""
    if engine is not None:
        if (engine.metric != metric or engine.nr != len(R)
                or not (engine._R_host is R
                        or np.array_equal(engine._R_host,
                                          np.asarray(R, np.float32)))):
            raise ValueError(
                "sharded_range_count_hist(engine=...): engine is built over "
                f"a different (R, metric) — engine has |R|={engine.nr}/"
                f"{engine.metric!r}, call has |R|={len(R)}/{metric!r}")
        return engine.range_count_hist(Q, eps_grid)
    eng = JoinEngine(R, metric, device=device, backend=backend)
    return eng.range_count_hist(Q, eps_grid)
