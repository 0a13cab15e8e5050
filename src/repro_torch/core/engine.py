"""Device-resident batch-join execution engine: one device, R replicated.

The port's `repro/core/engine.py`: the replicated topology on a single
device, the exact verify and the approximate verify routes ("lsh",
"ivfpq", or a plug-in searcher) with their index probe on the device or
on the host; no mesh, ring, delta shard or tombstones.

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
  * Approximate verification (`verify="lsh" | "ivfpq"`, or a Searcher
    object): the positives' candidates come from an index probe and are
    verified exactly (`joins/common.py`). With a device probe
    (`probe="device"`, or "auto" when the searcher advertises one —
    `core/probe.py`) the probe stage, right after the count read,
    compacts the positives and runs the probe on device (the LSH gather
    and ADC ranking kernels); the commit verifies the candidates and
    scatters the counts, with no host hop. The host probe reads the
    verdicts back, probes on the host and verifies on device.
  * `stream` / `StreamSession` pipeline these paths: batch k+1's filter
    is enqueued before batch k's count is read (and, on a device-probe
    route, its probe dispatched) and batch k-1's verify is committed;
    results come back through pinned host buffers and CUDA events, and a
    `depth`-bounded in-flight queue caps memory; `flush()` is the drain
    barrier.

Host-sync accounting: every per-batch host synchronization is counted in
`JoinEngine.host_syncs` by kind — "n_pos" (the positive-count read),
"result" (the counts readback), and on host-probe routes "verdicts"
(the verdict readback) and "probe" (the host probe). A streamed,
device-filtered batch on the exact or a device-probe route performs
exactly one "n_pos" and one "result".

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
from repro_torch.utils import resolve_device, start_host_copy, upload


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
    probe: Optional[str] = None   # "device" | "host" | None (exact sweep)


#: Verification backends accepted by name: "exact" is the engine's fused
#: sweep; "lsh" / "ivfpq" probe an engine-cached approximate index and
#: verify its candidates on device. `verify=` also takes a Searcher
#: object: one with `candidates(Q)` routes its candidates through the
#: device verification, one with only `query_counts(Q, eps)` verifies
#: the compacted positives itself on the host.
VERIFY_BACKENDS = ("exact", "lsh", "ivfpq")

#: Probe placement modes: "auto" probes on device whenever the route's
#: searcher advertises a device probe (`device_probe` /
#: `probe.PROBE_BUILDERS`), "device" requires one (and fails at
#: construction without it), "host" forces the host probe.
PROBE_MODES = ("auto", "device", "host")


def _check_block(block) -> Optional[int]:
    if block is not None and (isinstance(block, bool) or block < 1
                              or not isinstance(block, (int, np.integer))):
        raise ValueError(f"block={block!r}: expected None or a positive int")
    return None if block is None else int(block)


def _check_verify(verify) -> str:
    """Validate a `verify=` spec and return its label: a VERIFY_BACKENDS
    name, or a searcher object with `candidates(Q)` or
    `query_counts(Q, eps)`."""
    if isinstance(verify, str):
        if verify not in VERIFY_BACKENDS:
            raise ValueError(f"verify={verify!r}: expected one of "
                             f"{list(VERIFY_BACKENDS)} or a searcher object "
                             "exposing candidates()/query_counts()")
        return verify
    if hasattr(verify, "candidates") or hasattr(verify, "query_counts"):
        return getattr(verify, "name", type(verify).__name__)
    raise ValueError(
        f"verify={type(verify).__name__!r} object: plug-in verification "
        "searchers must expose candidates(Q) -> int32 [q, C] (-1 padded) "
        "or query_counts(Q, eps) -> int32 [q]")


class _StagedBatch:
    """A batch whose queries are on device and whose filter is enqueued;
    `n_pos` stays None until its count is read. On a device-probe route
    `_stage_probe` also fills `qpos_dev` / `idx_dev` / `cand_dev` and sets
    `probe` to the placed probe that produced them."""
    __slots__ = ("Q", "n", "eps", "qdev", "pos_dev", "n_pos_dev", "n_pos",
                 "t_stage", "probe", "qpos_dev", "idx_dev", "cand_dev")


class PendingJoin:
    """A committed batch: verify enqueued, device->host copy running;
    `result()` is the only blocking point and is idempotent."""

    def __init__(self, finalize: Callable[[], np.ndarray], *, note,
                 verify: str, n_searched: int, t_filter: float,
                 t_dispatch: float, probe: Optional[str] = None):
        self._finalize = finalize
        self._note = note
        self._verify = verify
        self._probe = probe
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
                self._t_dispatch + (time.perf_counter() - t0), self._verify,
                self._probe)
        return self._res


class StreamSession:
    """Pipelined serving session (push interface under `JoinEngine.stream`).

    Batches flow filter-staged -> probe-staged -> committed: `submit(Q)`
    stages the new batch's filter, commits the probe-staged batch's
    verify, reads the previously staged batch's positive count (the
    per-batch host sync, by then queued behind newer work) and, on a
    device-probe route, dispatches its probe, and returns the results
    forced out by the `depth` bound. Invariants:
      * results come back in submission order, bit-identical to per-batch
        `filtered_join` calls;
      * at most `depth` committed batches plus one probe-staged and one
        filter-staged batch are in flight;
      * a device-filtered batch on the exact or a device-probe route
        performs exactly two host syncs, "n_pos" and "result";
      * after `flush()` returns, nothing of this session is outstanding.
    """

    def __init__(self, engine: "JoinEngine", eps: float, *, predict=None,
                 threshold=None, verify="exact", depth: int = 2,
                 block: Optional[int] = None, probe: str = "auto"):
        _check_verify(verify)
        # resolve the probe route up front: probe="device" without a
        # device-capable searcher fails here, never mid-stream
        self._placed = engine.device_probe_for(verify, probe, eps=eps)
        self.engine = engine
        self.eps = float(eps)
        self.predict, self.threshold = predict, threshold
        self.verify = verify
        self.block = block
        self.depth = max(int(depth), 0)
        self._staged: Optional[_StagedBatch] = None
        self._probed: Optional[_StagedBatch] = None
        self._inflight: collections.deque[PendingJoin] = collections.deque()

    def _commit_probed(self) -> None:
        if self._probed is not None:
            self._inflight.append(self.engine._commit_verify(
                self._probed, verify=self.verify, block=self.block))
            self._probed = None

    def _advance_staged(self) -> None:
        if self._staged is not None:
            self._probed = self.engine._stage_probe(self._staged,
                                                    placed=self._placed)
            self._staged = None

    def submit(self, Q, *, verdicts=None) -> list[EngineJoinResult]:
        """Feed one query batch; returns the (possibly empty) list of OLDER
        batches' results released under the depth bound. `verdicts`
        optionally carries precomputed host verdicts (plug-in filters)."""
        st = self.engine._stage_filter(
            Q, self.eps, predict=self.predict, threshold=self.threshold,
            verdicts=verdicts)
        self._commit_probed()               # batch k-1 enters verify
        self._advance_staged()              # batch k: count read + probe
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
        self._commit_probed()
        self._advance_staged()
        self._commit_probed()
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
        #: per-batch host syncs by kind ("n_pos", "result", "verdicts",
        #: "probe")
        self.host_syncs: collections.Counter = collections.Counter()
        self._verifiers: dict = {}  # name -> engine-cached searcher
        self._probes: dict = {}     # probe spec -> PlacedProbe

    # ------------------------------------------------------------- plumbing
    def _note_host_sync(self, kind: str) -> None:
        self.host_syncs[kind] += 1

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device (a copy)."""
        return upload(x, self.device)

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
            st.n_pos = None                 # read by _stage_probe
        st.probe = None
        st.t_stage = time.perf_counter() - t0
        return st

    # ------------------------------------------- stage 2: probe dispatch
    def device_probe_for(self, verify, mode: str = "auto", *,
                         eps: Optional[float] = None):
        """Resolve the device-probe route of a verify spec.

        mode="host" returns None (host probing); "auto" returns a placed
        probe when the route's searcher advertises one
        (`device_probe(eps)` / `probe.PROBE_BUILDERS`) and None otherwise;
        "device" REQUIRES one and raises ValueError when the route has no
        probe stage (the exact sweep, query_counts-only plug-ins) or the
        searcher is host-only — at construction time, not mid-stream.
        Placement (the table upload) is cached per returned spec."""
        if mode not in PROBE_MODES:
            raise ValueError(f"probe={mode!r}: expected one of "
                             f"{list(PROBE_MODES)}")
        if mode == "host":
            return None
        label = _check_verify(verify)
        searcher = None
        if isinstance(verify, str):
            if verify != "exact":
                searcher = self.verifier(verify)
        elif hasattr(verify, "candidates"):
            searcher = verify
        if searcher is None:
            if mode == "device":
                raise ValueError(
                    f"probe='device': verify={label!r} has no probe stage "
                    "(the exact sweep and query_counts-only plug-ins "
                    "produce no candidates); use probe='auto'|'host' or an "
                    "approximate searcher")
            return None
        from repro_torch.core.probe import as_device_probe
        spec = as_device_probe(searcher, eps)
        if spec is None:
            if mode == "device":
                raise ValueError(
                    f"probe='device': searcher {label!r} exposes no device "
                    "probe — implement device_probe(eps) or register a "
                    "builder in probe.PROBE_BUILDERS; probe='auto' falls "
                    "back to host probing")
            return None
        placed = self._probes.get(spec)
        if placed is None:
            placed = self._probes[spec] = spec.place(self)
        return placed

    def _stage_probe(self, st: _StagedBatch, *, placed=None) -> _StagedBatch:
        """Stage 2: read the staged batch's positive count (the pipeline's
        one per-batch host sync before the result, waiting on this batch's
        filter only) and, on a device-probe route, compact the positives
        (a stable sort of the verdicts, no sync) and dispatch the probe,
        so the candidates are made on device while the PREVIOUS batch
        still verifies. Host-probe routes only read the count here."""
        t0 = time.perf_counter()
        self._read_n_pos(st)
        st.probe = placed                   # the route, even if this batch
        if placed is not None and st.n_pos > 0:     # stages nothing
            st.idx_dev = self._positives(st)[:st.n_pos]
            st.qpos_dev = st.qdev.index_select(0, st.idx_dev)
            st.cand_dev = placed.probe(st.qpos_dev)
        st.t_stage += time.perf_counter() - t0
        return st

    def _read_n_pos(self, st: _StagedBatch) -> None:
        """The "n_pos" host sync: read the staged batch's positive count
        (once)."""
        if st.n_pos is None:
            self._note_host_sync("n_pos")
            st.n_pos = int(st.n_pos_dev)

    def _positives(self, st: _StagedBatch) -> torch.Tensor:
        """Row indices of the padded batch, positives first in index order
        (a stable sort of the negated verdicts: no host sync)."""
        return torch.argsort(torch.logical_not(st.pos_dev).to(torch.uint8),
                             stable=True)

    # ------------------------------------- stage 3: verify dispatch (commit)
    def _commit_verify(self, st: _StagedBatch, *, verify="exact",
                       block: Optional[int] = None) -> PendingJoin:
        """Enqueue the batch's verification and start the counts'
        readback.

        Exact: compact -> range count -> scatter for the positives, cut at
        the known n_pos (or its `block` bucket). Device probe: verify the
        candidates `_stage_probe` made and scatter. Host probe: read the
        verdicts back ("verdicts"), probe on the host ("probe") and verify
        on device — or, for a query_counts-only plug-in, let it count the
        compacted positives itself."""
        label = _check_verify(verify)
        block = _check_block(block) or self.block
        t0 = time.perf_counter()
        self._read_n_pos(st)                # direct callers skipped stage 2
        t_filter = st.t_stage + (time.perf_counter() - t0)
        n, n_pos = st.n, st.n_pos
        probe_label = None if verify == "exact" else (
            "device" if st.probe is not None else "host")
        if n_pos == 0:
            return PendingJoin(lambda: np.zeros((n,), np.int32),
                               note=self._note_host_sync, verify=label,
                               n_searched=0, t_filter=t_filter,
                               t_dispatch=0.0, probe=probe_label)
        t1 = time.perf_counter()
        if verify == "exact":
            order = self._positives(st)
            capacity = n_pos if block is None else min(
                _bucket_size(n_pos, block), len(order))
            idx = order[:capacity]
            qpos = st.qdev.index_select(0, idx)
            eps1 = torch.full((1,), st.eps, dtype=torch.float32,
                              device=self.device)
            found = ops.range_count_hist(qpos, self._Rdev, eps1,
                                         metric=self.metric,
                                         backend=self.backend,
                                         nr_valid=self.nr)[:n_pos, 0]
            counts = torch.zeros((n,), dtype=torch.int32, device=self.device)
            # every positive index is < n; bucket rows past n_pos are dropped
            counts.index_copy_(0, idx[:n_pos], found)
            finalize = start_host_copy(counts)
        elif st.probe is not None:
            # device-probe route: the candidates are on device already
            counts = st.probe.verify(st.qpos_dev, st.cand_dev, st.idx_dev,
                                     st.eps, out_rows=n)
            finalize = start_host_copy(counts)
        else:
            finalize = self._host_probe_verify(st, verify, label)
        return PendingJoin(finalize, note=self._note_host_sync, verify=label,
                           n_searched=n_pos, t_filter=t_filter,
                           t_dispatch=time.perf_counter() - t1,
                           probe=probe_label)

    def _host_probe_verify(self, st: _StagedBatch, verify, label: str):
        """The host-probe route of one batch: verdict readback, host probe,
        device verify. Returns the finalize callable of its counts."""
        from repro_torch.core.joins.common import (dispatch_verify_candidates,
                                                   searcher_candidates)
        searcher = self.verifier(verify) if isinstance(verify, str) else verify
        n = st.n
        self._note_host_sync("verdicts")
        idx = np.nonzero(st.pos_dev[:n].cpu().numpy())[0]
        qpos = st.Q[idx]
        if hasattr(searcher, "candidates"):
            self._note_host_sync("probe")
            cand = searcher_candidates(searcher, qpos, st.eps)
            pend = dispatch_verify_candidates(self._Rdev, qpos, cand, st.eps,
                                              self.metric)
            found_fn = pend.result
        else:
            # candidate-less plug-in: the searcher counts the compacted
            # positives itself (a synchronous host hop)
            self._note_host_sync("probe")
            found = np.asarray(searcher.query_counts(qpos, st.eps), np.int32)
            found_fn = lambda: found             # noqa: E731

        def finalize() -> np.ndarray:
            counts = np.zeros((n,), np.int32)
            counts[idx] = found_fn()
            return counts
        return finalize

    # ------------------------------------------------ verification backends
    def verifier(self, name: str, **params):
        """The approximate searcher behind `verify=name`, built lazily over
        the engine's host R on its device and cached per name, so a
        serving session pays the index build once. Calling with `params`
        always (re)builds the index with them and replaces the cached one,
        dropping the stale index's placed probe (the retune hook); without
        params it returns the cached index, built with defaults on first
        use."""
        if name not in VERIFY_BACKENDS or name == "exact":
            raise ValueError(
                f"verifier={name!r}: expected an approximate backend "
                f"({sorted(set(VERIFY_BACKENDS) - {'exact'})}; 'exact' is "
                "the fused sweep — it has no index to build)")
        v = None if params else self._verifiers.get(name)
        if v is None:
            from repro_torch.core.joins import make_join  # circular at import
            stale = self._verifiers.get(name)
            if stale is not None:
                # a retune replaces the index: drop the old searcher's
                # placed probe too, or its tables stay on the device
                self._probes.pop(getattr(stale, "_probe_spec", None), None)
            v = make_join(name, self._R_host, self.metric,
                          **{"device": self.device, **params})
            self._verifiers[name] = v
        return v

    # --------------------------------------------------- one-shot join call
    def filtered_join(self, Q, eps: float, *, predict=None, threshold=None,
                      verdicts=None, verify="exact",
                      block: Optional[int] = None,
                      probe: str = "auto") -> EngineJoinResult:
        """One synchronous filter -> count read (+ probe) -> verify pass.

        Pass `predict` = (params, fn) from an estimator's
        `device_predict_fn()` plus the XDT `threshold` (fused path), or a
        host bool `verdicts` array (plug-in filters), or neither (every
        query is verified). `verify` is "exact", "lsh", "ivfpq" or a
        Searcher object; `probe` ("auto" | "device" | "host") places the
        approximate route's index probe. `block` overrides the engine's
        compaction quantum. `stream` pipelines the same stages."""
        placed = self.device_probe_for(verify, probe, eps=eps)
        st = self._stage_filter(Q, eps, predict=predict, threshold=threshold,
                                verdicts=verdicts)
        self._stage_probe(st, placed=placed)
        return self._commit_verify(st, verify=verify, block=block).result()

    # ------------------------------------------------------------ streaming
    def stream_session(self, eps: float, *, predict=None, threshold=None,
                       verify="exact", depth: int = 2,
                       block: Optional[int] = None,
                       probe: str = "auto") -> StreamSession:
        """Open a `StreamSession` (push interface) over this engine."""
        return StreamSession(self, eps, predict=predict, threshold=threshold,
                             verify=verify, depth=depth, block=block,
                             probe=probe)

    def stream(self, batches: Iterable, eps: float, *, predict=None,
               threshold=None, verify="exact", depth: int = 2,
               block: Optional[int] = None,
               probe: str = "auto") -> Iterator[EngineJoinResult]:
        """Serving loop: pipeline query batches through the engine; yields
        results in submission order, bit-identical to per-batch
        `filtered_join` calls. `depth=0` still keeps one staged batch of
        lookahead."""
        sess = self.stream_session(eps, predict=predict, threshold=threshold,
                                   verify=verify, depth=depth, block=block,
                                   probe=probe)
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
