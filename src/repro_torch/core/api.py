"""Protocol-first public join API: `JoinPlan` + the Filter contract —
the port's subset of `repro/core/api.py`.

    plan = (JoinPlan(R, "cosine")
            .filter("xling", tau=50, xdt="fpr")
            .search("naive")
            .on(device="cuda"))
    res = plan.run(Q, eps=0.45)
    for r in plan.stream(batches, eps=0.45, depth=2): ...

    plan = (JoinPlan(R, "cosine")
            .filter("xling", tau=50)
            .search("naive").verify("ivfpq")      # Xling in front of IVF-PQ
            .on(probe="device"))

Ported: `filter("xling" | "none" | XlingFilter | Filter object |
callable)`, `search("naive" | "lsh" | "ivfpq" | a Searcher over the
plan's R)`, `verify("auto" | "exact" | "lsh" | "ivfpq" | a Searcher
object)`, `on(backend=, block=, engine=, cache_key=, device=, probe=)`,
`build`, `run`, `stream`, `session`, `describe`. Every other
filter/search/verify value raises at `build()`.

The whole configuration is validated once at `build()`; the engine pins
R on its device once, and the XDT threshold is calibrated once per eps
through the estimator's device predict fn — the same fused kernel that
serves the filter.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Iterable, Iterator, Optional, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.core.engine import (PROBE_MODES, VERIFY_BACKENDS, JoinEngine,
                                     _check_block)
from repro_torch.core.joins import JOINS, make_join
from repro_torch.core.joins.naive import NaiveJoin
from repro_torch.core.xling import XlingConfig, XlingFilter


# =========================================================== the protocols
@runtime_checkable
class Filter(Protocol):
    """A query veto. Required: `verdicts(Q, eps) -> bool [q]` (host
    form). Optional: `device_filter(eps) -> (predict, threshold) | None`,
    the fused form the engine runs on device."""

    def verdicts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """bool [q]: True = search this query, False = skip it."""
        ...


@runtime_checkable
class Searcher(Protocol):
    """A join method over R. Required: `query_counts(Q, eps) -> int32
    [q]`, plus `.name` / `.exact` / `.metric` / `.R` attributes. Optional
    (the probe/verify split): `candidates(Q[, eps]) -> int32 [q, C]` (-1
    padded), which the engine verifies on device, and `device_probe(eps)
    -> spec | None`, which lets the engine probe on device too
    (`core/probe.py`)."""

    def query_counts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """int32 [q] neighbour counts of each query within eps."""
        ...


# ======================================================== filter adapters
class XlingAdapter:
    """`XlingFilter` on the Filter protocol: host verdicts via the
    estimator + XDT threshold, and the fused device form."""

    def __init__(self, filt: XlingFilter, *, tau: int = 0,
                 xdt_mode: Optional[str] = None,
                 fpr_tolerance: Optional[float] = None):
        self.filt = filt
        self.tau = int(tau)
        self.xdt_mode = xdt_mode
        self.fpr_tolerance = fpr_tolerance

    def verdicts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """Host-side verdicts: predicted count vs the XDT threshold."""
        pos, _ = self.filt.query(Q, eps, self.tau, mode=self.xdt_mode,
                                 fpr_tolerance=self.fpr_tolerance)
        return pos

    def device_filter(self, eps: float):
        """(predict, threshold) for the engine's filter stage; the XDT
        threshold is calibrated through the same device fn that will
        produce the online predictions (float parity at the boundary)."""
        predict = self.filt.estimator.device_predict_fn()
        threshold = self.filt.xdt(eps, self.tau, mode=self.xdt_mode,
                                  fpr_tolerance=self.fpr_tolerance,
                                  predict=predict)
        return predict, threshold


class CallableAdapter:
    """A bare `fn(Q, eps) -> bool [q]` on the Filter protocol (host-only)."""

    def __init__(self, fn: Callable[[np.ndarray, float], np.ndarray]):
        self.fn = fn
        self.tau = 0

    def verdicts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """Host-side verdicts from the wrapped callable."""
        return np.asarray(self.fn(Q, eps), bool)


#: Adapter registry: concrete filter type -> adapter factory.
FILTER_ADAPTERS: dict[type, Callable[..., Any]] = {
    XlingFilter: XlingAdapter,
}


def as_filter(obj, *, tau: int = 0, xdt_mode: Optional[str] = None,
              fpr_tolerance: Optional[float] = None):
    """Coerce `obj` onto the Filter protocol (None passes through):
    objects exposing `verdicts` as-is, registered types through their
    adapter (Xling adapters receive the tau/XDT knobs), other callables as
    `fn(Q, eps) -> bool [q]`. tau/XDT knobs on a filter that cannot honor
    them raise ValueError; anything else raises TypeError."""
    def _reject_knobs(kind: str):
        if tau or xdt_mode is not None or fpr_tolerance is not None:
            raise ValueError(
                f"filter options tau/xdt/fpr_tolerance do not apply to "
                f"{kind}: they parameterize the Xling XDT decision")

    if obj is None:
        return None
    if isinstance(obj, Filter):
        _reject_knobs(f"a prebuilt Filter object ({type(obj).__name__})")
        return obj
    for cls in type(obj).__mro__:
        adapt = FILTER_ADAPTERS.get(cls)
        if adapt is not None:
            return adapt(obj, tau=tau, xdt_mode=xdt_mode,
                         fpr_tolerance=fpr_tolerance)
    if callable(obj):
        _reject_knobs("a callable filter")
        return CallableAdapter(obj)
    raise TypeError(
        f"unsupported filter {type(obj).__name__}: expected an object with "
        "verdicts(Q, eps), an XlingFilter, or a callable fn(Q, eps) -> bool")


def _filter_label(f) -> Optional[str]:
    if f is None:
        return None
    for attr in ("filt", "fn"):
        inner = getattr(f, attr, None)
        if inner is not None:
            return type(inner).__name__
    return type(f).__name__


def _not_ported(kind: str, spec, ported) -> ValueError:
    name = spec if isinstance(spec, str) else type(spec).__name__
    return ValueError(f"{kind}({name!r}) is not ported yet; the PyTorch "
                      f"port supports {kind}({' | '.join(ported)})")


# ============================================================== the plan
@dataclass
class JoinResult:
    """Per-call join outcome: neighbor counts (0 for skipped queries) plus
    the filter/search timing split and provenance metadata."""
    counts: np.ndarray
    n_queries: int
    n_searched: int
    t_filter: float
    t_search: float
    meta: dict = field(default_factory=dict)

    @property
    def t_total(self) -> float:
        """Filter + search wall-clock for this call."""
        return self.t_filter + self.t_search

    def recall_vs(self, true_counts: np.ndarray) -> float:
        """Pair-level recall: found pairs over true pairs."""
        denom = float(np.sum(true_counts))
        if denom == 0:
            return 1.0
        return float(np.sum(np.minimum(self.counts, true_counts)) / denom)


@dataclass
class _BuiltPlan:
    engine: JoinEngine
    base: Any
    filter: Optional[Any]
    verify_route: Any                       # "exact" | name | Searcher
    verify_label: str
    placed_probe: Any = None                # PlacedProbe | None


def _spec_name(spec) -> str:
    """Display name of a filter/search/verify spec (string or instance)."""
    return spec if isinstance(spec, str) else type(spec).__name__


class JoinPlan:
    """Declarative, validated join configuration — the single entry point.

    Compose with `filter` / `search` / `verify` / `on`, then `run`,
    `stream`, `session`, or `describe`. `build()` runs implicitly on first
    use: it validates the whole configuration, pins R on the device via a
    `JoinEngine` (default device "cuda"), and fits a by-name filter with
    its ground-truth sweep on that engine."""

    _ON_KEYS = ("backend", "block", "engine", "cache_key", "device", "probe")

    def __init__(self, R: np.ndarray, metric: str = "cosine"):
        self._R = np.asarray(R, np.float32)
        self.metric = str(metric)
        self._filter_spec: tuple[Any, dict] = (None, {})
        self._search_spec: tuple[Any, dict] = ("naive", {})
        self._verify_spec: tuple[Any, dict] = ("auto", {})
        self._exec: dict = {"backend": "auto", "block": None, "engine": None,
                            "cache_key": None, "device": "cuda",
                            "probe": "auto"}
        self._built: Optional[_BuiltPlan] = None
        self._device_filter_cache: dict = {}

    # ------------------------------------------------------------ builders
    def filter(self, filt="xling", **opts) -> "JoinPlan":
        """Select the filter: "xling" (fitted on R at build time; `tau`,
        `xdt`/`xdt_mode`, `fpr_tolerance` plus any `XlingConfig` field as
        keywords), "none", a Filter-protocol object, an `XlingFilter`, or a
        callable `fn(Q, eps) -> bool [q]`."""
        self._filter_spec = (filt, dict(opts))
        self._built = None
        return self

    def search(self, method="naive", **params) -> "JoinPlan":
        """Select the base join: a registry name ("naive", "lsh", "ivfpq";
        params go to its constructor) or a Searcher instance built over
        this plan's R."""
        self._search_spec = (method, dict(params))
        self._built = None
        return self

    def verify(self, backend="auto", **params) -> "JoinPlan":
        """Select how positives are verified: "auto" (the exact sweep for
        the naive base; otherwise the base verifies its own positives —
        on device through its `candidates()` when it has them, by its own
        `query_counts()` when not), "exact" (the engine's brute-force
        sweep; naive base only), "lsh" / "ivfpq" (an engine-cached index;
        explicit params pin the built instance to this plan), or a
        Searcher instance. Naming a backend REPLACES the base's own
        verification; the filter still gates which queries reach it."""
        self._verify_spec = (backend, dict(params))
        self._built = None
        return self

    def on(self, **opts) -> "JoinPlan":
        """Set execution: `backend` ("auto" | "ref", `kernels/ops.py`),
        `block` (compaction quantum of the exact verify; None = exactly
        the positives, see `JoinEngine`), `engine` (share a prebuilt `JoinEngine` over the same R),
        `cache_key` (ground-truth table disk cache for the xling fit),
        `device` ("cuda" default, or "cpu"), `probe` ("auto" | "device" |
        "host": where the approximate verify route's index probe runs;
        "auto" picks the device whenever the searcher advertises
        `device_probe`, "device" requires it and fails at build without
        it)."""
        unknown = set(opts) - set(self._ON_KEYS)
        if unknown:
            raise ValueError(f"on(): unknown or not ported option(s) "
                             f"{sorted(unknown)}; expected {list(self._ON_KEYS)}")
        self._exec.update(opts)
        self._built = None
        return self

    # ---------------------------------------------------------- validation
    def _same_R(self, other_R) -> bool:
        other_R = np.asarray(other_R)
        if other_R is self._R:
            return True
        return (other_R.shape == self._R.shape
                and bool(np.array_equal(other_R, self._R)))

    def _build_base(self, engine: JoinEngine):
        spec, params = self._search_spec
        if isinstance(spec, str):
            if spec == "naive":
                return make_join("naive", self._R, self.metric,
                                 backend=self._exec["backend"], engine=engine,
                                 **params)
            if spec not in JOINS:
                raise _not_ported("search", spec,
                                  [repr(k) for k in JOINS] + ["Searcher"])
            return make_join(spec, self._R, self.metric,
                             **{"device": engine.device, **params})
        if not isinstance(spec, Searcher):
            raise ValueError(
                f"search({type(spec).__name__}): instance must satisfy the "
                "Searcher protocol (query_counts(Q, eps))")
        self._check_instance("search", spec)
        return spec

    def _check_instance(self, kind: str, spec) -> None:
        """A searcher instance must be built for this plan's metric and
        over this plan's R."""
        if getattr(spec, "metric", self.metric) != self.metric:
            raise ValueError(
                f"{kind}({type(spec).__name__}): instance is built for "
                f"metric {getattr(spec, 'metric')!r}, the plan for "
                f"{self.metric!r}")
        if not self._same_R(getattr(spec, "R", self._R)):
            raise ValueError(
                f"{kind}({type(spec).__name__}): instance is indexed over a "
                "different R than this plan")

    def _build_filter(self, engine: JoinEngine):
        spec, opts = self._filter_spec
        if spec is None or spec == "none":
            return None
        opts = dict(opts)
        tau = int(opts.pop("tau", 0))
        xdt_mode = opts.pop("xdt", opts.pop("xdt_mode", None))
        fpr_tolerance = opts.pop("fpr_tolerance", None)
        if tau < 0:
            raise ValueError(f"filter(tau={tau}): tau must be >= 0")
        if xdt_mode not in (None, "fpr", "mean"):
            raise ValueError(f"filter(xdt={xdt_mode!r}): expected 'fpr' or "
                             "'mean'")
        if fpr_tolerance is not None and not 0.0 < fpr_tolerance < 1.0:
            raise ValueError(f"filter(fpr_tolerance={fpr_tolerance}): "
                             "expected a rate in (0, 1)")
        if isinstance(spec, str):
            if spec != "xling":
                raise _not_ported("filter", spec,
                                  ["'xling'", "'none'", "XlingFilter",
                                   "Filter object", "callable"])
            cfg = XlingConfig(metric=self.metric, xdt_mode=xdt_mode or "fpr",
                              fpr_tolerance=(0.05 if fpr_tolerance is None
                                             else fpr_tolerance),
                              backend=self._exec["backend"],
                              device=str(engine.device), **opts)
            filt = XlingFilter(cfg).fit(
                self._R, cache_key=self._exec["cache_key"], engine=engine)
            return XlingAdapter(filt, tau=tau, xdt_mode=xdt_mode,
                                fpr_tolerance=fpr_tolerance)
        if opts:
            raise ValueError(f"filter(<instance>, **{sorted(opts)}): extra "
                             "constructor params only apply to by-name "
                             "filters")
        if isinstance(spec, XlingFilter) and spec.estimator is None:
            spec.fit(self._R, cache_key=self._exec["cache_key"], engine=engine)
        return as_filter(spec, tau=tau, xdt_mode=xdt_mode,
                         fpr_tolerance=fpr_tolerance)

    def _build_verify(self, engine: JoinEngine, base):
        """(route, label) of the verify spec: "exact", a VERIFY_BACKENDS
        name (or its pinned instance), or a Searcher object."""
        spec, params = self._verify_spec
        base_is_naive = isinstance(base, NaiveJoin)
        if spec == "auto":
            if params:
                raise ValueError("verify('auto') takes no params — name the "
                                 "backend to tune it")
            if base_is_naive:
                return "exact", "exact"
            return base, getattr(base, "name", type(base).__name__)
        if spec == "exact":
            if not base_is_naive:
                raise ValueError(
                    "verify('exact') is the engine's brute-force sweep and "
                    "only composes with search('naive'); with "
                    f"search({getattr(base, 'name', '?')!r}) use "
                    "verify('auto') (the base's own candidates) or name an "
                    "approximate backend")
            if params:
                raise ValueError("verify('exact') takes no params — it has "
                                 "no index to tune")
            return "exact", "exact"
        if isinstance(spec, str):
            if spec not in VERIFY_BACKENDS:
                raise _not_ported("verify", spec, [
                    "'auto'", "'exact'", "'lsh'", "'ivfpq'", "Searcher"])
            # build the index now, so its cost lands at build time. With
            # params the plan PINS the built instance; without, the NAME
            # stays the route and a later `engine.verifier(name, **p)`
            # retune takes effect
            v = engine.verifier(spec, **params)
            return (v if params else spec), spec
        if not (hasattr(spec, "candidates") or hasattr(spec, "query_counts")):
            raise ValueError(
                f"verify({type(spec).__name__}): instance must expose "
                "candidates(Q) -> int32 [q, C] (device verification) or "
                "query_counts(Q, eps) -> int32 [q] (host verification)")
        if params:
            raise ValueError(f"verify(<instance>, **{sorted(params)}): params "
                             "only apply to by-name backends")
        self._check_instance("verify", spec)
        return spec, getattr(spec, "name", type(spec).__name__)

    # -------------------------------------------------------------- build
    def build(self) -> "JoinPlan":
        """Validate the whole configuration and construct the engine, base
        and filter. Idempotent; called implicitly by run/stream/describe."""
        if self._built is not None:
            return self
        if self.metric not in ("cosine", "l2"):
            raise ValueError(f"metric={self.metric!r}: expected 'cosine' or "
                             "'l2'")
        _check_block(self._exec["block"])
        if self._exec["probe"] not in PROBE_MODES:
            raise ValueError(f"on(probe={self._exec['probe']!r}): expected "
                             f"one of {list(PROBE_MODES)}")
        engine = self._exec["engine"]
        spec = self._search_spec[0]
        if engine is None and isinstance(spec, NaiveJoin):
            engine = spec.engine            # adopt the base's pinned R
        if engine is not None:
            if engine.metric != self.metric or not self._same_R(engine._R_host):
                raise ValueError(
                    "on(engine=...): engine is built over a different "
                    f"(R, metric) — engine has |R|={engine.nr}/"
                    f"{engine.metric!r}, plan has |R|={len(self._R)}/"
                    f"{self.metric!r}")
        else:
            engine = JoinEngine(self._R, self.metric,
                                device=self._exec["device"],
                                backend=self._exec["backend"])
        base = self._build_base(engine)
        filt = self._build_filter(engine)
        route, label = self._build_verify(engine, base)
        # resolve the probe placement now: probe='device' with a route
        # that has no device probe fails HERE, and the table upload lands
        # at build time, not in batch 0
        placed = engine.device_probe_for(route, self._exec["probe"])
        self._built = _BuiltPlan(engine=engine, base=base, filter=filt,
                                 verify_route=route, verify_label=label,
                                 placed_probe=placed)
        self._device_filter_cache.clear()
        return self

    # ----------------------------------------------------------- execution
    def _filter_state(self, eps: float):
        """(predict, threshold) of the device filter at this eps, or
        (None, None) for host-only filters; cached per eps so XDT
        calibration is paid once per radius."""
        f = self._built.filter
        if f is None or not hasattr(f, "device_filter"):
            return None, None
        key = round(float(eps), 9)
        if key not in self._device_filter_cache:
            self._device_filter_cache[key] = f.device_filter(eps)
        return self._device_filter_cache[key]

    def _host_verdicts(self, Q: np.ndarray, eps: float):
        f = self._built.filter
        if f is None:
            return None                     # engine treats None as all-pos
        return np.asarray(f.verdicts(Q, eps), bool)

    def _route_searcher(self):
        """The searcher behind the verify route (None for the exact sweep;
        the engine-cached instance for a by-name route)."""
        route = self._built.verify_route
        if route == "exact":
            return None
        if isinstance(route, str):
            return self._built.engine.verifier(route)
        return route

    def _overflow_frac(self) -> Optional[float]:
        """The verify route's build-time candidate-loss budget
        (`LSHJoin.overflow_frac`), or None when the route has none."""
        frac = getattr(self._route_searcher(), "overflow_frac", None)
        return None if frac is None else float(frac)

    def _wrap(self, res, n: int, eps: float, t_host: float) -> JoinResult:
        st = self._built
        return JoinResult(
            counts=res.counts, n_queries=n, n_searched=res.n_searched,
            t_filter=res.t_filter + t_host, t_search=res.t_search,
            meta={"eps": eps, "tau": getattr(st.filter, "tau", 0),
                  "base": getattr(st.base, "name", "?"),
                  "filter": _filter_label(st.filter),
                  "engine": True, "verify": res.verify, "probe": res.probe,
                  "overflow_frac": self._overflow_frac(),
                  "device": str(st.engine.device)})

    def run(self, Q: np.ndarray, eps: float) -> JoinResult:
        """One synchronous join pass: device filter (or host verdicts) ->
        count read -> compact -> (probe ->) verify through the engine."""
        self.build()
        Q = np.asarray(Q, np.float32)
        t0 = time.perf_counter()
        predict, threshold = self._filter_state(eps)
        verdicts = None if predict is not None else self._host_verdicts(Q, eps)
        t_host = time.perf_counter() - t0
        res = self._built.engine.filtered_join(
            Q, float(eps), predict=predict, threshold=threshold,
            verdicts=verdicts, block=self._exec["block"],
            verify=self._built.verify_route, probe=self._exec["probe"])
        return self._wrap(res, len(Q), eps, t_host)

    def stream(self, batches: Iterable[np.ndarray], eps: float, *,
               depth: Optional[int] = None) -> Iterator[JoinResult]:
        """Serving form: one JoinResult per query batch, in order, through
        the engine's pipeline (`depth` bounds the in-flight queue, default
        2). Bit-identical to per-batch `run`."""
        sess = self.session(eps, depth=depth)
        for Q in batches:
            yield from sess.submit(Q)
        yield from sess.flush()

    def session(self, eps: float, *,
                depth: Optional[int] = None) -> "PlanSession":
        """Open a push-interface serving session at a fixed radius."""
        return PlanSession(self, eps, depth=2 if depth is None else depth)

    # ---------------------------------------------------------- inspection
    def describe(self) -> dict:
        """Serializable plan summary (spec + resolved execution state)."""
        self.build()
        st = self._built

        def scalars(d: dict) -> dict:
            return {k: (v.item() if isinstance(v, np.generic) else v)
                    for k, v in d.items()
                    if isinstance(v, (int, float, str, bool, np.generic))}

        fspec, fopts = self._filter_spec
        sspec, sparams = self._search_spec
        vspec, vparams = self._verify_spec
        name = _spec_name
        placed = st.placed_probe
        return {
            "metric": self.metric,
            "n_index": int(len(self._R)),
            "dim": int(self._R.shape[1]),
            "filter": {"spec": name(fspec) if fspec is not None else None,
                       "resolved": _filter_label(st.filter),
                       "tau": getattr(st.filter, "tau", 0),
                       "opts": scalars(fopts)},
            "search": {"spec": name(sspec),
                       "resolved": getattr(st.base, "name",
                                           type(st.base).__name__),
                       "exact": bool(getattr(st.base, "exact", False)),
                       # False when a named verify backend bypasses the
                       # base's own verification
                       "active": (st.verify_route is st.base
                                  or (st.verify_route == "exact"
                                      and isinstance(st.base, NaiveJoin))),
                       "params": scalars(sparams)},
            "verify": {"spec": name(vspec), "resolved": st.verify_label,
                       "params": scalars(vparams),
                       "overflow_frac": self._overflow_frac()},
            "exec": {"backend": st.engine.backend,
                     "block": self._exec["block"],
                     "device": str(st.engine.device),
                     "engine_shared": self._exec["engine"] is not None,
                     "r_bytes": int(st.engine.nr_padded * st.engine.dim * 4),
                     # where the verify route's index probe runs: "device"
                     # with its table bytes and candidate width, "host"
                     # for probing routes without a device probe, None for
                     # the exact sweep (no probe stage)
                     "probe": {
                         "mode": self._exec["probe"],
                         "resolved": (
                             "device" if placed is not None
                             else ("host" if self._route_searcher()
                                   is not None else None)),
                         "table_bytes": (None if placed is None else
                                         placed.table_bytes_per_device),
                         "cand_width": (None if placed is None else
                                        placed.cand_width),
                         "overflow_frac": self._overflow_frac()}},
        }

    @property
    def engine(self) -> JoinEngine:
        """The plan's `JoinEngine` (builds the plan on first access)."""
        return self.build()._built.engine

    @property
    def base(self):
        """The plan's base join (builds the plan on first access)."""
        return self.build()._built.base


class PlanSession:
    """Caller-driven serving session over a built `JoinPlan` at one radius:
    the push form of `stream`. `submit(Q)` returns the (possibly empty)
    list of OLDER batches' `JoinResult`s released under the depth bound;
    `flush()` is the drain barrier. Results are FIFO and bit-identical to
    per-batch `JoinPlan.run`."""

    def __init__(self, plan: JoinPlan, eps: float, *, depth: int = 2):
        plan.build()
        self._plan = plan
        self.eps = float(eps)
        t0 = time.perf_counter()
        self._predict, self._threshold = plan._filter_state(eps)
        self._t_host = time.perf_counter() - t0  # one-time XDT selection
        self._sess = plan._built.engine.stream_session(
            eps, predict=self._predict, threshold=self._threshold,
            verify=plan._built.verify_route, depth=depth,
            block=plan._exec["block"], probe=plan._exec["probe"])
        self._pending: list[tuple[int, float]] = []  # FIFO (n, host cost)

    def _emit(self, results) -> list[JoinResult]:
        out = []
        for res in results:
            n, th = self._pending.pop(0)
            out.append(self._plan._wrap(res, n, self.eps, th))
        return out

    def submit(self, Q: np.ndarray) -> list[JoinResult]:
        """Feed one query batch; returns older batches' results released
        under the depth bound (host filter verdicts are computed here when
        the filter has no device form)."""
        Q = np.asarray(Q, np.float32)
        t1 = time.perf_counter()
        verdicts = (None if self._predict is not None
                    else self._plan._host_verdicts(Q, self.eps))
        th = self._t_host + (time.perf_counter() - t1)
        self._t_host = 0.0              # charge XDT selection to batch 0
        self._pending.append((len(Q), th))
        return self._emit(self._sess.submit(Q, verdicts=verdicts))

    def flush(self) -> list[JoinResult]:
        """Drain barrier: all remaining results, in submission order."""
        return self._emit(self._sess.flush())

    def set_depth(self, depth: int) -> None:
        """Retarget the in-flight bound; takes effect on the next submit."""
        self._sess.set_depth(depth)

    @property
    def depth(self) -> int:
        """The current in-flight bound."""
        return self._sess.depth
