"""PyTorch port, slice 2: Xling in front of LSH and IVF-PQ with the index
probe on the device, against the JAX package on the same inputs.

  * The joins: the port's own LSH build draws the same projections,
    biases and salts as the JAX package from the same seed; both built
    indexes reach the recall floors of tests/test_probe.py (lsh >= 0.90,
    ivfpq >= 0.95); an index carried across with `load_jax_index` gives
    the JAX searcher's candidates — exactly for LSH (rows with a
    projection within 1e-5 of a code boundary aside), for IVF-PQ up to
    the ADC rule of tests/test_torch_probe_kernels.py.
  * The slice, on the CPU: a filter fitted by the JAX package (carried by
    `XlingFilter.load`, i.e. `load_jax_state`) and the carried index, in
    `verify("lsh" | "ivfpq").on(probe="device")` and `search("lsh" |
    "ivfpq")` plans of both packages: the same queries skipped except for
    boundary verdicts, counts equal up to the candidate boundary-tie rule
    (tests/torch_parity.py). In the port: device and host probe routes
    agree, `stream` equals per-batch `run`, a device-probe batch makes
    exactly one "n_pos" and one "result" host sync, `probe="device"` with
    `verify("exact")` raises at build, and a retune evicts the stale
    placed probe.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as jutils
from repro.core import JoinPlan as JaxPlan
from repro.core import XlingConfig as JaxConfig
from repro.core import XlingFilter as JaxFilter
from repro.core.joins.ivfpq import IVFPQJoin as JaxIVFPQ
from repro.core.joins.lsh import LSHJoin as JaxLSH
from repro.data import load_dataset
from repro.kernels.lsh_gather import lsh_bucket_gather_jnp
from repro_torch.core import JoinEngine, JoinPlan, XlingFilter
from repro_torch.core.joins import LSHJoin, load_jax_index
from repro_torch.kernels.ref import count_mismatches
from torch_parity import (ADC_RTOL, adc64, assert_candidate_counts_match,
                          lsh_near_boundary)

LSH_PARAMS = dict(k=10, l=8, n_probes=4, W=2.5)
IVFPQ_PARAMS = dict(C=24, m=8, n_probe=8, n_candidates=600)
PARAMS = {"lsh": LSH_PARAMS, "ivfpq": IVFPQ_PARAMS}
PROBE_KNOBS = {"lsh": ("n_probes", "W"), "ivfpq": ("n_probe", "n_candidates")}
EPS_L2 = 0.4
EPS, TAU = 0.45, 3


@pytest.fixture(autouse=True)
def _check_indices(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CHECK_INDICES", "1")


def _jax_join(name, R, metric, **params):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # LSH overflow
        return {"lsh": JaxLSH, "ivfpq": JaxIVFPQ}[name](R, metric, **params)


def _carry(name, jj, R, metric):
    """The port's index over R with the JAX searcher's arrays."""
    if name == "lsh":
        arrays = dict(proj=jj.proj, bias=jj.bias, salt=jj.salt,
                      tables=jj.tables, expand=jj.expand,
                      n_buckets=jj.n_buckets, cap=jj.cap)
    else:
        arrays = dict(centroids=jj.centroids, lists=jj.lists, codes=jj.codes,
                      codebooks=jj.codebooks)
    knobs = {k: PARAMS[name][k] for k in PROBE_KNOBS[name]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return load_jax_index(name, R, metric, arrays, device="cpu", **knobs)


def _clean_rows(name, jj, Q, metric):
    """Rows whose LSH codes cannot differ between the packages."""
    if name != "lsh":
        return np.ones(len(Q), bool)
    edge = lsh_near_boundary(Q, jj.proj, jj.bias, metric, jj.W)
    return ~edge.any(axis=(1, 2))


def _jax_lsh_probe(jj, Q):
    """The JAX LSH device probe's candidates: the host probe's bucket ids
    (expanded when re-bucketed), gathered with repeated probes blanked."""
    pb = jj._probe_buckets(Q)
    if jj.expand is not None:
        pb = jj.expand[np.arange(jj.l)[None, :, None], pb].reshape(
            len(Q), jj.l, -1)
    return np.asarray(lsh_bucket_gather_jnp(jnp.asarray(jj.tables),
                                            jnp.asarray(pb, np.int32)))


def _adc_rule_rows(jj, Q, got, want):
    """Rows whose candidate id sets differ; each differing id must have an
    ADC value within ADC_RTOL of the row's n_cand-th value."""
    rows = []
    for i in range(len(Q)):
        g, w = set(got[i][got[i] >= 0]), set(want[i][want[i] >= 0])
        if g == w:
            continue
        rows.append(i)
        kth = np.sort(adc64(Q[i], jj.codebooks, jj.codes,
                             np.array(sorted(w), np.int64)))[-1]
        for idv in g ^ w:
            v = adc64(Q[i], jj.codebooks, jj.codes, np.array([idv]))[0]
            assert abs(v - kth) <= ADC_RTOL * max(1.0, abs(kth)), (i, idv)
    return rows


@pytest.fixture(scope="module")
def clustered():
    """The clustered corpus of tests/test_probe.py: enough true pairs that
    approximate recall is a stable number."""
    rng = np.random.default_rng(5)
    d, nc, spread = 32, 6, 0.03
    c = rng.normal(size=(nc, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)

    def draw(per):
        pts = (np.repeat(c, per, axis=0)
               + rng.normal(size=(nc * per, d)) * spread)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        return pts.astype(np.float32)

    return draw(150), draw(25)


@pytest.fixture(scope="module")
def jax_joins(clustered):
    R, _ = clustered
    joins = {name: _jax_join(name, R, "l2", **PARAMS[name])
             for name in PARAMS}
    joins["lsh-rebucket"] = _jax_join("lsh", R, "l2", rebucket_hot=2.0,
                                      **LSH_PARAMS)
    assert joins["lsh-rebucket"].expand is not None
    return joins


# ------------------------------------------------------------------ joins
def test_lsh_rebucketing_matches_jax(clustered, jax_joins):
    """`rebucket_hot=`: the port's copy of `split_hot_buckets` splits the
    same hot buckets into the same children, and a port-built re-bucketed
    index keeps the candidate sets of the plain one."""
    from repro.core import probe as jprobe
    from repro_torch.core import probe as tprobe
    R, Q = clustered
    jj = jax_joins["lsh"]
    buckets = jprobe.lsh_bucket_ids(
        jprobe.lsh_hash_codes(R, jj.proj, jj.bias, metric="l2", W=jj.W),
        jj.salt, jj.n_buckets)
    kw = dict(n_buckets=jj.n_buckets, hot_factor=2.0, max_fanout=8, seed=0)
    want = jprobe.split_hot_buckets(buckets, R, **kw)
    got = tprobe.split_hot_buckets(buckets, R, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plain = LSHJoin(R, "l2", device="cpu", cap=len(R), **LSH_PARAMS)
        split = LSHJoin(R, "l2", device="cpu", cap=len(R), rebucket_hot=2.0,
                        **LSH_PARAMS)
    assert split.expand is not None and split.overflow_frac == 0.0
    assert split.cap < plain.cap
    for a, b in zip(plain.candidates(Q), split.candidates(Q)):
        assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())


def test_lsh_build_draws_the_jax_hash_functions(clustered, jax_joins):
    R, _ = clustered
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tj = LSHJoin(R, "l2", device="cpu", **LSH_PARAMS)
    jj = jax_joins["lsh"]
    for attr in ("proj", "bias", "salt"):
        a, b = getattr(tj, attr), getattr(jj, attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tj.n_buckets, tj.cap) == (jj.n_buckets, jj.cap)
    assert abs(tj.overflow_frac - jj.overflow_frac) < 0.01


@pytest.mark.parametrize("name,floor", [("lsh", 0.90), ("ivfpq", 0.95)])
def test_port_built_index_recall_floor(clustered, name, floor):
    R, Q = clustered
    eng = JoinEngine(R, "l2", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng.verifier(name, **PARAMS[name])
    true = eng.range_count(Q, EPS_L2)
    res = eng.filtered_join(Q, EPS_L2, verify=name, probe="device")
    assert res.probe == "device"
    assert count_mismatches(res.counts, true, Q, R, [EPS_L2], "l2",
                            at_most=True)["ok"]
    assert res.counts.sum() / true.sum() >= floor


@pytest.mark.parametrize("key", ["lsh", "lsh-rebucket", "ivfpq"])
def test_carried_index_candidates_match_jax(clustered, jax_joins, key):
    R, Q = clustered
    jj = jax_joins[key]
    name = key.split("-")[0]
    tj = _carry(name, jj, R, "l2")
    want = _jax_lsh_probe(jj, Q) if name == "lsh" else jj.candidates(Q)
    got = tj.candidates(Q)
    assert got.dtype == np.int32 and got.shape == want.shape
    clean = _clean_rows(name, jj, Q, "l2")
    assert clean.mean() > 0.95
    if name == "lsh":
        np.testing.assert_array_equal(got[clean], want[clean])
        jhost = jj.candidates(Q)             # the JAX host probe: no dedup
        for a, b in zip(got[clean], jhost[clean]):
            assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
        assert tj.overflow_frac == pytest.approx(jj.overflow_frac, abs=1e-12)
    else:
        assert len(_adc_rule_rows(jj, Q, got, want)) <= 0.05 * len(Q)
    # the placed device probe yields the host probe's candidates
    eng = JoinEngine(R, "l2", device="cpu")
    placed = eng.device_probe_for(tj, "device")
    dev = placed.probe(torch.from_numpy(Q)).numpy()
    assert dev.shape == (len(Q), placed.cand_width)
    np.testing.assert_array_equal(dev, got)


# ------------------------------------------------------------------ slice
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probe_slice")
    with pytest.MonkeyPatch.context() as mp:     # a private corpus cache
        mp.setattr(jutils, "CACHE_DIR", str(tmp))
        R, S, spec = load_dataset("glove", n=1000, seed=0)
    cfg = JaxConfig(estimator="rmi", metric=spec.metric, m=20, epochs=2,
                    backend="jnp", estimator_kwargs=dict(widths=(32, 16)))
    jfilt = JaxFilter(cfg).fit(R)
    path = str(tmp / "xling.npz")
    jfilt.save(path)
    tfilt = XlingFilter.load(path, device="cpu")
    joins = {}
    for name in PARAMS:
        jj = _jax_join(name, R, spec.metric, **PARAMS[name])
        joins[name] = (jj, _carry(name, jj, R, spec.metric))
    return R, S, spec, jfilt, tfilt, joins


def _verdicts(plan, S):
    """The fused filter's verdicts and predictions of a built plan."""
    (params, fn), thr = plan._filter_state(EPS)
    X = np.concatenate([S, np.full((len(S), 1), EPS, np.float32)], axis=1)
    if isinstance(plan, JaxPlan):
        pred = np.asarray(jax.jit(fn)(params, jnp.asarray(X)))
    else:
        with torch.no_grad():
            pred = fn(params, torch.from_numpy(X)).numpy()
    return pred > np.float32(thr), pred, float(thr)


def _hold(world, name, jres, tres, jplan, tplan):
    R, S, spec, _, _, joins = world
    jj, tj = joins[name]
    jv, _, _ = _verdicts(jplan, S)
    tv, tpred, tthr = _verdicts(tplan, S)
    boundary = np.abs(tpred - tthr) <= 1e-4 * max(1.0, abs(tthr))
    assert not ((jv != tv) & ~boundary).any()
    assert 0 < tres.n_searched < len(S)          # the filter really filters
    assert (tres.counts[~tv] == 0).all() and (jres.counts[~jv] == 0).all()
    both = np.nonzero(jv & tv)[0]
    Qb = S[both]
    tc, jc = tj.candidates(Qb), jj.candidates(Qb)
    same = np.array([set(a[a >= 0]) == set(b[b >= 0])
                     for a, b in zip(tc, jc)])
    if name == "lsh":
        assert same[_clean_rows(name, jj, Qb, spec.metric)].all()
    else:
        assert len(_adc_rule_rows(jj, Qb, tc, jc)) == int((~same).sum())
    assert same.mean() > 0.95
    assert_candidate_counts_match(tres.counts[both][same],
                                  jres.counts[both][same], Qb[same], R,
                                  tc[same], EPS, spec.metric)


@pytest.mark.parametrize("name", ["lsh", "ivfpq"])
def test_verify_route_matches_jax_plan(world, name):
    R, S, spec, jfilt, tfilt, joins = world
    jj, tj = joins[name]
    jplan = (JaxPlan(R, spec.metric).filter(jfilt, tau=TAU, xdt="fpr")
             .search("naive").verify(jj).on(backend="jnp", probe="device"))
    tplan = (JoinPlan(R, spec.metric).filter(tfilt, tau=TAU, xdt="fpr")
             .search("naive").verify(tj).on(device="cpu", probe="device"))
    jres, tres = jplan.run(S, EPS), tplan.run(S, EPS)
    assert jres.meta["probe"] == tres.meta["probe"] == "device"
    _hold(world, name, jres, tres, jplan, tplan)


@pytest.mark.parametrize("name", ["lsh", "ivfpq"])
def test_search_route_matches_jax_plan(world, name):
    R, S, spec, jfilt, tfilt, joins = world
    jj, tj = joins[name]
    jplan = (JaxPlan(R, spec.metric).filter(jfilt, tau=TAU, xdt="fpr")
             .search(jj).on(backend="jnp"))
    tplan = (JoinPlan(R, spec.metric).filter(tfilt, tau=TAU, xdt="fpr")
             .search(tj).on(device="cpu"))
    jres, tres = jplan.run(S, EPS), tplan.run(S, EPS)
    assert tres.meta["probe"] == "device" and tres.meta["verify"] == name
    assert tplan.describe()["search"]["active"]
    _hold(world, name, jres, tres, jplan, tplan)


@pytest.mark.parametrize("name", ["lsh", "ivfpq"])
def test_device_and_host_probe_routes_agree(world, name):
    R, S, spec, _, tfilt, _ = world
    plans = {mode: (JoinPlan(R, spec.metric)
                    .filter(tfilt, tau=TAU, xdt="fpr").search(name,
                                                              **PARAMS[name])
                    .on(device="cpu", probe=mode))
             for mode in ("device", "host")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = {mode: p.run(S, EPS) for mode, p in plans.items()}
    assert out["device"].meta["probe"] == "device"
    assert out["host"].meta["probe"] == "host"
    np.testing.assert_array_equal(out["device"].counts, out["host"].counts)
    # and the base's own query_counts over the searched queries
    pos = out["device"].counts > 0
    base = plans["device"].base
    np.testing.assert_array_equal(base.query_counts(S[pos], EPS),
                                  out["device"].counts[pos])


@pytest.mark.parametrize("name", ["lsh", "ivfpq"])
def test_stream_bit_identical_to_run_and_two_syncs(world, name):
    R, S, spec, _, tfilt, joins = world
    plan = (JoinPlan(R, spec.metric).filter(tfilt, tau=TAU, xdt="fpr")
            .search("naive").verify(joins[name][1])
            .on(device="cpu", probe="device").build())
    batches = [S[:50], S[50:51], S[51:]]      # ragged batches
    sync = [plan.run(b, EPS) for b in batches]
    eng = plan.engine
    for depth in (0, 2):
        eng.host_syncs.clear()
        stream = list(plan.stream(batches, EPS, depth=depth))
        assert len(stream) == len(batches)
        for s, a in zip(sync, stream):
            np.testing.assert_array_equal(a.counts, s.counts)
            assert a.meta["probe"] == "device"
        assert dict(eng.host_syncs) == {"n_pos": 3, "result": 3}


def test_probe_device_with_exact_verify_raises_at_build(world):
    R, _, spec, _, tfilt, _ = world
    plan = (JoinPlan(R, spec.metric).filter(tfilt, tau=TAU)
            .search("naive").verify("exact").on(device="cpu", probe="device"))
    with pytest.raises(ValueError, match="no probe stage"):
        plan.build()
    with pytest.raises(ValueError, match="probe="):
        JoinPlan(R, spec.metric).on(device="cpu", probe="gpu").build()


def test_retune_evicts_the_stale_placed_probe(world):
    R, S, spec, _, tfilt, _ = world
    plan = (JoinPlan(R, spec.metric).filter(tfilt, tau=TAU, xdt="fpr")
            .search("naive").verify("lsh").on(device="cpu", probe="device"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        d = plan.describe()["exec"]["probe"]
        eng = plan.engine
        old = eng.verifier("lsh")
        assert d["resolved"] == "device" and d["table_bytes"] > 0
        assert d["cand_width"] == 10 * 4 * old.cap     # default l 10, p 4
        assert old.device_probe() in eng._probes
        new = eng.verifier("lsh", **LSH_PARAMS)
    assert new is not old and eng.verifier("lsh") is new
    assert old.device_probe() not in eng._probes
    res = plan.run(S, EPS)                    # the route follows the retune
    assert new.device_probe() in eng._probes and res.meta["probe"] == "device"
    assert res.meta["overflow_frac"] == new.overflow_frac


@pytest.mark.parametrize("name", ["lsh", "ivfpq"])
def test_registered_probe_builder_runs_the_given_kernel(clustered, jax_joins,
                                                        name, monkeypatch):
    """A searcher without `device_probe` gets its device probe from
    `PROBE_BUILDERS`; a spec of its own places a `PlacedProbe` over the
    index's uploaded state whose probe runs the plain kernel versions
    (chip_smoke.py's comparison route), and gives the same counts."""
    import functools

    from repro_torch.core.probe import (PROBE_BUILDERS, PlacedProbe,
                                        _lsh_pb, ivfpq_pool, register_probe)
    from repro_torch.kernels.adc_rank import adc_rank_plain
    from repro_torch.kernels.lsh_gather import lsh_bucket_gather_plain
    R, Q = clustered
    tj = _carry(name, jax_joins[name], R, "l2")
    calls = []

    def plain_lsh(qpos, proj, bias, salt, tables, expand):
        calls.append("lsh_bucket_gather_plain")
        return lsh_bucket_gather_plain(tables, _lsh_pb(
            qpos, proj, bias, salt, expand, metric=tj.metric, W=tj.W,
            n_probes=tj.n_probes, n_buckets=tj.n_buckets))

    def plain_ivfpq(q, centroids, lists, codes, codebooks, *, n_cand):
        calls.append("adc_rank_plain")
        pool = ivfpq_pool(q, centroids, lists, n_probe=tj.n_probe)
        return adc_rank_plain(q, codebooks, pool, codes, n_cand=n_cand)

    label = f"{name}-plain"

    class PlainSpec:
        name = label

        def place(self, engine):
            # the index's own placement, for its uploaded state
            ref = engine.device_probe_for(tj, "device")
            fn = (plain_lsh if name == "lsh" else
                  functools.partial(plain_ivfpq, n_cand=ref.cand_width))
            return PlacedProbe(engine, name=self.name, probe_fn=fn,
                               state=ref.state,
                               table_bytes=ref.table_bytes_per_device,
                               cand_width=ref.cand_width)

    class Plug:
        """Host probe only; the registry supplies the device probe."""

        def candidates(self, Qh):
            return tj.candidates(Qh)

    spec = PlainSpec()
    monkeypatch.setitem(PROBE_BUILDERS, Plug, None)   # removed afterwards
    register_probe(Plug, lambda searcher, eps: spec)
    eng = JoinEngine(R, "l2", device="cpu")
    got = eng.filtered_join(Q, EPS_L2, verify=Plug(), probe="device")
    want = eng.filtered_join(Q, EPS_L2, verify=tj, probe="device")
    assert got.probe == "device" and calls
    np.testing.assert_array_equal(got.counts, want.counts)
