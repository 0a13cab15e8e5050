"""PyTorch port, engine: the replicated single-device cases of
tests/test_engine.py against the JAX package on the same numpy inputs —
the sweep vs the oracle, the NaiveJoin route, compaction for every
verdict pattern, streaming bit-identical to per-batch runs, the
StreamSession submit/flush invariants, and exactly one "n_pos" and one
"result" host sync per streamed device-filtered batch. Counts are held
to the boundary-tie rule (tests/torch_parity.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import make_join as jax_make_join
from repro.core.engine import JoinEngine as JaxEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import JoinEngine, XlingConfig, XlingFilter, make_join
from repro_torch.core.engine import _bucket_size, sharded_range_count_hist
from repro_torch.core.xjoin import FilteredJoin, enhance_with_xling
from torch_parity import assert_counts_match, unit

EPS = 0.8


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    R = unit(rng, 900, 24)
    Q = unit(rng, 157, 24)
    eps = np.linspace(0.2, 1.8, 23).astype(np.float32)
    return R, Q, eps


@pytest.fixture(scope="module")
def true_counts(world):
    R, Q, _ = world
    return np.asarray(jops.range_count(Q, R, EPS, metric="l2", backend="jnp"))


@pytest.fixture(scope="module")
def fitted(world):
    R, _, _ = world
    cfg = XlingConfig(estimator="nn", metric="l2", epochs=3, m=12,
                      device="cpu", estimator_kwargs=dict(widths=(16, 8)))
    return XlingFilter(cfg).fit(R)


def test_engine_hist_matches_jax_ref(world):
    R, Q, eps = world
    want = np.asarray(jref.range_count_hist(jnp.asarray(Q), jnp.asarray(R),
                                            jnp.asarray(eps), "l2"))
    for backend in ("auto", "ref"):
        eng = JoinEngine(R, "l2", backend=backend, device="cpu")
        assert_counts_match(eng.range_count_hist(Q, eps), want, Q, R, eps, "l2")
    assert_counts_match(
        sharded_range_count_hist(Q, R, eps, metric="l2", device="cpu"),
        want, Q, R, eps, "l2")
    assert JoinEngine(R, "l2", device="cpu").nr_padded % 512 == 0


def test_naive_join_routes_through_engine(world, true_counts):
    R, Q, _ = world
    j = make_join("naive", R, "l2", device="cpu")
    assert isinstance(j.engine, JoinEngine)
    jj = jax_make_join("naive", R, "l2", backend="jnp")
    assert_counts_match(j.query_counts(Q, EPS), jj.query_counts(Q, EPS),
                        Q, R, [EPS], "l2")
    assert_counts_match(j.query_counts(Q, EPS), true_counts, Q, R, [EPS], "l2")


@pytest.mark.parametrize("pattern", ["all_positive", "all_negative", "mixed"])
def test_filtered_join_compaction_patterns(world, true_counts, pattern):
    R, Q, _ = world
    rng = np.random.default_rng(3)
    verdicts = {"all_positive": np.ones(len(Q), bool),
                "all_negative": np.zeros(len(Q), bool),
                "mixed": rng.random(len(Q)) > 0.5}[pattern]
    base = make_join("naive", R, "l2", device="cpu")
    res = FilteredJoin(base, filter=lambda Q_, e_: verdicts).run(Q, EPS)
    assert res.meta["engine"] is True
    assert res.n_searched == int(verdicts.sum())
    assert (res.counts[~verdicts] == 0).all()
    assert_counts_match(res.counts[verdicts], true_counts[verdicts],
                        Q[verdicts], R, [EPS], "l2")
    # the JAX engine's compaction gives the same counts
    jeng = JaxEngine(R, "l2", backend="jnp")
    jres = jeng.filtered_join(Q, EPS, verdicts=verdicts)
    assert_counts_match(res.counts, jres.counts, Q, R, [EPS], "l2")


@pytest.mark.parametrize("block", [1, 16, 512])
def test_compaction_block_leaves_counts_unchanged(world, block):
    """`block` rounds the verified rows up to a bucket, as the JAX engine's
    compaction does; the extra rows are discarded, so the counts are the
    exact-n_pos compaction's, bit for bit."""
    R, Q, _ = world
    verdicts = np.random.default_rng(4).random(len(Q)) > 0.7
    eng = JoinEngine(R, "l2", device="cpu")
    want = eng.filtered_join(Q, EPS, verdicts=verdicts)
    got = eng.filtered_join(Q, EPS, verdicts=verdicts, block=block)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.n_searched == want.n_searched == int(verdicts.sum())
    sess = JoinEngine(R, "l2", device="cpu", block=block).stream_session(EPS)
    streamed = sess.submit(Q, verdicts=verdicts) + sess.flush()
    np.testing.assert_array_equal(streamed[0].counts, want.counts)
    jres = JaxEngine(R, "l2", backend="jnp").filtered_join(
        Q, EPS, verdicts=verdicts, block=block)
    assert_counts_match(got.counts, jres.counts, Q, R, [EPS], "l2")


def test_stream_bit_identical_to_per_batch_run(world, fitted):
    R, Q, _ = world
    base = make_join("naive", R, "l2", device="cpu")
    fj = FilteredJoin(base, filter=fitted, tau=0, xdt_mode="fpr")
    batches = [Q[:50], Q[50:51], Q[51:120], Q[120:]]   # ragged buckets
    sync = [fj.run(b, EPS) for b in batches]
    assert 0 < sum(s.n_searched for s in sync) < len(Q)
    for depth in (0, 1, 3, 10):
        stream = list(fj.run_stream(batches, EPS, depth=depth))
        assert len(stream) == len(batches)
        for s, a in zip(sync, stream):
            np.testing.assert_array_equal(a.counts, s.counts)
            assert a.n_searched == s.n_searched
    # the engine-level stream (predict + threshold) agrees with the plan's
    predict = fitted.estimator.device_predict_fn()
    thr = fitted.xdt(EPS, 0, mode="fpr", predict=predict)
    eng = list(base.engine.stream(batches, EPS, predict=predict, threshold=thr))
    np.testing.assert_array_equal(np.concatenate([r.counts for r in eng]),
                                  np.concatenate([s.counts for s in sync]))


def test_enhance_with_xling_is_mean_xdt_at_tau_0(world, fitted):
    R, Q, _ = world
    base = make_join("naive", R, "l2", device="cpu")
    got = enhance_with_xling(base, fitted).run(Q, EPS)
    want = FilteredJoin(base, filter=fitted, tau=0, xdt_mode="mean").run(Q, EPS)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.meta["tau"] == 0 and got.n_searched == want.n_searched


def test_stream_session_submit_flush_invariants(world):
    R, Q, _ = world
    eng = JoinEngine(R, "l2", device="cpu")
    rng = np.random.default_rng(9)
    verdicts = [rng.random(40) > 0.5 for _ in range(6)]
    sess = eng.stream_session(EPS, depth=2)
    got = []
    for i in range(6):
        got.extend(sess.submit(Q[i * 20:i * 20 + 40], verdicts=verdicts[i]))
        assert len(sess._inflight) <= 2
    rest = sess.flush()
    assert len(sess._inflight) == 0 and sess._staged is None
    assert sess.flush() == []            # idempotent barrier
    got.extend(rest)
    assert len(got) == 6
    for i, res in enumerate(got):        # FIFO + correct per-batch counts
        want = eng.filtered_join(Q[i * 20:i * 20 + 40], EPS,
                                 verdicts=verdicts[i])
        np.testing.assert_array_equal(res.counts, want.counts)
    sess.set_depth(0)
    assert sess.depth == 0


def test_two_host_syncs_per_streamed_batch(world, fitted):
    """A device-filtered streamed batch reads its positive count once and
    its result once; unfiltered batches know their count on the host."""
    R, Q, _ = world
    eng = JoinEngine(R, "l2", device="cpu")
    predict = fitted.estimator.device_predict_fn()
    thr = fitted.xdt(EPS, 0, mode="fpr", predict=predict)
    batches = [Q[i:i + 30] for i in range(0, 150, 30)]
    out = list(eng.stream(batches, EPS, predict=predict, threshold=thr))
    assert len(out) == 5
    assert eng.host_syncs == {"n_pos": 5, "result": 5}
    eng.host_syncs.clear()
    list(eng.stream(batches, EPS))           # no filter: n_pos is known
    assert eng.host_syncs == {"result": 5}


def test_bucket_size_matches_jax():
    from repro.core.engine import _bucket_size as jax_bucket
    for n in (1, 255, 256, 257, 1000, 4096, 30000, 120000):
        assert _bucket_size(n, 256) == jax_bucket(n, 256)


def test_unported_verify_raises(world):
    R, Q, _ = world
    eng = JoinEngine(R, "l2", device="cpu")
    with pytest.raises(ValueError, match="verify='grid'"):
        eng.filtered_join(Q, EPS, verify="grid")
    for bad in (0, -4, 2.5, True):
        with pytest.raises(ValueError, match="block"):
            eng.filtered_join(Q, EPS, block=bad)
