"""PyTorch port, the slice as a whole: a filter fitted by the JAX package,
saved with its `XlingFilter.save`, loaded by the port, and
`JoinPlan.run(Q, eps)` in both packages on the same synthetic corpus.

Tolerances: thresholds and predictions agree to |a - b| <= 1e-4 *
max(1, |a|) (f32 forwards summed in another order, then expm1); verdicts
are identical except where |pred - thr| is within that tolerance;
counts of queries both packages searched are equal up to boundary ties
(tests/torch_parity.py); skip rates differ by at most the boundary
verdicts. In the port, `build_xjoin` and `stream` agree with `run`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as jutils
from repro.core import JoinPlan as JaxPlan
from repro.core import XlingConfig as JaxConfig
from repro.core import XlingFilter as JaxFilter
from repro.data import load_dataset
from repro_torch.core import (JoinPlan, XlingConfig, XlingFilter, build_xjoin)
from torch_parity import assert_counts_match

EPS, TAU = 0.45, 3


def _tol(x):
    return 1e-4 * max(1.0, abs(float(x)))


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    with pytest.MonkeyPatch.context() as mp:     # a private corpus cache
        mp.setattr(jutils, "CACHE_DIR", str(tmp))
        R, S, spec = load_dataset("glove", n=1000, seed=0)
    cfg = JaxConfig(estimator="rmi", metric=spec.metric, m=20, epochs=2,
                    backend="jnp", estimator_kwargs=dict(widths=(32, 16)))
    jfilt = JaxFilter(cfg).fit(R)
    path = str(tmp / "xling.npz")
    jfilt.save(path)
    tfilt = XlingFilter.load(path, device="cpu")
    jplan = (JaxPlan(R, spec.metric).filter(jfilt, tau=TAU, xdt="fpr")
             .search("naive").on(backend="jnp"))
    tplan = (JoinPlan(R, spec.metric).filter(tfilt, tau=TAU, xdt="fpr")
             .search("naive").on(device="cpu"))
    return R, S, spec, jplan, tplan


def test_loaded_filter_carries_the_jax_state(plans):
    R, S, spec, jplan, tplan = plans
    jf, tf = jplan.build()._built.filter.filt, tplan.build()._built.filter.filt
    np.testing.assert_array_equal(tf.target_table, jf.target_table)
    np.testing.assert_array_equal(tf.train_points, jf.train_points)
    np.testing.assert_array_equal(tf.eps_grid, jf.eps_grid)
    assert tf.estimator.stage_sizes == (1, 2, 4)
    assert tf.estimator.widths == (32, 16)


def test_run_matches_jax_plan(plans):
    R, S, spec, jplan, tplan = plans
    jres, tres = jplan.run(S, EPS), tplan.run(S, EPS)
    (jpred_fn, jthr) = jplan._filter_state(EPS)
    (tpred_fn, tthr) = tplan._filter_state(EPS)
    assert abs(tthr - jthr) <= _tol(jthr), (tthr, jthr)

    X = np.concatenate([S, np.full((len(S), 1), EPS, np.float32)], axis=1)
    jparams, jfn = jpred_fn
    jpred = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(X)))
    tparams, tfn = tpred_fn
    with torch.no_grad():
        tpred = tfn(tparams, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(tpred, jpred, rtol=1e-4, atol=1e-4)
    jv = jpred > np.float32(jthr)
    tv = tpred > np.float32(tthr)
    boundary = np.abs(tpred - tthr) <= _tol(tthr)
    assert not ((jv != tv) & ~boundary).any()
    assert tres.n_searched == int(tv.sum()) and jres.n_searched == int(jv.sum())
    assert 0 < tres.n_searched < len(S)          # the filter really filters
    assert abs(tres.n_searched - jres.n_searched) <= int(boundary.sum())

    both = jv & tv
    assert_counts_match(tres.counts[both], jres.counts[both], S[both], R,
                        [EPS], spec.metric)
    assert (tres.counts[~tv] == 0).all()


def test_stream_and_build_xjoin_agree_with_run(plans):
    R, S, spec, _, tplan = plans
    one = tplan.run(S, EPS)
    stream = list(tplan.stream([S[:50], S[50:51], S[51:]], EPS, depth=1))
    np.testing.assert_array_equal(np.concatenate([r.counts for r in stream]),
                                  one.counts)
    cfg = XlingConfig(estimator="rmi", metric=spec.metric, m=20, epochs=1,
                      device="cpu", estimator_kwargs=dict(widths=(16, 8)))
    fj = build_xjoin(R, spec.metric, xling_cfg=cfg, tau=TAU, device="cpu")
    run = fj.run(S, EPS)
    streamed = list(fj.run_stream([S[:70], S[70:]], EPS))
    np.testing.assert_array_equal(
        np.concatenate([r.counts for r in streamed]), run.counts)
    plan = JoinPlan(R, spec.metric).filter(fj.filter, tau=TAU, xdt="fpr")
    np.testing.assert_array_equal(plan.on(device="cpu").run(S, EPS).counts,
                                  run.counts)
    d = tplan.describe()
    assert d["exec"]["device"] == "cpu" and d["verify"]["resolved"] == "exact"
    blocked = (JoinPlan(R, spec.metric).filter(fj.filter, tau=TAU, xdt="fpr")
               .on(device="cpu", block=64))
    np.testing.assert_array_equal(blocked.run(S, EPS).counts, run.counts)
    assert blocked.describe()["exec"]["block"] == 64


@pytest.mark.parametrize("build", [
    lambda p: p.search("grid"),
    lambda p: p.filter("lsbf"),
    lambda p: p.verify("kmeanstree"),
])
def test_unported_plan_values_raise(plans, build):
    R, _, spec, _, _ = plans
    with pytest.raises(ValueError, match="not ported yet"):
        build(JoinPlan(R, spec.metric).on(device="cpu")).build()
    with pytest.raises(ValueError, match="not ported"):
        JoinPlan(R, spec.metric).on(mesh=None)
