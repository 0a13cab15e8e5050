"""PyTorch port, probe kernels: the port's LSH bucket gather and ADC
ranking (the wrappers' plain CPU versions and the "ref" oracles) against
the JAX package's jnp formulations and its Pallas kernels in interpret
mode, plus the LSH hashing and multiprobe schedule against
`repro.core.probe`, on the same seeded numpy inputs.

Tolerances:
  * the bucket gather is integers only: exactly equal;
  * ADC ranking on integer-valued q and codebooks (every product and sum
    exact in f32 whatever the order): the same ids in the same order;
    these inputs tie often, so they test the lower-lane-first tie rule;
  * ADC ranking on random floats: ADC values agree to 1e-5 relative, and
    the id sets agree except for ids whose ADC value lies within that
    tolerance of the n_cand-th value (f32 sums in another order);
  * LSH codes: equal except where the projection is within 1e-5 of a
    code boundary (0 for cosine, an integer multiple of W for l2); bucket
    ids from equal codes are exactly equal, salts near 2^31 included.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import probe as jprobe
from repro.kernels.adc_rank import (adc_rank_jnp, adc_rank_pallas,
                                    lut_segment as jlut_segment)
from repro.kernels.lsh_gather import (lsh_bucket_gather_jnp,
                                      lsh_bucket_gather_pallas,
                                      lsh_probe_dup_mask as jdup_mask)
from repro_torch.core import probe as tprobe
from repro_torch.kernels import adc_rank, lsh_gather, ops
from torch_parity import ADC_RTOL, adc64, lsh_near_boundary, unit


@pytest.fixture(autouse=True)
def _check_indices(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CHECK_INDICES", "1")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_gathers(tables, pb):
    """The plain version (through the wrapper, on CPU tensors) and the
    ops-level "ref" oracle."""
    t, p = _t(tables), _t(pb)
    return (lsh_gather.lsh_bucket_gather(t, p).numpy(),
            ops.lsh_bucket_gather(t, p, backend="ref").numpy())


def _jax_gathers(tables, pb):
    """The jnp formulation and the Pallas kernel in interpret mode."""
    jt, jp = jnp.asarray(tables), jnp.asarray(pb)
    q = pb.shape[0]
    pad = (-q) % 8
    pbp = np.concatenate([pb, np.zeros((pad,) + pb.shape[1:], np.int32)])
    pallas = lsh_bucket_gather_pallas(jt, jnp.asarray(pbp), block_q=8,
                                      interpret=True)
    return np.asarray(lsh_bucket_gather_jnp(jt, jp)), np.asarray(pallas)[:q]


def _assert_gathers_equal(tables, pb):
    want, pallas = _jax_gathers(tables, pb)
    np.testing.assert_array_equal(pallas, want)
    for got in _port_gathers(tables, pb):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    return want


# ------------------------------------------------------- lsh_bucket_gather
@pytest.mark.parametrize("q,l,B,cap,p", [
    (64, 4, 64, 8, 3),
    (37, 5, 48, 7, 4),        # nothing divides a block
    (1, 1, 8, 1, 1),          # degenerate single-everything
])
def test_lsh_gather_matches_jax_exactly(q, l, B, cap, p):
    rng = np.random.default_rng(q + l + B)
    tables = rng.integers(-1, 900, size=(l, B, cap)).astype(np.int32)
    pb = rng.integers(0, B, size=(q, l, p)).astype(np.int32)
    pb[..., -1] = pb[..., 0]          # the pad schedule repeats probe 0
    _assert_gathers_equal(tables, pb)
    np.testing.assert_array_equal(
        lsh_gather.lsh_probe_dup_mask(_t(pb)).numpy(),
        np.asarray(jdup_mask(jnp.asarray(pb))))


def test_lsh_gather_ids_above_2_to_24():
    ids = np.array([2**31 - 1, 2**30 - 1, 2**24 + 1, 16_777_217, -1],
                   np.int32).reshape(1, 1, 5)
    tables = np.broadcast_to(ids, (2, 8, 5)).copy()
    rng = np.random.default_rng(9)
    pb = rng.integers(0, 8, size=(5, 2, 3)).astype(np.int32)
    out = _assert_gathers_equal(tables, pb)
    for v in (2**31 - 1, 2**30 - 1, 2**24 + 1, 16_777_217):
        assert v in set(out.ravel().tolist())


def test_lsh_gather_empty_buckets_and_all_duplicate_probes():
    l, B, cap, q, p = 3, 16, 5, 9, 4
    rng = np.random.default_rng(1)
    pb = rng.integers(0, B, size=(q, l, p)).astype(np.int32)
    out = _assert_gathers_equal(np.full((l, B, cap), -1, np.int32), pb)
    assert (out == -1).all()
    pb_dup = np.repeat(pb[:, :, :1], p, axis=2)
    tables = rng.integers(-1, 100, size=(l, B, cap)).astype(np.int32)
    out = _assert_gathers_equal(tables, pb_dup).reshape(q, l, p, cap)
    assert (out[:, :, 1:] == -1).all()
    np.testing.assert_array_equal(
        out[:, :, 0], tables[np.arange(l)[None, :], pb_dup[:, :, 0]])


def test_lsh_gather_on_expanded_probes():
    """The re-bucketed path: p becomes p * fanout after the expansion map,
    with repeated filler buckets blanked by the dedup."""
    rng = np.random.default_rng(4)
    l, B, fanout, p, q, cap = 3, 32, 4, 3, 11, 6
    n_total = B + 8 * fanout + 1
    expand = np.full((l, B, fanout), n_total - 1, np.int32)
    expand[:, :, 0] = np.arange(B)[None]
    hot = rng.choice(B, size=8, replace=False)
    for i, b in enumerate(hot):
        expand[:, b] = B + i * fanout + np.arange(fanout)
    tables = rng.integers(-1, 500, size=(l, n_total, cap)).astype(np.int32)
    tables[:, -1] = -1                          # the always-empty filler
    pb = rng.integers(0, B, size=(q, l, p)).astype(np.int32)
    pb[:, :, 1] = hot[rng.integers(0, 8, size=(q, l))]
    want_pb = np.asarray(jprobe._expand_pb(jnp.asarray(pb),
                                           jnp.asarray(expand)))
    got_pb = tprobe._expand_pb(_t(pb), _t(expand)).numpy()
    np.testing.assert_array_equal(got_pb, want_pb)
    assert got_pb.shape == (q, l, p * fanout)
    _assert_gathers_equal(tables, want_pb.astype(np.int32))


# ---------------------------------------------------------------- adc_rank
def _adc_inputs(rng, b, C, n, m, seg, *, integer):
    if integer:
        q = rng.integers(-2, 3, size=(b, m * seg)).astype(np.float32)
        cbs = rng.integers(-2, 3, size=(m, 256, seg)).astype(np.float32)
    else:
        q = rng.normal(size=(b, m * seg)).astype(np.float32)
        cbs = rng.normal(size=(m, 256, seg)).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    cand = rng.integers(-1, n, size=(b, C)).astype(np.int32)
    if C > 2:
        cand[:, 2] = cand[:, 1]       # duplicate ids (overlapping lists)
    return q, cbs, cand, codes


def _jax_ranks(q, cbs, cand, codes, n_cand):
    args = tuple(map(jnp.asarray, (q, cbs, cand, codes)))
    jnp_out = np.asarray(adc_rank_jnp(*args, n_cand=n_cand))
    b = q.shape[0]
    pad = (-b) % 8
    qp = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
    cp = np.concatenate([cand, np.full((pad, cand.shape[1]), -1, np.int32)])
    pallas = np.asarray(adc_rank_pallas(
        jnp.asarray(qp), args[1], jnp.asarray(cp), args[3], n_cand=n_cand,
        block_b=8, interpret=True))[:b]
    return jnp_out, pallas


def _port_ranks(q, cbs, cand, codes, n_cand):
    args = tuple(map(_t, (q, cbs, cand, codes)))
    return (adc_rank.adc_rank(*args, n_cand=n_cand).numpy(),
            ops.adc_rank(*args, n_cand=n_cand, backend="ref").numpy())


@pytest.mark.parametrize("b,C,n_cand", [(16, 64, 32), (21, 48, 20),
                                        (3, 10, 10)])
def test_adc_rank_exact_on_integer_inputs(b, C, n_cand):
    rng = np.random.default_rng(b * C)
    inputs = _adc_inputs(rng, b, C, 300, 4, 8, integer=True)
    want, pallas = _jax_ranks(*inputs, n_cand)
    np.testing.assert_array_equal(pallas, want)
    for got in _port_ranks(*inputs, n_cand):
        assert got.dtype == np.int32 and got.shape == (b, n_cand)
        np.testing.assert_array_equal(got, want)


def test_lut_segment_exact_on_integer_inputs():
    rng = np.random.default_rng(11)
    q = rng.integers(-3, 4, size=(7, 8)).astype(np.float32)
    cb = rng.integers(-3, 4, size=(256, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        adc_rank.lut_segment(_t(q), _t(cb)).numpy(),
        np.asarray(jlut_segment(jnp.asarray(q), jnp.asarray(cb))))


@pytest.mark.parametrize("b,C,n_cand", [(16, 64, 32), (5, 200, 60)])
def test_adc_rank_on_random_floats(b, C, n_cand):
    rng = np.random.default_rng(C)
    q, cbs, cand, codes = _adc_inputs(rng, b, C, 300, 4, 8, integer=False)
    want, pallas = _jax_ranks(q, cbs, cand, codes, n_cand)
    np.testing.assert_array_equal(pallas, want)
    # the values: the port's LUTs against the JAX package's
    for mi in range(4):
        tq = adc_rank.lut_segment(_t(q[:, mi * 8:(mi + 1) * 8]),
                                  _t(cbs[mi])).numpy()
        jq = np.asarray(jlut_segment(jnp.asarray(q[:, mi * 8:(mi + 1) * 8]),
                                     jnp.asarray(cbs[mi])))
        np.testing.assert_allclose(tq, jq, rtol=ADC_RTOL,
                                   atol=ADC_RTOL * np.abs(jq).max())
    for got in _port_ranks(q, cbs, cand, codes, n_cand):
        for i in range(b):
            live = cand[i][cand[i] >= 0]
            vals = np.sort(adc64(q[i], cbs, codes, live))
            kth = vals[min(n_cand, len(vals)) - 1]
            diff = set(got[i].tolist()) ^ set(want[i].tolist())
            for idv in diff:
                v = adc64(q[i], cbs, codes, np.array([idv]))[0]
                assert abs(v - kth) <= ADC_RTOL * max(1.0, abs(kth)), \
                    (i, idv, v, kth)


def test_adc_rank_all_minus_one_rows_and_short_pools():
    """A fully -1 row ranks to all -1; with fewer live lanes than n_cand
    the +inf lanes fill the tail, lowest lane first, as -1."""
    rng = np.random.default_rng(3)
    q, cbs, _, codes = _adc_inputs(rng, 8, 24, 50, 4, 8, integer=True)
    cand = np.full((8, 24), -1, np.int32)
    cand[0, :3] = [4, 4, 7]           # one row keeps a few live ids
    cand[1, 5:9] = [1, 2, 3, 9]
    want, pallas = _jax_ranks(q, cbs, cand, codes, 12)
    np.testing.assert_array_equal(pallas, want)
    for got in _port_ranks(q, cbs, cand, codes, 12):
        np.testing.assert_array_equal(got, want)
        assert (got[2:] == -1).all()
        assert set(got[0][got[0] >= 0].tolist()) == {4, 7}
        assert (got[1][4:] == -1).all()


def test_adc_rank_rejects_n_cand_beyond_the_pool():
    rng = np.random.default_rng(0)
    args = tuple(map(_t, _adc_inputs(rng, 2, 6, 20, 4, 8, integer=True)))
    with pytest.raises(ValueError, match="n_cand"):
        adc_rank.adc_rank(*args, n_cand=7)


# ------------------------------------------------------ LSH hashing math
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_lsh_codes_and_probe_schedule_match_jax(metric):
    rng = np.random.default_rng(7)
    n, d, l, k, W = 300, 32, 6, 10, 2.5
    X = unit(rng, n, d)
    proj = rng.normal(size=(l, k, d)).astype(np.float32)
    bias = rng.uniform(0, W, size=(l, k)).astype(np.float32)
    salt = rng.integers(1, 2 ** 31, size=(l, k)).astype(np.int64)
    want = jprobe.lsh_hash_codes(X, proj, bias, metric=metric, W=W)
    got = tprobe.lsh_hash_codes(X, proj, bias, metric=metric, W=W,
                                device="cpu")
    edge = lsh_near_boundary(X, proj, bias, metric, W)
    assert ((got == want) | edge).all()
    clean = ~edge.any(axis=(1, 2))
    assert clean.mean() > 0.95
    for n_buckets in (1024, 1000):           # 1000: mod needs the sign rule
        np.testing.assert_array_equal(
            tprobe.lsh_bucket_ids(want, salt, n_buckets),
            jprobe.lsh_bucket_ids(want, salt, n_buckets))
        for n_probes in (4, 12):             # 12 > k + 1: padded schedule
            kw = dict(metric=metric, W=W, n_probes=n_probes,
                      n_buckets=n_buckets)
            np.testing.assert_array_equal(
                tprobe.lsh_probe_buckets(X, proj, bias, salt, device="cpu",
                                         **kw)[clean],
                jprobe.lsh_probe_buckets(X, proj, bias, salt, **kw)[clean])


def test_lsh_bucket_ids_wrap_with_salts_near_2_to_31():
    rng = np.random.default_rng(2)
    l, k = 4, 18
    salt = rng.integers(2 ** 31 - 2000, 2 ** 31, size=(l, k)).astype(np.int64)
    salt[0, 0] = 29996224275833            # an int64 salt: wraps to int32
    codes = rng.integers(-6, 7, size=(500, l, k)).astype(np.int32)
    for n_buckets in (131072, 999, 7):
        np.testing.assert_array_equal(
            tprobe.lsh_bucket_ids(codes, salt, n_buckets),
            jprobe.lsh_bucket_ids(codes, salt, n_buckets))


# ------------------------------------------- entry points without a GPU
def _entry_point_calls():
    from repro_torch.core.joins import IVFPQJoin, LSHJoin
    from repro_torch.core.joins.common import assign_nearest, kmeans
    rng = np.random.default_rng(4)
    X = unit(rng, 300, 8)          # >= 256 rows: the PQ codebooks
    proj = rng.normal(size=(2, 4, 8)).astype(np.float32)
    bias = np.zeros((2, 4), np.float32)
    salt = np.arange(1, 9, dtype=np.int64).reshape(2, 4)
    lists = np.arange(64, dtype=np.int32).reshape(4, 16)
    codes = np.zeros((64, 2), np.uint8)
    books = rng.normal(size=(2, 256, 4)).astype(np.float32)
    return {
        "lsh_hash_codes": lambda **d: tprobe.lsh_hash_codes(
            X, proj, bias, metric="l2", W=2.5, **d),
        "lsh_probe_buckets": lambda **d: tprobe.lsh_probe_buckets(
            X, proj, bias, salt, metric="l2", W=2.5, n_probes=2,
            n_buckets=64, **d),
        "ivfpq_candidates": lambda **d: tprobe.ivfpq_candidates(
            X, X[:4], lists, codes, books, n_probe=2, n_cand=8, **d),
        "kmeans": lambda **d: kmeans(X, 4, iters=2, **d),
        "assign_nearest": lambda **d: assign_nearest(X, X[:4], **d),
        "LSHJoin": lambda **d: LSHJoin(X, "l2", k=4, l=2, **d),
        "IVFPQJoin": lambda **d: IVFPQJoin(X, "l2", C=4, m=2, n_probe=2,
                                           n_candidates=8, **d),
    }


@pytest.mark.parametrize("name", sorted(_entry_point_calls()))
def test_probe_entry_point_without_gpu_raises(monkeypatch, name):
    """The probe's host entries and the index builds default to the card:
    without one they raise unless the caller asks for the CPU."""
    call = _entry_point_calls()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # LSH overflow
        call(device="cpu")
