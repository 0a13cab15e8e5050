"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed and handed to both packages.
Neighbour counts are compared with the boundary-tie rule of
`repro_torch.kernels.ref.count_mismatches`: a count may differ only by
the number of pairs whose float64 dot lies within (d + 8) * 2^-24 of the
dot at eps — the f32 accumulation error of a dot of unit vectors —
never by a loose tolerance. Counts over candidate lists are held to the
same rule over the candidates (`assert_candidate_counts_match`).
"""
import numpy as np
import torch

from repro_torch.kernels.ref import count_mismatches, tie_tolerance

#: relative tolerance of ADC values between the packages (f32 sums of
#: random floats in another order)
ADC_RTOL = 1e-5

# one intra-op thread per test worker: the suite runs several workers,
# and the tiny tensors here gain nothing from more
torch.set_num_threads(1)


def unit(rng, n: int, d: int) -> np.ndarray:
    """n random unit vectors of dimension d, float32."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_counts_match(a, b, q, r, eps_grid, metric: str, *,
                        nr_valid=None) -> dict:
    """a, b: neighbour counts [nq] or [nq, m] of q in r[:nr_valid] within
    eps_grid; equal up to boundary ties."""
    if len(q) == 0:
        assert np.size(a) == np.size(b) == 0
        return {"ok": True}
    a = np.asarray(a).reshape(len(q), -1)
    b = np.asarray(b).reshape(len(q), -1)
    res = count_mismatches(a, b, np.asarray(q), np.asarray(r),
                           np.asarray(eps_grid, np.float32).reshape(-1),
                           metric, nr_valid=nr_valid)
    assert res["ok"], res
    return res


def assert_candidate_counts_match(a, b, q, r, cand, eps: float,
                                  metric: str) -> int:
    """a, b: neighbour counts [nq] of q among the candidate ids cand [nq, C]
    (-1 padded) in r, within one eps. A count may differ only by the
    candidates whose float64 dot with the query lies within
    `tie_tolerance(d)` of the dot at eps — the boundary-tie rule of
    `assert_counts_match`, over the candidates instead of all of r.
    Returns the number of rows that differ."""
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    q, r, cand = np.asarray(q), np.asarray(r), np.asarray(cand)
    tol = tie_tolerance(q.shape[1])
    e = float(np.float32(eps))
    c_eps = 1.0 - e if metric == "cosine" else 1.0 - e * e / 2.0
    bad = np.nonzero(a != b)[0]
    for i in bad:
        ids = np.unique(cand[i][cand[i] >= 0])
        dots = r[ids].astype(np.float64) @ q[i].astype(np.float64)
        ties = int((np.abs(dots - c_eps) <= tol).sum())
        assert abs(int(a[i]) - int(b[i])) <= ties, (i, a[i], b[i], ties)
    return len(bad)


def adc64(q, cbs, codes, ids) -> np.ndarray:
    """float64 ADC values of candidate ids for one query row q [m*seg],
    codebooks cbs [m, 256, seg], codes uint8 [n, m]."""
    m, _, seg = cbs.shape
    qs = q.reshape(m, seg).astype(np.float64)
    lut = ((qs[:, None, :] - cbs.astype(np.float64)) ** 2).sum(-1)  # [m,256]
    return lut[np.arange(m)[None, :], codes[ids].astype(np.int64)].sum(1)


def lsh_near_boundary(X, proj, bias, metric: str, W: float) -> np.ndarray:
    """bool [n, l, k]: LSH projections within 1e-5 of a code boundary (0
    for cosine, an integer multiple of W for l2), where f32 products in
    another order may give another code."""
    h = np.einsum("nd,lkd->nlk", X.astype(np.float64), proj.astype(np.float64))
    if metric == "cosine":
        return np.abs(h) < 1e-5
    t = (h + bias[None]) / W
    return np.abs(t - np.round(t)) < 1e-5
