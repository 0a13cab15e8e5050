"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed and handed to both packages.
Neighbour counts are compared with the boundary-tie rule of
`repro_torch.kernels.ref.count_mismatches`: a count may differ only by
the number of pairs whose float64 dot lies within (d + 8) * 2^-24 of the
dot at eps — the f32 accumulation error of a dot of unit vectors —
never by a loose tolerance.
"""
import numpy as np
import torch

from repro_torch.kernels.ref import count_mismatches

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
