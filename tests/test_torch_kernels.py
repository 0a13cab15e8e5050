"""PyTorch port, kernel modules: the port's plain and oracle paths of
`range_count_hist` and `mlp_forward` against the JAX package's oracle and
its Pallas kernels (interpret mode at small blocks, as test_kernels.py
runs them), on the same seeded numpy inputs.

Counts are held to the boundary-tie rule (tests/torch_parity.py); MLP
outputs to |a - b| <= 1e-5 + 1e-5 |b| (f32 sums in another order). Also:
the wrappers take the plain path for CPU tensors only because the tensor
lies on the CPU (no build, no launch), and a CUDA request without a GPU
raises instead of running on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.range_count import range_count_hist_pallas
from repro_torch.kernels import fused_mlp, ops, range_count, ref
from repro_torch.utils import resolve_device
from torch_parity import assert_counts_match, unit

MLP_TOL = dict(rtol=1e-5, atol=1e-5)


def _eps(rng, m, metric):
    hi = 1.0 if metric == "cosine" else 1.9
    return np.sort(rng.uniform(0.05, hi, size=m)).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("nq,nr,d,m", [
    (16, 64, 8, 4),        # tiny
    (37, 301, 65, 13),     # nothing divides a block
    (29, 150, 24, 1),      # single-eps verify shape
])
def test_range_count_vs_jax(metric, nq, nr, d, m):
    rng = np.random.default_rng(nq * 7 + nr + m)
    q, r = unit(rng, nq, d), unit(rng, nr, d)
    eps = _eps(rng, m, metric)
    want = np.asarray(jref.range_count_hist(jnp.asarray(q), jnp.asarray(r),
                                            jnp.asarray(eps), metric))
    pallas = np.asarray(jops.range_count_hist(
        q, r, eps, metric=metric, backend="pallas", block_q=16, block_r=32,
        eps_chunk=4))
    tq, tr, te = map(torch.from_numpy, (q, r, eps))
    plain = range_count.range_count_hist(tq, tr, te, metric=metric)
    oracle = ops.range_count_hist(tq, tr, te, metric=metric, backend="ref")
    for got in (plain, oracle):
        assert got.dtype == torch.int32 and got.shape == (nq, m)
        assert_counts_match(got.numpy(), want, q, r, eps, metric)
        assert_counts_match(got.numpy(), pallas, q, r, eps, metric)
    if m == 1:                              # the single-eps entry points
        e = float(eps[0])
        want1 = np.asarray(jref.range_count(jnp.asarray(q), jnp.asarray(r), e,
                                            metric))
        for got in (ref.range_count(tq, tr, e, metric),
                    ops.range_count(tq, tr, e, metric=metric)):
            assert_counts_match(got.numpy(), want1, q, r, eps, metric)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_range_count_nr_valid_masks_padding(metric):
    """Zero padding rows sit at distance 1 (cosine) or sqrt 2 (l2) from any
    unit query, inside the eps grid: rows past nr_valid must never count,
    at every eps, as in the Pallas kernel's nr_valid mask."""
    rng = np.random.default_rng(11)
    q, r = unit(rng, 24, 16), unit(rng, 100, 16)
    rp = np.concatenate([r, np.zeros((28, 16), np.float32)])   # 128 rows
    grid = np.linspace(0.4, 1.2, 8) if metric == "cosine" else \
        np.linspace(0.5, 2.0, 8)
    eps = grid.astype(np.float32)
    pallas = np.asarray(range_count_hist_pallas(
        jnp.asarray(q), jnp.asarray(rp), jnp.asarray(eps), metric=metric,
        nr_valid=100, block_q=8, block_r=32, eps_chunk=4, interpret=True))
    tq, trp, te = map(torch.from_numpy, (q, rp, eps))
    masked = range_count.range_count_hist(tq, trp, te, metric=metric,
                                          nr_valid=100)
    unpadded = ref.range_count_hist(tq, torch.from_numpy(r), te, metric)
    counted = range_count.range_count_hist(tq, trp, te, metric=metric)
    assert_counts_match(masked.numpy(), pallas, q, r, eps, metric)
    assert_counts_match(masked.numpy(), unpadded.numpy(), q, r, eps, metric)
    # without the mask the 28 zero rows land in the bins at/above 1 | sqrt 2
    assert (counted - masked).max().item() == 28


@pytest.mark.parametrize("widths", [(32,), (32, 16)])
@pytest.mark.parametrize("din,n", [(17, 40), (66, 19)])
def test_mlp_forward_vs_jax(widths, din, n):
    rng = np.random.default_rng(din + n)
    dims = (din,) + widths + (1,)
    params = [(rng.normal(size=(a, b)).astype(np.float32) * 0.2,
               rng.normal(size=(1, b)).astype(np.float32))
              for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(n, din)).astype(np.float32)
    want = np.asarray(jref.mlp_forward(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params], jnp.asarray(x)))
    pallas = np.asarray(jops.mlp_forward(params, x, backend="pallas",
                                         block_n=16))
    tp = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in params]
    for got in (fused_mlp.mlp_forward(tp, torch.from_numpy(x)),
                ops.mlp_forward(tp, torch.from_numpy(x), backend="ref")):
        np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **MLP_TOL)


def test_cpu_tensor_takes_plain_path_without_building():
    rng = np.random.default_rng(2)
    q, r = torch.from_numpy(unit(rng, 9, 8)), torch.from_numpy(unit(rng, 30, 8))
    eps = torch.tensor([0.5, 1.0], dtype=torch.float32)
    rc0, mlp0 = range_count.KERNEL.launches, fused_mlp.KERNEL.launches
    got = range_count.range_count_hist(q, r, eps, metric="cosine")
    assert torch.equal(got, range_count.range_count_hist_plain(
        q, r, eps, metric="cosine"))
    params = [(torch.ones(8, 4), torch.zeros(1, 4)),
              (torch.ones(4, 1), torch.zeros(1, 1))]
    out = fused_mlp.mlp_forward(params, q)
    assert torch.equal(out, fused_mlp.mlp_forward_plain(params, q))
    assert range_count.KERNEL.launches == rc0
    assert fused_mlp.KERNEL.launches == mlp0
    assert range_count.KERNEL._lib is None and fused_mlp.KERNEL._lib is None


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import JoinEngine
    from repro_torch.models import make_estimator
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JoinEngine(np.eye(4, dtype=np.float32), "cosine")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_estimator("nn", 5, widths=(4,))
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_reject_bad_inputs():
    q = torch.ones(4, 8)
    with pytest.raises(TypeError):
        range_count.range_count_hist(q.double(), q, torch.ones(2))
    with pytest.raises(ValueError):
        range_count.range_count_hist(q, torch.ones(4, 7), torch.ones(2))
    with pytest.raises(ValueError):
        range_count.range_count_hist(q, q, torch.ones(2), nr_valid=5)
    with pytest.raises(ValueError):
        fused_mlp.mlp_forward([(torch.ones(7, 1), torch.zeros(1, 1))], q)
    with pytest.raises(ValueError):
        fused_mlp.mlp_forward([(torch.ones(8, 2), torch.zeros(1, 2))], q)


@pytest.mark.parametrize("d0,bn", [(201, 32), (961, 32), (2000, 16)])
def test_mlp_tile_plan_fits_shared_memory(d0, bn):
    """The kernel's row tile: 32 rows while both activation buffers fit
    227 KB at the padded stride, 16 beyond (gist's 961 still takes 32)."""
    got_bn, size0, size1 = fused_mlp.plan_tile([d0, 512, 512, 256, 128, 1])
    assert (got_bn, size0, size1) == (bn, max(d0, 512), 512)
    assert (size0 + size1) * (got_bn + 4) * 4 <= fused_mlp.SMEM_LIMIT
    with pytest.raises(ValueError):
        fused_mlp.plan_tile([5000, 512, 1])
