"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version at small shapes, the launch counters, and one
filtered join through the engine. Marked `gpu`; every test skips with a
reason where no CUDA device is present (decided inside the fixture, not
at import). Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports torch and the port only (the card's machine has no JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_mlp, range_count
from repro_torch.kernels.ref import count_mismatches

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _unit(g, n, d, device):
    x = torch.randn(n, d, generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(device)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("nq,nr,d,m", [(37, 301, 65, 13), (130, 2000, 200, 100),
                                       (5, 700, 960, 1)])
def test_range_count_kernel_vs_plain(cuda, metric, nq, nr, d, m):
    g = torch.Generator().manual_seed(nq + nr)
    q, r = _unit(g, nq, d, cuda), _unit(g, nr, d, cuda)
    hi = 0.9 if metric == "cosine" else 2.0
    eps = torch.linspace(0.4, hi, m, device=cuda) if m > 1 else \
        torch.tensor([hi], device=cuda)
    before = range_count.KERNEL.launches
    got = range_count.range_count_hist(q, r, eps, metric=metric,
                                       nr_valid=nr - 3)
    want = range_count.range_count_hist_plain(q, r, eps, metric=metric,
                                              nr_valid=nr - 3)
    torch.cuda.synchronize()
    assert range_count.KERNEL.launches == before + 1
    res = count_mismatches(got, want, q, r, eps, metric, nr_valid=nr - 3)
    assert res["ok"], res


@pytest.mark.parametrize("d0", [201, 961])
def test_mlp_kernel_vs_plain(cuda, d0):
    g = torch.Generator().manual_seed(d0)
    dims = [d0, 512, 512, 256, 128, 1]
    params = [((torch.randn(a, b, generator=g) * (2.0 / a) ** 0.5).to(cuda),
               (torch.randn(1, b, generator=g) * 0.1).to(cuda))
              for a, b in zip(dims[:-1], dims[1:])]
    x = torch.randn(1000, d0, generator=g).to(cuda)
    before = fused_mlp.KERNEL.launches
    got = fused_mlp.mlp_forward(params, x)
    want = fused_mlp.mlp_forward_plain(params, x)
    torch.cuda.synchronize()
    assert fused_mlp.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_engine_filtered_join_on_card(cuda):
    from repro_torch.core import JoinEngine
    rng = np.random.default_rng(0)
    R = rng.normal(size=(3000, 64)).astype(np.float32)
    R /= np.linalg.norm(R, axis=1, keepdims=True)
    Q = R[:300] + 0.05 * rng.normal(size=(300, 64)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    verdicts = rng.random(300) > 0.5
    eng = JoinEngine(R, "cosine", device="cuda")
    res = eng.filtered_join(Q, 0.3, verdicts=verdicts)
    want = range_count.range_count_hist_plain(
        torch.from_numpy(Q).to(cuda), torch.from_numpy(R).to(cuda),
        torch.tensor([0.3], device=cuda), metric="cosine")[:, 0].cpu().numpy()
    assert (res.counts[~verdicts] == 0).all()
    assert res.n_searched == int(verdicts.sum())
    res_ok = count_mismatches(res.counts[verdicts], want[verdicts],
                              Q[verdicts], R, [0.3], "cosine")
    assert res_ok["ok"], res_ok
