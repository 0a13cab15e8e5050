"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch version at small shapes (the probe kernels also at the
main path's), the launch counters, filtered joins through the engine
on the exact and the device-probe routes, and the LM's prefill through
the attention kernel. Marked `gpu`; every test skips with a
reason where no CUDA device is present (decided inside the fixture, not
at import). Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Imports torch and the port only (the card's machine has no JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (adc_rank, flash_attention, fused_mlp,
                                 lsh_gather, range_count)
from repro_torch.kernels.ref import count_mismatches

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("REPRO_TORCH_CHECK_INDICES", "1")
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


@pytest.mark.parametrize("q,l,B,cap,p", [
    (37, 5, 48, 7, 4),                  # small, nothing divides a block
    (4096, 10, 131072, 12, 4),          # the main path's tables
    (640, 10, 4096, 12, 32),            # re-bucketed width p * fanout
])
def test_lsh_gather_kernel_vs_plain(cuda, q, l, B, cap, p):
    g = torch.Generator().manual_seed(q + B)
    tables = torch.randint(-1, 120000, (l, B, cap), generator=g,
                           dtype=torch.int32)
    tables[tables % 3 == 0] = -1                  # empty slots
    pb = torch.randint(0, B, (q, l, p), generator=g, dtype=torch.int32)
    pb[..., -1] = pb[..., 0]                      # repeated identity probe
    tables, pb = tables.to(cuda), pb.to(cuda)
    before = lsh_gather.KERNEL.launches
    got = lsh_gather.lsh_bucket_gather(tables, pb)
    want = lsh_gather.lsh_bucket_gather_plain(tables, pb)
    torch.cuda.synchronize()
    assert lsh_gather.KERNEL.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_probe_kernel_wrappers_check_indices(cuda):
    """With REPRO_TORCH_CHECK_INDICES=1 the wrappers refuse ids the
    kernels would read out of bounds."""
    tables = torch.full((2, 8, 3), -1, dtype=torch.int32, device=cuda)
    pb = torch.zeros((4, 2, 2), dtype=torch.int32, device=cuda)
    pb[1, 1, 1] = 8
    with pytest.raises(IndexError, match="bucket ids"):
        lsh_gather.lsh_bucket_gather(tables, pb)
    q = torch.zeros((2, 32), device=cuda)
    cbs = torch.zeros((4, 256, 8), device=cuda)
    codes = torch.zeros((10, 4), dtype=torch.uint8, device=cuda)
    cand = torch.tensor([[1, 10, -1], [0, 2, 3]], dtype=torch.int32,
                        device=cuda)
    with pytest.raises(IndexError, match="candidate ids"):
        adc_rank.adc_rank(q, cbs, cand, codes, n_cand=2)


@pytest.mark.parametrize("b,C,n,m,seg,n_cand,integer,live", [
    (16, 64, 300, 4, 8, 32, False, 0.9),
    (33, 500, 300, 4, 8, 100, True, 0.9),     # many ties: the tie order
    (9, 700, 300, 4, 8, 400, False, 0.3),     # fewer live lanes than n_cand
    (64, 85100, 120000, 25, 8, 1000, False, 0.3),   # the main path's pool
])
def test_adc_rank_kernel_vs_plain(cuda, b, C, n, m, seg, n_cand, integer,
                                  live):
    g = torch.Generator().manual_seed(b + C)
    if integer:
        q = torch.randint(-2, 3, (b, m * seg), generator=g).float()
        cbs = torch.randint(-2, 3, (m, 256, seg), generator=g).float()
    else:
        q = torch.randn(b, m * seg, generator=g)
        cbs = torch.randn(m, 256, seg, generator=g)
    codes = torch.randint(0, 256, (n, m), generator=g, dtype=torch.uint8)
    cand = torch.randint(0, n, (b, C), generator=g, dtype=torch.int32)
    cand[torch.rand(b, C, generator=g) > live] = -1
    cand[:, 2] = cand[:, 1]                       # duplicate ids
    cand[0] = -1                                  # an all -1 row
    args = [t.to(cuda) for t in (q, cbs, cand, codes)]
    before = adc_rank.KERNEL.launches
    got = adc_rank.adc_rank(*args, n_cand=n_cand)
    want = adc_rank.adc_rank_plain(*args, n_cand=n_cand)
    torch.cuda.synchronize()
    assert adc_rank.KERNEL.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert (got[0] == -1).all()


@pytest.mark.parametrize("verify", ["lsh", "ivfpq"])
def test_engine_device_probe_on_card(cuda, verify):
    from repro_torch.core import JoinEngine
    rng = np.random.default_rng(1)
    R = rng.normal(size=(3000, 64)).astype(np.float32)
    R /= np.linalg.norm(R, axis=1, keepdims=True)
    Q = R[:300] + 0.05 * rng.normal(size=(300, 64)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    verdicts = rng.random(300) > 0.5
    eng = JoinEngine(R, "cosine", device="cuda")
    eng.verifier(verify, **({"C": 30, "m": 8, "n_probe": 6}
                            if verify == "ivfpq" else {}))
    launches = (lsh_gather.KERNEL.launches, adc_rank.KERNEL.launches)
    dev = eng.filtered_join(Q, 0.3, verdicts=verdicts, verify=verify,
                            probe="device")
    host = eng.filtered_join(Q, 0.3, verdicts=verdicts, verify=verify,
                             probe="host")
    kernel = lsh_gather if verify == "lsh" else adc_rank
    assert kernel.KERNEL.launches > launches[verify == "ivfpq"]
    np.testing.assert_array_equal(dev.counts, host.counts)
    true = eng.range_count(Q, 0.3)
    assert (dev.counts[~verdicts] == 0).all()
    ok = count_mismatches(dev.counts[verdicts], true[verdicts], Q[verdicts],
                          R, [0.3], "cosine", at_most=True)
    assert ok["ok"], ok


def test_probe_host_entries_default_to_the_card(cuda):
    """Without device=, the probe's host entries and an index's host probe
    run on the card (launching the kernels) and equal the CPU route."""
    from repro_torch.core import probe
    from repro_torch.core.joins import IVFPQJoin, LSHJoin
    rng = np.random.default_rng(3)
    R = rng.normal(size=(3000, 64)).astype(np.float32)
    R /= np.linalg.norm(R, axis=1, keepdims=True)
    Q = R[:200]
    ivf = IVFPQJoin(R, "cosine", C=30, m=8, n_probe=6, n_candidates=300)
    assert ivf.device.type == "cuda"
    before = adc_rank.KERNEL.launches
    got = probe.ivfpq_candidates(Q, ivf.centroids, ivf.lists, ivf.codes,
                                 ivf.codebooks, n_probe=6, n_cand=300)
    assert adc_rank.KERNEL.launches == before + 1
    want = probe.ivfpq_candidates(Q, ivf.centroids, ivf.lists, ivf.codes,
                                  ivf.codebooks, n_probe=6, n_cand=300,
                                  device="cpu")
    assert got.shape == want.shape == (200, 300)
    lsh = LSHJoin(R, "cosine", k=8, l=4)
    before = lsh_gather.KERNEL.launches
    cand = lsh.candidates(Q)
    assert lsh_gather.KERNEL.launches == before + 1
    kw = dict(metric="cosine", W=lsh.W, n_probes=lsh.n_probes,
              n_buckets=lsh.n_buckets)
    h = Q.astype(np.float64) @ lsh.proj.reshape(-1, 64).T.astype(np.float64)
    clean = (np.abs(h) > 1e-5).all(axis=1)    # no sign bit near its edge
    np.testing.assert_array_equal(
        probe.lsh_probe_buckets(Q, lsh.proj, lsh.bias, lsh.salt, **kw)[clean],
        probe.lsh_probe_buckets(Q, lsh.proj, lsh.bias, lsh.salt,
                                device="cpu", **kw)[clean])
    assert cand.shape == (200, 4 * lsh.n_probes * lsh.cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,H,K,D,kv_valid,causal", [
    (2, 100, 100, 8, 8, 64, -1, True),        # ragged S, G 1
    (1, 200, 256, 32, 4, 64, 200, True),      # G 8, padded keys masked
    (2, 37, 96, 16, 2, 32, 70, False),        # cross attention, kv_valid
    (1, 130, 130, 8, 1, 128, -1, True),       # MQA, D 128
    (1, 70, 70, 4, 2, 16, 50, True),          # the SMOKE config's D 16
])
def test_flash_attention_kernel_vs_plain(cuda, dtype, B, S, T, H, K, D,
                                         kv_valid, causal):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(S + T + H)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dt) for shape in
               ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          kv_valid=kv_valid)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    assert got.dtype == dt and got.shape == (B, S, H, D)
    tol = 2e-5 if dt == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_reads_strided_q(cuda):
    """q as a transposed view ([B,H,S,D] storage) is read by strides."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 64, 64, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(2, 64, 2, 64, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    qt = q.transpose(1, 2)                          # [B,S,H,D], not contiguous
    got = flash_attention.flash_attention(qt, k, v)
    want = flash_attention.flash_attention_plain(qt.contiguous(), k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_lm_prefill_on_card_runs_the_kernel(cuda):
    """SMOKE in bf16 at TinyLlama's head dim (64) on the card: one attention
    launch per layer per prefill, none while decoding, and the kernel's
    route within the JAX package's prefill bound (2e-2 of max |logit|) of
    the ref route and of its own decode."""
    from repro_torch.archs import build_model, make_batch
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama_1_1b", smoke=True).scaled(
        param_dtype="bfloat16", d_model=256, d_ff=512)
    model = build_model(cfg, seed=0)
    ref = build_model(cfg, seed=0, backend="ref")
    toks = make_batch(cfg, "train", 2, 100)["tokens"]
    before = flash_attention.KERNEL.launches
    logits, cache = model.prefill({"tokens": toks})
    assert flash_attention.KERNEL.launches == before + cfg.n_layers
    want, _ = ref.prefill({"tokens": toks})
    rel = float((logits.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert rel < 2e-2, rel
    cache = model.cache_for_decode(cache, 116)
    before = flash_attention.KERNEL.launches
    nxt = logits.argmax(-1, keepdim=True)
    dec, _ = model.decode_step(cache, nxt, 100)
    assert flash_attention.KERNEL.launches == before
    full, _ = model.prefill({"tokens": torch.cat([toks, nxt], 1)})
    rel = float((dec.float() - full.float()).abs().max()
                / full.float().abs().max())
    assert rel < 2e-2, rel
