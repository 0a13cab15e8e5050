"""PyTorch port, the flash-attention kernel module: the port's plain
version (`flash_attention_plain`, the CUDA kernel's arithmetic) and its
dense oracle (`ops.flash_attention(backend="ref")`) against the JAX
package's Pallas kernel `flash_attention_pallas`, in interpret mode at the
cases `tests/test_kernels.py` runs it, on the same seeded numpy inputs.

Tolerances are the JAX kernel tests': f32 |a - b| <= 2e-5 + 2e-5 |b|
(sums in another order), bf16 3e-2 (p rounded to bf16 at other kv
tiles). The Pallas kernel takes no ragged S (S % block_q == 0), so ragged
S is held against the JAX package's `layers.flash_attention`. Also: a CPU
tensor takes the plain path without a launch, and the layers' plain
attention paths match the JAX package's with windows and query offsets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import layers as jlayers
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.archs import layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from torch_parity import unit  # noqa: F401  (sets the test thread count)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, B, S, T, H, K, Dk, Dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, Dk)).astype(np.float32),
            rng.normal(size=(B, T, K, Dk)).astype(np.float32),
            rng.normal(size=(B, T, K, Dv)).astype(np.float32))


def _port(fn, arrays, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in arrays), **kw)
    return out.float().numpy()


def _jax(fn, arrays, dtype=jnp.float32, **kw):
    return np.asarray(fn(*(jnp.asarray(a, dtype) for a in arrays), **kw),
                      np.float32)


@pytest.mark.parametrize("B,S,T,H,K,Dk,Dv,causal", [
    (2, 128, 128, 8, 2, 32, 32, True),
    (1, 64, 256, 4, 1, 16, 24, False),    # cross-attention shape (MQA-ish)
    (2, 128, 128, 6, 6, 64, 64, True),    # MHA
    (1, 64, 64, 40, 1, 96, 64, True),     # MLA-materialized-ish dims
    (1, 128, 128, 16, 2, 64, 64, True),   # GQA, G = 8 (TinyLlama's ratio)
])
def test_plain_and_ref_match_pallas_f32(B, S, T, H, K, Dk, Dv, causal):
    arrays = _qkv(S * 3 + T + H, B, S, T, H, K, Dk, Dv)
    want = _jax(flash_attention_pallas, arrays, causal=causal, block_q=32,
                block_kv=64)
    before = fa.KERNEL.launches
    for got in (_port(fa.flash_attention_plain, arrays, causal=causal),
                _port(ops.flash_attention, arrays, causal=causal),
                _port(ops.flash_attention, arrays, causal=causal,
                      backend="ref")):
        np.testing.assert_allclose(got, want, **F32)
    assert fa.KERNEL.launches == before, "a CPU tensor launched the kernel"


@pytest.mark.parametrize("H,K", [(4, 2), (16, 2)])
def test_plain_matches_pallas_bf16(H, K):
    arrays = _qkv(H, 1, 64, 64, H, K, 32, 32)
    want = _jax(flash_attention_pallas, arrays, jnp.bfloat16, causal=True,
                block_q=32, block_kv=32)
    got = _port(fa.flash_attention_plain, arrays, torch.bfloat16, causal=True)
    np.testing.assert_allclose(got, want, **BF16)
    ref = _port(ops.flash_attention, arrays, torch.bfloat16, causal=True,
                backend="ref")
    np.testing.assert_allclose(ref, want, **BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_kv_valid_matches_pallas(causal):
    arrays = _qkv(1, 1, 32, 64, 4, 2, 16, 16)
    want = _jax(flash_attention_pallas, arrays, causal=causal, block_q=16,
                block_kv=16, kv_valid=40)
    for backend in ("auto", "ref"):
        got = _port(ops.flash_attention, arrays, causal=causal, kv_valid=40,
                    backend=backend)
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("S,T,kv_valid,causal", [
    (100, 100, -1, True),        # ragged S, every key live
    (100, 128, 100, True),       # keys padded to 128, the pad masked
    (37, 96, 70, False),         # ragged S, cross attention, kv_valid
    (1, 64, 64, True),           # one query row
])
def test_plain_ragged_matches_jax_flash_attention(S, T, kv_valid, causal):
    arrays = _qkv(S + T, 2, S, T, 16, 2, 64, 64)
    # the JAX path needs T % chunk == 0: pad the keys, mask the pad
    Tp = -(-T // 32) * 32
    pad = [(0, 0), (0, Tp - T), (0, 0), (0, 0)]
    padded = (arrays[0], np.pad(arrays[1], pad), np.pad(arrays[2], pad))
    valid = T if kv_valid < 0 else kv_valid
    want = _jax(lambda q, k, v: jlayers.flash_attention(
        q, k, v, causal, 0, 0, valid, 32), padded)
    for backend in ("auto", "ref"):
        got = _port(ops.flash_attention, arrays, causal=causal,
                    kv_valid=kv_valid, backend=backend)
        np.testing.assert_allclose(got, want, **F32)


def test_kernel_tile_walk_matches_bf16_jax_flash_attention():
    """bf16 at the kernel's own kv tile (64) against the JAX jnp path at
    chunk 64: the same tiles, so p is rounded at the same running max."""
    arrays = _qkv(7, 1, 200, 256, 8, 1, 64, 64)
    want = _jax(lambda q, k, v: jlayers.flash_attention(
        q, k, v, True, 0, 0, 200, 64), arrays, jnp.bfloat16)
    got = _port(fa.flash_attention_plain, arrays, torch.bfloat16,
                causal=True, kv_valid=200)
    np.testing.assert_allclose(got, want, **BF16)
    assert fa.kv_tile(torch.bfloat16) == 64


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 9, 0), (True, 0, 16), (True, 5, 16)])
def test_layer_attention_paths_match_jax(causal, window, q_offset):
    B, S, T, H, K, D = 2, 20, 40, 6, 2, 8
    arrays = _qkv(window + q_offset, B, S, T, H, K, D, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax(lambda q, k, v: jlayers.chunked_attention(q, k, v, chunk=16,
                                                          **kw), arrays)
    got = _port(lambda q, k, v: layers.chunked_attention(q, k, v, chunk=16,
                                                         **kw), arrays)
    np.testing.assert_allclose(got, want, **F32)
    want = _jax(lambda q, k, v: jlayers.flash_attention(
        q, k, v, causal, window, q_offset, 37, 8), arrays)
    got = _port(lambda q, k, v: layers.flash_attention(
        q, k, v, causal, window, q_offset, 37, 8), arrays)
    np.testing.assert_allclose(got, want, **F32)
    if window or q_offset:      # the port's `attention` is the kernel call
        return                  # only; windows wait for ROADMAP item 18
    # the JAX layer pads T 40 to 48 and masks the pad; the port's kernel
    # route takes T as it is
    want = _jax(lambda q, k, v: jlayers.attention(q, k, v, chunk=16, **kw),
                arrays)
    got = _port(lambda q, k, v: layers.attention(q, k, v, causal=causal),
                arrays)
    np.testing.assert_allclose(got, want, **F32)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 16, dtype=torch.float64),
                           torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 9, 2, 16))
