"""PyTorch port, the LM stack's serving path (TinyLlama's dense decoder):
the JAX package's `Model.prefill` / `decode_step` against the port's on
the same weights, carried over leaf by leaf with `load_jax_params`.

Tolerances, relative to max |logit| (or max |cache value|): 1e-4 for the
f32 SMOKE config (f32 sums in another order), 2e-2 for its bf16 variant
(the JAX package's own prefill/decode bound, tests/test_archs.py:60;
bf16 rounds at other places in the two frameworks). Caches compare in
the decode layout [G, B, NS, Sc, K, D]. Also: the port's own
prefill/decode consistency, make_batch's tokens, the host check of the
decode position, the layers against the JAX package's, and that entry
points default to the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import build_model as jbuild_model
from repro.archs import layers as jlayers
from repro.archs.frontends import make_batch as jmake_batch
from repro.configs import get_config as jget_config
from repro_torch.archs import (Model, build_model, layers, make_batch,
                               param_specs)
from repro_torch.archs.spec import flatten, init_params
from repro_torch.configs import ARCH_IDS, get_config
from torch_parity import unit  # noqa: F401  (sets the test thread count)

ARCH = "tinyllama_1_1b"
CASES = {
    "f32": (dict(), 1e-4),
    "bf16": (dict(param_dtype="bfloat16"), 2e-2),
    "f32-kv4": (dict(kv_shards=4), 1e-4),
}


def _configs(case):
    kw, tol = CASES[case]
    return (jget_config(ARCH, smoke=True).scaled(**kw),
            get_config(ARCH, smoke=True).scaled(**kw), tol)


def _models(case, seed=0):
    jcfg, cfg, tol = _configs(case)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    model = build_model(cfg, device="cpu", seed=seed + 1)
    model.load_jax_params(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, tol


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _torch(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 by its bits) as a tensor."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_rel(got, want, tol, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < tol, (what, rel)


def _grow_np(cache, max_len: int, ns: int) -> dict:
    """A prefill cache ([G,B,NS0,Sc0,K,D] numpy) copied into a zero cache of
    max_len positions sharded ns ways: position p at shard p // Sc."""
    out = {}
    for b, c in cache.items():
        out[b] = {}
        for n, x in c.items():
            x = np.asarray(x)
            G, B, n0, s0, K, D = x.shape
            flat = np.zeros((G, B, max_len, K, D), x.dtype)
            flat[:, :, :n0 * s0] = x.reshape(G, B, n0 * s0, K, D)
            out[b][n] = flat.reshape(G, B, ns, max_len // ns, K, D)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_load_jax_params_bit_for_bit(dtype):
    _, jparams, model, _ = _models(dtype)
    want = dict(flatten(jax.tree.map(np.asarray, jparams)))
    got = dict(flatten(model.param_tree()))
    assert set(got) == set(want) and set(got) == set(model.state_dict())
    for path, a in want.items():
        t = got[path].detach()
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=path)
        else:
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), a, err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_matches_jax(case):
    jmodel, jparams, model, tol = _models(case)
    B, S = 2, 48
    toks = jmake_batch(jmodel.cfg, "train", B, S, seed=3)["tokens"]
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": toks})
    logits, cache = model.prefill({"tokens": _torch(toks)})
    _assert_rel(logits, jlogits, tol, "logits")
    assert logits.dtype == model.cfg.dtype
    for b in jcache:
        for n in ("k", "v"):
            assert tuple(cache[b][n].shape) == jcache[b][n].shape
            _assert_rel(cache[b][n], jcache[b][n], tol, f"cache {b}.{n}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(case):
    jmodel, jparams, model, tol = _models(case)
    cfg = model.cfg
    B, S, max_len = 2, 47, 64
    toks = np.asarray(jmake_batch(jmodel.cfg, "train", B, S + 2,
                                  seed=5)["tokens"])
    _, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": toks[:, :S]})
    ns = cfg.kv_shards if max_len % cfg.kv_shards == 0 else 1
    start = _grow_np(jax.tree.map(np.asarray, jcache), max_len, ns)
    jc = jax.tree.map(jnp.asarray, start)
    c = {b: {n: _torch(x) for n, x in v.items()}
         for b, v in start.items()}
    step = jax.jit(jmodel.decode_step)
    for pos in (S, S + 1):       # two steps: the second reads the first's K/V
        jlogits, jc = step(jparams, jc, toks[:, pos:pos + 1],
                           jnp.asarray(pos, jnp.int32))
        logits, c = model.decode_step(c, _torch(toks[:, pos:pos + 1]), pos)
        _assert_rel(logits, jlogits, tol, f"logits at {pos}")
    for b in jc:
        for n in ("k", "v"):
            assert tuple(c[b][n].shape) == (cfg.n_layers, B, ns, max_len // ns,
                                            cfg.n_kv_heads, cfg.head_dim)
            _assert_rel(c[b][n], jc[b][n], tol, f"cache {b}.{n}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_consistency(case):
    """The port of tests/test_archs.py::test_arch_prefill_decode_consistency
    on the port alone: prefill(S-1), the cache grown by cache_for_decode,
    one decode of token S-1 against prefill(S)."""
    _, cfg, _ = _configs(case)
    model = build_model(cfg, device="cpu")
    B, S = 2, 48
    toks = make_batch(cfg, "train", B, S, device="cpu")["tokens"]
    _, cache = model.prefill({"tokens": toks[:, :-1]})
    cache = model.cache_for_decode(cache, S + 16)
    logits_dec, _ = model.decode_step(cache, toks[:, -1:], S - 1)
    logits_full, _ = model.prefill({"tokens": toks})
    _assert_rel(logits_dec, logits_full, 2e-2, "decode vs prefill")


def test_cache_for_decode_keeps_positions_across_shardings():
    cfg = get_config(ARCH, smoke=True).scaled(kv_shards=4)
    model = build_model(cfg, device="cpu")
    toks = make_batch(cfg, "train", 2, 40, device="cpu")["tokens"]
    _, cache = model.prefill({"tokens": toks})            # NS 4, Sc 10
    assert cache["b0"]["k"].shape[2:4] == (4, 10)
    grown = model.cache_for_decode(cache, 56)              # NS 4, Sc 14
    assert grown["b0"]["k"].shape[2:4] == (4, 14)
    for n in ("k", "v"):
        flat = grown["b0"][n].reshape(cfg.n_layers, 2, 56, cfg.n_kv_heads, -1)
        src = cache["b0"][n].reshape(cfg.n_layers, 2, 40, cfg.n_kv_heads, -1)
        assert torch.equal(flat[:, :, :40], src)
        assert not flat[:, :, 40:].any()


def test_make_batch_matches_jax():
    for arch in ARCH_IDS:
        jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
        for kind in ("train", "prefill", "decode"):
            want = jmake_batch(jcfg, kind, 3, 20, seed=11)
            got = make_batch(cfg, kind, 3, 20, seed=11, device="cpu")
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(np.asarray(got[key]),
                                              np.asarray(want[key]))


def test_configs_match_jax():
    for arch in ARCH_IDS:
        for smoke in (False, True):
            jcfg, cfg = jget_config(arch, smoke), get_config(arch, smoke)
            for field in jcfg.__dataclass_fields__:
                assert getattr(cfg, field) == getattr(jcfg, field), field
            assert cfg.head_dim == jcfg.head_dim
            assert cfg.dtype == (torch.bfloat16 if jcfg.dtype == jnp.bfloat16
                                 else torch.float32)


def test_decode_position_past_the_cache_raises():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(2, 32)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    model.decode_step(cache, tok, 31)
    for pos in (32, 40, -1):
        with pytest.raises(IndexError):
            model.decode_step(cache, tok, pos)
    ck, cv = cache["b0"]["k"][0], cache["b0"]["v"][0]
    k1 = torch.ones((2, cfg.n_kv_heads, cfg.head_dim))
    with pytest.raises(IndexError):
        layers.cache_update(ck, cv, k1, k1, 32)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(cfg, "train", 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(param_specs(cfg), torch.Generator())


@pytest.mark.parametrize("kw", [dict(window=8), dict(attn_kind="mla"),
                                dict(n_experts=4, top_k=2),
                                dict(frontend="vision_stub", n_patches=4)])
def test_unported_families_raise(kw):
    cfg = get_config(ARCH, smoke=True).scaled(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")


def test_norm_rope_and_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.arange(3, 12, dtype=np.int32)
    for dt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                         (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(jlayers.rope(jnp.asarray(x, dt), jnp.asarray(pos)),
                          np.float32)
        got = layers.rope(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(pos)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        scale = rng.normal(size=16).astype(np.float32)
        want = np.asarray(jlayers.rmsnorm(jnp.asarray(scale),
                                          jnp.asarray(x, dt)), np.float32)
        got = layers.rmsnorm(torch.from_numpy(scale),
                             torch.from_numpy(x).to(tdt)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    for kind in ("swiglu", "gelu"):
        shapes = {k: s.shape for k, s in
                  layers.mlp_specs(16, 32, kind, torch.float32).items()}
        p = {k: (rng.normal(size=s) * 0.2).astype(np.float32)
             for k, s in shapes.items()}
        want = np.asarray(jlayers.mlp_apply(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h), kind))
        got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(h), kind).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_flash_decode_matches_jax():
    rng = np.random.default_rng(2)
    B, NS, Sc, H, K, D = 2, 4, 8, 8, 2, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, NS, Sc, K, D)).astype(np.float32)
    vc = rng.normal(size=(B, NS, Sc, K, D)).astype(np.float32)
    for valid in (1, 13, 32):
        want = np.asarray(jlayers.sharded_flash_decode(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(valid)))
        got = layers.sharded_flash_decode(torch.from_numpy(q),
                                          torch.from_numpy(kc),
                                          torch.from_numpy(vc), valid).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_model_is_a_module_with_jax_names():
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, Model) and isinstance(model, torch.nn.Module)
    names = dict(model.named_parameters())
    assert names["layers.b0.attn.wq"].shape == (cfg.n_layers, cfg.d_model,
                                                cfg.n_heads, cfg.head_dim)
    assert not any(p.requires_grad for p in names.values())
