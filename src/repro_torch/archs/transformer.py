"""Decoder-only model of the LM stack, dense family, for serving: prefill
and one-token decode. The port of `repro/archs/transformer.py`.

Parameters keep the JAX pytree's layout, layers stacked on a leading axis
("layers.b0.attn.wq" is [n_groups, d, H, Dh]), registered on the module
under those dotted names, so `load_jax_params` copies a JAX tree leaf by
leaf. Where JAX scans the stacked layers, the port loops over them in
Python. `constrain_act`/`constrain_logits` (sharding constraints, no-ops
without a mesh in JAX) are left out; `remat` and `scan_layers` have no
meaning in eager inference and are carried as config fields only.

Every prefill layer's attention runs the hand-written flash-attention
kernel (`backend="auto"` on a CUDA device) or its unblocked oracle
(`backend="ref"`); decode runs plain PyTorch over the sharded cache.

Not ported yet: the other families (`moe`, `mamba2`, `encdec`,
`vision_stub`, MLA, sliding windows; ROADMAP queue 1 item 18) and training
(`train_loss`; item 17).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.archs import layers as L
from repro_torch.archs.spec import ParamSpec, flatten, init_params
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import check_backend
from repro_torch.utils import resolve_device


class BlockDesc(NamedTuple):
    kind: str   # "attn" | "mamba"
    ffn: str    # "dense" | "moe" | "none"


def layer_pattern(cfg: ArchConfig) -> tuple[list[BlockDesc], int]:
    """The repeating group of sub-blocks and the number of groups."""
    period = 1
    if cfg.hybrid_period:
        period = cfg.hybrid_period
    if cfg.n_experts:
        period = int(period * cfg.moe_every // math.gcd(period, cfg.moe_every))
    assert cfg.n_layers % period == 0, (cfg.name, cfg.n_layers, period)
    descs = []
    for j in range(period):
        if cfg.attn_kind == "none":
            kind = "mamba"
        elif cfg.hybrid_period:
            kind = "attn" if j % cfg.hybrid_period == cfg.attn_position else "mamba"
        else:
            kind = "attn"
        if cfg.d_ff == 0 and not cfg.n_experts:
            ffn = "none"
        elif cfg.n_experts and (j % cfg.moe_every == cfg.moe_every - 1):
            ffn = "moe"
        else:
            ffn = "dense"
        descs.append(BlockDesc(kind, ffn))
    return descs, cfg.n_layers // period


def _check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    later = "waits for ROADMAP queue 1 item 18 (the other families)"
    if cfg.family == "audio" or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r}, "
                                  f"frontend {cfg.frontend!r} {later}")
    if cfg.attn_kind == "mla":
        raise NotImplementedError(f"{cfg.name}: MLA attention {later}")
    if cfg.window > 0:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention {later}")
    for desc in layer_pattern(cfg)[0]:
        if desc.kind != "attn" or desc.ffn == "moe":
            raise NotImplementedError(f"{cfg.name}: {desc.kind}/{desc.ffn} "
                                      f"blocks (mamba2, moe) {later}")


# ------------------------------------------------------------------- params
def _block_specs(cfg: ArchConfig, desc: BlockDesc) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    out = {"attn": L.gqa_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt)}
    if desc.ffn == "dense":
        out["mlp"] = L.mlp_specs(d, cfg.d_ff, cfg.mlp_kind, dt)
    return out


def _stack_specs(specs, n: int):
    return {k: _stack_specs(v, n) if isinstance(v, dict) else
            ParamSpec((n,) + v.shape, ("layers",) + v.logical, v.dtype,
                      v.init, v.scale)
            for k, v in specs.items()}


def param_specs(cfg: ArchConfig) -> dict:
    """The ParamSpec tree, in the JAX package's layout."""
    _check_supported(cfg)
    descs, n_groups = layer_pattern(cfg)
    d, dt = cfg.d_model, cfg.dtype
    group = {f"b{j}": _block_specs(cfg, desc) for j, desc in enumerate(descs)}
    out = {
        "emb": ParamSpec((cfg.vocab, d), ("vocab", "embed"), dt),
        "final_norm": L.rmsnorm_spec(d),
        "layers": _stack_specs(group, n_groups),
    }
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"), dt)
    return out


def _numpy_to_torch(a) -> torch.Tensor:
    """A host array (a JAX array, numpy, anything np.asarray takes) as a
    tensor with its own memory. A bf16 array from JAX has ml_dtypes'
    bfloat16 dtype, which torch.from_numpy refuses: it is taken by its
    bits."""
    a = np.array(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _register(module: nn.Module, tree: dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            child = nn.Module()
            _register(child, val)
            module.add_module(key, child)
        else:
            module.register_parameter(key, nn.Parameter(val, requires_grad=False))


def _tree_of(module: nn.Module, tree: dict) -> dict:
    """The registered parameters, nested as `tree` is."""
    return {k: _tree_of(getattr(module, k), v) if isinstance(v, dict)
            else getattr(module, k) for k, v in tree.items()}


def _layer(tree: dict, g: int) -> dict:
    """Layer g's views of a stacked tree."""
    return {k: _layer(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


# -------------------------------------------------------------------- model
class Model(nn.Module):
    """The dense decoder for serving. `params` is a tree as `param_specs`
    lays it out (`init_params` makes one); `backend` "auto" runs the
    prefill attention through the hand-written kernel on a CUDA device
    (its plain version on the CPU), "ref" through the dense oracle."""

    def __init__(self, cfg: ArchConfig, params: dict, *, backend: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.backend = check_backend(backend)
        given = dict(flatten(params))
        for path, spec in flatten(param_specs(cfg)):
            t = given.get(path)
            if t is None or tuple(t.shape) != spec.shape:
                raise ValueError(f"param {path}: expected {spec.shape}, got "
                                 f"{None if t is None else tuple(t.shape)}")
        _register(self, params)
        self._params = _tree_of(self, params)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def param_tree(self) -> dict:
        """The parameters as a nested dict (the JAX layout)."""
        return self._params

    @torch.no_grad()
    def load_jax_params(self, tree: dict) -> "Model":
        """Copy a JAX params pytree (nested dicts of arrays; each leaf goes
        through np.asarray) into this model, leaf for leaf, bit for bit.
        Shapes and dtypes must match."""
        want, got = dict(flatten(self._params)), dict(flatten(tree))
        if set(want) != set(got):
            raise KeyError(f"load_jax_params: missing "
                           f"{sorted(set(want) - set(got))}, unexpected "
                           f"{sorted(set(got) - set(want))}")
        for path, p in want.items():
            t = _numpy_to_torch(got[path])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(f"load_jax_params: {path} is {t.dtype} "
                                 f"{tuple(t.shape)}, expected {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
        return self

    # .... forward pieces ....
    def _embed(self, tokens) -> torch.Tensor:
        tok = torch.as_tensor(tokens, device=self.device).long()
        return self.emb[tok].to(self.cfg.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.emb.T if self.cfg.tie_embeddings else self.head
        return x @ head.to(x.dtype)

    # .... serving ....
    @torch.no_grad()
    def prefill(self, batch: dict):
        """batch {"tokens": [B, S] int}. Returns (last_logits [B, V], cache)
        with the cache in the decode layout, exactly S positions long
        (`cache_for_decode` gives it room to grow)."""
        cfg, P = self.cfg, self._params
        x = self._embed(batch["tokens"])
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)
        descs, n_groups = layer_pattern(cfg)
        raw = {f"b{j}": {n: torch.empty((n_groups, B, S, cfg.n_kv_heads,
                                         cfg.head_dim), dtype=cfg.dtype,
                                        device=x.device) for n in ("k", "v")}
               for j in range(len(descs))}
        for g in range(n_groups):
            gp = _layer(P["layers"], g)
            for j, desc in enumerate(descs):
                p = gp[f"b{j}"]
                x, (k, v) = L.gqa_prefill(
                    p["attn"], x, positions=positions, rope_theta=cfg.rope_theta,
                    norm_eps=cfg.norm_eps, with_cache=True,
                    backend=self.backend)
                raw[f"b{j}"]["k"][g] = k
                raw[f"b{j}"]["v"][g] = v
                if desc.ffn == "dense":
                    x = L.mlp_apply(p["mlp"], x, cfg.mlp_kind, cfg.norm_eps)
        x = L.rmsnorm(P["final_norm"], x[:, -1:], cfg.norm_eps)
        return self._logits(x)[:, 0], self._cache_from_prefill(raw, S)

    def _cache_from_prefill(self, raw: dict, S: int) -> dict:
        """[G,B,S,K,D] prefill K/V as the decode cache [G,B,NS,S/NS,K,D]
        (views, no copy): NS = kv_shards where it divides S, else 1."""
        ns = self.cfg.kv_shards if S % max(self.cfg.kv_shards, 1) == 0 else 1
        return {b: {n: x.reshape(x.shape[0], x.shape[1], ns, S // ns,
                                 *x.shape[3:]) for n, x in c.items()}
                for b, c in raw.items()}

    @torch.no_grad()
    def decode_step(self, cache: dict, token, pos: int):
        """token [B, 1] int, pos the host int position of the token. Writes
        its K/V into `cache` IN PLACE and returns (logits [B, V], cache). A
        position past the cache raises (the JAX package would clamp the
        write and overwrite the last slot)."""
        cfg, P = self.cfg, self._params
        pos = int(pos)
        ck = cache["b0"]["k"]
        max_len = ck.shape[2] * ck.shape[3]
        if not 0 <= pos < max_len:
            raise IndexError(f"decode_step: pos {pos} outside a cache of "
                             f"{max_len} positions; size it with "
                             "init_cache(batch, max_len) / cache_for_decode")
        descs, n_groups = layer_pattern(cfg)
        x = self._embed(token)
        for g in range(n_groups):
            gp = _layer(P["layers"], g)
            for j, desc in enumerate(descs):
                p = gp[f"b{j}"]
                c = {n: t[g] for n, t in cache[f"b{j}"].items()}
                x, _ = L.gqa_decode(p["attn"], x, c, pos,
                                    rope_theta=cfg.rope_theta,
                                    norm_eps=cfg.norm_eps)
                if desc.ffn == "dense":
                    x = L.mlp_apply(p["mlp"], x, cfg.mlp_kind, cfg.norm_eps)
        x = L.rmsnorm(P["final_norm"], x, cfg.norm_eps)
        return self._logits(x)[:, 0], cache

    # .... cache construction ....
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """A zero cache of max_len positions, [G,B,NS,max_len/NS,K,D] per
        attention block: NS = kv_shards where it divides max_len, else 1."""
        cfg = self.cfg
        descs, n_groups = layer_pattern(cfg)
        ns = cfg.kv_shards if max_len % max(cfg.kv_shards, 1) == 0 else 1
        shape = (n_groups, batch_size, ns, max_len // ns, cfg.n_kv_heads,
                 cfg.head_dim)
        return {f"b{j}": {n: torch.zeros(shape, dtype=cfg.dtype,
                                         device=self.device)
                          for n in ("k", "v")}
                for j in range(len(descs))}

    def cache_for_decode(self, cache: dict, max_len: int) -> dict:
        """A cache of max_len positions (`init_cache`) holding the
        positions of `cache` (a prefill's) at the front, whatever the two
        shardings: position p sits at shard p // Sc, offset p % Sc."""
        B = cache["b0"]["k"].shape[1]
        out = self.init_cache(B, max_len)
        for b, c in cache.items():
            for n, src in c.items():
                G, _, ns, sc, K, D = src.shape
                if ns * sc > max_len:
                    raise ValueError(f"cache_for_decode: {ns * sc} positions "
                                     f"do not fit max_len {max_len}")
                out[b][n].view(G, B, max_len, K, D)[:, :, :ns * sc] = \
                    src.reshape(G, B, ns * sc, K, D)
        return out


def build_model(cfg: ArchConfig, device: "str | torch.device" = "cuda",
                backend: str = "auto", seed: int = 0) -> Model:
    """The model with weights drawn from `seed` on `device` (`init_params`,
    a torch.Generator there). Without a GPU, device="cuda" raises."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, init_params(param_specs(cfg), gen, dev), backend=backend)
