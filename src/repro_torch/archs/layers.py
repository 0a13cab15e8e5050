"""Transformer layers of the LM stack: RMSNorm, RoPE, flash-style
attention, GQA attention blocks with the sharded KV cache, and MLPs. The
port of `repro/archs/layers.py` for the dense family's serving path,
weights in the JAX layouts (`wq` [d, H, Dh], `wo` [H, Dh, d]) and
activations as [B, S, H, D].

Prefill attention (`attention`) runs the hand-written kernel through
`kernels.ops.flash_attention`; `flash_attention` and `chunked_attention`
are the JAX package's two plain online-softmax paths, with windows and
query offsets, which no caller of the port reaches yet. Decode attention is `sharded_flash_decode` over the
[B, NS, Sc, K, D] cache: a partial softmax per shard and a log-sum-exp
merge over NS.

Not ported yet (ROADMAP queue 1 item 18): sliding-window attention's
ring-buffer cache and `_masked_decode`, and MLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.archs.spec import ParamSpec
from repro_torch.kernels import ops

_NEG = -1e30
_LATER = "waits for ROADMAP queue 1 item 18 (the other families)"


# --------------------------------------------------------------------- norms
def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x [..., S, H, D] (D even), positions [..., S] or [S]. The rotated
    pairs are interleaved, (x[..., 0::2], x[..., 1::2]), not split halves;
    angles and products in f32. theta == 0 disables RoPE."""
    if theta == 0:
        return x
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.float()[..., None] * freqs                  # [.., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------- flash attention
def _attn_mask(key_pos, q_pos, kv_valid, causal: bool, window: int):
    mask = key_pos[None, :] < kv_valid
    if causal:
        mask = mask & (key_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (key_pos[None, :] > q_pos[:, None] - window)
    return mask  # [S, chunk]


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_valid: int = -1,
                    chunk: int = 512) -> torch.Tensor:
    """Memory-linear online-softmax attention, forward only (the JAX
    package's custom-VJP path; its backward comes with training). bf16
    operands give f32 scores, p is cast to v's dtype for the PV product.
    q [B,S,H,Dk]; k [B,T,K,Dk]; v [B,T,K,Dv]; T % chunk == 0; kv_valid < 0
    means all T keys are valid."""
    B, S, H, Dk = q.shape
    T, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    if T % chunk:
        raise ValueError(f"flash_attention: T {T} is not a multiple of "
                         f"chunk {chunk}")
    scale = 1.0 / math.sqrt(Dk)
    valid = T if kv_valid < 0 else kv_valid
    qg = q.reshape(B, S, K, G, Dk).float()
    q_pos = q_offset + torch.arange(S, device=q.device)
    m = torch.full((B, K, G, S), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, Dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, chunk):
        kc = k[:, c0:c0 + chunk].float()
        vc = v[:, c0:c0 + chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kc) * scale
        key_pos = c0 + torch.arange(chunk, device=q.device)
        mask = _attn_mask(key_pos, q_pos, valid, causal, window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(v.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, kv_valid: int | None = None,
                      chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention with every operand in f32 (p too).
    q [B,S,H,Dk], k [B,T,K,Dk], v [B,T,K,Dv], H % K == 0. Keys are padded
    to a chunk multiple here; kv_valid masks the tail. Returns
    [B,S,H,Dv]."""
    B, S, H, Dk = q.shape
    T, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    chunk = min(chunk, T)
    if T % chunk:  # pad keys to a chunk multiple; kv_valid masks the tail
        pad = chunk - T % chunk
        k = torch.cat([k, k.new_zeros((B, pad, K, Dk))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, K, Dv))], dim=1)
        kv_valid = min(T if kv_valid is None else kv_valid, T)
        T = T + pad
    valid = T if kv_valid is None else kv_valid
    scale = 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, S, K, G, Dk).float()
    q_pos = q_offset + torch.arange(S, device=q.device)
    m = torch.full((B, K, G, S), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, Dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, chunk):
        s = torch.einsum("bskgd,btkd->bkgst", qg,
                         k[:, c0:c0 + chunk].float()) * scale
        key_pos = c0 + torch.arange(chunk, device=q.device)
        mask = _attn_mask(key_pos, q_pos, valid, causal, window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, v[:, c0:c0 + chunk].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv).to(q.dtype)


def sharded_flash_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                         valid_len: int) -> torch.Tensor:
    """Single-token decode over a seq-sharded cache: q [B,1,H,Dk],
    kc [B,NS,Sc,K,Dk], vc [B,NS,Sc,K,Dv], positions < valid_len live.
    A partial softmax per shard (f32 scores, p cast to the cache's dtype
    for PV), then the log-sum-exp merge over NS. Returns [B,1,H,Dv]."""
    B, _, H, Dk = q.shape
    _, NS, Sc, K, _ = kc.shape
    Dv = vc.shape[-1]
    G = H // K
    scale = 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, K, G, Dk).float()
    s = torch.einsum("bkgd,bnskd->bnkgs", qg, kc.float()) * scale
    key_pos = (torch.arange(NS, device=q.device)[:, None] * Sc
               + torch.arange(Sc, device=q.device)[None, :])
    mask = (key_pos < valid_len)[None, :, None, None, :]        # [1,NS,1,1,Sc]
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1)                                          # [B,NS,K,G]
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bnkgs,bnskd->bnkgd", p.to(vc.dtype).float(),
                       vc.float())
    M = m.amax(dim=1, keepdim=True)                             # [B,1,K,G]
    w = torch.exp(m - M)
    l_tot = (l * w).sum(dim=1)                                  # [B,K,G]
    acc_tot = (acc * w[..., None]).sum(dim=1)                   # [B,K,G,Dv]
    out = acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k1: torch.Tensor, v1: torch.Tensor, pos: int):
    """Write one token's K/V [B, K, D] at position `pos` of the sharded
    [B,NS,Sc,K,D] cache, IN PLACE (the JAX package returns a new cache),
    and return the two tensors. A position outside the cache raises here
    on the host; the JAX package's dynamic_update_slice would clamp it
    onto the last slot of the shard."""
    B, NS, Sc, K, D = cache_k.shape
    pos = int(pos)
    if not 0 <= pos < NS * Sc:
        raise IndexError(f"cache_update: position {pos} outside a cache of "
                         f"{NS * Sc} positions; size it with "
                         "Model.init_cache(batch, max_len) / cache_for_decode")
    shard, off = divmod(pos, Sc)
    cache_k[:, shard, off] = k1.to(cache_k.dtype)
    cache_v[:, shard, off] = v1.to(cache_v.dtype)
    return cache_k, cache_v


def attention(q, k, v, *, causal: bool = True,
              backend: str = "auto") -> torch.Tensor:
    """Prefill attention, always through `ops.flash_attention(backend=)`
    (the hand-written kernel on the card). The JAX package pads the keys
    to a chunk multiple and masks the pad; the kernel takes any T and
    masks its ragged last tile itself, so the keys go in as they are and
    the function is the same."""
    return ops.flash_attention(q, k, v, causal=causal, backend=backend)


# ------------------------------------------------------------ GQA attention
def gqa_specs(d: int, n_heads: int, n_kv: int, d_head: int, dtype) -> dict:
    return {
        "norm": rmsnorm_spec(d),
        "wq": ParamSpec((d, n_heads, d_head), ("embed", "heads", "head_dim"), dtype),
        "wk": ParamSpec((d, n_kv, d_head), ("embed", "kv_heads", "head_dim"), dtype),
        "wv": ParamSpec((d, n_kv, d_head), ("embed", "kv_heads", "head_dim"), dtype),
        "wo": ParamSpec((n_heads, d_head, d), ("heads", "head_dim", "embed"), dtype,
                        init="scaled"),
    }


def _heads_in(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", h, w) as one matmul."""
    d, H, Dh = w.shape
    return (h @ w.reshape(d, H * Dh)).reshape(*h.shape[:-1], H, Dh)


def _heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, w) as one matmul."""
    H, Dh, d = w.shape
    return o.reshape(*o.shape[:-2], H * Dh) @ w.reshape(H * Dh, d)


def gqa_prefill(p: dict, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool = True, window: int = 0, rope_theta: float = 1e4,
                norm_eps: float = 1e-5, with_cache: bool = False,
                backend: str = "auto"):
    """Full-sequence attention block, x [B,S,d]. Returns (y, (k, v) or
    None), k/v [B,S,K,Dh] after RoPE."""
    if window > 0:
        raise NotImplementedError(f"sliding-window attention {_LATER}")
    h = rmsnorm(p["norm"], x, norm_eps)
    q = rope(_heads_in(h, p["wq"]), positions, rope_theta)
    k = rope(_heads_in(h, p["wk"]), positions, rope_theta)
    v = _heads_in(h, p["wv"])
    o = attention(q, k, v, causal=causal, backend=backend)
    y = x + _heads_out(o, p["wo"])
    return (y, (k, v)) if with_cache else (y, None)


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, pos: int, *,
               window: int = 0, rope_theta: float = 1e4,
               norm_eps: float = 1e-5):
    """One-token decode, x [B,1,d], at position `pos` (a host int). cache
    {"k", "v"}: [B,NS,Sc,K,Dh], updated in place. Returns (y, cache)."""
    if window > 0:
        raise NotImplementedError(f"the sliding-window ring-buffer cache "
                                  f"and _masked_decode {_LATER}")
    h = rmsnorm(p["norm"], x, norm_eps)
    positions = torch.full((1,), int(pos), device=x.device)
    q = rope(_heads_in(h, p["wq"]), positions, rope_theta)
    k1 = rope(_heads_in(h, p["wk"]), positions, rope_theta)[:, 0]
    v1 = _heads_in(h, p["wv"])[:, 0]
    ck, cv = cache_update(cache["k"], cache["v"], k1, v1, pos)
    o = sharded_flash_decode(q, ck, cv, int(pos) + 1)
    y = x + _heads_out(o, p["wo"])
    return y, {"k": ck, "v": cv}


# ----------------------------------------------------------------------- MLP
def mlp_specs(d: int, f: int, kind: str, dtype) -> dict:
    if kind == "swiglu":
        return {
            "norm": rmsnorm_spec(d),
            "w_gate": ParamSpec((d, f), ("embed", "mlp"), dtype),
            "w_up": ParamSpec((d, f), ("embed", "mlp"), dtype),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), dtype, init="scaled"),
        }
    return {
        "norm": rmsnorm_spec(d),
        "w_in": ParamSpec((d, f), ("embed", "mlp"), dtype),
        "w_out": ParamSpec((f, d), ("mlp", "embed"), dtype, init="scaled"),
    }


def mlp_apply(p: dict, x: torch.Tensor, kind: str,
              norm_eps: float = 1e-5) -> torch.Tensor:
    """Pre-norm residual MLP: SwiGLU, or GELU (tanh form, jax.nn.gelu's
    default)."""
    h = rmsnorm(p["norm"], x, norm_eps)
    if kind == "swiglu":
        return x + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
    return x + F.gelu(h @ p["w_in"], approximate="tanh") @ p["w_out"]
