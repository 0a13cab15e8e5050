"""Causal/GQA flash-attention forward: the attention of every prefill layer
of the LM stack (`archs/layers.py::attention`).

`flash_attention` is the wrapper. On a CUDA tensor it launches the
hand-written kernel `csrc/flash_attention.cu` (which replaces the TPU
kernel `repro/kernels/flash_attention.py::flash_attention_pallas`; the
source says what bounds it and how it is laid out) and bumps
`KERNEL.launches`. On a CPU tensor it runs `flash_attention_plain`, the
blocked PyTorch version with the kernel's arithmetic: the same kv tiles,
the same online-softmax order, p rounded to v's dtype before the PV
product (the bf16 kernel's exp is the SFU's, a few ulps from torch.exp).
Unlike the TPU kernel, both take any S and T: the ragged last query tile
and the keys at or past `kv_valid` are masked inside.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("flash_attention", {
    "flash_attention_fwd": (ctypes.c_int, [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _I, _I, _I, _I,
                                           ctypes.c_float, _I, _I, _P]),
})

NEG = -1e30
#: head dims of the bf16 (tensor-core) instantiations, Dk == Dv
BF16_HEAD_DIMS = (16, 32, 64, 128)
#: largest Dk, Dv of the f32 (CUDA-core) instantiation
F32_MAX_HEAD_DIM = 128


def kv_tile(dtype: torch.dtype) -> int:
    """Keys per kv tile of the kernel: 64 for bf16, 32 for f32. The tile
    decides where p is rounded to v's dtype (through the running max), so
    the plain version walks the same tiles."""
    return 64 if dtype == torch.bfloat16 else 32


def scale_of(dk: int) -> float:
    """1/sqrt(Dk) as the JAX kernel forms it (float64, then f32 at the
    multiply)."""
    return 1.0 / math.sqrt(dk)


def _check(q, k, v, kv_valid):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q [B,S,H,Dk], k [B,T,K,Dk], "
                         "v [B,T,K,Dv] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dk = q.shape
    T, K = k.shape[1], k.shape[2]
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != Dk
            or K == 0 or H % K):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match "
                         "(H % K == 0 required)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share a dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    return T if kv_valid < 0 else min(int(kv_valid), T)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          kv_valid: int = -1) -> torch.Tensor:
    """The plain PyTorch version, kv tile by kv tile as the kernel walks
    them: s = (q.k) * scale in f32, masked to -1e30, m/l/acc updated in
    the JAX kernel's order, p cast to v's dtype for the PV product.
    Under causal masking the rows before a tile's first key see none of
    it and are left as they are (the kernel's block skip, which leaves
    them bit for bit the same). Returns [B,S,H,Dv] in q's dtype."""
    valid = _check(q, k, v, kv_valid)
    B, S, H, Dk = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    G = H // K
    qg = q.reshape(B, S, K, G, Dk).permute(0, 2, 3, 1, 4).float()
    kg = k.permute(0, 2, 1, 3).float()                       # [B,K,T,Dk]
    vg = v.permute(0, 2, 1, 3)                               # [B,K,T,Dv]
    m = torch.full((B, K, G, S), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, Dv), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(S, device=q.device)
    end = min(valid, S) if causal else valid
    tile, scale = kv_tile(q.dtype), scale_of(Dk)
    for k0 in range(0, end, tile):
        r0 = k0 if causal else 0
        key = k0 + torch.arange(min(tile, k.shape[1] - k0), device=q.device)
        mask = (key[None, :] < valid)
        if causal:
            mask = mask & (key[None, :] <= q_pos[r0:, None])
        s = torch.einsum("bkgsd,bktd->bkgst", qg[:, :, :, r0:],
                         kg[:, :, k0:k0 + tile]) * scale
        s = torch.where(mask, s, NEG)
        m_prev = m[..., r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m_prev - m_new)
        l[..., r0:] = l[..., r0:] * alpha + p.sum(dim=-1)
        acc[..., r0:, :] = acc[..., r0:, :] * alpha[..., None] + torch.einsum(
            "bkgst,bktd->bkgsd", p.to(v.dtype).float(),
            vg[:, :, k0:k0 + tile].float())
        m[..., r0:] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv).to(q.dtype)


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x itself where the kernel can read it by strides (unit last stride,
    16-byte aligned rows), else a contiguous copy."""
    align = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % align == 0 for s in x.stride()[:-1]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_valid: int = -1) -> torch.Tensor:
    """Causal/GQA attention forward, [B,S,H,Dv] in q's dtype. q [B,S,H,Dk],
    k [B,T,K,Dk], v [B,T,K,Dv], H % K == 0, any S and T; keys at or past
    kv_valid (< 0: T) are masked. CUDA tensors launch the kernel (bf16:
    Dk == Dv in BF16_HEAD_DIMS; f32: Dk, Dv <= 128); CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    valid = _check(q, k, v, kv_valid)
    B, S, H, Dk = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype == torch.bfloat16 and not (Dk == Dv and Dk in BF16_HEAD_DIMS):
        raise ValueError(f"flash_attention: bf16 kernel takes Dk == Dv in "
                         f"{BF16_HEAD_DIMS}, got Dk {Dk}, Dv {Dv}")
    if q.dtype == torch.float32 and max(Dk, Dv) > F32_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: f32 kernel takes Dk, Dv <= "
                         f"{F32_MAX_HEAD_DIM}, got {Dk}, {Dv}")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    code = KERNEL.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, S, H, T, K, Dk, Dv, valid, int(causal), scale_of(Dk),
        1 if q.dtype == torch.bfloat16 else 0, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    KERNEL.check(code)
    KERNEL.launches += 1
    return out
