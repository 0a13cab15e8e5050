"""Backend dispatch for the kernels (the port's `repro.kernels.ops`).

Backends:
  * "auto" — the kernel wrapper, which decides by where the tensor lies:
    a CUDA tensor launches the hand-written kernel, a CPU tensor runs its
    blocked plain PyTorch version. There is no fallback between the two.
  * "ref"  — the unblocked oracle (`kernels/ref.py`), the bit-for-bit
    reference of the engine tests.

No padding happens here: the kernels take any nq/nr/m and mask R rows
past `nr_valid` themselves, the probe kernels any row count, and the
attention kernel any S and T.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import adc_rank as adc_rank_kernel
from repro_torch.kernels import flash_attention as flash_attention_kernel
from repro_torch.kernels import fused_mlp, lsh_gather, ref
from repro_torch.kernels import range_count as range_count_kernel

BACKENDS = ("auto", "ref")


def check_backend(backend: str) -> str:
    """Validate a backend name."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    return backend


def range_count_hist(q: torch.Tensor, r: torch.Tensor, eps_grid: torch.Tensor,
                     *, metric: str = "cosine", backend: str = "auto",
                     nr_valid: int | None = None) -> torch.Tensor:
    """counts[i, j] = #-neighbors of q[i] in r[:nr_valid] within
    eps_grid[j], int32 [nq, m]; eps_grid sorted ascending."""
    if check_backend(backend) == "ref":
        return ref.range_count_hist(q, r[:nr_valid], eps_grid, metric)
    return range_count_kernel.range_count_hist(q, r, eps_grid, metric=metric,
                                               nr_valid=nr_valid)


def range_count(q: torch.Tensor, r: torch.Tensor, eps: float, *,
                metric: str = "cosine", backend: str = "auto",
                nr_valid: int | None = None) -> torch.Tensor:
    """Neighbor count within a single eps, int32 [nq]."""
    e = torch.tensor([float(eps)], dtype=torch.float32, device=q.device)
    return range_count_hist(q, r, e, metric=metric, backend=backend,
                            nr_valid=nr_valid)[:, 0]


def mlp_forward(params, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """Estimator inference, f32 [n]. params: (w [din,dout], b [1,dout])."""
    if check_backend(backend) == "ref":
        return ref.mlp_forward(params, x)
    return fused_mlp.mlp_forward(params, x)


def lsh_bucket_gather(tables: torch.Tensor, pb: torch.Tensor, *,
                      backend: str = "auto") -> torch.Tensor:
    """LSH member-table gather + multiprobe dedup, int32 [q, l*p*cap];
    tables int32 [l, B, cap], pb int32 [q, l, p]. Integers only: every
    backend gives the same ids."""
    if check_backend(backend) == "ref":
        return ref.lsh_bucket_gather(tables, pb)
    return lsh_gather.lsh_bucket_gather(tables, pb)


def adc_rank(q: torch.Tensor, codebooks: torch.Tensor, cand: torch.Tensor,
             codes: torch.Tensor, *, n_cand: int,
             backend: str = "auto") -> torch.Tensor:
    """IVF-PQ ADC ranking, the n_cand best candidate ids int32 [b, n_cand]
    (`kernels/adc_rank.py`). Every backend follows one arithmetic order
    and a stable selection, so all give the same ids in the same order."""
    if check_backend(backend) == "ref":
        return ref.adc_rank(q, codebooks, cand, codes, n_cand=n_cand)
    return adc_rank_kernel.adc_rank(q, codebooks, cand, codes, n_cand=n_cand)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_valid: int = -1,
                    backend: str = "auto") -> torch.Tensor:
    """Causal/GQA attention forward [B,S,H,Dv] in q's dtype; q [B,S,H,Dk],
    k [B,T,K,Dk], v [B,T,K,Dv], keys at or past kv_valid (< 0: T) masked
    (`kernels/flash_attention.py`). "ref" is the dense f32 softmax, which
    keeps p in f32: it agrees with the kernel to bf16 rounding."""
    if check_backend(backend) == "ref":
        return ref.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    return flash_attention_kernel.flash_attention(q, k, v, causal=causal,
                                                  kv_valid=kv_valid)
