"""Backend dispatch for the kernels (the port's `repro.kernels.ops`).

Backends:
  * "auto" — the kernel wrapper, which decides by where the tensor lies:
    a CUDA tensor launches the hand-written kernel, a CPU tensor runs its
    blocked plain PyTorch version. There is no fallback between the two.
  * "ref"  — the unblocked oracle (`kernels/ref.py`), the bit-for-bit
    reference of the engine tests.

No padding happens here: the kernels take any nq/nr/m and mask R rows
past `nr_valid` themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_mlp, ref
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
