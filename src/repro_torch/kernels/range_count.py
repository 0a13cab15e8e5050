"""Fused tiled pairwise-distance + eps-histogram: the range count under
the ground-truth table, the exact verify of the filter's positives and
`NaiveJoin`.

`range_count_hist` is the wrapper. On a CUDA tensor it launches the
hand-written kernel `csrc/range_count.cu` (which replaces the TPU kernel
`repro/kernels/range_count.py::range_count_hist_pallas`; the source says
what bounds it and how it is laid out) and bumps `KERNEL.launches`. On a
CPU tensor it runs `range_count_hist_plain`, the blocked PyTorch version
of the same function, which the CPU tests check against the JAX package
and `chip_smoke.py` holds the kernel against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("range_count", {
    "range_count_hist": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _P]),
})

#: largest eps grid the kernel's per-row shared histogram holds
#: (64 rows x 512 bins x 4 B = 128 KB of the 227 KB a CTA may use)
MAX_M = 512
METRICS = ("cosine", "l2")


def _check(q, r, eps_grid, metric, nr_valid):
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    for name, t in (("q", q), ("r", r), ("eps_grid", eps_grid)):
        if t.dtype != torch.float32:
            raise TypeError(f"range_count_hist: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"range_count_hist: {name} is on {t.device}, "
                             f"q on {q.device}")
    if q.ndim != 2 or r.ndim != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"range_count_hist: q {tuple(q.shape)} and r "
                         f"{tuple(r.shape)} must be [n, d] of one width")
    if eps_grid.ndim != 1:
        raise ValueError("range_count_hist: eps_grid must be 1-D")
    nrv = r.shape[0] if nr_valid is None else int(nr_valid)
    if not 0 <= nrv <= r.shape[0]:
        raise ValueError(f"range_count_hist: nr_valid={nrv} outside "
                         f"[0, {r.shape[0]}]")
    return nrv


#: the plain version's [query, R] tile: its compare temporary is
#: O(PLAIN_TILE[0] * PLAIN_TILE[1] * m)
PLAIN_TILE = (256, 512)


def range_count_hist_plain(q: torch.Tensor, r: torch.Tensor,
                           eps_grid: torch.Tensor, *, metric: str = "cosine",
                           nr_valid: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: the same counts, tile by tile. Rows of r
    at or past `nr_valid` never count."""
    nrv = _check(q, r, eps_grid, metric, nr_valid)
    bq, br = PLAIN_TILE
    out = torch.zeros((q.shape[0], eps_grid.shape[0]), dtype=torch.int32,
                      device=q.device)
    for i in range(0, q.shape[0], bq):
        qb = q[i:i + bq]
        acc = out[i:i + bq]
        for j in range(0, nrv, br):
            dots = qb @ r[j:min(j + br, nrv)].T
            if metric == "cosine":
                d = 1.0 - dots
            else:
                d = torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
            acc += (d[:, :, None] <= eps_grid[None, None, :]).sum(
                dim=1, dtype=torch.int32)
    return out


def range_count_hist(q: torch.Tensor, r: torch.Tensor, eps_grid: torch.Tensor,
                     *, metric: str = "cosine",
                     nr_valid: int | None = None) -> torch.Tensor:
    """counts[i, j] = #{k < nr_valid : d(q_i, r_k) <= eps_grid[j]}, int32
    [nq, m]; eps_grid f32 sorted ascending, any nq/nr/m (m <= MAX_M on the
    card). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return range_count_hist_plain(q, r, eps_grid, metric=metric,
                                      nr_valid=nr_valid)
    if q.device.type != "cuda":
        raise ValueError(f"range_count_hist: unsupported device {q.device}")
    nrv = _check(q, r, eps_grid, metric, nr_valid)
    m = eps_grid.shape[0]
    if m > MAX_M:
        raise ValueError(f"range_count_hist: m={m} eps values exceed the "
                         f"kernel's MAX_M={MAX_M}")
    q, r, eps_grid = q.contiguous(), r.contiguous(), eps_grid.contiguous()
    out = torch.empty((q.shape[0], m), dtype=torch.int32, device=q.device)
    if out.numel() == 0:
        return out
    code = KERNEL.lib().range_count_hist(
        q.data_ptr(), r.data_ptr(), eps_grid.data_ptr(), out.data_ptr(),
        q.shape[0], nrv, q.shape[1], m, int(metric == "l2"),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    KERNEL.check(code)
    KERNEL.launches += 1
    return out
