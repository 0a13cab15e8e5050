"""LSH member-table gather + multiprobe dedup: the device probe's step
from probe bucket ids to candidate ids.

    cand[q, t, j*cap:(j+1)*cap] = tables[t, pb[q, t, j]]

with every probe j whose bucket id repeats an earlier probe j' < j of
the same (q, t) pair blanked to -1 (`lsh_probe_dup_mask`). The
multiprobe schedule pads itself by repeating the identity probe, so the
repeats are common; blanking them keeps the candidate SET (verification
sort-dedups ids and masks -1) while sparing the verify their width.

`lsh_bucket_gather` is the wrapper. On a CUDA tensor it launches the
hand-written kernel `csrc/lsh_gather.cu` (which replaces the TPU kernel
`repro/kernels/lsh_gather.py::lsh_bucket_gather_pallas`; the source says
what bounds it and how it is laid out) and bumps `KERNEL.launches`. On a
CPU tensor it runs `lsh_bucket_gather_plain`, the advanced-index gather
plus the dedup mask. Integers only: both are bit-identical.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_indices

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("lsh_gather", {
    "lsh_bucket_gather": (ctypes.c_int, [_P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _P]),
})


def lsh_probe_dup_mask(pb: torch.Tensor) -> torch.Tensor:
    """bool [..., p]: True where the probe's bucket id equals an EARLIER
    probe of the same (query, table) pair."""
    p = pb.shape[-1]
    eq = pb[..., :, None] == pb[..., None, :]
    earlier = torch.tril(torch.ones((p, p), dtype=torch.bool,
                                    device=pb.device), diagonal=-1)
    return (eq & earlier).any(dim=-1)


def _check(tables: torch.Tensor, pb: torch.Tensor) -> None:
    for name, t in (("tables", tables), ("pb", pb)):
        if t.dtype != torch.int32:
            raise TypeError(f"lsh_bucket_gather: {name} must be int32, got "
                            f"{t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"lsh_bucket_gather: {name} must be 3-D, got "
                             f"{tuple(t.shape)}")
    if tables.device != pb.device:
        raise ValueError(f"lsh_bucket_gather: tables on {tables.device}, pb "
                         f"on {pb.device}")
    if pb.shape[1] != tables.shape[0]:
        raise ValueError(f"lsh_bucket_gather: pb {tuple(pb.shape)} probes "
                         f"{pb.shape[1]} tables, tables has {tables.shape[0]}")


def lsh_bucket_gather_plain(tables: torch.Tensor,
                            pb: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: advanced-index gather + dedup mask."""
    _check(tables, pb)
    q, l, _ = pb.shape
    t_idx = torch.arange(l, device=pb.device)[None, :, None]
    cand = tables[t_idx, pb.long()]                     # [q, l, p, cap]
    cand = cand.masked_fill(lsh_probe_dup_mask(pb)[..., None], -1)
    return cand.reshape(q, -1)


def lsh_bucket_gather(tables: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """tables int32 [l, B, cap] (-1 padded), pb int32 [q, l, p] probe
    bucket ids in [0, B). Returns int32 [q, l*p*cap] candidate ids,
    duplicate probes blanked to -1. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if pb.device.type == "cpu":
        return lsh_bucket_gather_plain(tables, pb)
    if pb.device.type != "cuda":
        raise ValueError(f"lsh_bucket_gather: unsupported device {pb.device}")
    _check(tables, pb)
    tables, pb = tables.contiguous(), pb.contiguous()
    q, l, p = pb.shape
    _, nb, cap = tables.shape
    if check_indices() and pb.numel() and not bool(
            ((pb >= 0) & (pb < nb)).all()):
        raise IndexError(f"lsh_bucket_gather: probe bucket ids outside "
                         f"[0, {nb})")
    out = torch.empty((q, l * p * cap), dtype=torch.int32, device=pb.device)
    if out.numel() == 0:
        return out
    code = KERNEL.lib().lsh_bucket_gather(
        tables.data_ptr(), pb.data_ptr(), out.data_ptr(), q, l, nb, cap, p,
        pb.device.index or 0, torch.cuda.current_stream(pb.device).cuda_stream)
    KERNEL.check(code)
    KERNEL.launches += 1
    return out
