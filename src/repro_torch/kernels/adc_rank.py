"""IVF-PQ ADC ranking: the device probe's step from a probed candidate
pool to the n_cand best candidates by asymmetric PQ distance.

For each query row and PQ segment mi the 256-entry table
`lut = (|q_mi|^2 - 2 q_mi.c) + |c|^2` is looked up by each candidate's
code and summed over the segments in ascending order; -1 lanes score
+inf; the n_cand smallest are kept in ascending order, the lower lane
first on ties (the order of the JAX package's `jax.lax.top_k(-adc)`).

Bit-identity between the kernel and the plain version rests on one
arithmetic order, fixed by `lut_segment`: qq, dot and cc are sums in
ascending s from 0, every multiply and add rounds on its own (separate
elementwise ops here, `__fmul_rn`/`__fadd_rn` in the kernel, never an
FMA or a cuBLAS product), and the selection is a STABLE ascending sort
(`torch.topk` leaves its tie order undefined and is not used).

`adc_rank` is the wrapper. On a CUDA tensor it launches the hand-written
kernel `csrc/adc_rank.cu` (which replaces the TPU kernel
`repro/kernels/adc_rank.py::adc_rank_pallas`; the source says what
bounds it and how it is laid out) and bumps `KERNEL.launches`. On a CPU
tensor it runs `adc_rank_plain`, the flat-LUT form in row blocks.
`adc_rank_chain` is the unblocked oracle: full LUT, code gather, sum,
stable sort.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_indices

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("adc_rank", {
    "adc_rank": (ctypes.c_int, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _P]),
})

#: most candidates the kernel keeps per row (its shared sort buffer:
#: 4096 x 8 B = 32 KB)
MAX_N_CAND = 4096
#: most PQ segments the kernel's shared LUT takes (64 x 256 x 4 B = 64 KB)
MAX_M = 64
#: the plain version scores at most this many (row, lane) pairs at once
PLAIN_LANES = 1 << 22


def lut_segment(q_mi: torch.Tensor, cb_mi: torch.Tensor) -> torch.Tensor:
    """f32 [b, 256] ADC table of ONE PQ segment, q_mi [b, seg], cb_mi
    [256, seg]: (qq - 2 dot) + cc with qq, dot, cc sums in ascending s
    from 0, each multiply and add a separate rounding — the arithmetic
    order the kernel follows."""
    b, seg = q_mi.shape
    qq = torch.zeros((b,), dtype=torch.float32, device=q_mi.device)
    dot = torch.zeros((b, cb_mi.shape[0]), dtype=torch.float32,
                      device=q_mi.device)
    cc = torch.zeros((cb_mi.shape[0],), dtype=torch.float32,
                     device=q_mi.device)
    for s in range(seg):
        qs, cs = q_mi[:, s], cb_mi[:, s]
        qq = qq + qs * qs
        dot = dot + qs[:, None] * cs[None, :]
        cc = cc + cs * cs
    return (qq[:, None] - 2.0 * dot) + cc[None, :]


def _check(q, codebooks, cand, codes, n_cand):
    if q.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError("adc_rank: q and codebooks must be float32")
    if cand.dtype != torch.int32 or codes.dtype != torch.uint8:
        raise TypeError(f"adc_rank: cand must be int32 and codes uint8, got "
                        f"{cand.dtype} / {codes.dtype}")
    for name, t in (("codebooks", codebooks), ("cand", cand),
                    ("codes", codes)):
        if t.device != q.device:
            raise ValueError(f"adc_rank: {name} is on {t.device}, q on "
                             f"{q.device}")
    if codebooks.ndim != 3 or codebooks.shape[1] != 256:
        raise ValueError(f"adc_rank: codebooks {tuple(codebooks.shape)} must "
                         "be [m, 256, seg]")
    m, _, seg = codebooks.shape
    if q.ndim != 2 or q.shape[1] != m * seg:
        raise ValueError(f"adc_rank: q {tuple(q.shape)} must be [b, m*seg] = "
                         f"[b, {m * seg}]")
    if cand.ndim != 2 or cand.shape[0] != q.shape[0]:
        raise ValueError(f"adc_rank: cand {tuple(cand.shape)} must be [b, C] "
                         f"with b = {q.shape[0]}")
    if codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(f"adc_rank: codes {tuple(codes.shape)} must be "
                         f"[n, {m}]")
    if not 0 <= n_cand <= cand.shape[1]:
        raise ValueError(f"adc_rank: n_cand={n_cand} outside [0, C="
                         f"{cand.shape[1]}]")


def _select(adc: torch.Tensor, cand: torch.Tensor, n_cand: int):
    """The n_cand lanes of smallest adc, ascending, lower lane first."""
    adc = adc.masked_fill(cand < 0, float("inf"))
    order = torch.sort(adc, dim=1, stable=True).indices[:, :n_cand]
    return cand.gather(1, order)


def adc_rank_chain(q: torch.Tensor, codebooks: torch.Tensor,
                   cand: torch.Tensor, codes: torch.Tensor, *,
                   n_cand: int) -> torch.Tensor:
    """The unblocked oracle: the full [b, m, 256] LUT, the [b, C, m] code
    gather, the segment sum (ascending, one add at a time), a stable
    sort. Same ids in the same order as `adc_rank_plain`."""
    _check(q, codebooks, cand, codes, n_cand)
    b = q.shape[0]
    m, _, seg = codebooks.shape
    qseg = q.reshape(b, m, seg)
    qq = torch.zeros((b, m), dtype=torch.float32, device=q.device)
    dot = torch.zeros((b, m, 256), dtype=torch.float32, device=q.device)
    cc = torch.zeros((m, 256), dtype=torch.float32, device=q.device)
    for s in range(seg):
        qs, cs = qseg[:, :, s], codebooks[:, :, s]
        qq = qq + qs * qs
        dot = dot + qs[:, :, None] * cs[None]
        cc = cc + cs * cs
    tables = (qq[:, :, None] - 2.0 * dot) + cc[None]            # [b, m, 256]
    code_blk = codes[cand.clamp(min=0).long()].long()           # [b, C, m]
    vals = tables.transpose(1, 2).gather(1, code_blk)           # [b, C, m]
    adc = torch.zeros(cand.shape, dtype=torch.float32, device=q.device)
    for mi in range(m):
        adc = adc + vals[:, :, mi]
    return _select(adc, cand, n_cand)


def adc_rank_plain(q: torch.Tensor, codebooks: torch.Tensor,
                   cand: torch.Tensor, codes: torch.Tensor, *,
                   n_cand: int) -> torch.Tensor:
    """The plain PyTorch version: per-segment [rows, 256] tables looked up
    and accumulated in ascending segment order, PLAIN_LANES (row, lane)
    pairs at a time."""
    _check(q, codebooks, cand, codes, n_cand)
    b, C = cand.shape
    m, _, seg = codebooks.shape
    qseg = q.reshape(b, m, seg)
    codes_t = codes.t().contiguous()                            # [m, n]
    out = torch.empty((b, n_cand), dtype=torch.int32, device=q.device)
    rows = max(1, PLAIN_LANES // max(C, 1))
    for i in range(0, b, rows):
        cb = cand[i:i + rows]
        safe = cb.clamp(min=0).long()
        adc = torch.zeros(cb.shape, dtype=torch.float32, device=q.device)
        for mi in range(m):
            lut = lut_segment(qseg[i:i + rows, mi], codebooks[mi])
            adc = adc + lut.gather(1, codes_t[mi][safe].long())
        out[i:i + rows] = _select(adc, cb, n_cand)
    return out


def adc_rank(q: torch.Tensor, codebooks: torch.Tensor, cand: torch.Tensor,
             codes: torch.Tensor, *, n_cand: int) -> torch.Tensor:
    """q f32 [b, m*seg], codebooks f32 [m, 256, seg], cand int32 [b, C]
    (-1 padded, live ids < n), codes uint8 [n, m]. Returns the n_cand
    best candidate ids int32 [b, n_cand] (n_cand <= C; -1 where fewer
    lanes are live). CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    n_cand = int(n_cand)
    if q.device.type == "cpu":
        return adc_rank_plain(q, codebooks, cand, codes, n_cand=n_cand)
    if q.device.type != "cuda":
        raise ValueError(f"adc_rank: unsupported device {q.device}")
    _check(q, codebooks, cand, codes, n_cand)
    b, C = cand.shape
    m, _, seg = codebooks.shape
    if n_cand > MAX_N_CAND or m > MAX_M:
        raise ValueError(f"adc_rank: n_cand={n_cand} / m={m} exceed the "
                         f"kernel's MAX_N_CAND={MAX_N_CAND} / MAX_M={MAX_M}")
    if check_indices() and cand.numel() and not bool(
            (cand < codes.shape[0]).all()):
        raise IndexError(f"adc_rank: candidate ids >= n={codes.shape[0]}")
    q, codebooks = q.contiguous(), codebooks.contiguous()
    cand, codes = cand.contiguous(), codes.contiguous()
    out = torch.empty((b, n_cand), dtype=torch.int32, device=q.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty((b, C), dtype=torch.int32, device=q.device)
    code = KERNEL.lib().adc_rank(
        q.data_ptr(), codebooks.data_ptr(), cand.data_ptr(), codes.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, C, m, seg, n_cand,
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    KERNEL.check(code)
    KERNEL.launches += 1
    return out
