"""Plain unblocked oracles for every kernel in this package, plus the
boundary-tie rule that count comparisons are held to. The ADC ranking's
oracle is `kernels/adc_rank.py::adc_rank_chain`, re-exported here as
`adc_rank`.

Clarity over speed: these are the references the tests and
`chip_smoke.py` compare against, never a path the join runs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.adc_rank import adc_rank_chain as adc_rank


def pair_distances(q: torch.Tensor, r: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances between unit-normalized rows of q [nq,d] and r [nr,d]."""
    dots = q.float() @ r.float().T
    if metric == "cosine":
        return 1.0 - dots
    if metric == "l2":
        return torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
    raise ValueError(f"unknown metric {metric!r}")


def range_count_hist(q: torch.Tensor, r: torch.Tensor, eps_grid: torch.Tensor,
                     metric: str = "cosine") -> torch.Tensor:
    """counts[i, j] = #{rows r_k of r : d(q_i, r_k) <= eps_grid[j]}. int32
    [nq, m]; eps_grid sorted ascending."""
    d = pair_distances(q, r, metric)
    eps = eps_grid.to(device=d.device, dtype=torch.float32)
    cmp = d[:, :, None] <= eps[None, None, :]
    return cmp.sum(dim=1, dtype=torch.int32)


def range_count(q: torch.Tensor, r: torch.Tensor, eps: float,
                metric: str = "cosine") -> torch.Tensor:
    """counts[i] = #-neighbors of q_i within eps. int32 [nq]."""
    e = torch.tensor([float(eps)], dtype=torch.float32, device=q.device)
    return range_count_hist(q, r, e, metric)[:, 0]


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP regressor forward. params: sequence of (w [din,dout],
    b [1,dout]); no ReLU after the last layer, whose dout must be 1.
    Returns f32 [n]."""
    h = x.float()
    for i, (w, b) in enumerate(params):
        h = h @ w.float() + b.float().reshape(1, -1)
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[:, 0]


def lsh_bucket_gather(tables: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """cand[q, t, j*cap:(j+1)*cap] = tables[t, pb[q, t, j]], a probe whose
    bucket id repeats an earlier probe of the same (q, t) blanked to -1.
    int32 [q, l*p*cap]; one probe at a time."""
    q, l, p = pb.shape
    rows = torch.arange(l, device=pb.device)[None, :]
    blocks = []
    for j in range(p):
        blk = tables[rows, pb[:, :, j].long()]              # [q, l, cap]
        dup = torch.zeros((q, l), dtype=torch.bool, device=pb.device)
        for jp in range(j):
            dup |= pb[:, :, jp] == pb[:, :, j]
        blocks.append(torch.where(dup[..., None], torch.full_like(blk, -1),
                                  blk))
    return torch.stack(blocks, dim=2).reshape(q, -1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_valid: int = -1) -> torch.Tensor:
    """Dense masked softmax attention in f32: every score at once, keys at
    or past kv_valid (< 0: T) and, when causal, keys after the query
    masked; a row with no live key gives 0. q [B,S,H,Dk], k [B,T,K,Dk],
    v [B,T,K,Dv], H % K == 0; returns [B,S,H,Dv] in q's dtype."""
    B, S, H, Dk = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    valid = T if kv_valid < 0 else min(int(kv_valid), T)
    qg = q.float().reshape(B, S, K, H // K, Dk)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / np.sqrt(Dk)
    key = torch.arange(T, device=q.device)
    mask = (key[None, :] < valid).expand(S, T)
    if causal:
        mask = mask & (key[None, :] <= torch.arange(S, device=q.device)[:, None])
    s = torch.where(mask, s, -torch.inf)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    o = o / torch.clamp(p.sum(dim=-1), min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, H, Dv).to(q.dtype)


# ------------------------------------------------------- boundary ties
def tie_tolerance(dim: int) -> float:
    """Dot-product window around eps inside which an f32 count may differ
    from another f32 count: d * 2^-24 bounds the accumulation error of an
    f32 dot of two unit vectors of dimension d (|sum q_i r_i| <= 1), and
    8 * 2^-24 more covers the rounding of the distance formula (1 - c,
    or sqrt(max(2 - 2c, 0)) seen through its derivative)."""
    return (int(dim) + 8) * 2.0 ** -24


def _dot_at_eps(eps: torch.Tensor, metric: str) -> torch.Tensor:
    """The dot product at which the distance equals eps (float64)."""
    e = eps.double()
    return 1.0 - e if metric == "cosine" else 1.0 - e * e / 2.0


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):           # copy: the array may be read-only
        x = torch.from_numpy(np.array(x))
    return torch.as_tensor(x, device=device)


def count_mismatches(a, b, q, r, eps_grid, metric: str, *,
                     nr_valid: int | None = None,
                     at_most: bool = False) -> dict:
    """Hold two neighbour-count tables against each other up to boundary
    ties. a, b: int [nq, m] counts of q's neighbours in r[:nr_valid]
    within eps_grid [m]. A mismatch at (i, j) is accepted only if
    |a - b| is at most the number of rows whose float64 dot with q_i lies
    within `tie_tolerance` of the dot at eps_j. Float64 dots are computed
    only for the rows that mismatch, on q's device.

    `at_most=True` holds an approximate count a (found among candidates)
    against the exact b: a below b is no mismatch, a above b must be
    explained by ties.

    Returns {"ok", "n_mismatch", "max_abs_diff", "n_unexplained"}."""
    q = _tensor(q)
    dev = q.device
    a = _tensor(a, dev).long().reshape(q.shape[0], -1)
    b = _tensor(b, dev).long().reshape(q.shape[0], -1)
    r = _tensor(r, dev)
    eps = _tensor(eps_grid, dev).reshape(-1)
    nrv = r.shape[0] if nr_valid is None else int(nr_valid)
    diff = (a - b).clamp(min=0) if at_most else (a - b).abs()
    pairs = torch.nonzero(diff > 0)
    out = {"n_mismatch": int(pairs.shape[0]),
           "max_abs_diff": int(diff.max()) if diff.numel() else 0,
           "n_unexplained": 0}
    if pairs.shape[0]:
        rows, inv = torch.unique(pairs[:, 0], return_inverse=True)
        dots = q[rows].double() @ r[:nrv].double().T          # [k, nrv]
        c_eps = _dot_at_eps(eps, metric)
        tol = tie_tolerance(q.shape[1])
        for s in range(0, pairs.shape[0], 256):
            sl = slice(s, s + 256)
            near = (dots[inv[sl]] - c_eps[pairs[sl, 1]][:, None]).abs() <= tol
            ties = near.sum(dim=1)
            d = diff[pairs[sl, 0], pairs[sl, 1]]
            out["n_unexplained"] += int((d > ties).sum())
    out["ok"] = out["n_unexplained"] == 0
    return out
