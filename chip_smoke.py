#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`src/repro_torch`): XJoin end to end
on one CUDA card at the paper's data scale, then Xling in front of LSH
and IVF-PQ with the index probe on the card, then TinyLlama-1.1B prefill
and greedy decode at full width.

    python3 chip_smoke.py [--epochs 3] [--seed 0]

Phases, one JSON line each:
  0 device  — the card (`nvidia-smi` name and power limit), torch/CUDA
              versions, and the nvcc build of all five kernels from
              `csrc/` (one nvcc per source, started together).
  1 kernels — each hand-written kernel against its plain PyTorch version
              on the card at the main path's shapes (the range count also
              at the full 120 000 x 120 000 ground-truth sweep; the probe
              kernels on the LSH tables and IVF-PQ state of phase 4's
              indexes, built here once more on their own):
              CUDA-event medians of one call (for the probe kernels also
              the profiler's device time per call, without the host's
              launch time), the bound (bytes over 3.35 TB/s vs fp32
              operations over 67 TFLOP/s, the larger), the plain
              version's time and the nearest PyTorch call as a partial
              yardstick (cuBLAS `q @ r.T`; the gather without the dedup;
              `torch.topk` over precomputed ADC values). The attention
              kernel at TinyLlama's layer shapes (H 32, K 4, D 64, bf16,
              unit-normal inputs) for both request batches of phase lm
              (S = T = 4096 and 4000), with keys masked by kv_valid (4000
              of 4096), and at B 1 x S 32 768, the prefill_32k length; held
              to the plain version row by row (max |kernel - plain| over
              a row of D within 2^-6 of the row's max |plain|, two bf16
              steps) and to a max abs error of 1e-2; its bound is the
              causal half's bf16 operations over 989 TFLOP/s vs the q, k,
              v, out bytes; its yardstick `scaled_dot_product_attention`
              (is_causal, K/V heads repeated), which the port never calls.
  2 fit     — glove stand-in, n = 150 000 (R 120 000 x 200, S 30 000):
              `JoinPlan(R).filter("xling", tau=50, xdt="fpr",
              estimator="rmi", epochs=E).search("naive")`; the ground-truth
              sweep and the RMI fit (1/2/4 sub-MLPs at 512/512/256/128)
              run on the card. E (default 3, the paper trains longer) is
              the one cut, a cut in depth, and is printed as `reduced`.
  3 serve   — `plan.stream(S in batches of 4096, eps=0.45, depth=2)`;
              every batch's counts are held against the plain oracle on
              the card (exact up to boundary ties for searched queries, 0
              for skipped ones); then one more pass of the same stream
              under torch.profiler gives the device busy share.
  4 probe   — the same R, S, batches, eps and tau and the SAME fitted
              filter, in two plans sharing phase 2's engine:
              `verify("lsh")` and `verify("ivfpq")`, both
              `on(probe="device")` (index defaults: LSH k 18, l 10,
              n_probes 4, W 2.5; IVF-PQ C 300, m 25, n_probe 50,
              n_candidates 1000). Per route: index build seconds, LSH
              overflow_frac, probe-table bytes, skip fraction, recall
              against phase 3's exact counts, batch latency, q/s, host
              syncs and kernel launches per batch; every batch's counts
              equal those of the same route run with the plain versions
              of both probe kernels, and never above the exact counts
              beyond boundary ties; then a profiled second pass.
  5 lm      — `tinyllama_1_1b` CONFIG at full width (22 layers, d 2048,
              32/4 heads, bf16), weights drawn from --seed on the card,
              `build_model(backend="auto")`. Two request batches of B 8:
              prompts of S 4096 and S 4000 (a ragged last query and kv
              tile, keys not padded); each is prefilled
              (a warm-up prefill and two decode steps first), then 16
              greedy decode steps, each timed to its sync, run into
              a cache of S + 16 positions (`cache_for_decode`). Prefill ms
              (time to first token), prompt tokens/s, decode ms a step
              and tokens/s, peak memory, `reduced`; exactly 22 attention
              launches a prefill and none while decoding. Checks: the
              kernel route against `backend="ref"` at B 1 x S 4096 and the
              first decode step against prefill(S + 1), both within 2e-2
              of max |logit| (the JAX package's prefill/decode bound), the
              head product taken in f32 for these checks so that the
              bound sits above the logits' own bf16 rounding; every logit
              finite. Then one profiled prefill and decode.
Then the card's `nvidia-smi` line, the kernels summary line, and
{"ok": true, "device": {...}} as the last line. Every kernel counter is
zeroed just before phase 2 and read right after phase 3, zeroed again
just before each route of phase 4 and read right after it, and just
before phase 5's timed requests and read right after them: the
launches reported are those of the main paths only. Any failure raises
and exits non-zero; without a CUDA device it exits 2 before printing a
result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32, outside the tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase."""
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(nbytes: float, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of fn() in ms, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device time of one call's `kernel` launches in ms: the profiler's
    device time of the kernels whose name holds `kernel`, over `reps`
    calls. Unlike `cuda_ms` it leaves out the host's time to launch, which
    a kernel of a few microseconds does not hide."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key)
    assert total > 0, f"the profiler saw no {kernel} launch"
    return total / 1e3 / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def range_count_case(q, r, eps, metric: str, reps: int, *,
                     library: bool = True) -> dict:
    """Kernel vs plain version at one shape; raises on a disagreement
    beyond boundary ties. Both were just run once, so timing needs no
    further warm-up. `library` times cuBLAS `q @ r.T` (the dots alone:
    no single PyTorch call computes the histogram) where its output fits
    the card."""
    import torch
    from repro_torch.kernels import range_count
    from repro_torch.kernels.ref import count_mismatches
    got = range_count.range_count_hist(q, r, eps, metric=metric)
    want = range_count.range_count_hist_plain(q, r, eps, metric=metric)
    torch.cuda.synchronize()
    check = count_mismatches(got, want, q, r, eps, metric)
    assert check["ok"], ("range_count kernel disagrees with its plain "
                         f"version beyond boundary ties: {check}")
    nq, d = q.shape
    nr, m = r.shape[0], eps.shape[0]
    bound_ms, bound_by = bound(4 * (nq * d + nr * d + m + nq * m),
                               2.0 * nq * nr * d)
    return {"shape": {"nq": nq, "nr": nr, "d": d, "m": m, "metric": metric},
            "max_abs_err": check["max_abs_diff"],
            "n_tie_mismatches": check["n_mismatch"],
            "ms": cuda_ms(lambda: range_count.range_count_hist(
                q, r, eps, metric=metric), reps, warmup=0),
            "plain_ms": cuda_ms(lambda: range_count.range_count_hist_plain(
                q, r, eps, metric=metric), 1, warmup=0),
            "library_ms": cuda_ms(lambda: q @ r.T, reps) if library else None,
            "library": ("torch.matmul q @ r.T (cuBLAS fp32): the dots only"
                        if library else "none: q @ r.T would be 4 nq nr bytes"),
            "bound_ms": bound_ms, "bound_by": bound_by}


def mlp_case(d0: int, n: int, gen, reps: int) -> dict:
    """Kernel vs plain version at the estimator's widths; raises beyond
    |a - b| <= 1e-4 + 1e-4 |b|."""
    import torch
    from repro_torch.kernels import fused_mlp
    from repro_torch.models.mlp import PAPER_WIDTHS
    dims = (d0,) + PAPER_WIDTHS + (1,)
    params = [((torch.randn(a, b, generator=gen) * (2.0 / a) ** 0.5).cuda(),
               (torch.randn(1, b, generator=gen) * 0.1).cuda())
              for a, b in zip(dims[:-1], dims[1:])]
    x = torch.randn(n, d0, generator=gen).cuda()
    got = fused_mlp.mlp_forward(params, x)
    want = fused_mlp.mlp_forward_plain(params, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    wbytes = 4 * sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    bound_ms, bound_by = bound(4 * n * (d0 + 1) + wbytes, 2.0 * n * macs)
    return {"shape": {"n": n, "dims": list(dims)},
            "max_abs_err": float((got - want).abs().max()),
            "tolerance": "|a-b| <= 1e-4 + 1e-4|b|",
            "ms": cuda_ms(lambda: fused_mlp.mlp_forward(params, x), reps),
            "plain_ms": cuda_ms(lambda: fused_mlp.mlp_forward_plain(params, x),
                                reps),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def lsh_gather_case(tables, pb, reps: int) -> dict:
    """Kernel vs plain version on the LSH member tables; raises unless the
    ids are equal. Yardstick: the advanced-index gather alone, without
    the dedup."""
    import torch
    from repro_torch.kernels import lsh_gather
    got = lsh_gather.lsh_bucket_gather(tables, pb)
    want = lsh_gather.lsh_bucket_gather_plain(tables, pb)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    assert mismatches == 0, f"lsh_bucket_gather: {mismatches} ids differ"
    q, l, p = pb.shape
    cap = tables.shape[2]
    t_idx = torch.arange(l, device=pb.device)[None, :, None]
    pbl = pb.long()
    bound_ms, bound_by = bound(4 * q * l * p * (1 + 2 * cap), 0.0)
    return {"shape": {"q": q, "l": l, "B": tables.shape[1], "cap": cap,
                      "p": p},
            "max_abs_err": 0, "mismatches": mismatches,
            "dup_blanked_frac": float((got < 0).float().mean()
                                      - (tables[t_idx, pbl] < 0)
                                      .float().mean()),
            "ms": cuda_ms(lambda: lsh_gather.lsh_bucket_gather(tables, pb),
                          reps),
            "device_ms": device_ms(lambda: lsh_gather.lsh_bucket_gather(
                tables, pb), reps, "lsh_bucket_gather_kernel"),
            "plain_ms": cuda_ms(lambda: lsh_gather.lsh_bucket_gather_plain(
                tables, pb), reps),
            "library_ms": cuda_ms(lambda: tables[t_idx, pbl], reps),
            "library": "tables[arange(l), pb] advanced indexing: the gather "
                       "without the dedup",
            "bound_ms": bound_ms, "bound_by": bound_by}


def adc_rank_case(q, cbs, cand, codes, n_cand: int, reps: int) -> dict:
    """Kernel vs plain version on a probed IVF-PQ pool; raises unless the
    ids are equal, in order. Yardstick: `torch.topk` over precomputed ADC
    values, the selection alone."""
    import torch
    from repro_torch.kernels import adc_rank
    got = adc_rank.adc_rank(q, cbs, cand, codes, n_cand=n_cand)
    want = adc_rank.adc_rank_plain(q, cbs, cand, codes, n_cand=n_cand)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    assert mismatches == 0, f"adc_rank: {mismatches} ids differ"
    b, C = cand.shape
    m, _, seg = cbs.shape
    live = int((cand >= 0).sum())
    adc = torch.rand((b, C), device=q.device)
    bound_ms, bound_by = bound(
        4 * q.numel() + 4 * cbs.numel() + 4 * cand.numel() + codes.numel()
        + 4 * b * n_cand,
        b * m * 256 * (6.0 * seg + 3) + float(live) * m)
    return {"shape": {"b": b, "C": C, "m": m, "seg": seg,
                      "n": codes.shape[0], "n_cand": n_cand},
            "live_frac": live / max(b * C, 1),
            "max_abs_err": 0, "mismatches": mismatches,
            "ms": cuda_ms(lambda: adc_rank.adc_rank(q, cbs, cand, codes,
                                                    n_cand=n_cand), reps),
            "device_ms": device_ms(lambda: adc_rank.adc_rank(
                q, cbs, cand, codes, n_cand=n_cand), reps, "adc_rank_kernel"),
            "plain_ms": cuda_ms(lambda: adc_rank.adc_rank_plain(
                q, cbs, cand, codes, n_cand=n_cand), 1, warmup=0),
            "library_ms": cuda_ms(lambda: torch.topk(adc, n_cand, dim=1,
                                                     largest=False), reps),
            "library": "torch.topk(adc, n_cand, largest=False) over a "
                       "precomputed [b, C] matrix: the selection alone",
            "bound_ms": bound_ms, "bound_by": bound_by}


def causal_pairs(S: int, kv_valid: int, causal: bool) -> int:
    """(query, key) pairs the attention must score: each query sees the
    keys below kv_valid, and under causal masking none after itself."""
    if not causal:
        return S * kv_valid
    n = min(S, kv_valid)                 # queries 0..n-1 see i + 1 keys
    return n * (n + 1) // 2 + (S - n) * kv_valid


#: kernel vs plain, per output row (b, s, h): max |kernel - plain| over the
#: row's D values within this share of the row's max |plain|. Both round
#: p to bf16 at the same kv tiles; they differ by where the bf16 output
#: rounds (one step, <= 2^-7 of the row's max) and by the SFU's exp
#: flipping a p's rounding (<= 2^-8 of it). An output of a long row is
#: small (std ~ sqrt(e/n) for n keys), so the row scale, not an absolute
#: bound, is what a dropped kv tile (~8/sqrt(e n) of it: 0.027 at n 32 768)
#: or a lost row would break.
FLASH_ROW_REL = 2.0 ** -6


def row_rel_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| along the last axis."""
    got, want = got.float(), want.float()
    num = (got - want).abs().amax(dim=-1)
    den = want.abs().amax(dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def flash_case(B: int, S: int, T: int, kv_valid: int, cfg, gen,
               reps: int) -> dict:
    """Kernel vs plain version at one prefill layer's shapes (unit-normal
    bf16 q, k, v; keys at or past kv_valid masked); raises beyond
    FLASH_ROW_REL row by row or a max abs error of 1e-2. Yardstick:
    `scaled_dot_product_attention` with is_causal on the live keys, K/V
    heads repeated to H."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))
    got = fa.flash_attention(q, k, v, causal=True, kv_valid=kv_valid)
    want = fa.flash_attention_plain(q, k, v, causal=True, kv_valid=kv_valid)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    row_err = row_rel_err(got, want)
    assert torch.isfinite(got).all() and err <= 1e-2, \
        f"flash_attention B {B} S {S}: max abs error {err} > 1e-2"
    assert row_err <= FLASH_ROW_REL, \
        f"flash_attention B {B} S {S} T {T}: row error {row_err} > 2^-6"
    pairs = causal_pairs(S, kv_valid, True)
    bound_ms, bound_by = bound(2 * (2 * B * S * H * D + 2 * B * kv_valid * K * D),
                               4.0 * B * H * D * pairs, BF16_FLOP_PER_S)
    qh = q.transpose(1, 2)
    kh, vh = (x[:, :kv_valid].repeat_interleave(H // K, dim=2).transpose(1, 2)
              for x in (k, v))
    lib = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
    del got, want, lib

    def kernel():
        return fa.flash_attention(q, k, v, causal=True, kv_valid=kv_valid)
    dev_ms = device_ms(kernel, reps, "flash_fwd_bf16_kernel")
    return {"shape": {"B": B, "S": S, "T": T, "kv_valid": kv_valid, "H": H,
                      "K": K, "D": D, "dtype": "bfloat16", "causal": True},
            "max_abs_err": err, "max_row_rel_err": row_err,
            "tolerance": "per row (b, s, h): max |kernel - plain| <= 2^-6 "
                         "max |plain|; and max |kernel - plain| <= 1e-2",
            "ms": cuda_ms(kernel, reps), "device_ms": dev_ms,
            "device_tflops": 4.0 * B * H * D * pairs / 1e9 / dev_ms,
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True, kv_valid=kv_valid), 1, warmup=0),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), reps),
            "library": "F.scaled_dot_product_attention(is_causal=True) on "
                       "[B,H,S,D] views, K/V heads repeated to H (a yardstick; "
                       "the port never calls it)",
            "library_max_abs_err_vs_plain": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by}


@contextlib.contextmanager
def f32_head(*models):
    """The models' head product in f32 (the final hidden state widened)
    while the model-level checks run, so that their 2e-2 bound sits above
    the logits' own bf16 rounding. The served path keeps bf16 logits, as
    the JAX package does."""
    for m in models:
        head = m.emb.T if m.cfg.tie_embeddings else m.head
        m._logits = lambda x, head=head: x.float() @ head.float()
    try:
        yield
    finally:
        for m in models:
            del m._logits


def lm_phase(seed: int) -> int:
    """Phase 5 (module docstring). Returns the attention kernel's launches
    on the main path (both requests' prefills and decodes)."""
    import torch
    from repro_torch.archs import Model, build_model, make_batch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("tinyllama_1_1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", backend="auto", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, n_dec = 8, 16
    prompts = [make_batch(cfg, "prefill", B, S, seed=seed + i,
                          device="cuda")["tokens"]
               for i, S in enumerate((4096, 4000))]
    for toks in prompts:                # warm-up of both paths, untimed
        logits, cache = model.prefill({"tokens": toks})
        cache = model.cache_for_decode(cache, toks.shape[1] + 2)
        nxt = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        for i in range(2):
            model.decode_step(cache, nxt, toks.shape[1] + i)
        del cache
    torch.cuda.synchronize()

    def sync_s(t):
        torch.cuda.synchronize()
        return time.perf_counter() - t
    # ---- main path: counter zeroed, both requests driven, counter read ----
    fa.KERNEL.launches = 0
    runs = []
    for toks in prompts:
        S = toks.shape[1]
        at = fa.KERNEL.launches
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": toks})
        nxt = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        prefill_s = sync_s(t0)
        prefill_launches = fa.KERNEL.launches - at
        t0 = time.perf_counter()
        cache = model.cache_for_decode(cache, S + n_dec)
        grow_s = sync_s(t0)
        at = fa.KERNEL.launches
        tok, steps, step_s = nxt, [logits], []
        for i in range(n_dec):
            t0 = time.perf_counter()
            step_logits, cache = model.decode_step(cache, tok, S + i)
            tok = step_logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            step_s.append(sync_s(t0))
            steps.append(step_logits)
        runs.append(dict(S=S, toks=toks, nxt=nxt, steps=steps,
                         prefill_s=prefill_s, grow_s=grow_s, step_s=step_s,
                         prefill_launches=prefill_launches,
                         decode_launches=fa.KERNEL.launches - at))
        del cache
    launches = fa.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    # ---- main path over: the checks below launch the kernel uncounted ----
    for r in runs:
        assert r["prefill_launches"] == cfg.n_layers, r["prefill_launches"]
        assert r["decode_launches"] == 0, r["decode_launches"]
        assert all(bool(torch.isfinite(x).all()) for x in r["steps"]), \
            "a logit is not finite"
    ref = Model(cfg, model.param_tree(), backend="ref")
    with f32_head(model, ref):
        for r in runs:
            S = r["S"]
            _, cache = model.prefill({"tokens": r["toks"]})
            cache = model.cache_for_decode(cache, S + 1)
            first, _ = model.decode_step(cache, r["nxt"], S)
            full, _ = model.prefill(
                {"tokens": torch.cat([r["toks"], r["nxt"]], 1)})
            r["decode_vs_prefill"] = float((first - full).abs().max()
                                           / full.abs().max())
            assert r["decode_vs_prefill"] < 2e-2, r["decode_vs_prefill"]
            del cache
        one = {"tokens": prompts[0][:1]}
        got, _ = model.prefill(one)
        want, _ = ref.prefill(one)
    assert got.dtype == torch.float32
    kernel_vs_ref = float((got - want).abs().max() / want.abs().max())
    assert kernel_vs_ref < 2e-2, kernel_vs_ref
    del ref, got, want
    torch.cuda.empty_cache()

    # one more prefill and a decode step under the profiler
    toks = prompts[0]
    prof_prefill = profile_call(lambda: model.prefill({"tokens": toks}), 10)
    _, cache = model.prefill({"tokens": toks})
    cache = model.cache_for_decode(cache, toks.shape[1] + 1)
    prof_decode = profile_call(lambda: model.decode_step(
        cache, runs[0]["nxt"], toks.shape[1]), 10)
    # the profiler's own host cost inflates its wall: the idle share of a
    # step is also read against the unprofiled step time
    step_ms = 1e3 * statistics.median(runs[0]["step_s"])
    prof_decode["device_idle_share_of_timed_step"] = \
        1 - prof_decode["device_busy_ms"] / step_ms
    del cache
    emit("lm", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.param_dtype,
         n_params=sum(p.numel() for p in model.parameters()),
         weights=f"random, torch.Generator seed {seed}", init_s=init_s,
         backend="auto",
         reduced={"seq": "4096 and 4000 (prefill_32k cell: 32 768)",
                  "batch": "8 (prefill_32k cell: 32)",
                  "decode": f"{n_dec} greedy steps a request",
                  "weights": "random from --seed: no TinyLlama checkpoint "
                             "in the repository"},
         requests=[{
             "batch": B, "prompt_len": r["S"],
             "prefill_ms": 1e3 * r["prefill_s"],
             "prompt_tokens_per_s": B * r["S"] / r["prefill_s"],
             "cache_grow_ms": 1e3 * r["grow_s"],
             "decode_steps": n_dec,
             "decode_ms_per_step": 1e3 * sum(r["step_s"]) / n_dec,
             "decode_ms_steps": [1e3 * x for x in r["step_s"]],
             "decode_tokens_per_s": B * n_dec / sum(r["step_s"]),
             "flash_attention_launches": {"prefill": r["prefill_launches"],
                                          "decode": r["decode_launches"]},
             "decode_vs_prefill_rel": r["decode_vs_prefill"],
             "greedy_tokens_row0": [int(x[0].argmax()) for x in r["steps"]],
         } for r in runs],
         kernel_vs_ref_rel_B1_S4096=kernel_vs_ref,
         tolerance="max |a - b| / max |b| < 2e-2 (tests/test_archs.py:60), "
                   "f32 logits (head product in f32)",
         max_memory_allocated_bytes=peak, launches=launches,
         profile_prefill_B8_S4096=prof_prefill,
         profile_decode_step_B8=prof_decode)
    return launches


def plain_lsh_probe(qpos, proj, bias, salt, tables, expand, *, metric, W,
                    n_probes, n_buckets):
    """The LSH probe with the plain version of its kernel."""
    from repro_torch.core.probe import _lsh_pb
    from repro_torch.kernels.lsh_gather import lsh_bucket_gather_plain
    return lsh_bucket_gather_plain(tables, _lsh_pb(
        qpos, proj, bias, salt, expand, metric=metric, W=W,
        n_probes=n_probes, n_buckets=n_buckets))


def plain_ivfpq_probe(q, centroids, lists, codes, codebooks, *, n_probe,
                      n_cand):
    """The IVF-PQ probe with the plain version of its kernel, in the same
    row tiles as the package's probe."""
    import torch
    from repro_torch.core.probe import ivfpq_pool, probe_tile_rows
    from repro_torch.kernels.adc_rank import adc_rank_plain
    tile = probe_tile_rows(n_probe * lists.shape[1])
    out = torch.empty((q.shape[0], n_cand), dtype=torch.int32,
                      device=q.device)
    for i in range(0, q.shape[0], tile):
        qb = q[i:i + tile]
        out[i:i + tile] = adc_rank_plain(
            qb, codebooks, ivfpq_pool(qb, centroids, lists, n_probe=n_probe),
            codes, n_cand=n_cand)
    return out


class PlainProbeKernels:
    """The engine-cached index `join`, probed on the card with the PLAIN
    PyTorch versions of the probe kernels: the route phase 4 holds the
    kernels' route against (a plug-in DeviceSearcher that is its own
    probe spec). It probes the very tables the kernels' route uploaded."""

    def __init__(self, join):
        self.join, self.metric, self.R = join, join.metric, join.R
        self.name = f"{join.name}-plain"

    def candidates(self, Q):
        """The index's host probe."""
        return self.join.candidates(Q)

    def device_probe(self, eps=None):
        """This object is the probe spec."""
        return self

    def place(self, engine):
        """A placed probe over the kernels' route's uploaded state."""
        import functools
        from repro_torch.core.probe import PlacedProbe
        j, ref = self.join, engine.device_probe_for(self.join, "device")
        fn = (functools.partial(plain_lsh_probe, metric=j.metric, W=j.W,
                                n_probes=j.n_probes, n_buckets=j.n_buckets)
              if j.name == "lsh" else
              functools.partial(plain_ivfpq_probe, n_probe=j.n_probe,
                                n_cand=ref.cand_width))
        return PlacedProbe(engine, name=self.name, probe_fn=fn,
                           state=ref.state,
                           table_bytes=ref.table_bytes_per_device,
                           cand_width=ref.cand_width)


def profile_serve(plan, batches, eps: float) -> dict:
    """One more pass of the same stream under torch.profiler. Runs after
    the main path's counters are read."""
    def run():
        for _ in plan.stream(batches, eps, depth=2):
            pass
    return profile_call(run)


def profile_call(fn, top: int = 8) -> dict:
    """fn() under torch.profiler: device busy share (kernel + copy time
    over wall time) and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): host ops that launched
    # them report the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_ms if rows else None,
            "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
            "top_device_ms": [{"name": k[:80], "ms": ms, "calls": n}
                              for k, ms, n in rows[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3,
                    help="estimator epochs (a cut in depth; paper: 30)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on a CUDA card only", file=sys.stderr)
        return 2
    from repro_torch.core import JoinPlan
    from repro_torch.core.joins import IVFPQJoin, LSHJoin
    from repro_torch.core.probe import (_lsh_pb, ivfpq_pool, ivfpq_state,
                                        lsh_state)
    from repro_torch.data import load_dataset
    from repro_torch.configs import get_config
    from repro_torch.kernels import (adc_rank, build, fused_mlp, lsh_gather,
                                     range_count)
    from repro_torch.kernels.ref import count_mismatches
    from repro_torch.utils import set_fp32_precision
    set_fp32_precision()
    kind = torch.cuda.get_device_name(0)

    # ---------------------------------------------------------- 0: device
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    built = build.build("range_count", "fused_mlp", "lsh_gather", "adc_rank",
                        "flash_attention")
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in built.items()})

    # --------------------------------------------------------- 1: kernels
    R, S, spec = load_dataset("glove", n=150000, seed=args.seed)
    Rd, Sd = torch.from_numpy(R).cuda(), torch.from_numpy(S).cuda()
    grid = torch.linspace(0.4, 0.9, 100, device="cuda")
    gR, gS, _ = load_dataset("gist", n=40960, seed=args.seed)
    rc_cases = [
        range_count_case(Sd[:4096], Rd, grid, "cosine", reps=5),
        range_count_case(Rd, Rd, grid, "cosine", reps=3, library=False),
        range_count_case(torch.from_numpy(gS[:1024]).cuda(),
                         torch.from_numpy(gR).cuda(),
                         torch.linspace(0.5, 2.0, 100, device="cuda"), "l2",
                         reps=5),
        range_count_case(Sd[:1024], Rd,
                         torch.tensor([0.45], device="cuda"), "cosine",
                         reps=5),
    ]
    gen = torch.Generator().manual_seed(args.seed)
    mlp_cases = [mlp_case(201, 8192, gen, reps=20),
                 mlp_case(961, 8192, gen, reps=20)]
    # the probe kernels on phase 4's index state, built here on its own
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # LSH overflow
        k_lsh = LSHJoin(R, spec.metric, device="cuda")
    k_ivf = IVFPQJoin(R, spec.metric, device="cuda")
    index_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    proj, bias, salt, tables, expand = lsh_state(k_lsh, dev)
    centroids, lists, codes, codebooks = ivfpq_state(k_ivf, dev)
    n_cand = min(k_ivf.n_candidates, k_ivf.n_probe * k_ivf.lists.shape[1])
    lsh_cases, adc_cases = [], []
    for nq in (640, 4096):
        qd = Sd[:nq]
        pb = _lsh_pb(qd, proj, bias, salt, expand, metric=spec.metric,
                     W=k_lsh.W, n_probes=k_lsh.n_probes,
                     n_buckets=k_lsh.n_buckets)
        lsh_cases.append(lsh_gather_case(tables, pb, reps=20))
        pool = ivfpq_pool(qd, centroids, lists, n_probe=k_ivf.n_probe)
        adc_cases.append(adc_rank_case(qd, codebooks, pool, codes, n_cand,
                                       reps=5))
        del pool
    lm_cfg = get_config("tinyllama_1_1b")
    gen_cuda = torch.Generator(device="cuda").manual_seed(args.seed)
    fa_cases = [flash_case(8, 4096, 4096, 4096, lm_cfg, gen_cuda, reps=10),
                flash_case(8, 4000, 4000, 4000, lm_cfg, gen_cuda, reps=10),
                flash_case(8, 4000, 4096, 4000, lm_cfg, gen_cuda, reps=3),
                flash_case(1, 32768, 32768, 32768, lm_cfg, gen_cuda, reps=3)]
    emit("kernels", range_count=rc_cases, mlp_forward=mlp_cases,
         lsh_bucket_gather=lsh_cases, adc_rank=adc_cases,
         flash_attention=fa_cases, probe_index_build_s=index_s)
    del proj, bias, salt, tables, expand, centroids, lists, codes, codebooks
    torch.cuda.empty_cache()

    # ----------------------------------- 2: fit (main path starts here)
    kernels = {"range_count": range_count, "fused_mlp": fused_mlp,
               "lsh_bucket_gather": lsh_gather, "adc_rank": adc_rank}
    for mod in kernels.values():
        mod.KERNEL.launches = 0
    plan = (JoinPlan(R, spec.metric)
            .filter("xling", tau=50, xdt="fpr", estimator="rmi",
                    epochs=args.epochs)
            .search("naive").on(cache_key=None, device="cuda"))
    t0 = time.perf_counter()
    plan.build()
    filt = plan._built.filter.filt
    fit_launches = {"range_count": range_count.KERNEL.launches,
                    "fused_mlp": fused_mlp.KERNEL.launches}
    emit("fit", n_index=len(R), dim=int(R.shape[1]), n_queries=len(S),
         estimator="rmi", stage_sizes=list(filt.estimator.stage_sizes),
         widths=list(filt.estimator.widths), epochs=args.epochs,
         reduced={"epochs": f"{args.epochs} (XlingConfig default 30)"},
         build_s=time.perf_counter() - t0, sweep_s=filt.stats["sweep_s"],
         fit_s=filt.stats["fit_s"], train_tuples=filt.stats["train_tuples"],
         final_loss=filt.stats["final_loss"], launches=fit_launches)

    # ------------------------------------------------------------ 3: serve
    eps, bs = 0.45, 4096
    batches = [S[i:i + bs] for i in range(0, len(S), bs)]
    engine = plan.engine
    engine.host_syncs.clear()
    pulled, results, latency_ms = [], [], []
    at_first_batch = {}

    def feed():
        for b in batches:
            if not pulled:      # the session is open: XDT is calibrated
                at_first_batch.update(range_count=range_count.KERNEL.launches,
                                      fused_mlp=fused_mlp.KERNEL.launches)
            pulled.append(time.perf_counter())
            yield b
    t0 = time.perf_counter()
    for res in plan.stream(feed(), eps, depth=2):
        latency_ms.append(1e3 * (time.perf_counter() - pulled[len(results)]))
        results.append(res)
    serve_s = time.perf_counter() - t0
    launches = {"range_count": range_count.KERNEL.launches,
                "fused_mlp": fused_mlp.KERNEL.launches}
    xdt_launches = {k: at_first_batch[k] - fit_launches[k] for k in launches}
    serve_launches = {k: launches[k] - at_first_batch[k] for k in launches}
    syncs = dict(engine.host_syncs)
    # ---- main path over: the checks below launch kernels uncounted ----
    assert len(results) == len(batches)
    assert serve_launches["fused_mlp"] > 0, "the filter never ran the kernel"
    assert serve_launches["range_count"] > 0, "verify never ran the kernel"
    (params, fn), thr = plan._filter_state(eps)
    eps1 = torch.tensor([eps], device="cuda")
    found = true_total = 0
    n_searched = 0
    trues, masks = [], []       # exact counts, verdicts: for phase 4
    for b, res in zip(batches, results):
        qd = torch.from_numpy(b).cuda()
        X = torch.cat([qd, torch.full((len(b), 1), eps, device="cuda")], 1)
        with torch.no_grad():
            searched = (fn(params, X) > float(np.float32(thr))).cpu().numpy()
        assert res.counts.shape == (len(b),) and res.counts.dtype == np.int32
        assert int(searched.sum()) == res.n_searched
        assert (res.counts[~searched] == 0).all()
        true = range_count.range_count_hist_plain(
            qd, Rd, eps1, metric=spec.metric)[:, 0].cpu().numpy()
        check = count_mismatches(res.counts[searched], true[searched],
                                 qd[torch.from_numpy(searched).cuda()], Rd,
                                 eps1, spec.metric)
        assert check["ok"], f"served counts disagree with the oracle: {check}"
        trues.append(true)
        masks.append(searched)
        found += int(np.minimum(res.counts, true).sum())
        true_total += int(true.sum())
        n_searched += res.n_searched
    prof = profile_serve(plan, batches, eps)
    emit("serve", eps=eps, tau=50, batch=bs, n_batches=len(batches),
         depth=2, threshold=float(thr), skip_frac=1 - n_searched / len(S),
         recall=found / max(true_total, 1), batch_latency_ms=latency_ms,
         serve_s=serve_s, queries_per_s=len(S) / serve_s,
         host_syncs_per_batch={k: v / len(batches) for k, v in syncs.items()},
         xdt_calibration_launches=xdt_launches, launches=serve_launches,
         launches_per_batch={k: v / len(batches)
                             for k, v in serve_launches.items()},
         profile_second_pass=prof)

    # ------------------------------------------------------------ 4: probe
    probe_launches = {}
    for name in ("lsh", "ivfpq"):
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            join = engine.verifier(name)
        index_build_s = time.perf_counter() - t0
        pplan = (JoinPlan(R, spec.metric).filter(filt, tau=50, xdt="fpr")
                 .search("naive").verify(name)
                 .on(engine=engine, probe="device", device="cuda"))
        t0 = time.perf_counter()
        pplan.build()
        pthr = pplan._filter_state(eps)[1]      # XDT, before the counters
        plan_build_s = time.perf_counter() - t0
        desc = pplan.describe()["exec"]["probe"]
        # phase 1's kernel rows ran on this route's index state
        assert (np.array_equal(join.tables, k_lsh.tables) if name == "lsh"
                else all(np.array_equal(getattr(join, k), getattr(k_ivf, k))
                         for k in ("centroids", "lists", "codes",
                                   "codebooks"))), \
            f"{name}: the engine's index differs from phase 1's"
        # ---- this route's main path: counters zeroed, driven, read ----
        for mod in kernels.values():
            mod.KERNEL.launches = 0
        engine.host_syncs.clear()
        ppulled, presults, platency = [], [], []

        def pfeed():
            for b in batches:
                ppulled.append(time.perf_counter())
                yield b
        t0 = time.perf_counter()
        for res in pplan.stream(pfeed(), eps, depth=2):
            platency.append(1e3 * (time.perf_counter()
                                   - ppulled[len(presults)]))
            presults.append(res)
        pserve_s = time.perf_counter() - t0
        plaunch = {k: mod.KERNEL.launches for k, mod in kernels.items()}
        psyncs = dict(engine.host_syncs)
        # ---- route over: the checks below launch kernels uncounted ----
        probe_launches[name] = plaunch
        kname = "lsh_bucket_gather" if name == "lsh" else "adc_rank"
        assert len(presults) == len(batches)
        assert plaunch[kname] > 0, f"the {name} route never ran {kname}"
        assert psyncs == {"n_pos": len(batches), "result": len(batches)}, \
            f"{name} route host syncs: {psyncs}"
        assert float(pthr) == float(thr), "XDT threshold differs"
        plain = (JoinPlan(R, spec.metric).filter(filt, tau=50, xdt="fpr")
                 .search("naive").verify(PlainProbeKernels(join))
                 .on(engine=engine, probe="device", device="cuda"))
        pfound = pn_searched = ptrue_searched = 0
        for b, res, pres, true, mask in zip(
                batches, presults, plain.stream(batches, eps, depth=2),
                trues, masks):
            assert res.meta["probe"] == "device" == pres.meta["probe"]
            np.testing.assert_array_equal(res.counts, pres.counts,
                                          err_msg=f"{name}: kernels vs plain")
            check = count_mismatches(res.counts, true,
                                     torch.from_numpy(b).cuda(), Rd, eps1,
                                     spec.metric, at_most=True)
            assert check["ok"], f"{name} counts above the exact: {check}"
            pfound += int(np.minimum(res.counts, true).sum())
            ptrue_searched += int(true[mask].sum())
            pn_searched += res.n_searched
        assert pn_searched == n_searched, "phase 4 searched other queries"
        pprof = profile_serve(pplan, batches, eps)
        emit("probe", route=name, verify=name, probe="device",
             index_params={k: getattr(join, k) for k in (
                 ("k", "l", "n_probes", "W", "n_buckets", "cap")
                 if name == "lsh" else
                 ("C", "m", "seg", "n_probe", "n_candidates"))},
             index_build_s=index_build_s, plan_build_s=plan_build_s,
             same_index_as_phase1=True,
             overflow_frac=desc["overflow_frac"],
             warnings=[str(w.message) for w in caught],
             probe_table_bytes=desc["table_bytes"],
             cand_width=desc["cand_width"],
             pool_width=(None if name == "lsh"
                         else join.n_probe * join.lists.shape[1]),
             skip_frac=1 - pn_searched / len(S),
             recall=pfound / max(true_total, 1),
             recall_of_searched=pfound / max(ptrue_searched, 1),
             batch_latency_ms=platency, serve_s=pserve_s,
             queries_per_s=len(S) / pserve_s,
             host_syncs_per_batch={k: v / len(batches)
                                   for k, v in psyncs.items()},
             launches=plaunch,
             launches_per_batch={k: v / len(batches)
                                 for k, v in plaunch.items()},
             equal_to_plain_kernels_route=True,
             profile_second_pass=pprof)

    # --------------------------------------------------------------- 5: lm
    lm_launches = lm_phase(args.seed)

    # ------------------------------------------------------------- summary
    print(smi, flush=True)
    first_rc, first_mlp = rc_cases[0], mlp_cases[0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": "range_count", "route": "cuda",
         "source": "src/repro_torch/csrc/range_count.cu",
         "replaces": "src/repro/kernels/range_count.py:117",
         "launches": launches["range_count"],
         **{k: first_rc[k] for k in keys}, "shape": first_rc["shape"],
         "other_shapes": rc_cases[1:]},
        {"name": "mlp_forward", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_mlp.cu",
         "replaces": "src/repro/kernels/fused_mlp.py:64",
         "launches": launches["fused_mlp"],
         **{k: first_mlp[k] for k in keys}, "shape": first_mlp["shape"],
         "other_shapes": mlp_cases[1:]},
        {"name": "lsh_bucket_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/lsh_gather.cu",
         "replaces": "src/repro/kernels/lsh_gather.py:121",
         "launches": probe_launches["lsh"]["lsh_bucket_gather"],
         **{k: lsh_cases[0][k] for k in keys + ("device_ms",)},
         "shape": lsh_cases[0]["shape"],
         "other_shapes": lsh_cases[1:]},
        {"name": "adc_rank", "route": "cuda",
         "source": "src/repro_torch/csrc/adc_rank.cu",
         "replaces": "src/repro/kernels/adc_rank.py:174",
         "launches": probe_launches["ivfpq"]["adc_rank"],
         **{k: adc_cases[0][k] for k in keys + ("device_ms",)},
         "shape": adc_cases[0]["shape"],
         "other_shapes": adc_cases[1:]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:121",
         "launches": lm_launches,
         **{k: fa_cases[0][k] for k in keys + ("device_ms",)},
         "shape": fa_cases[0]["shape"],
         "other_shapes": fa_cases[1:]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
