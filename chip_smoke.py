#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`src/repro_torch`): XJoin end to end
on one CUDA card at the paper's data scale.

    python3 chip_smoke.py [--epochs 3] [--seed 0]

Phases, one JSON line each:
  0 device  — the card (`nvidia-smi` name and power limit), torch/CUDA
              versions, and the nvcc build of both kernels from `csrc/`.
  1 kernels — each hand-written kernel against its plain PyTorch version
              on the card at the main path's shapes (the range count also
              at the full 120 000 x 120 000 ground-truth sweep):
              CUDA-event medians, the bound (bytes over 3.35 TB/s vs fp32
              operations over 67 TFLOP/s, the larger), the plain
              version's time and, for the range count, cuBLAS `q @ r.T`
              as a partial yardstick.
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
Then the card's `nvidia-smi` line, the kernels summary line, and
{"ok": true, "device": {...}} as the last line. Every kernel counter is
zeroed just before phase 2 and read right after phase 3: the launches
reported are those of the main path only. Any failure raises and exits
non-zero; without a CUDA device it exits 2 before printing a result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32, outside the tensor cores


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase."""
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
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


def profile_serve(plan, batches, eps: float) -> dict:
    """One more pass of the same stream under torch.profiler: device busy
    share (kernel + copy time over wall time) and the largest kernels.
    Runs after the main path's counters are read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in plan.stream(batches, eps, depth=2):
            pass
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
                              for k, ms, n in rows[:8]]}


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
    from repro_torch.data import load_dataset
    from repro_torch.kernels import build, fused_mlp, range_count
    from repro_torch.kernels.ref import count_mismatches
    from repro_torch.utils import set_fp32_precision
    set_fp32_precision()
    kind = torch.cuda.get_device_name(0)

    # ---------------------------------------------------------- 0: device
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    built = build.build("range_count", "fused_mlp")
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
    emit("kernels", range_count=rc_cases, mlp_forward=mlp_cases)

    # ----------------------------------- 2: fit (main path starts here)
    range_count.KERNEL.launches = 0
    fused_mlp.KERNEL.launches = 0
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
