"""Drive the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold
each against its plain PyTorch version at the main path's shapes, load
TPC-H lineitem through `SnappySession.insert_arrays`, answer Q1 and Q6
through `SnappySession.sql` with both kernel lanes on, then again through
the compressed-domain entry points (`utils/tpch_code_domain`), run the
run-space RLE probe, then load orders and answer TPC-H Q3C (orders LEFT
JOIN lineitem) and a generic-key join through the device join engine,
then stream Q1 and Q6 through the tiled out-of-core lane, answer Q1 and
Q6 over exact DECIMAL(15,2) columns, run count(DISTINCT) and the matmul
reduction strategy, then TPC-H Q4, Q22 and Q18 (subqueries) and a GROUP
BY over scalar and string functions, then window functions over orders,
then UPDATE / DELETE / insert on lineitem under a pinned reader with Q1
and Q6 through both kernels, concurrent scans and ingest, and row tables
(TPC-H Q10 over nation, PUT INTO, get), then nested orders with ARRAY /
MAP / STRUCT columns, then a durable lineitem through the WAL, a
checkpoint, crash-shape recovery and the compactor.

    python3 chip_smoke.py [--sf 16] [--seed 7] [--reps 3] [--profile]
                          [--ptxas]

With --profile, each timed query also runs once under torch.profiler
(each session opens with spin kernels that are left out of its figures,
`profile_run`); every breakdown prints the device's kernel records
beside the host's CUDA runtime launch records, which are equal when the
trace kept every kernel (--trace-dir DIR keeps the traces that did not).

Phases, in order; any failure exits non-zero before the result lines:

1. the card's name and power limit (nvidia-smi);
2. build every kernel with nvcc for sm_90a, one process per source
   (with --ptxas, also print ptxas's registers, shared memory and spills
   of every kernel);
3. generate lineitem at scale factor --sf (6M rows per unit) and load it;
4. the main path: launch counters set to 0, Q1 and Q6 through
   `session.sql` with `pallas_group_reduce` and `pallas_reduce` on, the
   counters read back — each kernel must have launched; the inputs each
   kernel received are kept for phase 5;
5. each kernel against its plain version on those inputs (tolerance: the
   compensated sums within 1e-6 * sum(|v|), counts and min/max exact),
   timed beside its bound and one PyTorch library call; the grouped
   kernel's launch configuration (threads, blocks, resident blocks per
   SM, words per group and thread) and its op count before and after
   dedup.  The Kahan kernel also: two calls bit-identical, `ms` over
   back-to-back calls between two events (so host dispatch counts) and
   its launch configuration;
6. the answers: Q1 and Q6 against a float64 numpy oracle computed from the
   generated arrays, and against the same queries with the knobs off
   (counts exact, same-sign sums within rel 1e-6);
7. the compressed-domain path: launch counters set to 0, `code_domain_q6`
   and `code_domain_q1` over the loaded table, the counters read back —
   both code kernels must have launched; counts equal the session's own,
   sums within rel 5e-5 of the session's Q6 / Q1 and of the oracle;
8. each code kernel against its plain version on the inputs phase 7
   handed it (counts exact, sums within 1e-6 * sum(|v|)), timed beside its
   bound and one PyTorch library call, with the launch configuration and
   slot count before and after dedup as in phase 5;
9. the run-space RLE probe: a sorted DOUBLE column of 5 distinct values
   (min(max(rows, 65536), 4194304) rows) and `SELECT sum(r), count(r)
   ... WHERE r < 9.0` against numpy; `agg_rle_runs` must move and
   `compressed_fallback_not_ported` stay 0;
10. the join path: generate orders (--sf x 1.5M rows, seed + 1) and load
   it; with `join_expand_max_bytes` and `join_build_cache_bytes` at 8 GiB
   and `pallas_group_reduce` on, launch counters and join counters set to
   0, TPC-H Q3C through `session.sql` once and --reps times warm, the
   counters read back: no host fallback, at least one device join, ONE
   build sort over all runs, and the grouped kernel launched on the
   joined rows.  Q3C against a float64 numpy oracle (per-order priority
   and date lookup, then `np.bincount` over lineitem: counts exact,
   revenue within rel 5e-5); the grouped kernel against its plain
   version on the inputs Q3C handed it (phase 5's tolerance), timed
   beside its bound; the build sort timed alone; the peak device memory;
   then the generic-key join (`GROUP BY o_orderdate`, about 2,400 groups)
   against numpy with `host_fallbacks` unchanged;
11. the tiled lane: `scan_tile_bytes` at a tenth of Q1's decoded bind of
   lineitem (the reference bench keeps its budget under 10% of the
   table), the table's device cache dropped, launch and tile counters set
   to 0, Q1 and Q6 through `session.sql` once and --reps times warm, the
   counters read back: `scan_tiles` = tiles x runs, device merges moved
   and host merges did not, `grouped_reduce` launched once per Q1 tile and
   `masked_kahan_sum` once per Q6 tile, look-ahead windows warmed with no
   prefetch worker death and no host fallback.  The answers equal phase
   4's and the oracle (counts exact, sums rel 1e-6); the peak device
   memory above the resident set stays under (tier_prefetch_depth + 2) x
   scan_tile_bytes + 64 MiB; each kernel against its plain version on the
   last tile's inputs, and the Kahan kernel on the first (full) tile's
   too (phase 5's checks and timings); seconds, rows/s, bytes uploaded
   per pass and the pinned host-to-device rate;
12. exact decimals: lineitem_dec (the first quarter of the --sf x 6M
   generated rows, `DEC_DEPTH`, cut to leave phases 15 - 16 room, with
   l_quantity, l_extendedprice, l_discount and l_tax as DECIMAL(15,2))
   loaded, Q1 and Q6 through `session.sql`: the exact slots are
   `Decimal`s equal, digit for digit, to an int64-cents numpy oracle, the
   float slots within rel 1e-6, no host fallback; Q1 tiled at phase 11's
   budget once and --reps times warm, merged on the device only, with its
   exact slots equal to the untiled run's at the column scale (with
   --profile, one more tiled run traced); a 5-row DECIMAL(18,0) probe whose max|v| x count passes 2^62
   reroutes to the host path (counted) and answers exactly;
13. `count(DISTINCT l_suppkey)` per (returnflag, linestatus) over lineitem
   against `np.unique` of the (group, key) pairs, with no host fallback;
   the `matmul` and `scatter` strategies on one Q1 tile's float sums
   (integer-valued, so the answers must be identical), timed;
14. subqueries and functions, each query with the launch counters set to
   0 just before it and read just after, once and --reps times warm, with
   its peak device memory: TPC-H Q4 (EXISTS as a semi join against the
   late lineitems, a five-group count through the grouped kernel) and Q22
   (customer loaded at a tenth of orders' rows; the scalar avg through
   the Kahan kernel, NOT EXISTS as an anti join) over the --sf tables;
   `FUNCTIONS_QUERY` (year, substr and abs in a GROUP BY) over lineitem;
   Q18 on a session of its own at SF 1, cut because its IN subquery's
   result substitutes one literal per passing order (about 4.6M at SF
   16), with max_groups at 2^21 (the subquery groups every order), the
   list's length and the subquery's and the outer query's seconds apart.
   Each answer against numpy (counts exact, sums rel 1e-6), no host
   fallback, one device join a run (two for Q18); over the phase both
   kernels must have launched.  The grouped kernel against its plain
   version on the inputs a warm Q4 run handed it, and the Kahan kernel on
   those of a warm Q22 run (phase 5's checks and timings);
15. window functions: `WINDOW_QUERY` (row_number, rank, dense_rank,
   running sum / count / avg / min / max and lag / lead of o_totalprice
   over o_custkey partitions, ORDER BY o_orderdate and o_totalprice DESC)
   over the orders of two years (about 7.4M of --sf x 1.5M rows), once
   and --reps times warm: its columns against a numpy oracle built from
   `np.lexsort` over the generated arrays (ranks, counts and NULLs exact,
   running values rel 1e-6 of the float32-rounded prices), no host
   fallback; first and warm seconds, peak device memory;
16. mutations on lineitem at --sf: (a) a thread pins lineitem
   (`mvcc.pinned_scope`) and reads Q1 / Q6; (b) `MUTATION_UPDATE` (about
   12% of rows; moves Q6), (c) `MUTATION_DELETE` (about 4%), (d) one
   insert of 131,072 rows, with seconds and rows/s; (e) Q1 and Q6 once
   and --reps times warm, launch counters at 0: both kernels launch,
   `compressed_fallback_deltas` moves, no host fallback, answers equal a
   float64 numpy oracle over the mutated arrays (counts exact, sums rel
   1e-6), each kernel against its plain version on a warm run's inputs;
   (f) the pinned reader's Q1 / Q6 again equal phase 4's, peak memory
   with both versions bound; (g) HTAP: scans of count(*) and
   sum(l_extendedprice) while a second session inserts 8 batches of
   131,072 rows, every scan equal to one of the 9 prefix states, scan
   p50 / p99 concurrent and serialized, ingest rows/s; (h) nation and
   region as row tables (`NATION_DDL`, `REGION_DDL`), TPC-H Q10 over
   customer, orders, lineitem and nation against numpy with device joins
   and no host fallback, PUT INTO nation (one upsert, one insert) read
   back through `session.get`, and PUT INTO a keyed column table;
17. the Kahan kernel under torch.profiler on phase 5's and phase 11's
   inputs, in one child process of this script per shape
   (`--kahan-profile`) that loads them from a file, so that its profiler
   starts fresh, and with spin kernels at the session's start (the
   profiler drops the device records of a session's first millisecond,
   PERF.md §7): one profiler session per shape, in which every device
   kernel but the spins is the Kahan kernel, the device's kernel records
   and the host's CUDA runtime records each hold exactly one kernel
   launch per call, and there is no copy, memset or torch op but the
   output's allocation; its mean device time (`device_ms`);
18. nested orders: `gen_orders(1,500,000)` with `gen_lineitem(6,000,000,
   seed 7)` nested by l_orderkey (`tpch.gen_orders_nested`: an `info`
   STRUCT, `modes` ARRAY<STRING>, `prices` ARRAY<DOUBLE>, `qty_by_mode`
   MAP<STRING, DOUBLE>; SF 1, `reduced`: the cells are Python objects on
   the host), ingested through `insert_arrays`; `NESTED_N1` (GROUP BY
   the two BOOLEAN keys array_contains(modes, 'AIR') and size(modes) >=
   4: the reference has no device dictionary for a GROUP BY over a
   struct's STRING field) and `NESTED_N2` once and --reps times
   warm, launch counters at 0: no host fallback, the grouped kernel
   launched by N1 and the Kahan kernel by N2, each against its plain
   version on a warm run's inputs, answers against a numpy oracle
   (counts exact, sums rel 1e-6); ingest rows/s, first and warm seconds,
   the complex plates' bytes on the card;
19. a durable lineitem: the first 1 / DEC_DEPTH of the rows in a session
   with `data_dir` under a temporary directory (its filesystem's free
   bytes first, removed at the end): (a) CREATE and `insert_arrays` in
   1,048,576-row statements (rows/s, WAL bytes, fsyncs); (b)
   `checkpoint()` (seconds, bytes on disk, the codec used); (c) phase
   16's UPDATE, DELETE and 131,072-row insert, journaled; (d) 4 threads x
   500 single-row INSERT statements in `group` mode (acks/s, fsyncs,
   group commits); (e) a second session on the open directory (the crash
   shape; recovery seconds), Q1 and Q6 once and --reps times warm
   through both kernels against numpy over the mutated rows, with
   `compressed_fallback_deltas` moving; (f) `run_compaction_pass` on the
   recovered table, then Q1 / Q6 again with no delta fallback and the
   grouped kernel's slot count; (g) a third session on the directory
   answers the same;
20. the kernels' JSON line, then `{"ok": true, "device": ...}` last.  Each
   kernel's `launches` counts its main-path runs of phases 4, 11, 14, 16,
   18 and 19.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its float32 operations over
67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ROWS_PER_SF = 6_000_000
ORDERS_PER_SF = 1_500_000
KERNELS = ("kahan_reduce", "group_reduce", "code_filter_sum",
           "group_code_reduce")
RLE_PROBE_ROWS = (1 << 16, 1 << 22)
DEC_DEPTH = 4        # lineitem_dec holds 1 / DEC_DEPTH of lineitem's rows


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Recorder:
    """Wraps a kernel wrapper to keep the arguments of its first `keep`
    calls (all of them when `keep` is None), or with `ends` only of its
    first and its most recent call."""

    def __init__(self, fn, keep=None, ends=False):
        self.fn = fn
        self.keep = keep
        self.ends = ends
        self.calls = []

    def __call__(self, *args):
        if self.ends:
            self.calls = self.calls[:1] + [args]
        elif self.keep is None or len(self.calls) < self.keep:
            self.calls.append(args)
        return self.fn(*args)


def run_queries(session, tpch):
    """Q1 and Q6 through the user entry point; (rows, seconds) each."""
    import torch

    out = {}
    for name, q in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        t0 = time.perf_counter()
        rows = session.sql(q).rows()
        torch.cuda.synchronize()
        out[name] = (rows, time.perf_counter() - t0)
    return out


def oracle(li, tpch):
    """Q1 / Q6 in float64 numpy straight from the generated arrays."""
    import numpy as np

    flag = li["l_returnflag"]
    status = li["l_linestatus"]
    fcode = (flag == "N").astype(np.int64) + 2 * (flag == "R")
    scode = (status == "O").astype(np.int64)
    qty, price = li["l_quantity"], li["l_extendedprice"]
    disc, tax, ship = li["l_discount"], li["l_tax"], li["l_shipdate"]
    m = ship <= tpch._days("1998-12-01") - 90
    g = (fcode * 2 + scode)[m]

    def per(w):
        return np.bincount(g, weights=w[m], minlength=6)

    cnt = np.bincount(g, minlength=6)
    sums = [per(qty), per(price), per(price * (1 - disc)),
            per(price * (1 - disc) * (1 + tax))]
    avgs = [per(qty), per(price), per(disc)]
    q1 = []
    for code in range(6):
        if cnt[code] == 0:
            continue
        key = ("ANR"[code // 2], "FO"[code % 2])
        q1.append(key + tuple(s[code] for s in sums)
                  + tuple(a[code] / cnt[code] for a in avgs)
                  + (int(cnt[code]),))
    q1.sort(key=lambda r: r[:2])
    m6 = (ship >= tpch._days("1994-01-01")) \
        & (ship < tpch._days("1995-01-01")) \
        & (disc >= 0.05) & (disc <= 0.07) & (qty < 24)
    q6 = [(float((price[m6] * disc[m6]).sum()),)]
    return {"q1": q1, "q6": q6}


def check_rows(what, got, want, rel=1e-6):
    import math

    if len(got) != len(want):
        fail(f"{what}: {len(got)} rows, expected {len(want)}")
    for g, w in zip(got, want):
        if len(g) != len(w):
            fail(f"{what}: row width {len(g)}, expected {len(w)}")
        for a, b in zip(g, w):
            if isinstance(b, str) or isinstance(b, int):
                if a != b:
                    fail(f"{what}: {g} != {w}")
            elif not (math.isfinite(a) and abs(a - b) <= rel * abs(b)):
                fail(f"{what}: {a!r} vs {b!r} (rel {rel})")


def launch_records(prof):
    """(host CUDA runtime kernel-launch records, device kernel records)
    of a finished torch.profiler session: equal when the trace kept
    every kernel the calls launched."""
    import torch

    runtime = device = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.key.startswith(("Memcpy", "Memset")):
                device += e.count
        elif "LaunchKernel" in e.key or "LaunchCooperativeKernel" in e.key:
            runtime += e.count
    return runtime, device


TRACE_DIR = []   # set by --trace-dir
SPIN = "spin_kernel"   # torch.cuda._sleep's kernel


def spin_prelude(spin_s, pad_s):
    """Open a torch.profiler session with `spin_s` seconds of
    `torch.cuda._sleep` spin kernels, which take the profiler's loss of
    the kernel records of about the first millisecond after a session's
    first launch (PERF.md §7), then `pad_s` seconds of host sleep.
    Returns the number of spin kernels launched; the caller leaves them
    out of every figure."""
    import torch

    spins = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < spin_s:
        torch.cuda._sleep(20_000)
        spins += 1
    torch.cuda.synchronize()
    time.sleep(pad_s)
    return spins


def profile_run(fn, top=8, pad_s=1.0, spin_s=0.02):
    """One warm call of `fn` under torch.profiler: wall ms, the summed
    device time of its kernels, the device's idle share of the wall time,
    the kernels with the most device time, and the runtime launch and
    device kernel record counts of the call (`whole` when they agree).

    Each session opens with `spin_prelude(spin_s, pad_s)`, whose spin
    kernels are left out of every figure.  With
    --trace-dir, a trace whose call lost records is also written there as
    a Chrome trace (`trace` names the file)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spins = spin_prelude(spin_s, pad_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(pad_s)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and SPIN not in e.key]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    dev.sort(key=lambda e: -e.self_device_time_total)
    runtime, kept = launch_records(prof)
    runtime -= spins
    kept -= sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and SPIN in e.key)
    trace = None
    if TRACE_DIR and runtime != kept:
        os.makedirs(TRACE_DIR[0], exist_ok=True)
        trace = os.path.join(TRACE_DIR[0],
                             f"profile_{len(os.listdir(TRACE_DIR[0]))}.json")
        prof.export_chrome_trace(trace)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "trace": trace,
            "idle_share": 1 - dev_ms / wall_ms if dev_ms else None,
            "runtime_launches": runtime, "trace_kernels": kept,
            "whole": runtime == kept, "spins": spins,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in dev[:top]]}


def kahan_phase(calls, reps):
    """The Kahan kernel on the first recorded call's inputs: against its
    plain version (1e-6 * sum(|v|)), bit-identical over two calls, `ms`
    over back-to-back calls between two events (host dispatch counts),
    its launch configuration."""
    import torch

    from snappydata_tpu_torch.ops.kahan_reduce import (
        masked_kahan_sum, masked_kahan_sum_plain)

    if not calls:
        fail("masked_kahan_sum saw no call on the main path")
    v, w = calls[0]
    n = v.numel()
    got = masked_kahan_sum(v, w)
    again = masked_kahan_sum(v, w)
    plain = masked_kahan_sum_plain(v, w)
    torch.cuda.synchronize()
    err = abs(float(got) - float(plain))
    scale = float(torch.where(w, v.double().abs(), 0).sum())
    if not err <= 1e-6 * scale:
        fail(f"masked_kahan_sum: |kernel - plain| = {err} > 1e-6 * {scale}")
    if float(got) != float(again):
        fail(f"masked_kahan_sum: two calls differ ({float(got)!r}, "
             f"{float(again)!r})")
    b_ms, b_by = bound(n * 4 + n * 1 + 8, 4 * n)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: masked_kahan_sum(v, w), reps * 10),
        "plain_ms": cuda_ms(lambda: masked_kahan_sum_plain(v, w), reps),
        "library_ms": cuda_ms(
            lambda: torch.where(w, v, 0).double().sum(), reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n,
        "config": masked_kahan_sum.config}


def kahan_profile(v, w, reps):
    """The Kahan kernel's calls on (v, w) in one torch.profiler session,
    after one warm-up call.  The host's CUDA runtime records and the
    device's kernel records must each hold one kernel launch per call,
    every device kernel in the trace must be the Kahan kernel, there must
    be no copy or memset, the only torch op must be the output's
    allocation (`aten::empty`), and the wrapper's launch count must move
    by the calls.  Run in a fresh process, one for each shape
    (`kahan_profile_child`), and opened with `spin_prelude`, whose spin
    kernels are left out: the profiler drops the kernel records of about
    the first millisecond of a session (PERF.md §7), which here is the
    start of the calls themselves.  `device_ms` is the kernel records'
    mean device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from snappydata_tpu_torch.ops.kahan_reduce import masked_kahan_sum

    calls = reps * 10
    masked_kahan_sum(v, w)
    torch.cuda.synchronize()
    before = masked_kahan_sum.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spins = spin_prelude(0.02, 1.0)
        for _ in range(calls):
            masked_kahan_sum(v, w)
        torch.cuda.synchronize()
        time.sleep(1.0)
    launched = masked_kahan_sum.launches - before
    host, dev = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if SPIN not in e.key:
                dev[e.key] = (e.count,
                              e.self_device_time_total / e.count / 1e3)
        else:
            host[e.key] = e.count
    runtime_launches, _kept = launch_records(prof)
    runtime_launches -= spins
    copies = {k: c for k, c in host.items()
              if "Memcpy" in k or "Memset" in k}
    torch_ops = {k: c for k, c in host.items()
                 if k.startswith("aten::") and k != "aten::empty"}
    kahan = [(c, ms) for k, (c, ms) in dev.items()
             if "kahan_sum_kernel" in k]
    if launched != calls or runtime_launches != calls or copies \
            or torch_ops or len(dev) != 1 or not kahan \
            or kahan[0][0] != calls:
        fail(f"masked_kahan_sum: {launched} wrapper launches over {calls} "
             f"calls gave {runtime_launches} runtime kernel launches, "
             f"copies {copies}, torch ops {torch_ops}, device kernels "
             f"{dev}; expected one kernel per call and nothing else")
    return {"device_ms": kahan[0][1], "runtime_launches": runtime_launches,
            "trace_kernels": kahan[0][0], "calls": calls, "rows": v.numel()}


def kahan_profile_child(shapes, reps, root):
    """`kahan_profile` on each (label, (v, w)) of `shapes`, each in a
    child process of its own, which loads its inputs from a file under
    the gitignored build directory; returns (label, result) pairs and
    fails when a child does."""
    import torch

    path = os.path.join(root, "snappydata_tpu_torch", "build",
                        "kahan_profile_inputs.pt")
    results = []
    for label, (v, w) in shapes:
        torch.save([(label, v.cpu(), w.cpu())], path)
        try:
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--kahan-profile", path, "--reps", str(reps)],
                capture_output=True, text=True, timeout=600)
        finally:
            os.remove(path)
        if child.returncode != 0:
            fail(f"the Kahan profile child on the {label} exited "
                 f"{child.returncode}:\n"
                 f"{child.stdout[-4000:]}{child.stderr[-4000:]}")
        out = [json.loads(line) for line in child.stdout.splitlines()
               if line.startswith("{")]
        if [r["label"] for r in out] != [label]:
            fail(f"the Kahan profile child printed {child.stdout[-4000:]}")
        results.append((label, {k: x for k, x in out[0].items()
                                if k != "label"}))
    return results


def kahan_profile_main(path, reps):
    """The child's side of `kahan_profile_child`: one JSON line per
    shape."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    for label, v, w in torch.load(path):
        r = kahan_profile(v.cuda(), w.cuda(), reps)
        log(json.dumps({"label": label, **r}))
    return 0


def grouped_phase(calls, reps):
    import torch

    from snappydata_tpu_torch.ops.group_reduce import (
        grouped_reduce, grouped_reduce_plain)

    if not calls:
        fail("grouped_reduce saw no call on the main path")
    ops, gidx, G = calls[0]
    n = gidx.numel()
    got = grouped_reduce(ops, gidx, G)
    config = dict(grouped_reduce.config)
    plain = grouped_reduce_plain(ops, gidx, G)
    torch.cuda.synchronize()
    err = 0.0
    for (kind, v, w), k, p in zip(ops, got, plain):
        if kind in ("count", "min", "max"):
            same = (k == p) | (torch.isinf(k) & torch.isinf(p) & (k == p))
            if not bool(same.all()):
                fail(f"grouped_reduce {kind}: kernel {k.tolist()} != "
                     f"plain {p.tolist()}")
            continue
        diff = (k - p).abs()
        scale = torch.zeros(G, dtype=torch.float64, device=gidx.device)
        scale.index_add_(0, gidx.long(), torch.where(w, v.double().abs(), 0))
        if not bool((diff <= 1e-6 * scale + 1e-9).all()):
            fail(f"grouped_reduce sum: |kernel - plain| {diff.tolist()} "
                 f"beyond 1e-6 * sum(|v|) {scale.tolist()}")
        err = max(err, float(diff.max()))
    values = {id(v) for _k, v, _w in ops if v is not None}
    masks = {id(w) for _k, _v, w in ops}
    nbytes = n * 4 + 4 * n * len(values) + n * len(masks) + 8 * G * len(ops)
    nops = n * sum(4 if k == "sum" else 1 for k, _v, _w in ops)
    b_ms, b_by = bound(nbytes, nops)
    # the library yardstick: one index_add_ of the same sums and counts,
    # packed as [n, ops] float64 columns beforehand (packing not timed)
    idx = gidx.long()
    packed = torch.stack(
        [torch.where(w, v, 0).double() if v is not None else w.double()
         for _k, v, w in ops if _k in ("sum", "count")], dim=1)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: grouped_reduce(ops, gidx, G), reps * 10),
        "plain_ms": cuda_ms(lambda: grouped_reduce_plain(ops, gidx, G),
                            reps),
        "library_ms": cuda_ms(
            lambda: torch.zeros(G, packed.shape[1], dtype=torch.float64,
                                device=idx.device).index_add_(0, idx, packed),
            reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n, "ops": len(ops),
        "groups": G, "config": config}


def code_filter_phase(calls, reps):
    import torch

    from snappydata_tpu_torch.ops.kahan_reduce import (
        code_filter_mask, decode_rows, fused_code_filter_sum,
        fused_code_filter_sum_plain)

    if not calls:
        fail("fused_code_filter_sum saw no call on the compressed path")
    args = calls[0]
    q, d, ship, price, valid, dicts, qhi, dlo, dhi, slo, shi = args
    got_s, got_n = fused_code_filter_sum(*args)
    plain_s, plain_n = fused_code_filter_sum_plain(*args)
    torch.cuda.synchronize()
    if int(got_n) != int(plain_n):
        fail(f"fused_code_filter_sum count: kernel {int(got_n)} != plain "
             f"{int(plain_n)}")
    ok = code_filter_mask(q, d, ship, valid, qhi, dlo, dhi, slo, shi)
    prod = price.double() * decode_rows(d, dicts).double()
    scale = float(torch.where(ok, prod.abs(), 0).sum())
    err = abs(float(got_s) - float(plain_s))
    if not err <= 1e-6 * scale:
        fail(f"fused_code_filter_sum: |kernel - plain| = {err} > 1e-6 * "
             f"{scale}")
    n = price.numel()
    B = price.shape[0]
    nbytes = n * (q.element_size() + d.element_size() + 4 + 4 + 1) \
        + dicts.numel() * 4 + 3 * B * 4 + 16
    b_ms, b_by = bound(nbytes, 5 * n)   # a product and four Kahan adds

    def library():
        keep = (valid & (q.int() < qhi[:, None]) & (d.int() >= dlo[:, None])
                & (d.int() <= dhi[:, None]) & (ship >= slo) & (ship < shi))
        dv = torch.gather(dicts, 1, d.long())
        return torch.where(keep, price * dv, 0).double().sum(), keep.sum()

    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: fused_code_filter_sum(*args), reps * 10),
        "plain_ms": cuda_ms(lambda: fused_code_filter_sum_plain(*args),
                            reps),
        "library_ms": cuda_ms(library, reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n, "batches": B,
        "count": int(got_n)}


def code_grouped_phase(calls, reps):
    import torch

    from snappydata_tpu_torch.ops.group_reduce import (
        grouped_code_reduce, grouped_code_reduce_plain, slot_values)

    if not calls:
        fail("grouped_code_reduce saw no call on the compressed path")
    gidx, mask, slots, G = calls[0]
    got = grouped_code_reduce(gidx, mask, slots, G)
    config = dict(grouped_code_reduce.config)
    plain = grouped_code_reduce_plain(gidx, mask, slots, G)
    torch.cuda.synchronize()
    idx = gidx.reshape(-1).long()
    m = mask.reshape(-1)
    err = 0.0
    values = []
    for slot, k, p in zip(slots, got, plain):
        if slot[0] == "count":
            if not bool((k == p).all()):
                fail(f"grouped_code_reduce count: kernel {k.tolist()} != "
                     f"plain {p.tolist()}")
            values.append(m.double())
            continue
        v = slot_values(slot, gidx.shape, gidx.device).reshape(-1)
        values.append(torch.where(m, v, 0).double())
        scale = torch.zeros(G, dtype=torch.float64, device=gidx.device)
        scale.index_add_(0, idx, values[-1].abs())
        diff = (k - p).abs()
        if not bool((diff <= 1e-6 * scale + 1e-9).all()):
            fail(f"grouped_code_reduce sum: |kernel - plain| "
                 f"{diff.tolist()} beyond 1e-6 * sum(|v|) {scale.tolist()}")
        err = max(err, float(diff.max()))
    n = gidx.numel()
    plains = {id(s[1]): s[1] for s in slots if s[0] == "sum"
              and s[1] is not None}
    codes = {id(c): c for s in slots if s[0] == "sum" for c, _ in s[2]}
    dicts = {id(dc): dc for s in slots if s[0] == "sum" for _, dc in s[2]}
    nbytes = n * (4 + 1 + 4 * len(plains)
                  + sum(c.element_size() for c in codes.values())) \
        + sum(dc.numel() * 4 for dc in dicts.values()) + 8 * G * len(slots)
    nops = n * sum(1 if s[0] == "count" else 4 + len(s[2])
                   + (s[1] is not None) for s in slots)
    b_ms, b_by = bound(nbytes, nops)
    # the library yardstick: one index_add_ of the slots' decoded products
    # and the count, packed as [n, slots] float64 beforehand (not timed)
    packed = torch.stack(values, dim=1)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: grouped_code_reduce(gidx, mask, slots, G),
                      reps * 10),
        "plain_ms": cuda_ms(
            lambda: grouped_code_reduce_plain(gidx, mask, slots, G), reps),
        "library_ms": cuda_ms(
            lambda: torch.zeros(G, packed.shape[1], dtype=torch.float64,
                                device=idx.device).index_add_(0, idx, packed),
            reps * 10),
        "bound_ms": b_ms, "bound_by": b_by, "rows": n, "slots": len(slots),
        "groups": G, "config": config}


def code_domain_checks(session, tpch, first, want, q6_out, q1_out):
    """Phase 7's answers against the session's own and the oracle."""
    rel = 5e-5
    exp_cnt = session.sql(
        "SELECT count(*) FROM lineitem "
        "WHERE l_shipdate >= DATE '1994-01-01' "
        "AND l_shipdate < DATE '1995-01-01' "
        "AND l_discount BETWEEN 0.05 AND 0.07 "
        "AND l_quantity < 24").rows()[0][0]
    revenue, count = q6_out
    if count != exp_cnt:
        fail(f"code_domain_q6 count {count} != session {exp_cnt}")
    check_rows("code_domain_q6 vs session", [(revenue,)], first["q6"][0],
               rel)
    check_rows("code_domain_q6 vs numpy oracle", [(revenue,)], want["q6"],
               rel)
    live = [r for r in q1_out if r[2] > 0]
    for what, rows in (("session", first["q1"][0]),
                       ("numpy oracle", want["q1"])):
        check_rows(f"code_domain_q1 vs {what}",
                   [r[:2] + r[3:] + (r[2],) for r in live],
                   [r[:6] + (r[9],) for r in rows], rel)


def rle_probe(session, n_rows, reps):
    """Phase 9: the reference bench's run-space probe through
    `session.sql`; (rows, seconds of the first and the best warm run)."""
    import numpy as np

    from snappydata_tpu_torch.observability.metrics import global_registry

    n = int(min(max(n_rows, RLE_PROBE_ROWS[0]), RLE_PROBE_ROWS[1]))
    rng = np.random.default_rng(7)
    rvals = np.sort(rng.choice(np.array([1.0, 2.0, 5.0, 9.0, 12.0]), n))
    session.sql("CREATE TABLE code_agg_rle (r DOUBLE) USING column")
    session.insert_arrays("code_agg_rle", [rvals])
    session.catalog.describe("code_agg_rle").data.force_rollover()
    q = "SELECT sum(r), count(r) FROM code_agg_rle WHERE r < 9.0"
    reg = global_registry()
    before = reg.counter("agg_rle_runs")
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        rows = session.sql(q).rows()
        times.append(time.perf_counter() - t0)
    if reg.counter("agg_rle_runs") - before != 1 + reps:
        fail("the RLE probe did not take the run-space lane "
             f"(agg_rle_runs moved {reg.counter('agg_rle_runs') - before})")
    if reg.counter("compressed_fallback_not_ported"):
        fail("a column was rerouted as compressed_fallback_not_ported")
    keep = rvals < 9.0
    check_rows("rle probe vs numpy", rows,
               [(float(rvals[keep].sum()), int(keep.sum()))], 1e-12)
    return n, rows, times[0], min(times[1:])


GENERIC_JOIN_QUERY = (
    "SELECT o_orderdate, count(*), sum(l_extendedprice) FROM orders "
    "JOIN lineitem ON o_orderkey = l_orderkey GROUP BY o_orderdate "
    "ORDER BY o_orderdate")
JOIN_COUNTERS = ("join_host_fallbacks", "host_fallbacks",
                 "join_device_joins", "join_build_sorts",
                 "join_build_cache_hits", "join_expand_out_rows",
                 "join_expand_probe_rows")


def join_oracle(li, orders, tpch):
    """Q3C and the generic-key join in float64 numpy: every l_orderkey is
    an orders row (keys 1..n consecutive), so a per-order lookup of
    priority, date and date filter, then `np.bincount` over lineitem."""
    import numpy as np

    names = sorted(set(orders["o_orderpriority"][:1000].tolist()))
    code = np.zeros(len(orders["o_orderkey"]), dtype=np.int64)
    for i, name in enumerate(names):
        code[orders["o_orderpriority"] == name] = i
    if int(np.bincount(code, minlength=len(names)).sum()) != len(code):
        fail("join oracle: an order priority outside the first 1000 rows")
    date = orders["o_orderdate"].astype(np.int64)
    passes = date < tpch._days("1995-03-15")
    row = li["l_orderkey"] - 1
    m = passes[row]
    g = code[row][m]
    rev = (li["l_extendedprice"] * (1 - li["l_discount"]))[m]
    cnt = np.bincount(g, minlength=len(names))
    q3c = [(names[i], int(cnt[i]),
            float(np.bincount(g, weights=rev, minlength=len(names))[i]))
           for i in range(len(names))
           if passes[code == i].any()]
    d = date[row]
    lo = int(d.min())
    dc = np.bincount(d - lo)
    ds = np.bincount(d - lo, weights=li["l_extendedprice"])
    generic = [(lo + int(i), int(dc[i]), float(ds[i]))
               for i in np.flatnonzero(dc)]
    return q3c, generic


def join_path(session, tpch, reps, profile):
    """Phase 10's runs: Q3C through `session.sql` with the counters at 0;
    (rows, first seconds, warm seconds, counter deltas, launches, peak
    device bytes, resident bytes before, profile or None)."""
    import torch

    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr

    reg = global_registry()
    before = {k: reg.counter(k) for k in JOIN_COUNTERS}
    rec = Recorder(executor.grouped_reduce, keep=1)
    executor.grouped_reduce = rec
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gr.grouped_reduce.launches = 0
    times = []
    try:
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            rows = session.sql(tpch.Q3C).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        executor.grouped_reduce = rec.fn
    launches = gr.grouped_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    moved = {k: reg.counter(k) - before[k] for k in JOIN_COUNTERS}
    prof = profile_run(lambda: session.sql(tpch.Q3C).rows()) \
        if profile else None
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    return (rows, times[0], warm, moved, launches, rec.calls, peak,
            resident, prof)


def build_sort_ms(session, reps):
    """The build side's sort alone: lineitem's l_orderkey plate encoded
    as the join encodes it, sorted stably, CUDA-event mean."""
    import torch

    from snappydata_tpu_torch.ops import join as dj
    from snappydata_tpu_torch.storage.device import build_device_table

    data = session.catalog.lookup_table("lineitem").data
    dt = build_device_table(data, [0], session.device, code_ok=False)
    keys = dj.encode_build_keys([(dt.columns[0].reshape(-1), None)],
                                dt.valid.reshape(-1), None)
    return cuda_ms(lambda: torch.sort(keys, stable=True), reps), \
        int(keys.numel())


Q1_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate")
Q6_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")
DEC_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
MIB = 1 << 20
DISTINCT_QUERY = (
    "SELECT l_returnflag, l_linestatus, count(DISTINCT l_suppkey) "
    "FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2")


def tile_plan(session, table, cols, budget):
    """(units, bytes per unit, units per tile, tiles) of `table`'s scan
    over `cols` under `budget`, by the session's own unit math."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.storage.device import scan_unit_count

    info = session.catalog.describe(table)
    with config.device_scope(session.device):
        per = 1 + sum(session._decoded_col_width(info.schema.field(c))
                      for c in cols)
    units = scan_unit_count(info.data)
    unit_bytes = info.data.capacity * per
    tile_units = max(1, budget // unit_bytes)
    if tile_units > 1:
        tile_units = 1 << (tile_units.bit_length() - 1)
    return units, unit_bytes, tile_units, -(-units // tile_units)


def pinned_h2d_gb_per_s(nbytes, reps):
    """Host-to-device copy rate from pinned memory, CUDA-event timed."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), reps)
    return nbytes / ms / 1e6


def tiled_path(session, tpch, reps, budget, profile):
    """Phase 11's runs: both kernel lanes on, lineitem's device cache
    dropped, the counters at 0, Q1 and Q6 through the tiled lane once and
    `reps` times warm.  The
    last run keeps the kernel inputs of its first and last tiles, so the
    peak device memory is read before it."""
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import (TILE_COUNTERS,
                                                            global_registry)
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    props = config.global_properties()
    data = session.catalog.lookup_table("lineitem").data
    reg = global_registry()
    names = TILE_COUNTERS + ("host_fallbacks",)
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    props.scan_tile_bytes = budget
    data._device_cache.clear()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = reg.counters(names)
    kr.masked_kahan_sum.launches = 0
    gr.grouped_reduce.launches = 0
    rec_k = Recorder(executor.masked_kahan_sum, ends=True)
    rec_g = Recorder(executor.grouped_reduce, ends=True)
    times = {"q1": [], "q6": []}
    uploads = {"q1": [], "q6": []}
    rows = {}
    peak = None
    try:
        for run in range(1 + reps):
            if run == reps and reps:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - resident
                executor.masked_kahan_sum = rec_k
                executor.grouped_reduce = rec_g
            for q, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
                u0 = reg.counter("device_upload_bytes")
                t0 = time.perf_counter()
                rows[q] = session.sql(sql).rows()
                torch.cuda.synchronize()
                times[q].append(time.perf_counter() - t0)
                uploads[q].append(reg.counter("device_upload_bytes") - u0)
    finally:
        executor.masked_kahan_sum = rec_k.fn
        executor.grouped_reduce = rec_g.fn
    if peak is None:
        peak = torch.cuda.max_memory_allocated() - resident
    launches = {"masked_kahan_sum": kr.masked_kahan_sum.launches,
                "grouped_reduce": gr.grouped_reduce.launches}
    after = reg.counters(names)
    moved = {k: after[k] - before[k] for k in names}
    prof = profile_run(lambda: session.sql(tpch.Q1).rows()) \
        if profile else None
    props.scan_tile_bytes = 0
    return (rows, times, uploads, moved, launches, peak, resident,
            rec_k.calls, rec_g.calls, prof)


def dec_oracle(li, tpch):
    """Q1's exact slots over DECIMAL(15,2) columns from int64 cents: per
    (returnflag, linestatus) the cent sums of l_quantity and
    l_extendedprice, with the counts."""
    from decimal import Decimal

    import numpy as np

    flag, status = li["l_returnflag"], li["l_linestatus"]
    code = (flag == "N").astype(np.int64) + 2 * (flag == "R")
    code = code * 2 + (status == "O")
    m = li["l_shipdate"] <= tpch._days("1998-12-01") - 90
    qty = np.round(li["l_quantity"] * 100).astype(np.int64)
    price = np.round(li["l_extendedprice"] * 100).astype(np.int64)
    out = []
    for c in range(6):
        sel = m & (code == c)
        n = int(sel.sum())
        if n:
            out.append(("ANR"[c // 2], "FO"[c % 2],
                        Decimal(int(qty[sel].sum())).scaleb(-2),
                        Decimal(int(price[sel].sum())).scaleb(-2), n))
    return out


def check_dec_q1(what, got, exact, floats):
    """Exact slots digit for digit, float slots within rel 1e-6."""
    from decimal import Decimal

    if len(got) != len(exact):
        fail(f"{what}: {len(got)} rows, expected {len(exact)}")
    for g, e, f in zip(got, exact, floats):
        if g[:2] != e[:2] or g[9] != e[4]:
            fail(f"{what}: keys/count {g[:2] + (g[9],)} != "
                 f"{e[:2] + (e[4],)}")
        for i, want in ((2, e[2]), (3, e[3])):
            if not isinstance(g[i], Decimal) or str(g[i]) != str(want):
                fail(f"{what}: exact slot {i} {g[i]!r} != {want!r}")
        check_rows(f"{what} float slots", [g[4:9]], [f[4:9]])


def decimal_path(session, tpch, li, reps, budget, profile):
    """Phase 12: lineitem_dec loaded from the generated rows; Q1 / Q6
    untiled, Q1 tiled at `budget` once and `reps` times warm, the
    overflow probe."""
    from decimal import Decimal

    import numpy as np
    import torch

    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import (TILE_COUNTERS,
                                                            global_registry)

    props = config.global_properties()
    reg = global_registry()
    ddl = tpch.LINEITEM_DDL.replace("TABLE lineitem", "TABLE lineitem_dec")
    for c in DEC_COLS:
        ddl = ddl.replace(f"{c} DOUBLE", f"{c} DECIMAL(15,2)")
    session.sql(ddl)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem_dec", list(li.values()))
    load_s = time.perf_counter() - t0
    q1 = tpch.Q1.replace("FROM lineitem", "FROM lineitem_dec")
    q6 = tpch.Q6.replace("FROM lineitem", "FROM lineitem_dec")
    fb = reg.counter("host_fallbacks")
    out = {"load_s": load_s}
    for name, q in (("q1", q1), ("q6", q6)):
        times = []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            rows = session.sql(q).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = rows
        out[name + "_first_s"] = times[0]
        out[name + "_warm_s"] = sorted(times[1:])[len(times[1:]) // 2] \
            if reps else times[0]
    if reg.counter("host_fallbacks") != fb:
        fail("decimal Q1/Q6 left the device")
    want = oracle(li, tpch)
    check_dec_q1("decimal Q1", out["q1"], dec_oracle(li, tpch),
                 want["q1"])
    check_rows("decimal Q6 vs numpy oracle", [(float(out["q6"][0][0]),)],
               want["q6"])
    # Q1 tiled at phase 11's budget: the per-tile int64 partials merge on
    # the device; the merge hands them back through float64 partial
    # columns, so the exact slots compare at the column scale
    props.scan_tile_bytes = budget
    before = reg.counters(TILE_COUNTERS)
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        tiled = session.sql(q1).rows()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    after = reg.counters(TILE_COUNTERS)
    out["q1_tiled_counters"] = {k: after[k] - before[k]
                                for k in TILE_COUNTERS}
    out["q1_tiled_prof"] = profile_run(lambda: session.sql(q1).rows()) \
        if profile else None
    props.scan_tile_bytes = 0
    out["q1_tiled_first_s"] = times[0]
    out["q1_tiled_warm_s"] = sorted(times[1:])[len(times[1:]) // 2] \
        if reps else times[0]
    out["q1_tiles"] = out["q1_tiled_counters"]["scan_tiles"] // len(times)
    if out["q1_tiles"] < 2 \
            or not out["q1_tiled_counters"]["scan_tile_device_merges"] \
            or out["q1_tiled_counters"]["scan_tile_host_merges"]:
        fail(f"decimal Q1 did not run the tiled device merge "
             f"({out['q1_tiled_counters']})")
    if reg.counter("host_fallbacks") != fb:
        fail("tiled decimal Q1 left the device")
    cents = Decimal("0.01")
    for t, u in zip(tiled, out["q1"]):
        for i in (2, 3):
            if Decimal(repr(t[i])).quantize(cents) != u[i]:
                fail(f"tiled decimal Q1 slot {i}: {t[i]!r} != untiled "
                     f"{u[i]!r}")
        if (t[:2], t[9]) != (u[:2], u[9]):
            fail(f"tiled decimal Q1 keys/count {t} != {u}")
    # the overflow probe: 5 x 9.9e17 at scale 0, max|v| * count = 4.95e18
    # >= 2^62, so the int64 guard must reroute to the host path
    session.sql("CREATE TABLE dec_probe (v DECIMAL(18,0)) USING column")
    session.insert_arrays("dec_probe", [np.full(5, 9.9e17)])
    fb = reg.counter("host_fallbacks")
    got = session.sql("SELECT sum(v) FROM dec_probe").rows()[0][0]
    if reg.counter("host_fallbacks") != fb + 1:
        fail("the decimal overflow probe did not reroute to the host path")
    if got != Decimal(495) * Decimal(10) ** 16:
        fail(f"the decimal overflow probe answered {got!r}")
    out["probe"] = str(got)
    return out


def distinct_path(session, li, reps):
    """Phase 13's count(DISTINCT) over lineitem against np.unique."""
    import numpy as np
    import torch

    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    fb = reg.counter("host_fallbacks")
    times = []
    for _ in range(1 + reps):
        t0 = time.perf_counter()
        rows = session.sql(DISTINCT_QUERY).rows()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if reg.counter("host_fallbacks") != fb:
        fail("count(DISTINCT) left the device")
    flag, status = li["l_returnflag"], li["l_linestatus"]
    code = ((flag == "N").astype(np.int64) + 2 * (flag == "R")) * 2 \
        + (status == "O")
    pairs = np.unique(code * (1 << 32) + li["l_suppkey"])
    per = np.bincount(pairs >> 32, minlength=6)
    want = [("ANR"[c // 2], "FO"[c % 2], int(per[c]))
            for c in range(6) if per[c]]
    if rows != want:
        fail(f"count(DISTINCT) {rows} != numpy {want}")
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    return rows, times[0], warm


def strategy_timing(calls, reps):
    """Phase 13's matmul against scatter on one Q1 tile's float sums: the
    grouped kernel's inputs of the first (full) tile, rounded to integers
    so that both strategies must agree bit for bit."""
    import torch

    from snappydata_tpu_torch.ops import reduction

    if not calls:
        fail("no Q1 tile inputs for the strategy timing")
    ops, gidx, nseg = calls[0]
    G = nseg - 1
    cols = [torch.where(w, v, 0).double().round() for k, v, w in ops
            if k == "sum"] + [w.double() for k, _v, w in ops
                              if k == "count"]
    n = gidx.numel()
    onehot = reduction.onehot_bytes(n, G, torch.float64)
    if onehot > reduction.MATMUL_ONEHOT_MAX_BYTES:
        fail(f"one Q1 tile's one-hot ({onehot} B) passes the matmul bound")
    mm = reduction.packed_sum(cols, gidx, G, "matmul")
    sc = reduction.packed_sum(cols, gidx, G, "scatter")
    torch.cuda.synchronize()
    if not torch.equal(mm, sc):
        fail(f"matmul {mm.tolist()} != scatter {sc.tolist()}")
    return {"rows": n, "groups": G, "columns": len(cols),
            "onehot_bytes": onehot,
            "auto": reduction.resolve_strategy("auto", "cuda", G, n, "fsum",
                                               torch.float64),
            "matmul_ms": cuda_ms(
                lambda: reduction.packed_sum(cols, gidx, G, "matmul"),
                reps * 3),
            "scatter_ms": cuda_ms(
                lambda: reduction.packed_sum(cols, gidx, G, "scatter"),
                reps * 3)}


SUBQUERY_COUNTERS = ("host_fallbacks", "join_host_fallbacks",
                     "join_device_joins", "join_build_sorts",
                     "join_build_cache_hits")
# GROUP BY a date part and a string prefix.  The prefix is two characters:
# substr(l_shipmode, 1, 1) folds 'RAIL' and 'REG AIR' into one value, and
# a derived group key whose values repeat takes the host path in both
# packages (grouping runs on dictionary codes)
FUNCTIONS_QUERY = (
    "SELECT year(l_shipdate), substr(l_shipmode, 1, 2), "
    "sum(abs(l_quantity - 25)), count(*) FROM lineitem GROUP BY 1, 2")


def timed_query(session, sql, reps):
    """`sql` through `session.sql` once and `reps` times warm, with the
    two kernels' launch counters set to 0 just before and read just
    after; (rows, first s, warm s, counter deltas, launches, the inputs of
    each kernel's last call, peak device bytes, resident bytes before)."""
    import torch

    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    reg = global_registry()
    before = {k: reg.counter(k) for k in SUBQUERY_COUNTERS}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = {"grouped_reduce": Recorder(executor.grouped_reduce, ends=True),
           "masked_kahan_sum": Recorder(executor.masked_kahan_sum,
                                        ends=True)}
    executor.grouped_reduce = rec["grouped_reduce"]
    executor.masked_kahan_sum = rec["masked_kahan_sum"]
    gr.grouped_reduce.launches = 0
    kr.masked_kahan_sum.launches = 0
    times = []
    try:
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            rows = session.sql(sql).rows()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        executor.grouped_reduce = rec["grouped_reduce"].fn
        executor.masked_kahan_sum = rec["masked_kahan_sum"].fn
    launches = {"grouped_reduce": gr.grouped_reduce.launches,
                "masked_kahan_sum": kr.masked_kahan_sum.launches}
    calls = {k: r.calls[-1:] for k, r in rec.items()}
    peak = torch.cuda.max_memory_allocated()
    moved = {k: reg.counter(k) - before[k] for k in SUBQUERY_COUNTERS}
    warm = sorted(times[1:])[len(times[1:]) // 2] if reps else times[0]
    return rows, times[0], warm, moved, launches, calls, peak, resident


def value_codes(arr, sample=1000):
    """(sorted distinct values, int64 code per row) of an object array
    whose distinct values all occur in its first `sample` rows."""
    import numpy as np

    names = sorted(set(arr[:sample].tolist()))
    code = np.full(len(arr), -1, dtype=np.int64)
    for i, name in enumerate(names):
        code[arr == name] = i
    if (code < 0).any():
        fail("oracle: a value outside the first rows of its column")
    return names, code


def q4_oracle(li, orders, tpch):
    import numpy as np

    late = li["l_commitdate"] < li["l_receiptdate"]
    has = np.zeros(len(orders["o_orderkey"]) + 1, dtype=np.bool_)
    has[li["l_orderkey"][late]] = True
    od = orders["o_orderdate"]
    m = (od >= tpch._days("1993-07-01")) & (od < tpch._days("1993-10-01")) \
        & has[orders["o_orderkey"]]
    names, code = value_codes(orders["o_orderpriority"])
    cnt = np.bincount(code[m], minlength=len(names))
    return [(names[i], int(cnt[i])) for i in range(len(names)) if cnt[i]]


def q22_oracle(cust, orders):
    import numpy as np

    nat, bal = cust["c_nationkey"], cust["c_acctbal"]
    sel = np.isin(nat, [1, 3, 5, 7])
    avg = bal[sel & (bal > 0.0)].mean()
    has = np.zeros(len(cust["c_custkey"]) + 1, dtype=np.bool_)
    has[orders["o_custkey"]] = True
    keep = sel & (bal > avg) & ~has[cust["c_custkey"]]
    cnt = np.bincount(nat[keep], minlength=25)
    tot = np.bincount(nat[keep], weights=bal[keep], minlength=25)
    return [(k, int(cnt[k]), float(tot[k])) for k in range(25) if cnt[k]]


def q18_oracle(li, orders, cust):
    """(the IN subquery's length, the top 100 rows, the 100th price)."""
    import numpy as np

    per = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                      minlength=len(orders["o_orderkey"]) + 1)
    big = np.flatnonzero(per > 150)
    row = big - 1
    ck = orders["o_custkey"][row]
    price = orders["o_totalprice"][row]
    order = np.lexsort((orders["o_orderdate"][row], -price))[:100]
    rows = {int(big[i]): (str(cust["c_name"][ck[i] - 1]), int(ck[i]),
                          int(big[i]), int(orders["o_orderdate"][row[i]]),
                          float(price[i]), float(per[big[i]]))
            for i in order}
    return len(big), rows, float(price[order[-1]])


def functions_oracle(li):
    import numpy as np
    import pandas as pd

    year = li["l_shipdate"].astype("datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970
    codes, uniq = pd.factorize(li["l_shipmode"])
    prefix = sorted({str(u)[:2] for u in uniq})
    pcode = np.array([prefix.index(str(u)[:2]) for u in uniq])[codes]
    lo = int(year.min())
    key = (year - lo) * len(prefix) + pcode
    cnt = np.bincount(key)
    tot = np.bincount(key, weights=np.abs(li["l_quantity"] - 25))
    return [(lo + int(k) // len(prefix), prefix[int(k) % len(prefix)],
             float(tot[k]), int(cnt[k])) for k in np.flatnonzero(cnt)]


def subquery_path(session, tpch, li, orders, args):
    """Phase 14: Q4, Q22 and the functions query at --sf, Q18 at SF 1 on
    its own session; returns the two kernels' launches over the phase."""
    import torch

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    total = {"grouped_reduce": 0, "masked_kahan_sum": 0}

    def run(name, s, sql, reps, expect):
        rows, first, warm, moved, launches, calls, peak, resident = \
            timed_query(s, sql, reps)
        log(f"{name}_counters {json.dumps(moved)} launches "
            f"{json.dumps(launches)}")
        log(f"{name} first_s {first:.4f} warm_s {warm:.4f} "
            f"peak_device_bytes {peak} resident_before_bytes {resident}")
        if moved["host_fallbacks"] or moved["join_host_fallbacks"]:
            fail(f"{name} left the device: {moved}")
        runs = 1 + reps
        if moved["join_device_joins"] != expect["joins"] * runs:
            fail(f"{name} ran {moved['join_device_joins']} device joins "
                 f"over {runs} runs, expected {expect['joins']} a run")
        for k in ("grouped_reduce", "masked_kahan_sum"):
            if expect.get(k) and launches[k] < runs:
                fail(f"{k} launched {launches[k]} times over {name}'s "
                     f"{runs} runs")
            total[k] += launches[k]
        # each kernel the query must launch, against its plain version on
        # the inputs of its last (warm) call; these launches come after
        # the counters were read
        if expect.get("grouped_reduce"):
            log(f"kernel grouped_reduce on {name} " + json.dumps(
                grouped_phase(calls["grouped_reduce"], args.reps)))
        if expect.get("masked_kahan_sum"):
            log(f"kernel masked_kahan_sum on {name} " + json.dumps(
                kahan_phase(calls["masked_kahan_sum"], args.reps)))
        del calls
        if args.profile:
            log(f"profile {name} " + json.dumps(profile_run(
                lambda: s.sql(sql).rows())))
        return rows

    # Q4: EXISTS -> a semi join of orders against late lineitems, then a
    # five-group count through the grouped kernel
    rows = run("q4", session, tpch.Q4, args.reps,
               {"joins": 1, "grouped_reduce": True})
    want = q4_oracle(li, orders, tpch)
    if rows != want:
        fail(f"Q4 {rows} != numpy {want}")
    log(f"q4 {json.dumps(rows)}")

    # Q22: customer at a tenth of orders' rows, as gen_orders draws its
    # customer keys; the scalar avg is a global f32 sum (Kahan kernel),
    # NOT EXISTS an anti join against orders
    n_cust = len(orders["o_orderkey"]) // 10
    t0 = time.perf_counter()
    cust = tpch.gen_customer(n_cust, args.seed + 2)
    session.sql(tpch.CUSTOMER_DDL)
    session.insert_arrays("customer", list(cust.values()))
    log(f"customer_load_s {time.perf_counter() - t0:.3f} rows {n_cust}")
    rows = run("q22", session, tpch.Q22, args.reps,
               {"joins": 1, "masked_kahan_sum": True})
    check_rows("Q22 vs numpy", rows, q22_oracle(cust, orders), 1e-6)
    log(f"q22 {json.dumps(rows)}")
    del cust

    # scalar and string functions in a GROUP BY, over lineitem
    rows = run("functions", session, FUNCTIONS_QUERY, args.reps,
               {"joins": 0})
    check_rows("functions query vs numpy", sorted(rows, key=lambda r: r[:2]),
               functions_oracle(li), 1e-6)
    log(f"functions {json.dumps(sorted(rows, key=lambda r: r[:2]))}")

    # Q18 on its own session at SF 1: its IN subquery's result substitutes
    # a literal list (about 19% of orders: 4.6M literals at SF 16)
    n_l, n_o = ROWS_PER_SF, ORDERS_PER_SF
    li18 = tpch.gen_lineitem(n_l, args.seed)
    o18 = tpch.gen_orders(n_o, n_o // 10, args.seed + 1)
    c18 = tpch.gen_customer(n_o // 10, args.seed + 2)
    s18 = SnappySession(catalog=Catalog())
    for ddl, name, cols in ((tpch.LINEITEM_DDL, "lineitem", li18),
                            (tpch.ORDERS_DDL, "orders", o18),
                            (tpch.CUSTOMER_DDL, "customer", c18)):
        s18.sql(ddl)
        s18.insert_arrays(name, list(cols.values()))
    sub = []
    run_sub = s18._run_subquery

    def timed_subquery(plan, params):
        t0 = time.perf_counter()
        res = run_sub(plan, params)
        torch.cuda.synchronize()
        sub.append((time.perf_counter() - t0, res.num_rows))
        return res

    s18._run_subquery = timed_subquery
    q18_reps = min(args.reps, 1)
    # the subquery groups every order (1.5M groups) and the outer query
    # every passing one: past the default max_groups (65,536) the generic
    # group-key lane reroutes to the host in both packages
    saved_groups = props.max_groups
    props.max_groups = 1 << 21
    try:
        t0 = time.perf_counter()
        rows = run("q18", s18, tpch.Q18, q18_reps, {"joins": 2})
        total_s = time.perf_counter() - t0
    finally:
        props.max_groups = saved_groups
    n_in, want, cut = q18_oracle(li18, o18, c18)
    sub_s = sum(t for t, _ in sub)
    log(f"q18 sf 1 reduced (the IN subquery's result substitutes one "
        f"literal per passing order: about 4.6M at SF 16) in_list_len "
        f"{sub[0][1]} subquery_s {json.dumps([round(t, 4) for t, _ in sub])}"
        f" outer_s {(total_s - sub_s) / (1 + q18_reps):.4f} per run")
    if sub[0][1] != n_in or len(rows) != 100:
        fail(f"Q18: IN list {sub[0][1]} (numpy {n_in}), {len(rows)} rows")
    prices = [r[4] for r in rows]
    if any(a < b for a, b in zip(prices, prices[1:])) \
            or min(prices) < cut * (1 - 1e-6):
        fail("Q18 rows are not the 100 highest prices in order")
    for r in rows:
        w = want.get(r[2])
        if w is None:
            if r[4] > cut * (1 + 1e-6):
                fail(f"Q18 row {r} is not in numpy's top 100")
            continue
        check_rows("Q18 vs numpy", [r], [w], 1e-6)
    del s18, li18, o18, c18
    log(f"q18_first_rows {json.dumps(rows[:3])}")
    log("answers ok: Q4, Q22, the functions query and Q18 match numpy, "
        "on the device")
    return total


# --- phase 15: window functions over orders --------------------------------

WINDOW_DATES = ("1995-01-01", "1997-01-01")
WINDOW_QUERY = (
    "SELECT o_orderkey, "
    "row_number() OVER (PARTITION BY o_custkey ORDER BY o_orderdate, "
    "o_orderkey), "
    "rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "dense_rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC), "
    "sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "count(*) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "avg(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "min(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "max(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "lag(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate, "
    "o_orderkey), "
    "lead(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate, "
    "o_orderkey) "
    f"FROM orders WHERE o_orderdate >= DATE '{WINDOW_DATES[0]}' "
    f"AND o_orderdate < DATE '{WINDOW_DATES[1]}'")


def window_oracle(orders, tpch):
    """Phase 15's columns in numpy, one row per passing order in key
    order: a lexsort by (custkey, date, key), segment and tie bounds,
    prefix sums, and running min / max through per-segment offsets.
    Prices are the float32-rounded values the card's plates hold, so
    ranks over them are exact; NaN marks a NULL lag / lead."""
    import numpy as np

    od = orders["o_orderdate"].astype(np.int64)
    m = (od >= tpch._days(WINDOW_DATES[0])) \
        & (od < tpch._days(WINDOW_DATES[1]))
    key = orders["o_orderkey"][m]
    cust = orders["o_custkey"][m]
    date = od[m]
    price = orders["o_totalprice"][m].astype(np.float32).astype(np.float64)
    n = len(key)
    pos = np.arange(n)

    def segments(new):
        sid = np.cumsum(new) - 1
        starts = np.flatnonzero(new)
        return sid, starts[sid], np.r_[starts[1:], n][sid] - 1

    order = np.lexsort((key, date, cust))
    cs, ds, ps = cust[order], date[order], price[order]
    new_seg = np.r_[True, cs[1:] != cs[:-1]]
    sid, first, _last = segments(new_seg)
    tie_new = new_seg | np.r_[True, ds[1:] != ds[:-1]]
    _tid, tfirst, tlast = segments(tie_new)
    c = np.cumsum(ps)
    run_sum = (c - (c[first] - ps[first]))[tlast]
    run_cnt = (pos - first + 1)[tlast]
    off = sid.astype(np.float64) * float(1 << 20)   # > every price
    run_min = (np.minimum.accumulate(ps - off) + off)[tlast]
    run_max = (np.maximum.accumulate(ps + off) - off)[tlast]
    lag = np.where(new_seg, np.nan, np.r_[np.nan, ps[:-1]])
    lead = np.where(np.r_[new_seg[1:], True], np.nan, np.r_[ps[1:], np.nan])
    sorted_cols = [pos - first + 1, tfirst - first + 1, None, run_sum,
                   run_cnt, run_sum / run_cnt, run_min, run_max, lag, lead]
    o2 = np.lexsort((-price, cust))
    c2, p2 = cust[o2], price[o2]
    new2 = np.r_[True, c2[1:] != c2[:-1]]
    tid2 = np.cumsum(new2 | np.r_[True, p2[1:] != p2[:-1]]) - 1
    _s, first2, _l = segments(new2)
    dense = np.empty(n, dtype=np.int64)
    dense[o2] = tid2 - tid2[first2] + 1
    by_key = np.argsort(key)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = pos
    cols = [key[by_key]]
    for j, col in enumerate(sorted_cols):
        cols.append(dense[by_key] if j == 2 else col[inv][by_key])
    return cols


def check_window(res, want):
    """The session's window Result against the oracle columns: ranks and
    counts exact, running sums / averages / extremes and lag / lead
    within rel 1e-6, NULLs exactly where the oracle has NaN."""
    import numpy as np

    keys = np.asarray(res.columns[0]).astype(np.int64)
    if len(keys) != len(want[0]):
        fail(f"window query: {len(keys)} rows, numpy {len(want[0])}")
    by = np.argsort(keys)
    if not (keys[by] == want[0]).all():
        fail("window query: order keys differ from numpy's")
    exact = {1: "row_number", 2: "rank", 3: "dense_rank", 5: "count"}
    for j in range(1, 11):
        got = np.asarray(res.columns[j])[by]
        nl = res.nulls[j]
        nl = np.zeros(len(got), np.bool_) if nl is None \
            else np.asarray(nl)[by]
        w = np.asarray(want[j], dtype=np.float64)
        wn = np.isnan(w)
        if (nl != wn).any():
            fail(f"window column {j}: NULLs differ from numpy "
                 f"({int(nl.sum())} vs {int(wn.sum())})")
        g = got[~nl].astype(np.float64)
        w = w[~wn]
        if j in exact:
            if not (g == w).all():
                bad = int(np.flatnonzero(g != w)[0])
                fail(f"window {exact[j]}: {g[bad]} != numpy {w[bad]}")
        else:
            err = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
            if len(err) and err.max() > 1e-6:
                fail(f"window column {j}: max rel err {err.max():.3g}")


def window_path(session, tpch, orders, args):
    """Phase 15: WINDOW_QUERY once and --reps times warm with
    `host_fallbacks` read around the runs; its answer against numpy."""
    import torch

    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    fb = reg.counter("host_fallbacks")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(1 + args.reps):
        t0 = time.perf_counter()
        res = session.sql(WINDOW_QUERY)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if reg.counter("host_fallbacks") != fb:
        fail("the window query left the device")
    t0 = time.perf_counter()
    want = window_oracle(orders, tpch)
    oracle_s = time.perf_counter() - t0
    check_window(res, want)
    warm = sorted(times[1:])[len(times[1:]) // 2] if args.reps else times[0]
    log(f"window rows {res.num_rows} first_s {times[0]:.4f} warm_s "
        f"{warm:.4f} rows_per_s {res.num_rows / warm:.0f} "
        f"peak_device_bytes {peak} resident_before_bytes {resident} "
        f"oracle_s {oracle_s:.3f}")
    if args.profile:
        log("profile window " + json.dumps(profile_run(
            lambda: session.sql(WINDOW_QUERY))))
    log("answers ok: the window query matches numpy, on the device")


# --- phase 16: mutations, MVCC pins, HTAP, row tables ----------------------

MUTATION_UPDATE = ("UPDATE lineitem SET l_discount = l_discount + 0.01 "
                   "WHERE l_shipdate >= DATE '1998-01-01' "
                   "AND l_discount < 0.10")
MUTATION_DELETE = "DELETE FROM lineitem WHERE l_quantity >= 49"
MUTATION_INSERT_ROWS = 131_072
HTAP_QUERY = "SELECT count(*), sum(l_extendedprice) FROM lineitem"
HTAP_BATCHES = 8


class PinnedReader:
    """A thread that holds one `mvcc.pinned_scope` over lineitem: it reads
    Q1 and Q6 when it pins (binding that version's plates), waits, reads
    them again under the same pin, and releases when told."""

    def __init__(self, session, tpch):
        import threading

        self.session, self.tpch = session, tpch
        self.pinned = threading.Event()
        self.go = threading.Event()
        self.done = threading.Event()
        self.out = {}
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self.pinned.wait(600) or self.error:
            fail(f"pinned reader: {self.error}")

    def _run(self):
        import torch

        from snappydata_tpu_torch.storage import mvcc

        try:
            with mvcc.pinned_scope(self.session.catalog, ["lineitem"]):
                self.out["before"] = run_queries(self.session, self.tpch)
                self.pinned.set()
                self.go.wait()
                torch.cuda.reset_peak_memory_stats()
                self.out["after"] = run_queries(self.session, self.tpch)
                self.out["peak"] = torch.cuda.max_memory_allocated()
        except Exception as e:  # noqa: BLE001 - reported by the caller
            self.error = f"{type(e).__name__}: {e}"
        finally:
            self.pinned.set()
            self.done.set()

    def read_again(self):
        self.go.set()
        if not self.done.wait(900) or self.error:
            fail(f"pinned reader: {self.error}")
        return self.out


def mutated_lineitem(li, extra, tpch):
    """The generated arrays after phase 16's UPDATE, DELETE and insert, as
    the card's plates hold them: l_discount float32 (the UPDATE's
    arithmetic and compare run at the plate width), rows with l_quantity
    >= 49 gone, the inserted rows appended."""
    import numpy as np

    disc = li["l_discount"].astype(np.float32)
    hit = (li["l_shipdate"] >= tpch._days("1998-01-01")) \
        & (disc < np.float32(0.10))
    disc = np.where(hit, disc + np.float32(0.01), disc)
    keep = li["l_quantity"] < 49
    out = {}
    for k, v in li.items():
        col = disc if k == "l_discount" else v
        tail = extra[k].astype(np.float32) if k == "l_discount" else extra[k]
        out[k] = np.concatenate([col[keep], tail])
    return out, int(hit.sum()), int((~keep).sum())


def q10_oracle(li, orders, cust, tpch):
    """TPC-H Q10 in float64 numpy: per-order date filter and customer,
    then `np.bincount` of the returned lines' revenue per customer."""
    import numpy as np

    od = orders["o_orderdate"]
    ok = (od >= tpch._days("1993-10-01")) & (od < tpch._days("1994-01-01"))
    row = li["l_orderkey"] - 1
    has = row < len(od)   # inserted lines may name orders that are absent
    row = np.where(has, row, 0)
    m = has & ok[row] & (li["l_returnflag"] == "R")
    ck = orders["o_custkey"][row[m]]
    rev = (li["l_extendedprice"] * (1 - li["l_discount"].astype(
        np.float64)))[m]
    tot = np.bincount(ck, weights=rev, minlength=len(cust["c_custkey"]) + 1)
    top = np.argsort(-tot, kind="stable")[:20]
    names = tpch.gen_nation()["n_name"]
    bal = cust["c_acctbal"].astype(np.float32).astype(np.float64)
    return [(int(c), cust["c_name"][c - 1], float(tot[c]), float(bal[c - 1]),
             names[cust["c_nationkey"][c - 1]]) for c in top if tot[c] > 0]


def mutation_path(session, tpch, li, orders, cust, first, args):
    """Phase 16 (a) - (h); returns the two kernels' launches over (e)."""
    import threading

    import numpy as np
    import torch

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.engine import executor
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr
    from snappydata_tpu_torch.ops import kahan_reduce as kr

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    reg = global_registry()

    # (a) a reader pins lineitem's current version
    reader = PinnedReader(session, tpch)
    for q in ("q1", "q6"):
        check_rows(f"pinned {q} before the mutations vs phase 4",
                   reader.out["before"][q][0], first[q][0], 1e-9)

    # (b) - (d) the mutations
    t0 = time.perf_counter()
    n_upd = int(session.sql(MUTATION_UPDATE).rows()[0][0])
    upd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_del = int(session.sql(MUTATION_DELETE).rows()[0][0])
    del_s = time.perf_counter() - t0
    extra = tpch.gen_lineitem(MUTATION_INSERT_ROWS, args.seed + 3)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem", list(extra.values()))
    ins_s = time.perf_counter() - t0
    mut, want_upd, want_del = mutated_lineitem(li, extra, tpch)
    log(f"mutation update rows {n_upd} s {upd_s:.3f} rows_per_s "
        f"{n_upd / upd_s:.0f}; delete rows {n_del} s {del_s:.3f} "
        f"rows_per_s {n_del / del_s:.0f}; insert rows "
        f"{MUTATION_INSERT_ROWS} s {ins_s:.3f}")
    if (n_upd, n_del) != (want_upd, want_del):
        fail(f"UPDATE / DELETE touched {n_upd} / {n_del} rows, numpy "
             f"{want_upd} / {want_del}")

    # (e) Q1 and Q6 over the mutated table, counters at 0
    cf0 = reg.counter("compressed_fallback_deltas")
    out = {}
    launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    for name, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        rows, f_s, w_s, moved, lc, calls, peak, resident = \
            timed_query(session, sql, args.reps)
        out[name] = rows
        log(f"mutated_{name} first_s {f_s:.4f} warm_s {w_s:.4f} counters "
            f"{json.dumps(moved)} launches {json.dumps(lc)} "
            f"peak_device_bytes {peak} resident_before_bytes {resident}")
        if moved["host_fallbacks"]:
            fail(f"mutated {name} left the device")
        kname = "grouped_reduce" if name == "q1" else "masked_kahan_sum"
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over mutated "
                 f"{name}'s {1 + args.reps} runs")
        for k in launches:
            launches[k] += lc[k]
        phase = grouped_phase if kname == "grouped_reduce" else kahan_phase
        log(f"kernel {kname} on mutated {name} "
            f"{json.dumps(phase(calls[kname], args.reps))}")
        del calls
        if args.profile:
            log(f"profile mutated_{name} " + json.dumps(profile_run(
                lambda sql=sql: session.sql(sql).rows())))
    cf = reg.counter("compressed_fallback_deltas") - cf0
    log(f"compressed_fallback_deltas moved {cf}")
    if cf < 1:
        fail("the updated l_discount kept its encoded form")
    want = oracle(mut, tpch)
    for q in ("q1", "q6"):
        check_rows(f"mutated {q} vs numpy", out[q], want[q])
    log(f"mutated_q1 {json.dumps(out['q1'])}")
    log(f"mutated_q6 {json.dumps(out['q6'])}")

    # (f) the pinned reader still sees phase 4's table
    pinned = reader.read_again()
    for q in ("q1", "q6"):
        check_rows(f"pinned {q} after the mutations vs phase 4",
                   pinned["after"][q][0], first[q][0], 1e-9)
    log(f"pinned_reader q1_s {pinned['after']['q1'][1]:.4f} q6_s "
        f"{pinned['after']['q6'][1]:.4f} peak_device_bytes_both_versions "
        f"{pinned['peak']} allocated_bytes {torch.cuda.memory_allocated()}")
    log("answers ok: mutated Q1 / Q6 match numpy; the pinned reader's "
        "match phase 4")

    # (g) HTAP: one thread scans while a second session inserts
    price = mut["l_extendedprice"].astype(np.float32).astype(np.float64)
    states = [(len(price), float(price.sum()))]
    batches = [tpch.gen_lineitem(MUTATION_INSERT_ROWS, args.seed + 10 + i)
               for i in range(HTAP_BATCHES)]
    for b in batches:
        p = b["l_extendedprice"].astype(np.float32).astype(np.float64)
        states.append((states[-1][0] + len(p), states[-1][1] + p.sum()))
    writer = SnappySession(catalog=session.catalog)
    scans, ingest_s = [], []
    stop = threading.Event()

    def ingest():
        for b in batches:
            t0 = time.perf_counter()
            writer.insert_arrays("lineitem", list(b.values()))
            ingest_s.append(time.perf_counter() - t0)
            time.sleep(0.5)   # paced, so the scans interleave the inserts
        stop.set()

    fb = reg.counter("host_fallbacks")
    th = threading.Thread(target=ingest, daemon=True)
    th.start()
    while not stop.is_set() or len(scans) < 8:
        t0 = time.perf_counter()
        cnt, sm = session.sql(HTAP_QUERY).rows()[0]
        scans.append((time.perf_counter() - t0, int(cnt), float(sm)))
    th.join()
    serial = []
    for _ in range(8):
        t0 = time.perf_counter()
        session.sql(HTAP_QUERY).rows()
        serial.append(time.perf_counter() - t0)
    mismatches = 0
    for _t, cnt, sm in scans:
        hit = [s for c, s in states if c == cnt]
        if not hit or abs(sm - hit[0]) > 1e-6 * abs(hit[0]):
            mismatches += 1
    if reg.counter("host_fallbacks") != fb:
        fail("an HTAP scan left the device")

    def pct(ts, q):
        ts = sorted(ts)
        return ts[min(len(ts) - 1, int(len(ts) * q))]

    conc = [t for t, _c, _s in scans]
    log(f"htap scans {len(scans)} states_seen "
        f"{len({c for _t, c, _s in scans})} mismatches {mismatches} "
        f"concurrent_p50_s {pct(conc, 0.5):.4f} p99_s {pct(conc, 0.99):.4f}"
        f" serialized_p50_s {pct(serial, 0.5):.4f} p99_s "
        f"{pct(serial, 0.99):.4f} ingest_rows_per_s "
        f"{HTAP_BATCHES * MUTATION_INSERT_ROWS / sum(ingest_s):.0f}")
    if mismatches:
        fail(f"{mismatches} HTAP scans saw no single epoch")
    htap_batches = batches
    del price

    # (h) row tables: nation and region, Q10, PUT INTO and get
    session.sql(tpch.NATION_DDL)
    session.sql(tpch.REGION_DDL)
    session.insert_arrays("nation", list(tpch.gen_nation().values()))
    session.insert_arrays("region", list(tpch.gen_region().values()))
    saved_groups = props.max_groups
    props.max_groups = 1 << 22   # Q10 groups every returning customer
    try:
        rows, f_s, w_s, moved, _lc, _calls, peak, _res = \
            timed_query(session, tpch.Q10, args.reps)
    finally:
        props.max_groups = saved_groups
    log(f"q10 first_s {f_s:.4f} warm_s {w_s:.4f} counters "
        f"{json.dumps(moved)} peak_device_bytes {peak}")
    if args.profile:
        props.max_groups = 1 << 22
        try:
            log("profile q10 " + json.dumps(profile_run(
                lambda: session.sql(tpch.Q10).rows())))
        finally:
            props.max_groups = saved_groups
    if moved["host_fallbacks"] or moved["join_host_fallbacks"] \
            or moved["join_device_joins"] < 1 + args.reps:
        fail(f"Q10 left the device: {moved}")
    # the table now holds the HTAP batches too
    final = {k: np.concatenate([mut[k]] + [
        b[k].astype(np.float32) if k == "l_discount" else b[k]
        for b in htap_batches])
        for k in ("l_orderkey", "l_returnflag", "l_extendedprice",
                  "l_discount")}
    check_rows("Q10 vs numpy", rows, q10_oracle(final, orders, cust, tpch))
    log(f"q10 {json.dumps(rows[:3], default=str)}")
    del final

    # PUT INTO the row table nation (one upsert, one insert), get(), and
    # PUT INTO a keyed column table
    session.sql("PUT INTO nation VALUES (7, 'GERMANIA', 3), "
                "(25, 'ATLANTIS', 1)")
    got = [tuple(session.get("nation", (k,)) or ()) for k in (7, 25, 3)]
    want_get = [(7, "GERMANIA", 3), (25, "ATLANTIS", 1),
                (3, "CANADA", 1)]
    if [tuple(x if isinstance(x, str) else int(x) for x in g)
            for g in got] != want_get:
        fail(f"nation after PUT INTO: get() {got}, expected {want_get}")
    cnt = session.sql("SELECT count(*), sum(n_regionkey) FROM nation"
                      ).rows()[0]
    if tuple(cnt) != (26, sum(tpch.gen_nation()["n_regionkey"]) + 1):
        fail(f"nation after PUT INTO: {cnt}")
    session.sql("CREATE TABLE kv (k BIGINT, v DOUBLE) USING column "
                "OPTIONS (key_columns 'k')")
    session.insert_arrays("kv", [np.arange(100_000, dtype=np.int64),
                                 np.ones(100_000)])
    session.sql("PUT INTO kv VALUES (5, 100.0), (100000, 7.0)")
    kv = tuple(session.sql("SELECT count(*), sum(v), max(v) FROM kv"
                           ).rows()[0])
    if kv != (100_001, 100_106.0, 100.0):
        fail(f"keyed column table after PUT INTO: {kv}")
    log(f"put_into nation get {json.dumps(got, default=str)} kv "
        f"{json.dumps(kv, default=str)}")
    log("answers ok: HTAP scans saw single epochs; Q10 over the row table "
        "nation matches numpy; PUT INTO and get() upsert on the key")
    return launches


# --------------------------------------------------------------------------
# phase 18: nested orders (ARRAY / MAP / STRUCT plates)
# --------------------------------------------------------------------------

NESTED_ORDERS = 1_500_000     # SF 1: the cells are Python objects
NESTED_LINES = 6_000_000
NESTED_COLS = ("o_orderkey", "o_orderdate", "info", "modes", "prices",
               "qty_by_mode")


def nested_oracle(orders, li):
    """N1 / N2 in float64 numpy from the generated arrays: per order its
    line count, whether a line ships by MAIL and by AIR, its AIR quantity
    and its first line's price (stable l_orderkey order), the DOUBLE
    values rounded to the card's float32 plates."""
    import numpy as np

    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    n = len(orders["o_orderkey"])
    ok = orders["o_orderkey"]
    key = li["l_orderkey"]
    order = np.argsort(key, kind="stable")
    lo = np.searchsorted(key[order], ok, side="left")
    lines = np.bincount(key, minlength=n + 2)[ok]
    mode = li["l_shipmode"]

    def per_order(w):
        return np.bincount(key, weights=w, minlength=n + 2)[ok]

    mail = per_order(mode == "MAIL") > 0
    has_air = per_order(mode == "AIR") > 0
    air = f32(per_order(li["l_quantity"] * (mode == "AIR")))
    price = f32(li["l_extendedprice"][order])
    first = np.where(lines > 0, price[np.minimum(lo, len(price) - 1)], 0.0)
    total = f32(orders["o_totalprice"])
    n1 = []
    for a in (False, True):
        for big in (False, True):
            m = mail & (has_air == a) & ((lines >= 4) == big)
            if m.any():
                n1.append((a, big, int(m.sum()), float(air[m].sum()),
                           int(lines[m].sum()), float(total[m].sum()),
                           float(first[m].max())))
    m2 = (lines >= 3) & (total > 100000)
    return n1, [(float(first[m2].sum()),)]


def complex_plate_bytes(data):
    """Bytes of the complex columns' plates in a table's device cache."""
    import torch

    total = 0
    for entry in list(data._device_cache.values()):
        for key, val in entry.items():
            if isinstance(key, tuple) and str(key[0]).startswith("_build_"):
                total += sum(t.numel() * t.element_size()
                             for t in torch.utils._pytree.tree_leaves(val)
                             if isinstance(t, torch.Tensor))
    return total


def nested_path(tpch, args):
    """Phase 18; returns the two kernels' launches over N1 and N2."""
    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    t0 = time.perf_counter()
    orders = tpch.gen_orders(NESTED_ORDERS, NESTED_ORDERS // 10, args.seed)
    li = tpch.gen_lineitem(NESTED_LINES, 7)
    nested = tpch.gen_orders_nested(orders, li)
    log(f"nested_gen_s {time.perf_counter() - t0:.3f} orders "
        f"{NESTED_ORDERS} lines {NESTED_LINES}")
    s = SnappySession(catalog=Catalog())
    s.sql(tpch.ORDERS_NESTED_DDL)
    t0 = time.perf_counter()
    s.insert_arrays("orders_nested", [nested[c] for c in NESTED_COLS])
    ing = time.perf_counter() - t0
    log(f"nested_ingest_s {ing:.3f} rows_per_s {NESTED_ORDERS / ing:.0f}")
    del nested
    want = dict(zip(("n1", "n2"), nested_oracle(orders, li)))
    del orders, li
    launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    data = s.catalog.describe("orders_nested").data
    for name, sql, kname in (("n1", tpch.NESTED_N1, "grouped_reduce"),
                             ("n2", tpch.NESTED_N2, "masked_kahan_sum")):
        rows, f_s, w_s, moved, lc, calls, peak, resident = \
            timed_query(s, sql, args.reps)
        log(f"nested_{name} first_s {f_s:.4f} warm_s {w_s:.4f} counters "
            f"{json.dumps(moved)} launches {json.dumps(lc)} "
            f"peak_device_bytes {peak} resident_before_bytes {resident}")
        if moved["host_fallbacks"]:
            fail(f"nested {name} left the device")
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over nested "
                 f"{name}'s {1 + args.reps} runs")
        for k in launches:
            launches[k] += lc[k]
        phase = grouped_phase if kname == "grouped_reduce" else kahan_phase
        log(f"kernel {kname} on nested {name} "
            f"{json.dumps(phase(calls[kname], args.reps))}")
        check_rows(f"nested {name} vs numpy", rows, want[name])
        log(f"nested_{name} {json.dumps(rows[:4])}")
        if args.profile:
            log(f"profile nested_{name} " + json.dumps(profile_run(
                lambda sql=sql: s.sql(sql).rows())))
    log(f"nested_complex_plate_bytes {complex_plate_bytes(data)}")
    log("answers ok: N1 / N2 over the nested orders match numpy")
    return launches


# --------------------------------------------------------------------------
# phase 19: durable lineitem (WAL, checkpoint, recovery, compaction)
# --------------------------------------------------------------------------

GROUP_COMMIT_THREADS = 4
GROUP_COMMIT_STMTS = 500
DURABLE_STMT_ROWS = 1 << 20


def _row_sql(rows, i, names):
    vals = []
    for k in names:
        v = rows[k][i]
        vals.append(f"'{v}'" if isinstance(v, str) else repr(v.item()))
    return "INSERT INTO lineitem VALUES (" + ", ".join(vals) + ")"


def durable_queries(s, tpch, want, args, what):
    """Q1 and Q6 once and --reps times warm on `s`, checked against
    `want`; (launches, compressed_fallback_deltas moved, the grouped
    kernel's last launch configuration)."""
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.ops import group_reduce as gr

    reg = global_registry()
    cf0 = reg.counter("compressed_fallback_deltas")
    fb0 = {k: v for k, v in reg.snapshot().items()
           if k.startswith("compressed_fallback_")}
    launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
    cfg = None
    for name, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        rows, f_s, w_s, moved, lc, calls, peak, _res = \
            timed_query(s, sql, args.reps)
        log(f"durable_{what}_{name} first_s {f_s:.4f} warm_s {w_s:.4f} "
            f"counters {json.dumps(moved)} launches {json.dumps(lc)} "
            f"peak_device_bytes {peak}")
        if moved["host_fallbacks"]:
            fail(f"durable {what} {name} left the device")
        kname = "grouped_reduce" if name == "q1" else "masked_kahan_sum"
        if lc[kname] < 1 + args.reps:
            fail(f"{kname} launched {lc[kname]} times over durable {what} "
                 f"{name}'s {1 + args.reps} runs")
        if name == "q1":
            cfg = dict(gr.grouped_reduce.config)
        for k in launches:
            launches[k] += lc[k]
        phase = grouped_phase if kname == "grouped_reduce" else kahan_phase
        log(f"kernel {kname} on durable {what} {name} "
            f"{json.dumps(phase(calls[kname], args.reps))}")
        check_rows(f"durable {what} {name} vs numpy", rows, want[name])
        if args.profile:
            log(f"profile durable_{what}_{name} " + json.dumps(profile_run(
                lambda sql=sql: s.sql(sql).rows())))
    moved = {k: v - fb0.get(k, 0) for k, v in reg.snapshot().items()
             if k.startswith("compressed_fallback_") and v != fb0.get(k, 0)}
    log(f"durable_{what} compressed_fallbacks {json.dumps(moved)}")
    return launches, reg.counter("compressed_fallback_deltas") - cf0, cfg


def durable_path(tpch, li, args):
    """Phase 19 (a) - (g) on the first 1 / DEC_DEPTH of lineitem's rows in
    a durable session under a temporary directory; returns the two
    kernels' launches over (e) - (g)."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from snappydata_tpu_torch import SnappySession, config
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.observability.metrics import global_registry
    from snappydata_tpu_torch.storage import compact
    from snappydata_tpu_torch.storage.encoding import compress_bytes

    props = config.global_properties()
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    props.wal_fsync_mode = "group"
    reg = global_registry()
    d = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    st = os.statvfs(d)
    log(f"durable_dir_free_bytes {st.f_bavail * st.f_frsize}")
    codec = compress_bytes(b"\0" * 1024, props.compression_codec)[0]
    log(f"durable_codec configured {props.compression_codec} used {codec}")
    try:
        n = len(li["l_orderkey"])
        names = list(li.keys())
        # (a) CREATE, then insert_arrays in 1,048,576-row statements
        s1 = SnappySession(catalog=Catalog(), data_dir=d, recover=False)
        s1.sql(tpch.LINEITEM_DDL)
        f0, w0 = reg.counter("wal_fsync_count"), \
            reg.counter("wal_bytes_written")
        t0 = time.perf_counter()
        for lo in range(0, n, DURABLE_STMT_ROWS):
            s1.insert_arrays("lineitem", [li[k][lo:lo + DURABLE_STMT_ROWS]
                                          for k in names])
        ing = time.perf_counter() - t0
        log(f"durable_ingest rows {n} s {ing:.3f} rows_per_s {n / ing:.0f}"
            f" wal_bytes {reg.counter('wal_bytes_written') - w0} "
            f"wal_fsync_count {reg.counter('wal_fsync_count') - f0}")
        # (b) checkpoint
        t0 = time.perf_counter()
        s1.checkpoint()
        ck = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(r, f))
                   for r, _d, fs in os.walk(d) for f in fs)
        log(f"durable_checkpoint s {ck:.3f} bytes_on_disk {disk} codec "
            f"{codec}")
        # (c) journaled UPDATE, DELETE and one insert
        times = {}
        for what, sql in (("update", MUTATION_UPDATE),
                          ("delete", MUTATION_DELETE)):
            t0 = time.perf_counter()
            cnt = int(s1.sql(sql).rows()[0][0])
            times[what] = (time.perf_counter() - t0, cnt)
        extra = tpch.gen_lineitem(MUTATION_INSERT_ROWS, args.seed + 3)
        t0 = time.perf_counter()
        s1.insert_arrays("lineitem", [extra[k] for k in names])
        times["insert"] = (time.perf_counter() - t0, MUTATION_INSERT_ROWS)
        log("durable_mutations " + " ".join(
            f"{k}_s {v[0]:.3f} {k}_rows {v[1]}" for k, v in times.items()))
        # (d) group commit: threads of single-row INSERT statements
        single = tpch.gen_lineitem(GROUP_COMMIT_THREADS * GROUP_COMMIT_STMTS,
                                   args.seed + 20)
        stmts = [_row_sql(single, i, names)
                 for i in range(GROUP_COMMIT_THREADS * GROUP_COMMIT_STMTS)]
        f0 = reg.counter("wal_fsync_count")
        g0 = reg.counter("wal_group_commit_batches")
        errors = []

        def committer(w):
            try:
                for sql in stmts[w::GROUP_COMMIT_THREADS]:
                    s1.sql(sql)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=committer, args=(w,))
                   for w in range(GROUP_COMMIT_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gc_s = time.perf_counter() - t0
        if errors:
            fail(f"group commit: {errors[0]!r}")
        log(f"durable_group_commit statements {len(stmts)} threads "
            f"{GROUP_COMMIT_THREADS} s {gc_s:.3f} acks_per_s "
            f"{len(stmts) / gc_s:.0f} wal_fsync_count "
            f"{reg.counter('wal_fsync_count') - f0} "
            f"wal_group_commit_batches "
            f"{reg.counter('wal_group_commit_batches') - g0}")
        tail = {k: np.concatenate([extra[k], single[k]]) for k in names}
        mut, _u, _d = mutated_lineitem(li, tail, tpch)
        want = oracle(mut, tpch)
        del mut, tail
        # (e) crash-shape reopen: s1 stays open
        launches = {"grouped_reduce": 0, "masked_kahan_sum": 0}
        t0 = time.perf_counter()
        s2 = SnappySession(data_dir=d)
        log(f"durable_recovery_s {time.perf_counter() - t0:.3f}")
        lc, cf, _cfg = durable_queries(s2, tpch, want, args, "recovered")
        log(f"durable_recovered compressed_fallback_deltas moved {cf}")
        if cf < 1:
            fail("the recovered l_discount kept its encoded form")
        for k in launches:
            launches[k] += lc[k]
        # (f) compaction of the recovered lineitem
        data = s2.catalog.describe("lineitem").data
        t0 = time.perf_counter()
        out = compact.run_compaction_pass(data, force=True)
        log(f"durable_compaction s {time.perf_counter() - t0:.3f} "
            f"batches_rewritten {out['rewritten']} produced "
            f"{out['produced']} reclaimed_bytes {out['reclaimed_bytes']}")
        if out["rewritten"] < 1:
            fail(f"compaction rewrote nothing: {out}")
        lc, cf, cfg = durable_queries(s2, tpch, want, args, "compacted")
        log(f"durable_compacted compressed_fallback_deltas moved {cf} "
            f"grouped_reduce_config {json.dumps(cfg)}")
        if cf:
            fail("a compacted column still bound with its delta")
        for k in launches:
            launches[k] += lc[k]
        # (g) a third crash-shape reopen answers the same
        t0 = time.perf_counter()
        s3 = SnappySession(data_dir=d)
        log(f"durable_recovery_again_s {time.perf_counter() - t0:.3f}")
        lc, _cf, _cfg = durable_queries(s3, tpch, want, args, "reopened")
        for k in launches:
            launches[k] += lc[k]
        for s in (s1, s2, s3):
            s.disk_store.close()
        log("answers ok: the recovered, compacted and reopened lineitem "
            "match numpy")
        return launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=16.0,
                    help="TPC-H scale factor of lineitem (6M rows each)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm run of each timed query "
                         "with torch.profiler")
    ap.add_argument("--ptxas", action="store_true",
                    help="build with -Xptxas -v and print each kernel's "
                         "registers, shared memory and spills")
    ap.add_argument("--trace-dir", metavar="DIR",
                    help="with --profile, write each trace that lost kernel "
                         "records to DIR as a Chrome trace")
    ap.add_argument("--kahan-profile", metavar="PATH",
                    help="child mode of phase 17: profile the Kahan kernel "
                         "on the inputs saved in PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if args.kahan_profile:
        return kahan_profile_main(args.kahan_profile, args.reps)
    if args.trace_dir:
        TRACE_DIR.append(os.path.abspath(args.trace_dir))
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from snappydata_tpu_torch import SnappySession, config
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.engine import executor
        from snappydata_tpu_torch.observability.metrics import \
            global_registry
        from snappydata_tpu_torch.ops import cuda_build
        from snappydata_tpu_torch.ops import group_reduce as gr
        from snappydata_tpu_torch.ops import kahan_reduce as kr
        from snappydata_tpu_torch.utils import tpch
        from snappydata_tpu_torch.utils import tpch_code_domain as tcd
    except ImportError as e:
        fail(f"the snappydata_tpu_torch package is not beside this script "
             f"({e})")
    if "jax" in sys.modules or any(m.startswith("snappydata_tpu.")
                                   for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    ptxas = ("-Xptxas", "-v") if args.ptxas else ()
    try:
        built = cuda_build.build(KERNELS, force=True, extra_flags=ptxas)
    except RuntimeError as e:
        fail(str(e))
    log(f"build_s {time.perf_counter() - t0:.3f} ({', '.join(KERNELS)})")
    if args.ptxas:
        for name in built:
            for line in built[name].splitlines():
                if "ptxas" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")

    # 3. data
    n_rows = int(args.sf * ROWS_PER_SF)
    t0 = time.perf_counter()
    li = tpch.gen_lineitem(n_rows, args.seed)
    log(f"gen_s {time.perf_counter() - t0:.3f} rows {n_rows}")
    props = config.global_properties()
    session = SnappySession(catalog=Catalog())   # device: cuda
    session.sql(tpch.LINEITEM_DDL)
    t0 = time.perf_counter()
    session.insert_arrays("lineitem", list(li.values()))
    load_s = time.perf_counter() - t0
    log(f"load_s {load_s:.3f} rows_per_s {n_rows / load_s:.0f}")

    # 4. the main path, kernel lanes on
    props.pallas_reduce = True
    props.pallas_group_reduce = True
    # the executor's references to the two wrappers record the inputs
    # the main path hands each kernel; the wrappers count their launches
    rec_k = Recorder(executor.masked_kahan_sum)
    rec_g = Recorder(executor.grouped_reduce)
    executor.masked_kahan_sum = rec_k
    executor.grouped_reduce = rec_g
    kr.masked_kahan_sum.launches = 0
    gr.grouped_reduce.launches = 0
    try:
        first = run_queries(session, tpch)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"main path: {type(e).__name__}: {e}")
    launches = {"masked_kahan_sum": kr.masked_kahan_sum.launches,
                "grouped_reduce": gr.grouped_reduce.launches}
    executor.masked_kahan_sum = rec_k.fn
    executor.grouped_reduce = rec_g.fn
    log(f"main_path_launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            fail(f"{name} did not launch on the main path")
    for q, (rows, s) in first.items():
        log(f"{q}_first_s {s:.3f}")
    warm = {}
    for q in ("q1", "q6"):
        times = []
        for _ in range(args.reps):
            times.append(run_queries(session, tpch)[q][1])
        warm[q] = sorted(times)[len(times) // 2]
        log(f"{q}_warm_s {warm[q]:.4f} rows_per_s {n_rows / warm[q]:.0f}")
    if args.profile:
        for q in ("q1", "q6"):
            log(f"profile {q} " + json.dumps(profile_run(
                lambda q=q: session.sql(getattr(tpch, q.upper())).rows())))

    # 5. kernels against their plain versions, on the main path's inputs
    kres = {"masked_kahan_sum": kahan_phase(rec_k.calls, args.reps),
            "grouped_reduce": grouped_phase(rec_g.calls, args.reps)}
    for name, r in kres.items():
        log(f"kernel {name} " + json.dumps(r))

    # 6. the answers
    want = oracle(li, tpch)
    for q in ("q1", "q6"):
        check_rows(f"{q} vs numpy oracle", first[q][0], want[q])
    props.pallas_reduce = False
    props.pallas_group_reduce = False
    off = run_queries(session, tpch)
    for q in ("q1", "q6"):
        check_rows(f"{q} vs knobs off", first[q][0], off[q][0])
        log(f"{q}_knobs_off_s {off[q][1]:.4f}")
    log("answers ok: Q1 (%d groups) and Q6 match the oracle and the "
        "knobs-off lanes" % len(first["q1"][0]))

    # 7. the compressed-domain path: Q6 / Q1 over code plates
    data = session.catalog.lookup_table("lineitem").data
    if data.snapshot().row_count:
        data.force_rollover()   # row-buffer rows would bind decoded
    rec_f = Recorder(tcd.fused_code_filter_sum)
    rec_c = Recorder(tcd.grouped_code_reduce)
    tcd.fused_code_filter_sum = rec_f
    tcd.grouped_code_reduce = rec_c
    kr.fused_code_filter_sum.launches = 0
    gr.grouped_code_reduce.launches = 0
    try:
        t0 = time.perf_counter()
        q6_out = tcd.code_domain_q6(session)
        t6 = time.perf_counter() - t0
        t0 = time.perf_counter()
        q1_out = tcd.code_domain_q1(session)
        t1 = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"compressed-domain path: {type(e).__name__}: {e}")
    code_launches = {
        "fused_code_filter_sum": kr.fused_code_filter_sum.launches,
        "grouped_code_reduce": gr.grouped_code_reduce.launches}
    tcd.fused_code_filter_sum = rec_f.fn
    tcd.grouped_code_reduce = rec_c.fn
    log(f"code_domain_launches {json.dumps(code_launches)}")
    for name, count in code_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the compressed-domain path")
    launches.update(code_launches)
    log(f"code_domain_q6 {json.dumps(q6_out)}")
    log(f"code_domain_q1 {json.dumps(q1_out)}")
    for name, fn, t_first in (("code_domain_q6", tcd.code_domain_q6, t6),
                              ("code_domain_q1", tcd.code_domain_q1, t1)):
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn(session)
            times.append(time.perf_counter() - t0)
        log(f"{name}_first_s {t_first:.4f} warm_s "
            f"{sorted(times)[len(times) // 2]:.4f}")
    if args.profile:
        for name, fn in (("code_domain_q6", tcd.code_domain_q6),
                         ("code_domain_q1", tcd.code_domain_q1)):
            log(f"profile {name} " + json.dumps(
                profile_run(lambda fn=fn: fn(session))))
    code_domain_checks(session, tpch, first, want, q6_out, q1_out)
    log("answers ok: code_domain_q6 / code_domain_q1 match the session and "
        "the oracle")

    # 8. the code kernels against their plain versions, on phase 7's inputs
    kres["fused_code_filter_sum"] = code_filter_phase(rec_f.calls,
                                                      args.reps)
    kres["grouped_code_reduce"] = code_grouped_phase(rec_c.calls, args.reps)
    for name in ("fused_code_filter_sum", "grouped_code_reduce"):
        log(f"kernel {name} " + json.dumps(kres[name]))

    # 9. the run-space RLE probe
    try:
        n_rle, rle_rows, rle_first, rle_warm = rle_probe(session, n_rows,
                                                         args.reps)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"RLE probe: {type(e).__name__}: {e}")
    log(f"rle_probe rows {n_rle} answer {json.dumps(rle_rows)} first_s "
        f"{rle_first:.4f} warm_s {rle_warm:.4f}")

    # 10. the join path: orders LEFT JOIN lineitem (Q3C), then a
    # generic-key join, through the device join engine
    n_orders = int(args.sf * ORDERS_PER_SF)
    t0 = time.perf_counter()
    orders = tpch.gen_orders(n_orders, n_orders // 10, args.seed + 1)
    log(f"orders_gen_s {time.perf_counter() - t0:.3f} rows {n_orders}")
    session.sql(tpch.ORDERS_DDL)
    t0 = time.perf_counter()
    session.insert_arrays("orders", list(orders.values()))
    o_load_s = time.perf_counter() - t0
    log(f"orders_load_s {o_load_s:.3f} rows_per_s {n_orders / o_load_s:.0f}")
    # the expanded output is ~39 B per slot over 134M slots at SF 16 and
    # the build artifact 1.6 GB: the default caps (2 GiB, 1 GiB) would
    # send Q3C to the host join and re-sort every run
    props.join_expand_max_bytes = 8 << 30
    props.join_build_cache_bytes = 8 << 30
    props.pallas_group_reduce = True
    try:
        (q3c_rows, q3c_first, q3c_warm, jmoved, jlaunch, jcalls, peak,
         resident, jprof) = join_path(session, tpch, args.reps, args.profile)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"join path: {type(e).__name__}: {e}")
    log(f"join_path_counters {json.dumps(jmoved)}")
    log(f"join_path_launches {json.dumps({'grouped_reduce': jlaunch})}")
    if jmoved["join_host_fallbacks"] or jmoved["host_fallbacks"]:
        fail(f"Q3C left the device: {jmoved}")
    if jmoved["join_device_joins"] < 1:
        fail("Q3C ran no device join")
    if jmoved["join_build_sorts"] != 1:
        fail(f"Q3C sorted its build {jmoved['join_build_sorts']} times "
             f"over {1 + args.reps} runs, expected once")
    if jlaunch < 1:
        fail("grouped_reduce did not launch on the join path")
    log(f"q3c_first_s {q3c_first:.4f} warm_s {q3c_warm:.4f} "
        f"lineitem_rows_per_s {n_rows / q3c_warm:.0f} "
        f"expand_bucket {jmoved['join_expand_out_rows'] // (1 + args.reps)}"
        f" peak_device_bytes {peak} resident_before_bytes {resident}")
    if jprof is not None:
        log(f"profile q3c {json.dumps(jprof)}")
    t0 = time.perf_counter()
    want_q3c, want_generic = join_oracle(li, orders, tpch)
    log(f"join_oracle_s {time.perf_counter() - t0:.3f}")
    check_rows("Q3C vs numpy oracle", q3c_rows, want_q3c, 5e-5)
    log(f"q3c {json.dumps(q3c_rows)}")
    # the grouped kernel at the join path's inputs: its own line, so the
    # kernels' line keeps phase 5's main-path numbers
    log(f"kernel grouped_reduce on Q3C "
        f"{json.dumps(grouped_phase(jcalls, args.reps))}")
    del jcalls
    sort_ms, sort_rows = build_sort_ms(session, args.reps)
    log(f"build_sort_ms {sort_ms:.3f} rows {sort_rows}")
    reg = global_registry()
    fb0 = reg.counter("host_fallbacks")
    try:
        t0 = time.perf_counter()
        gen_rows = session.sql(GENERIC_JOIN_QUERY).rows()
        gen_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"generic-key join: {type(e).__name__}: {e}")
    if reg.counter("host_fallbacks") != fb0:
        fail("the generic-key join left the device")
    check_rows("generic-key join vs numpy", gen_rows, want_generic, 5e-5)
    log(f"generic_join groups {len(gen_rows)} first_s {gen_s:.4f}")
    log("answers ok: Q3C and the generic-key join match numpy")

    # 11. the tiled lane over lineitem at a tenth of Q1's decoded bind
    units1, ub1, tu1, tiles_q1 = tile_plan(session, "lineitem", Q1_COLS, 1)
    budget = units1 * ub1 // 10
    _u, _b, tu1, tiles_q1 = tile_plan(session, "lineitem", Q1_COLS, budget)
    _u, ub6, tu6, tiles_q6 = tile_plan(session, "lineitem", Q6_COLS, budget)
    log(f"tile_plan units {units1} q1_bind_bytes {units1 * ub1} "
        f"scan_tile_bytes {budget} q1 tile_units {tu1} tiles {tiles_q1} "
        f"q6 tile_units {tu6} tiles {tiles_q6}")
    try:
        (t_rows, t_times, t_up, tmoved, tlaunch, tpeak, tresident, tk_calls,
         tg_calls, tprof) = tiled_path(session, tpch, args.reps, budget,
                                       args.profile)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"tiled path: {type(e).__name__}: {e}")
    runs = 1 + args.reps
    log(f"tiled_path_counters {json.dumps(tmoved)}")
    log(f"tiled_path_launches {json.dumps(tlaunch)}")
    if tmoved["scan_tiles"] != (tiles_q1 + tiles_q6) * runs:
        fail(f"scan_tiles moved {tmoved['scan_tiles']}, expected "
             f"({tiles_q1} + {tiles_q6}) x {runs}")
    if tmoved["scan_tile_device_merges"] < 1 \
            or tmoved["scan_tile_host_merges"]:
        fail(f"the tiled passes did not merge on the device: {tmoved}")
    if tlaunch["grouped_reduce"] != tiles_q1 * runs:
        fail(f"grouped_reduce launched {tlaunch['grouped_reduce']} times "
             f"over {tiles_q1} Q1 tiles x {runs} runs")
    if tlaunch["masked_kahan_sum"] != tiles_q6 * runs:
        fail(f"masked_kahan_sum launched {tlaunch['masked_kahan_sum']} "
             f"times over {tiles_q6} Q6 tiles x {runs} runs")
    if tmoved["prefetch_windows_warmed"] < 1 \
            or tmoved["prefetch_worker_deaths"]:
        fail(f"the tile prefetcher did not warm windows cleanly: {tmoved}")
    if tmoved["host_fallbacks"]:
        fail("a tiled pass left the device")
    for q in ("q1", "q6"):
        check_rows(f"tiled {q} vs phase 4", t_rows[q], first[q][0])
        check_rows(f"tiled {q} vs numpy oracle", t_rows[q], want[q])
    depth = int(props.tier_prefetch_depth)
    mem_bound = (depth + 2) * budget + 64 * MIB
    log(f"tiled_peak_device_bytes {tpeak} resident_before_bytes "
        f"{tresident} bound {mem_bound}")
    if tpeak > mem_bound:
        fail(f"the tiled pass allocated {tpeak} B above the resident set, "
             f"over the bound {mem_bound}")
    h2d = pinned_h2d_gb_per_s(budget, args.reps)
    for q in ("q1", "q6"):
        ts = t_times[q]
        tw = sorted(ts[1:])[len(ts[1:]) // 2] if args.reps else ts[0]
        up = t_up[q][-1]
        log(f"tiled_{q} first_s {ts[0]:.4f} warm_s {tw:.4f} rows_per_s "
            f"{n_rows / tw:.0f} in_hbm_rows_per_s {n_rows / warm[q]:.0f} "
            f"upload_bytes_per_pass {up} effective_upload_gb_per_s "
            f"{up / tw / 1e9:.3f}")
    log(f"pinned_h2d_gb_per_s {h2d:.3f} ({budget} B copies)")
    log(f"prefetch_overlap_ms {tmoved['prefetch_overlap_ms']} "
        f"window_waits {tmoved['prefetch_window_waits']} "
        f"tile_launch_overlaps {tmoved['scan_tile_prefetch_overlap']}")
    if tprof is not None:
        log(f"profile tiled_q1 {json.dumps(tprof)}")
    kahan_shapes = [("in-HBM Q6", rec_k.calls[0])]
    for label, calls in (("first", tk_calls[:1]), ("last", tk_calls[-1:])):
        log(f"kernel masked_kahan_sum on the {label} tile "
            f"{json.dumps(kahan_phase(calls, args.reps))}")
        kahan_shapes.append((f"{label} tile", calls[0]))
    log(f"kernel grouped_reduce on the last tile "
        f"{json.dumps(grouped_phase(tg_calls[-1:], args.reps))}")
    for name in ("masked_kahan_sum", "grouped_reduce"):
        launches[name] += tlaunch[name]
    del tk_calls
    log("answers ok: tiled Q1 and Q6 match phase 4 and the oracle")

    # 12. exact decimals on the card, over the first quarter of the rows:
    # a second full-size ingest would leave phases 15 - 16 too little of
    # the run's time limit
    n_dec = n_rows // DEC_DEPTH
    try:
        dec = decimal_path(session, tpch,
                           {k: v[:n_dec] for k, v in li.items()},
                           args.reps, budget, args.profile)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"decimal path: {type(e).__name__}: {e}")
    log(f"decimal_load_s {dec['load_s']:.3f} rows {n_dec} (1/{DEC_DEPTH} "
        f"of lineitem's)")
    for q in ("q1", "q6"):
        log(f"decimal_{q} first_s {dec[q + '_first_s']:.4f} warm_s "
            f"{dec[q + '_warm_s']:.4f} rows_per_s "
            f"{n_dec / dec[q + '_warm_s']:.0f}")
    log(f"decimal_q1_tiled tiles {dec['q1_tiles']} first_s "
        f"{dec['q1_tiled_first_s']:.4f} warm_s {dec['q1_tiled_warm_s']:.4f} "
        f"counters {json.dumps(dec['q1_tiled_counters'])}")
    if dec["q1_tiled_prof"] is not None:
        log(f"profile decimal_q1_tiled {json.dumps(dec['q1_tiled_prof'])}")
    log(f"decimal_q1 {json.dumps([[str(x) for x in r] for r in dec['q1']])}")
    log(f"decimal_overflow_probe {dec['probe']} (host path, counted)")
    log("answers ok: exact-decimal Q1/Q6 match the cents oracle, tiled and "
        "untiled")

    # 13. count(DISTINCT) and the matmul strategy
    try:
        d_rows, d_first, d_warm = distinct_path(session, li, args.reps)
        strat = strategy_timing(tg_calls, args.reps)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"count(DISTINCT) / strategy: {type(e).__name__}: {e}")
    del tg_calls
    log(f"count_distinct first_s {d_first:.4f} warm_s {d_warm:.4f} "
        f"rows_per_s {n_rows / d_warm:.0f} {json.dumps(d_rows)}")
    log(f"strategy_timing {json.dumps(strat)}")
    log("answers ok: count(DISTINCT) matches numpy; matmul equals scatter")

    # 14. subqueries and functions on the card: Q4, Q22 and the functions
    # query at --sf, Q18 at SF 1
    try:
        sub_launches = subquery_path(session, tpch, li, orders, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"subquery path: {type(e).__name__}: {e}")
    log(f"subquery_path_launches {json.dumps(sub_launches)}")
    for name, count in sub_launches.items():
        if count < 1:
            fail(f"{name} did not launch on the subquery path")
        launches[name] += count

    # 15. window functions over orders, on the device
    try:
        window_path(session, tpch, orders, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"window path: {type(e).__name__}: {e}")

    # 16. mutations at --sf on lineitem: a pinned reader, UPDATE, DELETE,
    # insert, Q1 / Q6 through both kernels, HTAP, row tables
    cust = tpch.gen_customer(n_orders // 10, args.seed + 2)
    try:
        mut_launches = mutation_path(session, tpch, li, orders, cust, first,
                                     args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"mutation path: {type(e).__name__}: {e}")
    del cust
    log(f"mutation_path_launches {json.dumps(mut_launches)}")
    for name, count in mut_launches.items():
        launches[name] += count

    # 17. the Kahan kernel under torch.profiler, in a child process whose
    # profiler starts fresh
    for label, r in kahan_profile_child(kahan_shapes, args.reps, root):
        log(f"kernel masked_kahan_sum profile on the {label} "
            f"{json.dumps(r)}")
    del kahan_shapes, rec_k

    # 18. nested orders: ARRAY / MAP / STRUCT plates on the card
    # the main session's plates are not read again: free the card first
    for info in session.catalog.list_tables():
        getattr(info.data, "_device_cache", {}).clear()
    del session
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    try:
        n_launches = nested_path(tpch, args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"nested path: {type(e).__name__}: {e}")
    log(f"nested_path_launches {json.dumps(n_launches)}")
    for name, count in n_launches.items():
        launches[name] += count
    gc.collect()
    torch.cuda.empty_cache()

    # 19. a durable lineitem: WAL, checkpoint, crash-shape recovery and
    # the compactor, over the first 1 / DEC_DEPTH of the rows
    try:
        d_launches = durable_path(tpch, {k: v[:n_dec] for k, v in li.items()},
                                  args)
    except Exception as e:  # noqa: BLE001 - report the phase, then exit
        fail(f"durable path: {type(e).__name__}: {e}")
    log(f"durable_path_launches {json.dumps(d_launches)}")
    for name, count in d_launches.items():
        launches[name] += count

    # 20. result lines
    src = {"masked_kahan_sum": ("snappydata_tpu_torch/csrc/kahan_reduce.cu",
                                "snappydata_tpu/ops/pallas_reduce.py:48"),
           "grouped_reduce": ("snappydata_tpu_torch/csrc/group_reduce.cu",
                              "snappydata_tpu/ops/pallas_group.py:103"),
           "fused_code_filter_sum": (
               "snappydata_tpu_torch/csrc/code_filter_sum.cu",
               "snappydata_tpu/ops/pallas_reduce.py:169"),
           "grouped_code_reduce": (
               "snappydata_tpu_torch/csrc/group_code_reduce.cu",
               "snappydata_tpu/ops/pallas_group.py:321")}
    kernels = []
    for name, r in kres.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
