#!/usr/bin/env python3
"""Chip smoke for druid_tpu_torch: the native aggregate path on one CUDA card.

    python3 chip_smoke.py                 # every phase (one card)

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from druid_tpu_torch/csrc (nvcc, sm_90a);
  3. kernel B1 (sorted_reduce) against its plain PyTorch version on the card,
     on synthetic projections: a 12.5M-row one with G = 131072 and five ops,
     and edge cases; integers and min/max exact, float sums within
     1e-5 * sum|v| per group, and bit-identical across two runs;
  4. the main path at full size: the headline data (100M rows in 8 segments
     of 12.5M, seed 1234) through QueryExecutor(device="cuda").run_json —
     the headline groupBy (through B1: +8 launches per run), topN and an
     hourly timeseries, each checked against an independent numpy result.
     The groupBy's B1 calls keep their inputs (and print their windows);
  5. B1 against its plain version on the inputs the main path gave it (the
     first segment's projection), then timed there with CUDA events beside
     its HBM bound, its plain version and a library yardstick
     (index_add_/scatter_reduce over the same keys, never used by the port);
     and the warm p50 of each query.
The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
ROWS, SEGMENTS, SEED = 100_000_000, 8, 1234
DAY = ("2026-01-01", "2026-01-02")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call of fn() over `reps` calls, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernel B1 against its plain version
# ---------------------------------------------------------------------------

def _kernels(with_float=True):
    from druid_tpu_torch.data.segment import ValueType
    from druid_tpu_torch.engine import kernels as K
    from druid_tpu_torch.query import aggregators as A
    ks = [K.CountKernel(A.CountAggregator("rows")),
          K.SumKernel(A.LongSumAggregator("lsum", "vlong"), ValueType.LONG),
          K.MinMaxKernel(A.FloatMaxAggregator("fmax", "vfloat"),
                         ValueType.FLOAT, True),
          K.SumKernel(A.FloatSumAggregator("fsum", "vfloat"),
                      ValueType.FLOAT),
          K.MinMaxKernel(A.LongMinAggregator("lmin", "vlong"),
                         ValueType.LONG, False),
          K.MinMaxKernel(A.FloatMinAggregator("fmin", "vfloat"),
                         ValueType.FLOAT, False)]
    ks[1].chunk_rows = 1 << 20        # what staging derives for small values
    return ks if with_float else ks[:2] + [ks[4]]


def make_projection(n, groups, lo, hi, keep, seed, dev):
    """Sorted compact keys (the Projection layout) + value columns, made on
    the card from a seed; returns (arrays, mask, key, span)."""
    import torch
    from druid_tpu_torch.engine.sorted_reduce import SPAN_BLOCK
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    key = torch.randint(0, groups, (n,), generator=g, device=dev,
                        dtype=torch.int64).sort().values.to(torch.int32)
    mask = torch.rand(n, generator=g, device=dev) < keep
    vlong = torch.randint(lo, hi, (n,), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
    vfloat = torch.randn(n, generator=g, device=dev) * 25.0 + 100.0
    pad = (-n) % SPAN_BLOCK
    kp = torch.cat([key, key[-1:].expand(pad)]) if pad else key
    kb = kp.view(-1, SPAN_BLOCK)
    span = int((kb.max(dim=1).values - kb.min(dim=1).values + 1).max())
    return {"vlong": vlong, "vfloat": vfloat}, mask, key, span


def check_b1(name, arrays, mask, key, kernels, num_total, span):
    """Kernel (twice) vs its plain version on the same inputs; returns
    (max_abs_err of the float sums, kernel states). Raises on any
    disagreement."""
    import torch
    from druid_tpu_torch.engine import sorted_reduce as sr
    kc, ks = sr.sorted_reduce_cuda(arrays, mask, key, kernels, num_total,
                                   span)
    kc2, ks2 = sr.sorted_reduce_cuda(arrays, mask, key, kernels, num_total,
                                     span)
    # the plain version runs on CPU copies of the same inputs: its scatter
    # ops are sequential there, so NaN and order questions have one answer
    pc, ps = sr.sorted_reduce_plain({f: v.cpu() for f, v in arrays.items()},
                                    mask.cpu(), key.cpu(), kernels,
                                    num_total, span)
    pc, ps = pc.to(key.device), [b.to(key.device) for b in ps]
    torch.cuda.synchronize()
    if not torch.equal(kc.long(), pc.long()):
        raise AssertionError(f"{name}: counts differ")
    err = 0.0
    for k, a, a2, b in zip(kernels, ks, ks2, ps):
        if a.dtype.is_floating_point:
            same = torch.equal(a.view(torch.int32), a2.view(torch.int32))
        else:
            same = torch.equal(a, a2)
        if not same:
            raise AssertionError(f"{name}/{k.name}: two runs differ in bits")
        if getattr(k, "vtype", None) is not None and a.dtype.is_floating_point \
                and not hasattr(k, "is_max"):
            # float sum: |kernel - plain| <= 1e-5 * sum|v| per group
            v = arrays[k.spec.field]
            keep = mask & (key < num_total)
            absum = torch.zeros(num_total, dtype=torch.float64,
                                device=v.device).index_add_(
                0, key[keep].long(), v[keep].double().abs())
            d = (a.double() - b.double()).abs()
            fin = ~torch.isnan(b)
            if not torch.equal(torch.isnan(a), torch.isnan(b)) \
                    or bool((d[fin] > 1e-5 * absum[fin]).any()):
                raise AssertionError(f"{name}/{k.name}: float sums differ "
                                     f"beyond 1e-5*sum|v|")
            if bool(fin.any()):
                err = max(err, float(d[fin].max()))
        else:
            eq = torch.equal(a, b) if not a.dtype.is_floating_point else (
                torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))
            if not eq:
                raise AssertionError(f"{name}/{k.name}: kernel != plain")
    log(f"  B1 {name}: ok (n={key.shape[0]}, G={num_total}, span={span}, "
        f"window={sr.plan_window(span)}, float-sum max_abs_err={err:.6g})")
    return err, ks


def phase_b1(dev):
    import torch
    from druid_tpu_torch.engine import sorted_reduce as sr
    res = {}
    ks = _kernels()
    # 12.5M rows, ~100k live groups, G = 131072, ~98% kept, five ops
    arrays, mask, key, span = make_projection(12_500_000, 100_000, 0, 10_001,
                                              0.98, 1, dev)
    res["max_abs_err"], _ = check_b1("synthetic-12.5M", arrays, mask, key,
                                     ks, 131072, span)
    del arrays, mask, key
    # int32 sums past 2^31 per group
    a, m, k, s = make_projection(2_000_000, 6, 300_000, 360_000, 0.9, 2, dev)
    _, st = check_b1("sum-past-int32", a, m, k, _kernels(False), 8, s)
    if int(st[1].max()) <= 2**31:
        raise AssertionError("sum-past-int32: sums did not pass 2^31")
    # fully masked blocks + NaN in float max/min
    a, m, k, s = make_projection(1_000_000, 60_000, -50, 50, 0.9, 3, dev)
    m[4096:40960] = False
    a["vfloat"][7] = float("nan")
    m[7] = True
    _, st = check_b1("masked-blocks+nan", a, m, k, ks, 65536, s)
    if not bool(torch.isnan(st[2]).any()):
        raise AssertionError("NaN did not reach float max")
    # every row masked
    m = torch.zeros_like(m)
    _, st = check_b1("all-masked", a, m, k, ks, 65536, s)
    if int(st[0].sum()) != 0:
        raise AssertionError("all-masked: rows counted")
    # G not a multiple of 128, ragged last block
    a, m, k, s = make_projection(777_777, 1000, -9, 9, 0.7, 4, dev)
    check_b1("G=1000", a, m, k, ks, 1000, s)
    # the wide-window path (BLK 1024)
    a, m, k, s = make_projection(200_000, 120_000, -9, 9, 0.9, 5, dev)
    if sr.plan_window(s)[0] != sr.BLK_WIDE_W:
        raise AssertionError(f"wide-window case planned {sr.plan_window(s)}")
    check_b1("blk1024", a, m, k, ks, 1 << 17, s)
    return res


class CaptureB1:
    """Wraps sorted_reduce.sorted_reduce while the main path runs: every
    call's span is kept, and the first call's inputs, so that B1 can be held
    against its plain version and timed at the shapes the main path gives
    it. The wrapped function runs unchanged (and counts its launches)."""

    def __init__(self, sr):
        self.sr, self.orig = sr, sr.sorted_reduce
        self.spans, self.first = [], None

    def __call__(self, arrays, mask, key, kernels, num_total, span):
        self.spans.append(span)
        if self.first is None:
            self.first = (dict(arrays), mask, key, list(kernels), num_total,
                          span)
        return self.orig(arrays, mask, key, kernels, num_total, span)

    def __enter__(self):
        self.sr.sorted_reduce = self
        return self

    def __exit__(self, *exc):
        self.sr.sorted_reduce = self.orig

    def windows(self):
        return sorted({self.sr.plan_window(s) for s in self.spans})


def run_shape(mask, key, blk):
    """Longest run of one live key inside each blk-row block: the rows one
    thread of the partial pass walks for its window slot. Returns (median
    over blocks with a live row, share of those blocks whose longest run is
    at least blk / 2)."""
    import torch
    n = key.shape[0]
    block = torch.arange(n, device=key.device) // blk
    live = mask & (key >= 0)
    comp = (block << 32) + key.long()
    vals, counts = torch.unique_consecutive(comp[live], return_counts=True)
    longest = torch.zeros(-(-n // blk), dtype=torch.int64,
                          device=key.device).scatter_reduce_(
        0, vals >> 32, counts, "amax")
    longest = longest[longest > 0].double()
    return float(longest.median()), float((longest >= blk // 2).double()
                                          .mean())


def time_b1(dev, inputs):
    """B1 on the main path's inputs: kernel, plain, library yardstick,
    bound."""
    import torch
    from druid_tpu_torch.engine import sorted_reduce as sr
    arrays, mask, key, ks, G, span = inputs
    n = key.shape[0]
    saved = sr.LAUNCHES
    ms = cuda_ms(lambda: sr.sorted_reduce_cuda(arrays, mask, key, ks, G,
                                               span), 20)
    sr.LAUNCHES = saved               # timing launches are not the path's
    plain_ms = cuda_ms(lambda: sr.sorted_reduce_plain(arrays, mask, key, ks,
                                                      G, span), 5)
    col_dtypes = {c: str(a.dtype).replace("torch.", "")
                  for c, a in arrays.items()}
    ops = [k.pallas_op(col_dtypes) for k in ks]
    slots = sr._slot_plan(ops)
    fields = sr.op_fields(ops)
    k64 = key.long()

    def library():
        for kind, field in slots:
            dt = sr._slot_dtype(kind)
            out = torch.full((G,), sr._identity(kind), dtype=dt, device=dev)
            if kind == "count":
                out.index_add_(0, k64, mask.to(dt))
            elif kind.startswith("sum"):
                out.index_add_(0, k64, torch.where(mask, arrays[field], 0)
                               .to(dt))
            else:
                out.scatter_reduce_(
                    0, k64, torch.where(mask, arrays[field],
                                        sr._identity(kind)),
                    "amin" if kind.startswith("min") else "amax")
    library_ms = cuda_ms(library, 10)
    # each input read once (key int32, mask bool, each value column 4 B),
    # each output grid written once
    out_bytes = sum(torch.empty((), dtype=sr._slot_dtype(k)).element_size()
                    for k, _ in slots)
    nbytes = n * (4 + 1 + 4 * len(fields)) + G * out_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    run_median, run_long_share = run_shape(mask, key,
                                           sr.plan_window(span)[0])
    # where a launch's device time goes, by kernel name (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    reps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            sr.sorted_reduce_cuda(arrays, mask, key, ks, G, span)
        torch.cuda.synchronize()
    sr.LAUNCHES = saved
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and ev.key and not ev.key.startswith("aten::") \
                and "Memcpy" not in ev.key:
            by_kernel[ev.key[:60]] = us / 1e3 / reps
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "device_ms_by_kernel": by_kernel,
            "bound_ms": bound_ms, "bytes": nbytes, "n": n, "G": G,
            "ops": [k for k, _ in slots], "span": span,
            "longest_run_median": run_median,
            "blocks_with_half_block_run": run_long_share,
            "window": list(sr.plan_window(span))}


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------

def headline_segments():
    from druid_tpu_torch.data.generator import ColumnSpec, DataGenerator
    from druid_tpu_torch.utils.intervals import Interval
    schema = (
        ColumnSpec("dimA", "string", cardinality=100, distribution="uniform"),
        ColumnSpec("dimB", "string", cardinality=1000, distribution="zipf"),
        ColumnSpec("metLong", "long", low=0, high=10_000),
        ColumnSpec("metFloat", "float", distribution="normal", mean=100.0,
                   std=25.0),
    )
    gen = DataGenerator(schema, seed=SEED)
    return gen.segments(SEGMENTS, ROWS // SEGMENTS, Interval.of(*DAY),
                        datasource="bench")


def queries(segments):
    iv = f"{DAY[0]}/{DAY[1]}"
    dim_a = list(segments[0].dims["dimA"].dictionary.values)
    groupby = {
        "queryType": "groupBy", "dataSource": "bench", "intervals": [iv],
        "granularity": "all", "dimensions": ["dimA", "dimB"],
        "aggregations": [
            {"type": "count", "name": "rows"},
            {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
            {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"}],
        "filter": {"type": "bound", "dimension": "metLong", "lower": "100",
                   "upper": "9900", "ordering": "numeric"}}
    topn = {
        "queryType": "topN", "dataSource": "bench", "intervals": [iv],
        "granularity": "all", "dimension": "dimB", "metric": "lsum",
        "threshold": 100,
        "aggregations": [
            {"type": "count", "name": "rows"},
            {"type": "longSum", "name": "lsum", "fieldName": "metLong"}],
        "filter": {"type": "in", "dimension": "dimA",
                   "values": dim_a[0:100:2]}}
    timeseries = {
        "queryType": "timeseries", "dataSource": "bench", "intervals": [iv],
        "granularity": "hour",
        "aggregations": [
            {"type": "count", "name": "rows"},
            {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
            {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"},
            {"type": "doubleSum", "name": "dsum", "fieldName": "metFloat"}]}
    return {"groupby": groupby, "topn": topn, "timeseries": timeseries}


def numpy_reference(segments):
    """Independent numpy results for the three headline queries."""
    t0 = segments[0].interval.start
    G = 100 * 1000
    cnt = np.zeros(G, np.int64)
    lsum = np.zeros(G, np.float64)
    fmax = np.full(G, -np.inf, np.float32)
    tb_cnt = np.zeros(1000, np.int64)
    tb_lsum = np.zeros(1000, np.float64)
    h_cnt = np.zeros(24, np.int64)
    h_lsum = np.zeros(24, np.float64)
    h_fmax = np.full(24, -np.inf, np.float32)
    h_dsum = np.zeros(24, np.float64)
    h_abs = np.zeros(24, np.float64)
    for s in segments:
        a = s.dims["dimA"].ids.astype(np.int64)
        b = s.dims["dimB"].ids.astype(np.int64)
        ml = s.metrics["metLong"].values
        mf = s.metrics["metFloat"].values
        keep = (ml >= 100) & (ml <= 9900)
        key = (a * 1000 + b)[keep]
        cnt += np.bincount(key, minlength=G)
        lsum += np.bincount(key, weights=ml[keep].astype(np.float64),
                            minlength=G)
        np.maximum.at(fmax, key, mf[keep])
        even = (a % 2) == 0
        tb_cnt += np.bincount(b[even], minlength=1000)
        tb_lsum += np.bincount(b[even], weights=ml[even].astype(np.float64),
                               minlength=1000)
        h = (s.time_ms - t0) // 3_600_000
        h_cnt += np.bincount(h, minlength=24)
        h_lsum += np.bincount(h, weights=ml.astype(np.float64), minlength=24)
        np.maximum.at(h_fmax, h, mf)
        h_dsum += np.bincount(h, weights=mf.astype(np.float64), minlength=24)
        h_abs += np.bincount(h, weights=np.abs(mf.astype(np.float64)),
                             minlength=24)
    return dict(cnt=cnt, lsum=lsum.astype(np.int64), fmax=fmax,
                tb_cnt=tb_cnt, tb_lsum=tb_lsum.astype(np.int64),
                h_cnt=h_cnt, h_lsum=h_lsum.astype(np.int64), h_fmax=h_fmax,
                h_dsum=h_dsum, h_abs=h_abs, t0=t0)


def check_groupby(rows, ref):
    live = np.flatnonzero(ref["cnt"])
    if len(rows) != len(live):
        raise AssertionError(f"groupBy: {len(rows)} rows, numpy {len(live)}")
    for r in rows:
        e = r["event"]
        g = int(e["dimA"][1:]) * 1000 + int(e["dimB"][1:])
        if (e["rows"], e["lsum"]) != (int(ref["cnt"][g]), int(ref["lsum"][g])) \
                or np.float32(e["fmax"]) != ref["fmax"][g]:
            raise AssertionError(f"groupBy row {e} != numpy group {g}")


def check_topn(rows, ref):
    live = np.flatnonzero(ref["tb_cnt"])
    order = live[np.argsort(-ref["tb_lsum"][live], kind="stable")][:100]
    got = [(int(x["dimB"][1:]), x["rows"], x["lsum"])
           for x in rows[0]["result"]]
    want = [(int(b), int(ref["tb_cnt"][b]), int(ref["tb_lsum"][b]))
            for b in order]
    if got != want:
        raise AssertionError("topN rows differ from numpy")


def check_timeseries(rows, ref):
    if len(rows) != 24:
        raise AssertionError(f"timeseries: {len(rows)} buckets, expected 24")
    for i, r in enumerate(rows):
        v = r["result"]
        if r["timestamp"] != ref["t0"] + i * 3_600_000 \
                or (v["rows"], v["lsum"]) != (int(ref["h_cnt"][i]),
                                              int(ref["h_lsum"][i])) \
                or np.float32(v["fmax"]) != ref["h_fmax"][i] \
                or abs(v["dsum"] - ref["h_dsum"][i]) > 1e-5 * ref["h_abs"][i]:
            raise AssertionError(f"timeseries bucket {i}: {v}")


def split_times(q, segments, dev):
    """Where a warm query's time goes: producing the per-segment partials
    (host planning + device work + copy back) against merging and finishing
    them on the host, medians of 3."""
    import torch
    from druid_tpu_torch.engine import engines, sorted_reduce as sr
    from druid_tpu_torch.query.model import (GroupByQuery, TimeseriesQuery,
                                             query_from_json)
    query = query_from_json(q)
    finish = engines.finish_groupby if isinstance(query, GroupByQuery) \
        else engines.finish_timeseries if isinstance(query, TimeseriesQuery) \
        else engines.finish_topn
    part, fin = [], []
    saved = sr.LAUNCHES
    for _ in range(3):
        t = time.perf_counter()
        ap = engines.make_aggregate_partials(query, segments, dev)
        torch.cuda.synchronize()
        part.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        finish(query, ap)
        fin.append((time.perf_counter() - t) * 1e3)
    sr.LAUNCHES = saved               # these runs are measurement, not path
    return {"partials_ms": float(np.median(part)),
            "finish_ms": float(np.median(fin))}


def phase_main(dev):
    import torch
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import sorted_reduce as sr
    t = time.perf_counter()
    segments = headline_segments()
    gen_s = time.perf_counter() - t
    log(f"  generated {ROWS} rows in {SEGMENTS} segments: {gen_s:.1f} s")
    t = time.perf_counter()
    ref = numpy_reference(segments)
    log(f"  numpy reference: {time.perf_counter() - t:.1f} s")
    qs = queries(segments)
    ex = QueryExecutor(segments, device=dev)
    checks = {"groupby": check_groupby, "topn": check_topn,
              "timeseries": check_timeseries}
    out = {"gen_s": gen_s}
    launches = 0
    for name, q in qs.items():
        t = time.perf_counter()
        before = sr.LAUNCHES
        with CaptureB1(sr) as cap:
            rows = ex.run_json(q)
            torch.cuda.synchronize()
        cold = time.perf_counter() - t
        delta = sr.LAUNCHES - before
        checks[name](rows, ref)
        want = SEGMENTS if name == "groupby" else 0
        if delta != want or len(cap.spans) != want:
            raise AssertionError(f"{name}: B1 launched {delta} times "
                                 f"({len(cap.spans)} calls), expected {want}")
        if cap.first is not None:
            out["b1_inputs"] = cap.first
            out["b1_windows"] = [list(w) for w in cap.windows()]
            out["b1_spans"] = cap.spans
        launches += delta
        warm = []
        for _ in range(5):
            before = sr.LAUNCHES
            t = time.perf_counter()
            rows = ex.run_json(q)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t) * 1e3)
            if sr.LAUNCHES - before != want:
                raise AssertionError(f"{name}: warm run launched "
                                     f"{sr.LAUNCHES - before} times")
        checks[name](rows, ref)
        split = split_times(q, segments, dev)
        p50 = float(np.median(warm))
        out[name] = {"cold_s": cold, "warm_ms": warm, "p50_ms": p50,
                     "rows_per_s": ROWS / (p50 / 1e3), "result_rows": len(rows),
                     "b1_launches_per_run": delta, **split}
        planned = (f", B1 spans {cap.spans} -> (BLK, W) {cap.windows()}"
                   if cap.spans else "")
        log(f"  {name}: ok, cold {cold:.2f} s, warm p50 {p50:.1f} ms "
            f"({ROWS / (p50 / 1e3):.3e} rows/s), B1 launches/run {delta}"
            f"{planned}; partials {split['partials_ms']:.1f} ms, "
            f"merge+finish {split['finish_ms']:.1f} ms")
    out["b1_launches_first_runs"] = launches
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from druid_tpu_torch import _build
    from druid_tpu_torch.engine import sorted_reduce as sr

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t
    log(f"build: {report['build_s']:.1f} s {built}")
    ptxas = (_build.BUILD_DIR / "sorted_reduce.log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    log("phase B1 parity, synthetic projections")
    b1 = phase_b1(dev)
    report["b1_parity"] = b1

    log("phase main path")
    sr.LAUNCHES = 0
    main_out = phase_main(dev)
    launches = sr.LAUNCHES
    inputs = main_out.pop("b1_inputs")
    report["main"] = main_out

    log("phase B1 on the main path's inputs (first groupBy segment)")
    arrays, mask, key, ks, G, span = inputs
    err, _ = check_b1("main-path", arrays, mask, key, ks, G, span)
    b1["main_path_max_abs_err"] = err
    tb = time_b1(dev, inputs)
    report["b1_times"] = tb
    log(f"  B1 {tb['ms']:.3f} ms/launch (n={tb['n']}, G={G}, span={span}, "
        f"window={tb['window']}, ops={tb['ops']}), bound "
        f"{tb['bound_ms']:.3f} ms ({tb['bytes']} B), plain "
        f"{tb['plain_ms']:.3f} ms, library {tb['library_ms']:.3f} ms; "
        f"longest run of one key per block: median "
        f"{tb['longest_run_median']:.0f} rows, "
        f"{tb['blocks_with_half_block_run']:.4f} of blocks >= half a block")
    for kname, kms in sorted(tb["device_ms_by_kernel"].items(),
                             key=lambda kv: -kv[1]):
        log(f"    device {kms:.4f} ms/launch  {kname}")
    kernels_line = {"kernels": [{
        "name": "sorted_reduce", "route": "cuda",
        "source": "druid_tpu_torch/csrc/sorted_reduce.cu",
        "replaces": "druid_tpu/engine/pallas_agg.py:166",
        "launches": launches, "max_abs_err": max(err, b1["max_abs_err"]),
        "ms": tb["ms"], "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"], "bound_by": "bytes",
        "library_ms": tb["library_ms"]}]}
    report["kernels"] = kernels_line["kernels"]
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    log(json.dumps(kernels_line))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
