#!/usr/bin/env python3
"""Chip smoke for druid_tpu_torch: the native aggregate path on one CUDA card.

    python3 chip_smoke.py                 # every phase (one card)

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from druid_tpu_torch/csrc (nvcc, sm_90a);
  3. kernel B1 (sorted_reduce) against its plain PyTorch version on the card,
     on synthetic projections: a 12.5M-row one with G = 131072 and five ops,
     and edge cases, among them the partial pass's runs (one key over more
     than three blocks with masked rows, a NaN and a sum past 2^31 inside
     it; runs of 1, 31, 32, 33 and a thread's chunk -1/0/+1 rows and one
     over exactly a warp's rows; keys permuted within each span block);
     integers and min/max exact, float sums within 1e-5 * sum|v| per group,
     and bit-identical across two runs;
  4. kernel B2 (megakernel.mega_reduce, the row mask as words) on synthetic
     12.5M-row projections: against its plain version under the same rule,
     against B1 given the same mask as bools (every output bit-identical,
     floats included), and bit-identical across two runs; cases: two fused
     bitmap nodes plus a residual mask with n % 32 != 0, sums past 2^31,
     fully masked blocks with NaN, every row masked, B1's long-run case;
  5. B1 and B2 with packed value fields (data/packed.py words, unpacked in
     the kernel): w16 at the headline's metLong range, w16 with base -1024
     (slot 1's top bit set), w8 base -128, w4 base -8, at BLK 2048 with
     n % BLK != 0 and at BLK 1024; each against its plain version on the
     dense view, and against the same kernel on the dense columns bit for
     bit;
  6. the main path at full size, packing on (the default):
     the headline data (100M rows in 8 segments of 12.5M, seed 1234)
     through QueryExecutor(device="cuda").run_json —
     the headline groupBy (through B1: +8 launches per run, B2 none), topN
     and an hourly timeseries, and a filtered groupBy (a dashboard panel:
     dimA in half its values, not dimB's most frequent value, a bound on
     metLong; through B2: +8 launches per run, B1 none), each checked
     against an independent numpy result; each query's staged block
     (descriptor, resident and decoded bytes) is printed, and only the
     columns B1/B2 read may be packed (topN and timeseries stage dense).
     The first B1 and B2 calls keep their inputs, and must hold metLong as
     w16 words, not decoded. Each query's reduction strategy per segment
     is printed and must be: groupBy projection (B1), filtered groupBy
     megakernel (B2), topN mm (the one-hot matmul), timeseries mixed with
     count, longSum and floatMax blocked and the doubleSum scattered;
  7. the same four queries on 2 of the 8 segments with packing off: the
     rows equal the packed run's;
  8. strategies: on the 8 headline segments, every strategy forced in turn
     (grouping.FORCE_STRATEGY) on the topN (mm, blocked, mixed, projection)
     and the timeseries (mm and blocked are ineligible there and fall
     through to mixed, which is printed), each against numpy and the
     others, with its partials time; the timeseries' pure-scatter form
     (the parent's: mixed with the blocked hybrid off) beside the hybrid,
     and each op's device time on segment 0 in both forms; mm and blocked
     twice on the topN with a floatSum added (the same float bits both
     times); mm on segment 0's topN inputs split into the one-hot build and
     the int8 product, and timed at smaller one-hot budgets;
  9. sorted: the headline schema in the rollup sort order (2 segments of
     12.5M rows, cut from 8 for time): the headline groupBy must select
     windowed (W printed), rows against numpy, cold and warm p50; windowed
     twice with a floatSum (the same float bits); forced projection (B1)
     gives the same rows;
 10. B1 and B2 against their plain versions on the inputs the main path gave
     them (the first segment's), then timed there with CUDA events beside
     their HBM bound, their plain version and a library yardstick
     (index_add_/scatter_reduce over the same keys, B2's with the word
     unpack, never used by the port), the host's enqueue time per launch
     and torch.profiler's device time by kernel, with metLong as words
     (the main path's inputs) and decoded, in turns; and the warm p50 of
     each query.
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
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    key = torch.randint(0, groups, (n,), generator=g, device=dev,
                        dtype=torch.int64).sort().values.to(torch.int32)
    mask = torch.rand(n, generator=g, device=dev) < keep
    vlong = torch.randint(lo, hi, (n,), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
    vfloat = torch.randn(n, generator=g, device=dev) * 25.0 + 100.0
    return {"vlong": vlong, "vfloat": vfloat}, mask, key, projection_span(key)


def projection_span(key):
    """The widest key range of any SPAN_BLOCK rows (Projection.max_span)."""
    import torch
    from druid_tpu_torch.engine.sorted_reduce import SPAN_BLOCK
    pad = (-key.shape[0]) % SPAN_BLOCK
    kp = torch.cat([key, key[-1:].expand(pad)]) if pad else key
    kb = kp.view(-1, SPAN_BLOCK)
    return int((kb.max(dim=1).values - kb.min(dim=1).values + 1).max())


HEAD_RUN = (3000, 3000 + 4 * 2048 + 777)   # head_run_projection's run


def head_run_projection(n, seed, dev):
    """A sorted projection of n / 32 keys (n <= 2^21 keeps them within
    65536) with one key over rows HEAD_RUN: it starts and ends inside a
    2048-row block and fills the three blocks between; about 10% of its rows
    are masked, scattered; a NaN sits in its middle (live); its long sum
    passes 2^31. Returns (arrays, mask, key, span, the run's key)."""
    arrays, mask, key, _ = make_projection(n, n // 32, 300_000, 360_000,
                                           0.9, seed, dev)
    lo, hi = HEAD_RUN
    head = int(key[lo])
    key[lo:hi] = head                 # still sorted: key[lo] <= key[lo:hi]
    mid = (lo + hi) // 2
    arrays["vfloat"][mid] = float("nan")
    mask[mid] = True
    return arrays, mask, key, projection_span(key), head


def check_head_run(name, states, head):
    """The head run's group: its long sum passed 2^31 and the NaN reached
    float max and min (states in _kernels() order)."""
    import torch
    if int(states[1][head]) <= 2**31:
        raise AssertionError(f"{name}: the run's sum did not pass 2^31")
    if not (bool(torch.isnan(states[2][head]))
            and bool(torch.isnan(states[5][head]))):
        raise AssertionError(f"{name}: the NaN did not reach float max/min")


def same_bits(a, b):
    """Equal dtype and bits (floats compared as their int32 words)."""
    import torch
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def compare_states(name, arrays, mask, key, kernels, num_total, kernel_out,
                   again_out, plain_out):
    """A kernel's (counts, states) against a second run (same bits) and its
    plain version (integers and min/max exact, NaN included; float sums
    within 1e-5 * sum|v| per group). Returns the float sums' max abs error;
    raises on any disagreement."""
    import torch
    (kc, ks), (kc2, ks2), (pc, ps) = kernel_out, again_out, plain_out
    torch.cuda.synchronize()
    if not torch.equal(kc.long(), pc.long()):
        raise AssertionError(f"{name}: counts differ")
    if not same_bits(kc, kc2):
        raise AssertionError(f"{name}: two runs differ in counts")
    err = 0.0
    for k, a, a2, b in zip(kernels, ks, ks2, ps):
        if not same_bits(a, a2):
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
    return err


def value_fields(arrays, kernels):
    """The value columns the kernels read, sorted."""
    from druid_tpu_torch.data.cascade import column_dtypes
    from druid_tpu_torch.engine import sorted_reduce as sr
    return sr.value_fields(kernels, column_dtypes(arrays))


def dense_view(arrays, kernels):
    """{field: dense tensor} of the kernels' value columns (a packed field
    decoded)."""
    return {f: arrays[f] for f in value_fields(arrays, kernels)}


def check_words_read(arrays, key, kernels, span, packed_cols):
    """The packed fields the kernel will read as words; raises if none."""
    from druid_tpu_torch.engine import sorted_reduce as sr
    got = sr.packed_fields(value_fields(arrays, kernels), packed_cols,
                           sr.plan_window(span)[0], key.shape[0])
    if not got:
        raise AssertionError("no packed field reaches the kernel as words")
    return got


def check_b1(name, arrays, mask, key, kernels, num_total, span,
             packed_cols=None):
    """Kernel (twice) vs its plain version on the same inputs, and with
    `packed_cols` also vs the same kernel on the dense columns (every output
    bit-identical); returns (max_abs_err of the float sums, kernel states).
    Raises on any disagreement."""
    from druid_tpu_torch.engine import sorted_reduce as sr
    saved = sr.LAUNCHES
    out = sr.sorted_reduce_cuda(arrays, mask, key, kernels, num_total, span,
                                packed_cols=packed_cols)
    again = sr.sorted_reduce_cuda(arrays, mask, key, kernels, num_total,
                                  span, packed_cols=packed_cols)
    dense = dense_view(arrays, kernels)
    words = ""
    if packed_cols:
        pf = check_words_read(arrays, key, kernels, span, packed_cols)
        words = ", words " + ", ".join(f"{f} w{pc.width} base {pc.base}"
                                       for f, pc in pf.items())
        d_out = sr.sorted_reduce_cuda(dense, mask, key, kernels, num_total,
                                      span)
        same_outputs(f"B1 {name}", kernels, out, d_out, "dense launch")
    sr.LAUNCHES = saved               # parity launches are not the path's
    # the plain version runs on CPU copies of the same inputs: its scatter
    # ops are sequential there, so NaN and order questions have one answer
    pc, ps = sr.sorted_reduce_plain({f: v.cpu() for f, v in dense.items()},
                                    mask.cpu(), key.cpu(), kernels,
                                    num_total, span)
    plain = (pc.to(key.device), [b.to(key.device) for b in ps])
    err = compare_states(f"B1 {name}", dense, mask, key, kernels, num_total,
                         out, again, plain)
    log(f"  B1 {name}: ok{' (= dense launch bit for bit)' if words else ''} "
        f"(n={key.shape[0]}, G={num_total}, span={span}, "
        f"window={sr.plan_window(span)}{words}, float-sum "
        f"max_abs_err={err:.6g})")
    return err, out[1]


def same_outputs(name, kernels, a, b, what):
    """(counts, states) pairs equal bit for bit; raises otherwise."""
    for k, x, y in zip(["counts"] + [k.name for k in kernels],
                       [a[0]] + list(a[1]), [b[0]] + list(b[1])):
        if not same_bits(x, y):
            raise AssertionError(f"{name}/{k}: differs from the {what} in "
                                 f"bits")


def check_b2(name, arrays, words, key, kernels, num_total, span,
             packed_cols=None):
    """Kernel B2 (twice) vs its plain version, vs kernel B1 given the same
    mask as bools, and with `packed_cols` vs B2 on the dense columns (every
    output bit-identical); returns (max_abs_err of the float sums, B2's
    states). Raises on any disagreement."""
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.engine.filters import expand_mask_words
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    out = mk.mega_reduce_cuda(arrays, words, key, kernels, num_total, span,
                              packed_cols=packed_cols)
    again = mk.mega_reduce_cuda(arrays, words, key, kernels, num_total, span,
                                packed_cols=packed_cols)
    mask = expand_mask_words(words, key.shape[0])
    b1 = sr.sorted_reduce_cuda(arrays, mask, key, kernels, num_total, span,
                               packed_cols=packed_cols)
    dense = dense_view(arrays, kernels)
    tag = ""
    if packed_cols:
        pf = check_words_read(arrays, key, kernels, span, packed_cols)
        tag = ", words " + ", ".join(f"{f} w{pc.width} base {pc.base}"
                                     for f, pc in pf.items())
        d_out = mk.mega_reduce_cuda(dense, words, key, kernels, num_total,
                                    span)
        same_outputs(f"B2 {name}", kernels, out, d_out, "dense launch")
    sr.LAUNCHES, mk.LAUNCHES = saved  # parity launches are not the path's
    pc, ps = mk.mega_reduce_plain({f: v.cpu() for f, v in dense.items()},
                                  words.cpu(), key.cpu(), kernels, num_total,
                                  span)
    plain = (pc.to(key.device), [b.to(key.device) for b in ps])
    err = compare_states(f"B2 {name}", dense, mask, key, kernels, num_total,
                         out, again, plain)
    same_outputs(f"B2 {name}", kernels, out, b1, "B1 launch")
    log(f"  B2 {name}: ok, = B1 bit for bit"
        f"{' and = dense launch' if tag else ''} (n={key.shape[0]}, "
        f"G={num_total}, span={span}, window={sr.plan_window(span)}{tag}, "
        f"live rows={int(mask.sum())}, float-sum max_abs_err={err:.6g})")
    return err, out[1]


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
    # the partial pass's runs: one key over more than three blocks, masked
    # rows and a NaN inside it, its sum past 2^31
    a, m, k, s, head = head_run_projection(2_000_000, 6, dev)
    _, st = check_b1("head-runs", a, m, k, ks, 65536, s)
    check_head_run("B1 head-runs", st, head)
    # runs of 1, 31, 32, 33, c - 1, c, c + 1 rows (c: rows per thread) and
    # one over exactly one warp's rows
    k = boundary_run_keys(1_000_000, dev)
    a, m, _, _ = make_projection(k.shape[0], 1, -50, 50, 1.0, 7, dev)
    check_b1("boundary-runs", a, m, k, ks, int(k.max()) + 1,
             projection_span(k))
    # sorted keys with every SPAN_BLOCK rows permuted in place: the plan of
    # the sorted case, many runs per slot
    a, m, k, s = make_projection(2_048_000, 100_000, -9, 9, 0.9, 8, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    kb = k.view(-1, sr.SPAN_BLOCK)
    perm = torch.rand(kb.shape, generator=g, device=dev).argsort(dim=1)
    k = kb.gather(1, perm).reshape(-1).contiguous()
    if projection_span(k) != s:
        raise AssertionError("unsorted-in-block: the span changed")
    check_b1("unsorted-in-block", a, m, k, ks, 131072, s)
    return res


def boundary_run_keys(n, dev):
    """Sorted keys whose runs cycle through 1, 31, 32, 33, c - 1, c, c + 1
    rows (c = BLK_SMALL_W / PARTIAL_THREADS, one thread's chunk), with one
    run over exactly the rows of warp 1 of the second 2048-row block."""
    import torch
    from druid_tpu_torch.engine import sorted_reduce as sr
    c = sr.BLK_SMALL_W // sr.PARTIAL_THREADS
    cycle = [1, 31, 32, 33, c - 1, c, c + 1]
    start = sr.BLK_SMALL_W + 32 * c
    before = []
    while sum(before) < start:
        before.append(cycle[len(before) % len(cycle)])
    before[-1] -= sum(before) - start      # the last run ends at `start`
    after = [cycle[i % len(cycle)] for i in range(n // 8)]
    lengths = [x for x in before if x > 0] + [32 * c] + after
    key = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths))[:n]
    return key.to(torch.int32).to(dev)


def phase_b2(dev, rows=12_500_000):
    """Kernel B2 on synthetic projections of `rows` rows (see check_b2)."""
    import torch
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine.filters import (expand_mask_words,
                                                pack_mask_words)
    res = {}
    ks = _kernels()
    n = rows + 1                        # n % 32 != 0: a partial last word
    arrays, mask, key, span = make_projection(n, 100_000, 0, 10_001, 0.98,
                                              11, dev)
    # two fused bitmap nodes over three random leaves, ANDed with the base
    # (residual) mask through the entry point's own word algebra
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    leaves = [torch.rand(n, generator=g, device=dev) < 0.8 for _ in range(3)]
    nodes = [mk.MegaBitmapNode(("and", (("leaf", 0), ("not", ("leaf", 1)))),
                               [("l0", None), ("l1", None)], 0),
             mk.MegaBitmapNode(("or", (("and", (("leaf", 0), ("leaf", 1))),
                                       ("not", ("leaf", 2)))),
                               [("l0", None), ("l2", None), ("l1", None)], 1)]
    cols = dict(arrays)
    for node, idx in zip(nodes, ([0, 1], [0, 2, 1])):
        for j, li in enumerate(idx):
            cols[node.leaf_col(j)] = pack_mask_words(leaves[li])
    words = mk.fused_mask_words(cols, mask, nodes)
    want = mask & leaves[0] & ~leaves[1] \
        & ((leaves[0] & leaves[2]) | ~leaves[1])
    if not torch.equal(expand_mask_words(words, n), want):
        raise AssertionError("fused mask words != the bool algebra")
    res["max_abs_err"], _ = check_b2("two-nodes+residual", arrays, words,
                                     key, ks, 131072, span)
    del arrays, mask, key, leaves, cols, words
    # int32 sums past 2^31 per group
    a, m, k, s = make_projection(rows, 6, 300_000, 360_000, 0.9, 13, dev)
    _, st = check_b2("sum-past-int32", a, pack_mask_words(m), k,
                     _kernels(False), 8, s)
    if int(st[1].max()) <= 2**31:
        raise AssertionError("B2 sum-past-int32: sums did not pass 2^31")
    # fully masked blocks + NaN in float max/min
    a, m, k, s = make_projection(rows, 100_000, -50, 50, 0.9, 14, dev)
    m[4096:rows // 12] = False
    a["vfloat"][7] = float("nan")
    m[7] = True
    _, st = check_b2("masked-blocks+nan", a, pack_mask_words(m), k, ks,
                     131072, s)
    if not bool(torch.isnan(st[2]).any()):
        raise AssertionError("B2: NaN did not reach float max")
    # every row masked
    _, st = check_b2("all-masked", a, torch.zeros(-(-k.shape[0] // 32),
                                                  dtype=torch.int32,
                                                  device=dev),
                     k, ks, 131072, s)
    if int(st[0].sum()) != 0:
        raise AssertionError("B2 all-masked: rows counted")
    # B1's head-run case with the mask as words, n % 32 != 0
    a, m, k, s, head = head_run_projection(2_000_001, 15, dev)
    _, st = check_b2("head-runs", a, pack_mask_words(m), k, ks, 65536, s)
    check_head_run("B2 head-runs", st, head)
    return res


#: packed-field cases: (name, n, groups, lo, hi, width, base, G); n is a
#: multiple of 1024 (the padded row count of a staged column) and, at BLK
#: 2048, not of BLK: the ragged last block
PACKED_CASES = [
    ("w16 metLong-range", 12_493_824, 100_000, 0, 10_001, 16, 0, 131072),
    ("w16 base -1024, slot-1 top bit", 1_999_872, 60_000, -1024, 64_512, 16,
     -1024, 65536),
    ("w8 base -128", 1_999_872, 60_000, -128, 128, 8, -128, 65536),
    ("w4 base -8", 1_999_872, 60_000, -8, 8, 4, -8, 65536),
    ("w4 base -8, blk1024", 200_704, 120_000, -8, 8, 4, -8, 1 << 17),
]


def pack_on_card(v, width, base):
    """A PackedColumn of int32 tensor v (data/packed.py's layout), its
    words on v's device."""
    import torch
    from druid_tpu_torch.data import packed
    words = packed.pack_padded(v.cpu().numpy(), width, base)
    return packed.PackedColumn(torch.from_numpy(words).to(v.device), width,
                               base, v.shape[0])


def phase_packed(dev):
    """B1 and B2 with vlong as packed words (PACKED_CASES)."""
    import torch
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.engine.filters import pack_mask_words
    res = {"max_abs_err": 0.0}
    ks = _kernels()
    for i, (name, n, groups, lo, hi, width, base, G) in \
            enumerate(PACKED_CASES):
        a, m, k, s = make_projection(n, groups, lo, hi, 0.9, 40 + i, dev)
        want_blk = sr.BLK_WIDE_W if "blk1024" in name else sr.BLK_SMALL_W
        if sr.plan_window(s)[0] != want_blk or (
                want_blk == sr.BLK_SMALL_W and n % want_blk == 0):
            raise AssertionError(f"{name}: planned {sr.plan_window(s)}")
        pc = pack_on_card(a["vlong"], width, base)
        if width == 16 and base < 0 and not bool((pc.words < 0).any()):
            raise AssertionError(f"{name}: no word has its top bit set")
        from druid_tpu_torch.data.cascade import split_resident
        packed_cols, view = split_resident({"vlong": pc,
                                            "vfloat": a["vfloat"]})
        e1, _ = check_b1(f"packed {name}", view, m, k, ks, G, s,
                         packed_cols)
        g = torch.Generator(device=dev)
        g.manual_seed(60 + i)
        words = pack_mask_words(m & (torch.rand(n, generator=g, device=dev)
                                     < 0.5))
        e2, _ = check_b2(f"packed {name}", view, words, k, ks, G, s,
                         packed_cols)
        res["max_abs_err"] = max(res["max_abs_err"], e1, e2)
        del a, m, k, pc, packed_cols, view, words
    return res


class Capture:
    """Wraps a kernel's entry (`module.attr`) while the main path runs:
    every call's span is kept, and the first call's inputs (with the packed
    columns and the columns its dense view had decoded by then), so that
    the kernel can be held against its plain version and timed at the
    shapes the main path gives it. The wrapped function runs unchanged (and
    counts its launches)."""

    def __init__(self, module, attr):
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.spans, self.first, self.decoded = [], None, None

    def __call__(self, arrays, mask, key, kernels, num_total, span,
                 packed_cols=None):
        self.spans.append(span)
        if self.first is None:
            self.first = (arrays, mask, key, list(kernels), num_total, span,
                          dict(packed_cols or {}))
            self.decoded = tuple(getattr(arrays, "decoded", tuple)())
        return self.orig(arrays, mask, key, kernels, num_total, span,
                         packed_cols=packed_cols)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)

    def windows(self):
        from druid_tpu_torch.engine.sorted_reduce import plan_window
        return sorted({plan_window(s) for s in self.spans})


class BlockLog:
    """Records every block `Segment.device_block` returns while it is
    active (the staged encodings of each query)."""

    def __enter__(self):
        from druid_tpu_torch.data.segment import Segment
        self.cls, self.orig, self.blocks = Segment, Segment.device_block, []
        orig, blocks = self.orig, self.blocks

        def device_block(seg, *a, **k):
            b = orig(seg, *a, **k)
            blocks.append(b)
            return b
        Segment.device_block = device_block
        return self

    def __exit__(self, *exc):
        self.cls.device_block = self.orig

    def summary(self):
        """{encodings of the first block, resident and decoded MB per
        segment (min, max)}."""
        if not self.blocks:
            return {}
        res = [b.resident_nbytes / 1e6 for b in self.blocks]
        dec = [b.logical_nbytes / 1e6 for b in self.blocks]
        return {"encodings": self.blocks[0].encodings(),
                "packs": sorted({tuple(e) for b in self.blocks
                                 for e in b.packs}),
                "resident_mb": [min(res), max(res)],
                "decoded_mb": [min(dec), max(dec)],
                "bytes_per_row": self.blocks[0].resident_nbytes
                / self.blocks[0].padded_rows}


class StrategyLog:
    """Records, while active, the strategy and window of every segment's
    reduction (`grouping.fuse_filter_update`), the kernels each blocked
    reduction took (`grouping._blocked_reduce`), and the first fuse and mm
    calls' inputs (segment 0's, for the per-op timings). Every wrapped
    function runs unchanged."""

    NAMES = ("fuse_filter_update", "_blocked_reduce", "mm_reduce")

    def __enter__(self):
        from druid_tpu_torch.engine import grouping as gr
        self.gr, self.orig = gr, {n: getattr(gr, n) for n in self.NAMES}
        self.strategies, self.blocked = [], []
        self.first_fuse = self.first_mm = None
        orig = self.orig

        def fuse(arrays, mask, key, dims, filter_node, kernels, num_total,
                 strategy="mixed", span=0, packed_cols=None):
            self.strategies.append((strategy, span))
            if self.first_fuse is None:
                self.first_fuse = (arrays, mask, key, dims, filter_node,
                                   list(kernels), num_total)
            return orig["fuse_filter_update"](
                arrays, mask, key, dims, filter_node, kernels, num_total,
                strategy=strategy, span=span, packed_cols=packed_cols)

        def blocked(arrays, mask, key, kernels, num_total):
            self.blocked.append(tuple(k.name for k in kernels))
            return orig["_blocked_reduce"](arrays, mask, key, kernels,
                                           num_total)

        def mm(arrays, mask, key, kernels, plans, num_total):
            if self.first_mm is None:
                self.first_mm = (arrays, mask, key, list(kernels),
                                 list(plans), num_total)
            return orig["mm_reduce"](arrays, mask, key, kernels, plans,
                                     num_total)
        for n, f in zip(self.NAMES, (fuse, blocked, mm)):
            setattr(gr, n, f)
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.gr, n, f)

    def names(self):
        return [s for s, _ in self.strategies]


def run_shape(mask, key, blk):
    """Longest run of one live key inside each blk-row block: the rows the
    partial pass joins across threads and warps. Returns (median
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


def launcher(which, inputs, packed=True):
    """(a function launching B1 or B2 once on the main path's inputs, the
    fields it reads as words, the dense value columns). `packed` passes the
    packed columns as the main path does; otherwise every value column goes
    in decoded."""
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    view, m_in, key, ks, G, span, packed_cols = inputs
    arrays = dense_view(view, ks)
    words_in = sr.packed_fields(sorted(arrays), packed_cols,
                                sr.plan_window(span)[0], key.shape[0]) \
        if packed else {}
    k_arrays = view if packed else arrays
    fn = sr.sorted_reduce_cuda if which == "B1" else mk.mega_reduce_cuda

    def kernel():
        return fn(k_arrays, m_in, key, ks, G, span, packed_cols=words_in)
    return kernel, words_in, arrays


def time_kernel(which, dev, inputs, packed=True):
    """Kernel B1 or B2 on the main path's inputs (the row mask as bools for
    B1, as words for B2), with the packed columns as words (`packed`, as
    the main path calls it) or decoded: ms per launch, its plain version's
    ms, a library yardstick (index_add_/scatter_reduce over the same keys,
    B2's with the word unpack), the bound from the bytes, and
    torch.profiler's split by kernel name."""
    import torch
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.engine.filters import (expand_mask_words,
                                                pack_mask_words)
    _, m_in, key, ks, G, span, _ = inputs
    n = key.shape[0]
    kernel, words_in, arrays = launcher(which, inputs, packed)
    if which == "B1":
        def plain():
            return sr.sorted_reduce_plain(arrays, m_in, key, ks, G, span)

        def row_mask():
            return m_in
        mask_bytes = n                          # bool rows
    else:
        def plain():
            return mk.mega_reduce_plain(arrays, m_in, key, ks, G, span)

        def row_mask():
            return expand_mask_words(m_in, n)
        mask_bytes = 4 * -(-n // 32)            # int32 words
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    # host time to enqueue one launch (wrapper, torch ops, ctypes), with the
    # card still busy from the calls before: near `ms`, the host limits it
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        kernel()
    enqueue_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    from druid_tpu_torch.data.cascade import column_dtypes
    ops = [k.pallas_op(column_dtypes(arrays)) for k in ks]
    slots = sr._slot_plan(ops)
    fields = sr.op_fields(ops)
    k64 = key.long()

    def library():
        mask = row_mask()
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
    # the bytes this run's data needs, each read or written once: the whole
    # mask; the key (4 B a row) and each value column (4 B a row dense,
    # width / 8 B packed) only in the 32-row groups that hold a live row (a
    # group is one line of each; a group with no live row needs none of
    # them); each output grid
    out_bytes = sum(torch.empty((), dtype=sr._slot_dtype(k)).element_size()
                    for k, _ in slots)
    mask = row_mask()
    words = pack_mask_words(mask)
    live_words = int(torch.count_nonzero(words))
    row_bytes = 4 + sum(words_in[f].width / 8 if f in words_in else 4
                        for f in fields)
    nbytes = mask_bytes + live_words * 32 * row_bytes + G * out_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    run_median, run_long_share = run_shape(mask, key,
                                           sr.plan_window(span)[0])
    # where a launch's device time goes, by kernel name (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    reps = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel()
        torch.cuda.synchronize()
    sr.LAUNCHES, mk.LAUNCHES = saved  # timing launches are not the path's
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and ev.key and not ev.key.startswith("aten::") \
                and "Memcpy" not in ev.key:
            by_kernel[ev.key] = us / 1e3 / reps
    device_ms = sum(v for k, v in by_kernel.items()
                    if not k.startswith(("cuda", "Activity")))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "enqueue_ms": enqueue_ms, "device_ms": device_ms,
            "device_ms_by_kernel": by_kernel,
            "bound_ms": bound_ms, "bytes": nbytes, "n": n, "G": G,
            "live_rows": int(mask.sum()),
            "live_word_share": live_words / words.shape[0],
            "ops": [k for k, _ in slots], "span": span,
            "packed_fields": {f: pc.width for f, pc in words_in.items()},
            "longest_run_median": run_median,
            "blocks_with_half_block_run": run_long_share,
            "window": list(sr.plan_window(span))}


def ab_ms(fn_a, fn_b, reps=20):
    """ms per call of two functions timed in turns (a, b, b, a); returns
    ([a1, a2], [b1, b2])."""
    a1, b1, b2, a2 = (cuda_ms(f, reps) for f in (fn_a, fn_b, fn_b, fn_a))
    return [a1, a2], [b1, b2]


# ---------------------------------------------------------------------------
# phase 6: the main path at full size
# ---------------------------------------------------------------------------

def headline_segments(n_seg=SEGMENTS, sort_by_dims=False):
    """The headline data: n_seg segments of ROWS // SEGMENTS rows each (in
    the rollup sort order with `sort_by_dims`)."""
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
    return gen.segments(n_seg, ROWS // SEGMENTS, Interval.of(*DAY),
                        datasource="bench", sort_by_dims=sort_by_dims)


def dimb_head(segments):
    """dimB's most frequent id (the zipf head), counted in segment 0."""
    return int(np.bincount(segments[0].dims["dimB"].ids).argmax())


def queries(segments):
    iv = f"{DAY[0]}/{DAY[1]}"
    dim_a = list(segments[0].dims["dimA"].dictionary.values)
    head = segments[0].dims["dimB"].dictionary.values[dimb_head(segments)]
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
    # a dashboard panel: slice by dimA, drop dimB's dominant value
    filtered = dict(groupby, filter={"type": "and", "fields": [
        {"type": "in", "dimension": "dimA", "values": dim_a[0:100:2]},
        {"type": "not", "field": {"type": "selector", "dimension": "dimB",
                                  "value": head}},
        groupby["filter"]]})
    return {"groupby": groupby, "topn": topn, "timeseries": timeseries,
            "groupby_filtered": filtered}


def numpy_reference(segments):
    """Independent numpy results for the four main-path queries."""
    t0 = segments[0].interval.start
    head = dimb_head(segments)
    G = 100 * 1000
    cnt = np.zeros(G, np.int64)
    lsum = np.zeros(G, np.float64)
    fmax = np.full(G, -np.inf, np.float32)
    f_cnt = np.zeros(G, np.int64)
    f_lsum = np.zeros(G, np.float64)
    f_fmax = np.full(G, -np.inf, np.float32)
    g_fsum = np.zeros(G, np.float64)
    g_abs = np.zeros(G, np.float64)
    tb_cnt = np.zeros(1000, np.int64)
    tb_lsum = np.zeros(1000, np.float64)
    tb_fsum = np.zeros(1000, np.float64)
    tb_abs = np.zeros(1000, np.float64)
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
        g_fsum += np.bincount(key, weights=mf[keep].astype(np.float64),
                              minlength=G)
        g_abs += np.bincount(key, weights=np.abs(mf[keep].astype(
            np.float64)), minlength=G)
        even = (a % 2) == 0
        fk = keep & even & (b != head)
        key = a[fk] * 1000 + b[fk]
        f_cnt += np.bincount(key, minlength=G)
        f_lsum += np.bincount(key, weights=ml[fk].astype(np.float64),
                              minlength=G)
        np.maximum.at(f_fmax, key, mf[fk])
        tb_cnt += np.bincount(b[even], minlength=1000)
        tb_lsum += np.bincount(b[even], weights=ml[even].astype(np.float64),
                               minlength=1000)
        tb_fsum += np.bincount(b[even], weights=mf[even].astype(np.float64),
                               minlength=1000)
        tb_abs += np.bincount(b[even], weights=np.abs(
            mf[even].astype(np.float64)), minlength=1000)
        h = (s.time_ms - t0) // 3_600_000
        h_cnt += np.bincount(h, minlength=24)
        h_lsum += np.bincount(h, weights=ml.astype(np.float64), minlength=24)
        np.maximum.at(h_fmax, h, mf)
        h_dsum += np.bincount(h, weights=mf.astype(np.float64), minlength=24)
        h_abs += np.bincount(h, weights=np.abs(mf.astype(np.float64)),
                             minlength=24)
    return dict(cnt=cnt, lsum=lsum.astype(np.int64), fmax=fmax,
                f_cnt=f_cnt, f_lsum=f_lsum.astype(np.int64), f_fmax=f_fmax,
                g_fsum=g_fsum, g_abs=g_abs, tb_fsum=tb_fsum, tb_abs=tb_abs,
                tb_cnt=tb_cnt, tb_lsum=tb_lsum.astype(np.int64),
                h_cnt=h_cnt, h_lsum=h_lsum.astype(np.int64), h_fmax=h_fmax,
                h_dsum=h_dsum, h_abs=h_abs, t0=t0)


def check_groupby(rows, ref, pre=""):
    cnt, lsum, fmax = ref[pre + "cnt"], ref[pre + "lsum"], ref[pre + "fmax"]
    live = np.flatnonzero(cnt)
    if len(rows) != len(live):
        raise AssertionError(f"groupBy: {len(rows)} rows, numpy {len(live)}")
    for r in rows:
        e = r["event"]
        g = int(e["dimA"][1:]) * 1000 + int(e["dimB"][1:])
        if (e["rows"], e["lsum"]) != (int(cnt[g]), int(lsum[g])) \
                or np.float32(e["fmax"]) != fmax[g] \
                or ("fsum" in e and abs(e["fsum"] - ref["g_fsum"][g])
                    > 1e-5 * ref["g_abs"][g]):
            raise AssertionError(f"groupBy row {e} != numpy group {g}")


def check_filtered(rows, ref):
    check_groupby(rows, ref, "f_")


def check_topn(rows, ref):
    live = np.flatnonzero(ref["tb_cnt"])
    order = live[np.argsort(-ref["tb_lsum"][live], kind="stable")][:100]
    got = [(int(x["dimB"][1:]), x["rows"], x["lsum"])
           for x in rows[0]["result"]]
    want = [(int(b), int(ref["tb_cnt"][b]), int(ref["tb_lsum"][b]))
            for b in order]
    if got != want:
        raise AssertionError("topN rows differ from numpy")
    for x in rows[0]["result"]:
        b = int(x["dimB"][1:])
        if "fsum" in x and abs(x["fsum"] - ref["tb_fsum"][b]) \
                > 1e-5 * ref["tb_abs"][b]:
            raise AssertionError(f"topN fsum of {b}: {x['fsum']}")


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
    from druid_tpu_torch.engine import megakernel as mk
    part, fin = [], []
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    for _ in range(3):
        t = time.perf_counter()
        ap = engines.make_aggregate_partials(query, segments, dev)
        torch.cuda.synchronize()
        part.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        finish(query, ap)
        fin.append((time.perf_counter() - t) * 1e3)
    sr.LAUNCHES, mk.LAUNCHES = saved  # these runs are measurement, not path
    return {"partials_ms": float(np.median(part)),
            "finish_ms": float(np.median(fin))}


def phase_main(dev):
    import torch
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    t = time.perf_counter()
    segments = headline_segments()
    gen_s = time.perf_counter() - t
    log(f"  generated {ROWS} rows in {SEGMENTS} segments: {gen_s:.1f} s")
    t = time.perf_counter()
    ref = numpy_reference(segments)
    log(f"  numpy reference: {time.perf_counter() - t:.1f} s")
    from druid_tpu_torch.data import packed
    if not packed.enabled():
        raise AssertionError("packing must be on (the default)")
    qs = queries(segments)
    ex = QueryExecutor(segments, device=dev)
    checks = {"groupby": check_groupby, "topn": check_topn,
              "timeseries": check_timeseries,
              "groupby_filtered": check_filtered}
    # (B1, B2) launches per run of each query
    wants = {"groupby": (SEGMENTS, 0), "groupby_filtered": (0, SEGMENTS)}
    out = {"gen_s": gen_s, "segments": segments, "queries": qs, "ref": ref}

    def launches():
        return (sr.LAUNCHES, mk.LAUNCHES)
    for name, q in qs.items():
        want = wants.get(name, (0, 0))
        t = time.perf_counter()
        before = launches()
        with Capture(sr, "sorted_reduce") as cap1, \
                Capture(mk, "mega_reduce_cuda") as cap2, BlockLog() as blog, \
                StrategyLog() as slog:
            rows = ex.run_json(q)
            torch.cuda.synchronize()
        cold = time.perf_counter() - t
        check_strategies(name, slog)
        if name == "topn":
            out["mm_inputs"] = slog.first_mm
        if name == "timeseries":
            out["ts_inputs"] = slog.first_fuse
        blocks = blog.summary()
        log(f"  {name}: staged block {blocks['encodings']}; resident "
            f"{blocks['resident_mb'][0]:.3f}-{blocks['resident_mb'][1]:.3f} "
            f"MB/segment ({blocks['bytes_per_row']:.3f} B/row), decoded "
            f"{blocks['decoded_mb'][0]:.3f} MB")
        delta = tuple(a - b for a, b in zip(launches(), before))
        checks[name](rows, ref)
        # only what B1/B2 read is packed: metLong where they run
        if blocks["packs"] != ([("metLong", 16, 0)] if any(want) else []):
            raise AssertionError(f"{name}: staged packs {blocks['packs']}")
        if delta != want or (len(cap1.spans), len(cap2.spans)) != want:
            raise AssertionError(
                f"{name}: (B1, B2) launched {delta} times ({len(cap1.spans)},"
                f" {len(cap2.spans)} calls), expected {want}")
        for tag, cap in (("b1", cap1), ("b2", cap2)):
            if cap.first is not None:
                view, key, ks, span, pcs = (cap.first[0], cap.first[2],
                                            cap.first[3], cap.first[5],
                                            cap.first[6])
                read = sr.packed_fields(value_fields(view, ks), pcs,
                                        sr.plan_window(span)[0],
                                        key.shape[0])
                if getattr(read.get("metLong"), "width", 0) != 16:
                    raise AssertionError(f"{name}: {tag} does not read "
                                         f"metLong as w16 words: {read}")
                log(f"  {name}: {tag.upper()} reads "
                    f"{ {f: repr(pc) for f, pc in read.items()} } as words; "
                    f"its dense view had decoded {list(cap.decoded)} for "
                    f"the query's other consumers")
                out[f"{tag}_inputs"] = cap.first
                out[f"{tag}_windows"] = [list(w) for w in cap.windows()]
                out[f"{tag}_spans"] = cap.spans
        warm = []
        for _ in range(5):
            before = launches()
            t = time.perf_counter()
            rows = ex.run_json(q)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t) * 1e3)
            got = tuple(a - b for a, b in zip(launches(), before))
            if got != want:
                raise AssertionError(f"{name}: warm run launched (B1, B2) "
                                     f"{got} times, expected {want}")
        checks[name](rows, ref)
        split = split_times(q, segments, dev)
        p50 = float(np.median(warm))
        out[name] = {"cold_s": cold, "warm_ms": warm, "p50_ms": p50,
                     "strategies": slog.strategies,
                     "blocked_kernels": slog.blocked,
                     "rows_per_s": ROWS / (p50 / 1e3), "result_rows": len(rows),
                     "b1_launches_per_run": delta[0],
                     "b2_launches_per_run": delta[1], "block": blocks,
                     **split}
        planned = "".join(
            f", {tag} spans {cap.spans} -> (BLK, W) {cap.windows()}"
            for tag, cap in (("B1", cap1), ("B2", cap2)) if cap.spans)
        log(f"  {name}: ok, cold {cold:.2f} s, warm p50 {p50:.1f} ms "
            f"({ROWS / (p50 / 1e3):.3e} rows/s), (B1, B2) launches/run "
            f"{delta}{planned}; partials {split['partials_ms']:.1f} ms, "
            f"merge+finish {split['finish_ms']:.1f} ms")
    return out


#: the strategy each main-path query must run on every segment, and the
#: aggregators its blocked reductions must take (the timeseries' mixed
#: hybrid: all but the doubleSum, which scatters)
MAIN_STRATEGIES = {"groupby": ("projection", ()),
                   "groupby_filtered": ("megakernel", ()),
                   "topn": ("mm", ()),
                   "timeseries": ("mixed", ("rows", "lsum", "fmax"))}


def check_strategies(name, slog, segments=SEGMENTS):
    """The query ran MAIN_STRATEGIES[name] on each of `segments` segments;
    prints the strategy (and window) per segment."""
    want, blocked = MAIN_STRATEGIES[name]
    log(f"  {name}: strategy per segment {slog.strategies}; blocked "
        f"reductions took {sorted(set(slog.blocked))}")
    if slog.names() != [want] * segments:
        raise AssertionError(f"{name}: strategies {slog.strategies}, "
                             f"expected {want} on {segments} segments")
    if slog.blocked != ([blocked] * segments if blocked else []):
        raise AssertionError(f"{name}: blocked reductions {slog.blocked}, "
                             f"expected {blocked} on each segment")


FLOAT_SUMS = ("dsum",)


def same_rows(a, b):
    """Rows equal; a float sum (the mixed strategy's atomics add in no fixed
    order) within 1e-9 of its magnitude."""
    def split(rows):
        exact, sums = [], []
        for r in rows:
            r = json.loads(json.dumps(r))
            for v in ([r["event"]] if "event" in r else
                      r["result"] if isinstance(r["result"], list)
                      else [r["result"]]):
                for k in FLOAT_SUMS:
                    if k in v:
                        sums.append(v.pop(k))
            exact.append(r)
        return exact, np.asarray(sums, dtype=np.float64)
    (ea, sa), (eb, sb) = split(a), split(b)
    return ea == eb and sa.shape == sb.shape \
        and bool(np.all(np.abs(sa - sb) <= 1e-9 * np.abs(sa)))


def phase_packing_off(dev, segments, qs, n_seg=2):
    """The four queries on the first `n_seg` segments with packing on (the
    blocks the main path staged) and off (decoded blocks): the same
    rows."""
    import torch
    from druid_tpu_torch.data import packed
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    sub = segments[:n_seg]
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    out = {}
    for name, q in qs.items():
        on = QueryExecutor(sub, device=dev).run_json(q)
        prev = packed.set_enabled(False)
        try:
            with BlockLog() as blog:
                off = QueryExecutor(sub, device=dev).run_json(q)
                torch.cuda.synchronize()
        finally:
            packed.set_enabled(prev)
        b = blog.summary()
        if not same_rows(on, off) or not on:
            raise AssertionError(f"{name}: packing off changes the rows")
        if b["packs"]:
            raise AssertionError(f"{name}: packing off staged {b}")
        out[name] = {"rows": len(on), "block_off": b}
        log(f"  {name}: {len(on)} rows, packing on = off; off: resident "
            f"{b['resident_mb'][0]:.3f} MB/segment "
            f"({b['bytes_per_row']:.3f} B/row)")
    sr.LAUNCHES, mk.LAUNCHES = saved  # these runs are a check, not the path
    return out


# ---------------------------------------------------------------------------
# phases 8 and 9: the reduction strategies on the headline data
# ---------------------------------------------------------------------------

#: forced strategy -> the strategy each query must then run. A force the
#: reference's rules find ineligible falls through to the normal selection
#: (the timeseries' doubleSum has no mm plan and no blocked step); the
#: topN's projection takes its fused `in` filter into kernel B2.
FORCES = {"topn": {"mm": "mm", "blocked": "blocked", "mixed": "mixed",
                   "projection": "megakernel"},
          "timeseries": {"mm": "mixed", "blocked": "mixed",
                         "mixed": "mixed"}}


def run_forced(ex, q, force, segments=SEGMENTS):
    """One cold run of `q` under grouping.FORCE_STRATEGY = force: (rows,
    StrategyLog, seconds)."""
    import torch
    from druid_tpu_torch.engine import grouping as gr
    gr.FORCE_STRATEGY = force
    try:
        t = time.perf_counter()
        with StrategyLog() as slog:
            rows = ex.run_json(q)
            torch.cuda.synchronize()
        return rows, slog, time.perf_counter() - t
    finally:
        gr.FORCE_STRATEGY = None


def timed_split(q, segments, dev, force):
    from druid_tpu_torch.engine import grouping as gr
    gr.FORCE_STRATEGY = force
    try:
        return split_times(q, segments, dev)
    finally:
        gr.FORCE_STRATEGY = None


def with_fsum(q):
    """`q` with a floatSum of metFloat beside its aggregators."""
    return dict(q, aggregations=q["aggregations"] + [
        {"type": "floatSum", "name": "fsum", "fieldName": "metFloat"}])


def same_bits_twice(ex, q, force, check, ref, segments=SEGMENTS):
    """Two runs of `q` under `force` give the same rows, float bits
    included (every float printed exactly); both hold against numpy."""
    a, slog, _ = run_forced(ex, q, force, segments)
    b, _, _ = run_forced(ex, q, force, segments)
    check(a, ref)
    if json.dumps(a) != json.dumps(b):
        raise AssertionError(f"{force}: two runs differ in float bits")
    return slog.strategies


def op_times(fns, reps=5):
    """{name: ms per call} of each function, CUDA events."""
    return {name: cuda_ms(fn, reps) for name, fn in fns.items()}


def device_split(fn, reps=3, top=8):
    """torch.profiler's device ms per call of `fn`, by kernel name (the
    `top` largest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us and ev.key and not ev.key.startswith(("aten::", "cuda")) \
                and "Memcpy" not in ev.key:
            by[ev.key[:90]] = us / 1e3 / reps
    return dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])


def timeseries_op_split(ts_inputs):
    """Device ms of each op of the timeseries' reduction on segment 0's
    inputs: the pure-scatter form (the parent's) and the mixed hybrid; the
    blocked reduction at smaller steps, and split by kernel."""
    import torch
    from druid_tpu_torch.engine import grouping as gr
    arrays, mask, key, _, _, ks, G = ts_inputs
    key = key.to(torch.int64).clamp(0, G - 1)
    scatter = {"counts index_add_ int64": lambda: torch.zeros(
        G, dtype=torch.int64, device=key.device).index_add_(
            0, key, mask.to(torch.int64))}
    for k in ks:
        scatter[f"{k.name} {type(k).__name__}.update"] = \
            lambda k=k: k.update(arrays, mask, key, G)
    blocked = [k for k in ks if k.name != "dsum"]

    def run_blocked():
        return gr._blocked_reduce(arrays, mask, key, blocked, G)
    hybrid = {f"_blocked_reduce {tuple(k.name for k in blocked)} + counts":
              run_blocked,
              "dsum SumKernel.update": scatter["dsum SumKernel.update"]}
    out = {"pure_scatter": op_times(scatter), "hybrid": op_times(hybrid)}
    saved = gr.STEP_CELLS
    try:
        for cells in (1 << 26, 1 << 23):
            gr.STEP_CELLS = cells
            out["hybrid"][f"_blocked_reduce at {cells // G} rows/step"] = \
                cuda_ms(run_blocked, 3)
    finally:
        gr.STEP_CELLS = saved
    out["blocked_by_kernel"] = device_split(run_blocked)
    return out


def mm_split(mm_inputs):
    """The mm reduction on segment 0's topN inputs: its time, one step's
    one-hot build and int8 product (block-diagonal, as mm_reduce runs it,
    and the plain [G, rows] x [rows, 8] one) times, and its time at smaller
    one-hot budgets (an L2-resident step trades HBM bytes for launches)."""
    import torch
    from druid_tpu_torch.engine import mmagg
    arrays, mask, key, ks, plans, G = mm_inputs
    step = mmagg.step_rows(G)
    steps = -(-mask.shape[0] // step)
    groups = max(G, 32)
    r8 = 8
    nsl = mmagg.slices(r8)
    kb, mb = key[:step], mask[:step]
    oh = mmagg.onehot(kb, mb, groups)
    lhs = torch.ones(nsl, r8, kb.shape[0] // nsl, dtype=torch.int8,
                     device=key.device)
    flat = torch.ones(r8, kb.shape[0], dtype=torch.int8, device=key.device)
    res = {"G": G, "rows": int(mask.shape[0]), "step_rows": step,
           "steps": steps, "slices": nsl,
           "mm_reduce_ms": cuda_ms(lambda: mmagg.mm_reduce(
               arrays, mask, key, ks, plans, G), 5),
           "onehot_ms_per_step": cuda_ms(
               lambda: mmagg.onehot(kb, mb, groups), 5),
           "product_ms_per_step": cuda_ms(
               lambda: mmagg.int8_product(oh, lhs), 5),
           "plain_product_ms_per_step": cuda_ms(
               lambda: torch._int_mm(oh, flat.t()), 5)}
    del oh
    saved = mmagg.MM_ONEHOT_BYTES
    try:
        for budget in (1 << 26, 1 << 24):
            mmagg.MM_ONEHOT_BYTES = budget
            res[f"mm_reduce_ms_budget_{budget >> 20}MiB"] = cuda_ms(
                lambda: mmagg.mm_reduce(arrays, mask, key, ks, plans, G), 3)
    finally:
        mmagg.MM_ONEHOT_BYTES = saved
    return res


def phase_strategies(dev, segments, qs, ref, main_out):
    """Every eligible strategy forced on the topN and the timeseries over
    the 8 headline segments: each against numpy and the others, its
    partials time; mm and blocked twice with a float sum (same bits); the
    timeseries' pure-scatter form (the parent's) beside the hybrid, split
    by op on segment 0; mm split into one-hot and product."""
    from druid_tpu_torch.engine import grouping as gr
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import mmagg
    from druid_tpu_torch.engine import sorted_reduce as sr
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    checks = {"topn": check_topn, "timeseries": check_timeseries}
    ex = QueryExecutor(segments, device=dev)
    out = {}
    for name, forces in FORCES.items():
        q, first = qs[name], None
        for force, want in forces.items():
            rows, slog, cold = run_forced(ex, q, force)
            checks[name](rows, ref)
            if slog.names() != [want] * SEGMENTS:
                raise AssertionError(f"{name} forced {force}: ran "
                                     f"{slog.strategies}, expected {want}")
            if first is None:
                first = rows
            elif not same_rows(rows, first):
                raise AssertionError(f"{name} forced {force}: rows differ "
                                     f"from forced {list(forces)[0]}")
            split = timed_split(q, segments, dev, force)
            out[f"{name}/{force}"] = {"ran": want, "cold_s": cold,
                                      "blocked": sorted(set(slog.blocked)),
                                      **split}
            fell = "" if want == force else f" (ran {want})"
            log(f"  {name} forced {force}{fell}: ok, partials "
                f"{split['partials_ms']:.1f} ms, merge+finish "
                f"{split['finish_ms']:.1f} ms, first run {cold:.2f} s; "
                f"blocked took {sorted(set(slog.blocked))}")
    # the parent's pure-scatter timeseries: mixed with the hybrid off
    limit = gr.BLOCKED_GROUP_LIMIT
    gr.BLOCKED_GROUP_LIMIT = 0
    try:
        rows, slog, cold = run_forced(ex, qs["timeseries"], "mixed")
        check_timeseries(rows, ref)
        if slog.blocked:
            raise AssertionError("pure scatter ran a blocked reduction")
        split = timed_split(qs["timeseries"], segments, dev, "mixed")
    finally:
        gr.BLOCKED_GROUP_LIMIT = limit
    out["timeseries/pure_scatter"] = split
    log(f"  timeseries pure scatter (the parent's form): partials "
        f"{split['partials_ms']:.1f} ms, merge+finish "
        f"{split['finish_ms']:.1f} ms")
    ops = timeseries_op_split(main_out["ts_inputs"])
    out["timeseries_ops_segment0"] = ops
    for form, t in ops.items():
        log(f"  timeseries segment 0, {form}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in t.items()))
    out["mm_by_kernel"] = device_split(
        lambda: mmagg.mm_reduce(*main_out["mm_inputs"]))
    log("  mm on segment 0, device ms by kernel: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["mm_by_kernel"].items()))
    # float bits twice: a floatSum beside the topN's aggregators
    topn_f = with_fsum(qs["topn"])
    for force in ("mm", "blocked"):
        st = same_bits_twice(ex, topn_f, force, check_topn, ref)
        if [s for s, _ in st] != [force] * SEGMENTS:
            raise AssertionError(f"topN+fsum forced {force} ran {st}")
        log(f"  topN + floatSum forced {force}: two runs, same float bits; "
            f"fsum within 1e-5*sum|v| of numpy")
    mm = mm_split(main_out["mm_inputs"])
    out["mm_split_segment0"] = mm
    log(f"  mm on segment 0's topN inputs (G={mm['G']}, {mm['rows']} rows, "
        f"{mm['steps']} steps of up to {mm['step_rows']} rows): "
        f"{mm['mm_reduce_ms']:.3f} ms; one-hot "
        f"{mm['onehot_ms_per_step']:.3f} ms/step, int8 product "
        f"{mm['product_ms_per_step']:.3f} ms/step block-diagonal "
        f"({mm['slices']} slices), {mm['plain_product_ms_per_step']:.3f} "
        f"ms/step plain (N = 8); at a 64 MiB one-hot "
        f"{mm['mm_reduce_ms_budget_64MiB']:.3f} ms, 16 MiB "
        f"{mm['mm_reduce_ms_budget_16MiB']:.3f} ms")
    sr.LAUNCHES, mk.LAUNCHES = saved  # forced runs are not the main path
    return out


SORTED_SEGMENTS = 2                  # cut from 8 for time (reduced)


def phase_sorted(dev):
    """The headline schema in the rollup sort order (2 segments of 12.5M
    rows): the headline groupBy must select windowed; rows against numpy;
    cold and warm p50; windowed twice with a float sum (same bits); forced
    projection (B1) as a cross-check."""
    import torch
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    t = time.perf_counter()
    segments = headline_segments(SORTED_SEGMENTS, sort_by_dims=True)
    gen_s = time.perf_counter() - t
    ref = numpy_reference(segments)
    q = queries(segments)["groupby"]
    ex = QueryExecutor(segments, device=dev)
    rows, slog, cold = run_forced(ex, q, None)
    check_groupby(rows, ref)
    log(f"  generated {SORTED_SEGMENTS} sorted segments of "
        f"{ROWS // SEGMENTS} rows in {gen_s:.1f} s; groupBy strategy per "
        f"segment {slog.strategies}")
    if slog.names() != ["windowed"] * SORTED_SEGMENTS:
        raise AssertionError(f"sorted groupBy ran {slog.strategies}, "
                             f"expected windowed")
    warm = []
    for _ in range(5):
        t = time.perf_counter()
        again = ex.run_json(q)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    check_groupby(again, ref)
    split = split_times(q, segments, dev)
    st = same_bits_twice(ex, with_fsum(q), None, check_groupby, ref,
                         SORTED_SEGMENTS)
    if [s for s, _ in st] != ["windowed"] * SORTED_SEGMENTS:
        raise AssertionError(f"sorted groupBy + fsum ran {st}")
    proj, pslog, pcold = run_forced(ex, q, "projection", SORTED_SEGMENTS)
    if pslog.names() != ["projection"] * SORTED_SEGMENTS:
        raise AssertionError(f"forced projection ran {pslog.strategies}")
    if json.dumps(proj) != json.dumps(rows):
        raise AssertionError("sorted groupBy: projection rows differ from "
                             "windowed rows")
    psplit = timed_split(q, segments, dev, "projection")
    sr.LAUNCHES, mk.LAUNCHES = saved  # not the main path
    p50 = float(np.median(warm))
    log(f"  sorted groupBy: windowed, W {sorted({w for _, w in slog.strategies})}"
        f", ok; cold {cold:.2f} s, warm p50 {p50:.1f} ms, partials "
        f"{split['partials_ms']:.1f} ms, merge+finish "
        f"{split['finish_ms']:.1f} ms; windowed + floatSum twice: same "
        f"float bits; forced projection (B1): same rows, first run "
        f"{pcold:.2f} s, partials {psplit['partials_ms']:.1f} ms")
    return {"rows": ROWS // SEGMENTS * SORTED_SEGMENTS, "gen_s": gen_s,
            "strategies": slog.strategies, "cold_s": cold, "warm_ms": warm,
            "p50_ms": p50, **split, "projection_cold_s": pcold,
            "projection": psplit, "result_rows": len(rows)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from druid_tpu_torch import _build
    from druid_tpu_torch.engine import megakernel as mk
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
    log("phase B2 parity, synthetic")
    b2 = phase_b2(dev)
    report["b2_parity"] = b2

    log("phase packed value fields, synthetic")
    report["packed_parity"] = phase_packed(dev)

    log("phase main path (packing on)")
    sr.LAUNCHES = mk.LAUNCHES = 0
    main_out = phase_main(dev)
    launches = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    inputs = {"B1": main_out.pop("b1_inputs"),
              "B2": main_out.pop("b2_inputs")}
    segments, qs = main_out.pop("segments"), main_out.pop("queries")
    ref = main_out.pop("ref")
    captured = {k: main_out.pop(k) for k in ("mm_inputs", "ts_inputs")}
    report["main"] = main_out

    log("phase packing off, 2 segments")
    report["packing_off"] = phase_packing_off(dev, segments, qs)

    log("phase strategies, the 8 headline segments")
    report["strategies"] = phase_strategies(dev, segments, qs, ref, captured)
    del segments, captured, ref

    log(f"phase sorted, {SORTED_SEGMENTS} segments in the rollup order")
    report["sorted"] = phase_sorted(dev)

    entries = []
    for which, parity, check, name, source, replaces in (
            ("B1", b1, check_b1, "sorted_reduce",
             "druid_tpu_torch/csrc/sorted_reduce.cu",
             "druid_tpu/engine/pallas_agg.py:166"),
            ("B2", b2, check_b2, "mega_reduce",
             "druid_tpu_torch/csrc/sorted_reduce.cu (sr_partial_words)",
             "druid_tpu/engine/megakernel.py:742")):
        log(f"phase {which} on the main path's inputs (first segment)")
        view, m_in, key, ks, G, span, pcs = inputs[which]
        err, _ = check("main-path", view, m_in, key, ks, G, span, pcs)
        parity["main_path_max_abs_err"] = err
        tb = time_kernel(which, dev, inputs[which], packed=True)
        td = time_kernel(which, dev, inputs[which], packed=False)
        saved = (sr.LAUNCHES, mk.LAUNCHES)
        ms_packed, ms_dense = ab_ms(launcher(which, inputs[which])[0],
                                    launcher(which, inputs[which], False)[0])
        sr.LAUNCHES, mk.LAUNCHES = saved
        tb["ab_ms_packed"], tb["ab_ms_dense"] = ms_packed, ms_dense
        report[f"{which.lower()}_times"] = tb
        report[f"{which.lower()}_times_dense"] = td
        partial = [sum(v for k, v in t["device_ms_by_kernel"].items()
                       if "sr_partial_kernel" in k) for t in (tb, td)]
        log(f"  {which} {tb['ms']:.3f} ms/launch with "
            f"{tb['packed_fields']} as words, {td['ms']:.3f} decoded; in "
            f"turns packed {ms_packed[0]:.3f}/{ms_packed[1]:.3f}, decoded "
            f"{ms_dense[0]:.3f}/{ms_dense[1]:.3f} ms; partial pass "
            f"{partial[0]:.4f} (words) / {partial[1]:.4f} (decoded) ms "
            f"(n={tb['n']}, live rows={tb['live_rows']}, G={G}, "
            f"span={span}, window={tb['window']}, ops={tb['ops']}); bound "
            f"{tb['bound_ms']:.4f} ms ({tb['bytes']} B; decoded "
            f"{td['bound_ms']:.4f} ms, {td['bytes']} B; 32-row groups "
            f"with a live row: {tb['live_word_share']:.4f}), plain "
            f"{tb['plain_ms']:.3f} ms, library {tb['library_ms']:.3f} ms; "
            f"longest run of one key per block: median "
            f"{tb['longest_run_median']:.0f} rows, "
            f"{tb['blocks_with_half_block_run']:.4f} of blocks >= half a "
            f"block")
        for tag, t in (("words", tb), ("decoded", td)):
            log(f"    [{tag}] host enqueue {t['enqueue_ms']:.4f} ms/launch, "
                f"device {t['device_ms']:.4f} ms/launch in all "
                f"(torch.profiler):")
            for kname, kms in sorted(t["device_ms_by_kernel"].items(),
                                     key=lambda kv: -kv[1]):
                log(f"    [{tag}] device {kms:.4f} ms/launch  {kname[:100]}")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[which],
            "max_abs_err": max(err, parity["max_abs_err"],
                               report["packed_parity"]["max_abs_err"]),
            "ms": tb["ms"], "plain_ms": tb["plain_ms"],
            "bound_ms": tb["bound_ms"], "bound_by": "bytes",
            "library_ms": tb["library_ms"],
            "variant": "packed words: " + ", ".join(
                f"{f} w{w}" for f, w in sorted(tb["packed_fields"].items())),
            "dense_ms": td["ms"], "dense_bound_ms": td["bound_ms"]})
    kernels_line = {"kernels": entries}
    report["kernels"] = entries
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
