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
 10. run domain: the headline schema in the rollup order (8 segments of
     12.5M rows) with a constant LONG `cnt`, and 2 of them re-ordered by
     (hour, dimA, dimB): a timeseries (all, `in` dimA), a timeseries with a
     filtered longSum of `cnt` and a filtered count (each `in` dimA), a
     topN on dimA, an
     hourly groupBy on dimA over the hour-ordered segments, all served in
     run space (code-domain aggregation, engine/rundomain.py) on every
     segment with B1/B2 launched 0 times, and the count-only groupBy on
     dimA x dimB, whose joint run count (printed, against numpy) decides
     its path; each against numpy and against the row program
     (`cascade.set_run_domain_enabled(False)`), which must not stage `cnt`,
     with cold, warm p50 and split times and the bytes each path staged;
     the filtered groupBy's bitmap leaves from run tables (staged fill and
     fused) equal the row-built words on the card, and its rows equal
     numpy with the megakernel on and off;
 11. B1 and B2 against their plain versions on the inputs the main path gave
     them (the first segment's), then timed there with CUDA events beside
     their HBM bound, their plain version and a library yardstick
     (index_add_/scatter_reduce over the same keys, B2's with the word
     unpack, never used by the port), the host's enqueue time per launch
     and torch.profiler's device time by kernel, with metLong as words
     (the main path's inputs) and decoded, in turns; and the warm p50 of
     each query;
 12. expressions, on headline data generated anew (run before phase 11,
     with the B1/B2 counts set to 0 before it and read after it): X1 the
     headline
     groupBy with a FLOAT virtual column vf = metFloat * 2 + metLong and
     floatMax(vf) (projection, B1 x8 a run; its first B1 call held
     against the plain version, vf read dense and metLong as w16 words;
     vf's device time on segment 0); X2 a groupBy filtered by and(in dimA,
     regex dimB, expression "metLong % 10 < 7") (megakernel, B2 x8, the
     expression as B2's residual row mask; its first call held against
     the plain version; the live row share); X3 a topN on a substring
     extraction of dimB filtered by search dimA "5" (mm); X4 a groupBy on
     the expression dimension div(metLong, 100) x dimA with a DOUBLE
     virtual column summed, filtered by not(columnComparison [dimA,
     dimB]) (windowed over the projection: B1 has no float64 sum); X3 and
     X4 on 2 of the 8 segments (reduced). Each against numpy (exact, vf
     within 1e-6 relative, the double sum within 1e-9), with its strategy
     per segment, cold time, warm p50 of 5 and split_times;
 13. aggregators, on phase 12's segments (before phase 11, B1/B2 counts
     set to 0 before it; both must stay 0): A1 an hourly timeseries with a
     count and a filtered count, longSum and longMax (their bitmap trees
     fused), again with the megakernel off and with device bitmaps off;
     A2 a groupBy on dimA with hyperUnique(dimB, log2m 12), and the HLL
     update's device time on segment 0 beside its bytes bound; A3 an
     hourly timeseries with cardinality([dimA, dimB], byRow, round) and
     cardinality([metLong]); A4 an hourly groupBy on dimA with longFirst,
     longLast and floatLast; A5 hyperUnique over an int8 register column
     on the (dimA, dimB) rollup of 2 segments that the script builds
     (~410 MB of registers a segment; reduced). Each against numpy (its
     own FNV-1a and splitmix64 hashes and estimator; registers, estimates
     and first/last values exact), with its strategy per segment (mixed,
     with the blocked hybrid where G <= 2048), cold time, warm p50 of 5
     and split_times.
 14. batching and the device pool (before phase 11, B1/B2 counts set to 0
     before it; both must stay 0): the headline schema generated anew in
     48 hourly segments of 1M rows over two days (rung 2^20: stacked runs
     of 32 and 16) and one 3M-row segment for the next hour (above
     BATCH_MAX_SEGMENT_ROWS: a straggler), each in a random row order so
     that the run domain refuses; B-ts an hourly timeseries (count,
     longSum, floatMax, doubleSum: the mixed hybrid), B-topN a topN of dimB
     by longSum under `in` half of dimA (mm, G = 1024), B-gb a groupBy on
     dimA with count, longSum, longMin, longFirst and a filtered count of
     dimB's head (mixed). Each batched and with {"batchSegments": false},
     1 cold and 5 warm runs, rows against numpy and against each other;
     warm p50, split_times and cold time; the batched runs, segments per
     run, fill ratio and stragglers (`batching.stats()`); B-ts and B-topN
     with a floatSum twice batched (the same bits required) and alone
     (bit equality reported); each stacked run's launch calls and the
     device kernels they launched at K = 16 and K = 32 (torch.profiler;
     for the mixed and blocked cells the launches must be equal, and the
     kernels too where neither trace dropped a record); then B-ts three
     times under a pool budget of half its resident
     bytes (evictions required, rows unchanged) and the default budget
     back.
 15. the native surface (run after phase 8, on the 8 headline segments,
     with the B1/B2 counts set to 0 before it and read after it; a second
     datasource headline_b re-labels two segments' arrays): N1 the headline
     groupBy with having and(greaterThan rows, filter(bound lsum)) and a
     limitSpec; N2 with subtotalsSpec [[dimA], [dimB], []]; N3 a groupBy
     on dimA over a query dataSource (the headline groupBy); N4 bySegment;
     N5 the filtered groupBy with doubleGreatest / longLeast; N6 the hourly
     timeseries under chunkPeriod PT6H, and the headline groupBy over
     union(bench, headline_b); N7 a scan (limit 10,000, batchSize 4096,
     the filtered groupBy's filter) in both orders, also through
     run_streaming; N8 two select pages of 1000; N9 search "7" over dimA
     and dimB; N10 timeBoundary under the filter; N11 segmentMetadata,
     merged, every analysis; N12 dataSourceMetadata. Each query
     round-trips through to_json, runs cold and 3 times warm with its
     B1/B2 launches per run required (N1-N4 B1 x8, N5 B2 x8, the union B1
     x10, the rest none), and its rows hold against numpy.
 16. the extension aggregators (druid_tpu_torch.ext, run after phase 15 on
     its 8 headline segments, B1/B2 counts set to 0 before it and read
     after it; both must stay 0): E1 an hourly timeseries with variance
     (sample) and stddev, quantilesDoublesSketch(metFloat) with p50 and
     p90/p99, timeMin and timeMax; E2 a groupBy on dimA with two filtered
     thetaSketch(dimB) (metLong < 5000, metFloat > 100; shouldFinalize
     false), their INTERSECT and estimates, and HLLSketchBuild(dimB, lgK
     12) with HLLSketchToEstimate; E3 a topN of dimA by distinctCount(dimB),
     threshold 10, with approxHistogram(metFloat, 0..200, 64) and its 0.95
     quantile; E4 a groupBy on dimA under a bloom filter of 100 dimB values
     (built here; its false positives over the dictionary counted) with a
     bloom aggregator on dimB. Each runs cold and 3 times warm against
     numpy (exact: counts, sketch states, minima, bits, estimates,
     quantiles; variance and stddev within 1e-9 relative, its merged sums
     within 1e-12 sum|v| and 1e-12 sum v^2), with its strategy per segment
     (mixed), split_times, and each ext update's device time on segment 0
     beside its bytes bound. E5, after phase 14 on its segments: E1 over
     the 49 hourly segments, batched and alone, each against numpy and the
     two against each other.
 17. serving (druid_tpu_torch.cluster, run after phase 16 on its 8 headline
     segments, B1/B2 counts set to 0 before the broker's runs and read
     after them): 3 DataNodes on the card, the segments round-robin with
     replica 2, announced on one InventoryView, one Broker (hedging off:
     the nodes share one card). The four main-path queries through
     Broker.run_json, 1 run and 3 warm, each against numpy and the
     executor's rows (float sums within 1e-9 of their magnitude), with B1
     x8 a groupBy run and B2 x8 a filtered-groupBy run, the warm p50
     beside the executor's and the trace's time by span (broker/scatter,
     broker/node, engine/partials, broker/merge); the groupBy with an
     LruCache on each node (8 misses and B1 x8, then 8 hits and B1 x0, the
     same rows), with the broker's result cache (the second run served
     with no node call), and with node0 dead (the same rows, B1 x8, failed
     calls on node0 only; no other sub-phase may show a failed call or a
     partial result); the seven monitors ticked once (pool bytes,
     dispatches and megakernel runs > 0; the pool no larger than after
     phase 16: replicas share one segment's entries). Its cross-query
     fusion runs in phase 14: two B-ts through one node's
     run_partials_group, a stacked run holding both queries, each equal to
     the query alone, B1/B2 0.
 18. HTTP serving (right after phase 17, on its 8 segments and its three
     DataNodes, so nothing stages again; B1/B2 counts set to 0 before it
     and read after it): a DataNodeServer over each node, a
     RemoteDataNodeClient per server in a fresh InventoryView, a Broker
     over it (hedging off) served by QueryHttpServer(QueryLifecycle(...)),
     every call loopback in this process. The four main-path queries
     posted as JSON to /druid/v2, 1 cold and 3 warm runs each, against
     numpy and phase 17's broker rows, with B1 x8 a groupBy run and B2 x8
     a filtered run (topN and timeseries none) and no failed node call;
     the warm p50 beside phase 17's broker p50 and the executor's, the
     trace's time by span from GET /druid/v2/trace/<id> (query,
     broker/scatter, broker/node, the summed datanode/query,
     engine/partials, broker/merge) and the wire's logical and emitted
     bytes a run. Then the groupBy with wireCompress off in its context
     (the same rows, no fewer bytes than compressed), with If-None-Match
     set to the last reply's etag (a 304 and no launch), and with node0's
     server stopped (failover to the replicas, the same rows, failed calls
     on node0 only); then node1 served anew with SchedulerConfig() beside
     node2 and two filtered groupBys posted at once (rows against numpy
     and phase 17's; the scheduler's stats and query/queue, shed and
     crossBatch metrics printed). The pool's resident bytes must be the
     same before and after, and the phase must take at most 45 s.
 19. SQL (right after phase 18, on phase 17's three DataNodes served
     anew, so nothing stages again; B1/B2 counts set to 0 before it and
     read after it): a Broker over RemoteDataNodeClients behind
     QueryHttpServer(QueryLifecycle(broker), sql_executor=SqlExecutor(
     broker)), and a RouterHttpServer in front of it, every call loopback
     in this process. The schema discovery (a merged segmentMetadata
     scatter) timed apart; the four main-path queries as Druid SQL posted
     to the router's /druid/v2/sql, 1 cold and 3 warm runs each, against
     numpy and phase 18's native rows, with B1 x8 a groupBy run and B2 x8
     a filtered run (each statement carries the native queries' day as
     a __time range, so its plan equals the native query but for the
     timeseries' floatSum, and reuses its staged blocks), each statement's
     explain() and planning time printed, and its warm p50 beside phase
     18's native p50 over HTTP; one Avatica round trip of the groupBy
     (open, prepareAndExecute, fetch, close; the same rows, B1 x8) and one
     native groupBy through the router (phase 18's rows, B1 x8). The
     pool's resident bytes must be the same before and after, and the
     phase must take at most 45 s.
 20. storage (right after phase 19, on phase 6's 8 in-memory segments and
     numpy reference; B1/B2 counts set to 0 before it and read after it):
     the golden fixtures tests/golden/segment_v1 and segment_v2 (written by
     the reference) loaded on the card, their columns against the
     fixture's arrays rebuilt with no RNG (NaN and -0.0 bit for bit) and
     their groupBy against numpy; the 8 segments pushed (format V2) to a
     LocalDeepStorage in a temporary directory, segment 0 again as V1,
     each push's seconds, on-disk bytes by part kind and logical bytes
     printed; a LoadQueuePeon loading the 8 into a fresh DataNode announced
     on an InventoryView (none failed, no lazy column materialized by the
     load) and one tick of its DataNodeServer's SegmentLoadMonitor
     (segment/load/{time,bytes,compressedBytes} > 0); the four main-path
     queries posted to /druid/v2 of a broker over it, 1 cold and 3 warm
     runs each, against numpy and phase 18's rows, B1 x8 a groupBy run and
     B2 x8 a filtered run, cold and warm p50 beside phase 18's p50, and
     cascade.decode_stats before and after; the filtered groupBy's leaves
     on loaded segment 0 (the words B2 read) against lut[ids]'s words; a
     groupBy filtered on a dimB tail value whose leaf ships sparse, through
     B2 x8, against numpy; segment 0 loaded from V1 equal to the in-memory
     one bit for bit, its groupBy equal to the V2 copy's; no pool
     eviction. The directory is removed at the end; the phase must take at
     most 150 s.
 21. ingest (right after phase 20; B1/B2 counts set to 0 before it and
     read after it): Druid's Kafka indexing service with its documented
     tuningConfig (maxRowsInMemory 1,000,000 as max_rows_per_hydrant,
     maxRowsPerSegment 5,000,000 checked against every sink, not
     enforced; maxTotalRows 20,000,000 as the task roll-over, which no
     task reaches; segmentGranularity HOUR, queryGranularity NONE,
     taskCount 2 over 2 partitions). 10,000,000 events of the headline
     schema (seed 1234, numpy), 5,000,000 a partition in time order over
     2 hours, each at its own millisecond (nothing rolls up: every stored
     count is 1), go into a SimulatedStream; a StreamSupervisor with a sqlite MetadataStore, a
     LocalDeepStorage, an InputRowParser and a RealtimeServer in the
     broker's InventoryView ingests them (4 sinks of ~2.5M events, each
     with 2 persisted hydrants and a live one). Two standing queries
     (hourly timeseries; groupBy by dimA with doubleMax) are subscribed on
     a SubscriptionHub before the first event and ticked every 500,000
     events: every snapshot against numpy over the events so far and
     against its re-scan (counts, long sums and maxima equal, float sums
     within 1e-5 * sum|v|), no segment folded twice. A7: one live hydrant
     of 1M rows refolded 20 times, the ticks' ms and torch.cuda.
     memory_stats before and after. The subscription surface: POST
     /druid/v2/subscriptions, a 304 on an unchanged ETag within its
     timeoutMs, and a poll parked before the last 200,000 events (ticked
     by the historical's DataNodeScheduler flush loop) woken with the next
     version. The four main-path queries posted to /druid/v2 of a broker
     (hedging off) over the realtime server before publish, 1 cold and 3
     warm runs, against numpy; checkpoint_all() publishes the 4 sinks
     (merged, pushed as V2, committed with the offsets {"0": 5000000,
     "1": 5000000}), the handoff loads them into a DataNode through a
     LoadQueuePeon, the sinks unannounce, each standing program cuts over
     once a sink (every emission across the boundary counts 10,000,000);
     the four queries again, rows equal numpy and the ones before publish,
     each segment's strategy printed and checked against the planner's
     rule: a longSum over a constant LONG column (count) keeps the
     groupBys off B1 and B2, on mixed, so B1 and B2 launch once a
     published segment only where its count column is not constant (none
     here; ROADMAP C). No pool eviction; the
     directory is removed; the phase must take at most 150 s.
22. the mesh (druid_tpu_torch/parallel/; right after phase 7, on phase 6's
     8 segments): the four main-path queries through
     QueryExecutor(segments, mesh=make_mesh()) (the one card), 1 cold and
     3 warm runs each: rows against numpy, exactly one `sharded` dispatch a
     run and no per-segment, batched or run-domain one, the same strategy
     every run (the projection becomes mixed), B1 and B2 launched 0 times;
     warm p50, partials and merge+finish (split_times) and
     query/sharded/stackBytes printed beside the same query's warm p50 and
     split without a mesh, with the card's name and power limit. Then one
     groupBy through a DataNode(mesh=...) behind the in-process broker
     (rows against numpy, one sharded run), and release_device_caches()
     must take stackBytes from above 0 to 0. The phase must take at most
     120 s (run alone it also pays the meshless queries' cold runs).
The device pool's snapshot is printed after phases 6-10 and 12-22; at the
default budget none may show an eviction.
`python3 chip_smoke.py batching` runs the build and phase 14 alone;
`python3 chip_smoke.py extensions` the build and phase 16 with E5;
`python3 chip_smoke.py serving` the build and phase 17 (the executor
warms the headline segments first) with its fusion on phase 14's segments;
`python3 chip_smoke.py http` the build, phase 17's cluster and its four
main-path queries (phase 18's yardstick), and phase 18;
`python3 chip_smoke.py sql` the same and phase 19;
`python3 chip_smoke.py storage` the build, phase 6's data and numpy
reference, and phase 20;
`python3 chip_smoke.py ingest` the build and phase 21;
`python3 chip_smoke.py sharded` the build, phase 6's data and numpy
reference, and phase 22.
The line before the last is the kernels JSON line (each kernel's
`launches` counted on phase 6's path, `launches_expressions` on phase
12's, `launches_aggregators` on phase 13's, `launches_native_surface` on
phase 15's, `launches_extensions` on phase 16's, `launches_serving` on
phase 17's, `launches_http` on phase 18's, `launches_sql` on phase
19's, `launches_storage` on phase 20's, `launches_ingest` on phase
21's, `launches_sharded` on phase 22's mesh runs); the last line is
{"ok": true,
"device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""
import dataclasses
import json
import math
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
    reduction (`grouping.fuse_filter_update`, and K entries for a batched
    run of K segments, `grouping.fuse_filter_update_stacked`), the kernels
    each blocked reduction took (`grouping._blocked_reduce`, per segment),
    and the first fuse and mm calls' inputs (segment 0's, for the per-op
    timings). Every wrapped function runs unchanged."""

    NAMES = ("fuse_filter_update", "_blocked_reduce", "mm_reduce",
             "fuse_filter_update_stacked")

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
            # a batched stack [K, R] reduces K segments at once
            k = mask.shape[0] if mask.dim() == 2 else 1
            self.blocked.extend([tuple(kr.name for kr in kernels)] * k)
            return orig["_blocked_reduce"](arrays, mask, key, kernels,
                                           num_total)

        def stacked(arrays, mask, key, dims, filter_node, kernels,
                    num_total, slot_base, strategy="mixed", span=0):
            self.strategies.extend([(strategy, span)] * mask.shape[0])
            return orig["fuse_filter_update_stacked"](
                arrays, mask, key, dims, filter_node, kernels, num_total,
                slot_base, strategy=strategy, span=span)

        def mm(arrays, mask, key, kernels, plans, num_total):
            if self.first_mm is None:
                self.first_mm = (arrays, mask, key, list(kernels),
                                 list(plans), num_total)
            return orig["mm_reduce"](arrays, mask, key, kernels, plans,
                                     num_total)
        for n, f in zip(self.NAMES, (fuse, blocked, mm, stacked)):
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


def check_timeseries(rows, ref, buckets=24):
    if len(rows) != buckets:
        raise AssertionError(f"timeseries: {len(rows)} buckets, expected "
                             f"{buckets}")
    for i, r in enumerate(rows):
        v = r["result"]
        if r["timestamp"] != ref["t0"] + i * 3_600_000 \
                or (v["rows"], v["lsum"]) != (int(ref["h_cnt"][i]),
                                              int(ref["h_lsum"][i])) \
                or np.float32(v["fmax"]) != ref["h_fmax"][i] \
                or abs(v["dsum"] - ref["h_dsum"][i]) > 1e-5 * ref["h_abs"][i]:
            raise AssertionError(f"timeseries bucket {i}: {v}")


def split_times(q, segments, dev, reps=3, mesh=None):
    """Where a warm query's time goes: producing the per-segment partials
    (host planning + device work + copy back) against merging and finishing
    them on the host, medians of `reps`. With `mesh`, the partials are the
    one sharded run's, merged on the card."""
    import torch
    from druid_tpu_torch.engine import engines, sorted_reduce as sr
    from druid_tpu_torch.parallel import use_mesh
    from druid_tpu_torch.engine.executor import apply_interval_chunking
    from druid_tpu_torch.query.model import (GroupByQuery, TimeseriesQuery,
                                             query_from_json)
    query = apply_interval_chunking(query_from_json(q))
    finish = engines.finish_groupby if isinstance(query, GroupByQuery) \
        else engines.finish_timeseries if isinstance(query, TimeseriesQuery) \
        else engines.finish_topn
    from druid_tpu_torch.engine import megakernel as mk
    part, fin = [], []
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    for _ in range(reps):
        t = time.perf_counter()
        with use_mesh(mesh):
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


def same_rows(a, b, rel=1e-9):
    """Rows equal; a float sum (the mixed strategy's atomics add in no fixed
    order) within `rel` of its magnitude."""
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
        and bool(np.all(np.abs(sa - sb) <= rel * np.abs(sa)))


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


# ---------------------------------------------------------------------------
# phase 15: the native surface (run after phase 8, on its segments)
# ---------------------------------------------------------------------------

NATIVE_WARM = 3                      # warm runs a query (p50 of 3)
N1_MIN_ROWS, N1_LSUM, N1_LIMIT = 200, (1_000_000, 50_000_000), 5000
SCAN_LIMIT, SCAN_BATCH = 10_000, 4096
SCAN_COLUMNS = ["__time", "dimA", "dimB", "metLong", "metFloat"]
SELECT_PAGE = 1000
HEADLINE_B = 2                       # segments re-labelled as headline_b


def relabelled(segments, n=HEADLINE_B):
    """The first n segments' arrays as the datasource headline_b
    (segment_from_arrays: the same numpy arrays, no copy)."""
    from druid_tpu_torch.data.convert import segment_from_arrays
    return [segment_from_arrays(
        s.time_ms, {k: (c.ids, c.dictionary.values)
                    for k, c in s.dims.items()},
        {k: (m.type.value, m.values) for k, m in s.metrics.items()},
        "headline_b", (s.interval.start, s.interval.end), s.id.version,
        s.id.partition) for s in segments[:n]]


def native_queries(qs, segments):
    """N1-N12 as Druid JSON; N8 is two queries, its second page resuming
    after the first page's last offset in segment 0."""
    gb, filtered = qs["groupby"], qs["groupby_filtered"]
    iv = gb["intervals"]

    def field(name):
        return {"type": "fieldAccess", "fieldName": name}
    scan = {"queryType": "scan", "dataSource": "bench", "intervals": iv,
            "columns": SCAN_COLUMNS, "limit": SCAN_LIMIT,
            "batchSize": SCAN_BATCH, "filter": filtered["filter"]}
    select = {"queryType": "select", "dataSource": "bench", "intervals": iv,
              "dimensions": ["dimA", "dimB"], "metrics": ["metLong"],
              "pagingSpec": {"threshold": SELECT_PAGE}}
    return {
        "n1_having": dict(gb, having={"type": "and", "havingSpecs": [
            {"type": "greaterThan", "aggregation": "rows",
             "value": N1_MIN_ROWS},
            {"type": "filter", "filter": {
                "type": "bound", "dimension": "lsum",
                "lower": str(N1_LSUM[0]), "upper": str(N1_LSUM[1]),
                "ordering": "numeric"}}]},
            limitSpec={"type": "default", "limit": N1_LIMIT, "columns": [
                {"dimension": "lsum", "direction": "descending",
                 "dimensionOrder": "numeric"}, "dimA", "dimB"]}),
        "n2_subtotals": dict(gb, subtotalsSpec=[["dimA"], ["dimB"], []]),
        "n3_nested": {
            "queryType": "groupBy",
            "dataSource": {"type": "query", "query": gb}, "intervals": iv,
            "granularity": "all", "dimensions": ["dimA"],
            "aggregations": [{"type": "count", "name": "groups"},
                             {"type": "longSum", "name": "lsum",
                              "fieldName": "lsum"}]},
        "n4_by_segment": dict(gb, context={"bySegment": True}),
        "n5_greatest_least": dict(filtered, postAggregations=[
            {"type": "doubleGreatest", "name": "g",
             "fields": [field("lsum"), field("fmax")]},
            {"type": "longLeast", "name": "l",
             "fields": [field("rows"), field("lsum")]}]),
        "n6_chunked": dict(qs["timeseries"],
                           context={"chunkPeriod": "PT6H"}),
        "n6_union": dict(gb, dataSource={
            "type": "union", "dataSources": ["bench", "headline_b"]}),
        "n7_scan_asc": dict(scan, order="ascending"),
        "n7_scan_desc": dict(scan, order="descending"),
        "n8_select_page1": select,
        "n8_select_page2": dict(select, pagingSpec={
            "threshold": SELECT_PAGE,
            "pagingIdentifiers": {str(segments[0].id): SELECT_PAGE - 1}}),
        "n9_search": {"queryType": "search", "dataSource": "bench",
                      "intervals": iv, "searchDimensions": ["dimA", "dimB"],
                      "query": {"type": "contains", "value": "7"}},
        "n10_time_boundary": {"queryType": "timeBoundary",
                              "dataSource": "bench", "intervals": iv,
                              "filter": filtered["filter"]},
        "n11_segment_metadata": {
            "queryType": "segmentMetadata", "dataSource": "bench",
            "intervals": iv, "merge": True,
            "analysisTypes": ["cardinality", "size", "interval", "minmax"]},
        "n12_datasource_metadata": {"queryType": "dataSourceMetadata",
                                    "dataSource": "bench"},
    }


#: (B1, B2) launches per run; every other query launches neither
NATIVE_LAUNCHES = {"n1_having": (SEGMENTS, 0),
                   "n2_subtotals": (SEGMENTS, 0),
                   "n3_nested": (SEGMENTS, 0),
                   "n4_by_segment": (SEGMENTS, 0),
                   "n5_greatest_least": (0, SEGMENTS),
                   "n6_union": (SEGMENTS + HEADLINE_B, 0)}


def filtered_rows(s, head):
    """The filtered groupBy's filter over one segment, in numpy: dimA even
    (`in` half its values), dimB not its head, 100 <= metLong <= 9900."""
    ml = s.metrics["metLong"].values
    return ((s.dims["dimA"].ids % 2) == 0) & (s.dims["dimB"].ids != head) \
        & (ml >= 100) & (ml <= 9900)


def segment_groupby(s):
    """The headline groupBy over one segment, in numpy: (cnt, lsum, fmax)
    by group dimA * 1000 + dimB."""
    G = 100 * 1000
    ml = s.metrics["metLong"].values
    keep = (ml >= 100) & (ml <= 9900)
    key = (s.dims["dimA"].ids.astype(np.int64) * 1000
           + s.dims["dimB"].ids)[keep]
    fmax = np.full(G, -np.inf, np.float32)
    np.maximum.at(fmax, key, s.metrics["metFloat"].values[keep])
    return {"cnt": np.bincount(key, minlength=G),
            "lsum": np.bincount(key, weights=ml[keep].astype(np.float64),
                                minlength=G).astype(np.int64),
            "fmax": fmax}


def native_reference(segments, ref):
    """numpy results for N1-N12 beyond the main path's: headline_b's two
    segments grouped alone, the filtered rows of the first and the last
    segment, the filtered time bounds, dimA/dimB value counts, and the
    columns' extremes."""
    head = dimb_head(segments)
    out = {"per_segment": [segment_groupby(s) for s in segments[:HEADLINE_B]],
           "cnt_a": np.zeros(100, np.int64), "cnt_b": np.zeros(1000, np.int64)}
    lo = hi = None
    for i, s in enumerate(segments):
        m = filtered_rows(s, head)
        ids = np.flatnonzero(m)
        if i == 0:
            out["asc_ids"] = ids[:SCAN_LIMIT]
        if i == len(segments) - 1:
            out["desc_ids"] = ids[::-1][:SCAN_LIMIT]
        if len(ids):
            t = s.time_ms[ids]
            lo = int(t.min()) if lo is None else min(lo, int(t.min()))
            hi = int(t.max()) if hi is None else max(hi, int(t.max()))
        out["cnt_a"] += np.bincount(s.dims["dimA"].ids, minlength=100)
        out["cnt_b"] += np.bincount(s.dims["dimB"].ids, minlength=1000)
    out["time_bounds"] = (lo, hi)
    out["extremes"] = {c: (min(s.metrics[c].values.min().item()
                               for s in segments),
                           max(s.metrics[c].values.max().item()
                               for s in segments))
                       for c in ("metLong", "metFloat")}
    union = {k: ref[k] + sum(p[k] for p in out["per_segment"])
             for k in ("cnt", "lsum")}
    union["fmax"] = np.maximum.reduce(
        [ref["fmax"]] + [p["fmax"] for p in out["per_segment"]])
    out["union"] = union
    return out


def _groups(rows):
    """{group: (rows, lsum, fmax)} of headline groupBy rows."""
    return {int(r["event"]["dimA"][1:]) * 1000 + int(r["event"]["dimB"][1:]):
            (r["event"]["rows"], r["event"]["lsum"],
             np.float32(r["event"]["fmax"])) for r in rows}


def check_n1(rows, ref, nref, segments):
    cnt, lsum, fmax = ref["cnt"], ref["lsum"], ref["fmax"]
    sel = np.flatnonzero((cnt > N1_MIN_ROWS) & (lsum >= N1_LSUM[0])
                         & (lsum <= N1_LSUM[1]))
    order = sel[np.lexsort((sel % 1000, sel // 1000, -lsum[sel]))]
    want = [(int(g), int(cnt[g]), int(lsum[g]), fmax[g])
            for g in order[:N1_LIMIT]]
    got = [(int(r["event"]["dimA"][1:]) * 1000 + int(r["event"]["dimB"][1:]),
            r["event"]["rows"], r["event"]["lsum"],
            np.float32(r["event"]["fmax"])) for r in rows]
    if got != want:
        raise AssertionError(f"N1: {len(got)} rows differ from numpy's "
                             f"{len(want)}")


def check_n2(rows, ref, nref, segments):
    cnt, lsum, fmax = ref["cnt"], ref["lsum"], ref["fmax"]
    n_live = int((cnt > 0).sum())
    check_groupby(rows[:n_live], ref)
    c2, l2, f2 = (x.reshape(100, 1000) for x in (cnt, lsum, fmax))
    want = [({"dimA": f"v{a:08d}"}, c2[a].sum(), l2[a].sum(), f2[a].max())
            for a in range(100) if c2[a].sum()]
    want += [({"dimB": f"v{b:08d}"}, c2[:, b].sum(), l2[:, b].sum(),
              f2[:, b].max()) for b in range(1000) if c2[:, b].sum()]
    want.append(({}, cnt.sum(), lsum.sum(), fmax.max()))
    got = [({k: v for k, v in r["event"].items() if k in ("dimA", "dimB")},
            r["event"]["rows"], r["event"]["lsum"],
            np.float32(r["event"]["fmax"])) for r in rows[n_live:]]
    if [(k, int(c), int(s), np.float32(f)) for k, c, s, f in want] != got:
        raise AssertionError(f"N2: {len(got)} subtotal rows differ from "
                             f"numpy's {len(want)}")


def check_n3(rows, ref, nref, segments):
    c2, l2 = ref["cnt"].reshape(100, 1000), ref["lsum"].reshape(100, 1000)
    want = {f"v{a:08d}": (int((c2[a] > 0).sum()), int(l2[a].sum()))
            for a in range(100) if c2[a].sum()}
    got = {r["event"]["dimA"]: (r["event"]["groups"], r["event"]["lsum"])
           for r in rows}
    if got != want or len(rows) != len(want):
        raise AssertionError("N3: the nested groupBy differs from numpy")


def check_n4(rows, ref, nref, segments):
    if [r["result"]["segment"] for r in rows] != \
            [str(s.id) for s in segments] \
            or not all(r["bySegment"] for r in rows):
        raise AssertionError("N4: not one entry per segment")
    G = len(ref["cnt"])
    cnt, lsum = np.zeros(G, np.int64), np.zeros(G, np.int64)
    fmax = np.full(G, -np.inf, np.float32)
    for i, r in enumerate(rows):
        g = _groups(r["result"]["results"])
        ks = np.fromiter(g, np.int64, len(g))
        vals = list(g.values())
        c = np.asarray([v[0] for v in vals], np.int64)
        s_ = np.asarray([v[1] for v in vals], np.int64)
        f = np.asarray([v[2] for v in vals], np.float32)
        cnt[ks] += c
        lsum[ks] += s_
        fmax[ks] = np.maximum(fmax[ks], f)
        if i < HEADLINE_B:
            p = nref["per_segment"][i]
            live = np.flatnonzero(p["cnt"])
            if not (np.array_equal(np.sort(ks), live)
                    and np.array_equal(c, p["cnt"][ks])
                    and np.array_equal(s_, p["lsum"][ks])
                    and np.array_equal(f, p["fmax"][ks])):
                raise AssertionError(f"N4: segment {i} differs from numpy")
    if not (np.array_equal(cnt, ref["cnt"]) and np.array_equal(lsum,
                                                              ref["lsum"])
            and np.array_equal(fmax, ref["fmax"])):
        raise AssertionError("N4: the segments' results do not add up to "
                             "numpy's")


def check_n5(rows, ref, nref, segments):
    check_filtered(rows, ref)
    for r in rows:
        e = r["event"]
        if e["g"] != max(float(e["lsum"]), float(e["fmax"])) \
                or e["l"] != min(float(e["rows"]), float(e["lsum"])):
            raise AssertionError(f"N5: greatest/least of {e}")


def check_n6_union(rows, ref, nref, segments):
    check_groupby(rows, nref["union"])


def _check_scan(rows, seg, ids, tag):
    events = [e for b in rows for e in b["events"]]
    sizes = [len(b["events"]) for b in rows]
    want_sizes = [SCAN_BATCH] * (SCAN_LIMIT // SCAN_BATCH) \
        + [SCAN_LIMIT % SCAN_BATCH]
    vals = {c: np.asarray(seg.dims[c].dictionary.values)[seg.dims[c].ids[ids]]
            for c in ("dimA", "dimB")}
    want = [{"__time": t, "dimA": a, "dimB": b, "metLong": m, "metFloat": f}
            for t, a, b, m, f in zip(
                seg.time_ms[ids].tolist(), vals["dimA"].tolist(),
                vals["dimB"].tolist(),
                seg.metrics["metLong"].values[ids].tolist(),
                seg.metrics["metFloat"].values[ids].tolist())]
    if sizes != want_sizes or events != want \
            or {b["segmentId"] for b in rows} != {str(seg.id)}:
        raise AssertionError(f"{tag}: the scan's rows differ from numpy "
                             f"(batches {sizes})")


def check_n7_asc(rows, ref, nref, segments):
    _check_scan(rows, segments[0], nref["asc_ids"], "N7 ascending")


def check_n7_desc(rows, ref, nref, segments):
    _check_scan(rows, segments[-1], nref["desc_ids"], "N7 descending")


def _check_select(rows, segments, page):
    seg = segments[0]
    ids = np.arange(page * SELECT_PAGE, (page + 1) * SELECT_PAGE)
    vals = {c: np.asarray(seg.dims[c].dictionary.values)[seg.dims[c].ids[ids]]
            for c in ("dimA", "dimB")}
    want = [{"segmentId": str(seg.id), "offset": int(i), "event": {
        "__time": t, "dimA": a, "dimB": b, "metLong": m}}
        for i, t, a, b, m in zip(ids, seg.time_ms[ids].tolist(),
                                 vals["dimA"].tolist(), vals["dimB"].tolist(),
                                 seg.metrics["metLong"].values[ids].tolist())]
    res = rows[0]["result"]
    if res["events"] != want or res["pagingIdentifiers"] != {
            str(seg.id): int(ids[-1])}:
        raise AssertionError(f"N8: page {page + 1} differs from numpy")


def check_n8_select_page1(rows, ref, nref, segments):
    _check_select(rows, segments, 0)


def check_n8_select_page2(rows, ref, nref, segments):
    _check_select(rows, segments, 1)


def check_n9(rows, ref, nref, segments):
    want = [{"dimension": d, "value": f"v{i:08d}", "count": int(c)}
            for d, cnt in (("dimA", nref["cnt_a"]), ("dimB", nref["cnt_b"]))
            for i, c in enumerate(cnt) if c and "7" in f"v{i:08d}"]
    want.sort(key=lambda e: (e["value"], e["dimension"]))
    if rows != [{"timestamp": segments[0].interval.start,
                 "result": want[:1000]}]:
        raise AssertionError("N9: search counts differ from numpy")


def check_n10(rows, ref, nref, segments):
    lo, hi = nref["time_bounds"]
    if rows != [{"timestamp": lo, "result": {"minTime": lo,
                                             "maxTime": hi}}]:
        raise AssertionError(f"N10: {rows} != numpy ({lo}, {hi})")


def check_n11(rows, ref, nref, segments):
    (m,) = rows
    cols = m["columns"]
    ext = nref["extremes"]
    ok = (m["numRows"] == ROWS
          and m["size"] == sum(s.size_bytes() for s in segments)
          and m["intervals"] == sorted({str(s.interval) for s in segments})
          and cols["dimA"]["cardinality"] == 100
          and cols["dimB"]["cardinality"] == 1000
          and cols["__time"]["minValue"] == min(s.min_time for s in segments)
          and cols["__time"]["maxValue"] == max(s.max_time for s in segments)
          and all((cols[c]["minValue"], cols[c]["maxValue"]) == ext[c]
                  for c in ext)
          and cols["metLong"]["type"] == "LONG"
          and cols["metFloat"]["type"] == "FLOAT")
    if not ok:
        raise AssertionError(f"N11: {m} differs from numpy")


def check_n12(rows, ref, nref, segments):
    mx = max(s.max_time for s in segments)
    if rows != [{"timestamp": mx, "result": {"maxIngestedEventTime": mx}}]:
        raise AssertionError(f"N12: {rows}")


NATIVE_CHECKS = {
    "n1_having": check_n1, "n2_subtotals": check_n2,
    "n3_nested": check_n3, "n4_by_segment": check_n4,
    "n5_greatest_least": check_n5,
    "n6_chunked": lambda rows, ref, nref, segs: check_timeseries(rows, ref),
    "n6_union": check_n6_union, "n7_scan_asc": check_n7_asc,
    "n7_scan_desc": check_n7_desc,
    "n8_select_page1": check_n8_select_page1,
    "n8_select_page2": check_n8_select_page2, "n9_search": check_n9,
    "n10_time_boundary": check_n10, "n11_segment_metadata": check_n11,
    "n12_datasource_metadata": check_n12}


def native_split(name, q, segments, extra, dev, ex):
    """split_times for the aggregate queries (one run: N2's finish alone
    takes seconds): N3 as its inner groupBy's split plus the subquery
    segment and the outer query; N4 as the sum over its eight per-segment
    partials and finishes."""
    import torch
    from druid_tpu_torch.engine import engines, executor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.query.model import query_from_json
    if name == "n3_nested":
        inner = q["dataSource"]["query"]
        out = split_times(inner, segments, dev, reps=1)
        saved = (sr.LAUNCHES, mk.LAUNCHES)
        rows = ex.run_json(inner)
        t = time.perf_counter()
        seg = executor.subquery_segment(query_from_json(inner), rows)
        out["subquery_segment_ms"] = (time.perf_counter() - t) * 1e3
        out["subquery_rows"] = seg.n_rows
        t = time.perf_counter()
        ex.run(query_from_json(q), [seg])
        torch.cuda.synchronize()
        out["outer_ms"] = (time.perf_counter() - t) * 1e3
        sr.LAUNCHES, mk.LAUNCHES = saved
        return out
    if name == "n4_by_segment":
        saved = (sr.LAUNCHES, mk.LAUNCHES)
        query = query_from_json(dict(q, context={}))
        part = fin = 0.0
        for s in segments:
            t = time.perf_counter()
            ap = engines.make_aggregate_partials(query, [s], dev)
            torch.cuda.synchronize()
            part += time.perf_counter() - t
            t = time.perf_counter()
            engines.finish_groupby(query, ap)
            fin += time.perf_counter() - t
        sr.LAUNCHES, mk.LAUNCHES = saved
        return {"partials_ms": part * 1e3, "finish_ms": fin * 1e3}
    if name in ("n6_union",):
        return split_times(q, segments + extra, dev, reps=1)
    if name in ("n1_having", "n2_subtotals", "n5_greatest_least",
                "n6_chunked"):
        return split_times(q, segments, dev, reps=1)
    return {}


def phase_native(dev, segments, qs, ref):
    """N1-N12 over the 8 headline segments (and headline_b, two of them
    re-labelled): each query's JSON round-trips through to_json, runs cold
    and NATIVE_WARM times warm with its B1/B2 launches counted per run, and
    its rows (cold and last warm) hold against numpy; N7 also through
    run_streaming. Returns (results, (B1, B2) launches of the phase's
    runs)."""
    import torch
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.query.model import query_from_json
    t_phase = time.perf_counter()
    t = time.perf_counter()
    nref = native_reference(segments, ref)
    extra = relabelled(segments)
    out = {"oracle_s": time.perf_counter() - t}
    log(f"  numpy results for N1-N12: {out['oracle_s']:.1f} s")
    nqs = native_queries(qs, segments)
    ex = QueryExecutor(segments + extra, device=dev)
    base = (sr.LAUNCHES, mk.LAUNCHES)
    sr.LAUNCHES = mk.LAUNCHES = 0
    for name, q in nqs.items():
        query = query_from_json(q)
        if query_from_json(query.to_json()) != query:
            raise AssertionError(f"{name}: does not round-trip through "
                                 f"to_json")
        want = NATIVE_LAUNCHES.get(name, (0, 0))
        times = []
        for i in range(1 + NATIVE_WARM):
            before = (sr.LAUNCHES, mk.LAUNCHES)
            t = time.perf_counter()
            rows = ex.run(query)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            got = (sr.LAUNCHES - before[0], mk.LAUNCHES - before[1])
            if got != want:
                raise AssertionError(f"{name}: run {i} launched (B1, B2) "
                                     f"{got} times, expected {want}")
            if i in (0, NATIVE_WARM):
                NATIVE_CHECKS[name](rows, ref, nref, segments)
        if name.startswith("n7_"):
            if list(ex.run_streaming(query)) != rows:
                raise AssertionError(f"{name}: run_streaming differs")
        warm = [x * 1e3 for x in times[1:]]
        res = {"cold_s": times[0], "warm_ms": warm,
               "p50_ms": float(np.median(warm)), "result_rows": len(rows),
               "b1_launches_per_run": want[0],
               "b2_launches_per_run": want[1]}
        res.update(native_split(name, q, segments, extra, dev, ex))
        if name in ("n9_search", "n10_time_boundary"):
            # the card's share of the warm query: every kernel's device
            # time (torch.profiler), against the bytes the masks read once
            # (dimA and dimB ids, metLong and the time offsets: 16 B/row)
            by = device_split(lambda: ex.run(query), reps=1, top=100)
            res["device_ms"] = sum(by.values())
            res["device_top"] = dict(list(by.items())[:4])
            res["mask_bound_ms"] = sum(x.n_rows for x in segments) * 16 \
                / HBM_BYTES_PER_S * 1e3
        out[name] = res
        split = "".join(f", {k} {v:.3f}" for k, v in res.items()
                        if k.endswith("_ms") and k not in ("p50_ms", "warm_ms"))
        log(f"  {name}: ok, cold {times[0]:.2f} s, warm p50 "
            f"{res['p50_ms']:.1f} ms{split}, (B1, B2) launches/run {want}, "
            f"{len(rows)} rows")
    launches = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    del ex, extra
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase native surface took {out['phase_s']:.1f} s; B1 launched "
        f"{launches['B1']}, B2 {launches['B2']} times in its runs")
    return out, launches


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


# ---------------------------------------------------------------------------
# phase 10: code-domain aggregation over run tables
# ---------------------------------------------------------------------------

RUN_SEGMENTS = 8
HOUR_SEGMENTS = 2                    # the hour-ordered shape: 2 of the 8


class PartialLog:
    """Records, while active, each segment partial's strategy
    (`run_grouped_aggregate`, called by the engines and for batching's
    stragglers): "runDomain" for a segment served in
    run space, which never reaches `fuse_filter_update`; and, for those,
    the segment and the run partition its tables are cached under."""

    def __enter__(self):
        from druid_tpu_torch.engine import batching, engines
        # a segment runs alone from the engines or as a batching straggler
        self.mods = (engines, batching)
        self.orig = engines.run_grouped_aggregate
        self.strategies, self.run_tables = [], []
        orig = self.orig

        def run(*a, **k):
            p = orig(*a, **k)
            self.strategies.append(p.spec.strategy)
            plan = (p.spec._cascade_run_plan or (None,))[0]
            if plan is not None:
                self.run_tables.append((p.segment, (plan[2], plan[3])))
            return p
        for mod in self.mods:
            mod.run_grouped_aggregate = run
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.run_grouped_aggregate = self.orig


def rundomain_segments():
    """The headline schema in the rollup order (RUN_SEGMENTS segments of
    ROWS // SEGMENTS rows, seed SEED) with a LONG column `cnt` of ones (a
    count metric before rollup), and HOUR_SEGMENTS of them re-ordered by
    (hour bucket, dimA, dimB), the order rollup at queryGranularity hour
    writes."""
    from druid_tpu_torch.data.segment import (NumericColumn, Segment,
                                              StringDimColumn, ValueType)
    segs = headline_segments(RUN_SEGMENTS, sort_by_dims=True)
    for s in segs:
        s.metrics["cnt"] = NumericColumn(np.ones(s.n_rows, dtype=np.int64),
                                         ValueType.LONG)
    t0 = segs[0].interval.start
    hourly = []
    for s in segs[:HOUR_SEGMENTS]:
        o = np.lexsort((s.dims["dimB"].ids, s.dims["dimA"].ids,
                        (s.time_ms - t0) // 3_600_000))
        hourly.append(Segment(
            s.id, s.time_ms[o],
            {n: StringDimColumn(c.ids[o], c.dictionary)
             for n, c in s.dims.items()},
            {n: NumericColumn(m.values[o], m.type)
             for n, m in s.metrics.items()}))
    return segs, hourly


def rundomain_queries(segments):
    iv = f"{DAY[0]}/{DAY[1]}"
    dim_a = list(segments[0].dims["dimA"].dictionary.values)
    aggs = [{"type": "count", "name": "rows"},
            {"type": "longSum", "name": "c", "fieldName": "cnt"}]
    return {
        "timeseries_all": {
            "queryType": "timeseries", "dataSource": "bench",
            "intervals": [iv], "granularity": "all", "aggregations": aggs,
            "filter": {"type": "in", "dimension": "dimA",
                       "values": dim_a[0:100:2]}},
        "timeseries_filtered": {
            "queryType": "timeseries", "dataSource": "bench",
            "intervals": [iv], "granularity": "all", "aggregations": [
                aggs[0],
                {"type": "filtered", "aggregator": aggs[1], "filter": {
                    "type": "in", "dimension": "dimA",
                    "values": dim_a[0:100:2]}},
                {"type": "filtered", "aggregator": {
                    "type": "count", "name": "fc"}, "filter": {
                    "type": "in", "dimension": "dimA",
                    "values": dim_a[:30]}}]},
        "topn_dima": {
            "queryType": "topN", "dataSource": "bench", "intervals": [iv],
            "granularity": "all", "dimension": "dimA", "metric": "rows",
            "threshold": 10, "aggregations": aggs},
        "groupby_hourly": {
            "queryType": "groupBy", "dataSource": "bench", "intervals": [iv],
            "granularity": "hour", "dimensions": ["dimA"],
            "aggregations": aggs},
        "groupby_ab_count": {
            "queryType": "groupBy", "dataSource": "bench", "intervals": [iv],
            "granularity": "all", "dimensions": ["dimA", "dimB"],
            "aggregations": aggs[:1]}}


def rundomain_reference(segments, hourly):
    """numpy: rows per dimA, per (dimA, dimB), and per (hour, dimA) over the
    hour-ordered segments."""
    t0 = segments[0].interval.start
    a_cnt = np.zeros(100, np.int64)
    ab = np.zeros(100 * 1000, np.int64)
    for s in segments:
        a = s.dims["dimA"].ids.astype(np.int64)
        a_cnt += np.bincount(a, minlength=100)
        ab += np.bincount(a * 1000 + s.dims["dimB"].ids, minlength=100_000)
    ha = np.zeros(24 * 100, np.int64)
    for s in hourly:
        h = (s.time_ms - t0) // 3_600_000
        ha += np.bincount(h * 100 + s.dims["dimA"].ids, minlength=2400)
    return {"a_cnt": a_cnt, "ab": ab, "ha": ha, "t0": t0}


def check_rundomain(name, rows, ref):
    if name == "timeseries_all":
        want = int(ref["a_cnt"][0::2].sum())
        if len(rows) != 1 or (rows[0]["result"]["rows"],
                              rows[0]["result"]["c"]) != (want, want):
            raise AssertionError(f"{name}: {rows} != {want}")
    elif name == "timeseries_filtered":
        v = rows[0]["result"] if len(rows) == 1 else {}
        want = {"rows": int(ref["a_cnt"].sum()),
                "c": int(ref["a_cnt"][0::2].sum()),
                "fc": int(ref["a_cnt"][:30].sum())}
        if v != want:
            raise AssertionError(f"{name}: {rows} != {want}")
    elif name == "topn_dima":
        order = np.argsort(-ref["a_cnt"], kind="stable")[:10]
        got = [(int(x["dimA"][1:]), x["rows"], x["c"])
               for x in rows[0]["result"]]
        want = [(int(a), int(ref["a_cnt"][a]), int(ref["a_cnt"][a]))
                for a in order]
        if got != want:
            raise AssertionError(f"{name}: {got} != numpy {want}")
    elif name == "groupby_hourly":
        live = np.flatnonzero(ref["ha"])
        got = sorted(((r["timestamp"] - ref["t0"]) // 3_600_000 * 100
                      + int(r["event"]["dimA"][1:]), r["event"]["rows"],
                      r["event"]["c"]) for r in rows)
        want = [(int(g), int(ref["ha"][g]), int(ref["ha"][g]))
                for g in live]
        if got != want:
            raise AssertionError(f"{name}: rows differ from numpy")
    else:
        live = np.flatnonzero(ref["ab"])
        got = sorted((int(r["event"]["dimA"][1:]) * 1000
                      + int(r["event"]["dimB"][1:]), r["event"]["rows"])
                     for r in rows)
        if got != [(int(g), int(ref["ab"][g])) for g in live]:
            raise AssertionError(f"{name}: rows differ from numpy")


def joint_runs(seg, cols):
    """numpy: the run count of the joint partition over `cols`."""
    change = np.zeros(seg.n_rows - 1, dtype=bool)
    for c in cols:
        v = seg.dims[c].ids
        change |= v[1:] != v[:-1]
    return 1 + int(np.count_nonzero(change))


def run_table_mb(run_tables):
    """MB (min, max) over segments of the run tables a query read: the
    entries cached under its run partition."""
    mb = [sum(int(v.nbytes) for k, v in seg.device_entries().items()
              if k[0] == "rundom" and k[1] == part) / 1e6
          for seg, part in run_tables]
    return [min(mb), max(mb)] if mb else None


def run_query_path(ex, name, q, segments, dev, ref):
    """One query's cold run, 5 warm runs and split_times on the current
    path: rows checked against numpy each time; strategies per segment,
    code-domain hits, blocks staged and B1/B2 launches recorded."""
    import torch
    from druid_tpu_torch.data import cascade
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    stats = cascade.code_domain_stats()
    h0, l0 = stats.snapshot()["hits"], (sr.LAUNCHES, mk.LAUNCHES)
    t = time.perf_counter()
    with PartialLog() as plog, BlockLog() as blog:
        rows = ex.run_json(q)
        torch.cuda.synchronize()
    cold = time.perf_counter() - t
    hits = stats.snapshot()["hits"] - h0
    launches = (sr.LAUNCHES - l0[0], mk.LAUNCHES - l0[1])
    check_rundomain(name, rows, ref)
    warm = []
    for _ in range(5):
        t = time.perf_counter()
        rows = ex.run_json(q)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    check_rundomain(name, rows, ref)
    blocks = blog.summary()
    return {"strategies": plog.strategies, "code_domain_hits": hits,
            "run_table_mb": run_table_mb(plog.run_tables),
            "b1_b2_launches": launches, "cold_s": cold, "warm_ms": warm,
            "p50_ms": float(np.median(warm)),
            "block_mb": blocks.get("resident_mb"),
            "block": blocks.get("encodings"),
            "rows": json.dumps(rows), **split_times(q, segments, dev)}


def check_run_leaves(segments, q, dev):
    """The filtered groupBy's bitmap leaves on the card, per segment: the
    staged fill's run-table words and the run-built mega leaves equal the
    row-built words bit for bit, and so do the combined words."""
    import torch
    from druid_tpu_torch.engine import filters as F
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.query.filters import filter_from_json
    out = []
    for seg in segments:
        padded = seg.padded_rows()
        kinds = []
        for node in F.collect_bitmap_nodes(F.plan_filter(
                filter_from_json(q["filter"]), seg, device_bitmap=True)):
            for dim, lut in node.leaves:
                row = F.leaf_words(seg, dim, lut, padded, dev)
                payload = F._run_leaf_payload(seg, dim, lut, padded)
                if payload is not None:
                    staged = F.runs_leaf_words(
                        torch.from_numpy(payload).to(dev), padded)
                    if not torch.equal(staged, row):
                        raise AssertionError(f"{dim}: run-leaf words differ")
                mega = mk.mega_leaf_words(seg, dim, lut, padded, dev)
                if not torch.equal(mega, row):
                    raise AssertionError(f"{dim}: mega leaf words differ")
                kinds.append((dim, "runs" if payload is not None else "rows",
                              mega is not row))
            filled = F._fill_single(seg, node, padded, dev)
            rows_built = F.structure_words(node.structure, [
                F.leaf_words(seg, d, lut, padded, dev)
                for d, lut in node.leaves].__getitem__)
            if not torch.equal(filled, rows_built):
                raise AssertionError("combined words differ")
        if not any(k == "runs" for _, k, _ in kinds):
            raise AssertionError(f"no leaf staged from run tables: {kinds}")
        out.append(kinds)
    return out


def phase_rundomain(dev):
    """Code-domain aggregation at full width: the queries over run tables
    where the rule holds, against numpy and against the row program; the
    run-table filter leaves against the row-built words."""
    import torch
    from druid_tpu_torch.data import cascade
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import rundomain
    from druid_tpu_torch.engine import sorted_reduce as sr
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    t = time.perf_counter()
    segments, hourly = rundomain_segments()
    gen_s = time.perf_counter() - t
    ref = rundomain_reference(segments, hourly)
    qs = rundomain_queries(segments)
    ab_runs = [joint_runs(s, ("dimA", "dimB")) for s in segments]
    log(f"  generated {RUN_SEGMENTS} rollup-order segments of "
        f"{ROWS // SEGMENTS} rows (+ {HOUR_SEGMENTS} hour-ordered) in "
        f"{gen_s:.1f} s; joint (dimA, dimB) runs per segment {ab_runs}")
    out = {"gen_s": gen_s, "ab_joint_runs": ab_runs}
    for name, q in qs.items():
        segs = hourly if name == "groupby_hourly" else segments
        if name == "groupby_ab_count":
            expect = ["runDomain" if nr <= rundomain.CASCADE_MAX_RUNS and
                      nr * cascade.RUN_DOMAIN_MIN_ROWS_PER_RUN <= s.n_rows
                      else None for nr, s in zip(ab_runs, segs)]
        else:
            expect = ["runDomain"] * len(segs)
        ex = QueryExecutor(segs, device=dev)
        on = run_query_path(ex, name, q, segs, dev, ref)
        if name == "groupby_ab_count":
            planned = [rundomain.joint_partition(s, ("dimA", "dimB"))[2]
                       for s in segs]
            if planned != ab_runs:
                raise AssertionError(f"{name}: the planner's joint runs "
                                     f"{planned} != numpy {ab_runs}")
        got = [st if st == "runDomain" else None for st in on["strategies"]]
        if got != expect or on["code_domain_hits"] != expect.count(
                "runDomain"):
            raise AssertionError(f"{name}: paths {on['strategies']} "
                                 f"({on['code_domain_hits']} hits), "
                                 f"expected {expect}")
        if "runDomain" in expect and on["b1_b2_launches"] != (0, 0):
            raise AssertionError(f"{name}: run domain launched (B1, B2) "
                                 f"{on['b1_b2_launches']}")
        prev = cascade.set_run_domain_enabled(False)
        try:
            off = run_query_path(ex, name, q, segs, dev, ref)
        finally:
            cascade.set_run_domain_enabled(prev)
        if "runDomain" in off["strategies"] or off["code_domain_hits"]:
            raise AssertionError(f"{name}: run domain off still ran it")
        if off["rows"] != on["rows"]:
            raise AssertionError(f"{name}: row program rows differ")
        if "cnt" in (off["block"] or {}):
            raise AssertionError(f"{name}: the constant cnt was staged")
        del on["rows"], off["rows"]
        out[name] = {"run_domain": on, "row_program": off}
        log(f"  {name}: on {len(segs)} segments, paths {on['strategies']}; "
            f"run tables {on['run_table_mb']} MB/segment, block "
            f"{on['block_mb']} MB/segment; cold "
            f"{on['cold_s']:.3f} s, warm p50 {on['p50_ms']:.2f} ms, "
            f"partials {on['partials_ms']:.2f} ms, merge+finish "
            f"{on['finish_ms']:.2f} ms. Row program: "
            f"{sorted(set(off['strategies']))}, block "
            f"{off['block_mb']} MB/segment {off['block']}; cold "
            f"{off['cold_s']:.3f} s, warm p50 {off['p50_ms']:.2f} ms, "
            f"partials {off['partials_ms']:.2f} ms, merge+finish "
            f"{off['finish_ms']:.2f} ms; same rows")
    # the filtered groupBy's bitmap leaves from run tables: words equal on
    # the card, and the query through them (staged fill, then fused) holds
    # against numpy
    sub = segments[:SORTED_SEGMENTS]
    fq = queries(sub)["groupby_filtered"]
    leaves = check_run_leaves(sub, fq, dev)
    fref = numpy_reference(sub)
    for mega in (True, False):    # fused first: staged words would be kept
        prev = mk.set_enabled(mega)
        try:
            check_filtered(QueryExecutor(sub, device=dev).run_json(fq), fref)
        finally:
            mk.set_enabled(prev)
    out["filter_leaves"] = leaves
    log(f"  filtered groupBy leaves on {len(sub)} segments (dim, staged "
        f"form, mega leaf run-built): {leaves[0]}; run-table and run-built "
        f"words = row-built words; rows = numpy with megakernel off and on")
    sr.LAUNCHES, mk.LAUNCHES = saved  # not the B1/B2 main path
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 12: expressions (virtual columns, string and expression filters,
# extraction and expression dimensions)
# ---------------------------------------------------------------------------

#: X3 and X4 run on 2 of the 8 headline segments: their cold runs (the
#: expression dimension's host np.unique, X4's own projection argsort) would
#: otherwise add more than 2 minutes to the phase (reduced)
EXPR_SMALL_SEGMENTS = 2
VF = {"type": "expression", "name": "vf",
      "expression": "metFloat * 2 + metLong", "outputType": "float"}
VD = {"type": "expression", "name": "vd", "expression": "metLong * 0.01",
      "outputType": "double"}
#: query -> (segments it runs on, strategy per segment, (B1, B2) per run)
EXPR_PLAN = {"x1": (SEGMENTS, "projection", (SEGMENTS, 0)),
             "x2": (SEGMENTS, "megakernel", (0, SEGMENTS)),
             "x3": (EXPR_SMALL_SEGMENTS, "mm", (0, 0)),
             "x4": (EXPR_SMALL_SEGMENTS, "windowed", (0, 0))}


def expression_queries(segments):
    iv = f"{DAY[0]}/{DAY[1]}"
    base = queries(segments)["groupby"]
    dim_a = list(segments[0].dims["dimA"].dictionary.values)
    x1 = dict(base, virtualColumns=[VF], aggregations=[
        {"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "floatMax", "name": "vfmax", "fieldName": "vf"}])
    x2 = dict(base, filter={"type": "and", "fields": [
        {"type": "in", "dimension": "dimA", "values": dim_a[:50]},
        {"type": "regex", "dimension": "dimB", "pattern": "[13579]$"},
        {"type": "expression", "expression": "metLong % 10 < 7"}]})
    x3 = {"queryType": "topN", "dataSource": "bench", "intervals": [iv],
          "granularity": "all", "metric": "lsum", "threshold": 10,
          "dimension": {"type": "extraction", "dimension": "dimB",
                        "outputName": "b8", "extractionFn": {
                            "type": "substring", "index": 0, "length": 8}},
          "aggregations": [{"type": "longSum", "name": "lsum",
                            "fieldName": "metLong"}],
          "filter": {"type": "search", "dimension": "dimA",
                     "query": {"type": "contains", "value": "5"}}}
    x4 = {"queryType": "groupBy", "dataSource": "bench", "intervals": [iv],
          "granularity": "all", "virtualColumns": [VD],
          "dimensions": [{"type": "expression", "outputName": "e",
                          "expression": "div(metLong, 100)",
                          "outputType": "long"}, "dimA"],
          "aggregations": [{"type": "count", "name": "rows"},
                           {"type": "doubleSum", "name": "dsum",
                            "fieldName": "vd"}],
          "filter": {"type": "not", "field": {
              "type": "columnComparison", "dimensions": ["dimA", "dimB"]}}}
    return {"x1": x1, "x2": x2, "x3": x3, "x4": x4}


def expression_reference(segments):
    """Independent numpy results for X1-X4: each expression, extraction and
    predicate evaluated in numpy over the host arrays."""
    import re
    G = 100 * 1000
    out = {k: np.zeros(G, np.int64) for k in ("x1_cnt", "x2_cnt")}
    out.update(x1_lsum=np.zeros(G, np.float64),
               x1_vfmax=np.full(G, -np.inf, np.float32),
               x2_lsum=np.zeros(G, np.float64),
               x2_fmax=np.full(G, -np.inf, np.float32),
               x3_lsum=np.zeros(100, np.float64),
               x4_cnt=np.zeros(101 * 100, np.int64),
               x4_dsum=np.zeros(101 * 100, np.float64))
    rx = re.compile("[13579]$")
    b_vals = segments[0].dims["dimB"].dictionary.values
    b_odd = np.asarray([rx.search(v) is not None for v in b_vals])
    a_vals = segments[0].dims["dimA"].dictionary.values
    a_five = np.asarray(["5" in v.lower() for v in a_vals])
    live = 0
    for i, s in enumerate(segments):
        a = s.dims["dimA"].ids.astype(np.int64)
        b = s.dims["dimB"].ids.astype(np.int64)
        ml = s.metrics["metLong"].values
        mf = s.metrics["metFloat"].values
        keep = (ml >= 100) & (ml <= 9900)
        key = (a * 1000 + b)[keep]
        vf = mf * np.float32(2) + ml.astype(np.float32)
        out["x1_cnt"] += np.bincount(key, minlength=G)
        out["x1_lsum"] += np.bincount(
            key, weights=ml[keep].astype(np.float64), minlength=G)
        np.maximum.at(out["x1_vfmax"], key, vf[keep])
        k2 = (a < 50) & b_odd[b] & (ml % 10 < 7)
        live += int(k2.sum())
        key = a[k2] * 1000 + b[k2]
        out["x2_cnt"] += np.bincount(key, minlength=G)
        out["x2_lsum"] += np.bincount(
            key, weights=ml[k2].astype(np.float64), minlength=G)
        np.maximum.at(out["x2_fmax"], key, mf[k2])
        if i < EXPR_SMALL_SEGMENTS:
            k3 = a_five[a]
            out["x3_lsum"] += np.bincount(
                b[k3] // 10, weights=ml[k3].astype(np.float64),
                minlength=100)
            k4 = a != b                  # dimA and dimB share value names
            g = (ml[k4] // 100) * 100 + a[k4]
            out["x4_cnt"] += np.bincount(g, minlength=101 * 100)
            out["x4_dsum"] += np.bincount(g, weights=ml[k4] * 0.01,
                                          minlength=101 * 100)
    for k in ("x1_lsum", "x2_lsum", "x3_lsum"):
        out[k] = out[k].astype(np.int64)
    out["x2_live_share"] = live / sum(s.n_rows for s in segments)
    return out


def check_x1(rows, ref):
    live = np.flatnonzero(ref["x1_cnt"])
    if len(rows) != len(live):
        raise AssertionError(f"x1: {len(rows)} rows, numpy {len(live)}")
    worst = 0.0
    for r in rows:
        e = r["event"]
        g = int(e["dimA"][1:]) * 1000 + int(e["dimB"][1:])
        want = float(ref["x1_vfmax"][g])
        rel = abs(e["vfmax"] - want) / max(abs(want), 1e-30)
        worst = max(worst, rel)
        if (e["rows"], e["lsum"]) != (int(ref["x1_cnt"][g]),
                                      int(ref["x1_lsum"][g])) or rel > 1e-6:
            raise AssertionError(f"x1 row {e} != numpy group {g}")
    return worst


def check_x2(rows, ref):
    live = np.flatnonzero(ref["x2_cnt"])
    if len(rows) != len(live):
        raise AssertionError(f"x2: {len(rows)} rows, numpy {len(live)}")
    for r in rows:
        e = r["event"]
        g = int(e["dimA"][1:]) * 1000 + int(e["dimB"][1:])
        if (e["rows"], e["lsum"]) != (int(ref["x2_cnt"][g]),
                                      int(ref["x2_lsum"][g])) \
                or np.float32(e["fmax"]) != ref["x2_fmax"][g]:
            raise AssertionError(f"x2 row {e} != numpy group {g}")
    return 0.0


def check_x3(rows, ref):
    lsum = ref["x3_lsum"]
    order = np.argsort(-lsum, kind="stable")[:10]
    want = [(f"v{int(p):07d}", int(lsum[p])) for p in order]
    got = [(x["b8"], x["lsum"]) for x in rows[0]["result"]]
    if got != want:
        raise AssertionError(f"x3: {got} != numpy {want}")
    return 0.0


def check_x4(rows, ref):
    live = np.flatnonzero(ref["x4_cnt"])
    if len(rows) != len(live):
        raise AssertionError(f"x4: {len(rows)} rows, numpy {len(live)}")
    worst = 0.0
    for r in rows:
        e = r["event"]
        g = int(e["e"]) * 100 + int(e["dimA"][1:])
        want = float(ref["x4_dsum"][g])
        rel = abs(e["dsum"] - want) / max(abs(want), 1e-30)
        worst = max(worst, rel)
        if e["rows"] != int(ref["x4_cnt"][g]) or rel > 1e-9:
            raise AssertionError(f"x4 row {e} != numpy group {g}")
    return worst


def vc_eval_ms(view, segment):
    """Device ms of X1's virtual column over segment 0's permuted block,
    as the path runs it (its packed input decoded first), and over decoded
    inputs alone; and the computed column's dtype."""
    from druid_tpu_torch.data import cascade
    from druid_tpu_torch.engine import grouping as gr
    from druid_tpu_torch.query.model import virtualcolumn_from_json
    plans, luts = gr.plan_virtual_columns(
        segment, [virtualcolumn_from_json(VF)])
    t0 = segment.interval.start
    staged = {k: view.staged[k] for k in ("__valid", "__time_offset",
                                         "metLong", "metFloat")}
    dense = {k: view[k] for k in staged}
    out = gr.eval_virtual_columns(dict(dense), t0, plans, luts)
    return {"with_decode_ms": cuda_ms(lambda: gr.eval_virtual_columns(
                cascade.DecodedView(staged), t0, plans, luts), 10),
            "decoded_inputs_ms": cuda_ms(lambda: gr.eval_virtual_columns(
                dict(dense), t0, plans, luts), 10),
            "dtype": str(out["vf"].dtype), "rows": int(out["vf"].shape[0])}


def query_device_split(q, segment, dev):
    """torch.profiler's device ms of one warm run of `q` over `segment`:
    the total and the largest kernels by name."""
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    ex = QueryExecutor([segment], device=dev)
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    by = device_split(lambda: ex.run_json(q), reps=3, top=200)
    sr.LAUNCHES, mk.LAUNCHES = saved  # measurement, not the path
    top = dict(sorted(by.items(), key=lambda kv: -kv[1])[:6])
    return {"device_ms": sum(by.values()), "top": top}


def phase_expressions(dev, segments):
    """X1-X4 on fresh headline segments, each against numpy, with its
    strategy per segment, cold time, warm p50 of 5 and split_times; B1's
    and B2's first calls held against their plain versions. Returns (report,
    {"B1": launches, "B2": launches}, {"B1": max_abs_err, "B2": ...})."""
    import torch
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    t = time.perf_counter()
    ref = expression_reference(segments)
    log(f"  numpy reference {time.perf_counter() - t:.1f} s; X2's live row "
        f"share {ref['x2_live_share']:.4f}")
    qs = expression_queries(segments)
    checks = {"x1": check_x1, "x2": check_x2, "x3": check_x3,
              "x4": check_x4}
    out = {"x2_live_share": ref["x2_live_share"]}
    errs = {"B1": 0.0, "B2": 0.0}
    sr.LAUNCHES = mk.LAUNCHES = 0
    for name, q in qs.items():
        n_seg, want_strategy, want = EXPR_PLAN[name]
        segs = segments[:n_seg]
        ex = QueryExecutor(segs, device=dev)
        before = (sr.LAUNCHES, mk.LAUNCHES)
        t = time.perf_counter()
        with Capture(sr, "sorted_reduce") as cap1, \
                Capture(mk, "mega_reduce_cuda") as cap2, \
                StrategyLog() as slog, BlockLog() as blog:
            rows = ex.run_json(q)
            torch.cuda.synchronize()
        cold = time.perf_counter() - t
        delta = (sr.LAUNCHES - before[0], mk.LAUNCHES - before[1])
        worst = checks[name](rows, ref)
        log(f"  {name}: strategy per segment {slog.strategies}")
        if slog.names() != [want_strategy] * n_seg:
            raise AssertionError(f"{name}: strategies {slog.strategies}, "
                                 f"expected {want_strategy} x {n_seg}")
        if delta != want or (len(cap1.spans), len(cap2.spans)) != want:
            raise AssertionError(f"{name}: (B1, B2) launched {delta}, "
                                 f"expected {want}")
        res = {"segments": n_seg, "cold_s": cold, "strategies":
               slog.strategies, "result_rows": len(rows),
               "b1_b2_launches_per_run": delta, "max_rel_err": worst,
               "block": blog.summary()}
        if name == "x1":
            view, m_in, key, ks, G, span, pcs = cap1.first
            vf = view.staged.get("vf")
            read = sr.packed_fields(value_fields(view, ks), pcs,
                                    sr.plan_window(span)[0], key.shape[0])
            if not torch.is_tensor(vf) or vf.dtype != torch.float32 \
                    or "vf" in read \
                    or getattr(read.get("metLong"), "width", 0) != 16:
                raise AssertionError(f"x1: B1 reads {read}; vf staged as "
                                     f"{type(vf).__name__}")
            errs["B1"], _ = check_b1("x1", view, m_in, key, ks, G, span,
                                     pcs)
            res["vc_eval_segment0"] = vc_eval_ms(view, segs[0])
            res["b1_reads_words"] = {f: repr(pc) for f, pc in read.items()}
            log(f"  x1: B1 reads {res['b1_reads_words']} as words, vf dense "
                f"float32; vf on segment 0: "
                f"{res['vc_eval_segment0']['with_decode_ms']:.4f} ms "
                f"(metLong decoded first) / "
                f"{res['vc_eval_segment0']['decoded_inputs_ms']:.4f} ms "
                f"(decoded inputs), device time, "
                f"{res['vc_eval_segment0']['rows']} rows")
        if name == "x2":
            view, words, key, ks, G, span, pcs = cap2.first
            errs["B2"], _ = check_b2("x2", view, words, key, ks, G, span,
                                     pcs)
        warm = []
        for _ in range(5):
            before = (sr.LAUNCHES, mk.LAUNCHES)
            t = time.perf_counter()
            rows = ex.run_json(q)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t) * 1e3)
            got = (sr.LAUNCHES - before[0], mk.LAUNCHES - before[1])
            if got != want:
                raise AssertionError(f"{name}: warm run launched (B1, B2) "
                                     f"{got}, expected {want}")
        checks[name](rows, ref)
        split = split_times(q, segs, dev)
        res.update(warm_ms=warm, p50_ms=float(np.median(warm)), **split)
        out[name] = res
        log(f"  {name}: ok on {n_seg} segments, {len(rows)} rows, cold "
            f"{cold:.2f} s, warm p50 {res['p50_ms']:.1f} ms, (B1, B2) "
            f"launches/run {delta}; partials {split['partials_ms']:.1f} "
            f"ms, merge+finish {split['finish_ms']:.1f} ms; max rel err "
            f"{worst:.3g}")
    launches = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    out["launches"] = launches
    # where X1's and X2's extra partials time goes: device time by kernel
    # on segment 0, beside the headline groupBy and the filtered groupBy
    base = queries(segments)
    for name, q in (("x1", qs["x1"]), ("groupby", base["groupby"]),
                    ("x2", qs["x2"]),
                    ("groupby_filtered", base["groupby_filtered"])):
        sp = query_device_split(q, segments[0], dev)
        out[f"device_split_{name}"] = sp
        log(f"  {name} on segment 0: device {sp['device_ms']:.3f} ms a "
            f"run (torch.profiler); largest: " + ", ".join(
                f"{k[:60]} {v:.3f}" for k, v in sp["top"].items()))
    torch.cuda.synchronize()
    return out, launches, errs


# ---------------------------------------------------------------------------
# phase 13: the first/last, filtered and HLL aggregators
# ---------------------------------------------------------------------------

#: A5 rolls up this many of the headline segments by (dimA, dimB): ~100,000
#: rows a segment, each a 2^12-register HLL of metLong (~410 MB of int8
#: registers a segment; reduced from 8 segments to keep the phase short)
ROLLUP_SEGMENTS = 2
HLL_LOG2M = 12
U64 = (1 << 64) - 1


def np_splitmix64(x):
    """splitmix64 over numpy uint64 (wrapping)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def np_hash_strings(values):
    """FNV-1a over each string's UTF-8 bytes, then splitmix64."""
    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        h = 0xCBF29CE484222325
        for byte in v.encode("utf-8"):
            h = ((h ^ byte) * 0x100000001B3) & U64
        out[i] = h
    return np_splitmix64(out)


def np_register_table(hashes, log2m):
    """(register, rho) per uint64 hash: the low log2m bits pick the
    register; rho is 1 + the leading zeros of the other 64 - log2m bits
    (Python's bit_length, one hash at a time: tables only)."""
    width = 64 - log2m
    reg = np.empty(len(hashes), np.int64)
    rho = np.empty(len(hashes), np.int64)
    for i, h in enumerate(int(x) for x in hashes):
        reg[i] = h & ((1 << log2m) - 1)
        rest = h >> log2m
        rho[i] = width - rest.bit_length() + 1 if rest else width + 1
    return reg, rho


def np_estimate(regs, log2m):
    """The HLL estimate of each row of a [G, m] register grid, with the
    small-range (linear counting) and large-range corrections."""
    m = 1 << log2m
    alpha = 0.7213 / (1 + 1.079 / m)
    raw = alpha * m * m / np.power(2.0, -regs.astype(np.float64)).sum(-1)
    zeros = (regs == 0).sum(-1)
    with np.errstate(divide="ignore"):
        lin = np.where(zeros > 0, m * np.log(m / np.maximum(zeros, 1)), raw)
    out = np.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)
    two64 = 2.0 ** 64
    return np.where(out > two64 / 30.0,
                    -two64 * np.log1p(-out / two64), out)


def np_registers(groups, reg, rho, n_groups, log2m):
    """[n_groups, m] registers: the max rho of each (group, register)."""
    regs = np.zeros((n_groups, 1 << log2m), np.int32)
    np.maximum.at(regs, (groups, reg), rho)
    return regs


def rollup_segments(segments):
    """The (dimA, dimB) rollup of each segment (port Segments built here):
    one row per present pair at the segment's first instant, `cnt` its row
    count and `uu` the int8 HLL registers (log2m HLL_LOG2M) of its metLong
    values."""
    from druid_tpu_torch.data.segment import (ComplexColumn, NumericColumn,
                                              Segment, SegmentId,
                                              StringDimColumn, ValueType)
    m = 1 << HLL_LOG2M
    reg_v, rho_v = np_register_table(
        np_splitmix64(np.arange(10_001, dtype=np.uint64)), HLL_LOG2M)
    out = []
    for s in segments:
        a = s.dims["dimA"].ids.astype(np.int64)
        g = a * 1000 + s.dims["dimB"].ids
        cnt = np.bincount(g, minlength=100_000)
        live = np.flatnonzero(cnt)
        row_of = np.full(100_000, -1, np.int64)
        row_of[live] = np.arange(live.size)
        v = s.metrics["metLong"].values
        regs = np.zeros(live.size * m, np.int8)
        np.maximum.at(regs, row_of[g] * m + reg_v[v], rho_v[v].astype(
            np.int8))
        out.append(Segment(
            SegmentId("rolled", s.interval, "v1", s.id.partition),
            np.full(live.size, s.min_time, np.int64),
            {"dimA": StringDimColumn((live // 1000).astype(np.int32),
                                     s.dims["dimA"].dictionary),
             "dimB": StringDimColumn((live % 1000).astype(np.int32),
                                     s.dims["dimB"].dictionary)},
            {"cnt": NumericColumn(cnt[live].astype(np.int64),
                                  ValueType.LONG),
             "uu": ComplexColumn(regs.reshape(live.size, m),
                                 "hyperUnique")}))
    return out


def aggregator_queries(segments):
    iv = f"{DAY[0]}/{DAY[1]}"
    dim_a = list(segments[0].dims["dimA"].dictionary.values)
    head = segments[0].dims["dimB"].dictionary.values[dimb_head(segments)]
    in_a = {"type": "in", "dimension": "dimA", "values": dim_a[:50]}
    a1 = {"queryType": "timeseries", "dataSource": "bench",
          "intervals": [iv], "granularity": "hour", "aggregations": [
              {"type": "count", "name": "rows"},
              {"type": "filtered", "filter": in_a, "aggregator": {
                  "type": "count", "name": "fc"}},
              {"type": "filtered", "aggregator": {
                  "type": "longSum", "name": "fs", "fieldName": "metLong"},
               "filter": {"type": "not", "field": {
                   "type": "selector", "dimension": "dimB",
                   "value": head}}},
              {"type": "filtered", "aggregator": {
                  "type": "longMax", "name": "fm", "fieldName": "metLong"},
               "filter": {"type": "in", "dimension": "dimA",
                          "values": dim_a[25:75]}}]}
    a2 = {"queryType": "groupBy", "dataSource": "bench", "intervals": [iv],
          "granularity": "all", "dimensions": ["dimA"], "aggregations": [
              {"type": "count", "name": "rows"},
              {"type": "hyperUnique", "name": "u", "fieldName": "dimB",
               "log2m": HLL_LOG2M}]}
    a3 = {"queryType": "timeseries", "dataSource": "bench",
          "intervals": [iv], "granularity": "hour", "aggregations": [
              {"type": "count", "name": "rows"},
              {"type": "cardinality", "name": "ab",
               "fields": ["dimA", "dimB"], "byRow": True, "round": True},
              {"type": "cardinality", "name": "ml",
               "fields": ["metLong"]}]}
    a4 = {"queryType": "groupBy", "dataSource": "bench", "intervals": [iv],
          "granularity": "hour", "dimensions": ["dimA"], "aggregations": [
              {"type": "longFirst", "name": "lf", "fieldName": "metLong"},
              {"type": "longLast", "name": "ll", "fieldName": "metLong"},
              {"type": "floatLast", "name": "fl", "fieldName": "metFloat"}]}
    a5 = {"queryType": "groupBy", "dataSource": "rolled", "intervals": [iv],
          "granularity": "all", "dimensions": ["dimA"], "aggregations": [
              {"type": "longSum", "name": "n", "fieldName": "cnt"},
              {"type": "hyperUnique", "name": "u", "fieldName": "uu",
               "log2m": HLL_LOG2M}]}
    return {"a1": a1, "a2": a2, "a3": a3, "a4": a4, "a5": a5}


def aggregator_reference(segments):
    """Independent numpy results for A1-A5: counts and sums by bincount,
    registers from each query's (group, value) presence and the hash tables
    above, first/last from per-segment sorts."""
    t0 = segments[0].interval.start
    head = dimb_head(segments)
    a_vals = segments[0].dims["dimA"].dictionary.values
    b_vals = segments[0].dims["dimB"].dictionary.values
    h_a, h_b = np_hash_strings(a_vals), np_hash_strings(b_vals)
    reg_b, rho_b = np_register_table(h_b, HLL_LOG2M)
    with np.errstate(over="ignore"):
        h_ab = np_splitmix64(h_a[:, None] * np.uint64(31)
                             + h_b[None, :]).reshape(-1)
    reg_ab, rho_ab = np_register_table(h_ab, 11)
    h_v = np_splitmix64(np.arange(10_001, dtype=np.uint64))
    reg_v11, rho_v11 = np_register_table(h_v, 11)
    reg_v12, rho_v12 = np_register_table(h_v, HLL_LOG2M)
    r = {k: np.zeros(24, np.int64) for k in ("rows", "fc", "fs")}
    r["fm"] = np.full(24, np.iinfo(np.int64).min, np.int64)
    ab = np.zeros(100 * 1000, np.int64)
    h_pair = np.zeros(24 * 100_000, np.int64)
    h_val = np.zeros(24 * 10_001, np.int64)
    a_val = np.zeros(100 * 10_001, np.int64)
    first = {}
    for i, s in enumerate(segments):
        a = s.dims["dimA"].ids.astype(np.int64)
        b = s.dims["dimB"].ids.astype(np.int64)
        ml = s.metrics["metLong"].values
        h = (s.time_ms - t0) // 3_600_000
        r["rows"] += np.bincount(h, minlength=24)
        r["fc"] += np.bincount(h[a < 50], minlength=24)
        r["fs"] += np.bincount(h[b != head], weights=ml[b != head],
                               minlength=24).astype(np.int64)
        keep = (a >= 25) & (a < 75)
        np.maximum.at(r["fm"], h[keep], ml[keep])
        ab += np.bincount(a * 1000 + b, minlength=100_000)
        h_pair += np.bincount(h * 100_000 + a * 1000 + b,
                              minlength=24 * 100_000)
        h_val += np.bincount(h * 10_001 + ml, minlength=24 * 10_001)
        if i < ROLLUP_SEGMENTS:
            a_val += np.bincount(a * 10_001 + ml, minlength=100 * 10_001)
        # first / last per (hour, dimA): the least (time, row) and the
        # greatest time with the least row among its rows
        g = h * 100 + a
        order = np.argsort(g.astype(np.int16), kind="stable")
        gs = g[order]
        starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
        off = (s.time_ms - s.interval.start)[order]
        idx = order.astype(np.int64)
        lo = np.minimum.reduceat((off << 24) | idx, starts) & ((1 << 24) - 1)
        hi = ((1 << 24) - 1) - (np.maximum.reduceat(
            (off << 24) | (((1 << 24) - 1) - idx), starts) & ((1 << 24) - 1))
        mf = s.metrics["metFloat"].values
        for gi, i_lo, i_hi in zip(gs[starts], lo, hi):
            first[int(gi)] = (int(ml[i_lo]), int(ml[i_hi]), float(mf[i_hi]))
    live = np.flatnonzero(ab)
    r["a2_rows"] = ab.reshape(100, 1000).sum(1)
    r["a2_regs"] = np_registers(live // 1000, reg_b[live % 1000],
                                rho_b[live % 1000], 100, HLL_LOG2M)
    p = np.flatnonzero(h_pair)
    regs_ab = np_registers(p // 100_000, reg_ab[p % 100_000],
                           rho_ab[p % 100_000], 24, 11)
    r["a3_ab"] = np.rint(np_estimate(regs_ab, 11)).astype(np.int64)
    p = np.flatnonzero(h_val)
    r["a3_ml"] = np_estimate(np_registers(p // 10_001, reg_v11[p % 10_001],
                                          rho_v11[p % 10_001], 24, 11), 11)
    r["a4"] = first
    p = np.flatnonzero(a_val)
    r["a5_regs"] = np_registers(p // 10_001, reg_v12[p % 10_001],
                                rho_v12[p % 10_001], 100, HLL_LOG2M)
    r["a5_rows"] = sum(np.bincount(s.dims["dimA"].ids, minlength=100)
                       for s in segments[:ROLLUP_SEGMENTS])
    r["t0"] = t0
    return r


class MergeLog:
    """Keeps the first merge's output (`engines.merge_partials`) while
    active: the merged register grids of the HLL queries."""

    def __enter__(self):
        from druid_tpu_torch.engine import engines
        self.mod, self.orig, self.first = engines, engines.merge_partials, None
        orig = self.orig

        def merge(*a, **k):
            out = orig(*a, **k)
            if self.first is None:
                self.first = out
            return out
        engines.merge_partials = merge
        return self

    def __exit__(self, *exc):
        self.mod.merge_partials = self.orig


class HllCapture:
    """Keeps the first `HllKernel.update` call's inputs while active."""

    def __enter__(self):
        from druid_tpu_torch.engine import kernels
        self.cls, self.orig, self.first = (kernels.HllKernel,
                                           kernels.HllKernel.update, None)
        orig = self.orig

        def update(k, cols, mask, keys, num):
            if self.first is None:
                self.first = (k, cols, mask, keys, num)
            return orig(k, cols, mask, keys, num)
        kernels.HllKernel.update = update
        return self

    def __exit__(self, *exc):
        self.cls.update = self.orig


def _merged_registers(merged, name):
    """{dimA id: registers} of a merged groupBy state."""
    _, dim_vals, _, states, _ = merged
    return {int(v[1:]): states[name][i] for i, v in enumerate(dim_vals[0])}


def check_a1(rows, ref, merged=None):
    if len(rows) != 24:
        raise AssertionError(f"a1: {len(rows)} buckets")
    for i, row in enumerate(rows):
        got = tuple(row["result"][k] for k in ("rows", "fc", "fs", "fm"))
        want = tuple(int(ref[k][i]) for k in ("rows", "fc", "fs", "fm"))
        if got != want:
            raise AssertionError(f"a1 bucket {i}: {got} != numpy {want}")


def check_a2(rows, ref, merged=None):
    est = np_estimate(ref["a2_regs"], HLL_LOG2M)
    if len(rows) != 100:
        raise AssertionError(f"a2: {len(rows)} rows")
    for row in rows:
        e = row["event"]
        a = int(e["dimA"][1:])
        if (e["rows"], e["u"]) != (int(ref["a2_rows"][a]), float(est[a])):
            raise AssertionError(f"a2 {e} != numpy {est[a]}")
    if merged is not None:
        for a, regs in _merged_registers(merged, "u").items():
            if not np.array_equal(regs, ref["a2_regs"][a]):
                raise AssertionError(f"a2: registers of dimA {a} differ")


def check_a3(rows, ref, merged=None):
    if len(rows) != 24:
        raise AssertionError(f"a3: {len(rows)} buckets")
    for i, row in enumerate(rows):
        v = row["result"]
        if (v["rows"], v["ab"], v["ml"]) != (int(ref["rows"][i]),
                                             int(ref["a3_ab"][i]),
                                             float(ref["a3_ml"][i])):
            raise AssertionError(f"a3 bucket {i}: {v}")


def check_a4(rows, ref, merged=None):
    if len(rows) != len(ref["a4"]):
        raise AssertionError(f"a4: {len(rows)} rows, numpy {len(ref['a4'])}")
    for row in rows:
        e = row["event"]
        g = (row["timestamp"] - ref["t0"]) // 3_600_000 * 100 \
            + int(e["dimA"][1:])
        if (e["lf"], e["ll"], e["fl"]) != ref["a4"][g]:
            raise AssertionError(f"a4 group {g}: {e} != {ref['a4'][g]}")


def check_a5(rows, ref, merged=None):
    est = np_estimate(ref["a5_regs"], HLL_LOG2M)
    if len(rows) != 100:
        raise AssertionError(f"a5: {len(rows)} rows")
    for row in rows:
        e = row["event"]
        a = int(e["dimA"][1:])
        if (e["n"], e["u"]) != (int(ref["a5_rows"][a]), float(est[a])):
            raise AssertionError(f"a5 {e} != numpy {est[a]}")
    if merged is not None:
        for a, regs in _merged_registers(merged, "u").items():
            if not np.array_equal(regs, ref["a5_regs"][a]):
                raise AssertionError(f"a5: registers of dimA {a} differ")


#: query -> (checker, blocked-reduction kernels per segment: the reference's
#: mixed hybrid where G <= 2048, else none)
AGG_PLAN = {"a1": (check_a1, ("rows",)), "a2": (check_a2, ("rows",)),
            "a3": (check_a3, ("rows",)), "a4": (check_a4, None),
            "a5": (check_a5, ("n",))}


def run_agg_query(ex, name, q, segs, dev, ref):
    """One A-query: a cold run (rows against numpy, registers where it has
    them, strategies and blocked kernels per segment), 5 warm runs and
    split_times."""
    import torch
    check, blocked = AGG_PLAN[name]
    t = time.perf_counter()
    with StrategyLog() as slog, MergeLog() as mlog:
        rows = ex.run_json(q)
        torch.cuda.synchronize()
    cold = time.perf_counter() - t
    check(rows, ref, mlog.first)
    want = [("mixed", 0)] * len(segs)
    want_blocked = [blocked] * len(segs) if blocked else []
    if slog.strategies != want or slog.blocked != want_blocked:
        raise AssertionError(f"{name}: strategies {slog.strategies}, "
                             f"blocked {slog.blocked}")
    warm = []
    for _ in range(5):
        t = time.perf_counter()
        rows = ex.run_json(q)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    check(rows, ref)
    return {"segments": len(segs), "cold_s": cold, "warm_ms": warm,
            "p50_ms": float(np.median(warm)), "result_rows": len(rows),
            "strategies": slog.strategies, "blocked_kernels": slog.blocked,
            **split_times(q, segs, dev)}


def hll_update_time(cap):
    """A2's HLL update on segment 0 (its first HllKernel.update call):
    CUDA-event ms, torch.profiler device ms, and the bytes bound: the dimB
    ids, the mask and the keys read once, the register grid written once,
    at 3.35 TB/s."""
    k, cols, mask, keys, num = cap
    ids = cols["dimB"]
    nbytes = (ids.numel() * ids.element_size() + mask.numel()
              + keys.numel() * keys.element_size()
              + num * (1 << k.log2m) * 4)
    by = device_split(lambda: k.update(cols, mask, keys, num), reps=5,
                      top=20)
    return {"ms": cuda_ms(lambda: k.update(cols, mask, keys, num), 10),
            "device_ms": sum(by.values()), "device_by_kernel": by,
            "rows": int(mask.shape[0]), "groups": num, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def phase_aggregators(dev, segments):
    """A1-A5 on the headline segments (A5 on their rollup), each against
    numpy, with its device time by kernel on segment 0; A1 also with the
    megakernel off and with device bitmaps off. Returns (report, {"B1":
    launches, "B2": launches})."""
    import torch
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import filters as F
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    t = time.perf_counter()
    rolled = rollup_segments(segments[:ROLLUP_SEGMENTS])
    roll_s = time.perf_counter() - t
    t = time.perf_counter()
    ref = aggregator_reference(segments)
    ref_s = time.perf_counter() - t
    reg_mb = [s.metrics["uu"].values.nbytes / 1e6 for s in rolled]
    log(f"  rolled up {ROLLUP_SEGMENTS} segments in {roll_s:.1f} s "
        f"({[s.n_rows for s in rolled]} rows, {reg_mb} MB of registers); "
        f"numpy reference {ref_s:.1f} s")
    qs = aggregator_queries(segments)
    out = {"rollup_s": roll_s, "reference_s": ref_s,
           "rolled_rows": [s.n_rows for s in rolled],
           "rolled_register_mb": reg_mb}
    sr.LAUNCHES = mk.LAUNCHES = 0
    for name, q in qs.items():
        segs = rolled if name == "a5" else segments
        ex = QueryExecutor(segs, device=dev)
        hits = mk.stats().snapshot()["hits"]
        with HllCapture() as hcap:
            res = run_agg_query(ex, name, q, segs, dev, ref)
        if name == "a1":
            res["megakernel_hits"] = mk.stats().snapshot()["hits"] - hits
            if res["megakernel_hits"] < 2 * len(segs):
                raise AssertionError("a1: the filtered trees were not fused")
            for tag, setter in (("megakernel_off", mk.set_enabled),
                                ("device_bitmaps_off",
                                 F.set_device_bitmap_enabled)):
                prev = setter(False)
                try:
                    t = time.perf_counter()
                    check_a1(ex.run_json(q), ref)
                    torch.cuda.synchronize()
                    res[f"{tag}_s"] = time.perf_counter() - t
                finally:
                    setter(prev)
        if name == "a2":
            res["hll_update_segment0"] = hll_update_time(hcap.first)
            u = res["hll_update_segment0"]
            log(f"  a2: HLL update on segment 0 ({u['rows']} rows, G = "
                f"{u['groups']}): {u['ms']:.4f} ms (CUDA events), device "
                f"{u['device_ms']:.4f} ms (torch.profiler), bound "
                f"{u['bound_ms']:.4f} ms ({u['bytes']} B); by kernel "
                + ", ".join(f"{k[:50]} {v:.4f}"
                            for k, v in u["device_by_kernel"].items()))
        sp = res["device_split_segment0"] = query_device_split(q, segs[0],
                                                               dev)
        out[name] = res
        log(f"  {name} on segment 0: device {sp['device_ms']:.3f} ms a run "
            f"(torch.profiler); largest: " + ", ".join(
                f"{k[:60]} {v:.3f}" for k, v in sp["top"].items()))
        log(f"  {name}: ok on {len(segs)} segments, {res['result_rows']} "
            f"rows, strategies {sorted(set(res['strategies']))} (blocked "
            f"{sorted(set(res['blocked_kernels']))}), cold "
            f"{res['cold_s']:.2f} s, warm p50 {res['p50_ms']:.1f} ms, "
            f"partials {res['partials_ms']:.1f} ms, merge+finish "
            f"{res['finish_ms']:.1f} ms"
            + (f"; megakernel off {res['megakernel_off_s']:.2f} s, device "
               f"bitmaps off {res['device_bitmaps_off_s']:.2f} s, same rows"
               if name == "a1" else ""))
    launches = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    if any(launches.values()):
        raise AssertionError(f"aggregators launched B1/B2: {launches}")
    out["launches"] = launches
    del rolled
    torch.cuda.synchronize()
    return out, launches


# ---------------------------------------------------------------------------
# phase 14: batching and the device pool
# ---------------------------------------------------------------------------

#: the hourly hand-offs of streaming ingestion over two days (48 segments of
#: 1M rows: rung 2^20, buckets of 32 + 16) and the next hour's 3M-row
#: segment (above BATCH_MAX_SEGMENT_ROWS: a straggler), queried by a
#: two-day dashboard
BATCH_HOURS, BATCH_ROWS, BATCH_BIG_ROWS = 48, 1_000_000, 3_000_000
BATCH_IV = "2026-01-01T00:00:00.000Z/2026-01-03T01:00:00.000Z"
HOUR_MS = 3_600_000


def hourly_segments():
    """The headline schema in hourly segments, each in a random row order
    (so that the run domain refuses them)."""
    from druid_tpu_torch.data.generator import ColumnSpec, DataGenerator
    from druid_tpu_torch.data.segment import (NumericColumn, Segment,
                                              StringDimColumn)
    from druid_tpu_torch.utils.intervals import Interval
    schema = (
        ColumnSpec("dimA", "string", cardinality=100, distribution="uniform"),
        ColumnSpec("dimB", "string", cardinality=1000, distribution="zipf"),
        ColumnSpec("metLong", "long", low=0, high=10_000),
        ColumnSpec("metFloat", "float", distribution="normal", mean=100.0,
                   std=25.0),
    )
    gen = DataGenerator(schema, seed=SEED + 14)
    rng = np.random.default_rng(SEED + 14)
    start = Interval.parse(BATCH_IV).start
    out = []
    for h in range(BATCH_HOURS + 1):
        iv = Interval(start + h * HOUR_MS, start + (h + 1) * HOUR_MS)
        seg = gen.segment(BATCH_ROWS if h < BATCH_HOURS else BATCH_BIG_ROWS,
                          iv, datasource="hourly")
        perm = rng.permutation(seg.n_rows)
        out.append(Segment(
            seg.id, seg.time_ms[perm],
            {n: StringDimColumn(c.ids[perm], c.dictionary)
             for n, c in seg.dims.items()},
            {n: NumericColumn(m.values[perm], m.type)
             for n, m in seg.metrics.items()}))
    return out


def batching_queries(segments):
    dim_a = list(segments[0].dims["dimA"].dictionary.values)
    head = segments[0].dims["dimB"].dictionary.values[dimb_head(segments)]
    base = {"dataSource": "hourly", "intervals": [BATCH_IV]}
    ts = dict(base, queryType="timeseries", granularity="hour", aggregations=[
        {"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"},
        {"type": "doubleSum", "name": "dsum", "fieldName": "metFloat"}])
    topn = dict(base, queryType="topN", granularity="all", dimension="dimB",
                metric="lsum", threshold=100, aggregations=[
                    {"type": "count", "name": "rows"},
                    {"type": "longSum", "name": "lsum",
                     "fieldName": "metLong"}],
                filter={"type": "in", "dimension": "dimA",
                        "values": dim_a[0:100:2]})
    gb = dict(base, queryType="groupBy", granularity="all",
              dimensions=["dimA"], aggregations=[
                  {"type": "count", "name": "rows"},
                  {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
                  {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
                  {"type": "longFirst", "name": "lfirst",
                   "fieldName": "metLong"},
                  {"type": "filtered", "filter": {
                      "type": "selector", "dimension": "dimB", "value": head},
                   "aggregator": {"type": "count", "name": "head"}}])
    return {"B-ts": ts, "B-topN": topn, "B-gb": gb}


def batching_reference(segments):
    """numpy results of the three B-queries (and of floatSum(metFloat))."""
    t0 = segments[0].interval.start
    head = dimb_head(segments)
    H = BATCH_HOURS + 1
    r = {k: np.zeros(n, np.int64) for k, n in (
        ("h_cnt", H), ("h_lsum", H), ("tb_cnt", 1000), ("tb_lsum", 1000),
        ("a_cnt", 100), ("a_lsum", 100), ("a_head", 100))}
    r.update(h_fmax=np.full(H, -np.inf, np.float32),
             h_fsum=np.zeros(H), h_abs=np.zeros(H),
             tb_fsum=np.zeros(1000), tb_abs=np.zeros(1000),
             a_lmin=np.full(100, np.iinfo(np.int64).max),
             a_ftime=np.full(100, np.iinfo(np.int64).max),
             a_first=np.zeros(100, np.int64))
    for s in segments:
        a = s.dims["dimA"].ids.astype(np.int64)
        b = s.dims["dimB"].ids.astype(np.int64)
        ml = s.metrics["metLong"].values
        mf = s.metrics["metFloat"].values
        mf64 = mf.astype(np.float64)
        h = (s.time_ms - t0) // HOUR_MS
        r["h_cnt"] += np.bincount(h, minlength=H)
        r["h_lsum"] += np.bincount(h, weights=ml, minlength=H).astype(
            np.int64)
        for hv in range(int(h.min()), int(h.max()) + 1):
            r["h_fmax"][hv] = max(r["h_fmax"][hv], mf[h == hv].max())
        r["h_fsum"] += np.bincount(h, weights=mf64, minlength=H)
        r["h_abs"] += np.bincount(h, weights=np.abs(mf64), minlength=H)
        even = (a % 2) == 0
        r["tb_cnt"] += np.bincount(b[even], minlength=1000)
        r["tb_lsum"] += np.bincount(b[even], weights=ml[even],
                                    minlength=1000).astype(np.int64)
        r["tb_fsum"] += np.bincount(b[even], weights=mf64[even],
                                    minlength=1000)
        r["tb_abs"] += np.bincount(b[even], weights=np.abs(mf64[even]),
                                   minlength=1000)
        r["a_cnt"] += np.bincount(a, minlength=100)
        r["a_lsum"] += np.bincount(a, weights=ml, minlength=100).astype(
            np.int64)
        r["a_head"] += np.bincount(a[b == head], minlength=100)
        # per-group minima from one sort of a packed key each: (dimA,
        # metLong) for longMin; (dimA, time offset, row) for longFirst (the
        # least time, then the least row index; an earlier segment wins a
        # tie, as the partials merge in the segments' order)
        g_lmin = np.sort((a << 14) | ml)
        starts = np.searchsorted(g_lmin >> 14, np.arange(100))
        live = starts < g_lmin.shape[0]
        live[live] = (g_lmin[starts[live]] >> 14) == np.arange(100)[live]
        lmin = g_lmin[starts[live]] & ((1 << 14) - 1)
        r["a_lmin"][live] = np.minimum(r["a_lmin"][live], lmin)
        toff = s.time_ms - s.interval.start
        g_first = np.sort((a << 44) | (toff << 22)
                          | np.arange(s.n_rows, dtype=np.int64))
        starts = np.searchsorted(g_first >> 44, np.arange(100))
        live = starts < g_first.shape[0]
        live[live] = (g_first[starts[live]] >> 44) == np.arange(100)[live]
        first = g_first[starts[live]]
        t_first = ((first >> 22) & ((1 << 22) - 1)) + s.interval.start
        row = first & ((1 << 22) - 1)
        g = np.arange(100)[live]
        better = t_first < r["a_ftime"][g]
        r["a_ftime"][g[better]] = t_first[better]
        r["a_first"][g[better]] = ml[row[better]]
    r["t0"] = t0
    return r


def _check_fsum(got, want, absv, what):
    if abs(got - want) > 1e-5 * absv:
        raise AssertionError(f"{what}: float sum {got} against {want} "
                             f"(sum|v| {absv})")


def check_b_ts(rows, ref, fsum=False):
    t0, H = ref["t0"], BATCH_HOURS + 1
    if [r["timestamp"] for r in rows] != [t0 + h * HOUR_MS
                                          for h in range(H)]:
        raise AssertionError("B-ts: bucket timestamps")
    for h, r in enumerate(rows):
        v = r["result"]
        if (v["rows"], v["lsum"], v["fmax"]) != (
                int(ref["h_cnt"][h]), int(ref["h_lsum"][h]),
                float(ref["h_fmax"][h])):
            raise AssertionError(f"B-ts: hour {h}: {v}")
        _check_fsum(v["dsum"], ref["h_fsum"][h], ref["h_abs"][h],
                    f"B-ts hour {h} dsum")
        if fsum:
            _check_fsum(v["fsum"], ref["h_fsum"][h], ref["h_abs"][h],
                        f"B-ts hour {h} fsum")


def check_b_topn(rows, ref, fsum=False, segments=None):
    res = rows[0]["result"]
    vals = {v: i for i, v in enumerate(
        segments[0].dims["dimB"].dictionary.values)}
    want_top = np.sort(ref["tb_lsum"])[::-1][:100]
    if len(res) != 100 or [e["lsum"] for e in res] != want_top.tolist():
        raise AssertionError("B-topN: the top 100 sums")
    for e in res:
        i = vals[e["dimB"]]
        if (e["rows"], e["lsum"]) != (int(ref["tb_cnt"][i]),
                                      int(ref["tb_lsum"][i])):
            raise AssertionError(f"B-topN: {e}")
        if fsum:
            _check_fsum(e["fsum"], ref["tb_fsum"][i], ref["tb_abs"][i],
                        f"B-topN {e['dimB']} fsum")


def check_b_gb(rows, ref, segments=None):
    vals = {v: i for i, v in enumerate(
        segments[0].dims["dimA"].dictionary.values)}
    if len(rows) != 100:
        raise AssertionError(f"B-gb: {len(rows)} rows")
    for r in rows:
        e = r["event"]
        i = vals[e["dimA"]]
        want = (int(ref["a_cnt"][i]), int(ref["a_lsum"][i]),
                int(ref["a_lmin"][i]), int(ref["a_first"][i]),
                int(ref["a_head"][i]))
        if (e["rows"], e["lsum"], e["lmin"], e["lfirst"], e["head"]) != want:
            raise AssertionError(f"B-gb: {e} against {want}")


def float_bits(rows, name):
    """The float64 bit patterns of every `name` value in `rows`."""
    out = []
    for r in rows:
        for v in ([r["event"]] if "event" in r else
                  r["result"] if isinstance(r["result"], list)
                  else [r["result"]]):
            out.append(np.float64(v[name]).view(np.int64).item())
    return out


def pool_snapshot(tag, require_no_evictions=True):
    """Logs the device pool's counters; fails on an eviction where the
    default budget must hold the phase."""
    from druid_tpu_torch.data.devicepool import device_pool
    s = device_pool().snapshot()
    log(f"  pool after {tag}: {s.resident_bytes / 1e9:.3f} GB resident in "
        f"{s.entries} entries (budget {s.budget_bytes / 1e9:.3f} GB), hits "
        f"{s.hits}, misses {s.misses}, evictions {s.evictions} "
        f"({s.evicted_bytes / 1e9:.3f} GB)")
    if require_no_evictions and s.evictions:
        raise AssertionError(f"{tag}: {s.evictions} pool evictions at the "
                             f"default budget")
    return dataclasses.asdict(s)


def stacked_launches(q, segments, dev, K):
    """One warm stacked run of K compatible segments of `q`: the runtime
    launch calls this thread made inside the run's range and the device
    kernels they launched (matched by correlation id, copies excluded),
    from torch.profiler (a few warm-up kernels open the trace first:
    counted over the whole trace, a long process's later traces lost
    kernels; counted by device timestamp alone, kernels not of this run
    once landed in its range); the tensor ops dispatched to the card (a
    host-side count); and the run's time by CUDA events. The runs are
    measurement; they add to `batching.stats()` outside the query runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode
    from druid_tpu_torch.engine import batching, engines
    from druid_tpu_torch.query.model import query_from_json
    query = query_from_json(q)

    def chunk():
        intervals, segs, kds, _ = engines._query_plan(query, segments)
        plans = [batching._plan_for(s, k, i, intervals, query.granularity,
                                    query.aggregations, query.filter,
                                    query.virtual_columns)
                 for i, (s, k) in enumerate(zip(segs, kds))]
        bucket = max(batching._shape_buckets(
            [p for p in plans if p.eligible]), key=len)
        return bucket[:K]

    class DeviceOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(torch.is_tensor(t) and t.is_cuda
                   for t in torch.utils._pytree.tree_leaves(out)) \
                    and not func._schema.name.startswith(
                        ("aten::view", "aten::_unsafe_view", "aten::select",
                         "aten::slice", "aten::as_strided", "aten::expand",
                         "aten::unsqueeze", "aten::t", "aten::permute",
                         "aten::detach", "aten::alias", "aten::unflatten",
                         "aten::diagonal", "aten::transpose",
                         "aten::_reshape_alias", "aten::unbind")):
                self.n += 1
            return out

    batching._run_batch(chunk(), dev)          # warm: staged, built
    torch.cuda.synchronize()
    plans = chunk()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    batching._run_batch(plans, dev)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    ops = DeviceOps()
    with ops:
        batching._run_batch(chunk(), dev)
    torch.cuda.synchronize()
    plans = chunk()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1 << 20, device=dev)
        for _ in range(8):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function("stacked run"):
            batching._run_batch(plans, dev)
            torch.cuda.synchronize()
    events = prof.events()
    region = [e for e in events if e.name == "stacked run"][0]
    t0, t1 = region.time_range.start, region.time_range.end
    # the run's launch calls: this thread's, inside the run's range; its
    # kernels: the device events of those calls (one correlation id per
    # launch), so that a kernel whose device timestamp lands in the range
    # without this run having launched it is not counted
    launches = {e.id for e in events
                if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC", "cuLaunchKernelEx")
                and e.thread == region.thread
                and t0 <= e.time_range.start <= t1}
    kernels = in_range = 0
    by_kernel = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or "Memcpy" in e.name or "Memset" in e.name \
                or e.name.startswith(("aten::", "cuda", "Activity")):
            continue
        in_range += t0 <= e.time_range.start <= t1
        if e.id in launches:
            kernels += 1
            key = e.name[:300]
            by_kernel[key] = by_kernel.get(key, 0) + 1
    if launches and not kernels:
        raise AssertionError("stacked run: no device kernel carries the "
                             "correlation id of one of its launch calls")
    return {"K": K, "strategy": plans[0].spec.strategy,
            "device_kernels": kernels, "device_kernels_in_range": in_range,
            "launch_calls": len(launches), "device_ops": ops.n,
            "by_kernel": by_kernel, "ms": ms}


def run_batching_query(ex, name, q, segments, dev, check, batched):
    """A cold run and 5 warm runs (rows checked each time), split_times;
    with `batched` False the query carries {"batchSegments": false}."""
    import torch
    from druid_tpu_torch.engine import batching
    if not batched:
        q = dict(q, context={"batchSegments": False})
    s0 = batching.stats().snapshot()
    batching.stats().drain_events()
    t = time.perf_counter()
    rows = ex.run_json(q)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    check(rows)
    s1 = batching.stats().snapshot()
    events, _ = batching.stats().drain_events()
    warm = []
    for _ in range(5):
        t = time.perf_counter()
        rows = ex.run_json(q)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    check(rows)
    batching.stats().drain_events()
    return rows, {"cold_s": cold, "warm_ms": warm,
                  "p50_ms": float(np.median(warm)),
                  "dispatches": s1["batches"] - s0["batches"],
                  "segments_per_dispatch": sorted(n for n, _ in events),
                  "fill_ratio": [f for _, f in events],
                  "stragglers": s1["fallbackSegments"]
                  - s0["fallbackSegments"],
                  **split_times(q, segments, dev)}


def phase_batching(dev, extra=None):
    """B-ts, B-topN and B-gb over 48 hourly segments and a straggler,
    batched and alone, against numpy and each other; float bits, launches
    per stacked run at K = 16 and 32, and the pool under a budget of half
    B-ts's resident bytes. `extra(segments)`, when given, runs last on the
    same segments; its result is out["extra"]."""
    import torch
    from druid_tpu_torch.data.devicepool import device_pool
    from druid_tpu_torch.engine import QueryExecutor, batching
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    t = time.perf_counter()
    segments = hourly_segments()
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    ref = batching_reference(segments)
    log(f"  {len(segments)} segments ({BATCH_HOURS} x {BATCH_ROWS} rows + "
        f"{BATCH_BIG_ROWS}) generated in {gen_s:.1f} s, numpy reference "
        f"{time.perf_counter() - t:.1f} s")
    qs = batching_queries(segments)
    checks = {"B-ts": lambda rows, fs=False: check_b_ts(rows, ref, fs),
              "B-topN": lambda rows, fs=False: check_b_topn(
                  rows, ref, fs, segments),
              "B-gb": lambda rows, fs=False: check_b_gb(rows, ref, segments)}
    want_strategy = {"B-ts": "mixed", "B-topN": "mm", "B-gb": "mixed"}
    ex = QueryExecutor(segments, device=dev)
    pool = device_pool()
    out = {"segments": len(segments), "gen_s": gen_s}
    sr.LAUNCHES = mk.LAUNCHES = 0
    for name, q in qs.items():
        check = checks[name]
        r0 = pool.snapshot().resident_bytes
        with StrategyLog() as slog:
            rows_b, res_b = run_batching_query(ex, name, q, segments, dev,
                                               check, True)
        res_b["resident_bytes"] = pool.snapshot().resident_bytes - r0
        rows_a, res_a = run_batching_query(ex, name, q, segments, dev,
                                           check, False)
        if not same_rows(rows_b, rows_a):
            raise AssertionError(f"{name}: batched rows differ from alone")
        strategies = sorted(set(slog.names()))
        if res_b["dispatches"] != 2 or res_b["stragglers"] != 1 \
                or res_b["segments_per_dispatch"] != [16, 32] \
                or strategies != [want_strategy[name]]:
            raise AssertionError(f"{name}: {res_b['dispatches']} dispatches "
                                 f"of {res_b['segments_per_dispatch']}, "
                                 f"{res_b['stragglers']} stragglers, "
                                 f"strategies {strategies}")
        if res_a["dispatches"]:
            raise AssertionError(f"{name}: batched with batchSegments off")
        res = {"batched": res_b, "alone": res_a, "strategies": strategies}
        if name in ("B-ts", "B-topN"):
            # the blocked / mm float sum: two batched runs, the same bits;
            # batched against alone, reported
            fq = with_fsum(q)
            fa = ex.run_json(fq)
            fb = ex.run_json(fq)
            fo = ex.run_json(dict(fq, context={"batchSegments": False}))
            for rows in (fa, fb, fo):
                check(rows, True)
            if float_bits(fa, "fsum") != float_bits(fb, "fsum"):
                raise AssertionError(f"{name}: fsum bits differ between two "
                                     f"batched runs")
            res["fsum_bits_batched_twice_equal"] = True
            res["fsum_bits_equal_alone"] = \
                float_bits(fa, "fsum") == float_bits(fo, "fsum")
        res["launches"] = [stacked_launches(q, segments, dev, k)
                           for k in (16, 32)]
        l16, l32 = res["launches"]
        for kname in sorted(set(l16["by_kernel"]) | set(l32["by_kernel"])):
            n16 = l16["by_kernel"].get(kname, 0)
            n32 = l32["by_kernel"].get(kname, 0)
            if n16 != n32:
                log(f"    {kname[:160]}: {n16} at K = 16, {n32} at 32")
        # the run's launch calls are counted on the host, whole; a long
        # process's traces drop some kernel records (fewer device kernels
        # than launches), so kernels compare only where both are whole
        whole = all(la["device_kernels"] == la["launch_calls"]
                    for la in (l16, l32))
        if want_strategy[name] != "mm" \
                and (l16["launch_calls"] != l32["launch_calls"]
                     or whole and l16["device_kernels"]
                     != l32["device_kernels"]):
            raise AssertionError(
                f"{name}: {l16['launch_calls']} launches "
                f"({l16['device_kernels']} kernels traced) at K = 16, "
                f"{l32['launch_calls']} ({l32['device_kernels']}) at 32")
        out[name] = res
        log(f"  {name}: {strategies}, batched: cold {res_b['cold_s']:.2f} s, "
            f"warm p50 {res_b['p50_ms']:.1f} ms (partials "
            f"{res_b['partials_ms']:.1f}, merge+finish "
            f"{res_b['finish_ms']:.1f}), {res_b['dispatches']} dispatches "
            f"of {res_b['segments_per_dispatch']} segments, fill "
            f"{[round(f, 4) for f in res_b['fill_ratio']]}, "
            f"{res_b['stragglers']} straggler, "
            f"{res_b['resident_bytes'] / 1e6:.1f} MB staged; alone: cold "
            f"{res_a['cold_s']:.2f} s, warm p50 {res_a['p50_ms']:.1f} ms "
            f"(partials {res_a['partials_ms']:.1f}, merge+finish "
            f"{res_a['finish_ms']:.1f}); rows equal numpy and each other"
            + (f"; fsum bits batched twice equal, equal alone: "
               f"{res['fsum_bits_equal_alone']}" if "fsum_bits_equal_alone"
               in res else ""))
        for la in res["launches"]:
            log(f"    stacked run at K = {la['K']} ({la['strategy']}): "
                f"{la['device_kernels']} device kernels "
                f"({la['device_kernels_in_range']} by device timestamp), "
                f"{la['launch_calls']} launch calls (torch.profiler), "
                f"{la['device_ops']} tensor ops on the card; "
                f"{la['ms']:.3f} ms (CUDA events)")
    out["pool"] = pool_snapshot("phase 14's queries")

    # the pool under a budget of half B-ts's resident bytes
    budget = out["B-ts"]["batched"]["resident_bytes"] // 2
    before = pool.snapshot()
    pool.configure(budget)
    s0 = pool.snapshot()
    runs = []
    for _ in range(3):
        t = time.perf_counter()
        rows = ex.run_json(qs["B-ts"])
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
        checks["B-ts"](rows)
    s1 = pool.snapshot()
    pool.configure(None)
    ev = s1.evictions - before.evictions
    if ev <= 0 or s1.resident_bytes > budget \
            or s1.misses == s0.misses:
        raise AssertionError(f"pool sub-phase: {ev} evictions, "
                             f"{s1.resident_bytes} resident over {budget}")
    out["pool_budget"] = {"budget_bytes": budget, "runs_ms": runs,
                          "evictions_on_configure": s0.evictions
                          - before.evictions,
                          "evictions": ev,
                          "evicted_bytes": s1.evicted_bytes
                          - before.evicted_bytes,
                          "misses": s1.misses - s0.misses}
    log(f"  pool at {budget / 1e6:.1f} MB (half B-ts's): B-ts 3 runs "
        f"{[round(x, 1) for x in runs]} ms, rows unchanged; evictions "
        f"{s0.evictions - before.evictions} on configure, {ev} in all "
        f"({(s1.evicted_bytes - before.evicted_bytes) / 1e9:.3f} GB), "
        f"{s1.misses - s0.misses} "
        f"misses; default budget back: "
        f"{pool.snapshot().budget_bytes / 1e9:.3f} GB")
    launches = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched B1/B2: {launches}")
    if extra is not None:
        log("phase extensions E5 (E1 on these segments)")
        out["extra"] = extra(segments)
    del ex, segments
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 16: the extension aggregators
# ---------------------------------------------------------------------------

EXT_WARM = 3                         # warm runs a query (p50 of 3)
BLOOM_VALUES = 100                   # dimB values E4's filter is built from
THETA_SIZE = 4096
QG_LOG = math.log(1.05)              # the quantiles sketch's log(gamma)
QE = 512                             # its exponent range, +-QE
QP = 2 * QE + 1                      # its buckets a sign
QN = 2 * QP + 1                      # its buckets in all
HIST = (0.0, 200.0, 64)              # E3's approxHistogram limits, buckets


def np_bit_positions(value, m_bits, k=7):
    """A bloom filter's k bit positions of a string: md5's two 64-bit
    halves, double hashed (Kirsch-Mitzenmacher)."""
    import hashlib
    d = hashlib.md5(value.encode()).digest()
    h1 = int.from_bytes(d[:8], "big")
    h2 = int.from_bytes(d[8:], "big") | 1
    return [(h1 + i * h2) % m_bits for i in range(k)]


def np_bloom_m_bits(entries, fpp=0.01):
    return max(64, int(np.ceil(-entries * np.log(fpp) / np.log(2) ** 2)))


def np_theta_tables(values, size):
    """(bucket, fraction) per string: the hash's uint64 remainder by
    `size`, and its top 32 bits over 2^32 (at least 1e-12)."""
    h = np_hash_strings(values)
    frac = (h >> np.uint64(32)).astype(np.float64) / float(2 ** 32)
    return (h % np.uint64(size)).astype(np.int64), np.maximum(frac, 1e-12)


def np_theta_estimate(mins):
    """The min-hash estimate: invert sum(mins) / B = (1 - e^-l) / l for l
    by bisection; n = l * B (0 for an empty sketch)."""
    b = float(len(mins))
    r = float(mins.sum()) / b
    if r >= 1.0 - 1e-12:
        return 0.0
    lo, hi = 1e-9, 1e9
    for _ in range(100):
        mid = (lo + hi) / 2 if hi < 1e8 else min(lo * 2, hi)
        if (1.0 - np.exp(-mid)) / mid > r:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-9 * max(1.0, lo):
            break
    return lo * b


def np_theta_intersect(a, b):
    """Jaccard of the non-empty buckets times the union's estimate."""
    both = (a < 1.0) | (b < 1.0)
    if not both.any():
        return 0.0
    jac = float(((a == b) & both).sum()) / float(both.sum())
    return jac * np_theta_estimate(np.minimum(a, b))


def np_theta_mins(presence, btab, ftab, size):
    """[G, size] bucket minima of the ids present in each group (the state
    depends only on the (group, id) pairs); 1.0 where none landed."""
    g, ids = np.nonzero(presence)
    mins = np.ones((presence.shape[0], size))
    np.minimum.at(mins, (g, btab[ids]), ftab[ids])
    return mins


def np_quantile_bucket(x):
    """The quantiles sketch's bucket of each float64: round(log|x| /
    log gamma) half to even, clipped to +-QE, mirrored by sign; zero and
    NaN in the middle bucket."""
    with np.errstate(invalid="ignore", divide="ignore"):
        idx = np.clip(np.rint(np.log(np.maximum(np.abs(x), 1e-300))
                              / QG_LOG), -QE, QE)
    idx = np.nan_to_num(idx).astype(np.int64)
    return np.where(x > 0, QP + 1 + idx + QE,
                    np.where(x < 0, QP - 1 - idx - QE, QP))


def np_quantile_values():
    exps = np.exp(np.arange(-QE, QE + 1) * QG_LOG)
    out = np.zeros(QN)
    out[QP + 1:] = exps
    out[:QP] = -exps[::-1]
    return out


def np_sketch_quantile(counts, q):
    total = counts.sum()
    if total == 0:
        return float("nan")
    i = int(np.searchsorted(np.cumsum(counts), q * (total - 1),
                            side="right"))
    return float(np_quantile_values()[min(i, QN - 1)])


def np_hist_bucket(x, lo, hi, b):
    """trunc((x - lo) / width) clipped to the grid, NaN to bucket 0."""
    q = np.nan_to_num((x - lo) / ((hi - lo) / b), nan=0.0)
    return np.clip(np.clip(q, -1.0, float(b)).astype(np.int64), 0, b - 1)


def np_hist_quantile(counts, mn, mx, lo, hi, q):
    total = counts.sum()
    if total == 0:
        return float("nan")
    b = len(counts)
    width = (hi - lo) / b
    target = q * total
    cdf = np.concatenate([[0], np.cumsum(counts)])
    i = max(1, min(int(np.searchsorted(cdf, target, side="left")), b))
    prev, cur = cdf[i - 1], cdf[i]
    frac = 0.0 if cur == prev else (target - prev) / (cur - prev)
    return float(np.clip(lo + (i - 1 + frac) * width, mn, mx))


def _fa(name):
    return {"type": "fieldAccess", "fieldName": name}


def bloom_filter_json(segments):
    """E4's filter: a bloom filter of BLOOM_VALUES dimB values (every
    tenth of the dictionary), serialized as the bloom extension does."""
    import base64
    vals = segments[0].dims["dimB"].dictionary.values[::10][:BLOOM_VALUES]
    m = np_bloom_m_bits(BLOOM_VALUES)
    bits = np.zeros(m, np.uint8)
    for v in vals:
        bits[np_bit_positions(v, m)] = 1
    return {"type": "bloom", "dimension": "dimB", "mBits": m,
            "bloomKFilter": base64.b64encode(np.packbits(bits).tobytes())
            .decode()}, bits, vals


def e1_query(iv, ds):
    """E1: the percentile-latency panel, hourly."""
    return {"queryType": "timeseries", "dataSource": ds, "intervals": [iv],
            "granularity": "hour", "aggregations": [
                {"type": "count", "name": "rows"},
                {"type": "variance", "name": "var", "fieldName": "metFloat",
                 "estimator": "sample"},
                {"type": "quantilesDoublesSketch", "name": "qs",
                 "fieldName": "metFloat"},
                {"type": "timeMin", "name": "tmin"},
                {"type": "timeMax", "name": "tmax"}],
            "postAggregations": [
                {"type": "stddev", "name": "sd", "fieldName": "var"},
                {"type": "quantilesDoublesSketchToQuantile", "name": "p50",
                 "field": _fa("qs"), "fraction": 0.5},
                {"type": "quantilesDoublesSketchToQuantiles", "name": "ps",
                 "field": _fa("qs"), "fractions": [0.9, 0.99]}]}


def extension_queries(segments):
    iv = f"{DAY[0]}/{DAY[1]}"
    base = {"dataSource": "bench", "intervals": [iv], "granularity": "all"}

    def theta(name, flt):
        return {"type": "filtered", "name": name, "filter": flt,
                "aggregator": {"type": "thetaSketch", "name": name,
                               "fieldName": "dimB", "size": THETA_SIZE,
                               "shouldFinalize": False}}
    e2 = dict(base, queryType="groupBy", dimensions=["dimA"], aggregations=[
        {"type": "count", "name": "rows"},
        theta("lo", {"type": "bound", "dimension": "metLong",
                     "upper": "5000", "upperStrict": True,
                     "ordering": "numeric"}),
        theta("hi", {"type": "bound", "dimension": "metFloat",
                     "lower": "100", "lowerStrict": True,
                     "ordering": "numeric"}),
        {"type": "HLLSketchBuild", "name": "u", "fieldName": "dimB",
         "lgK": 12}],
        postAggregations=[
            {"type": "thetaSketchSetOp", "name": "both", "func": "INTERSECT",
             "fields": [_fa("lo"), _fa("hi")]},
            {"type": "thetaSketchEstimate", "name": "loe", "field": _fa("lo")},
            {"type": "thetaSketchEstimate", "name": "hie", "field": _fa("hi")},
            {"type": "HLLSketchToEstimate", "name": "ue", "field": _fa("u")}])
    e3 = dict(base, queryType="topN", dimension="dimA", metric="dc",
              threshold=10, aggregations=[
                  {"type": "count", "name": "rows"},
                  {"type": "distinctCount", "name": "dc", "fieldName": "dimB"},
                  {"type": "approxHistogram", "name": "h",
                   "fieldName": "metFloat", "lowerLimit": HIST[0],
                   "upperLimit": HIST[1], "numBuckets": HIST[2]}],
              postAggregations=[{"type": "quantile", "name": "h95",
                                 "field": _fa("h"), "probability": 0.95}])
    e4 = dict(base, queryType="groupBy", dimensions=["dimA"],
              filter=bloom_filter_json(segments)[0], aggregations=[
                  {"type": "count", "name": "rows"},
                  {"type": "bloom", "name": "b", "fieldName": "dimB"}])
    return {"e1": e1_query(iv, "bench"), "e2": e2, "e3": e3, "e4": e4}


def _hourly_e1(segments, t_start, n_buckets):
    """E1's numpy result over `segments`: per hour bucket from t_start,
    the row count, n / sum / sumsq (and sum|v|, sum v^2 for the bounds),
    quantile-sketch counts, and the time min and max."""
    acc = {"rows": np.zeros(n_buckets, np.int64),
           "sum": np.zeros(n_buckets), "abs": np.zeros(n_buckets),
           "sumsq": np.zeros(n_buckets),
           "qs": np.zeros((n_buckets, QN), np.int64),
           "tmin": np.full(n_buckets, np.iinfo(np.int64).max),
           "tmax": np.full(n_buckets, np.iinfo(np.int64).min)}
    for s in segments:
        h = (s.time_ms - t_start) // HOUR_MS
        x = s.metrics["metFloat"].values.astype(np.float64)
        acc["rows"] += np.bincount(h, minlength=n_buckets)
        acc["sum"] += np.bincount(h, x, n_buckets)
        acc["abs"] += np.bincount(h, np.abs(x), n_buckets)
        acc["sumsq"] += np.bincount(h, x * x, n_buckets)
        acc["qs"] += np.bincount(h * QN + np_quantile_bucket(x),
                                 minlength=n_buckets * QN).reshape(-1, QN)
        np.minimum.at(acc["tmin"], h, s.time_ms)
        np.maximum.at(acc["tmax"], h, s.time_ms)
    n = acc["rows"].astype(np.float64)
    acc["var"] = np.where(n > 0, np.maximum(
        acc["sumsq"] - acc["sum"] ** 2 / np.maximum(n, 1.0), 0.0)
        / np.maximum(n - 1.0, 1.0), 0.0)
    return acc


def extension_reference(segments):
    """Independent numpy results for E1-E4 (dictionaries shared by the
    segments, as the generator makes them)."""
    dim_a = segments[0].dims["dimA"].dictionary.values
    dim_b = segments[0].dims["dimB"].dictionary.values
    for s in segments:
        if s.dims["dimA"].dictionary.values != dim_a \
                or s.dims["dimB"].dictionary.values != dim_b:
            raise AssertionError("extensions: segments' dictionaries differ")
    ga, gb = len(dim_a), len(dim_b)
    ref = {"e1": _hourly_e1(segments, segments[0].interval.start, 24)}
    _, fbits, fvals = bloom_filter_json(segments)
    fm = len(fbits)
    passes = np.asarray([bool(fbits[np_bit_positions(v, fm)].all())
                         for v in dim_b])
    agg_m = np_bloom_m_bits(1500)
    lo_p = np.zeros((ga, gb), bool)
    hi_p = np.zeros((ga, gb), bool)
    all_p = np.zeros((ga, gb), bool)
    bl_p = np.zeros((ga, gb), bool)
    dc = np.zeros(ga, np.int64)
    rows = np.zeros(ga, np.int64)
    bl_rows = np.zeros(ga, np.int64)
    hcounts = np.zeros((ga, HIST[2]), np.int64)
    hmin = np.full(ga, np.finfo(np.float64).max)
    hmax = np.full(ga, -np.finfo(np.float64).max)
    for s in segments:
        a, b = s.dims["dimA"].ids.astype(np.int64), \
            s.dims["dimB"].ids.astype(np.int64)
        pair = a * gb + b
        ml = s.metrics["metLong"].values
        x = s.metrics["metFloat"].values.astype(np.float64)
        seg_p = np.bincount(pair, minlength=ga * gb).reshape(ga, gb) > 0
        all_p |= seg_p
        dc += seg_p.sum(1)
        rows += np.bincount(a, minlength=ga)
        lo_p |= np.bincount(pair[ml < 5000], minlength=ga * gb) \
            .reshape(ga, gb) > 0
        # metFloat > 100 compares the float32 value with 100 (exact)
        hi_p |= np.bincount(pair[s.metrics["metFloat"].values > 100],
                            minlength=ga * gb).reshape(ga, gb) > 0
        keep = passes[b]
        bl_p |= np.bincount(pair[keep], minlength=ga * gb) \
            .reshape(ga, gb) > 0
        bl_rows += np.bincount(a[keep], minlength=ga)
        hcounts += np.bincount(a * HIST[2] + np_hist_bucket(x, *HIST),
                               minlength=ga * HIST[2]).reshape(ga, -1)
        np.minimum.at(hmin, a, x)
        np.maximum.at(hmax, a, x)
    btab, ftab = np_theta_tables(dim_b, THETA_SIZE)
    reg, rho = np_register_table(np_hash_strings(dim_b), HLL_LOG2M)
    g, ids = np.nonzero(all_p)
    regs = np_registers(g, reg[ids], rho[ids], ga, HLL_LOG2M)
    ref["e2"] = {"rows": rows,
                 "lo": np_theta_mins(lo_p, btab, ftab, THETA_SIZE),
                 "hi": np_theta_mins(hi_p, btab, ftab, THETA_SIZE),
                 "u": np_estimate(regs, HLL_LOG2M)}
    ref["e3"] = {"rows": rows, "dc": dc, "counts": hcounts, "min": hmin,
                 "max": hmax}
    pos = np.asarray([np_bit_positions(v, agg_m) for v in dim_b])
    bits = np.zeros((ga, agg_m), np.uint8)
    g, ids = np.nonzero(bl_p)
    bits[g[:, None], pos[ids]] = 1
    ref["e4"] = {"rows": bl_rows, "bits": bits, "passes": int(passes.sum()),
                 "false_positives": int(passes.sum()) - len(fvals),
                 "m_bits": agg_m}
    return ref


def _close_rel(got, want, rel, what):
    if not abs(got - want) <= rel * abs(want):
        raise AssertionError(f"{what}: {got} against {want} (rel {rel})")


def check_e1(rows, want, states=None, tag="e1"):
    """Counts, quantile counts, time min/max and the quantiles exact;
    variance and stddev within 1e-9 relative; with the merged states, n
    exact and sum / sumsq within 1e-12 sum|v| and 1e-12 sum v^2."""
    live = np.flatnonzero(want["rows"])
    if len(rows) != len(live):
        raise AssertionError(f"{tag}: {len(rows)} buckets, want {len(live)}")
    for row, i in zip(rows, live):
        r = row["result"]
        c = want["qs"][i]
        exact = {"rows": int(want["rows"][i]), "tmin": int(want["tmin"][i]),
                 "tmax": int(want["tmax"][i]),
                 "p50": np_sketch_quantile(c, 0.5),
                 "ps": [np_sketch_quantile(c, q) for q in (0.9, 0.99)]}
        for k, v in exact.items():
            if r[k] != v:
                raise AssertionError(f"{tag} bucket {i}: {k} {r[k]} != {v}")
        if not np.array_equal(r["qs"].counts, c):
            raise AssertionError(f"{tag} bucket {i}: quantile counts differ")
        _close_rel(r["var"], want["var"][i], 1e-9, f"{tag} {i} var")
        _close_rel(r["sd"], np.sqrt(want["var"][i]), 1e-9, f"{tag} {i} sd")
    if states is not None:
        buckets, _, _, st, _ = states
        v = st["var"]
        idx = np.asarray(buckets, dtype=np.int64)
        if not np.array_equal(v["n"], want["rows"][idx]):
            raise AssertionError(f"{tag}: variance n differs")
        if not (np.all(np.abs(v["sum"] - want["sum"][idx])
                       <= 1e-12 * want["abs"][idx])
                and np.all(np.abs(v["sumsq"] - want["sumsq"][idx])
                           <= 1e-12 * want["sumsq"][idx])):
            raise AssertionError(f"{tag}: variance sums past the bound")


def _by_dim_a(rows):
    return {int(r["event"]["dimA"][1:]): r["event"] for r in rows}


def check_e2(rows, ref):
    want = ref["e2"]
    got = _by_dim_a(rows)
    if sorted(got) != list(np.flatnonzero(want["rows"])):
        raise AssertionError(f"e2: groups {sorted(got)[:5]}...")
    for g, ev in got.items():
        lo, hi = want["lo"][g], want["hi"][g]
        if ev["rows"] != want["rows"][g]:
            raise AssertionError(f"e2 {g}: rows")
        if not (np.array_equal(ev["lo"].mins, lo)
                and np.array_equal(ev["hi"].mins, hi)):
            raise AssertionError(f"e2 {g}: theta bucket minima differ")
        exact = {"loe": np_theta_estimate(lo), "hie": np_theta_estimate(hi),
                 "both": np_theta_intersect(lo, hi), "u": want["u"][g],
                 "ue": float(want["u"][g])}
        for k, v in exact.items():
            if ev[k] != v:
                raise AssertionError(f"e2 {g}: {k} {ev[k]} != {v}")


def check_e3(rows, ref):
    want = ref["e3"]
    order = np.argsort(-want["dc"].astype(np.float64), kind="stable")[:10]
    res = rows[0]["result"] if len(rows) == 1 else None
    if res is None or [int(e["dimA"][1:]) for e in res] != list(order):
        raise AssertionError(f"e3: top 10 {res and [e['dimA'] for e in res]}"
                             f", want ids {list(order)}")
    for e, g in zip(res, order):
        h = e["h"]
        q95 = np_hist_quantile(want["counts"][g], want["min"][g],
                               want["max"][g], HIST[0], HIST[1], 0.95)
        if not (e["dc"] == want["dc"][g] and e["rows"] == want["rows"][g]
                and np.array_equal(h.counts, want["counts"][g])
                and h.min == want["min"][g] and h.max == want["max"][g]
                and e["h95"] == q95):
            raise AssertionError(f"e3 {g}: dc {e['dc']}/{want['dc'][g]}, "
                                 f"h95 {e['h95']}/{q95}")


def check_e4(rows, ref):
    want = ref["e4"]
    got = _by_dim_a(rows)
    if sorted(got) != list(np.flatnonzero(want["rows"])):
        raise AssertionError("e4: groups differ")
    for g, ev in got.items():
        if ev["rows"] != want["rows"][g] \
                or not np.array_equal(ev["b"].bits, want["bits"][g]):
            raise AssertionError(f"e4 {g}: rows or bloom bits differ")


EXT_CHECKS = {"e1": lambda rows, ref, st=None: check_e1(rows, ref["e1"], st),
              "e2": lambda rows, ref, st=None: check_e2(rows, ref),
              "e3": lambda rows, ref, st=None: check_e3(rows, ref),
              "e4": lambda rows, ref, st=None: check_e4(rows, ref)}


class ExtCapture:
    """Keeps, while active, the first `update` call's inputs of each
    extension kernel (and HllKernel, HLLSketchBuild's) by aggregator name:
    segment 0's, since the headline segments run one at a time."""

    def __enter__(self):
        from druid_tpu_torch.engine import kernels
        from druid_tpu_torch.ext import (bloom, distinctcount, histogram,
                                         sketches, stats, time_minmax)
        self.classes = [time_minmax.TimeMinMaxKernel, stats.VarianceKernel,
                        sketches.QuantilesKernel, sketches.ThetaKernel,
                        histogram.HistogramKernel,
                        distinctcount.DistinctCountKernel, bloom.BloomKernel,
                        kernels.HllKernel]
        self.orig = {c: c.update for c in self.classes}
        self.first = {}

        def wrap(orig):
            def update(k, cols, mask, keys, num):
                self.first.setdefault(k.name, (k, cols, mask, keys, num))
                return orig(k, cols, mask, keys, num)
            return update
        for c in self.classes:
            c.update = wrap(self.orig[c])
        return self

    def __exit__(self, *exc):
        for c, f in self.orig.items():
            c.update = f


def _nbytes(state):
    if isinstance(state, tuple):
        return sum(_nbytes(s) for s in state)
    return state.numel() * state.element_size()


def ext_update_time(cap):
    """One ext update on segment 0: CUDA-event ms, torch.profiler device
    ms by kernel, and the bytes bound: the columns it reads, the mask and
    the keys read once, its state written once, at the HBM rate. Also its
    CUDA-event ms with the contended scatters' grid copies capped at 64
    (`SCATTER_CELLS` 0) and with none (one copy)."""
    from druid_tpu_torch.engine import kernels
    k, cols, mask, keys, num = cap
    saved = (kernels.SCATTER_COPIES, kernels.SCATTER_CELLS)
    copies = {}
    try:
        for tag, setting in (("copies64_ms", (64, 0)),
                             ("one_copy_ms", (1, 0))):
            kernels.SCATTER_COPIES, kernels.SCATTER_CELLS = setting
            copies[tag] = cuda_ms(lambda: k.update(cols, mask, keys, num), 5)
    finally:
        kernels.SCATTER_COPIES, kernels.SCATTER_CELLS = saved
    fields = getattr(k, "fields", None) or (getattr(k, "field", None),)
    names = {"__time_offset" if f in (None, "__time") else f for f in fields}
    nbytes = sum(cols[f].numel() * cols[f].element_size() for f in names
                 if f in cols) + mask.numel() \
        + keys.numel() * keys.element_size() \
        + _nbytes(k.update(cols, mask, keys, num))
    by = device_split(lambda: k.update(cols, mask, keys, num), reps=3,
                      top=20)
    return {"kernel": type(k).__name__, "ms": cuda_ms(
                lambda: k.update(cols, mask, keys, num), 5),
            "device_ms": sum(by.values()), "device_by_kernel": by,
            "rows": int(mask.shape[0]), "groups": num, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, **copies}


def run_ext_query(ex, name, q, segs, dev, check, timing=True):
    """One E-query: a cold run (rows and merged states against numpy, the
    strategy of every segment), EXT_WARM warm runs (rows checked after the
    last), B1/B2 launches (none) and split_times."""
    import torch
    from druid_tpu_torch.engine import batching
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    base = (sr.LAUNCHES, mk.LAUNCHES)
    before = batching.stats().snapshot()
    t = time.perf_counter()
    with StrategyLog() as slog, MergeLog() as mlog:
        rows = ex.run_json(q)
        torch.cuda.synchronize()
    cold = time.perf_counter() - t
    after = batching.stats().snapshot()
    check(rows, mlog.first)
    if slog.names() != ["mixed"] * len(segs):
        raise AssertionError(f"{name}: strategies {slog.strategies}")
    warm = []
    for _ in range(EXT_WARM):
        t = time.perf_counter()
        rows = ex.run_json(q)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    check(rows)
    launches = (sr.LAUNCHES - base[0], mk.LAUNCHES - base[1])
    if any(launches):
        raise AssertionError(f"{name}: launched (B1, B2) {launches}")
    res = {"segments": len(segs), "cold_s": cold, "warm_ms": warm,
           "p50_ms": float(np.median(warm)), "result_rows": len(rows),
           "strategies": sorted(set(slog.names())),
           "b1_b2_launches": list(launches),
           "stacked_runs": after["batches"] - before["batches"],
           "stacked_segments": after["batchedSegments"]
           - before["batchedSegments"]}
    if timing:
        res.update(split_times(q, segs, dev))
    return rows, res


def check_edge_buckets(dev):
    """The histogram's and the quantiles sketch's buckets of edge values on
    the card against numpy: NaN, +-inf, past int32, subnormal, zeros."""
    import torch
    from druid_tpu_torch.ext import histogram, sketches
    x = np.asarray([np.nan, np.inf, -np.inf, 1e14, -1e14, 3e9, -3e9, -0.5,
                    -1.0, 63.99, 64.0, 0.0, -0.0, 1e-320, -1e-320, 1e300])
    t = torch.from_numpy(x).to(dev)
    hist = histogram.bucket_of(t, 0.0, 1.0, 64).cpu().numpy()
    quant = sketches.quantile_bucket(t).cpu().numpy()
    with np.errstate(invalid="ignore"):
        want_h = np_hist_bucket(x, 0.0, 64.0, 64)
    if not (np.array_equal(hist, want_h)
            and np.array_equal(quant, np_quantile_bucket(x))):
        raise AssertionError(f"edge buckets: histogram {hist.tolist()}, "
                             f"quantiles {quant.tolist()}")
    return {"histogram": hist.tolist(), "quantiles": quant.tolist()}


def phase_extensions(dev, segments):
    """E1-E4 on the 8 headline segments, each against numpy, with each ext
    update's device time on segment 0 beside its bytes bound. Returns
    (report, {"B1": launches, "B2": launches})."""
    import torch
    import druid_tpu_torch.ext  # noqa: F401  (registers the extensions)
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    t_phase = time.perf_counter()
    ref = extension_reference(segments)
    out = {"oracle_s": time.perf_counter() - t_phase,
           "bloom_filter": {"values": BLOOM_VALUES,
                            "passing_values": ref["e4"]["passes"],
                            "false_positives": ref["e4"]["false_positives"]}}
    log(f"  numpy results for E1-E4: {out['oracle_s']:.1f} s; E4's bloom "
        f"filter passes {ref['e4']['passes']} dimB values "
        f"({ref['e4']['false_positives']} false positives)")
    out["edge_buckets"] = check_edge_buckets(dev)
    log(f"  edge buckets on the card equal numpy's: histogram "
        f"{out['edge_buckets']['histogram']}, quantiles "
        f"{out['edge_buckets']['quantiles']}")
    ex = QueryExecutor(segments, device=dev)
    base = (sr.LAUNCHES, mk.LAUNCHES)
    sr.LAUNCHES = mk.LAUNCHES = 0
    for name, q in extension_queries(segments).items():
        with ExtCapture() as cap:
            rows, res = run_ext_query(
                ex, name, q, segments, dev,
                lambda r, st=None, n=name: EXT_CHECKS[n](r, ref, st))
        res["updates_segment0"] = {
            agg: ext_update_time(c) for agg, c in cap.first.items()}
        sp = res["device_split_segment0"] = query_device_split(
            q, segments[0], dev)
        out[name] = res
        log(f"  {name}: ok on {len(segments)} segments, "
            f"{res['result_rows']} rows, strategies {res['strategies']}, "
            f"(B1, B2) launches {res['b1_b2_launches']}, cold "
            f"{res['cold_s']:.2f} s, warm p50 {res['p50_ms']:.1f} ms, "
            f"partials {res['partials_ms']:.1f} ms, merge+finish "
            f"{res['finish_ms']:.1f} ms; segment 0 alone: device "
            f"{sp['device_ms']:.3f} ms a run (torch.profiler); largest: "
            + ", ".join(f"{k[:50]} {v:.3f}" for k, v in sp["top"].items()))
        for agg, u in res["updates_segment0"].items():
            log(f"    {agg} ({u['kernel']}) on segment 0 ({u['rows']} rows, "
                f"G = {u['groups']}): {u['ms']:.3f} ms (CUDA events; "
                f"{u['copies64_ms']:.3f} with at most 64 grid copies, "
                f"{u['one_copy_ms']:.3f} with one), "
                f"device {u['device_ms']:.3f} ms, bound {u['bound_ms']:.4f} "
                f"ms ({u['bytes']} B); " + ", ".join(
                    f"{k[:40]} {v:.3f}" for k, v in
                    list(u["device_by_kernel"].items())[:3]))
    launches = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    if any(launches.values()):
        raise AssertionError(f"extensions launched B1/B2: {launches}")
    del ex
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase extensions took {out['phase_s']:.1f} s")
    return out, launches


def phase_extensions_e5(dev, segments):
    """E5: E1 over phase 14's hourly segments, batched and alone, each
    against numpy and the two against each other."""
    import druid_tpu_torch.ext  # noqa: F401  (registers the extensions)
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.utils.intervals import Interval
    t = time.perf_counter()
    iv = Interval.parse(BATCH_IV)
    want = _hourly_e1(segments, iv.start, BATCH_HOURS + 1)
    out = {"oracle_s": time.perf_counter() - t}
    q = e1_query(BATCH_IV, "hourly")
    ex = QueryExecutor(segments, device=dev)
    rows = {}
    for tag, batched in (("batched", True), ("alone", False)):
        qq = dict(q, context={"batchSegments": batched})
        rows[tag], res = run_ext_query(
            ex, f"e5 {tag}", qq, segments, dev,
            lambda r, st=None, tg=tag: check_e1(r, want, st, f"e5 {tg}"))
        if batched != (res["stacked_segments"] > 0):
            raise AssertionError(f"e5 {tag}: {res['stacked_segments']} "
                                 f"segments ran batched")
        out[tag] = res
        log(f"  e5 {tag}: ok on {len(segments)} segments, "
            f"{res['result_rows']} rows, {res['stacked_runs']} stacked runs "
            f"a query ({res['stacked_segments']} segments), cold "
            f"{res['cold_s']:.2f} s, warm p50 {res['p50_ms']:.1f} ms, "
            f"partials {res['partials_ms']:.1f} ms, merge+finish "
            f"{res['finish_ms']:.1f} ms")
    for a, b in zip(rows["batched"], rows["alone"]):
        ra, rb = a["result"], b["result"]
        for k in ("rows", "tmin", "tmax", "p50", "ps"):
            if ra[k] != rb[k]:
                raise AssertionError(f"e5: batched and alone differ in {k}")
        if not np.array_equal(ra["qs"].counts, rb["qs"].counts):
            raise AssertionError("e5: batched and alone counts differ")
        _close_rel(ra["var"], rb["var"], 1e-9, "e5 batched/alone var")
    return out


# ---------------------------------------------------------------------------
# phase 17: the in-process serving path (Broker -> InventoryView -> DataNode)
# ---------------------------------------------------------------------------

SERVING_WARM = 3                     # warm runs a query (p50 of 3)
SERVING_NODES, SERVING_REPLICAS = 3, 2


def serving_cluster(segments, dev):
    """tests/test_cluster.py's cluster fixture on the card: SERVING_NODES
    data nodes on `dev`, the segments round-robin with SERVING_REPLICAS
    replicas, announced on one InventoryView, and one Broker; no cache yet.
    Each node counts its run_partials calls. Hedging is off: every node
    shares the one card, so a hedge would only run a straggler's segments
    again on it (and add B1/B2 launches to the run)."""
    from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                         ResiliencePolicy, descriptor_for)

    class CountingNode(DataNode):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.calls = 0

        def run_partials(self, query, segment_ids, check=None):
            self.calls += 1
            return super().run_partials(query, segment_ids, check)

    view = InventoryView()
    nodes = [CountingNode(f"node{i}", device=dev)
             for i in range(SERVING_NODES)]
    for n in nodes:
        view.register(n)
    for i, s in enumerate(segments):
        for j in range(SERVING_REPLICAS):
            node = nodes[(i + j) % SERVING_NODES]
            node.load_segment(s)
            view.announce(node.name, descriptor_for(s))
    return view, nodes, Broker(
        view, device=dev,
        resilience_policy=ResiliencePolicy(hedge_enabled=False))


def serving_run(broker, q, qid):
    """One broker run of `q` under query id `qid`: (rows, ms, the trace's
    time by span name). A PartialResult fails the run."""
    import torch
    from druid_tpu_torch.cluster import PartialResult
    from druid_tpu_torch.obs import trace
    t = time.perf_counter()
    rows = broker.run_json(dict(q, context=dict(q.get("context", {}),
                                                queryId=qid)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    if isinstance(rows, PartialResult):
        raise AssertionError(f"{qid}: a partial result, missing "
                             f"{rows.missing_segments}")
    return rows, ms, trace.phase_breakdown(trace.trace_store().spans(qid))


def _failed_calls(broker):
    return broker.resilience.circuits.failures_by_server()


def phase_serving(dev, segments, qs, ref, pool_before, extras=True):
    """Phase 17 on the 8 headline segments: the four main-path queries
    through Broker.run_json against numpy and the executor, then (with
    `extras`) the segment cache, the result cache, a dead node, and the
    seven monitors; the pool may not grow past `pool_before` (phase 16's
    snapshot; None: the one after the executor's runs here). Returns
    (report, {"B1": launches, "B2": launches} of the broker's runs, kept):
    `kept` holds the three DataNodes and each query's broker rows for
    phase 18."""
    import torch
    from druid_tpu_torch.cluster import LruCache, ResilienceMetricsMonitor
    from druid_tpu_torch.data.cascade import CodeDomainMonitor
    from druid_tpu_torch.data.devicepool import (DevicePoolMonitor,
                                                 device_pool)
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.engine.batching import BatchMetricsMonitor
    from druid_tpu_torch.engine.filters import FilterBitmapMonitor
    from druid_tpu_torch.engine.megakernel import MegakernelMonitor
    from druid_tpu_torch.obs.dispatch import DispatchMonitor
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    t_phase = time.perf_counter()
    view, nodes, broker = serving_cluster(segments, dev)
    monitors = [DevicePoolMonitor(), BatchMetricsMonitor(),
                CodeDomainMonitor(), FilterBitmapMonitor(),
                MegakernelMonitor(), DispatchMonitor(),
                ResilienceMetricsMonitor(broker.resilience)]
    checks = {"groupby": check_groupby, "topn": check_topn,
              "timeseries": check_timeseries,
              "groupby_filtered": check_filtered}
    wants = {"groupby": (SEGMENTS, 0), "groupby_filtered": (0, SEGMENTS)}
    ex = QueryExecutor(segments, device=dev)
    base = (sr.LAUNCHES, mk.LAUNCHES)

    def launches():
        return (sr.LAUNCHES, mk.LAUNCHES)
    out = {"nodes": SERVING_NODES, "replicas": SERVING_REPLICAS}
    # the yardstick first: the executor's rows and warm p50 (its launches
    # are not the serving path's)
    ex_rows, ex_ms = {}, {}
    for name, q in qs.items():
        ex_ms[name] = []
        for _ in range(1 + SERVING_WARM):
            t = time.perf_counter()
            ex_rows[name] = ex.run_json(q)
            torch.cuda.synchronize()
            ex_ms[name].append((time.perf_counter() - t) * 1e3)
    if pool_before is None:
        pool_before = pool_snapshot("the executor's runs")
    sr.LAUNCHES = mk.LAUNCHES = 0
    broker_rows = {}
    for name, q in qs.items():
        want = wants.get(name, (0, 0))
        runs = []
        for i in range(1 + SERVING_WARM):
            before = launches()
            rows, ms, spans = serving_run(broker, q, f"serving-{name}-{i}")
            got = tuple(a - b for a, b in zip(launches(), before))
            if got != want:
                raise AssertionError(f"serving {name}: (B1, B2) launched "
                                     f"{got} times a run, expected {want}")
            checks[name](rows, ref)
            if not same_rows(rows, ex_rows[name]):
                raise AssertionError(f"serving {name}: broker rows differ "
                                     f"from the executor's")
            runs.append((ms, spans))
        broker_rows[name] = rows
        warm = [ms for ms, _ in runs[1:]]
        names = sorted({k for _, sp in runs[1:] for k in sp})
        split = {k: float(np.median([sp.get(k, 0.0) for _, sp in runs[1:]]))
                 for k in names}
        res = out[name] = {
            "cold_ms": runs[0][0], "warm_ms": warm,
            "p50_ms": float(np.median(warm)),
            "executor_p50_ms": float(np.median(ex_ms[name][1:])),
            "b1_b2_launches_per_run": list(want), "span_ms": split,
            "result_rows": len(rows)}
        log(f"  {name}: broker rows equal numpy and the executor's; warm "
            f"p50 {res['p50_ms']:.1f} ms (executor {res['executor_p50_ms']:.1f}"
            f" ms), first {res['cold_ms']:.1f} ms, (B1, B2) {want} a run; "
            f"trace: " + ", ".join(f"{k} {split[k]:.1f}" for k in (
                "broker/plan", "broker/scatter", "broker/node",
                "engine/partials", "broker/merge") if k in split))
    if _failed_calls(broker):
        raise AssertionError(f"failed node calls: {_failed_calls(broker)}")
    kept = {"nodes": nodes, "rows": broker_rows}
    if not extras:
        counted = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
        sr.LAUNCHES, mk.LAUNCHES = base
        broker.stop()
        out["phase_s"] = time.perf_counter() - t_phase
        return out, counted, kept

    # the segment cache: 8 misses, then 8 hits and no B1 launch; the
    # broker's replica picks are reseeded before each run, so that each
    # segment goes to the node that cached it (a node's cache is its own)
    q = qs["groupby"]
    for n in nodes:
        n.cache = LruCache()
    seg = {}
    for tag, want_b1 in (("miss", SEGMENTS), ("hit", 0)):
        broker.rng.seed(SEED)
        c0 = [(n.cache.stats.hits, n.cache.stats.misses) for n in nodes]
        before = launches()
        rows, ms, spans = serving_run(broker, q, f"serving-segcache-{tag}")
        got = tuple(a - b for a, b in zip(launches(), before))
        hits = sum(n.cache.stats.hits - h for n, (h, _) in zip(nodes, c0))
        misses = sum(n.cache.stats.misses - m
                     for n, (_, m) in zip(nodes, c0))
        want = (0, SEGMENTS) if tag == "miss" else (SEGMENTS, 0)
        if (hits, misses) != want or got != (want_b1, 0) \
                or not same_rows(rows, ex_rows["groupby"]):
            raise AssertionError(f"segment cache {tag}: {hits} hits, "
                                 f"{misses} misses, (B1, B2) {got}")
        seg[tag] = {"ms": ms, "hits": hits, "misses": misses,
                    "b1_launches": got[0], "span_ms": spans}
    out["segment_cache"] = seg
    log(f"  segment cache: groupBy {seg['miss']['ms']:.1f} ms with 8 misses "
        f"(B1 x8), {seg['hit']['ms']:.1f} ms with 8 hits (B1 x0), the same "
        f"rows; merge {seg['hit']['span_ms'].get('broker/merge', 0):.1f} ms")

    # the result cache: the second run is served without a node call
    broker.cache = LruCache()
    res_c = {}
    for tag in ("miss", "hit"):
        calls = sum(n.calls for n in nodes)
        h0 = broker.cache.stats.hits
        rows, ms, _ = serving_run(broker, q, f"serving-rescache-{tag}")
        called = sum(n.calls for n in nodes) - calls
        hit = broker.cache.stats.hits - h0
        if (tag == "hit") != (hit == 1 and called == 0) \
                or not same_rows(rows, ex_rows["groupby"]):
            raise AssertionError(f"result cache {tag}: {hit} hits, "
                                 f"{called} node calls")
        res_c[tag] = {"ms": ms, "node_calls": called}
    out["result_cache"] = res_c
    log(f"  result cache: groupBy {res_c['miss']['ms']:.1f} ms "
        f"({res_c['miss']['node_calls']} node calls), then a hit in "
        f"{res_c['hit']['ms']:.3f} ms with no node call")
    broker.cache = None
    for n in nodes:
        n.cache = None
    if _failed_calls(broker):
        raise AssertionError(f"failed node calls: {_failed_calls(broker)}")

    # failover: node0 dead; every run still launches B1 8 times
    nodes[0].alive = False
    fail = {"runs_ms": []}
    for i in range(4):
        before = launches()
        rows, ms, _ = serving_run(broker, q, f"serving-failover-{i}")
        got = tuple(a - b for a, b in zip(launches(), before))
        if got != (SEGMENTS, 0) or not same_rows(rows, ex_rows["groupby"]):
            raise AssertionError(f"failover: (B1, B2) {got}")
        fail["runs_ms"].append(ms)
        if _failed_calls(broker).get("node0"):
            break
    nodes[0].alive = True
    failed = _failed_calls(broker)
    if set(failed) != {"node0"}:
        raise AssertionError(f"failover: failed calls {failed}")
    fail["failed_calls"] = failed
    fail["circuits"] = broker.resilience.circuits.snapshot()
    out["failover"] = fail
    log(f"  failover (node0 dead): {len(fail['runs_ms'])} groupBy runs "
        f"{[round(x, 1) for x in fail['runs_ms']]} ms, rows unchanged, B1 "
        f"x8 each; failed calls {failed}, circuits {fail['circuits']}")

    # the seven monitors, one tick each
    sink = InMemoryEmitter()
    emitter = ServiceEmitter("broker", "chip", sink)
    for m in monitors:
        m.do_monitor(emitter)
    metrics = {}
    for e in sink.metrics():
        metrics.setdefault(e.metric, []).append(e.value)
    out["monitors"] = metrics
    log("  monitors: " + ", ".join(
        f"{k} {v[0] if len(v) == 1 else v}" for k, v in sorted(
            metrics.items())))
    after = device_pool().snapshot().resident_bytes
    if metrics["segment/devicePool/residentBytes"][0] <= 0 \
            or metrics["query/dispatch/count"][0] <= 0 \
            or metrics["query/megakernel/hits"][0] <= 0:
        raise AssertionError("monitors: pool bytes, dispatches and "
                             "megakernel runs must be > 0")
    if after > pool_before["resident_bytes"]:
        raise AssertionError(
            f"serving raised the pool from {pool_before['resident_bytes']} "
            f"to {after} B")
    out["pool"] = {"before": pool_before["resident_bytes"], "after": after}
    log(f"  pool {after} B resident after serving, "
        f"{pool_before['resident_bytes']} B before: replicas staged nothing "
        f"twice")
    counted = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    broker.stop()
    del ex, broker, view
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase serving took {out['phase_s']:.1f} s; (B1, B2) launched "
        f"{counted}")
    return out, counted, kept


def serving_fusion(dev, segments):
    """Phase 17's cross-query fusion, on phase 14's hourly segments: two
    timeseries through one data node's run_partials_group, each against
    the same query through run_partials alone; the stacked runs fuse the
    two queries. B1/B2 must not launch."""
    import torch
    from druid_tpu_torch.cluster import DataNode
    from druid_tpu_torch.engine import batching, engines
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.engine.batching import BatchMetricsMonitor
    from druid_tpu_torch.query.model import query_from_json
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    node = DataNode("fusion", device=dev)
    for s in segments:
        node.load_segment(s)
    sids = [str(s.id) for s in segments]
    ts = batching_queries(segments)["B-ts"]
    qs = [query_from_json(dict(ts, context={"queryId": f"fused-{i}"}))
          for i in range(2)]
    base = (sr.LAUNCHES, mk.LAUNCHES)
    monitor = BatchMetricsMonitor()
    monitor.do_monitor(ServiceEmitter("historical", "chip",
                                      InMemoryEmitter()))   # drain
    fused = []
    s0 = batching.stats().snapshot()
    t = time.perf_counter()
    got = node.run_partials_group(
        [(q, sids, None) for q in qs],
        on_batch=lambda nq, ns, fill: fused.append((nq, ns, fill)))
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t) * 1e3
    s1 = batching.stats().snapshot()
    sink = InMemoryEmitter()
    monitor.do_monitor(ServiceEmitter("historical", "chip", sink))
    t = time.perf_counter()
    alone = [node.run_partials(q, sids)[0] for q in qs]
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t) * 1e3
    for q, g, a in zip(qs, got, alone):
        if isinstance(g, BaseException):
            raise g
        if not same_rows(engines.finish_timeseries(q, g[0]),
                         engines.finish_timeseries(q, a)):
            raise AssertionError("fusion: a fused query's rows differ from "
                                 "the query alone")
    if (sr.LAUNCHES, mk.LAUNCHES) != base:
        raise AssertionError("fusion launched B1/B2")
    if not any(nq == 2 for nq, _, _ in fused):
        raise AssertionError(f"fusion: no stacked run held both queries: "
                             f"{fused}")
    out = {"fused_ms": fused_ms, "alone_ms": alone_ms,
           "stacked_runs": [list(f) for f in fused],
           "batches": s1["batches"] - s0["batches"],
           "batch_metrics": [(e.metric, e.value) for e in sink.metrics()]}
    log(f"  fusion: two B-ts through run_partials_group in {fused_ms:.1f} ms "
        f"({out['batches']} stacked runs: (queries, segments, fill) "
        f"{[(a, b, round(c, 4)) for a, b, c in fused]}), each equal to the "
        f"query alone ({alone_ms:.1f} ms for both); BatchMetricsMonitor "
        f"emitted {len(out['batch_metrics'])} metrics")
    return out


# ---------------------------------------------------------------------------
# phase 18: the HTTP serving path (QueryHttpServer -> Broker ->
# RemoteDataNodeClient -> HTTP -> DataNodeServer -> DataNode)
# ---------------------------------------------------------------------------

HTTP_WARM = 3                        # warm runs a query (p50 of 3)
HTTP_PHASE_LIMIT_S = 45.0


def http_post(port, q, headers=None, path="/druid/v2"):
    """POST a JSON payload (a native query to /druid/v2 by default):
    (status, headers, rows or None, ms, body bytes). The host clock stops
    after the reply is read and decoded, and the card is synchronised."""
    import torch
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(q).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, hdrs, body = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, dict(e.headers), e.read()
    rows = json.loads(body) if body else None
    torch.cuda.synchronize()
    return status, hdrs, rows, (time.perf_counter() - t) * 1e3, body


def http_trace(port, qid):
    """Time by span name of the trace GET /druid/v2/trace/<qid> serves."""
    import urllib.request
    from druid_tpu_torch.obs import trace
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/druid/v2/trace/{qid}",
            timeout=60) as r:
        return trace.phase_breakdown(json.loads(r.read())["spans"])


def http_cluster(nodes, dev, servers=None, sql=False):
    """One RemoteDataNodeClient per DataNodeServer in a fresh
    InventoryView (each node's segments announced from its /status), a
    Broker over it with hedging off, and the broker's QueryHttpServer
    (with a SqlExecutor over the broker where `sql`). `servers` defaults
    to a new plain DataNodeServer per node."""
    from druid_tpu_torch.cluster import (Broker, DataNodeServer,
                                         InventoryView, RemoteDataNodeClient,
                                         ResiliencePolicy)
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
    if servers is None:
        servers = [DataNodeServer(n).start() for n in nodes]
    view = InventoryView()
    for n, srv in zip(nodes, servers):
        client = RemoteDataNodeClient(n.name, srv.url)
        view.register(client)
        for d in client.served_descriptors():
            view.announce(n.name, d)
    broker = Broker(view, device=dev,
                    resilience_policy=ResiliencePolicy(hedge_enabled=False))
    sql_executor = None
    if sql:
        from druid_tpu_torch.sql import SqlExecutor
        sql_executor = SqlExecutor(broker)
    http = QueryHttpServer(QueryLifecycle(broker),
                           sql_executor=sql_executor).start()
    return servers, broker, http


def phase_http(dev, qs, ref, kept, serving):
    """Phase 18 over phase 17's three DataNodes (nothing stages again): a
    DataNodeServer per node, a Broker over RemoteDataNodeClients, its
    QueryHttpServer; the four main-path queries posted as JSON, 1 cold and
    HTTP_WARM warm runs each, against numpy and phase 17's broker rows,
    with B1 x8 a groupBy run and B2 x8 a filtered run; then the groupBy
    with wireCompress off, with If-None-Match (a 304, no B1 launch) and
    with node0's server stopped (failover, the same rows); then two
    concurrent filtered groupBys through a node served with the
    scheduler. `serving` is phase 17's report (its broker and executor
    p50s). Returns (report, {"B1": launches, "B2": launches})."""
    import threading
    from druid_tpu_torch.cluster import DataNodeServer, wire
    from druid_tpu_torch.data.devicepool import device_pool
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.server.scheduler import (SchedulerConfig,
                                                  SchedulerMetricsMonitor)
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    t_phase = time.perf_counter()
    nodes, broker_rows = kept["nodes"], kept["rows"]
    pool_before = device_pool().snapshot().resident_bytes
    checks = {"groupby": check_groupby, "topn": check_topn,
              "timeseries": check_timeseries,
              "groupby_filtered": check_filtered}
    wants = {"groupby": (SEGMENTS, 0), "groupby_filtered": (0, SEGMENTS)}
    base = (sr.LAUNCHES, mk.LAUNCHES)

    def launches():
        return (sr.LAUNCHES, mk.LAUNCHES)

    def wire_bytes():
        w = wire.wire_stats().snapshot()
        return w["logicalBytes"], w["wireBytes"]

    verified = {}

    def check(name, rows, body):
        """The rows against numpy and phase 17's broker rows; a reply whose
        bytes equal one already checked for `name` holds the same rows."""
        if verified.get(name) == body:
            return
        checks[name](rows, ref)
        if not same_rows(rows, broker_rows[name]):
            raise AssertionError(f"http {name}: rows differ from phase "
                                 f"17's broker")
        verified[name] = body
        kept.setdefault("http_rows", {})[name] = rows

    def run(q, qid, headers=None):
        """One POST of `q` under `qid`: (status, headers, rows, ms,
        (B1, B2) launched, (logical, emitted) wire bytes, body)."""
        l0, w0 = launches(), wire_bytes()
        status, hdrs, rows, ms, body = http_post(
            http.port, dict(q, context=dict(q.get("context", {}),
                                            queryId=qid)), headers)
        return (status, hdrs, rows, ms,
                tuple(a - b for a, b in zip(launches(), l0)),
                tuple(a - b for a, b in zip(wire_bytes(), w0)), body)

    servers, broker, http = http_cluster(nodes, dev)
    sr.LAUNCHES = mk.LAUNCHES = 0
    out = {"nodes": len(nodes)}
    etag = None
    for name, q in qs.items():
        want = wants.get(name, (0, 0))
        runs = []
        for i in range(1 + HTTP_WARM):
            qid = f"http-{name}-{i}"
            status, hdrs, rows, ms, got, wb, body = run(q, qid)
            if status != 200 or got != want:
                raise AssertionError(f"http {name}: status {status}, (B1, "
                                     f"B2) launched {got}, expected {want}")
            check(name, rows, body)
            runs.append((ms, http_trace(http.port, qid), wb))
            if name == "groupby":
                etag = hdrs.get("X-Druid-ETag")
        warm = [ms for ms, _, _ in runs[1:]]
        split = {k: float(np.median([sp.get(k, 0.0)
                                     for _, sp, _ in runs[1:]]))
                 for k in sorted({k for _, sp, _ in runs[1:] for k in sp})}
        res = out[name] = {
            "cold_ms": runs[0][0], "warm_ms": warm,
            "p50_ms": float(np.median(warm)),
            "broker_p50_ms": serving[name]["p50_ms"],
            "executor_p50_ms": serving[name]["executor_p50_ms"],
            "b1_b2_launches_per_run": list(want), "span_ms": split,
            "wire_logical_bytes": runs[-1][2][0],
            "wire_emitted_bytes": runs[-1][2][1]}
        log(f"  {name}: HTTP rows equal numpy and phase 17's; warm p50 "
            f"{res['p50_ms']:.1f} ms (in-process broker "
            f"{res['broker_p50_ms']:.1f} ms, executor "
            f"{res['executor_p50_ms']:.1f} ms), first {res['cold_ms']:.1f} "
            f"ms, (B1, B2) {want} a run; trace: " + ", ".join(
                f"{k} {split[k]:.1f}" for k in (
                    "query", "broker/scatter", "broker/node",
                    "datanode/query", "engine/partials", "broker/merge")
                if k in split)
            + f"; wire {res['wire_logical_bytes']} B logical, "
            f"{res['wire_emitted_bytes']} B emitted a run")
    if _failed_calls(broker):
        raise AssertionError(f"failed node calls: {_failed_calls(broker)}")

    # the groupBy with the compressed wire refused in its context
    q = qs["groupby"]
    plain = dict(q, context={"wireCompress": False})
    status, _, rows, ms, got, wb, body = run(plain, "http-groupby-plain")
    if status != 200 or got != (SEGMENTS, 0):
        raise AssertionError(f"wireCompress off: status {status}, (B1, B2) "
                             f"{got}")
    check("groupby", rows, body)
    comp = out["groupby"]["wire_emitted_bytes"]
    if comp > wb[1]:
        raise AssertionError(f"compressed wire {comp} B > plain {wb[1]} B")
    out["wire_compress_off"] = {"ms": ms, "logical_bytes": wb[0],
                                "emitted_bytes": wb[1]}
    log(f"  wireCompress off: the same rows in {ms:.1f} ms, {wb[1]} B "
        f"emitted ({comp} B compressed)")

    # If-None-Match with the last groupBy reply's etag: 304, no launch
    status, hdrs, _, ms, got, _, _ = run(q, "http-groupby-304",
                                         {"If-None-Match": etag})
    if status != 304 or got != (0, 0) or hdrs.get("X-Druid-ETag") != etag:
        raise AssertionError(f"If-None-Match: status {status}, (B1, B2) "
                             f"{got}")
    out["not_modified"] = {"ms": ms, "etag": etag}
    log(f"  If-None-Match: 304 in {ms:.2f} ms, no B1/B2 launch")

    # failover: node0's server stopped
    servers[0].stop()
    fail = {"runs_ms": []}
    for i in range(4):
        status, _, rows, ms, got, _, body = run(q, f"http-failover-{i}")
        if status != 200 or got != (SEGMENTS, 0):
            raise AssertionError(f"failover: status {status}, (B1, B2) "
                                 f"{got}")
        check("groupby", rows, body)
        fail["runs_ms"].append(ms)
        if _failed_calls(broker).get(nodes[0].name):
            break
    failed = _failed_calls(broker)
    if set(failed) != {nodes[0].name}:
        raise AssertionError(f"failover: failed calls {failed}")
    fail["failed_calls"] = failed
    out["failover"] = fail
    log(f"  failover (node0's server stopped): {len(fail['runs_ms'])} "
        f"groupBy runs {[round(x, 1) for x in fail['runs_ms']]} ms, rows "
        f"unchanged, B1 x8 each; failed calls {failed}")
    http.stop()
    broker.stop()
    for srv in servers[1:]:
        srv.stop()

    # the scheduler: node1 served anew with SchedulerConfig(), beside
    # node2 (the two hold every segment between them); two filtered
    # groupBys at once through the broker's resource
    sched_srv = DataNodeServer(
        nodes[1], scheduler_config=SchedulerConfig()).start()
    servers, broker, http = http_cluster(
        nodes[1:], dev, [sched_srv, DataNodeServer(nodes[2]).start()])
    fq = qs["groupby_filtered"]
    results = [None, None]
    l0 = launches()

    def post(i):
        results[i] = http_post(http.port, dict(fq, context={
            "queryId": f"http-sched-{i}"}))
    threads = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    got = tuple(a - b for a, b in zip(launches(), l0))
    for status, _, rows, _, body in results:
        if status != 200:
            raise AssertionError(f"scheduler: status {status}")
        check("groupby_filtered", rows, body)
    sink = InMemoryEmitter()
    SchedulerMetricsMonitor(sched_srv.scheduler).do_monitor(
        ServiceEmitter("historical", "chip", sink))
    sched = {"ms": [r[3] for r in results], "b1_b2_launches": list(got),
             "stats": sched_srv.scheduler.stats.snapshot(),
             "metrics": [(e.metric, e.value) for e in sink.metrics()]}
    out["scheduler"] = sched
    log(f"  scheduler: two filtered groupBys at once through node1's "
        f"scheduler in {[round(x, 1) for x in sched['ms']]} ms, rows equal "
        f"numpy and phase 17's, (B1, B2) {got}; stats {sched['stats']}; "
        + ", ".join(f"{m} {v}" for m, v in sched["metrics"]))
    if _failed_calls(broker):
        raise AssertionError(f"failed node calls: {_failed_calls(broker)}")
    http.stop()
    broker.stop()
    for srv in servers:
        srv.stop()

    after = device_pool().snapshot().resident_bytes
    out["pool"] = {"before": pool_before, "after": after}
    if after != pool_before:
        raise AssertionError(f"http: the pool went from {pool_before} B to "
                             f"{after} B")
    counted = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  pool {after} B resident before and after; phase http took "
        f"{out['phase_s']:.1f} s; (B1, B2) launched {counted}; "
        f"{card_line()}")
    if out["phase_s"] > HTTP_PHASE_LIMIT_S:
        raise AssertionError(f"phase http took {out['phase_s']:.1f} s, "
                             f"over {HTTP_PHASE_LIMIT_S} s")
    return out, counted


SQL_WARM = 3                         # warm runs a statement (p50 of 3)
SQL_PHASE_LIMIT_S = 45.0
AVATICA_PATH = "/druid/v2/sql/avatica/"


def sql_statements(qs):
    """The four main-path queries as Druid SQL, with the native queries'
    time range (as a dashboard sends it: the planner turns it into the
    query's interval) and filter values."""
    fields = qs["groupby_filtered"]["filter"]["fields"]
    in_a = ", ".join(f"'{v}'" for v in qs["topn"]["filter"]["values"])
    in_f = ", ".join(f"'{v}'" for v in fields[0]["values"])
    head = fields[1]["field"]["value"]
    day = (f"__time >= TIMESTAMP '{DAY[0]} 00:00:00' AND "
           f"__time < TIMESTAMP '{DAY[1]} 00:00:00'")
    aggs = 'COUNT(*) AS "rows", SUM(metLong) AS lsum'
    return {
        "groupby": f"SELECT dimA, dimB, {aggs}, MAX(metFloat) AS fmax "
                   f"FROM bench WHERE {day} AND metLong BETWEEN 100 AND "
                   f"9900 GROUP BY dimA, dimB",
        "topn": f"SELECT dimB, {aggs} FROM bench WHERE {day} AND dimA IN "
                f"({in_a}) GROUP BY dimB ORDER BY lsum DESC LIMIT 100",
        "timeseries": f"SELECT FLOOR(__time TO HOUR) AS t, {aggs}, "
                      f"MAX(metFloat) AS fmax, SUM(metFloat) AS dsum "
                      f"FROM bench WHERE {day} GROUP BY 1",
        "groupby_filtered": f"SELECT dimA, dimB, {aggs}, MAX(metFloat) AS "
                            f"fmax FROM bench WHERE {day} AND dimA IN "
                            f"({in_f}) AND dimB <> '{head}' AND metLong "
                            f"BETWEEN 100 AND 9900 GROUP BY dimA, dimB"}


def sql_as_native(name, rows):
    """SQL object rows in the shape of the native rows the numpy checks
    read."""
    from druid_tpu_torch.utils.intervals import parse_ts
    if name == "topn":
        return [{"result": rows}]
    if name == "timeseries":
        return [{"timestamp": parse_ts(r["t"]),
                 "result": {k: v for k, v in r.items() if k != "t"}}
                for r in rows]
    return [{"event": r} for r in rows]


def sql_same_as_native(name, rows, native, ref):
    """SQL rows equal the native rows of the same query: exactly, but for
    the timeseries' float sum (floatSum in the SQL plan, doubleSum in the
    native query) within 1e-5 * sum|v| of its bucket."""
    from druid_tpu_torch.utils.intervals import parse_ts
    if name == "topn":
        return rows == native[0]["result"]
    if name == "timeseries":
        keys = ("rows", "lsum", "fmax")
        return len(rows) == len(native) and all(
            parse_ts(a["t"]) == b["timestamp"]
            and all(a[k] == b["result"][k] for k in keys)
            and abs(a["dsum"] - b["result"]["dsum"]) <= 1e-5 * ref["h_abs"][i]
            for i, (a, b) in enumerate(zip(rows, native)))
    return rows == [r["event"] for r in native]


def plan_summary(plan):
    """queryType, strategy-relevant shape and filter of an explain()."""
    def filt(f):
        if f is None:
            return None
        if f["type"] in ("and", "or"):
            return {f["type"]: [filt(x) for x in f["fields"]]}
        if f["type"] == "not":
            return {"not": filt(f["field"])}
        if f["type"] == "in":
            return f"in {f['dimension']} ({len(f['values'])} values)"
        if f["type"] == "bound":
            return (f"bound {f.get('lower')} <= {f['dimension']} <= "
                    f"{f.get('upper')} ({f.get('ordering')})")
        return f"{f['type']} {f.get('dimension')} {f.get('value', '')}"
    return {"queryType": plan["queryType"],
            "granularity": plan.get("granularity"),
            "intervals": plan.get("intervals"),
            "aggregations": [f"{a['type']}({a.get('fieldName', '')})"
                             for a in plan.get("aggregations", [])],
            "filter": filt(plan.get("filter"))}


def avatica_roundtrip(port, stmt):
    """open, prepareAndExecute, fetch to the end, close through the router:
    (rows, ms, frames, signature column names)."""
    def rpc(payload):
        status, _, body, _, _ = http_post(port, payload, path=AVATICA_PATH)
        if status != 200 or body.get("response") == "error":
            raise AssertionError(f"avatica {payload['request']}: {status} "
                                 f"{body}")
        return body
    t = time.perf_counter()
    cid = rpc({"request": "openConnection"})["connectionId"]
    rs = rpc({"request": "prepareAndExecute", "connectionId": cid,
              "statementId": 0, "sql": stmt,
              "maxRowCount": -1})["results"][0]
    rows, done, frames = rs["firstFrame"]["rows"], rs["firstFrame"]["done"], 1
    while not done:
        frame = rpc({"request": "fetch", "connectionId": cid,
                     "statementId": 0, "offset": len(rows),
                     "fetchMaxRowCount": 1 << 20})["frame"]
        rows, done, frames = rows + frame["rows"], frame["done"], frames + 1
    rpc({"request": "closeStatement", "connectionId": cid, "statementId": 0})
    rpc({"request": "closeConnection", "connectionId": cid})
    names = [c["columnName"] for c in rs["signature"]["columns"]]
    return rows, (time.perf_counter() - t) * 1e3, frames, names


def phase_sql(dev, qs, ref, kept, http_report):
    """Phase 19 over phase 17's three DataNodes, each served anew by a
    DataNodeServer (nothing stages again): a Broker over
    RemoteDataNodeClients behind QueryHttpServer(QueryLifecycle(broker),
    sql_executor=SqlExecutor(broker)), and a RouterHttpServer in front of
    it. The schema discovery timed apart; the four main-path queries as
    SQL posted to the router's /druid/v2/sql, 1 cold and SQL_WARM warm
    runs each, against numpy and phase 18's native rows, with B1 x8 a
    groupBy run and B2 x8 a filtered run as their plans' strategies give;
    each statement's explain() and planning time; one Avatica round trip
    of the groupBy and one native groupBy through the router. Returns
    (report, {"B1": launches, "B2": launches})."""
    from druid_tpu_torch.data.devicepool import device_pool
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.query.model import query_from_json
    from druid_tpu_torch.server import RouterHttpServer, TieredBrokerSelector
    t_phase = time.perf_counter()
    nodes, native_rows = kept["nodes"], kept["http_rows"]
    pool_before = device_pool().snapshot().resident_bytes
    checks = {"groupby": check_groupby, "topn": check_topn,
              "timeseries": check_timeseries,
              "groupby_filtered": check_filtered}
    wants = {"groupby": (SEGMENTS, 0), "groupby_filtered": (0, SEGMENTS)}
    base = (sr.LAUNCHES, mk.LAUNCHES)

    def launches():
        return (sr.LAUNCHES, mk.LAUNCHES)

    servers, broker, http = http_cluster(nodes, dev, sql=True)
    router = RouterHttpServer(TieredBrokerSelector(
        {"_default": [f"http://127.0.0.1:{http.port}"]},
        default_tier="_default")).start()
    sq = http.sql_executor
    builds = []
    build_schema = sq._build_schema

    def timed_build():
        t = time.perf_counter()
        schema = build_schema()
        builds.append((time.perf_counter() - t) * 1e3)
        return schema
    sq._build_schema = timed_build
    sr.LAUNCHES = mk.LAUNCHES = 0
    out = {"nodes": len(nodes)}
    stmts = sql_statements(qs)

    # schema discovery: one merged segmentMetadata scatter per datasource
    sq.schema()
    out["schema"] = {"ms": builds[0], "tables": sq.schema().tables}
    if sq.schema().tables.get("bench") != {
            "dimA": "string", "dimB": "string", "metLong": "long",
            "metFloat": "float"} or launches() != (0, 0):
        raise AssertionError(f"schema {sq.schema().tables}, (B1, B2) "
                             f"{launches()}")
    log(f"  schema discovery (segmentMetadata over {len(nodes)} nodes): "
        f"{builds[0]:.1f} ms, {sq.schema().tables}")

    verified = {}
    sql_rows = {}
    for name, stmt in stmts.items():
        plan = sq.explain(stmt)
        same_plan = {k: v for k, v in query_from_json(plan).to_json().items()
                     if k != "context"} == {
            k: v for k, v in query_from_json(qs[name]).to_json().items()
            if k != "context"}
        plan_ms = []
        for _ in range(3):
            t = time.perf_counter()
            sq.explain(stmt)
            plan_ms.append((time.perf_counter() - t) * 1e3)
        want = wants.get(name, (0, 0))
        runs = []
        for i in range(1 + SQL_WARM):
            l0 = launches()
            status, _, rows, ms, body = http_post(
                router.port, {"query": stmt, "context": {
                    "queryId": f"sql-{name}-{i}"}}, path="/druid/v2/sql")
            got = tuple(a - b for a, b in zip(launches(), l0))
            if status != 200 or got != want:
                raise AssertionError(f"sql {name}: status {status}, (B1, "
                                     f"B2) launched {got}, expected {want}"
                                     + ("" if status == 200 else
                                        f"; {rows}"))
            if verified.get(name) != body:
                checks[name](sql_as_native(name, rows), ref)
                if not sql_same_as_native(name, rows, native_rows[name], ref):
                    raise AssertionError(f"sql {name}: rows differ from "
                                         f"phase 18's native rows")
                verified[name] = body
            sql_rows[name] = rows
            runs.append(ms)
        res = out[name] = {
            "statement": stmt if len(stmt) < 300 else stmt[:300] + "...",
            "plan": plan_summary(plan), "plan_equals_native": same_plan,
            "plan_ms": float(np.median(plan_ms)),
            "cold_ms": runs[0], "warm_ms": runs[1:],
            "p50_ms": float(np.median(runs[1:])),
            "native_http_p50_ms": http_report[name]["p50_ms"],
            "b1_b2_launches_per_run": list(want), "rows": len(rows)}
        log(f"  {name}: explain {json.dumps(res['plan'])}; the native "
            f"query's plan: {same_plan}")
        log(f"  {name}: SQL rows ({len(rows)}) equal numpy and phase 18's; "
            f"warm p50 {res['p50_ms']:.1f} ms through the router (native "
            f"over HTTP {res['native_http_p50_ms']:.1f} ms), first "
            f"{res['cold_ms']:.1f} ms, planning {res['plan_ms']:.2f} ms, "
            f"(B1, B2) {want} a run")
    if _failed_calls(broker):
        raise AssertionError(f"failed node calls: {_failed_calls(broker)}")

    # one Avatica round trip of the groupBy, through the router
    l0 = launches()
    rows, ms, frames, names = avatica_roundtrip(router.port,
                                                stmts["groupby"])
    got = tuple(a - b for a, b in zip(launches(), l0))
    if got != wants["groupby"] or rows != [[r[c] for c in names]
                                           for r in sql_rows["groupby"]]:
        raise AssertionError(f"avatica: (B1, B2) {got}, or rows other "
                             f"than the SQL groupBy's")
    out["avatica"] = {"ms": ms, "frames": frames, "rows": len(rows)}
    log(f"  Avatica (open, prepareAndExecute, fetch, close) of the groupBy: "
        f"{len(rows)} rows in {frames} frames, {ms:.1f} ms, the SQL rows, "
        f"(B1, B2) {got}")

    # one native groupBy through the router
    l0 = launches()
    status, _, rows, ms, _ = http_post(router.port, dict(
        qs["groupby"], context={"queryId": "sql-native-groupby"}))
    got = tuple(a - b for a, b in zip(launches(), l0))
    if status != 200 or got != wants["groupby"] \
            or not same_rows(rows, native_rows["groupby"]):
        raise AssertionError(f"native through the router: status {status}, "
                             f"(B1, B2) {got}")
    out["native_groupby_via_router"] = {"ms": ms}
    log(f"  native groupBy through the router: phase 18's rows in "
        f"{ms:.1f} ms, (B1, B2) {got}")
    if _failed_calls(broker):
        raise AssertionError(f"failed node calls: {_failed_calls(broker)}")
    router.stop()
    http.stop()
    broker.stop()
    for srv in servers:
        srv.stop()

    out["schema"]["builds_ms"] = builds
    after = device_pool().snapshot().resident_bytes
    out["pool"] = {"before": pool_before, "after": after}
    if after != pool_before:
        raise AssertionError(f"sql: the pool went from {pool_before} B to "
                             f"{after} B")
    counted = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  pool {after} B resident before and after; {len(builds)} schema "
        f"build(s) {[round(b, 1) for b in builds]} ms; phase sql took "
        f"{out['phase_s']:.1f} s; (B1, B2) launched {counted}; "
        f"{card_line()}")
    if out["phase_s"] > SQL_PHASE_LIMIT_S:
        raise AssertionError(f"phase sql took {out['phase_s']:.1f} s, "
                             f"over {SQL_PHASE_LIMIT_S} s")
    return out, counted


STORAGE_WARM = 3                     # warm runs a query (p50 of 3)
STORAGE_PHASE_LIMIT_S = 150.0
GOLDEN_Q = {"queryType": "groupBy", "dataSource": "golden",
            "intervals": [f"{DAY[0]}/{DAY[1]}"], "granularity": "all",
            "dimensions": ["dim"],
            "aggregations": [{"type": "count", "name": "rows"},
                             {"type": "longSum", "name": "s",
                              "fieldName": "lng"},
                             {"type": "doubleSum", "name": "x",
                              "fieldName": "dbl"}]}


def golden_segment():
    """tests/test_format_v2.py's _golden_segment, rebuilt with the port's
    SegmentBuilder and no RNG: the segment tests/golden/segment_v{1,2}
    hold."""
    from druid_tpu_torch.data.segment import SegmentBuilder
    from druid_tpu_torch.utils.intervals import Interval
    rows, card = 256, 8
    iv = Interval.of(*DAY)
    b = SegmentBuilder("golden", iv, version="v0", partition=0)
    b.add_columns(
        iv.start + (np.arange(rows, dtype=np.int64) // 16),
        {"dim": np.repeat([f"g{i}" for i in range(card)],
                          rows // card).tolist()},
        {"cnt": np.ones(rows, dtype=np.int64),
         "lng": (np.arange(rows, dtype=np.int64) * 7) % 13,
         "dbl": np.tile(np.array([0.5, -0.0, np.nan, 8.0]),
                        rows // 4).astype(np.float64)})
    return b.build()


def _col_bits(a):
    a = np.asarray(a)
    return a.view(np.dtype(f"<i{a.dtype.itemsize}")) \
        if np.issubdtype(a.dtype, np.floating) else a


def same_columns(a, b, what):
    """Two segments' columns bit for bit (NaN and -0.0 as integer bits)."""
    if str(a.id) != str(b.id) or a.n_rows != b.n_rows \
            or not np.array_equal(a.time_ms, b.time_ms) \
            or list(a.dims) != list(b.dims) \
            or list(a.metrics) != list(b.metrics):
        raise AssertionError(f"{what}: identity, rows or schema differ")
    for name, col in a.dims.items():
        if col.dictionary.values != b.dims[name].dictionary.values \
                or not np.array_equal(col.ids, b.dims[name].ids):
            raise AssertionError(f"{what}: dimension {name} differs")
    for name, m in a.metrics.items():
        x, y = np.asarray(m.values), np.asarray(b.metrics[name].values)
        if m.type != b.metrics[name].type or x.dtype != y.dtype \
                or not np.array_equal(_col_bits(x), _col_bits(y)):
            raise AssertionError(f"{what}: metric {name} differs")


def check_golden(rows):
    """The golden groupBy against numpy: 8 groups of 32 rows, lng = 7r mod
    13, and a NaN in every group's dbl."""
    lng = (np.arange(256) * 7) % 13
    if len(rows) != 8:
        raise AssertionError(f"golden groupBy: {len(rows)} rows")
    for i, r in enumerate(rows):
        e = r["event"]
        if (e["dim"], e["rows"], e["s"]) != (
                f"g{i}", 32, int(lng[32 * i:32 * (i + 1)].sum())) \
                or not math.isnan(e["x"]):
            raise AssertionError(f"golden groupBy row {e}")


def part_bytes(directory):
    """On-disk bytes of a segment directory by part kind, from its
    meta.smoosh."""
    kinds = {}
    with open(os.path.join(directory, "meta.smoosh")) as f:
        next(f)
        for line in f:
            name, _, start, end = line.strip().rsplit(",", 3)
            kind = ("rle" if ".rle." in name else "pack"
                    if name.endswith(".pack") else "lz4"
                    if name.endswith(".lz4") else "dict"
                    if name.endswith(".dict") else "bitmaps"
                    if name.endswith(".bitmaps") else "index"
                    if name == "index.json" else "block")
            kinds[kind] = kinds.get(kind, 0) + int(end) - int(start)
    return kinds


class LeafLog:
    """Wraps filters.leaf_repr and both bindings of filters.leaf_words
    while the filtered queries run: each leaf built for `segment` is kept
    with its kind, permutation and the words the kernel then reads."""

    def __init__(self, segment):
        from druid_tpu_torch.engine import filters as F
        from druid_tpu_torch.engine import megakernel as mk
        self.segment, self.F, self.mk = segment, F, mk
        self.orig_repr, self.orig_words = F.leaf_repr, F.leaf_words
        self.kinds, self.words = {}, []

    def leaf_repr(self, segment, dim, lut, padded, perm=None, perm_key=None):
        kind, payload = self.orig_repr(segment, dim, lut, padded, perm,
                                       perm_key)
        if segment is self.segment:
            self.kinds[(dim, self.F.leaf_digest(lut))] = \
                (kind, payload.shape[0])
        return kind, payload

    def leaf_words(self, segment, dim, lut, padded, device, perm=None,
                   perm_key=None):
        out = self.orig_words(segment, dim, lut, padded, device, perm,
                              perm_key)
        if segment is self.segment:
            self.words.append((dim, lut, padded, perm, out))
        return out

    def __enter__(self):
        self.F.leaf_repr = self.leaf_repr
        self.F.leaf_words = self.mk.leaf_words = self.leaf_words
        return self

    def __exit__(self, *exc):
        self.F.leaf_repr = self.orig_repr
        self.F.leaf_words = self.mk.leaf_words = self.orig_words

    def check(self):
        """Each logged leaf's words equal lut[ids]'s (in its row order).
        Returns [(dim, kind, payload length, values matched)]."""
        seg, out = self.segment, []
        for dim, lut, padded, perm, words in self.words:
            bits = lut[seg.dims[dim].ids]
            if perm is not None:
                bits = bits[perm]
            want = np.zeros(padded, dtype=bool)
            want[:bits.shape[0]] = bits
            if not np.array_equal(words.cpu().numpy(),
                                  self.F.host_words(want)):
                raise AssertionError(f"leaf {dim}: words differ from "
                                     f"lut[ids]")
            kind, size = self.kinds.get((dim, self.F.leaf_digest(lut)),
                                        ("cached", 0))
            out.append((dim, kind, int(size), int(lut.sum())))
        return out


def tail_value_reference(segments, tail):
    """numpy rows of the headline groupBy filtered to one dimB id: {dimA
    id: (count, long sum, float max)}."""
    out = {}
    for s in segments:
        b = s.dims["dimB"].ids
        sel = np.flatnonzero(b == tail)
        a = s.dims["dimA"].ids[sel]
        ml, mf = s.metrics["metLong"].values[sel], \
            s.metrics["metFloat"].values[sel]
        for g in np.unique(a):
            k = a == g
            c, ls, fm = out.get(int(g), (0, 0, np.float32(-np.inf)))
            out[int(g)] = (c + int(k.sum()), ls + int(ml[k].sum()),
                           max(fm, mf[k].max()))
    return out


def phase_storage(dev, segments, qs, ref, kept, http_report):
    """Phase 20 on phase 6's 8 in-memory headline segments and numpy
    reference: the golden fixtures loaded and answered on the card; the 8
    segments persisted (V2) to a LocalDeepStorage in a temporary directory,
    segment 0 again as V1; a LoadQueuePeon loading all 8 into a fresh
    DataNode (no lazy column materialized by the load), whose
    DataNodeServer's SegmentLoadMonitor ticks segment/load/* > 0; the four
    main-path queries posted to a broker over it (1 cold and STORAGE_WARM
    warm runs, B1 x8 a groupBy run and B2 x8 a filtered run, rows against
    numpy and phase 18's), cascade.decode_stats before and after; the
    filtered groupBy's leaves on loaded segment 0 against lut[ids]; a
    sparse leaf (a dimB tail value) through B2; V1 equal to V2; no pool
    eviction. `kept` and `http_report` are phase 17-18's (None where they
    did not run). Returns (report, {"B1": launches, "B2": launches})."""
    import shutil
    import tempfile
    import torch
    from druid_tpu_torch.cluster import (DataNode, DataNodeServer,
                                         InventoryView, descriptor_for)
    from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
    from druid_tpu_torch.data import cascade
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.storage.deep import LocalDeepStorage
    from druid_tpu_torch.storage.format import load_segment
    from druid_tpu_torch.storage.format_v2 import segment_load_stats
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base = (sr.LAUNCHES, mk.LAUNCHES)
    sr.LAUNCHES = mk.LAUNCHES = 0
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_storage_")
    servers, broker, http, peon = [], None, None, None
    try:
        # 1. the golden fixtures the reference wrote, loaded on the card
        fresh = golden_segment()
        golden = {}
        for name in ("segment_v1", "segment_v2"):
            g = load_segment(os.path.join(root, "tests", "golden", name))
            same_columns(fresh, g, name)
            rows = QueryExecutor([g], device=dev).run_json(GOLDEN_Q)
            check_golden(rows)
            golden[name] = rows
        out["golden"] = {"rows": len(golden["segment_v2"]),
                         "v1_equals_v2": json.dumps(golden["segment_v1"])
                         == json.dumps(golden["segment_v2"])}
        log("  golden fixtures (tests/golden/segment_v1, segment_v2): "
            "columns bit for bit, groupBy rows equal numpy")

        # 2. persist: the 8 segments as V2, segment 0 again as V1
        deep = LocalDeepStorage(os.path.join(tmp, "deep"))
        descs, persist = [], []
        for s in segments:
            t = time.perf_counter()
            d = deep.push(s, descriptor_for(s))
            secs = time.perf_counter() - t
            descs.append(d)
            persist.append({"s": secs, "bytes": d.size_bytes,
                            "logical_bytes": s.size_bytes(),
                            "by_part": part_bytes(d.load_spec["path"])})
        t = time.perf_counter()
        v1 = LocalDeepStorage(os.path.join(tmp, "deep_v1"),
                              format_version=1).push(segments[0], descs[0])
        v1_s = time.perf_counter() - t
        out["persist"] = {
            "segments": persist, "total_s": sum(p["s"] for p in persist),
            "bytes": sum(p["bytes"] for p in persist),
            "logical_bytes": sum(p["logical_bytes"] for p in persist),
            "v1_segment0": {"s": v1_s, "bytes": v1.size_bytes,
                            "by_part": part_bytes(v1.load_spec["path"])}}
        by_part = {}
        for p in persist:
            for k, v in p["by_part"].items():
                by_part[k] = by_part.get(k, 0) + v
        out["persist"]["by_part"] = by_part
        each = ", ".join(f"{p['s']:.1f}" for p in persist)
        log(f"  persist V2: 8 segments in {out['persist']['total_s']:.1f} s "
            f"({each} s), "
            f"{out['persist']['bytes']} B on disk for "
            f"{out['persist']['logical_bytes']} B logical; by part "
            f"{by_part}; V1 of segment 0 in {v1_s:.1f} s, "
            f"{v1.size_bytes} B ({out['persist']['v1_segment0']['by_part']})")

        # 3. load: a LoadQueuePeon into a fresh DataNode, its server's
        # SegmentLoadMonitor built before the loads
        view, node = InventoryView(), DataNode("storage0", device=dev)
        view.register(node)
        sink = InMemoryEmitter()
        # no periodic tick: the one below reads the loads' whole delta
        srv = DataNodeServer(node, emitter=ServiceEmitter(
            "druid/historical", "storage0", sink),
            monitor_period_seconds=3600.0).start()
        servers.append(srv)
        before = segment_load_stats().snapshot()
        t = time.perf_counter()
        peon = LoadQueuePeon(node, view, deep.pull)
        for d in descs:
            if not peon.load(d):
                raise AssertionError(f"load of {d.id} refused")
        if not peon.wait_idle(600.0):
            raise AssertionError("the load queue did not drain")
        load_s = time.perf_counter() - t
        if peon.loads_done != SEGMENTS or peon.failures:
            raise AssertionError(f"loads {peon.loads_done}, failures "
                                 f"{peon.failures}")
        loaded = {str(s.id): s for s in node.segments()}
        lazy = [(sid, c) for sid, s in loaded.items()
                for c in list(s.dims) + list(s.metrics)
                if getattr(s.dims.get(c) or s.metrics[c], "materialized",
                           lambda: False)()]
        if lazy:
            raise AssertionError(f"the load materialized {lazy}")
        after = segment_load_stats().snapshot()
        srv.metrics_tick()
        ticked = {e.metric: e.value for e in sink.metrics()
                  if e.metric.startswith("segment/load/")}
        if len(ticked) != 3 or min(ticked.values()) <= 0:
            raise AssertionError(f"segment/load metrics {ticked}")
        out["load"] = {"s": load_s, "stats_delta": {
            k: after[k] - before[k] for k in after}, "monitor": ticked}
        log(f"  load: {peon.loads_done} segments by the load queue in "
            f"{load_s:.2f} s, none failed, no lazy column materialized; "
            f"segment_load_stats delta {out['load']['stats_delta']}; "
            f"SegmentLoadMonitor tick {ticked}")

        # 4. serve: the four main-path queries over HTTP
        _, broker, http = http_cluster([node], dev, [srv])
        seg0 = loaded[str(segments[0].id)]
        wants = {"groupby": (SEGMENTS, 0), "groupby_filtered": (0, SEGMENTS)}
        checks = {"groupby": check_groupby, "topn": check_topn,
                  "timeseries": check_timeseries,
                  "groupby_filtered": check_filtered}
        phase18 = (kept or {}).get("http_rows", {})
        decodes_before = cascade.decode_stats()
        serve = out["serve"] = {}
        leaves = None
        for name, q in qs.items():
            want = wants.get(name, (0, 0))
            runs = []
            for i in range(1 + STORAGE_WARM):
                l0 = (sr.LAUNCHES, mk.LAUNCHES)
                if name == "groupby_filtered" and i == 0:
                    with LeafLog(seg0) as leaves:
                        status, _, rows, ms, _ = http_post(http.port, q)
                else:
                    status, _, rows, ms, _ = http_post(http.port, q)
                got = (sr.LAUNCHES - l0[0], mk.LAUNCHES - l0[1])
                if status != 200 or got != want:
                    raise AssertionError(f"storage {name}: status {status},"
                                         f" (B1, B2) {got}, expected {want}")
                if i == 0:
                    checks[name](rows, ref)
                    if name in phase18 and not same_rows(rows,
                                                         phase18[name]):
                        raise AssertionError(f"storage {name}: rows differ "
                                             f"from phase 18's")
                runs.append(ms)
            res = serve[name] = {
                "cold_ms": runs[0], "warm_ms": runs[1:],
                "p50_ms": float(np.median(runs[1:])),
                "phase18_p50_ms": (http_report or {}).get(name, {}).get(
                    "p50_ms"), "b1_b2_launches_per_run": list(want)}
            log(f"  {name} over {SEGMENTS} loaded segments: "
                f"rows equal numpy{' and phase 18' if name in phase18 else ''}"
                f"; cold {res['cold_ms']:.1f} ms, warm p50 "
                f"{res['p50_ms']:.1f} ms (phase 18 over the in-memory "
                f"segments: {res['phase18_p50_ms']} ms), (B1, B2) {want} a "
                f"run")
        decodes_after = cascade.decode_stats()
        out["decodes"] = {"before": decodes_before, "after": decodes_after}
        log(f"  cascade.decode_stats before {decodes_before}, after "
            f"{decodes_after}")

        # 5. the filtered groupBy's leaves on loaded segment 0, then a
        # sparse leaf (a dimB tail value) through B2
        checked = leaves.check()
        if not checked:
            raise AssertionError("no leaf of loaded segment 0 was staged")
        out["leaves"] = checked
        log(f"  filtered groupBy's leaves on loaded segment 0 (words B2 "
            f"read) equal lut[ids]'s: {checked}")
        counts = np.bincount(segments[0].dims["dimB"].ids, minlength=1000)
        tail = int(np.flatnonzero(counts == counts[counts > 0].min())[0])
        tail_value = segments[0].dims["dimB"].dictionary.values[tail]
        tq = dict(qs["groupby"], filter={"type": "selector",
                                         "dimension": "dimB",
                                         "value": tail_value})
        l0 = (sr.LAUNCHES, mk.LAUNCHES)
        with LeafLog(seg0) as tail_leaves:
            status, _, rows, ms, _ = http_post(http.port, tq)
        got = (sr.LAUNCHES - l0[0], mk.LAUNCHES - l0[1])
        kinds = tail_leaves.check()
        if status != 200 or got != (0, SEGMENTS) \
                or {k for _, k, _, _ in kinds} != {"sparse"}:
            raise AssertionError(f"sparse leaf: status {status}, (B1, B2) "
                                 f"{got}, leaves {kinds}")
        want = tail_value_reference(segments, tail)
        gotrows = {int(r["event"]["dimA"][1:]): (
            r["event"]["rows"], r["event"]["lsum"],
            np.float32(r["event"]["fmax"])) for r in rows}
        if gotrows != want:
            raise AssertionError("sparse-leaf groupBy rows differ from "
                                 "numpy")
        out["sparse_leaf"] = {"value": tail_value,
                              "rows_in_segment0": int(counts[tail]),
                              "leaves": kinds, "ms": ms,
                              "b1_b2_launches": list(got),
                              "groups": len(rows)}
        log(f"  sparse leaf: dimB = {tail_value} ({int(counts[tail])} rows "
            f"in segment 0), leaf kind {kinds[0][1]} ({kinds[0][2]} padded "
            f"ids), B2 x{got[1]}, {len(rows)} rows equal numpy, {ms:.1f} ms")

        # 6. V1: segment 0 loaded eagerly from its V1 copy
        seg_v1 = load_segment(v1.load_spec["path"])
        same_columns(segments[0], seg_v1, "V1 segment 0")
        rows_v1 = QueryExecutor([seg_v1], device=dev).run_json(qs["groupby"])
        rows_v2 = QueryExecutor([seg0], device=dev).run_json(qs["groupby"])
        if not same_rows(rows_v1, rows_v2):
            raise AssertionError("groupBy over V1 segment 0 differs from V2")
        out["v1"] = {"groupby_rows": len(rows_v1)}
        log(f"  V1 segment 0: columns equal the in-memory segment bit for "
            f"bit; its groupBy ({len(rows_v1)} rows) equals the V2 copy's")

        # 7. the pool
        out["pool"] = pool_snapshot("storage")
    finally:
        if peon is not None:
            peon.stop()
        for x in (http, broker):
            if x is not None:
                x.stop()
        for srv in servers:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    counted = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase storage took {out['phase_s']:.1f} s; (B1, B2) launched "
        f"{counted}; temporary directory removed; {card_line()}")
    if out["phase_s"] > STORAGE_PHASE_LIMIT_S:
        raise AssertionError(f"phase storage took {out['phase_s']:.1f} s, "
                             f"over {STORAGE_PHASE_LIMIT_S} s")
    return out, counted


# ---------------------------------------------------------------------------
# phase 21: streaming ingestion and standing queries
# ---------------------------------------------------------------------------

INGEST_EVENTS = 10_000_000           # 2 partitions of 5M over 2 hours
INGEST_PARTITIONS = 2                # Kafka partitions, read by taskCount 2
INGEST_HYDRANT_ROWS = 1_000_000      # maxRowsInMemory
INGEST_SEGMENT_ROWS = 5_000_000      # maxRowsPerSegment (checked per sink)
INGEST_TASK_ROWS = 20_000_000        # maxTotalRows, a task's roll-over
INGEST_TICK_EVERY = 500_000          # events between standing ticks
INGEST_POLL_RECORDS = 10_000         # a task's records a partition a poll
INGEST_HOLDBACK = 100_000            # a partition's events for step 5
INGEST_REFOLDS = 20                  # A7: refolds of one live hydrant
INGEST_WARM = 3                      # warm runs a query (p50 of 3)
INGEST_PHASE_LIMIT_S = 150.0
INGEST_IV = ("2026-02-01T00:00:00.000Z", "2026-02-01T02:00:00.000Z")


def ingest_events(n=None, seed=SEED):
    """The headline schema as a stream, made from `seed` with numpy: per
    partition, n / partitions events in time order over INGEST_IV's 2
    hours, each at its own millisecond (one producer's partition), dimA
    uniform over 100 values, dimB a bounded zipf (1.5) over 1000, metLong
    0..10000, metFloat normal(100, 25) as float32. One dict of arrays per
    partition, the stream in order."""
    from druid_tpu_torch.utils.intervals import Interval
    n = INGEST_EVENTS if n is None else n
    iv = Interval.of(*INGEST_IV)
    rng = np.random.default_rng(seed)
    probs = np.arange(1, 1001, dtype=np.float64) ** -1.5
    probs /= probs.sum()
    per = n // INGEST_PARTITIONS
    return [{"t": iv.start + np.sort(rng.choice(iv.width, size=per,
                                                replace=False)).astype(
                                                    np.int64),
             "a": rng.integers(0, 100, size=per).astype(np.int64),
             "b": rng.choice(1000, size=per, p=probs).astype(np.int64),
             "ml": rng.integers(0, 10_001, size=per).astype(np.int64),
             "mf": rng.normal(100.0, 25.0, size=per).astype(np.float32)}
            for _ in range(INGEST_PARTITIONS)]


_NAMES_A = [f"v{i:08d}" for i in range(100)]
_NAMES_B = [f"v{i:08d}" for i in range(1000)]


def ingest_records(ev, lo, hi):
    """Partition events [lo, hi) as the records a consumer hands the
    parser."""
    return [{"timestamp": t, "dimA": _NAMES_A[a], "dimB": _NAMES_B[b],
             "metLong": ml, "metFloat": mf}
            for t, a, b, ml, mf in zip(
                ev["t"][lo:hi].tolist(), ev["a"][lo:hi].tolist(),
                ev["b"][lo:hi].tolist(), ev["ml"][lo:hi].tolist(),
                ev["mf"][lo:hi].tolist())]


def ingest_specs():
    """The supervisor's metricsSpec: the row count, metLong summed,
    metFloat summed and its max (queried through their combining forms)."""
    from druid_tpu_torch.query import aggregators as A
    return [A.CountAggregator("count"),
            A.LongSumAggregator("metLong", "metLong"),
            A.FloatSumAggregator("metFloat", "metFloat"),
            A.FloatMaxAggregator("metFloatMax", "metFloat")]


_ROWS = {"type": "longSum", "name": "rows", "fieldName": "count"}
_LSUM = {"type": "longSum", "name": "lsum", "fieldName": "metLong"}


def ingest_queries(head):
    """The four main-path queries over the ingested datasource (`head`:
    dimB's most frequent value, which the filtered groupBy drops)."""
    iv = f"{INGEST_IV[0]}/{INGEST_IV[1]}"
    fmax = {"type": "floatMax", "name": "fmax", "fieldName": "metFloatMax"}
    bound = {"type": "bound", "dimension": "metLong", "lower": "100",
             "upper": "9900", "ordering": "numeric"}
    groupby = {"queryType": "groupBy", "dataSource": "ingest",
               "intervals": [iv], "granularity": "all",
               "dimensions": ["dimA", "dimB"],
               "aggregations": [_ROWS, _LSUM, fmax], "filter": bound}
    return {
        "groupby": groupby,
        "topn": {"queryType": "topN", "dataSource": "ingest",
                 "intervals": [iv], "granularity": "all",
                 "dimension": "dimB", "metric": "lsum", "threshold": 100,
                 "aggregations": [_ROWS, _LSUM],
                 "filter": {"type": "in", "dimension": "dimA",
                            "values": _NAMES_A[0:100:2]}},
        "timeseries": {"queryType": "timeseries", "dataSource": "ingest",
                       "intervals": [iv], "granularity": "hour",
                       "aggregations": [_ROWS, _LSUM, fmax, {
                           "type": "doubleSum", "name": "dsum",
                           "fieldName": "metFloat"}]},
        "groupby_filtered": dict(groupby, filter={"type": "and", "fields": [
            {"type": "in", "dimension": "dimA",
             "values": _NAMES_A[0:100:2]},
            {"type": "not", "field": {"type": "selector",
                                      "dimension": "dimB", "value": head}},
            bound]})}


def ingest_standing_queries(datasource="ingest"):
    """The two standing queries: an hourly timeseries (rows, longSum,
    doubleSum) and a groupBy by dimA (rows, longSum, doubleMax)."""
    iv = f"{INGEST_IV[0]}/{INGEST_IV[1]}"
    return {
        "timeseries": {"queryType": "timeseries", "dataSource": datasource,
                       "intervals": [iv], "granularity": "hour",
                       "aggregations": [_ROWS, _LSUM, {
                           "type": "doubleSum", "name": "dsum",
                           "fieldName": "metFloat"}]},
        "groupby_dima": {"queryType": "groupBy", "dataSource": datasource,
                         "intervals": [iv], "granularity": "all",
                         "dimensions": ["dimA"],
                         "aggregations": [_ROWS, _LSUM, {
                             "type": "doubleMax", "name": "dmax",
                             "fieldName": "metFloatMax"}]}}


def ingest_reference(events, t0):
    """numpy_reference's dictionary for the four queries over the rows the
    ingestion stores (each event one row of count 1: no two events of a
    partition share a millisecond, so nothing rolls up); and dimB's most
    frequent id in partition 0."""
    G = 100 * 1000
    ref = dict(cnt=np.zeros(G), lsum=np.zeros(G),
               fmax=np.full(G, -np.inf, np.float32), f_cnt=np.zeros(G),
               f_lsum=np.zeros(G), f_fmax=np.full(G, -np.inf, np.float32),
               tb_cnt=np.zeros(1000), tb_lsum=np.zeros(1000),
               h_cnt=np.zeros(24), h_lsum=np.zeros(24),
               h_fmax=np.full(24, -np.inf, np.float32),
               h_dsum=np.zeros(24), h_abs=np.zeros(24), t0=t0)
    head = int(np.bincount(events[0]["b"], minlength=1000).argmax())
    for ev in events:
        t, a, b, ml, f = ev["t"], ev["a"], ev["b"], ev["ml"], ev["mf"]
        keep = (ml >= 100) & (ml <= 9900)
        key = a * 1000 + b
        for pre, sel in (("", keep),
                         ("f_", keep & (a % 2 == 0) & (b != head))):
            ref[pre + "cnt"] += np.bincount(key[sel], minlength=G)
            ref[pre + "lsum"] += np.bincount(key[sel], weights=ml[sel],
                                             minlength=G)
            np.maximum.at(ref[pre + "fmax"], key[sel], f[sel])
        even = a % 2 == 0
        ref["tb_cnt"] += np.bincount(b[even], minlength=1000)
        ref["tb_lsum"] += np.bincount(b[even], weights=ml[even],
                                      minlength=1000)
        h = (t - t0) // HOUR_MS
        f64 = f.astype(np.float64)
        ref["h_cnt"] += np.bincount(h, minlength=24)
        ref["h_lsum"] += np.bincount(h, weights=ml, minlength=24)
        np.maximum.at(ref["h_fmax"], h, f)
        ref["h_dsum"] += np.bincount(h, weights=f64, minlength=24)
        ref["h_abs"] += np.bincount(h, weights=np.abs(f64), minlength=24)
    for k in ("cnt", "lsum", "f_cnt", "f_lsum", "tb_cnt", "tb_lsum",
              "h_cnt", "h_lsum"):
        ref[k] = ref[k].astype(np.int64)
    return ref, head


class IngestTally:
    """numpy over the events ingested so far, for the standing queries:
    per hour rows, long sum, float sum and |v| sum; per dimA rows, long
    sum and float max."""

    def __init__(self, t0):
        self.t0 = t0
        self.h_cnt = np.zeros(2, np.int64)
        self.h_lsum = np.zeros(2, np.int64)
        self.h_dsum = np.zeros(2, np.float64)
        self.h_abs = np.zeros(2, np.float64)
        self.a_cnt = np.zeros(100, np.int64)
        self.a_lsum = np.zeros(100, np.int64)
        self.a_max = np.full(100, -np.inf, np.float32)
        self.n = 0

    def add(self, ev, lo, hi):
        if hi <= lo:
            return
        h = (ev["t"][lo:hi] - self.t0) // HOUR_MS
        a, ml = ev["a"][lo:hi], ev["ml"][lo:hi]
        mf = ev["mf"][lo:hi].astype(np.float64)
        self.h_cnt += np.bincount(h, minlength=2)
        self.h_lsum += np.bincount(h, weights=ml, minlength=2).astype(
            np.int64)
        self.h_dsum += np.bincount(h, weights=mf, minlength=2)
        self.h_abs += np.bincount(h, weights=np.abs(mf), minlength=2)
        self.a_cnt += np.bincount(a, minlength=100)
        self.a_lsum += np.bincount(a, weights=ml, minlength=100).astype(
            np.int64)
        np.maximum.at(self.a_max, a, ev["mf"][lo:hi])
        self.n += hi - lo


def check_standing(name, rows, tally, want=None):
    """A standing snapshot's rows against numpy over the events so far
    (`want` None), or against `want` (the re-scan) with numpy's |v| sums:
    counts, long sums and maxima equal, float sums within 1e-5 * sum|v|
    per group."""
    if name == "timeseries":
        live = np.flatnonzero(tally.h_cnt)
        if len(rows) != len(live):
            raise AssertionError(f"standing {name}: {len(rows)} buckets, "
                                 f"numpy {len(live)}")
        for r, w in zip(rows, want or [None] * len(rows)):
            i = (r["timestamp"] - tally.t0) // HOUR_MS
            v = r["result"]
            exp = (w["result"]["rows"], w["result"]["lsum"],
                   w["result"]["dsum"]) if w is not None else (
                int(tally.h_cnt[i]), int(tally.h_lsum[i]),
                float(tally.h_dsum[i]))
            if (v["rows"], v["lsum"]) != exp[:2] \
                    or abs(v["dsum"] - exp[2]) > 1e-5 * tally.h_abs[i]:
                raise AssertionError(f"standing {name} bucket {i}: {v}, "
                                     f"want {exp}")
        return int(sum(r["result"]["rows"] for r in rows))
    live = np.flatnonzero(tally.a_cnt)
    if len(rows) != len(live):
        raise AssertionError(f"standing {name}: {len(rows)} rows, numpy "
                             f"{len(live)}")
    wants = {w["event"]["dimA"]: w["event"] for w in want or []}
    for r in rows:
        e = r["event"]
        a = int(e["dimA"][1:])
        w = wants.get(e["dimA"]) if want is not None else {
            "rows": int(tally.a_cnt[a]), "lsum": int(tally.a_lsum[a]),
            "dmax": float(tally.a_max[a])}
        if w is None or (e["rows"], e["lsum"], e["dmax"]) != (
                w["rows"], w["lsum"], w["dmax"]):
            raise AssertionError(f"standing {name} dimA {a}: {e}, want {w}")
    return int(sum(r["event"]["rows"] for r in rows))


class FoldLog:
    """Wraps engines.make_partials_by_segment while active: every segment
    each standing fold passes, by program (its query), so that no segment
    folds twice in one program (each hydrant folds exactly once)."""

    def __enter__(self):
        import weakref
        from druid_tpu_torch.engine import engines
        self.engines, self.orig = engines, engines.make_partials_by_segment
        self.seen, self.calls, self.twice = {}, 0, []
        orig = self.orig

        def wrapped(query, segments, device, clamp=False, check=None):
            seen = self.seen.setdefault(id(query), {})
            for s in segments:
                ref = seen.get(id(s))
                if ref is not None and ref() is s:
                    self.twice.append(str(s.id))
                seen[id(s)] = weakref.ref(s)
            self.calls += 1
            return orig(query, segments, device, clamp=clamp, check=check)
        engines.make_partials_by_segment = wrapped
        return self

    def __exit__(self, *exc):
        self.engines.make_partials_by_segment = self.orig


def http_get(port, path, headers=None, timeout=60):
    """GET: (status, headers, JSON body or None, ms)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, hdrs, body = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, dict(e.headers), e.read()
    return status, hdrs, (json.loads(body) if body else None), \
        (time.perf_counter() - t) * 1e3


def _cuda_memory(dev):
    import torch
    if dev.type != "cuda":
        return {}
    m = torch.cuda.memory_stats(dev)
    return {k: int(m.get(k, 0)) for k in (
        "allocated_bytes.all.current", "allocated_bytes.all.peak",
        "reserved_bytes.all.current", "num_alloc_retries")}


def ingest_a7(dev, events):
    """A7's measurement: one live hydrant of INGEST_HYDRANT_ROWS rows (a
    separate datasource, fed partition 0's first events) refolded by a
    standing groupBy INGEST_REFOLDS times, a few rows appended before each
    tick; the tick's ms and torch.cuda.memory_stats before, after and at
    every refold, and the device pool's entries and resident bytes (read
    after the memory: a pool call drains the blocks of snapshots collected
    since the last one); every refold's rows against the re-scan."""
    import torch
    from druid_tpu_torch.cluster import MetadataStore
    from druid_tpu_torch.data.devicepool import device_pool
    from druid_tpu_torch.engine.standing import StandingQuery
    from druid_tpu_torch.ingest import (Appenderator, RowBatch,
                                        SegmentAllocator)
    from druid_tpu_torch.query.model import query_from_json
    ev = events[0]
    n = min(INGEST_HYDRANT_ROWS, len(ev["t"]) - 1000 * INGEST_REFOLDS)
    app = Appenderator("ingest_a7", ingest_specs(),
                       max_rows_per_hydrant=10 * INGEST_HYDRANT_ROWS)
    ident = SegmentAllocator(MetadataStore(), "hour").allocate(
        "ingest_a7", int(ev["t"][0]))

    def batch(lo, hi):
        return RowBatch(ev["t"][lo:hi].tolist(), {
            "dimA": [_NAMES_A[i] for i in ev["a"][lo:hi].tolist()],
            "dimB": [_NAMES_B[i] for i in ev["b"][lo:hi].tolist()],
            "metLong": ev["ml"][lo:hi].tolist(),
            "metFloat": ev["mf"][lo:hi].tolist()})
    app.add(ident, batch(0, n))
    q = query_from_json(ingest_standing_queries("ingest_a7")["groupby_dima"])
    sq = StandingQuery(q, [app], device=dev)
    pool = device_pool()
    try:
        sq.tick()
        torch.cuda.synchronize()
        before = {"memory": _cuda_memory(dev),
                  "pool": dataclasses.asdict(pool.snapshot())}
        ticks, memory, resident = [], [], []
        lo = n
        for i in range(INGEST_REFOLDS):
            hi = min(lo + 1000, len(ev["t"]))
            app.add(ident, batch(lo, hi))
            lo = hi
            if dev.type == "cuda":
                # the peak then reads this refold's temporaries
                torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            if sq.tick() is None:
                raise AssertionError(f"A7 refold {i}: no emission")
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t) * 1e3)
            memory.append(_cuda_memory(dev))
            resident.append(pool.snapshot().resident_bytes)
        after = {"memory": _cuda_memory(dev),
                 "pool": dataclasses.asdict(pool.snapshot())}
        if not same_rows(sq.rows(), sq.rescan_rows()):
            raise AssertionError("A7: the refolded rows differ from the "
                                 "re-scan")
        if len(sq.world_segments()) != 1:
            raise AssertionError("A7: the live hydrant was sealed")
    finally:
        sq.close()
    res = {"live_rows": lo, "refolds": INGEST_REFOLDS, "tick_ms": ticks,
           "tick_ms_first": ticks[0], "tick_ms_p50": float(np.median(ticks)),
           "tick_ms_max": float(max(ticks)), "before": before,
           "after": after, "by_refold": memory,
           "pool_resident_by_refold": resident}
    mb, ma = before["memory"], after["memory"]
    mib = {f"{k}_{w}": [round(m.get(f"{k}_bytes.all.{w}", 0) / 2**20, 2)
                        for m in memory]
           for k, w in (("allocated", "current"), ("allocated", "peak"),
                        ("reserved", "current"))}
    log(f"  A7: {INGEST_REFOLDS} refolds of a live hydrant of {lo} rows: "
        f"tick ms first {ticks[0]:.1f}, p50 {res['tick_ms_p50']:.1f}, max "
        f"{res['tick_ms_max']:.1f}; memory before {mb}, after {ma}; MiB by "
        f"refold allocated {mib['allocated_current']}, its peak in the "
        f"refold {mib['allocated_peak']}, reserved "
        f"{mib['reserved_current']}, "
        f"pool resident {[round(r / 2**20, 2) for r in resident]}; "
        f"pool entries {before['pool']['entries']} -> "
        f"{after['pool']['entries']}, resident "
        f"{before['pool']['resident_bytes']} -> "
        f"{after['pool']['resident_bytes']} B")
    return res


def phase_ingest(dev):
    """Phase 21: streaming ingestion into the port, standing queries on its
    hydrants, queries through the broker before publish, the subscription
    surface, the transactional publish and the handoff to a historical.
    Returns (report, {"B1": launches, "B2": launches}). The ingest loop
    runs under Python's cyclic collector as the process sets it; its
    collections in the loop are timed (gc.callbacks), not changed.

    Cuts from the deployment: each task reads 5M events, under the task
    roll-over (maxTotalRows 20M, INGEST_TASK_ROWS; taskDuration PT1H of
    wall time is never reached), so no task rolls over here; the roll-over
    runs in tests/test_torch_realtime.py. maxRowsPerSegment is checked on
    the sinks after ingest, not enforced: the port, as the reference, has
    no per-sink bound."""
    import gc
    import shutil
    import tempfile
    import threading
    import torch
    from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                         MetadataStore, RealtimeServer,
                                         ResiliencePolicy)
    from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.engine import standing
    from druid_tpu_torch.engine.kernels import make_kernel
    from druid_tpu_torch.ingest import (SimulatedStream, StreamSupervisor,
                                        StreamSupervisorSpec,
                                        StreamTuningConfig)
    from druid_tpu_torch.ingest.appenderator import Sink
    from druid_tpu_torch.ingest.input import (DimensionsSpec,
                                              InputRowParser, TimestampSpec)
    from druid_tpu_torch.query import aggregators as A
    from druid_tpu_torch.query.model import query_from_json
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
    from druid_tpu_torch.server.scheduler import (DataNodeScheduler,
                                                  SchedulerConfig)
    from druid_tpu_torch.server.subscriptions import SubscriptionHub
    from druid_tpu_torch.storage.deep import LocalDeepStorage
    from druid_tpu_torch.utils.intervals import Interval
    t_phase = time.perf_counter()
    base = (sr.LAUNCHES, mk.LAUNCHES)
    sr.LAUNCHES = mk.LAUNCHES = 0
    out = {"events": INGEST_EVENTS, "partitions": INGEST_PARTITIONS,
           "max_rows_per_hydrant": INGEST_HYDRANT_ROWS}
    t0 = Interval.of(*INGEST_IV).start
    t = time.perf_counter()
    events = ingest_events()
    ref, head_id = ingest_reference(events, t0)
    qs = ingest_queries(f"v{head_id:08d}")
    out["gen_s"] = time.perf_counter() - t
    per = len(events[0]["t"])
    log(f"  {INGEST_EVENTS} events ({INGEST_PARTITIONS} partitions of "
        f"{per}) made and their numpy reference in {out['gen_s']:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_ingest_")
    hub = sched = http = broker = peon = None
    try:
        # the cluster: a realtime server and a historical on one view, a
        # broker (hedging off) behind the query resource with the hub
        view = InventoryView()
        rt = RealtimeServer("peon0", view, device=dev)
        hist = DataNode("historical0", device=dev)
        view.register(hist)
        broker = Broker(view, device=dev, resilience_policy=ResiliencePolicy(
            hedge_enabled=False))
        hub = SubscriptionHub(idle_timeout_s=0, device=dev)
        http = QueryHttpServer(QueryLifecycle(broker),
                               subscription_hub=hub).start()
        md = MetadataStore()
        deep = LocalDeepStorage(os.path.join(tmp, "deep"))
        peon = LoadQueuePeon(hist, view, deep.pull)
        handoff_s = []

        def handoff(pushed):
            t = time.perf_counter()
            for d, _ in pushed:
                if not peon.load(d):
                    raise AssertionError(f"handoff load of {d.id} refused")
            if not peon.wait_idle(300.0):
                raise AssertionError("the handoff loads did not drain")
            handoff_s.append(time.perf_counter() - t)

        parser = InputRowParser(TimestampSpec("timestamp", "millis"),
                                DimensionsSpec(("dimA", "dimB")))
        parse_s = [0.0]
        parse_orig = parser.parse_batch

        def timed_parse(records):
            t = time.perf_counter()
            try:
                return parse_orig(records)
            finally:
                parse_s[0] += time.perf_counter() - t
        parser.parse_batch = timed_parse
        persists = []
        persist_orig = Sink.persist_hydrant

        def timed_persist(sink):
            rows = sink.index.n_rows
            t = time.perf_counter()
            persist_orig(sink)
            if rows:
                persists.append(((time.perf_counter() - t) * 1e3, rows))
        stream = SimulatedStream(INGEST_PARTITIONS)
        sup = StreamSupervisor(
            StreamSupervisorSpec(
                "ingest", ingest_specs(), dimensions=["dimA", "dimB"],
                task_count=INGEST_PARTITIONS,
                max_rows_per_task=INGEST_TASK_ROWS,
                tuning=StreamTuningConfig(
                    max_rows_per_hydrant=INGEST_HYDRANT_ROWS,
                    max_records_per_poll=INGEST_POLL_RECORDS,
                    segment_granularity="hour", query_granularity="none")),
            stream, md, parser=parser, handoff=handoff, deep_storage=deep,
            realtime=rt)
        # the two standing queries subscribe before the first event; the
        # tasks (one per partition) start on the empty stream
        sqs = ingest_standing_queries()
        subs = {name: hub.subscribe(query_from_json(q))
                for name, q in sqs.items()}
        sup.run_once()
        for task in sup.tasks.values():
            hub.attach(task.driver.appenderator)
        programs = {name: p.standing for name, p in zip(
            sqs, hub._programs.values())}
        if hub.active_programs() != 2 or len(sup.tasks) != 2:
            raise AssertionError("phase ingest: programs or tasks missing")

        # 1-2. ingest with a standing tick every INGEST_TICK_EVERY events
        t = time.perf_counter()
        for p, ev in enumerate(events):
            stream.append(p, ingest_records(ev, 0, per - INGEST_HOLDBACK))
        out["append_s"] = time.perf_counter() - t
        tally = IngestTally(t0)
        done = [0] * INGEST_PARTITIONS
        ticks, folds_per_tick = [], []
        next_tick = INGEST_TICK_EVERY
        t_ingest = time.perf_counter()
        tick_s = check_s = 0.0
        Sink.persist_hydrant = timed_persist
        collector = {"s": 0.0, "t": 0.0, "stats": gc.get_stats()}

        def timed_collect(phase, info):
            if phase == "start":
                collector["t"] = time.perf_counter()
            else:
                collector["s"] += time.perf_counter() - collector["t"]
        gc.callbacks.append(timed_collect)
        try:
            with FoldLog() as flog:
                while True:
                    sup.run_once()
                    offs = [sup.tasks[g].current_offsets[p]
                            for g in range(INGEST_PARTITIONS)
                            for p in sup.tasks[g].partitions]
                    lag = sum(stream.latest_offset(p) - o
                              for p, o in enumerate(offs))
                    if sum(offs) < next_tick and lag:
                        continue
                    next_tick += INGEST_TICK_EVERY
                    for p, ev in enumerate(events):
                        tally.add(ev, done[p], offs[p])
                        done[p] = offs[p]
                    s0 = standing.stats().snapshot()
                    tt = time.perf_counter()
                    hub.tick()
                    torch.cuda.synchronize()
                    ticks.append((time.perf_counter() - tt) * 1e3)
                    tick_s += ticks[-1] / 1e3
                    folds_per_tick.append(standing.stats().snapshot()[
                        "folds"] - s0["folds"])
                    tc = time.perf_counter()
                    for name, sq in programs.items():
                        snap = sq.snapshot()
                        n = check_standing(name, snap.rows, tally)
                        if n != tally.n:
                            raise AssertionError(f"standing {name}: {n} "
                                                 f"rows, {tally.n} events")
                        rescan = sq.rescan_rows()
                        check_standing(name, rescan, tally)
                        check_standing(name, snap.rows, tally, rescan)
                    check_s += time.perf_counter() - tc
                    if not lag:
                        break
        finally:
            Sink.persist_hydrant = persist_orig
            gc.callbacks.remove(timed_collect)
            by_gen = [b["collections"] - a["collections"] for a, b in
                      zip(collector["stats"], gc.get_stats())]
            collector.update(n=sum(by_gen), full=by_gen[2])
        ingest_s = time.perf_counter() - t_ingest
        if flog.twice:
            raise AssertionError(f"segments folded twice: {flog.twice[:4]}")
        n_in = tally.n
        host_s = ingest_s - tick_s - check_s
        out["ingest"] = {
            "events": n_in, "s": ingest_s, "ticks_s": tick_s,
            "checks_s": check_s,
            "events_per_s": n_in / host_s, "parse_s": parse_s[0],
            "parse_events_per_s": n_in / parse_s[0],
            "rollup_s": host_s - parse_s[0],
            "rollup_events_per_s": n_in / (host_s - parse_s[0]),
            "collector_s": collector["s"],
            "collections": collector["n"],
            "full_collections": collector["full"],
            "hydrant_persist_ms": [ms for ms, _ in persists],
            "hydrant_persist_rows": [r for _, r in persists]}
        out["standing"] = {"ticks": len(ticks), "tick_ms": ticks,
                           "tick_ms_p50": float(np.median(ticks)),
                           "tick_ms_max": float(max(ticks)),
                           "folds_per_tick": folds_per_tick,
                           "fold_calls": flog.calls}
        log(f"  ingest: {n_in} events in {ingest_s:.1f} s ({tick_s:.1f} s "
            f"of it in {len(ticks)} standing ticks, {check_s:.1f} s in their "
            f"checks): "
            f"{out['ingest']['events_per_s']:.0f} events/s on the host, "
            f"parse {out['ingest']['parse_events_per_s']:.0f}/s "
            f"({parse_s[0]:.1f} s), rollup "
            f"{out['ingest']['rollup_events_per_s']:.0f}/s "
            f"({out['ingest']['rollup_s']:.1f} s); Python's collector "
            f"{collector['s']:.1f} s of the loop in {collector['n']} "
            f"collections ({collector['full']} full); hydrant persists "
            f"{[round(ms, 1) for ms, _ in persists]} ms at rows "
            f"{[r for _, r in persists]}")
        log(f"  standing: {len(ticks)} ticks, tick ms p50 "
            f"{out['standing']['tick_ms_p50']:.1f}, max "
            f"{out['standing']['tick_ms_max']:.1f}; folds per tick "
            f"{folds_per_tick}; every snapshot equals numpy and the "
            f"re-scan, no segment folded twice")

        # 3. A7: refolds of one live hydrant
        out["a7"] = ingest_a7(dev, events)

        # 5. the subscription surface, ticked by the scheduler's flush loop
        port = http.port
        status, _, body, _, _ = http_post(
            port, sqs["timeseries"], path="/druid/v2/subscriptions")
        if status != 200 or hub.active_programs() != 2:
            raise AssertionError(f"subscribe: status {status}, programs "
                                 f"{hub.active_programs()}")
        sub_id = body["subscriptionId"]
        status, hdrs, rows, _ = http_get(port,
                                         f"/druid/v2/subscriptions/{sub_id}")
        etag = hdrs.get("X-Druid-ETag")
        before_rows = sum(r["result"]["rows"] for r in rows)
        status304, _, _, ms304 = http_get(
            port, f"/druid/v2/subscriptions/{sub_id}?timeoutMs=300",
            {"If-None-Match": etag})
        if status304 != 304 or not 250 <= ms304 < 5000:
            raise AssertionError(f"unchanged long-poll: {status304} in "
                                 f"{ms304:.0f} ms")
        sched = DataNodeScheduler(hist, SchedulerConfig()).start()
        hub.drive_with(sched)
        parked = {}

        def park():
            parked["r"] = http_get(
                port, f"/druid/v2/subscriptions/{sub_id}?timeoutMs=30000",
                {"If-None-Match": etag}, timeout=60)
            parked["t"] = time.perf_counter()
        th = threading.Thread(target=park, name="ingest-parked-poll")
        th.start()
        time.sleep(0.3)
        t_new = time.perf_counter()
        for p, ev in enumerate(events):
            stream.append(p, ingest_records(ev, per - INGEST_HOLDBACK, per))
        while True:
            sup.run_once()
            offs = [sup.tasks[g].current_offsets[p]
                    for g in range(INGEST_PARTITIONS)
                    for p in sup.tasks[g].partitions]
            if sum(stream.latest_offset(p) - o
                   for p, o in enumerate(offs)) == 0:
                break
        th.join(timeout=60)
        if th.is_alive() or parked["r"][0] != 200:
            raise AssertionError("the parked long-poll did not wake")
        wake_rows = sum(r["result"]["rows"] for r in parked["r"][2])
        new_etag = parked["r"][1].get("X-Druid-ETag")
        if new_etag == etag or not before_rows < wake_rows <= INGEST_EVENTS:
            raise AssertionError(f"parked poll woke with {wake_rows} rows, "
                                 f"etag {new_etag}")
        for p, ev in enumerate(events):
            tally.add(ev, done[p], per)
            done[p] = per
        hub.tick()
        for name, sq in programs.items():
            if check_standing(name, sq.rows(), tally) != INGEST_EVENTS:
                raise AssertionError(f"standing {name}: not every event")
            check_standing(name, sq.rows(), tally, sq.rescan_rows())
        out["subscription"] = {
            "id": sub_id, "unchanged_status": status304,
            "unchanged_ms": ms304, "wake_ms": (parked["t"] - t_new) * 1e3,
            "wake_rows": wake_rows, "rows_before": before_rows}
        log(f"  subscription {sub_id}: 304 on an unchanged ETag in "
            f"{ms304:.0f} ms (timeoutMs 300); a poll parked before "
            f"{INGEST_PARTITIONS * INGEST_HOLDBACK} new events woke after "
            f"{out['subscription']['wake_ms']:.0f} ms with {wake_rows} rows "
            f"(had {before_rows}), ticked by the scheduler's flush loop")
        sinks = [(str(i.id), app.rows_in(i)) for task in sup.tasks.values()
                 for app in [task.driver.appenderator]
                 for i in app.sink_ids()]
        hydrants = [len(s.hydrants) for task in sup.tasks.values()
                    for s in task.driver.appenderator._sinks.values()]
        if max(r for _, r in sinks) > INGEST_SEGMENT_ROWS:
            raise AssertionError(f"a sink holds more than "
                                 f"maxRowsPerSegment: {sinks}")
        out["sinks"] = {"rows": [r for _, r in sinks],
                        "persisted_hydrants": hydrants}
        log(f"  sinks: {len(sinks)}, rows {[r for _, r in sinks]}, "
            f"persisted hydrants {hydrants}")

        # 4. the four queries before publish, through the realtime server
        checks = {"groupby": check_groupby, "topn": check_topn,
                  "timeseries": lambda rows, ref: check_timeseries(
                      rows, ref, buckets=2),
                  "groupby_filtered": check_filtered}

        def serve(tag, want):
            res, kept = {}, {}
            for name, q in qs.items():
                runs, got = [], None
                for i in range(1 + INGEST_WARM):
                    l0 = (sr.LAUNCHES, mk.LAUNCHES)
                    if i == 0:
                        with StrategyLog() as slog:
                            status, _, rows, ms, _ = http_post(port, q)
                    else:
                        status, _, rows, ms, _ = http_post(port, q)
                    got_l = (sr.LAUNCHES - l0[0], mk.LAUNCHES - l0[1])
                    if status != 200 or (want(name) is not None
                                         and got_l != want(name)):
                        raise AssertionError(
                            f"{tag} {name}: status {status}, (B1, B2) "
                            f"{got_l}, expected {want(name)}; strategies "
                            f"{slog.strategies}")
                    if i == 0:
                        checks[name](rows, ref)
                        kept[name], got = rows, got_l
                    runs.append(ms)
                res[name] = {"cold_ms": runs[0], "warm_ms": runs[1:],
                             "p50_ms": float(np.median(runs[1:])),
                             "strategies": slog.strategies,
                             "b1_b2_launches_per_run": list(got)}
                log(f"  {tag} {name}: rows equal numpy; strategy per "
                    f"segment {slog.strategies}; cold {runs[0]:.1f} ms, "
                    f"warm p50 {res[name]['p50_ms']:.1f} ms; (B1, B2) "
                    f"{got} a run")
            return res, kept
        out["before_publish"], rows_before = serve(
            "before publish", lambda name: None)

        # 6. publish and handoff
        flat = []
        stop_poll = threading.Event()
        etag_now = http_get(port, f"/druid/v2/subscriptions/{sub_id}")[1][
            "X-Druid-ETag"]

        def poller(etag=etag_now):
            while not stop_poll.is_set():
                st, h, rows, _ = http_get(
                    port, f"/druid/v2/subscriptions/{sub_id}?timeoutMs=500",
                    {"If-None-Match": etag})
                if st == 200:
                    etag = h["X-Druid-ETag"]
                    flat.append(sum(r["result"]["rows"] for r in rows))
        pt = threading.Thread(target=poller, name="ingest-cutover-poll")
        pt.start()
        c0 = standing.stats().snapshot()["cutovers"]
        t = time.perf_counter()
        ok = sup.checkpoint_all()
        publish_s = time.perf_counter() - t - sum(handoff_s)
        hub.tick()
        time.sleep(0.6)
        stop_poll.set()
        pt.join(timeout=30)
        if not ok or pt.is_alive():
            raise AssertionError(f"checkpoint_all {ok}")
        meta = md.datasource_metadata("ingest")
        used = md.used_segments("ingest")
        want_meta = {str(p): per for p in range(INGEST_PARTITIONS)}
        if meta != {"partitions": want_meta} \
                or sum(d.num_rows for d in used) != INGEST_EVENTS:
            raise AssertionError(f"committed {meta}, used rows "
                                 f"{sum(d.num_rows for d in used)}")
        cutovers = standing.stats().snapshot()["cutovers"] - c0
        if rt.served_segment_ids() or hist.segment_count() != len(used) \
                or cutovers != len(used) * len(programs):
            raise AssertionError(
                f"handoff: realtime serves {rt.served_segment_ids()}, the "
                f"historical {hist.segment_count()}, cutovers {cutovers}")
        if any(n != INGEST_EVENTS for n in flat):
            raise AssertionError(f"an emission across the cutover counted "
                                 f"{sorted(set(flat))} rows")
        for name, sq in programs.items():
            if check_standing(name, sq.rows(), tally) != INGEST_EVENTS:
                raise AssertionError(f"standing {name} after the cutover")
            check_standing(name, sq.rows(), tally, sq.rescan_rows())
        out["publish"] = {"s": publish_s, "handoff_s": sum(handoff_s),
                          "segments": len(used),
                          "rows": [d.num_rows for d in used],
                          "bytes": [d.size_bytes for d in used],
                          "offsets": meta, "cutovers": cutovers,
                          "emissions_across": len(flat)}
        log(f"  publish: checkpoint_all in {publish_s:.1f} s (merge, push "
            f"to deep storage, commit with offsets {meta}); handoff "
            f"{sum(handoff_s):.1f} s ({len(used)} segments of "
            f"{[d.num_rows for d in used]} rows, through the load queue); "
            f"sinks unannounced; {cutovers} standing cutovers, "
            f"{len(flat)} emissions across the boundary each count "
            f"{INGEST_EVENTS}")

        # 7. the four queries after handoff. A longSum over a LONG column
        # whose min equals its max sums as count x c, and such a kernel
        # keeps a groupBy off the projection (the reference's rule): over
        # a segment where nothing rolled up, `count` is constant and the
        # groupBys run mixed; elsewhere B1 (B2 filtered) once a segment
        const = sum(make_kernel(A.LongSumAggregator("rows", "count"),
                                seg).const_value is not None
                    for seg in hist.segments())
        n_proj = len(used) - const
        want_l = {"groupby": (n_proj, 0), "groupby_filtered": (0, n_proj)}
        out["after_handoff"], rows_after = serve(
            "after handoff", lambda name: want_l.get(name, (0, 0)))
        for name, strat in (("groupby", "projection"),
                            ("groupby_filtered", "megakernel")):
            got_s = [s for s, _ in out["after_handoff"][name]["strategies"]]
            if got_s.count(strat) != n_proj \
                    or got_s.count("mixed") != const:
                raise AssertionError(
                    f"after handoff {name}: strategies {got_s}, expected "
                    f"{strat} x{n_proj} and mixed x{const}")
        out["publish"]["count_constant_segments"] = const
        log(f"  after handoff: {const} of {len(used)} published segments "
            f"hold a constant count column, so their groupBys run mixed "
            f"(B1/B2 once for each of the other {n_proj})")
        for name in qs:
            if not same_rows(rows_before[name], rows_after[name], rel=1e-5):
                raise AssertionError(f"{name}: rows after handoff differ "
                                     f"from before publish")
            a, b = out["after_handoff"][name], out["before_publish"][name]
            a["before_p50_ms"], a["before_cold_ms"] = b["p50_ms"], b["cold_ms"]
            log(f"  {name}: cold {b['cold_ms']:.1f} -> {a['cold_ms']:.1f} "
                f"ms, warm p50 {b['p50_ms']:.1f} -> {a['p50_ms']:.1f} ms "
                f"(before publish -> after handoff); rows equal")

        # 8. the pool
        out["pool"] = pool_snapshot("ingest")
    finally:
        for x in (hub, sched, http, broker, peon):
            if x is not None:
                x.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    counted = {"B1": sr.LAUNCHES, "B2": mk.LAUNCHES}
    sr.LAUNCHES, mk.LAUNCHES = base
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase ingest took {out['phase_s']:.1f} s; (B1, B2) launched "
        f"{counted}; temporary directory removed; {card_line()}")
    if out["phase_s"] > INGEST_PHASE_LIMIT_S:
        raise AssertionError(f"phase ingest took {out['phase_s']:.1f} s, "
                             f"over {INGEST_PHASE_LIMIT_S} s")
    return out, counted


# ---------------------------------------------------------------------------
# phase 22: the mesh (druid_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

SHARDED_WARM = 3                     # warm runs a query (p50 of 3)
SHARDED_PHASE_LIMIT_S = 120.0        # alone, it pays phase 6's cold runs too


def sharded_metrics():
    """query/sharded/* as ShardedMonitor emits them now."""
    from druid_tpu_torch.parallel.distributed import ShardedMonitor
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    sink = InMemoryEmitter()
    ShardedMonitor().do_monitor(ServiceEmitter("chip_smoke", "card", sink))
    return {e.metric: e.value for e in sink.metrics()}


def phase_sharded(dev, segments, qs, ref):
    """Phase 22: the four main-path queries through QueryExecutor(segments,
    mesh=make_mesh()) on phase 6's 8 segments, beside the same queries
    without a mesh, and one groupBy through a DataNode(mesh=...) behind the
    in-process broker. Returns (report, {"B1": n, "B2": n} launched by the
    mesh runs)."""
    import torch
    from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                         descriptor_for)
    from druid_tpu_torch.data.devicepool import device_pool
    from druid_tpu_torch.engine import QueryExecutor, release_device_caches
    from druid_tpu_torch.engine import megakernel as mk
    from druid_tpu_torch.engine import sorted_reduce as sr
    from druid_tpu_torch.obs import dispatch
    from druid_tpu_torch.parallel import distributed, make_mesh
    t_phase = time.perf_counter()
    card = card_line()
    checks = {"groupby": check_groupby, "topn": check_topn,
              "timeseries": check_timeseries,
              "groupby_filtered": check_filtered}
    mesh = make_mesh()
    log(f"  mesh {[str(d) for d in mesh.devices]} (axis {mesh.axis!r}); "
        f"{card}")
    if mesh.size != torch.cuda.device_count():
        raise AssertionError(f"make_mesh() gave {mesh.size} shards")
    ex_mesh = QueryExecutor(segments, device=dev, mesh=mesh)
    ex_plain = QueryExecutor(segments, device=dev)
    strategies = []
    orig_try = distributed.try_sharded

    def try_spy(*a, **k):
        got = orig_try(*a, **k)
        strategies.append(None if got is None else got.spec.strategy)
        return got

    def mesh_run(name, q):
        """One mesh run: its rows checked, one sharded dispatch and no
        per-segment, batched or run-domain one."""
        kinds = dispatch.stats().snapshot()
        before = distributed.sharded_stats().snapshot()
        t = time.perf_counter()
        rows = ex_mesh.run_json(q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = distributed.sharded_stats().snapshot()
        kinds_after = dispatch.stats().snapshot()
        checks[name](rows, ref)
        # the cold run's filter words stage in "filterFill" waves
        delta = {k: kinds_after.get(k, 0) - kinds.get(k, 0)
                 for k in ("sharded", "segment", "batched", "runDomain")}
        if delta != {"sharded": 1, "segment": 0, "batched": 0,
                     "runDomain": 0} or after[0] - before[0] != 1 \
                or after[1] - before[1] != len(segments):
            raise AssertionError(f"{name} on the mesh: dispatches {delta}, "
                                 f"sharded stats {before} -> {after}")
        return ms

    out = {"card": card, "mesh": [str(d) for d in mesh.devices]}
    base = (sr.LAUNCHES, mk.LAUNCHES)
    # (B1, B2) launched by the mesh runs alone: each query's cold and warm
    # runs, read before its comparison runs, and the DataNode's run
    counted = {"B1": 0, "B2": 0}

    def count_mesh_launches():
        counted["B1"] += sr.LAUNCHES
        counted["B2"] += mk.LAUNCHES
    distributed.try_sharded = try_spy
    try:
        for name, q in qs.items():
            sr.LAUNCHES = mk.LAUNCHES = 0
            strategies.clear()
            cold = mesh_run(name, q)
            warm = [mesh_run(name, q) for _ in range(SHARDED_WARM)]
            count_mesh_launches()
            if (sr.LAUNCHES, mk.LAUNCHES) != (0, 0):
                raise AssertionError(f"{name} on the mesh launched (B1, B2) "
                                     f"{(sr.LAUNCHES, mk.LAUNCHES)} times")
            if len(set(strategies)) != 1 or strategies[0] is None:
                raise AssertionError(f"{name}: mesh strategies {strategies}")
            split = split_times(q, segments, dev, mesh=mesh)
            stack = sharded_metrics()["query/sharded/stackBytes"]
            # the same query without a mesh, beside it (measurement: its
            # B1/B2 launches are not the phase's); its first run is cold
            # where phase 6 has not run in this process
            pw = []
            for _ in range(1 + SHARDED_WARM):
                t = time.perf_counter()
                rows = ex_plain.run_json(q)
                torch.cuda.synchronize()
                pw.append((time.perf_counter() - t) * 1e3)
            checks[name](rows, ref)
            psplit = split_times(q, segments, dev)
            r = out[name] = {
                "strategy": strategies[0], "cold_ms": cold, "warm_ms": warm,
                "p50_ms": float(np.median(warm)),
                "partials_ms": split["partials_ms"],
                "finish_ms": split["finish_ms"], "stack_bytes": stack,
                "plain_first_ms": pw[0], "plain_warm_ms": pw[1:],
                "plain_p50_ms": float(np.median(pw[1:])),
                "plain_partials_ms": psplit["partials_ms"],
                "plain_finish_ms": psplit["finish_ms"]}
            log(f"  {name}: mesh ({r['strategy']}) cold {cold:.1f} ms, warm "
                f"p50 {r['p50_ms']:.1f} ms, partials "
                f"{r['partials_ms']:.1f} ms, merge+finish "
                f"{r['finish_ms']:.1f} ms, stackBytes {stack / 1e9:.3f} GB"
                f" | no mesh: first run {pw[0]:.1f} ms, warm p50 "
                f"{r['plain_p50_ms']:.1f} ms, partials "
                f"{r['plain_partials_ms']:.1f} ms, merge+finish "
                f"{r['plain_finish_ms']:.1f} ms; rows equal numpy; {card}")
        sr.LAUNCHES = mk.LAUNCHES = 0
        # one groupBy through a data node on the mesh, behind the broker
        node = DataNode("mesh0", device=dev, mesh=mesh)
        view = InventoryView()
        view.register(node)
        for s in segments:
            node.load_segment(s)
            view.announce(node.name, descriptor_for(s))
        broker = Broker(view, device=dev)
        try:
            before = distributed.sharded_stats().snapshot()
            t = time.perf_counter()
            rows = broker.run_json(qs["groupby"])
            torch.cuda.synchronize()
            node_ms = (time.perf_counter() - t) * 1e3
            after = distributed.sharded_stats().snapshot()
        finally:
            broker.stop()
        count_mesh_launches()
        check_groupby(rows, ref)
        if after[0] - before[0] != 1 or (sr.LAUNCHES, mk.LAUNCHES) != (0, 0):
            raise AssertionError(f"DataNode(mesh=): sharded stats {before} "
                                 f"-> {after}, (B1, B2) "
                                 f"{(sr.LAUNCHES, mk.LAUNCHES)}")
        out["data_node_groupby_ms"] = node_ms
        log(f"  groupby through DataNode(mesh=) behind the broker: "
            f"{node_ms:.1f} ms (cold node), one sharded run, rows equal "
            f"numpy; {card}")
    finally:
        distributed.try_sharded = orig_try
    sr.LAUNCHES, mk.LAUNCHES = base
    before = device_pool().snapshot()
    out["stack_bytes_before_release"] = before.stacked_bytes
    released = release_device_caches()
    after = sharded_metrics()
    out["released"] = released
    if before.stacked_bytes <= 0 or after["query/sharded/stackBytes"] != 0:
        raise AssertionError(f"stack bytes {before.stacked_bytes} before "
                             f"release_device_caches(), "
                             f"{after['query/sharded/stackBytes']} after")
    log(f"  release_device_caches(): {released}; stackBytes "
        f"{before.stacked_bytes / 1e9:.3f} GB -> 0; {card}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase sharded took {out['phase_s']:.1f} s; the mesh runs "
        f"launched (B1, B2) {counted}")
    if out["phase_s"] > SHARDED_PHASE_LIMIT_S:
        raise AssertionError(f"phase sharded took {out['phase_s']:.1f} s, "
                             f"over {SHARDED_PHASE_LIMIT_S} s")
    return out, counted


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
    from druid_tpu_torch.data.devicepool import device_pool
    report["pool_budget_bytes"] = device_pool().budget_bytes
    log(f"device pool budget {report['pool_budget_bytes']} B "
        f"({report['pool_budget_bytes'] / 2**30:.2f} GiB, "
        f"{torch.cuda.get_device_properties(0).total_memory} B on the card)")

    t = time.perf_counter()
    built = _build.build_all()
    report["build_s"] = time.perf_counter() - t
    log(f"build: {report['build_s']:.1f} s {built}")
    ptxas = (_build.BUILD_DIR / "sorted_reduce.log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    if sys.argv[1:] == ["batching"]:
        # the build and phase 14 alone (a quicker check of that phase; its
        # numbers are in the log)
        log("phase batching and the pool")
        phase_batching(dev)
        return 0
    if sys.argv[1:] == ["serving"]:
        # the build and phase 17 alone: the executor warms the headline
        # segments, then the broker path; the fusion sub-phase on phase
        # 14's hourly segments made here
        log("phase serving, the 8 headline segments")
        segments = headline_segments()
        qs = queries(segments)
        out, counted, _ = phase_serving(dev, segments, qs,
                                        numpy_reference(segments), None)
        del segments
        log("phase serving: cross-query fusion on phase 14's segments")
        out["fusion"] = serving_fusion(dev, hourly_segments())
        out["launches"] = counted
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_serving.json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        return 0
    if sys.argv[1:] == ["http"]:
        # the build, phase 17's cluster and its four main-path queries (the
        # rows and p50s phase 18 compares with), and phase 18
        log("phase serving (the main-path queries), the 8 headline segments")
        segments = headline_segments()
        qs = queries(segments)
        ref = numpy_reference(segments)
        serving, _, kept = phase_serving(dev, segments, qs, ref, None,
                                         extras=False)
        log(f"phase http: a QueryHttpServer over a Broker over "
            f"{SERVING_NODES} DataNodeServers")
        out, counted = phase_http(dev, qs, ref, kept, serving)
        out["launches"] = counted
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_http.json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        return 0
    if sys.argv[1:] == ["sql"]:
        # the build, phase 17's cluster and its four main-path queries,
        # phase 18 (the native rows and p50s phase 19 compares with), and
        # phase 19
        log("phase serving (the main-path queries), the 8 headline segments")
        segments = headline_segments()
        qs = queries(segments)
        ref = numpy_reference(segments)
        serving, _, kept = phase_serving(dev, segments, qs, ref, None,
                                         extras=False)
        log(f"phase http: a QueryHttpServer over a Broker over "
            f"{SERVING_NODES} DataNodeServers")
        http_out, http_counted = phase_http(dev, qs, ref, kept, serving)
        log("phase sql: Druid SQL through a RouterHttpServer to the "
            "broker's /druid/v2/sql")
        out, counted = phase_sql(dev, qs, ref, kept, http_out)
        out["launches"], out["http"] = counted, http_out
        out["http"]["launches"] = http_counted
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_sql.json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        return 0
    if sys.argv[1:] == ["storage"]:
        # the build, phase 6's data and numpy reference, and phase 20 (no
        # phase 18 rows or p50s to compare with)
        log("phase storage, the 8 headline segments")
        segments = headline_segments()
        out, counted = phase_storage(dev, segments, queries(segments),
                                     numpy_reference(segments), None, None)
        out["launches"] = counted
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_storage.json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        return 0
    if sys.argv[1:] == ["ingest"]:
        # the build and phase 21 alone (it makes its own events)
        log("phase ingest: a stream of the headline schema into the port")
        out, counted = phase_ingest(dev)
        out["launches"] = counted
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_ingest.json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        return 0
    if sys.argv[1:] == ["sharded"]:
        # the build, phase 6's data and numpy reference, and phase 22
        log("phase sharded, the 8 headline segments")
        segments = headline_segments()
        out, counted = phase_sharded(dev, segments, queries(segments),
                                     numpy_reference(segments))
        out["launches"] = counted
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_sharded.json"), "w") as f:
            json.dump(out, f, indent=1, default=float)
        return 0
    if sys.argv[1:] == ["extensions"]:
        # the build and phase 16 alone, E5 on phase 14's segments made here
        # (a quicker check of that phase; its numbers are in the log)
        log("phase extensions (E1-E4), the 8 headline segments")
        ext, _ = phase_extensions(dev, headline_segments())
        log("phase extensions E5 (E1 on phase 14's hourly segments)")
        ext["e5"] = phase_extensions_e5(dev, hourly_segments())
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "chip_smoke_extensions.json"), "w") as f:
            json.dump(ext, f, indent=1, default=float)
        return 0

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
    pools = report["pool"] = {"main": pool_snapshot("the main path")}

    log("phase packing off, 2 segments")
    report["packing_off"] = phase_packing_off(dev, segments, qs)
    pools["packing_off"] = pool_snapshot("packing off")

    log("phase sharded: the four main-path queries on a mesh of the card, "
        "the 8 headline segments")
    report["sharded"], sharded_launches = phase_sharded(dev, segments, qs,
                                                        ref)
    pools["sharded"] = pool_snapshot("sharded")

    log("phase strategies, the 8 headline segments")
    report["strategies"] = phase_strategies(dev, segments, qs, ref, captured)
    pools["strategies"] = pool_snapshot("strategies")

    log("phase native surface (N1-N12), the 8 headline segments")
    report["native_surface"], native_launches = phase_native(
        dev, segments, qs, ref)
    pools["native_surface"] = pool_snapshot("native surface")

    log("phase extensions (E1-E4), the 8 headline segments")
    report["extensions"], ext_launches = phase_extensions(dev, segments)
    pools["extensions"] = pool_snapshot("extensions")

    log(f"phase serving: a Broker over {SERVING_NODES} data nodes (replica "
        f"{SERVING_REPLICAS}), the 8 headline segments")
    report["serving"], serving_launches, kept = phase_serving(
        dev, segments, qs, ref, pools["extensions"])
    pools["serving"] = pool_snapshot("serving")

    log(f"phase http: a QueryHttpServer over a Broker over {SERVING_NODES} "
        f"DataNodeServers, the same segments")
    report["http"], http_launches = phase_http(dev, qs, ref, kept,
                                               report["serving"])
    pools["http"] = pool_snapshot("http")

    log("phase sql: Druid SQL through a RouterHttpServer to the broker's "
        "/druid/v2/sql, the same nodes")
    report["sql"], sql_launches = phase_sql(dev, qs, ref, kept,
                                            report["http"])
    pools["sql"] = pool_snapshot("sql")

    log("phase storage: the 8 segments persisted to deep storage, loaded by "
        "a load queue into a data node, and served over HTTP")
    report["storage"], storage_launches = phase_storage(
        dev, segments, qs, ref, kept, report["http"])
    pools["storage"] = report["storage"]["pool"]
    del segments, captured, ref, kept

    log("phase ingest: a stream of the headline schema through the "
        "realtime path, standing queries, publish and handoff")
    report["ingest"], ingest_launches = phase_ingest(dev)
    pools["ingest"] = report["ingest"]["pool"]

    log(f"phase sorted, {SORTED_SEGMENTS} segments in the rollup order")
    report["sorted"] = phase_sorted(dev)
    pools["sorted"] = pool_snapshot("sorted")

    log(f"phase run domain, {RUN_SEGMENTS} segments in the rollup order")
    report["run_domain"] = phase_rundomain(dev)
    pools["run_domain"] = pool_snapshot("run domain")

    entries = []
    saved = (sr.LAUNCHES, mk.LAUNCHES)
    t = time.perf_counter()
    fresh = headline_segments()
    report["fresh_gen_s"] = time.perf_counter() - t
    log(f"phase expressions (X1-X4); generated the headline data anew in "
        f"{report['fresh_gen_s']:.1f} s")
    expr, expr_launches, expr_errs = phase_expressions(dev, fresh)
    report["expressions"] = expr
    pools["expressions"] = pool_snapshot("expressions")
    log("phase aggregators (A1-A5), the same segments")
    aggr, aggr_launches = phase_aggregators(dev, fresh)
    report["aggregators"] = aggr
    pools["aggregators"] = pool_snapshot("aggregators")
    del fresh
    log(f"phase batching and the pool ({BATCH_HOURS} hourly segments and a "
        f"straggler)")
    t = time.perf_counter()
    report["batching"] = phase_batching(
        dev, extra=lambda segs: {"e5": phase_extensions_e5(dev, segs),
                                 "fusion": serving_fusion(dev, segs)})
    extra = report["batching"].pop("extra")
    report["extensions"]["e5"] = extra["e5"]
    report["serving"]["fusion"] = extra["fusion"]
    report["batching"]["phase_s"] = time.perf_counter() - t
    log(f"  phase 14 took {report['batching']['phase_s']:.1f} s")
    sr.LAUNCHES, mk.LAUNCHES = saved
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
            "launches_expressions": expr_launches[which],
            "launches_aggregators": aggr_launches[which],
            "launches_native_surface": native_launches[which],
            "launches_extensions": ext_launches[which],
            "launches_serving": serving_launches[which],
            "launches_http": http_launches[which],
            "launches_sql": sql_launches[which],
            "launches_storage": storage_launches[which],
            "launches_ingest": ingest_launches[which],
            "launches_sharded": sharded_launches[which],
            "max_abs_err": max(err, parity["max_abs_err"],
                               report["packed_parity"]["max_abs_err"],
                               expr_errs[which]),
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
