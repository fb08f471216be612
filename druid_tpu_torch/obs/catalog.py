"""The single-source metrics catalog: every metric name the system emits
(the port's own copy of the reference package's `obs/catalog.py`).

The entries are the reference's, those the port does not emit among them
(coordination/latch.py's): the catalog is the contract between a node and the
dashboards that read it, and a name must not change meaning between the
two packages (the `query/sharded/*` help text names the reference's
collectives; the port's sharded merge on the card counts the same way).
Keep the dict a PLAIN LITERAL.

Each entry: unit, the per-site dims (service/host are stamped on everything
by ServiceEmitter and not repeated), the emitting site, and a help string
(also the Prometheus # HELP text). `render_table()` produces a markdown
table from the same data.
"""
from __future__ import annotations

from typing import List

METRICS = {
    # ---- query lifecycle (server/lifecycle.py) -------------------------
    "query/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id", "priority",
                               "success"),
        "site": "server/lifecycle.py, cluster/dataserver.py",
        "help": "end-to-end query wall time"},
    "query/wait/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id"),
        "site": "server/lifecycle.py",
        "help": "time queued for a scheduler slot before execution"},
    "query/node/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id", "server"),
        "site": "server/lifecycle.py (from broker/node trace spans)",
        "help": "broker wait on one data node's response"},
    "query/compile/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id"),
        "site": "server/lifecycle.py (from engine/compile trace spans)",
        "help": "jit-cache-miss compile time inside the query (absent on "
                "cache-hit runs)"},
    "query/stage/h2d/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id"),
        "site": "server/lifecycle.py (from pool/h2d trace spans)",
        "help": "device-pool cold-miss host-to-device staging time"},
    # ---- per-segment serving (cluster/view.py) -------------------------
    "query/segment/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id", "segment",
                               "server"),
        "site": "cluster/view.py",
        "help": "uncached per-segment (or fused-set) execution wall time"},
    "query/segmentAndCache/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id", "segment",
                               "server"),
        "site": "cluster/view.py",
        "help": "per-segment serving time including cache hits"},
    "query/cpu/time": {
        "unit": "ms", "dims": ("dataSource", "type", "id", "segment",
                               "server"),
        "site": "cluster/view.py",
        "help": "per-segment host CPU (thread) time"},
    # ---- query counts (utils/emitter.py QueryCountStatsMonitor) --------
    "query/count": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "cumulative queries served"},
    "query/success/count": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "cumulative successful queries"},
    "query/failed/count": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "cumulative failed queries"},
    "query/count/delta": {
        "unit": "count/period", "dims": (),
        "site": "utils/emitter.py",
        "help": "queries served since the last monitor tick"},
    "query/success/count/delta": {
        "unit": "count/period", "dims": (),
        "site": "utils/emitter.py",
        "help": "successes since the last monitor tick"},
    "query/failed/count/delta": {
        "unit": "count/period", "dims": (),
        "site": "utils/emitter.py",
        "help": "failures since the last monitor tick"},
    # ---- result/segment cache (utils/emitter.py CacheMonitor) ----------
    "query/cache/total/hits": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "cumulative cache hits"},
    "query/cache/total/misses": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "cumulative cache misses"},
    "query/cache/total/evictions": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "cumulative cache evictions"},
    "query/cache/total/entries": {
        "unit": "count", "dims": (),
        "site": "utils/emitter.py",
        "help": "current cache entry count"},
    # ---- data-node scheduler (server/scheduler.py) ---------------------
    "query/queue/depth": {
        "unit": "count", "dims": (),
        "site": "server/scheduler.py (SchedulerMetricsMonitor)",
        "help": "queries queued at the data-node scheduler at tick time"},
    "query/queue/wait": {
        "unit": "ms", "dims": ("dataSource", "type", "id", "lane"),
        "site": "server/scheduler.py",
        "help": "time a query was held in the scheduler queue before its "
                "flush started (emitted per query, tracing on or off)"},
    "query/shed/count": {
        "unit": "count/period", "dims": (),
        "site": "server/scheduler.py (SchedulerMetricsMonitor)",
        "help": "queries shed with 429 at admission since the last tick"},
    "query/crossBatch/queries": {
        "unit": "count", "dims": (),
        "site": "server/scheduler.py (SchedulerMetricsMonitor)",
        "help": "distinct queries fused into one cross-query dispatch"},
    "query/crossBatch/segments": {
        "unit": "count", "dims": (),
        "site": "server/scheduler.py (SchedulerMetricsMonitor)",
        "help": "segments stacked into one cross-query dispatch"},
    "query/crossBatch/fillRatio": {
        "unit": "ratio", "dims": (),
        "site": "server/scheduler.py (SchedulerMetricsMonitor)",
        "help": "real rows / padded slots of a cross-query dispatch"},
    "query/crossBatch/droppedEvents": {
        "unit": "count", "dims": (),
        "site": "server/scheduler.py (SchedulerMetricsMonitor)",
        "help": "per-dispatch events lost to the bounded event queue "
                "(the crossBatch series undercounts by this many)"},
    # ---- broker fault tolerance (cluster/resilience.py) ----------------
    "broker/circuit/open": {
        "unit": "count", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "per-server circuit breakers currently open or half-open "
                "(replica selection is skipping these servers)"},
    "broker/circuit/trips": {
        "unit": "count/period", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "circuits tripped open since the last tick (consecutive "
                "failures/sheds/timeouts crossed the threshold)"},
    "broker/circuit/probes": {
        "unit": "count/period", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "half-open probe queries routed through an open circuit "
                "since the last tick"},
    "query/hedge/issued": {
        "unit": "count/period", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "speculative straggler re-issues sent since the last "
                "tick (hedged requests)"},
    "query/hedge/won": {
        "unit": "count/period", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "hedged requests that claimed their segments first since "
                "the last tick"},
    "query/hedge/cancelled": {
        "unit": "count/period", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "in-flight rivals remote-cancelled after losing a hedge "
                "race since the last tick"},
    "query/partial/missingSegments": {
        "unit": "count/period", "dims": (),
        "site": "cluster/resilience.py (ResilienceMetricsMonitor)",
        "help": "segments reported missing in typed partial results "
                "(allowPartialResults degradations) since the last tick"},
    # ---- device dispatches (obs/dispatch.py) ---------------------------
    "query/dispatch/count": {
        "unit": "count/period", "dims": (),
        "site": "obs/dispatch.py (DispatchMonitor)",
        "help": "device-callable invocations on the query path since the "
                "last tick (per-segment, batched, sharded, and "
                "bitmap-fill programs; the megakernel's one-dispatch "
                "contract is asserted on deltas of this counter)"},
    # ---- fused megakernel (engine/megakernel.py) -----------------------
    "query/megakernel/hits": {
        "unit": "count/period", "dims": (),
        "site": "engine/megakernel.py (MegakernelMonitor)",
        "help": "bitmap filter subtrees fused inline into the one-dispatch "
                "megakernel program since the last tick"},
    "query/megakernel/fallbacks": {
        "unit": "count/period", "dims": (),
        "site": "engine/megakernel.py (MegakernelMonitor)",
        "help": "bitmap filter subtrees that stayed on the staged "
                "fill-wave path since the last tick (megakernel disabled, "
                "or resident combined words already serve them)"},
    "query/megakernel/donatedBytes": {
        "unit": "bytes/period", "dims": (),
        "site": "engine/megakernel.py (MegakernelMonitor)",
        "help": "per-group partial-buffer bytes handed back DONATED across "
                "repeated executions since the last tick (standing-query "
                "ticks update partials in place, zero per-tick HBM churn)"},
    # ---- standing queries (engine/standing.py) -------------------------
    "query/standing/ticks": {
        "unit": "count/period", "dims": (),
        "site": "engine/standing.py (StandingMetricsMonitor)",
        "help": "standing-query ticks executed since the last monitor "
                "tick (each folds only data appended past the per-sink "
                "high-water marks)"},
    "query/standing/folds": {
        "unit": "count/period", "dims": (),
        "site": "engine/standing.py (StandingMetricsMonitor)",
        "help": "incremental segment folds (device work actually paid) "
                "since the last tick — a quiet datasource ticks for free"},
    "query/standing/rows": {
        "unit": "count/period", "dims": (),
        "site": "engine/standing.py (StandingMetricsMonitor)",
        "help": "newly appended rows folded into standing partials since "
                "the last tick (the incremental win vs re-scanning every "
                "sink)"},
    "query/standing/cutovers": {
        "unit": "count/period", "dims": (),
        "site": "engine/standing.py (StandingMetricsMonitor)",
        "help": "publish cutovers since the last tick (a sink's "
                "incremental partials swapped exactly-once for its "
                "published segment's contribution)"},
    # ---- subscription fan-out (server/subscriptions.py) ----------------
    "subscription/active": {
        "unit": "count", "dims": (),
        "site": "server/subscriptions.py (SubscriptionMetricsMonitor)",
        "help": "live subscriptions at tick time (N structurally "
                "identical ones share ONE standing program)"},
    "subscription/fanout": {
        "unit": "count/period", "dims": (),
        "site": "server/subscriptions.py (SubscriptionMetricsMonitor)",
        "help": "changed-result long-poll deliveries since the last tick"},
    "subscription/ticks": {
        "unit": "count/period", "dims": (),
        "site": "server/subscriptions.py (SubscriptionMetricsMonitor)",
        "help": "subscription-hub ticks since the last monitor tick "
                "(each advances every standing program once)"},
    # ---- sharded mesh execution (parallel/distributed.py) --------------
    "query/sharded/mergeDevice": {
        "unit": "count/period", "dims": (),
        "site": "parallel/distributed.py (ShardedMonitor)",
        "help": "sharded dispatches whose partial grids were merged "
                "IN-PROGRAM by the mesh collectives (psum/pmin/pmax/"
                "all_gather+fold) since the last tick — every sharded "
                "dispatch, now that the broker-side host merge is gone"},
    "query/sharded/stackBytes": {
        "unit": "bytes", "dims": (),
        "site": "parallel/distributed.py (ShardedMonitor)",
        "help": "HBM resident in stacked sharded blocks (gauge; the "
                "device pool's stacked_* accounting — counted against "
                "DEVICE_POOL_BUDGET_BYTES like every other entry)"},
    "query/sharded/packedRatio": {
        "unit": "ratio", "dims": (),
        "site": "parallel/distributed.py (ShardedMonitor)",
        "help": "decoded-equivalent / actual bytes over the stacked "
                "sharded blocks (gauge; 1.0 when nothing is stacked) — "
                "the HBM multiplier the compressed-resident stacking "
                "(packed words, cascade run tables, bitmap slots) buys "
                "a pod"},
    # ---- code-domain aggregation (data/cascade.py) ---------------------
    "query/codeDomain/hits": {
        "unit": "count/period", "dims": (),
        "site": "data/cascade.py (CodeDomainMonitor)",
        "help": "segment executions served fully over run metadata since "
                "the last tick (no row-width column staged or decoded — "
                "count/sum/min-max computed from run values × lengths)"},
    "query/codeDomain/rows": {
        "unit": "count/period", "dims": (),
        "site": "data/cascade.py (CodeDomainMonitor)",
        "help": "logical rows covered by code-domain (run-space) "
                "executions since the last tick"},
    # ---- device filter-bitmap cache (engine/filters.py) ----------------
    "query/filter/deviceBitmapHits": {
        "unit": "count/period", "dims": (),
        "site": "engine/filters.py (FilterBitmapMonitor)",
        "help": "filter-result device bitmaps served from resident pool "
                "words since the last tick (no leaf staging, no algebra "
                "dispatch)"},
    "query/filter/deviceBitmapMisses": {
        "unit": "count/period", "dims": (),
        "site": "engine/filters.py (FilterBitmapMonitor)",
        "help": "filter-result device bitmaps built cold since the last "
                "tick"},
    "query/filter/bytes": {
        "unit": "bytes/period", "dims": (),
        "site": "engine/filters.py (FilterBitmapMonitor)",
        "help": "device filter-bitmap bytes materialized on cold misses "
                "since the last tick (1 bit per padded row per filter)"},
    # ---- batched execution (engine/batching.py) ------------------------
    "query/batch/segments": {
        "unit": "count", "dims": (),
        "site": "engine/batching.py",
        "help": "segments fused into one batched dispatch"},
    "query/batch/fillRatio": {
        "unit": "ratio", "dims": (),
        "site": "engine/batching.py",
        "help": "real rows / padded slots of a batched dispatch"},
    "query/batch/droppedEvents": {
        "unit": "count", "dims": (),
        "site": "engine/batching.py",
        "help": "per-dispatch events lost to the bounded queue"},
    # ---- device segment pool (data/devicepool.py) ----------------------
    "segment/devicePool/hitRate": {
        "unit": "ratio", "dims": (),
        "site": "data/devicepool.py",
        "help": "pool hit rate over the monitor tick window"},
    "segment/devicePool/hits": {
        "unit": "count/period", "dims": (),
        "site": "data/devicepool.py",
        "help": "pool hits since the last tick"},
    "segment/devicePool/misses": {
        "unit": "count/period", "dims": (),
        "site": "data/devicepool.py",
        "help": "pool misses since the last tick"},
    "segment/devicePool/evictedBytes": {
        "unit": "bytes/period", "dims": (),
        "site": "data/devicepool.py",
        "help": "HBM bytes evicted since the last tick"},
    "segment/devicePool/residentBytes": {
        "unit": "bytes", "dims": (),
        "site": "data/devicepool.py",
        "help": "HBM bytes currently pinned by pool entries"},
    "segment/devicePool/entries": {
        "unit": "count", "dims": (),
        "site": "data/devicepool.py",
        "help": "current pool entry count"},
    "segment/devicePool/packedRatio": {
        "unit": "ratio", "dims": (),
        "site": "data/devicepool.py",
        "help": "decoded-equivalent bytes / actual resident bytes of "
                "compressed-domain pool entries (1.0 = nothing packed); "
                "the pool/h2d trace span's bytes attr is likewise the "
                "COMPRESSED bus transfer, logicalBytes the decoded size"},
    "segment/devicePool/cascadeRatio": {
        "unit": "ratio", "dims": (),
        "site": "data/devicepool.py",
        "help": "decoded-equivalent bytes / actual resident bytes over "
                "CASCADE-encoded pool entries only (RLE/delta/FOR/LZ4 — "
                "data/cascade.py; 1.0 when nothing cascade-encoded is "
                "resident)"},
    # ---- segment load (storage/format_v2.py) ---------------------------
    "segment/load/time": {
        "unit": "ms/period", "dims": (),
        "site": "storage/format_v2.py",
        "help": "wall time spent loading segments from disk since the "
                "last tick (format V2: mmap + descriptor reconstruction, "
                "no column decode)"},
    "segment/load/bytes": {
        "unit": "bytes/period", "dims": (),
        "site": "storage/format_v2.py",
        "help": "logical (decoded-equivalent) bytes of segments loaded "
                "since the last tick"},
    "segment/load/compressedBytes": {
        "unit": "bytes/period", "dims": (),
        "site": "storage/format_v2.py",
        "help": "on-disk bytes of segments loaded since the last tick "
                "(ratio to segment/load/bytes = storage compression)"},
    # ---- broker <-> data node wire (cluster/wire.py) -------------------
    "query/wire/bytes": {
        "unit": "bytes/period", "dims": (),
        "site": "cluster/wire.py",
        "help": "logical (raw little-endian) tensor bytes of partials "
                "payloads serialized since the last tick"},
    "query/wire/compressedBytes": {
        "unit": "bytes/period", "dims": (),
        "site": "cluster/wire.py",
        "help": "tensor bytes actually emitted after per-tensor wire "
                "compression (equals query/wire/bytes when peers do not "
                "advertise wireCompress)"},
    # ---- coordination (coordination/latch.py) --------------------------
    "coordination/leader/transitions": {
        "unit": "count", "dims": ("service", "node", "event", "term",
                                  "leader"),
        "site": "coordination/latch.py",
        "help": "cumulative leadership transitions"},
    "coordination/lease/ageMs": {
        "unit": "ms", "dims": ("service", "node", "leader"),
        "site": "coordination/latch.py",
        "help": "age of the current leader lease"},
    # ---- host/process (utils/emitter.py Sys/ProcessMonitor) ------------
    "sys/cpu": {
        "unit": "percent", "dims": (),
        "site": "utils/emitter.py",
        "help": "host CPU utilization over the tick window"},
    "sys/mem/used": {
        "unit": "bytes", "dims": (),
        "site": "utils/emitter.py",
        "help": "host memory in use"},
    "sys/mem/max": {
        "unit": "bytes", "dims": (),
        "site": "utils/emitter.py",
        "help": "host memory total"},
    "proc/rss": {
        "unit": "bytes", "dims": (),
        "site": "utils/emitter.py",
        "help": "this process's resident set size"},
    "proc/cpu": {
        "unit": "seconds", "dims": (),
        "site": "utils/emitter.py",
        "help": "this process's cumulative CPU time"},
}


def declared_names() -> List[str]:
    return sorted(METRICS)


def help_for(name: str) -> str:
    m = METRICS.get(name)
    if m is None:
        return "(undeclared metric)"
    return f"{m['help']} ({m['unit']})"


def render_table() -> str:
    """The catalog as a markdown table (README's Observability section)."""
    lines = ["| metric | unit | dims | emitting site |",
             "|---|---|---|---|"]
    for name in sorted(METRICS):
        m = METRICS[name]
        dims = ", ".join(m["dims"]) if m["dims"] else "—"
        lines.append(f"| `{name}` | {m['unit']} | {dims} | {m['site']} |")
    return "\n".join(lines)


def validate_emitted(names) -> List[str]:
    """Names in `names` missing from the catalog (test helper)."""
    return sorted(set(names) - set(METRICS))
