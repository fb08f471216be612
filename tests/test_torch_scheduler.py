"""The port's data-node scheduler (druid_tpu_torch/server/scheduler.py) on
the CPU: the cases of tests/test_scheduler.py — cross-query fusion parity,
admission control (429s, lanes, deadline shed), queue accounting, and the
broker's 429 handling — over the port's DataNode, DataNodeServer and
RemoteDataNodeClient, on the reference's data (its DataGenerator, seed 11,
carried into the port as plain arrays). The serial path's rows are held
against the reference package's QueryExecutor on the same segments
(counts, long sums and min/max bit for bit, float sums within
1e-5 * sum|v|).

Parity assertions inside the port are EXACT (`==` on finished rows, floats
included): a fused run computes each query's partials as its own serial
run does. Saturation/lane assertions are on CONTRACT (shed vs admitted,
429 vs hang), never on wall-clock throughput."""
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.cluster import (Broker, DataNode, DataNodeServer,
                                     InventoryView, RemoteDataNodeClient,
                                     descriptor_for)
from druid_tpu_torch.cluster import wire
from druid_tpu_torch.engine import engines
from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.server.querymanager import QueryCapacityError
from druid_tpu_torch.server.scheduler import (BACKGROUND_LANE,
                                              DataNodeScheduler,
                                              SchedulerConfig,
                                              SchedulerMetricsMonitor,
                                              lane_of)
from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
from tests.test_torch_cluster import _close
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = Interval.of("2026-03-01", "2026-03-03")
CPU = torch.device("cpu")

SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=8, distribution="uniform"),
    ColumnSpec("dimB", "string", cardinality=40, distribution="zipf"),
    ColumnSpec("metLong", "long", low=0, high=1000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=5.0, std=2.0),
    ColumnSpec("metDouble", "double", low=0.0, high=1.0),
)

AGGS = [{"type": "count", "name": "n"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"},
        {"type": "doubleSum", "name": "ds", "fieldName": "metDouble"},
        {"type": "floatMax", "name": "fx", "fieldName": "metFloat"}]


@pytest.fixture(scope="module")
def ref_segments():
    gen = DataGenerator(SCHEMA, seed=11)
    return gen.segments(8, 1500, IV, datasource="hot")


@pytest.fixture(scope="module")
def sched_segments(ref_segments):
    return [_carry(s) for s in ref_segments]


@pytest.fixture()
def node(sched_segments):
    n = DataNode("sched-node", device="cpu")
    for s in sched_segments:
        n.load_segment(s)
    return n


def _groupby(qid, ctx=None):
    return query_from_json({
        "queryType": "groupBy", "dataSource": "hot", "intervals": [str(IV)],
        "granularity": "all", "dimensions": ["dimA"], "aggregations": AGGS,
        "context": {"queryId": qid, **(ctx or {})}})


def _timeseries(qid, ctx=None):
    return query_from_json({
        "queryType": "timeseries", "dataSource": "hot",
        "intervals": [str(IV)], "granularity": "hour", "aggregations": AGGS,
        "context": {"queryId": qid, **(ctx or {})}})


def _topn(qid, ctx=None):
    return query_from_json({
        "queryType": "topN", "dataSource": "hot", "intervals": [str(IV)],
        "granularity": "all", "dimension": "dimB", "metric": "ls",
        "threshold": 7, "aggregations": AGGS,
        "context": {"queryId": qid, **(ctx or {})}})


def _finish(query, ap):
    qt = query.query_type
    if qt == "groupBy":
        return engines.finish_groupby(query, ap)
    if qt == "timeseries":
        return engines.finish_timeseries(query, ap)
    return engines.finish_topn(query, ap)


@pytest.mark.parametrize("make", [_groupby, _timeseries, _topn],
                         ids=["groupBy", "timeseries", "topN"])
def test_serial_rows_match_reference(node, sched_segments, ref_segments,
                                     make):
    """The yardstick the parity cases below compare with: the node's serial
    partials, finished, equal the reference executor's rows."""
    q = make("ref")
    sids = [str(s.id) for s in sched_segments]
    _close(RefExecutor(ref_segments).run_json(q.to_json()),
           _finish(q, node.run_partials(q, sids)[0]))


# ---------------------------------------------------------------------------
# cross-query fusion parity
# ---------------------------------------------------------------------------

def test_concurrent_mixed_queries_bit_identical_to_serial(node,
                                                          sched_segments):
    """The acceptance gate: a mixed concurrent workload — different query
    types, overlapping segment sets, float/double aggregations — produces
    EXACTLY the rows serial per-query execution produces."""
    sids = [str(s.id) for s in sched_segments]
    workload = (
        [(_groupby(f"g{i}"), [sids[i % 8]]) for i in range(6)]
        + [(_timeseries(f"t{i}"), sids[i:i + 3]) for i in range(3)]
        + [(_topn(f"n{i}"), [sids[i], sids[(i + 4) % 8]]) for i in range(3)]
    )
    serial = [node.run_partials(q, s) for q, s in workload]

    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=40.0, lane_depths={})).start()
    try:
        results = [None] * len(workload)
        errors = []

        def client(i):
            q, s = workload[i]
            try:
                results[i] = sched.submit(q, s)
            except Exception as e:           # pragma: no cover - must not
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(workload))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sched.stop()
    assert errors == []

    for (q, _), (ap_s, served_s), got in zip(workload, serial, results):
        ap_g, served_g = got
        assert served_g == served_s
        # partial-state parity, bitwise (counts + every kernel state)
        assert len(ap_g.partials) == len(ap_s.partials)
        for ps, pg in zip(ap_s.partials, ap_g.partials):
            assert np.array_equal(ps.counts, pg.counts)
            for k in ps.states:
                assert np.array_equal(np.asarray(ps.states[k]),
                                      np.asarray(pg.states[k]))
        # finished-row parity, exact (floats included)
        assert _finish(q, ap_g) == _finish(q, ap_s)


def test_flush_actually_fuses_across_queries(node, sched_segments):
    """The point of the scheduler: concurrent plan-compatible queries land
    in ONE device dispatch (crossBatch queries > 1), not one each."""
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=60.0, lane_depths={})).start()
    try:
        barrier = threading.Barrier(6)

        def client(i):
            barrier.wait()
            sched.submit(_groupby(f"fuse{i}"), [sids[i % 8]])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sched.stop()
    events, _, _ = sched.stats.drain_events()
    assert sched.stats.snapshot()["crossBatches"] >= 1
    assert any(nq >= 2 for nq, _, _ in events), events


# ---------------------------------------------------------------------------
# admission control: saturation, lanes, deadline
# ---------------------------------------------------------------------------

def test_flood_beyond_queue_depth_sheds_not_hangs(node, sched_segments):
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=300.0, max_queue_depth=2,
                              lane_depths={})).start()
    ok, shed, other = [], [], []
    try:
        barrier = threading.Barrier(8)

        def client(i):
            barrier.wait()
            try:
                ok.append(sched.submit(_groupby(f"flood{i}"), [sids[0]]))
            except QueryCapacityError as e:
                assert e.retry_after_s > 0
                shed.append(e)
            except Exception as e:           # pragma: no cover - must not
                other.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sched.stop()
    assert other == []
    assert len(ok) + len(shed) == 8
    assert len(shed) >= 2, "a flood beyond depth 2 must shed"
    assert len(ok) >= 2, "admitted queries must still complete"
    assert sched.stats.snapshot()["shed"] == len(shed)


def test_background_flood_cannot_starve_interactive(node, sched_segments):
    """Priority lanes: with the background lane capped, a background flood
    sheds BACKGROUND queries while every interactive query is admitted and
    completes — bounded interactive latency by construction."""
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=300.0, max_queue_depth=100,
                              lane_depths={BACKGROUND_LANE: 2})).start()
    bg_ok, bg_shed, inter_ok, errors = [], [], [], []
    try:
        barrier = threading.Barrier(9)

        def background(i):
            barrier.wait()
            try:
                bg_ok.append(sched.submit(
                    _groupby(f"bg{i}", {"lane": "background"}), [sids[0]]))
            except QueryCapacityError:
                bg_shed.append(i)
            except Exception as e:           # pragma: no cover - must not
                errors.append(e)

        def interactive(i):
            barrier.wait()
            time.sleep(0.05)        # arrive INTO the flood
            try:
                inter_ok.append(sched.submit(
                    _groupby(f"int{i}", {"priority": 10}), [sids[i]]))
            except Exception as e:           # pragma: no cover - must not
                errors.append(e)

        threads = [threading.Thread(target=background, args=(i,))
                   for i in range(6)] \
            + [threading.Thread(target=interactive, args=(i,))
               for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sched.stop()
    assert errors == []
    assert len(bg_shed) >= 1, "the background flood must shed"
    assert len(inter_ok) == 3, "no interactive query may be shed"


def test_deadline_infeasible_sheds_upfront(node, sched_segments):
    """With a measured service rate and a queue of work, a query whose
    timeout the queue provably cannot meet is shed at admission (429 with
    the drain estimate as Retry-After) instead of timing out late."""
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=1.0, lane_depths={}))
    sched.start()
    # establish a service-rate estimate
    sched.submit(_groupby("warm"), sids[:2])
    assert sched._rate_rows_per_s is not None
    sched.stop()
    # a stopped dispatcher keeps the queue static: stack up cost, then ask
    # for a 1ms deadline — infeasible against the measured rate
    with sched._cond:
        sched._stopping = False   # allow enqueue without a live dispatcher
    big = [_groupby(f"q{i}") for i in range(3)]
    with sched._cond:
        for i, q in enumerate(big):
            sched._seq += 1
            from druid_tpu_torch.server.scheduler import _Item
            sched._queue.append(_Item(q, sids, None, "interactive", 0,
                                      10_000_000, sched._seq))
    with pytest.raises(QueryCapacityError, match="deadline infeasible"):
        with sched._cond:
            sched._admit_locked(_groupby("late", {"timeout": 1}),
                                "interactive", 1000)
    assert sched.stats.snapshot()["shed"] == 1


def test_lane_derivation():
    assert lane_of(_groupby("a")) == "interactive"
    assert lane_of(_groupby("b", {"priority": -1})) == "background"
    assert lane_of(_groupby("c", {"lane": "reporting"})) == "reporting"
    assert lane_of(_groupby("d", {"priority": 10})) == "interactive"


def test_stop_fails_queued_waiters_fast(node, sched_segments):
    """stop() with queued work must release the waiters with an error —
    never leave an HTTP handler thread hung on a dead dispatcher."""
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=5000.0, lane_depths={}))
    sched.start()
    outcome = []

    def client():
        try:
            outcome.append(("ok", sched.submit(_groupby("q"), [sids[0]])))
        except Exception as e:
            outcome.append(("err", e))

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + 5.0
    while sched.depth() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    sched.stop()
    t.join(timeout=10)
    assert not t.is_alive(), "waiter hung across scheduler stop"
    assert outcome and outcome[0][0] == "err"


def test_submit_after_stop_raises_fast(node, sched_segments):
    """A submit racing (or following) stop() must fail fast — never
    resurrect the dispatcher of a deliberately stopped scheduler. Only an
    explicit start() brings it back."""
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=1.0, lane_depths={})).start()
    sched.submit(_groupby("warm"), [sids[0]])
    sched.stop()
    with pytest.raises(RuntimeError, match="scheduler stopped"):
        sched.submit(_groupby("late"), [sids[0]])
    assert sched._thread is None or not sched._thread.is_alive(), \
        "submit resurrected a stopped dispatcher"
    sched.start()
    try:
        ap, served = sched.submit(_groupby("again"), [sids[0]])
        assert served == {sids[0]}
    finally:
        sched.stop()


def test_group_path_keeps_segment_time_metrics(sched_segments):
    """query/segment/time must not disappear when the scheduler fronts an
    emitter-bearing node: the fused group path emits one aggregate timing
    per request (run_partials' batched-set shape), and a
    per_segment_metrics node routes through run_partials so every segment
    keeps its own timing — the serial path's observability trade."""
    sink = InMemoryEmitter()
    em = ServiceEmitter("druid/historical", "emit-node", sink)
    n = DataNode("emit-node", device="cpu", emitter=em)
    for s in sched_segments:
        n.load_segment(s)
    sids = [str(s.id) for s in sched_segments]
    out = n.run_partials_group([(_groupby("ga"), sids[:2], None),
                                (_groupby("gb"), sids[2:4], None)])
    assert all(not isinstance(r, BaseException) for r in out)
    evs = sink.metrics("query/segment/time")
    assert {e.dims["id"] for e in evs} == {"ga", "gb"}
    assert all(e.dims["segment"] == "2-segments" for e in evs)

    sink2 = InMemoryEmitter()
    n2 = DataNode("emit-node2", device="cpu",
                  emitter=ServiceEmitter("druid/historical", "emit-node2",
                                         sink2),
                  per_segment_metrics=True)
    for s in sched_segments:
        n2.load_segment(s)
    out2 = n2.run_partials_group([(_groupby("gc"), sids[:2], None)])
    assert all(not isinstance(r, BaseException) for r in out2)
    segs_seen = {e.dims["segment"]
                 for e in sink2.metrics("query/segment/time")}
    assert segs_seen == set(sids[:2])


# ---------------------------------------------------------------------------
# queue accounting: span + metric reflect the scheduler hold
# ---------------------------------------------------------------------------

def _held_submit(node, sids, window_ms, ctx=None):
    """Submit ONE query into an idle scheduler with the given batching
    window — its queue/wait hold is ≈ the window — and return
    (emitted metrics, trace spans, hold lower bound ms)."""
    sink = InMemoryEmitter()
    emitter = ServiceEmitter("druid/historical", "t", sink)
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=window_ms, lane_depths={}),
        emitter=emitter).start()
    store = qtrace.TraceStore()
    q = _groupby("held", ctx)
    try:
        with qtrace.root_span("datanode/query", q, service="t",
                              store=store):
            sched.submit(q, sids[:1])
    finally:
        sched.stop()
    return sink, store.spans("held"), window_ms * 0.5


def test_queue_wait_span_and_metric_reflect_hold(node, sched_segments):
    """Under a saturated/held scheduler the qtrace queue/wait span AND the
    query/queue/wait metric must carry the actual hold — not the
    (previously only-exercised) unqueued near-zero path."""
    sids = [str(s.id) for s in sched_segments]
    sink, spans, floor_ms = _held_submit(node, sids, window_ms=150.0)
    waits = [e for e in sink.metrics("query/queue/wait")]
    assert len(waits) == 1
    assert waits[0].value >= floor_ms, \
        f"metric {waits[0].value}ms does not reflect a ~150ms hold"
    assert waits[0].dims.get("lane") == "interactive"
    qspans = [s for s in spans if s["name"] == "queue/wait"]
    assert len(qspans) == 1
    assert qspans[0]["durationMs"] >= floor_ms
    # the hold ended when the flush STARTED: execution is attributed to
    # engine spans, not to queue time
    flush = [s for s in spans if s["name"] == "sched/flush"]
    assert flush, "flush span missing from the request trace"


def test_trace_false_still_gets_queue_metrics(node, sched_segments):
    """{"trace": false} opts out of SPANS, never of metrics: the
    query/queue/wait metric must still reflect the hold."""
    sids = [str(s.id) for s in sched_segments]
    sink, spans, floor_ms = _held_submit(node, sids, window_ms=120.0,
                                         ctx={"trace": False})
    waits = sink.metrics("query/queue/wait")
    assert len(waits) == 1 and waits[0].value >= floor_ms
    assert spans == [], "trace=false query must record no spans"


def test_scheduler_monitor_emits_catalog_metrics(node, sched_segments):
    sids = [str(s.id) for s in sched_segments]
    sched = DataNodeScheduler(
        node, SchedulerConfig(batch_window_ms=30.0, max_queue_depth=1,
                              lane_depths={})).start()
    try:
        barrier = threading.Barrier(4)

        def client(i):
            barrier.wait()
            try:
                sched.submit(_groupby(f"m{i}"), [sids[i % 8]])
            except QueryCapacityError:
                pass

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sched.stop()
    sink = InMemoryEmitter()
    SchedulerMetricsMonitor(sched).do_monitor(
        ServiceEmitter("druid/historical", "t", sink))
    names = {e.metric for e in sink.metrics()}
    assert "query/queue/depth" in names
    assert "query/shed/count" in names
    shed = sink.metrics("query/shed/count")[0]
    assert shed.value == sched.stats.snapshot()["shed"]
    from druid_tpu_torch.obs import catalog
    assert catalog.validate_emitted(names) == []


# ---------------------------------------------------------------------------
# the 429 contract over HTTP + the broker's handling
# ---------------------------------------------------------------------------

def test_http_flood_yields_429_with_retry_after(node, sched_segments):
    """A flood beyond queue depth at the HTTP layer: every response is a
    clean 200 or a 429 carrying Retry-After — no hangs, no 500s."""
    sids = [str(s.id) for s in sched_segments]
    srv = DataNodeServer(node, scheduler_config=SchedulerConfig(
        batch_window_ms=120.0, max_queue_depth=2, lane_depths={})).start()
    codes, retry_after = [], []
    body = json.dumps({"query": _groupby("warm").to_json(),
                       "segments": sids[:1]}).encode()

    def flood(i):
        b = json.dumps({"query": _groupby(f"h{i}").to_json(),
                        "segments": sids[:1]}).encode()
        req = urllib.request.Request(
            srv.url + "/druid/v2/partials", data=b,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                codes.append(r.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
            if e.code == 429:
                retry_after.append(e.headers.get("Retry-After"))
            e.read()

    try:
        # warm one through (establishes the fused path compiles)
        req = urllib.request.Request(
            srv.url + "/druid/v2/partials", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
        threads = [threading.Thread(target=flood, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.stop()
    assert sorted(set(codes)) in ([200, 429], [429], [200]), codes
    assert 429 in codes, "a flood beyond depth must shed with 429"
    assert all(ra and int(ra) >= 1 for ra in retry_after), retry_after


def test_non_fusable_requests_bypass_scheduler(sched_segments):
    """Work the node cannot fuse (per-segment metrics here; mesh likewise)
    must run on the request thread, not serialize on the single dispatcher
    thread — DataNodeServer routes it straight to run_partials and the
    scheduler never sees it. (Segment-cache queries, by contrast, DO fuse
    — see the scheduler × segment-cache section below.)"""
    n = DataNode("bypass-node", device="cpu",
                 emitter=ServiceEmitter("druid/historical", "t",
                                        InMemoryEmitter()),
                 per_segment_metrics=True)
    for s in sched_segments:
        n.load_segment(s)
    q = _groupby("bypass")
    assert not n.fusable(q)
    sids = [str(s.id) for s in sched_segments]
    expect = _finish(q, n.run_partials(q, sids)[0])
    srv = DataNodeServer(n, scheduler_config=SchedulerConfig(
        batch_window_ms=50.0)).start()
    submits = []
    real_submit = srv.scheduler.submit
    srv.scheduler.submit = lambda *a, **k: (submits.append(a),
                                            real_submit(*a, **k))[1]
    try:
        body = json.dumps({"query": q.to_json(),
                           "segments": sids}).encode()
        req = urllib.request.Request(
            srv.url + "/druid/v2/partials", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            ap, served, _ = wire.loads_partials(r.read())
    finally:
        srv.stop()
    assert submits == [], "non-fusable request must not enter the queue"
    assert _finish(q, ap) == expect
    assert served == {str(s.id) for s in sched_segments}


def test_batch_opted_out_queries_are_not_fusable(node):
    """{"batchSegments": false} (and the process switch) means the fused
    path would only run the query per-segment on the dispatcher thread —
    such queries must bypass the scheduler entirely."""
    from druid_tpu_torch.engine import batching
    assert node.fusable(_groupby("plain"))
    assert not node.fusable(_groupby("opt", {"batchSegments": False}))
    assert not node.fusable(_groupby("opt2", {"batchSegments": "false"}))
    prev = batching.set_enabled(False)
    try:
        assert not node.fusable(_groupby("global-off"))
    finally:
        batching.set_enabled(prev)
    assert node.fusable(_groupby("back-on"))


def test_stop_without_dispatcher_fails_queued_waiters(node, sched_segments):
    """A submit that races stop() when NO dispatcher thread is alive
    (scheduler constructed but never started) must still fail fast —
    stop() itself fails the queue, not only the dispatcher loop."""
    sched = DataNodeScheduler(node, SchedulerConfig(batch_window_ms=500.0))
    sched._ensure_dispatcher = lambda: None      # no dispatcher, ever
    sids = [str(s.id) for s in sched_segments]
    errs = []

    def go():
        try:
            sched.submit(_groupby("stranded"), sids)
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=go)
    t.start()
    deadline = time.monotonic() + 10
    while sched.depth() == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sched.depth() == 1
    sched.stop()
    t.join(timeout=5)
    assert not t.is_alive(), "waiter stranded after stop()"
    assert len(errs) == 1 and isinstance(errs[0], RuntimeError) \
        and "stopped" in str(errs[0])


def test_run_partials_group_backstop_for_non_fusable(sched_segments):
    """The robustness backstop: a non-fusable request that does reach
    run_partials_group (eligibility changed between admission and flush)
    runs via the normal run_partials path with identical semantics."""
    n = DataNode("backstop-node", device="cpu",
                 emitter=ServiceEmitter("druid/historical", "t",
                                        InMemoryEmitter()),
                 per_segment_metrics=True)
    for s in sched_segments:
        n.load_segment(s)
    q = _groupby("backstop")
    sids = [str(s.id) for s in sched_segments]
    expect = _finish(q, n.run_partials(q, sids)[0])
    out = n.run_partials_group([(q, sids, None),
                                (_timeseries("mate"), sids, None)])
    assert not isinstance(out[0], BaseException)
    ap, served = out[0]
    assert _finish(q, ap) == expect
    assert served == {str(s.id) for s in sched_segments}
    assert not isinstance(out[1], BaseException)


class _SheddingHandler(BaseHTTPRequestHandler):
    """Stub data node: sheds the first `shed_n` POSTs with 429 (carrying
    `retry_after`), then serves a canned partials bundle."""
    shed_n = 1
    retry_after = "0.05"
    payload = b""
    calls = []

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).calls.append(self.path)
        if len(type(self).calls) <= type(self).shed_n:
            body = b'{"error": "Query capacity exceeded"}'
            self.send_response(429)
            self.send_header("Retry-After", type(self).retry_after)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", wire.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(type(self).payload)))
        self.end_headers()
        self.wfile.write(type(self).payload)


def _stub_shedding_server(sched_segments, shed_n, retry_after="0.05"):
    q = _groupby("stub")
    ap = engines.make_aggregate_partials(q, sched_segments[:1], CPU,
                                         clamp=False)
    payload = wire.dumps_partials(
        ap, served=[str(sched_segments[0].id)], trace=[])
    handler = type("H", (_SheddingHandler,), {
        "shed_n": shed_n, "retry_after": retry_after,
        "payload": payload, "calls": []})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, handler, q


def test_client_retries_once_after_retry_after(sched_segments,
                                               monkeypatch):
    """A single 429 is retried once after Retry-After and the query
    succeeds, instead of an opaque RemoteQueryError."""
    httpd, handler, q = _stub_shedding_server(sched_segments, shed_n=1)
    monkeypatch.setattr(RemoteDataNodeClient, "MAX_RETRY_AFTER_SLEEP", 0.05)
    try:
        client = RemoteDataNodeClient(
            "stub", f"http://127.0.0.1:{httpd.server_address[1]}")
        ap, served = client.run_partials(q, [str(sched_segments[0].id)])
        assert served == {str(sched_segments[0].id)}
        assert len(handler.calls) == 2, "exactly one retry after the 429"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_persistent_shed_raises_capacity_error(sched_segments, monkeypatch):
    """Shed twice → QueryCapacityError with the node's Retry-After, NOT a
    RemoteQueryError/MissingSegmentsError."""
    httpd, handler, q = _stub_shedding_server(sched_segments, shed_n=99)
    monkeypatch.setattr(RemoteDataNodeClient, "MAX_RETRY_AFTER_SLEEP", 0.05)
    try:
        client = RemoteDataNodeClient(
            "stub", f"http://127.0.0.1:{httpd.server_address[1]}")
        with pytest.raises(QueryCapacityError) as ei:
            client.run_partials(q, [str(sched_segments[0].id)])
        assert ei.value.retry_after_s == 0.05
        assert ei.value.server == "stub"
        assert len(handler.calls) == 2
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_long_retry_after_fails_fast_without_retry(sched_segments):
    """A drain estimate past MAX_RETRY_AFTER_SLEEP means the one retry is
    near-certain to shed again — the client must fail fast with the
    node's Retry-After, not sleep the cap and reissue a doomed request."""
    httpd, handler, q = _stub_shedding_server(sched_segments, shed_n=99,
                                              retry_after="10")
    try:
        client = RemoteDataNodeClient(
            "stub", f"http://127.0.0.1:{httpd.server_address[1]}")
        t0 = time.monotonic()
        with pytest.raises(QueryCapacityError) as ei:
            client.run_partials(q, [str(sched_segments[0].id)])
        assert time.monotonic() - t0 < 2.0, "slept toward a doomed retry"
        assert ei.value.retry_after_s == 10.0
        assert len(handler.calls) == 1, "no retry on a long drain estimate"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_broker_http_surface_propagates_429(sched_segments, monkeypatch):
    """End of the chain: the ORIGINAL client sees the same 429 +
    Retry-After contract from the broker's own HTTP resource."""
    from druid_tpu_torch.server.http import QueryHttpServer
    from druid_tpu_torch.server.lifecycle import QueryLifecycle

    httpd, handler, q = _stub_shedding_server(sched_segments, shed_n=99)
    monkeypatch.setattr(RemoteDataNodeClient, "MAX_RETRY_AFTER_SLEEP", 0.05)
    client = RemoteDataNodeClient(
        "stub", f"http://127.0.0.1:{httpd.server_address[1]}")
    view = InventoryView()
    view.register(client)
    for s in sched_segments:
        view.announce("stub", descriptor_for(s))
    broker = Broker(view, device="cpu")
    http = QueryHttpServer(QueryLifecycle(broker)).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{http.port}/druid/v2",
            data=json.dumps(q.to_json()).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 429
        assert int(ei.value.headers.get("Retry-After")) >= 1
        body = json.loads(ei.value.read())
        assert body["error"] == "Query capacity exceeded"
    finally:
        http.stop()
        broker.stop()
        httpd.shutdown()
        httpd.server_close()


def test_broker_fails_fast_with_clear_shed_error(sched_segments,
                                                 monkeypatch):
    """The broker surfaces a persistent shed as QueryCapacityError — a
    clear, typed saturation signal (429 at its own resource layer) instead
    of opaquely erroring the whole query."""
    httpd, handler, q = _stub_shedding_server(sched_segments, shed_n=99)
    monkeypatch.setattr(RemoteDataNodeClient, "MAX_RETRY_AFTER_SLEEP", 0.05)
    try:
        client = RemoteDataNodeClient(
            "stub", f"http://127.0.0.1:{httpd.server_address[1]}")
        view = InventoryView()
        view.register(client)
        for s in sched_segments:
            view.announce("stub", descriptor_for(s))
        broker = Broker(view, device="cpu")
        with pytest.raises(QueryCapacityError):
            broker.run(q)
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# scheduler × segment cache: cache-hit partials resolve inside the
# batched wave instead of routing per-query in a flush
# ---------------------------------------------------------------------------

def _cached_node(sched_segments, name="cache-node"):
    from druid_tpu_torch.cluster.cache import CacheConfig, LruCache
    n = DataNode(name, device="cpu", cache=LruCache(max_entries=256),
                 cache_config=CacheConfig())
    for s in sched_segments:
        n.load_segment(s)
    return n


def _parts_equal(a, b):
    assert len(a.partials) == len(b.partials)
    for pa, pb in zip(a.partials, b.partials):
        assert np.array_equal(pa.counts, pb.counts)
        assert set(pa.states) == set(pb.states)
        for k in pa.states:
            sa, sb = pa.states[k], pb.states[k]
            if isinstance(sa, dict):
                for kk in sa:
                    assert np.array_equal(np.asarray(sa[kk]),
                                          np.asarray(sb[kk]))
            else:
                assert np.array_equal(np.asarray(sa), np.asarray(sb))


def test_cached_query_is_fusable(node, sched_segments):
    """The composition gate: segment-cache-active queries now fuse — a hot
    datasource's cached queries must not serialize per-query in a flush."""
    n = _cached_node(sched_segments)
    q = _groupby("cache-fusable")
    assert n._segment_cache_active(q)
    assert n.fusable(q)


def test_fused_cache_population_identical_to_serial(sched_segments):
    """One run_partials_group flush over a cold cache must produce the
    SAME results and the SAME per-segment cache entries the serial
    run_partials path produces."""
    sids = [str(s.id) for s in sched_segments]
    q = _groupby("cache-pop")

    serial_node = _cached_node(sched_segments, "serial-cache-node")
    ap_serial, served_serial = serial_node.run_partials(q, sids)

    fused_node = _cached_node(sched_segments, "fused-cache-node")
    out = fused_node.run_partials_group([(q, sids, None)])
    assert not isinstance(out[0], BaseException)
    ap_fused, served_fused = out[0]
    assert served_fused == served_serial
    _parts_equal(ap_fused, ap_serial)
    assert _finish(q, ap_fused) == _finish(q, ap_serial)

    # entry-for-entry cache identity (counts + every kernel state)
    from druid_tpu_torch.cluster.cache import query_cache_key
    qkey = query_cache_key(q)
    for sid in sids:
        es = serial_node.cache.get("segment", f"{sid}|{qkey}")
        ef = fused_node.cache.get("segment", f"{sid}|{qkey}")
        assert es is not None and ef is not None
        _parts_equal(ef, es)


def test_fully_cached_query_resolves_without_any_compute(sched_segments,
                                                         monkeypatch):
    """All-hit queries resolve inline during the flush: the fused wave is
    never entered for them (no device work, no dispatcher serialization)."""
    sids = [str(s.id) for s in sched_segments]
    q = _groupby("cache-hot")
    n = _cached_node(sched_segments)
    first = n.run_partials_group([(q, sids, None)])[0]
    assert not isinstance(first, BaseException)

    calls = []
    real = engines.make_aggregate_partials_multi

    def counting(items, device, on_batch=None, clamp=True):
        calls.append(len(items))
        return real(items, device, on_batch=on_batch, clamp=clamp)

    monkeypatch.setattr(engines, "make_aggregate_partials_multi", counting)
    second = n.run_partials_group([(q, sids, None)])[0]
    assert calls == [], "an all-hit query must not enter the fused wave"
    assert not isinstance(second, BaseException)
    _parts_equal(second[0], first[0])
    assert second[1] == first[1]


def test_partial_hits_fuse_only_the_miss_set(sched_segments, monkeypatch):
    """A query with some cached segments sends ONLY its misses into the
    fused wave; results concatenate hits + computed exactly like the
    serial cached path, and the misses get cached."""
    from druid_tpu_torch.cluster.cache import query_cache_key
    sids = [str(s.id) for s in sched_segments]
    q = _groupby("cache-mix")
    n = _cached_node(sched_segments)
    warm = sids[:3]
    n.run_partials(q, warm)                      # pre-cache 3 segments
    qkey = query_cache_key(q)
    assert all(n.cache.get("segment", f"{sid}|{qkey}") for sid in warm)

    submitted = []
    real = engines.make_aggregate_partials_multi

    def spying(items, device, on_batch=None, clamp=True):
        submitted.extend(len(segs) for _, segs, _ in items)
        return real(items, device, on_batch=on_batch, clamp=clamp)

    monkeypatch.setattr(engines, "make_aggregate_partials_multi", spying)
    mate = _timeseries("cache-mate")
    out = n.run_partials_group([(q, sids, None), (mate, sids, None)])
    assert submitted == [len(sids) - 3, len(sids)], \
        "cached query must submit only its miss set"
    assert not isinstance(out[0], BaseException)
    assert not isinstance(out[1], BaseException)

    # every miss is now cached, and the result matches the serial path
    assert all(n.cache.get("segment", f"{sid}|{qkey}") for sid in sids)
    serial_node = _cached_node(sched_segments, "mix-serial-node")
    ap_serial, _ = serial_node.run_partials(q, sids)
    assert _finish(q, out[0][0]) == _finish(q, ap_serial)
    assert _finish(mate, out[1][0]) == _finish(
        mate, serial_node.run_partials(mate, sids)[0])


def test_cached_queries_fuse_through_the_scheduler(sched_segments):
    """End to end through DataNodeScheduler.submit: concurrent cache-active
    queries ride the flush (hits inline, misses fused) and return exactly
    the serial results."""
    sids = [str(s.id) for s in sched_segments]
    n = _cached_node(sched_segments)
    plain = _cached_node(sched_segments, "plain-node")
    queries = [_groupby(f"sc{i}") for i in range(4)]
    serial = [_finish(q, plain.run_partials(q, sids)[0]) for q in queries]

    sched = DataNodeScheduler(
        n, SchedulerConfig(batch_window_ms=40.0, lane_depths={})).start()
    try:
        for wave in range(2):                    # cold wave, then hot wave
            results = [None] * len(queries)
            errors = []

            def client(i):
                try:
                    results[i] = sched.submit(queries[i], sids)
                except Exception as e:           # pragma: no cover
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(queries))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert errors == []
            for q, expect, got in zip(queries, serial, results):
                ap, served = got
                assert served == {str(s.id) for s in sched_segments}
                assert _finish(q, ap) == expect
    finally:
        sched.stop()
