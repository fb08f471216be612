"""The port's in-process serving path (druid_tpu_torch/cluster/: Broker,
InventoryView, DataNode) against the reference package's, on the CPU.

The reference's `segments` data (4 segments of 5,000 rows over four days,
seed 42) is carried into the port as plain arrays (`_carry`). Both packages
build tests/test_cluster.py's cluster: 3 data nodes, the segments
round-robin with replica 2, one broker. The same Druid JSON then runs
through the port's Broker, the reference's Broker and the port's
QueryExecutor. The rule: counts, long sums, min/max and HLL estimates equal
bit for bit; the float sum `ds` within 1e-5 * sum|v| per row (its column is
positive, so sum|v| is the sum).

The cases follow tests/test_cluster.py's broker cases, plus a nested
groupBy and a bySegment query through the broker, four concurrent
Broker.run threads, and the bucket alignment that make_aggregate_partials'
clamp=False gives the data nodes. The SQL, HTTP/etag, 429 and coordinator
cases wait for those surfaces (ROADMAP).
"""
import random
import threading

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu import cluster as ref_cluster
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch import cluster as port_cluster
from druid_tpu_torch.cluster import view as port_view
from druid_tpu_torch.cluster.resilience import (HALF_OPEN, CircuitRegistry,
                                                ResiliencePolicy)
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import engines
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"},
        {"type": "doubleSum", "name": "ds", "fieldName": "metDouble"},
        {"type": "longMax", "name": "lmax", "fieldName": "metLong"}]
FLOAT_SUMS = {"ds"}


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"), datasource="test")
    return ref, [_carry(s) for s in ref]


def _build(pkg, segments, node_kw=None, broker_kw=None, n_nodes=3,
           replicas=2, node_cls=None):
    """tests/test_cluster.py's cluster in package `pkg` (the reference's or
    the port's `cluster`)."""
    view = pkg.InventoryView()
    cls = node_cls or pkg.DataNode
    nodes = [cls(f"node{i}", **(node_kw or {})) for i in range(n_nodes)]
    for n in nodes:
        view.register(n)
    for i, s in enumerate(segments):
        for j in range(replicas):
            node = nodes[(i + j) % n_nodes]
            node.load_segment(s)
            view.announce(node.name, pkg.descriptor_for(s))
    return view, nodes, pkg.Broker(view, **(broker_kw or {}))


@pytest.fixture()
def both(segs):
    """(reference cluster, port cluster), each with segment caches on its
    nodes and a result cache on its broker, as the reference fixture."""
    ref, port = segs
    r = _build(ref_cluster, ref, {"cache": ref_cluster.LruCache()},
               {"cache": ref_cluster.LruCache()})
    p = _build(port_cluster, port,
               {"cache": port_cluster.LruCache(), "device": "cpu"},
               {"cache": port_cluster.LruCache(), "device": "cpu"})
    yield r, p
    r[2].stop()
    p[2].stop()


def _close(want, got, where=()):
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            if k in FLOAT_SUMS:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), \
                    (where, k, want[k], got[k])
            else:
                _close(want[k], got[k], where + (k,))
    elif isinstance(want, list):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _close(a, b, where + (i,))
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), where
    else:
        assert got == want and type(got) is type(want), (where, want, got)


def _port_local(segs, q):
    return PortExecutor(segs[1], device="cpu").run_json(q)


def _all_three(both, segs, q):
    """The port broker's rows against the reference broker's and the port
    executor's."""
    (_, _, rb), (_, _, pb) = both
    got = pb.run_json(q)
    _close(rb.run_json(q), got)
    _close(_port_local(segs, q), got)
    return got


def _ts(gran="all", **kw):
    return dict({"queryType": "timeseries", "dataSource": "test",
                 "intervals": [WEEK], "granularity": gran,
                 "aggregations": AGGS}, **kw)


def _topn(dim="dimB", threshold=10, **kw):
    return dict({"queryType": "topN", "dataSource": "test",
                 "intervals": [WEEK], "granularity": "all", "dimension": dim,
                 "metric": "ls", "threshold": threshold,
                 "aggregations": AGGS}, **kw)


def _gb(gran="day", dims=("dimA",), **kw):
    return dict({"queryType": "groupBy", "dataSource": "test",
                 "intervals": [WEEK], "granularity": gran,
                 "dimensions": list(dims), "aggregations": AGGS}, **kw)


def test_broker_timeseries_matches_reference(both, segs):
    rows = _all_three(both, segs, _ts("day"))
    assert len(rows) == 4


def test_broker_topn_matches_reference(both, segs):
    rows = _all_three(both, segs, _topn())
    assert len(rows[0]["result"]) == 10


def test_broker_groupby_matches_reference(both, segs):
    rows = _all_three(both, segs, _gb())
    assert len(rows) == 40


def test_broker_groupby_filtered_two_dims(both, segs):
    _all_three(both, segs, _gb("all", ("dimA", "dimB"), filter={
        "type": "and", "fields": [
            {"type": "in", "dimension": "dimA",
             "values": ["v00000001", "v00000003", "v00000004"]},
            {"type": "bound", "dimension": "metLong", "lower": "10",
             "upper": "80", "ordering": "numeric"}]}))


def test_broker_hll_exact_state_merge(both, segs):
    """HLL registers merge across nodes exactly: the broker's estimate is
    the single process's, in both packages."""
    q = {"queryType": "timeseries", "dataSource": "test",
         "intervals": [WEEK], "granularity": "all",
         "aggregations": [{"type": "cardinality", "name": "u",
                           "fields": ["dimHi"]},
                          {"type": "hyperUnique", "name": "h",
                           "fieldName": "dimB"}]}
    rows = _all_three(both, segs, q)
    assert rows[0]["result"]["u"] > 1000


def test_broker_row_queries(both, segs):
    (_, _, rb), (_, _, pb) = both
    tb = {"queryType": "timeBoundary", "dataSource": "test",
          "intervals": [WEEK]}
    _all_three(both, segs, tb)
    sc = {"queryType": "scan", "dataSource": "test", "intervals": [WEEK],
          "columns": ["dimA", "metLong"], "limit": 17, "order": "ascending"}
    got = pb.run_json(sc)
    assert sum(len(b["events"]) for b in got) == 17
    _close(rb.run_json(sc), got)
    _close(_port_local(segs, sc), got)
    se = {"queryType": "search", "dataSource": "test", "intervals": [WEEK],
          "query": {"type": "insensitive_contains", "value": "0000"},
          "limit": 5}
    _all_three(both, segs, se)


def test_broker_retry_on_dead_server(both, segs):
    (_, rn, _), (_, pn, _) = both
    rn[0].alive = False
    pn[0].alive = False
    _all_three(both, segs, _ts("day"))


def test_broker_missing_segments_error(segs):
    view, nodes, broker = _build(port_cluster, segs[1], {"device": "cpu"},
                                 {"device": "cpu"}, n_nodes=1, replicas=1)
    nodes[0].alive = False
    with pytest.raises(port_cluster.MissingSegmentsError):
        broker.run_json(_ts())
    broker.stop()


def test_server_removal_updates_view(both, segs):
    (rv, _, _), (pv, _, _) = both
    rv.remove_node("node1")
    pv.remove_node("node1")
    assert pv.served_segments("node1") == []
    _all_three(both, segs, _ts("day"))


def test_result_level_cache(both, segs):
    _, (_, _, pb) = both
    q = _topn("dimA", 5)
    first = _all_three(both, segs, q)
    assert pb.cache.stats.misses >= 1
    hits = pb.cache.stats.hits
    assert pb.run_json(q) == first
    assert pb.cache.stats.hits == hits + 1


def test_segment_level_cache(both, segs):
    (_, rn, rb), (_, pn, pb) = both
    for b, pkg in ((rb, ref_cluster), (pb, port_cluster)):
        b.cache_config = pkg.CacheConfig(use_result_cache=False,
                                         populate_result_cache=False)
    q = _gb("all")
    _all_three(both, segs, q)
    assert sum(n.cache.stats.puts for n in pn) >= len(segs[1])
    hits = sum(n.cache.stats.hits for n in pn)
    _all_three(both, segs, q)
    assert sum(n.cache.stats.hits for n in pn) > hits


def test_broker_scan_offset_without_limit(both, segs):
    _, (_, _, pb) = both
    q = {"queryType": "scan", "dataSource": "test", "intervals": [WEEK],
         "columns": ["dimA"], "offset": 10, "order": "ascending"}
    total = sum(s.n_rows for s in segs[1])
    assert sum(len(b["events"]) for b in pb.run_json(q)) == total - 10


def test_broker_all_granularity_timestamp(both, segs):
    q = dict(_ts(), intervals=["2020-01-01/2030-01-01"])
    rows = _all_three(both, segs, q)
    assert rows[0]["timestamp"] == Interval.of("2020-01-01", "2021-01-01").start


def test_remove_last_holder_removes_from_timeline(segs):
    view, nodes, _ = _build(port_cluster, segs[1], {"device": "cpu"},
                            {"device": "cpu"}, n_nodes=1, replicas=1)
    assert view.datasources() == ["test"]
    view.remove_node("node0")
    assert view.datasources() == []
    broker = port_cluster.Broker(view, device="cpu")
    assert broker.run_json(_ts()) == []
    broker.stop()


class _SickNode(port_cluster.DataNode):
    """Serves segments but fails queries with a server error (reachable,
    sick: the HTTP-500 case)."""

    def __init__(self, name, failures=10**9, **kw):
        super().__init__(name, **kw)
        self.failures = failures

    def run_partials(self, query, segment_ids, check=None):
        if self.failures > 0:
            self.failures -= 1
            raise RuntimeError("node exploded mid-query")
        return super().run_partials(query, segment_ids, check)


def _sick_and_good(segments, with_good=True):
    view = port_cluster.InventoryView()
    nodes = [_SickNode("sick", device="cpu")]
    if with_good:
        nodes.append(port_cluster.DataNode("good", device="cpu"))
    for n in nodes:
        view.register(n)
        for s in segments:
            n.load_segment(s)
            view.announce(n.name, port_cluster.descriptor_for(s))
    return view, nodes, port_cluster.Broker(view, device="cpu")


def test_broker_retries_sick_node_on_replica(segs):
    _, _, broker = _sick_and_good(segs[1])
    _close(_port_local(segs, _ts("day")), broker.run_json(_ts("day")))
    broker.stop()


def test_broker_reports_node_error_when_replicas_exhausted(segs):
    _, _, broker = _sick_and_good(segs[1], with_good=False)
    with pytest.raises(RuntimeError, match="exploded"):
        broker.run_json(_ts())
    broker.stop()


def test_replica_pick_fuzz_exclusions_and_circuits():
    """tests/test_cluster.py's fuzz of ReplicaSet.pick on the port's view
    and breakers: never an excluded server; never a still-cooling open
    server while a closed or cooled one exists; a cooled pick, and the
    all-open fallback, tagged as the half-open probe."""
    rng = random.Random(123)
    servers_all = [f"s{i}" for i in range(6)]
    for trial in range(400):
        now = [0.0]
        reg = CircuitRegistry(
            ResiliencePolicy(circuit_failure_threshold=1,
                             circuit_cooldown_s=5.0,
                             circuit_cooldown_cap_s=5.0),
            seed=trial, clock=lambda: now[0])
        rs = port_view.ReplicaSet(descriptor=None)
        members = set(rng.sample(servers_all, rng.randint(1, 6)))
        rs.servers = set(members)
        exclude = set(rng.sample(sorted(members),
                                 rng.randint(0, len(members))))
        cooled_open, cooling_open = set(), set()
        for s in sorted(members):
            r = rng.random()
            if r < 0.3:
                cooled_open.add(s)
            elif r < 0.55:
                cooling_open.add(s)
        for s in sorted(cooled_open):
            reg.on_failure(s)            # cooldown ends at t=5
        now[0] = 6.0
        for s in sorted(cooling_open):
            reg.on_failure(s)            # cooldown ends at t=11
        chosen = rs.pick(rng, exclude=exclude, circuits=reg)
        candidates = members - exclude
        if not candidates:
            assert chosen is None
            continue
        assert chosen in candidates
        closed_c = candidates - cooled_open - cooling_open
        cooled_c = candidates & cooled_open
        if closed_c or cooled_c:
            assert chosen in closed_c | cooled_c
            if chosen in cooled_c:
                assert reg.state_of(chosen) == HALF_OPEN
        else:
            assert reg.state_of(chosen) == HALF_OPEN
            assert reg.snapshot()["probes"] >= 1


def test_broker_nested_groupby(both, segs):
    inner = _gb("all", ("dimA", "dimB"))
    q = {"queryType": "groupBy", "intervals": [WEEK], "granularity": "all",
         "dataSource": {"type": "query", "query": inner},
         "dimensions": ["dimA"],
         "aggregations": [{"type": "longSum", "name": "ls",
                           "fieldName": "ls"},
                          {"type": "count", "name": "groups"}]}
    rows = _all_three(both, segs, q)
    assert len(rows) == 10


@pytest.mark.parametrize("q", [_ts("day"), _gb("all")],
                         ids=["timeseries", "groupBy"])
def test_broker_by_segment(both, segs, q):
    q = dict(q, context={"bySegment": True})
    rows = _all_three(both, segs, q)
    assert [r["result"]["segment"] for r in rows] \
        == sorted(str(s.id) for s in segs[1])


def test_concurrent_broker_runs_match_single_thread(segs):
    """Four threads on one port broker, each running the groupBy, topN and
    timeseries, give the single-thread rows (the nodes share one process,
    one device pool and the segments' caches)."""
    _, _, broker = _build(port_cluster, segs[1], {"device": "cpu"},
                          {"device": "cpu"})
    qs = [_gb("all", ("dimA", "dimB")), _topn(), _ts("day")]
    want = [broker.run_json(q) for q in qs]
    got, errors = {}, []

    def worker(i):
        try:
            got[i] = [broker.run_json(q) for q in qs]
        except Exception as e:     # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(got) == 4
    for rows in got.values():
        _close(want, rows)
    broker.stop()


def test_unclamped_partials_align_buckets_across_nodes(segs, monkeypatch):
    """Two nodes hold two days each. The broker bounds the query intervals
    and the nodes build partials with clamp=False: every node's bucket
    index space starts at the same day, and the rows equal the executor's.
    With the clamp forced on, the late node's buckets restart at its own
    first day and the merged rows go wrong."""
    ref, port = segs
    view = port_cluster.InventoryView()
    nodes = [port_cluster.DataNode(n, device="cpu") for n in ("early",
                                                              "late")]
    for n in nodes:
        view.register(n)
    for i, s in enumerate(port):
        node = nodes[i // 2]
        node.load_segment(s)
        view.announce(node.name, port_cluster.descriptor_for(s))
    broker = port_cluster.Broker(view, device="cpu")
    q = _ts("day")
    want = _port_local(segs, q)
    _close(want, broker.run_json(q))
    _close(RefExecutor(ref).run_json(q), broker.run_json(q))

    real = engines.make_aggregate_partials

    def clamped(query, segments, device, clamp=True, check=None):
        return real(query, segments, device, clamp=True, check=check)
    monkeypatch.setattr(port_view, "make_aggregate_partials", clamped)
    assert broker.run_json(q) != want
    broker.stop()


def test_dead_node_never_called_once_removed(both, segs):
    """check_liveness drops a dead node from the view: its segments fail
    over to their other replica and the node is not called again."""
    _, (pv, pn, pb) = both
    pn[2].alive = False
    assert pv.check_liveness() == ["node2"]
    assert pv.node("node2") is None
    _all_three(both, segs, _ts("day"))
    assert pb.resilience.circuits.failures_by_server() == {}


def test_hybrid_remote_cache_through_broker(segs):
    """A port broker on a hybrid cache (local L1 + the loopback remote L2)
    serves repeat queries from cache; a second broker sharing only the
    remote tier hits it too; a dead remote degrades to misses. The rows
    are plain JSON data, so they cross the remote tier whole."""
    server = port_cluster.RemoteCacheServer().start()
    view, _, _ = _build(port_cluster, segs[1], {"device": "cpu"},
                        {"device": "cpu"}, n_nodes=1, replicas=1)

    def hybrid():
        return port_cluster.HybridCache(
            port_cluster.LruCache(),
            port_cluster.RemoteCacheClient("127.0.0.1", server.port))
    q = _topn("dimA", 5)
    try:
        b1 = port_cluster.Broker(view, cache=hybrid(), device="cpu")
        b2 = port_cluster.Broker(view, cache=hybrid(), device="cpu")
        first = b1.run_json(q)
        _close(_port_local(segs, q), first)
        assert b1.cache.stats.misses >= 1
        assert b1.run_json(q) == first
        assert b1.cache.stats.hits >= 1
        assert b2.run_json(q) == first          # an L2 hit
        assert b2.cache.l2.stats.hits >= 1
        assert b2.cache.l1.stats.puts >= 1      # which filled b2's L1
    finally:
        server.stop()
    b3 = port_cluster.Broker(view, cache=hybrid(), device="cpu")
    assert b3.run_json(q) == first
    assert b3.run_json(q) == first
    for b in (b1, b2, b3):
        b.stop()


def test_remote_cache_wire_is_data_only():
    """The remote cache carries JSON frames only: values round-trip as
    data, numpy values lower to plain numbers, an opaque object is dropped
    client-side, and a pickle frame is a malformed frame that drops the
    connection without being interpreted. The port's client and the
    reference's server speak the same frames."""
    import pickle
    import socket
    import struct
    server = port_cluster.RemoteCacheServer().start()
    try:
        c = port_cluster.RemoteCacheClient("127.0.0.1", server.port)
        rows = {"rows": [1, 2.5, "x"], "nested": {"a": [True, None]}}
        c.put("ns", "k", rows)
        assert c.get("ns", "k") == rows
        c.put("ns", "np", {"v": np.int64(7), "arr": np.arange(3)})
        assert c.get("ns", "np") == {"v": 7, "arr": [0, 1, 2]}

        class Opaque:
            pass
        c.put("ns", "bad", Opaque())
        assert c.get("ns", "bad") is None
        assert c.stats.dropped_puts == 1
        evil = pickle.dumps({"op": "get", "ns": "ns", "key": "k"})
        s = socket.create_connection(("127.0.0.1", server.port), timeout=2)
        s.sendall(struct.pack(">I", len(evil)) + evil)
        s.close()
        assert c.get("ns", "k") == rows
        c.close()
    finally:
        server.stop()
    ref_server = ref_cluster.RemoteCacheServer().start()
    try:
        c = port_cluster.RemoteCacheClient("127.0.0.1", ref_server.port)
        c.put("ns", "k", {"a": [1, 2]})
        assert ref_cluster.RemoteCacheClient(
            "127.0.0.1", ref_server.port).get("ns", "k") == {"a": [1, 2]}
        c.close()
    finally:
        ref_server.stop()


def test_inventory_sync_follows_load_and_drop(segs):
    """sync_all announces what a node now serves and unannounces what it
    dropped (the inventory poll), and the broker's rows follow."""
    view = port_cluster.InventoryView()
    node = port_cluster.DataNode("n0", device="cpu")
    view.register(node)
    for s in segs[1][:2]:
        node.load_segment(s)
    assert view.sync_all() == (2, 0)
    broker = port_cluster.Broker(view, device="cpu")
    _close(PortExecutor(segs[1][:2], device="cpu").run_json(_ts("day")),
           broker.run_json(_ts("day")))
    node.load_segment(segs[1][2])
    node.drop_segment(str(segs[1][0].id))
    assert view.sync_all() == (1, 1)
    assert sorted(d.id for d in view.served_segments("n0")) \
        == sorted(str(s.id) for s in segs[1][1:3])
    _close(PortExecutor(segs[1][1:3], device="cpu").run_json(_ts("day")),
           broker.run_json(_ts("day")))
    broker.stop()


def test_broker_streaming_scan(both, segs):
    """run_streaming scatters an ordered scan one segment at a time and
    stops when the limit is met: the batches equal the broker's
    materialized run and the reference broker's."""
    (_, _, rb), (_, _, pb) = both
    from druid_tpu_torch.query.model import query_from_json
    from druid_tpu.query.model import query_from_json as ref_query
    q = {"queryType": "scan", "dataSource": "test", "intervals": [WEEK],
         "columns": ["__time", "dimA", "metLong"], "limit": 7000,
         "offset": 5, "order": "descending", "batchSize": 1000}
    got = list(pb.run_streaming(query_from_json(q)))
    assert sum(len(b["events"]) for b in got) == 7000
    _close(pb.run_json(q), got)
    _close(list(rb.run_streaming(ref_query(q))), got)
