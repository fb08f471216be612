"""The port's appenderator, stream tasks and realtime server
(druid_tpu_torch/ingest/{appenderator,streaming}.py,
druid_tpu_torch/cluster/realtime.py) against the reference package's, on
the CPU.

Every case of tests/test_realtime.py runs through BOTH packages with the
same records (made from a seed with numpy): the allocator's identities, the
committed offsets, the published descriptors and every query's rows must
be equal; the reference's assertions hold on the port. The port's nodes,
brokers and realtime servers run on device "cpu". Exactly-once holds on a
task failure and on a duplicate publish, in-flight rows answer through the
broker before publish, and the handoff keeps the broker's rows unchanged.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster as r_cluster
import druid_tpu.cluster.metadata as r_metadata
import druid_tpu.ingest as r_ingest
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.model as r_model
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster as p_cluster
import druid_tpu_torch.cluster.metadata as p_metadata
import druid_tpu_torch.ingest as p_ingest
import druid_tpu_torch.query.aggregators as p_aggs
import druid_tpu_torch.query.model as p_model
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.utils.intervals import Interval as PInterval
from tests.test_torch_ingest import close

torch.set_num_threads(1)

DAY_TEXT = ("2026-03-01", "2026-03-02")
T0 = RInterval.of(*DAY_TEXT).start


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(
            name="ref", C=r_cluster, MD=r_metadata, I=r_ingest, A=r_aggs,
            M=r_model, DAY=RInterval.of(*DAY_TEXT), dev={},
            executor=lambda segs: RefExecutor(segs))
    return SimpleNamespace(
        name="port", C=p_cluster, MD=p_metadata, I=p_ingest, A=p_aggs,
        M=p_model, DAY=PInterval.of(*DAY_TEXT), dev={"device": "cpu"},
        executor=lambda segs: PortExecutor(segs, device="cpu"))


REF, PORT = _pkg(True), _pkg(False)


def both(fn):
    return fn(REF), fn(PORT)


def SPECS(pk):
    return [pk.A.CountAggregator("rows"), pk.A.LongSumAggregator("v", "value")]


# rolled-up data re-queries through the combining forms over the stored
# metric columns (count re-queries as longSum of the row-count column)
def QSPECS(pk):
    return [pk.A.LongSumAggregator("rows", "rows"),
            pk.A.LongSumAggregator("v", "v")]


def _ts(pk):
    return pk.M.TimeseriesQuery.of("stream_ds", [pk.DAY], QSPECS(pk))


def _records(n, t_start=T0, dim_card=5, seed=0):
    rng = np.random.default_rng(seed)
    return [{"timestamp": int(t_start + i * 1000),
             "page": f"p{int(rng.integers(dim_card))}",
             "value": int(rng.integers(0, 10))} for i in range(n)]


def _batch(pk, records):
    return pk.I.RowBatch([r["timestamp"] for r in records],
                         {"page": [r["page"] for r in records],
                          "value": [r["value"] for r in records]})


def _ident(i):
    return (str(i.interval), i.version, i.partition, i.id)


def _descs(md, ds):
    return sorted((d.id, d.num_rows) for d in md.used_segments(ds))


# ---------------------------------------------------------------------------
# Appenderator
# ---------------------------------------------------------------------------

def test_allocator_partitions_and_versions():
    def run(pk):
        md = pk.C.MetadataStore()
        alloc = pk.I.SegmentAllocator(md, "hour")
        a, b = alloc.allocate("ds", T0), alloc.allocate("ds", T0)
        c = alloc.allocate("ds", T0 + 3_600_000)
        md.publish_segments([pk.MD.SegmentDescriptor("ds", a.interval,
                                                     a.version, 5)])
        d = pk.I.SegmentAllocator(md, "hour").allocate("ds", T0,
                                                       version=a.version)
        return a, b, c, d
    r, p = both(run)
    a, b, c, d = p
    assert a.interval == b.interval and a.partition == 0 and b.partition == 1
    assert c.interval.start == T0 + 3_600_000 and c.partition == 0
    assert d.partition == 6
    # the versions are allocation times: equal shape, not equal values
    assert [(str(x.interval), x.partition) for x in p] == \
        [(str(x.interval), x.partition) for x in r]
    assert a.version == b.version == d.version


def test_concurrent_allocators_share_version():
    def run(pk):
        md = pk.C.MetadataStore()
        a1, a2 = (pk.I.SegmentAllocator(md, "hour") for _ in range(2))
        return a1.allocate("ds", T0), a2.allocate("ds", T0), \
            a1.allocate("ds", T0)
    r, (x, y, z) = both(run)
    assert x.version == y.version == z.version
    assert sorted([x.partition, y.partition, z.partition]) == [0, 1, 2]
    assert [i.partition for i in r] == [x.partition, y.partition, z.partition]


def test_allocation_refuses_conflicting_granularity():
    def run(pk):
        md = pk.C.MetadataStore()
        md.publish_segments([pk.MD.SegmentDescriptor("ds", pk.DAY, "v1", 0)])
        with pytest.raises(pk.MD.SegmentAllocationError):
            pk.I.SegmentAllocator(md, "hour").allocate("ds", T0)
        return _ident(pk.I.SegmentAllocator(md, "day").allocate("ds", T0))
    r, p = both(run)
    assert p == r and p[1:3] == ("v1", 1)


def test_pending_segments_cleanup():
    def run(pk):
        md = pk.C.MetadataStore()
        alloc = pk.I.SegmentAllocator(md, "hour")
        a = alloc.allocate("ds", T0)
        alloc.allocate("ds", T0)
        md.publish_segments([pk.MD.SegmentDescriptor(
            "ds", a.interval, a.version, a.partition)])
        return md.kill_pending_segments("ds"), md.kill_pending_segments("ds")
    assert both(run) == ((1, 0), (1, 0))


def test_appenderator_rollup_and_query():
    recs = _records(1000)

    def run(pk):
        app = pk.I.Appenderator("rt", SPECS(pk), query_granularity="none",
                                max_rows_per_hydrant=300)
        ident = pk.I.SegmentAllocator(pk.C.MetadataStore(), "day").allocate(
            "rt", T0)
        for i in range(0, 1000, 100):
            app.add(ident, _batch(pk, recs[i:i + 100]))
        sink = app._sinks[ident.id]
        q = pk.M.TimeseriesQuery.of("rt", [pk.DAY], QSPECS(pk))
        rows = pk.executor(app.query_segments()).run(q)
        (desc, seg), = app.push([ident])
        return (len(sink.hydrants), list(sink.hydrants), rows, desc.id ==
                ident.id, seg, pk.executor([seg]).run(q))
    (rn, rhyd, rrows, _, rseg, rrows2), (n, hyd, rows, same_id, seg,
                                         rows2) = both(run)
    assert n == rn and n >= 3
    for a, b in zip(rhyd, hyd):
        assert np.array_equal(a.time_ms, b.time_ms)
    assert rows[0]["result"]["rows"] == 1000
    assert rows[0]["result"]["v"] == sum(r["value"] for r in recs)
    assert same_id and rows2 == rows
    close(rrows, rows)
    close(rrows2, rows2)
    assert np.array_equal(seg.time_ms, rseg.time_ms)
    assert seg.dims["page"].dictionary.values == \
        rseg.dims["page"].dictionary.values
    for m in ("rows", "v"):
        assert np.array_equal(seg.metrics[m].values, rseg.metrics[m].values)


def test_driver_routes_by_segment_granularity():
    def run(pk):
        md = pk.C.MetadataStore()
        app = pk.I.Appenderator("rt", SPECS(pk))
        driver = pk.I.StreamAppenderatorDriver(
            app, pk.I.SegmentAllocator(md, "hour"), md)
        recs = _records(100) + _records(100, t_start=T0 + 2 * 3_600_000)
        touched = driver.add_batch(_batch(pk, recs))
        return sorted(i.interval.start for i in app.sink_ids()), \
            [i.partition for i in touched]
    r, p = both(run)
    assert p == r and p[0] == [T0, T0 + 2 * 3_600_000]


def test_driver_publish_cas():
    def run(pk):
        md = pk.C.MetadataStore()
        app = pk.I.Appenderator("rt", SPECS(pk))
        driver = pk.I.StreamAppenderatorDriver(
            app, pk.I.SegmentAllocator(md, "day"), md)
        driver.add_batch(_batch(pk, _records(50)))
        ok1 = driver.publish_all(None, {"offset": 50})
        meta = md.datasource_metadata("rt")
        app2 = pk.I.Appenderator("rt", SPECS(pk))
        d2 = pk.I.StreamAppenderatorDriver(
            app2, pk.I.SegmentAllocator(md, "day"), md)
        d2.add_batch(_batch(pk, _records(50)))
        ok2 = d2.publish_all(None, {"offset": 50})
        return ok1, meta, ok2, len(md.used_segments("rt")), app.sink_ids(), \
            len(app2.sink_ids())
    r, p = both(run)
    assert p[:4] == r[:4] == (True, {"offset": 50}, False, 1)
    # the winner's sinks dropped after publish; the loser's stay intact
    assert p[4] == [] and p[5] == 1


# ---------------------------------------------------------------------------
# Streaming supervisor: exactly-once under failure
# ---------------------------------------------------------------------------

def _supervisor(pk, md, stream, handoff=None, task_count=1, max_rows=10**9,
                realtime=None):
    spec = pk.I.StreamSupervisorSpec(
        "stream_ds", SPECS(pk), dimensions=["page"], task_count=task_count,
        max_rows_per_task=max_rows,
        tuning=pk.I.StreamTuningConfig(segment_granularity="day"))
    return pk.I.StreamSupervisor(spec, stream, md, handoff=handoff,
                                 realtime=realtime)


def test_stream_ingest_end_to_end():
    def run(pk):
        md = pk.C.MetadataStore()
        stream = pk.I.SimulatedStream(n_partitions=2)
        stream.append(0, _records(500, seed=1))
        stream.append(1, _records(300, t_start=T0 + 1000, seed=2))
        sup = _supervisor(pk, md, stream, task_count=2)
        sup.run_once()
        rows = pk.executor(sup.query_segments()).run(_ts(pk))
        ok = sup.checkpoint_all()
        return rows, ok, md.datasource_metadata("stream_ds"), \
            sum(d.num_rows for d in md.used_segments("stream_ds")), \
            sorted(t["status"] for t in md.tasks())
    r, p = both(run)
    assert p[0][0]["result"]["rows"] == 800
    assert p[1] and p[2]["partitions"] == {"0": 500, "1": 300} and p[3] > 0
    assert p[2:] == r[2:]
    close(r[0], p[0])


def test_stream_exactly_once_on_task_failure():
    def run(pk):
        md = pk.C.MetadataStore()
        published = []
        stream = pk.I.SimulatedStream(n_partitions=1)
        stream.append(0, _records(400, seed=3))
        sup = _supervisor(pk, md, stream,
                          handoff=lambda pushed: published.extend(pushed))
        sup.run_once()
        assert sup.checkpoint_all()
        stream.append(0, _records(200, t_start=T0 + 500_000, seed=4))
        sup.run_once()
        task = list(sup.tasks.values())[0]
        assert task.current_offsets[0] == 600
        task.status = "FAILED"            # simulated crash before publish
        sup.run_once()
        new_task = list(sup.tasks.values())[0]
        assert new_task is not task and new_task.start_offsets[0] == 400
        assert sup.checkpoint_all()
        rows = pk.executor([seg for _, seg in published]).run(_ts(pk))
        return md.datasource_metadata("stream_ds"), rows, \
            [seg for _, seg in published]
    (rmeta, rrows, rsegs), (meta, rows, segs) = both(run)
    assert meta["partitions"] == {"0": 600} and meta == rmeta
    recs = _records(400, seed=3) + _records(200, t_start=T0 + 500_000,
                                            seed=4)
    assert rows[0]["result"]["rows"] == 600
    assert rows[0]["result"]["v"] == sum(r["value"] for r in recs)
    close(rrows, rows)
    assert len(segs) == len(rsegs)
    for a, b in zip(rsegs, segs):
        assert np.array_equal(a.time_ms, b.time_ms)


def test_stream_duplicate_publish_rejected():
    def run(pk):
        md = pk.C.MetadataStore()
        stream = pk.I.SimulatedStream(n_partitions=1)
        stream.append(0, _records(100, seed=5))
        sup_a, sup_b = _supervisor(pk, md, stream), _supervisor(pk, md,
                                                                stream)
        sup_a.run_once()
        sup_b.run_once()
        return sup_a.checkpoint_all(), sup_b.checkpoint_all(), \
            md.datasource_metadata("stream_ds"), \
            sum(d.num_rows for d in md.used_segments("stream_ds")), \
            sorted(t["status"] for t in md.tasks())
    r, p = both(run)
    assert p == r
    assert p[:4] == (True, False, {"partitions": {"0": 100}}, 100)


def test_realtime_queryable_through_broker_before_publish():
    recs, more = _records(300, seed=7), _records(
        100, t_start=T0 + 50_000_000, seed=8)

    def run(pk):
        md = pk.C.MetadataStore()
        view = pk.C.InventoryView()
        rt = pk.C.RealtimeServer("peon0", view, **pk.dev)
        stream = pk.I.SimulatedStream(n_partitions=1)
        stream.append(0, recs)
        sup = _supervisor(pk, md, stream, realtime=rt)
        sup.run_once()
        assert md.datasource_metadata("stream_ds") is None
        broker = pk.C.Broker(view, **pk.dev)
        try:
            assert "stream_ds" in broker.datasources
            rows1 = broker.run(_ts(pk))
            stream.append(0, more)
            sup.run_once()
            rows2 = broker.run(_ts(pk))
            tb = broker.run(pk.M.TimeBoundaryQuery.of("stream_ds", [pk.DAY]))
        finally:
            broker.stop()
        return rows1, rows2, tb, sorted(rt.served_segment_ids())
    r, p = both(run)
    rows1, rows2, tb, served = p
    assert rows1[0]["result"]["rows"] == 300
    assert rows1[0]["result"]["v"] == sum(x["value"] for x in recs)
    assert rows2[0]["result"]["rows"] == 400
    assert tb[0]["result"]["minTime"] == T0
    close(r[:3], p[:3])
    assert len(served) == 1 == len(r[3])


def test_realtime_handoff_is_seamless():
    recs = _records(250, seed=9)

    def run(pk):
        md = pk.C.MetadataStore()
        view = pk.C.InventoryView()
        rt = pk.C.RealtimeServer("peon0", view, **pk.dev)
        node = pk.C.DataNode("historical0", **pk.dev)
        view.register(node)

        def handoff(pushed):
            for desc, seg in pushed:
                node.load_segment(seg)
                view.announce(node.name, desc)

        stream = pk.I.SimulatedStream(n_partitions=1)
        stream.append(0, recs)
        sup = _supervisor(pk, md, stream, handoff=handoff, realtime=rt)
        sup.run_once()
        broker = pk.C.Broker(view, **pk.dev)
        try:
            before = broker.run(_ts(pk))
            assert sup.checkpoint_all()
            assert rt.served_segment_ids() == set()
            assert node.segment_count() == 1
            after = broker.run(_ts(pk))
        finally:
            broker.stop()
        sets = [view.replica_set(str(s.id)) for s in node.segments()]
        assert sets and all(rs.servers == {"historical0"} for rs in sets)
        return before, after
    (rb, ra), (before, after) = both(run)
    assert before[0]["result"]["rows"] == 250
    assert after == before
    close(rb, before)
    close(ra, after)


def test_stream_handoff_to_cluster():
    recs = _records(250, seed=6)

    def run(pk):
        md = pk.C.MetadataStore()
        view = pk.C.InventoryView()
        node = pk.C.DataNode("historical0", **pk.dev)
        view.register(node)

        def handoff(pushed):
            for desc, seg in pushed:
                node.load_segment(seg)
                view.announce(node.name, desc)

        stream = pk.I.SimulatedStream(n_partitions=1)
        stream.append(0, recs)
        sup = _supervisor(pk, md, stream, handoff=handoff)
        sup.run_once()
        assert sup.checkpoint_all()
        broker = pk.C.Broker(view, **pk.dev)
        try:
            return broker.run(_ts(pk)), node.segments()[0]
        finally:
            broker.stop()
    (rrows, rseg), (rows, seg) = both(run)
    assert rows[0]["result"]["rows"] == 250
    assert rows[0]["result"]["v"] == sum(r["value"] for r in recs)
    close(rrows, rows)
    assert np.array_equal(seg.time_ms, rseg.time_ms)


# ---------------------------------------------------------------------------
# The port's own: deep storage before the commit, the realtime server's
# surface, and the supervisor's roll-over
# ---------------------------------------------------------------------------

def test_publish_pushes_to_deep_storage_and_loads_back(tmp_path):
    """A driver with deep storage pushes each merged sink before the
    metadata commit: the committed descriptors carry load specs, and a
    LoadQueuePeon loads them into a DataNode whose rows equal the
    reference's published segment."""
    from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
    from druid_tpu_torch.storage.deep import LocalDeepStorage
    recs = _records(700, seed=21)

    def published(pk, deep=None):
        md = pk.C.MetadataStore()
        app = pk.I.Appenderator("rt", SPECS(pk), max_rows_per_hydrant=200)
        driver = pk.I.StreamAppenderatorDriver(
            app, pk.I.SegmentAllocator(md, "day"), md, deep_storage=deep)
        driver.add_batch(_batch(pk, recs))
        assert driver.publish_all(None, {"partitions": {"0": 700}})
        return md
    deep = LocalDeepStorage(str(tmp_path / "deep"))
    md = published(PORT, deep)
    (desc,) = md.used_segments("rt")
    assert desc.load_spec and desc.num_rows > 0
    view = p_cluster.InventoryView()
    node = p_cluster.DataNode("hist", device="cpu")
    view.register(node)
    peon = LoadQueuePeon(node, view, deep.pull)
    try:
        assert peon.load(desc) and peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert peon.failures == []
    q = p_model.TimeseriesQuery.of("rt", [PORT.DAY], QSPECS(PORT))
    broker = p_cluster.Broker(view, device="cpu")
    try:
        got = broker.run(q)
    finally:
        broker.stop()
    rmd = published(REF)
    assert [d.num_rows for d in rmd.used_segments("rt")] == [desc.num_rows]
    assert got[0]["result"] == {"rows": 700,
                                "v": sum(r["value"] for r in recs)}


def test_realtime_server_node_surface():
    """RealtimeServer answers run_partials/run_rows for the sinks it
    serves, skips ids it does not, never caches, and refuses when down."""
    md = p_cluster.MetadataStore()
    view = p_cluster.InventoryView()
    rt = p_cluster.RealtimeServer("peon0", view, device="cpu")
    assert rt.segment_replicatable is False and rt.device.type == "cpu"
    app = p_ingest.Appenderator("rt", SPECS(PORT), max_rows_per_hydrant=100)
    rt.attach(app)
    driver = p_ingest.StreamAppenderatorDriver(
        app, p_ingest.SegmentAllocator(md, "hour"), md)
    driver.add_batch(_batch(PORT, _records(500)))
    (sid,) = rt.served_segment_ids()
    assert rt.segment_count() == 1
    q = p_model.TimeseriesQuery.of("rt", [PORT.DAY], QSPECS(PORT))
    ap, served = rt.run_partials(q, [sid, "nope"])
    assert served == {sid} and len(ap.partials) == len(rt.segments())
    rows, served = rt.run_rows(p_model.TimeBoundaryQuery.of("rt", [PORT.DAY]),
                               [sid])
    assert served == {sid} and rows[0]["result"]["minTime"] == T0
    assert rt.load_segment(None) is False and rt.drop_segment(sid) is False
    rt.alive = False
    with pytest.raises(ConnectionError):
        rt.run_partials(q, [sid])
    assert rt.ping() is False


def test_supervisor_rolls_tasks_over_at_max_rows():
    """A task past max_rows_per_task finishes (publishes) and the next
    period starts a fresh one from the committed offsets."""
    def run(pk):
        md = pk.C.MetadataStore()
        stream = pk.I.SimulatedStream(n_partitions=1)
        stream.append(0, _records(300, seed=11))
        spec = pk.I.StreamSupervisorSpec(
            "stream_ds", SPECS(pk), dimensions=["page"], task_count=1,
            max_rows_per_task=250,
            tuning=pk.I.StreamTuningConfig(segment_granularity="day",
                                           max_records_per_poll=200))
        sup = pk.I.StreamSupervisor(spec, stream, md)
        trace = []
        for _ in range(3):
            sup.run_once()
            trace.append((sorted(t.task_id for t in sup.tasks.values()),
                          md.datasource_metadata("stream_ds")))
        return trace, sorted((t["id"], t["status"]) for t in md.tasks()), \
            _descs(md, "stream_ds")
    r, p = both(run)
    assert p[0] == r[0] and p[1] == r[1]
    assert [n for _, n in p[2]] == [n for _, n in r[2]]
