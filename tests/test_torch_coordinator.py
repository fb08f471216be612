"""The port's Coordinator (druid_tpu_torch/cluster/coordinator.py) against
the reference package's, on the CPU.

The coordinator cases of tests/test_cluster.py (from its Coordinator
section on) and every case of tests/test_loadqueue_sync.py run as a
scenario through BOTH packages: the same four segments (the reference's
TEST_SCHEMA, seed 42, carried to the port as plain arrays), the same
metadata, rules and nodes, and a fixed `now_ms` where a rule reads the
clock. The reference's assertions hold in each, and each scenario's
observations are equal between the two, exactly: every cycle's
CoordinatorStats, the node -> segment id sets after it, and the broker's
rows afterwards (counts and long sums, bit for bit). The asynchronous
cases compare their converged state, not the timing of the workers.
"""
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster as r_cluster
import druid_tpu.cluster.coordinator as r_coordinator
import druid_tpu.cluster.metadata as r_metadata
import druid_tpu.cluster.shardspec as r_shardspec
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.model as r_model
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster as p_cluster
import druid_tpu_torch.cluster.coordinator as p_coordinator
import druid_tpu_torch.cluster.metadata as p_metadata
import druid_tpu_torch.cluster.shardspec as p_shardspec
import druid_tpu_torch.query.aggregators as p_aggs
import druid_tpu_torch.query.model as p_model
from druid_tpu_torch.utils.intervals import Interval as PInterval
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

NOW = 1_780_000_000_000          # 2026-05-28: after every segment's day
IV = ("2026-01-01", "2026-01-05")


@pytest.fixture(scope="module")
def segs():
    gen = DataGenerator(TEST_SCHEMA, seed=42)
    ref = gen.segments(4, 5_000, RInterval.of(*IV), datasource="test")
    v2 = gen.segment(1000, ref[0].id.interval, datasource="test",
                     version="v2")
    return SimpleNamespace(ref=ref, port=[_carry(s) for s in ref],
                           ref_v2=v2, port_v2=_carry(v2))


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(
            name="ref", C=r_cluster, CO=r_coordinator, MD=r_metadata,
            SS=r_shardspec, A=r_aggs, M=r_model,
            WEEK=RInterval.of("2026-01-01", "2026-01-08"),
            node=lambda name, **kw: r_cluster.DataNode(name, **kw),
            broker=lambda view, **kw: r_cluster.Broker(view, **kw))
    return SimpleNamespace(
        name="port", C=p_cluster, CO=p_coordinator, MD=p_metadata,
        SS=p_shardspec, A=p_aggs, M=p_model,
        WEEK=PInterval.of("2026-01-01", "2026-01-08"),
        node=lambda name, **kw: p_cluster.DataNode(name, device="cpu", **kw),
        broker=lambda view, **kw: p_cluster.Broker(view, device="cpu", **kw))


REF, PORT = _pkg(True), _pkg(False)


def both(segs, fn):
    """fn(pkg, segments, v2) for each package; asserts the observations
    are equal and returns the port's."""
    r = fn(REF, segs.ref, segs.ref_v2)
    p = fn(PORT, segs.port, segs.port_v2)
    assert p == r
    return p


def stats_of(stats):
    return dict(vars(stats))


def holdings(view, nodes):
    """node name -> the sorted ids of the segments the view has it
    serving."""
    return {n.name: sorted(d.id for d in view.served_segments(n.name))
            for n in nodes}


def rows(pk, view):
    broker = pk.broker(view)
    try:
        q = pk.M.TimeseriesQuery.of(
            "test", [pk.WEEK], [pk.A.CountAggregator("rows"),
                                pk.A.LongSumAggregator("ls", "metLong")])
        return broker.run(q)
    finally:
        broker.stop()


def ref_rows(segments):
    q = r_model.TimeseriesQuery.of(
        "test", [RInterval.of("2026-01-01", "2026-01-08")],
        [r_aggs.CountAggregator("rows"),
         r_aggs.LongSumAggregator("ls", "metLong")])
    return RefExecutor(segments).run(q)


def coordinated(pk, segments):
    md = pk.MD.MetadataStore()
    view = pk.C.InventoryView()
    nodes = [pk.node(f"node{i}") for i in range(3)]
    for n in nodes:
        view.register(n)
    by_id = {pk.C.descriptor_for(s).id: s for s in segments}
    md.publish_segments([pk.C.descriptor_for(s) for s in segments])
    coord = pk.C.Coordinator(md, view, lambda d: by_id.get(d.id),
                             pk.C.DynamicConfig(
                                 max_segments_to_move=10,
                                 replication_throttle_limit=100))
    return md, view, nodes, coord


# ---------------------------------------------------------------------------
# tests/test_cluster.py: the Coordinator cases
# ---------------------------------------------------------------------------

def test_coordinator_assigns_replicas(segs):
    def run(pk, segments, _):
        md, view, nodes, coord = coordinated(pk, segments)
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 2}}])
        stats = coord.run_once(now_ms=NOW)
        assert stats.assigned == 2 * len(segments)
        for s in segments:
            rs = view.replica_set(pk.C.descriptor_for(s).id)
            assert rs is not None and len(rs.servers) == 2
        stats2 = coord.run_once(now_ms=NOW)
        assert stats2.assigned == 0
        return stats_of(stats), stats_of(stats2), holdings(view, nodes), \
            rows(pk, view)
    out = both(segs, run)
    assert out[-1] == ref_rows(segs.ref)


def test_coordinator_queries_after_assignment(segs):
    def run(pk, segments, _):
        md, view, nodes, coord = coordinated(pk, segments)
        stats = coord.run_once(now_ms=NOW)
        return stats_of(stats), holdings(view, nodes), rows(pk, view)
    assert both(segs, run)[-1] == ref_rows(segs.ref)


def test_coordinator_drop_rule(segs):
    def run(pk, segments, _):
        md, view, nodes, coord = coordinated(pk, segments)
        first = coord.run_once(now_ms=NOW)
        md.set_rules("_default", [{"type": "dropByPeriod", "periodMs": 1}])
        stats = coord.run_once(now_ms=int(4e12))
        assert stats.dropped > 0
        assert all(n.segment_count() == 0 for n in nodes)
        return stats_of(first), stats_of(stats), holdings(view, nodes)
    both(segs, run)


def test_coordinator_overshadow_cleanup(segs):
    def run(pk, segments, v2):
        md, view, nodes, coord = coordinated(pk, segments)
        s0 = segments[0]
        d_v2 = pk.C.descriptor_for(v2)
        md.publish_segments([d_v2])
        coord.segment_source = (lambda orig: lambda d:
                                v2 if d.id == d_v2.id else orig(d)
                                )(coord.segment_source)
        stats = coord.run_once(now_ms=NOW)
        assert stats.overshadowed_marked == 1
        used_ids = {d.id for d in md.used_segments("test")}
        assert pk.C.descriptor_for(s0).id not in used_ids
        assert d_v2.id in used_ids
        killed = coord.kill_unused("test")
        assert killed == 1
        return stats_of(stats), sorted(used_ids), killed, \
            holdings(view, nodes), rows(pk, view)
    out = both(segs, run)
    assert out[-1] == ref_rows([segs.ref_v2] + segs.ref[1:])


def test_liveness_failure_triggers_rereplication(segs):
    def run(pk, segments, _):
        md, view, nodes, coord = coordinated(pk, segments)
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 2}}])
        first = coord.run_once(now_ms=NOW)
        sid = pk.C.descriptor_for(segments[0]).id
        victim_name = sorted(view.replica_set(sid).servers)[0]
        view.node(victim_name).alive = False
        during = rows(pk, view)
        stats = coord.run_once(now_ms=NOW)
        assert stats.nodes_removed == 1
        assert view.node(victim_name) is None
        for s in segments:
            rs = view.replica_set(pk.C.descriptor_for(s).id)
            assert rs is not None and len(rs.servers) == 2
            assert victim_name not in rs.servers
        live = [n for n in nodes if n.name != victim_name]
        return stats_of(first), victim_name, during, stats_of(stats), \
            holdings(view, live), rows(pk, view)
    out = both(segs, run)
    assert out[2] == out[-1] == ref_rows(segs.ref)


def test_coordinator_balances(segs):
    def run(pk, segments, _):
        md = pk.MD.MetadataStore()
        view = pk.C.InventoryView()
        nodes = [pk.node("a"), pk.node("b")]
        for n in nodes:
            view.register(n)
        by_id = {pk.C.descriptor_for(s).id: s for s in segments}
        md.publish_segments([pk.C.descriptor_for(s) for s in segments])
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 1}}])
        for s in segments:
            nodes[0].load_segment(s)
            view.announce("a", pk.C.descriptor_for(s))
        coord = pk.C.Coordinator(md, view, lambda d: by_id.get(d.id),
                                 pk.C.DynamicConfig(max_segments_to_move=10))
        stats = coord.run_once(now_ms=NOW)
        assert stats.moved >= 1
        assert abs(nodes[0].segment_count() - nodes[1].segment_count()) <= 1
        return stats_of(stats), holdings(view, nodes), rows(pk, view)
    assert both(segs, run)[-1] == ref_rows(segs.ref)


@pytest.mark.parametrize("rule", [
    {"type": "loadByPeriod", "periodMs": 200 * 86_400_000,
     "tieredReplicants": {"_default_tier": 1}},
    {"type": "loadByPeriod", "periodMs": 100 * 86_400_000,
     "tieredReplicants": {"_default_tier": 3}},
    {"type": "loadByInterval", "interval": "2026-01-02/2026-01-04",
     "tieredReplicants": {"_default_tier": 2}},
    {"type": "dropByInterval", "interval": "2026-01-01/2026-01-03"},
    {"type": "dropForever"}],
    ids=["period-200d", "period-100d", "interval", "drop-interval", "drop"])
def test_rule_chains_and_placement_cost(segs, rule):
    """Each rule type ahead of a loadForever fallback, with a fixed now:
    the same stats and the same placement (placement_cost picks the node)
    in both packages; the placement costs themselves equal."""
    def run(pk, segments, _):
        md, view, nodes, coord = coordinated(pk, segments)
        md.set_rules("_default", [
            rule, {"type": "loadForever",
                   "tieredReplicants": {"_default_tier": 1}}])
        out = [stats_of(coord.run_once(now_ms=NOW)), holdings(view, nodes)]
        descs = [pk.C.descriptor_for(s) for s in segments]
        out.append([pk.CO.placement_cost(d, descs[:i] + descs[i + 1:])
                    for i, d in enumerate(descs)])
        out.append(type(pk.CO.rule_from_json(rule)).__name__)
        out.append(stats_of(coord.run_once(now_ms=NOW)))
        return out
    both(segs, run)


# ---------------------------------------------------------------------------
# tests/test_loadqueue_sync.py
# ---------------------------------------------------------------------------

def test_async_loading_assigns_through_peons(segs):
    def run(pk, segments, _):
        md = pk.MD.MetadataStore()
        view = pk.C.InventoryView()
        nodes = [pk.node(f"n{i}") for i in range(2)]
        for n in nodes:
            view.register(n)
        by_id = {pk.C.descriptor_for(s).id: s for s in segments}
        md.publish_segments([pk.C.descriptor_for(s) for s in segments])
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 2}}])
        coord = pk.C.Coordinator(md, view, lambda d: by_id.get(d.id),
                                 pk.C.DynamicConfig(
                                     replication_throttle_limit=100),
                                 async_loading=True)
        try:
            stats = coord.run_once(now_ms=NOW)
            assert stats.assigned == 2 * len(segments)
            assert coord.wait_loads(30.0)
            for s in segments:
                rs = view.replica_set(pk.C.descriptor_for(s).id)
                assert rs is not None and len(rs.servers) == 2
            stats2 = coord.run_once(now_ms=NOW)
            assert stats2.assigned == 0
            got = rows(pk, view)
            assert got[0]["result"]["rows"] == sum(s.n_rows
                                                   for s in segments)
        finally:
            coord.stop()
        return stats_of(stats), stats_of(stats2), holdings(view, nodes), got
    both(segs, run)


def test_async_loading_pending_counts_as_holder(segs):
    def run(pk, segments, _):
        md = pk.MD.MetadataStore()
        view = pk.C.InventoryView()
        nodes = [pk.node(f"n{i}") for i in range(3)]
        for n in nodes:
            view.register(n)
        by_id = {pk.C.descriptor_for(s).id: s for s in segments}
        md.publish_segments([pk.C.descriptor_for(s) for s in segments])
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 1}}])

        def slow_source(d):
            time.sleep(0.2)
            return by_id.get(d.id)

        coord = pk.C.Coordinator(md, view, slow_source, async_loading=True)
        try:
            first = coord.run_once(now_ms=NOW)
            coord.run_once(now_ms=NOW)
            assert coord.wait_loads(30.0)
            for s in segments:
                rs = view.replica_set(pk.C.descriptor_for(s).id)
                assert rs is not None and len(rs.servers) == 1, rs.servers
        finally:
            coord.stop()
        return stats_of(first), holdings(view, nodes)
    both(segs, run)


def test_load_queue_bound_defers(segs):
    def run(pk, segments, _):
        md = pk.MD.MetadataStore()
        view = pk.C.InventoryView()
        node = pk.node("n0")
        view.register(node)
        by_id = {pk.C.descriptor_for(s).id: s for s in segments}
        md.publish_segments([pk.C.descriptor_for(s) for s in segments])
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 1}}])
        gate = threading.Event()

        def gated_source(d):
            gate.wait(10.0)
            return by_id.get(d.id)

        coord = pk.C.Coordinator(
            md, view, gated_source,
            pk.C.DynamicConfig(max_segments_in_node_loading_queue=1),
            async_loading=True)
        try:
            stats = coord.run_once(now_ms=NOW)
            assert 0 < stats.assigned <= 2
            assert stats.unassigned >= len(segments) - 2
            gate.set()
            assert coord.wait_loads(30.0)
            for _ in range(len(segments)):
                coord.run_once(now_ms=NOW)
                coord.wait_loads(30.0)
            assert sum(1 for s in segments if view.replica_set(
                pk.C.descriptor_for(s).id)) == len(segments)
        finally:
            coord.stop()
        return holdings(view, [node]), rows(pk, view)
    both(segs, run)


def test_async_balance_never_leaves_zero_replicas(segs):
    def run(pk, segments, _):
        md = pk.MD.MetadataStore()
        view = pk.C.InventoryView()
        a, b = pk.node("a"), pk.node("b")
        view.register(a)
        view.register(b)
        by_id = {pk.C.descriptor_for(s).id: s for s in segments}
        md.publish_segments([pk.C.descriptor_for(s) for s in segments])
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 1}}])
        for s in segments:
            a.load_segment(s)
            view.announce("a", pk.C.descriptor_for(s))
        gate = threading.Event()
        violations = []

        def gated_source(d):
            rs = view.replica_set(d.id)
            if rs is None or not rs.servers:
                violations.append(d.id)
            gate.wait(10.0)
            return by_id.get(d.id)

        coord = pk.C.Coordinator(md, view, gated_source,
                                 pk.C.DynamicConfig(max_segments_to_move=10),
                                 async_loading=True)
        try:
            stats = coord.run_once(now_ms=NOW)
            gate.set()
            assert coord.wait_loads(30.0)
            assert violations == []
            for s in segments:
                rs = view.replica_set(pk.C.descriptor_for(s).id)
                assert rs is not None and len(rs.servers) == 1
            assert abs(a.segment_count() - b.segment_count()) <= 1
        finally:
            coord.stop()
        return stats_of(stats), holdings(view, [a, b]), rows(pk, view)
    both(segs, run)


def test_status_descriptors_keep_real_shard_specs(segs):
    def run(pk, segments, _):
        s = segments[0]
        d = pk.MD.SegmentDescriptor(s.id.datasource, s.id.interval,
                                    s.id.version, 0,
                                    pk.SS.NumberedShardSpec(0, 2))
        node = pk.node("n0")
        node.load_segment(s, d)
        srv = pk.C.DataNodeServer(node).start()
        try:
            client = pk.C.RemoteDataNodeClient("n0", srv.url)
            descs = client.served_descriptors()
            assert len(descs) == 1
            spec = descs[0].shard_spec
            assert isinstance(spec, pk.SS.NumberedShardSpec)
            assert spec.partitions == 2
        finally:
            srv.stop()
        return [x.to_json() for x in descs]
    both(segs, run)


def test_sync_blip_does_not_mass_unannounce(segs):
    def run(pk, segments, _):
        node = pk.node("r0")
        for s in segments:
            node.load_segment(s)
        srv = pk.C.DataNodeServer(node).start()
        client = pk.C.RemoteDataNodeClient("r0", srv.url,
                                           connect_timeout=0.5)
        view = pk.C.InventoryView()
        view.register(client)
        first = view.sync_all()
        assert len(view.served_segments("r0")) == len(segments)
        srv.stop()
        added, removed = view.sync_all()
        assert removed == 0
        assert len(view.served_segments("r0")) == len(segments)
        return first, (added, removed), \
            sorted(d.id for d in view.served_segments("r0"))
    both(segs, run)


def test_inventory_sync_loop_over_http(segs):
    def run(pk, segments, _):
        node = pk.node("remote0")
        for s in segments:
            node.load_segment(s)
        srv = pk.C.DataNodeServer(node).start()
        out = []
        try:
            client = pk.C.RemoteDataNodeClient("remote0", srv.url)
            view = pk.C.InventoryView()
            view.register(client)
            added, removed = view.sync_all()
            assert added == len(segments) and removed == 0
            out.append(rows(pk, view))
            assert out[-1][0]["result"]["rows"] == sum(s.n_rows
                                                       for s in segments)
            dropped = segments[0]
            node.drop_segment(str(dropped.id))
            added, removed = view.sync_all()
            assert removed == 1
            out.append(rows(pk, view))
            want = sum(s.n_rows for s in segments) - dropped.n_rows
            assert out[-1][0]["result"]["rows"] == want
        finally:
            srv.stop()
        return out
    both(segs, run)
