"""The port's MetadataStore (druid_tpu_torch/cluster/metadata.py) against
the reference package's, on the CPU.

The MetadataStore cases of tests/test_cluster.py (publish with the
datasource-metadata CAS, unused segments and rules, the published set a
coordinator assigns from) and the store side of tests/test_loadqueue_sync.py
run on both stores: every call's answer must be equal (wall-clock fields
aside). The loading cases drive the port's LoadQueuePeon from the store's
used segments, as the coordinator's duty does (tests/test_torch_coordinator.py
runs the Coordinator itself against the reference's).
Then one sequence over the whole surface (leases and fencing, allocation,
pending segments, MVCC visibility, config, audit, tasks, supervisors) on
both stores, and the store on a file shared by two instances.
"""
import json
from types import SimpleNamespace

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster as r_cluster
import druid_tpu.cluster.metadata as r_metadata
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster as p_cluster
import druid_tpu_torch.cluster.metadata as p_metadata
from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
from druid_tpu_torch.cluster.shardspec import NumberedShardSpec
from druid_tpu_torch.storage.deep import InMemoryDeepStorage
from druid_tpu_torch.utils.intervals import Interval as PInterval
from tests.conftest import TEST_SCHEMA
from tests.test_torch_ingest import close
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, RInterval.of("2026-01-01", "2026-01-05"), datasource="test")
    return ref, [_carry(s) for s in ref]


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(C=r_cluster, MD=r_metadata,
                               Interval=RInterval)
    return SimpleNamespace(C=p_cluster, MD=p_metadata, Interval=PInterval)


REF, PORT = _pkg(True), _pkg(False)

_CLOCK_KEYS = {"created_ms", "createdMs", "updated_ms", "expiresMs",
               "created"}


def _norm(x):
    """Descriptors to JSON, wall-clock fields dropped, for comparing the
    two stores' answers."""
    if hasattr(x, "to_json") and hasattr(x, "shard_spec"):
        return x.to_json()
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k not in _CLOCK_KEYS}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, BaseException):
        return type(x).__name__
    return x


def test_metadata_publish_and_cas(segs):
    def run(pk, segments):
        md = pk.MD.MetadataStore()
        descs = [pk.C.descriptor_for(s) for s in segments]
        out = [md.publish_segments(descs[:2]),
               len(md.used_segments("test")),
               md.publish_segments([descs[2]],
                                   ("test", None, {"offset": 10})),
               md.datasource_metadata("test"),
               md.publish_segments([descs[3]], ("test", {"offset": 99},
                                                {"offset": 20})),
               md.datasource_metadata("test"),
               len(md.used_segments("test")),
               md.publish_segments([descs[3]], ("test", {"offset": 10},
                                                {"offset": 20})),
               len(md.used_segments("test")),
               md.used_segments("test")]
        return out
    r, p = run(REF, segs[0]), run(PORT, segs[1])
    assert p[:9] == [True, 2, True, {"offset": 10}, False, {"offset": 10},
                     3, True, 4]
    assert _norm(p) == _norm(r)


def test_metadata_unused_and_rules(segs):
    def run(pk, segments):
        md = pk.MD.MetadataStore()
        descs = [pk.C.descriptor_for(s) for s in segments]
        md.publish_segments(descs)
        out = [md.mark_unused([descs[0].id]),
               len(md.used_segments("test")),
               [d.id for d in md.unused_segments("test")]]
        md.set_rules("test", [{"type": "loadForever",
                               "tieredReplicants": {"_default_tier": 1}}])
        md.set_rules("_default", [{"type": "dropForever"}])
        out.append([r["type"] for r in md.rules_for("test")])
        md.audit("rules", "rules", "admin", "set rules", {"x": 1})
        out.append(md.audit_log("rules"))
        out.append(md.mark_used([descs[0].id]))
        out.append(len(md.used_segments("test")))
        return out
    r, p = run(REF, segs[0]), run(PORT, segs[1])
    assert p[0] == 1 and p[1] == 3 and p[3] == ["loadForever", "dropForever"]
    assert p[4][0]["author"] == "admin" and p[5] == 1 and p[6] == 4
    assert _norm(p) == _norm(r)


def _replicas(md, tier="_default_tier"):
    """The replica count the store's rules give (the coordinator's rule
    walk for loadForever, which is all these cases set)."""
    for rule in md.rules_for("test"):
        if rule["type"] == "loadForever":
            return rule["tieredReplicants"].get(tier, 0)
    return 0


def _assign_from_store(md, view, nodes, deep):
    """What the coordinator's load duty does with the store: every used
    segment onto as many nodes as its rules ask, through one
    LoadQueuePeon per node (round-robin). Returns the loads enqueued."""
    peons = [LoadQueuePeon(n, view, deep.pull) for n in nodes]
    enqueued = 0
    try:
        want = _replicas(md)
        for i, d in enumerate(sorted(md.used_segments("test"),
                                     key=lambda d: d.id)):
            holders = view.replica_set(d.id)
            have = len(holders.servers) if holders else 0
            for j in range(have, want):
                if peons[(i + j) % len(peons)].load(d):
                    enqueued += 1
        for p in peons:
            assert p.wait_idle(30.0)
        assert all(p.failures == [] for p in peons)
    finally:
        for p in peons:
            p.stop()
    return enqueued


def test_published_segments_load_through_peons_with_replicas(segs):
    """tests/test_cluster.py's coordinated fixture and
    test_loadqueue_sync.py's first case, on the port's store: the used
    segments load onto two nodes each (the loadForever rule's replicants),
    a second pass enqueues nothing, and the broker answers like the
    reference's executor."""
    ref, port = segs
    md = p_metadata.MetadataStore()
    deep = InMemoryDeepStorage()
    descs = [deep.push(s, p_cluster.descriptor_for(s)) for s in port]
    assert md.publish_segments(descs)
    md.set_rules("_default", [{"type": "loadForever",
                               "tieredReplicants": {"_default_tier": 2}}])
    view = p_cluster.InventoryView()
    nodes = [p_cluster.DataNode(f"n{i}", device="cpu") for i in range(3)]
    for n in nodes:
        view.register(n)
    assert _assign_from_store(md, view, nodes, deep) == 2 * len(port)
    for d in md.used_segments("test"):
        assert len(view.replica_set(d.id).servers) == 2
    assert _assign_from_store(md, view, nodes, deep) == 0
    q = {"queryType": "timeseries", "dataSource": "test",
         "intervals": [WEEK], "granularity": "all",
         "aggregations": [{"type": "count", "name": "rows"},
                          {"type": "longSum", "name": "ls",
                           "fieldName": "metLong"}]}
    broker = p_cluster.Broker(view, device="cpu")
    try:
        got = broker.run_json(q)
    finally:
        broker.stop()
    close(RefExecutor(ref).run_json(q), got)


def test_unused_segment_drops_from_view_and_queries(segs):
    """A segment marked unused in the store leaves the nodes and the view
    (the coordinator's drop duty, driven by hand), and the broker answers
    over the rest like the reference's executor over the same three."""
    ref, port = segs
    md = p_metadata.MetadataStore()
    deep = InMemoryDeepStorage()
    md.publish_segments([deep.push(s, p_cluster.descriptor_for(s))
                         for s in port])
    md.set_rules("_default", [{"type": "loadForever",
                               "tieredReplicants": {"_default_tier": 1}}])
    view = p_cluster.InventoryView()
    nodes = [p_cluster.DataNode(f"n{i}", device="cpu") for i in range(2)]
    for n in nodes:
        view.register(n)
    _assign_from_store(md, view, nodes, deep)
    victim = sorted(d.id for d in md.used_segments("test"))[0]
    assert md.mark_unused([victim]) == 1
    used = {d.id for d in md.used_segments("test")}
    for n in nodes:
        for sid in list(n.served_segment_ids()):
            if sid not in used:
                assert n.drop_segment(sid)
                view.unannounce(n.name, sid)
    assert view.replica_set(victim) is None
    q = {"queryType": "timeseries", "dataSource": "test",
         "intervals": [WEEK], "granularity": "day",
         "aggregations": [{"type": "count", "name": "rows"}]}
    broker = p_cluster.Broker(view, device="cpu")
    try:
        got = broker.run_json(q)
    finally:
        broker.stop()
    keep = [s for s in ref if str(s.id) != victim]
    close(RefExecutor(keep).run_json(q), got)


def test_descriptors_keep_real_shard_specs_through_the_store():
    """test_loadqueue_sync.py's shard-spec case, on the store: a published
    NumberedShardSpec(p, n) comes back with its partition count, in both
    packages."""
    def run(pk):
        md = pk.MD.MetadataStore()
        iv = pk.Interval.of("2026-01-01", "2026-01-02")
        spec = (r_cluster.NumberedShardSpec if pk is REF
                else NumberedShardSpec)
        md.publish_segments([pk.MD.SegmentDescriptor(
            "test", iv, "v1", p, spec(p, 3), 100 + p, 10 * p,
            {"type": "local", "path": f"/x/{p}"}) for p in range(3)])
        return [d.to_json() for d in sorted(md.used_segments("test"),
                                            key=lambda d: d.partition)]
    r, p = run(REF), run(PORT)
    assert p == r
    assert [d["shardSpec"]["partitions"] for d in p] == [3, 3, 3]


def _surface_sequence(pk):
    """One walk over the store's whole surface; every answer recorded."""
    MD = pk.MD
    md = MD.MetadataStore()
    iv = pk.Interval.of
    out = []

    def rec(name, fn):
        try:
            out.append((name, fn()))
        except Exception as e:     # the refusal's type is the answer
            out.append((name, e))

    # leases and fencing
    rec("acquire a", lambda: md.try_acquire_lease("coord", "a", 1000, 500))
    rec("acquire b live", lambda: md.try_acquire_lease("coord", "b", 1200,
                                                        500))
    rec("renew a", lambda: md.try_acquire_lease("coord", "a", 1300, 500,
                                                {"url": "http://a"}))
    rec("takeover b", lambda: md.try_acquire_lease("coord", "b", 2000, 500))
    rec("read", lambda: md.read_lease("coord"))
    d1 = MD.SegmentDescriptor("ds", iv("2026-01-01", "2026-01-02"), "v1", 0)
    rec("fenced stale", lambda: md.publish_segments(
        [d1], fence=("coord", 1, "a")))
    rec("fenced ok", lambda: md.publish_segments(
        [d1], fence=("coord", 2, "b")))
    rec("fence log", lambda: md.fence_log("coord"))
    rec("release wrong", lambda: md.release_lease("coord", "a"))
    rec("release", lambda: md.release_lease("coord", "b"))
    rec("reacquire", lambda: md.try_acquire_lease("coord", "a", 2100, 500))
    # allocation and pending segments
    rec("alloc day", lambda: md.allocate_segment(
        "ds", iv("2026-01-01", "2026-01-02"), None))
    rec("alloc hour in day", lambda: md.allocate_segment(
        "ds", iv("2026-01-01T01", "2026-01-01T02"), None))
    rec("alloc new", lambda: md.allocate_segment(
        "ds2", iv("2026-01-03", "2026-01-04"), "v9"))
    rec("alloc again", lambda: md.allocate_segment(
        "ds2", iv("2026-01-03", "2026-01-04"), "v9"))
    rec("max version", lambda: md.max_version(
        "ds", iv("2026-01-01", "2026-01-03")))
    rec("max partition", lambda: md.max_partition(
        "ds", iv("2026-01-01", "2026-01-02"), "v1"))
    rec("kill pending", lambda: md.kill_pending_segments("ds2"))
    # MVCC visibility: v2 overshadows v1 on the same day
    d2 = MD.SegmentDescriptor("ds", iv("2026-01-01", "2026-01-02"), "v2", 0)
    d3 = MD.SegmentDescriptor("ds", iv("2026-01-02", "2026-01-03"), "v1", 0)
    rec("publish v2", lambda: md.publish_segments([d2, d3]))
    rec("visible", lambda: md.visible_segments("ds"))
    rec("visible day2", lambda: md.visible_segments(
        "ds", iv("2026-01-02", "2026-01-03")))
    rec("used", lambda: sorted(d.id for d in md.used_segments()))
    rec("datasources", md.datasources)
    rec("update payload", lambda: md.update_segment_payload(
        MD.SegmentDescriptor("ds", d3.interval, "v1", 0, None, 7, 70,
                             {"type": "local", "path": "/p"})))
    rec("after update", lambda: md.used_segments("ds"))
    rec("unused", lambda: md.mark_unused([d1.id]))
    rec("unused list", lambda: md.unused_segments(
        "ds", iv("2026-01-01", "2026-01-02")))
    rec("delete", lambda: md.delete_segments([d1.id]))
    rec("reset", lambda: md.reset_datasource_metadata("ds"))
    rec("ds meta", lambda: md.datasource_metadata("ds"))
    # config, audit, tasks, supervisors
    rec("config", lambda: (md.set_config("coordinator.config",
                                         {"maxSegmentsToMove": 5}),
                           md.get_config("coordinator.config"),
                           md.get_config("missing", {"d": 1})))
    rec("audit", lambda: (md.audit("k", "t", "me", "why", {"p": 1}),
                          md.audit_log("k"), md.audit_log()))
    rec("tasks", lambda: (md.insert_task("t1", "ds", "RUNNING", {"g": 0}),
                          md.insert_task("t2", "ds", "RUNNING"),
                          md.update_task_status("t1", "SUCCESS"),
                          md.task("t1"), md.task("nope"),
                          md.tasks("RUNNING"), len(md.tasks())))
    rec("supervisors", lambda: (md.set_supervisor("ds", {"taskCount": 2}),
                                md.set_supervisor("ds", {"taskCount": 3}),
                                md.supervisors()))
    return out


def test_store_surface_equals_reference():
    """Leases and fencing, allocation and its refusal, pending segments,
    MVCC visibility, payload updates, unused and deleted segments, config,
    audit, tasks and supervisors: each call answers as the reference's
    store does."""
    r, p = _surface_sequence(REF), _surface_sequence(PORT)
    assert [n for n, _ in p] == [n for n, _ in r]
    for (name, a), (_, b) in zip(r, p):
        assert _norm(b) == _norm(a), name
    answers = dict(p)
    assert isinstance(answers["fenced stale"], p_metadata.StaleTermError)
    assert isinstance(answers["alloc hour in day"],
                      p_metadata.SegmentAllocationError)
    assert [d.version for d in answers["visible"]] == ["v2", "v1"]


def test_file_store_shared_by_two_instances(tmp_path):
    """A file-backed store is one truth for two instances (two processes'
    connections): a publish through one is read by the other, and the
    datasource CAS rejects the second writer."""
    path = str(tmp_path / "md.sqlite")
    a, b = p_metadata.MetadataStore(path), p_metadata.MetadataStore(path)
    iv = PInterval.of("2026-01-01", "2026-01-02")
    d = p_metadata.SegmentDescriptor("ds", iv, "v1", 0)
    assert a.publish_segments([d], ("ds", None, {"partitions": {"0": 5}}))
    assert [x.id for x in b.used_segments("ds")] == [d.id]
    assert not b.publish_segments(
        [p_metadata.SegmentDescriptor("ds", iv, "v1", 1)],
        ("ds", None, {"partitions": {"0": 5}}))
    assert b.datasource_metadata("ds") == {"partitions": {"0": 5}}
    assert json.dumps(a.datasource_metadata("ds")) == \
        json.dumps(b.datasource_metadata("ds"))
