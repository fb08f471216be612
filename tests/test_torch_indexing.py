"""The port's indexing service (druid_tpu_torch/indexing/: task locks, the
task model, the overlord with its toolbox, autoscaling) against the
reference package's, on the CPU.

Each of the 18 cases of tests/test_indexing.py and the three autoscaling
cases of tests/test_scaling_receiver.py runs as a scenario through BOTH
packages with the same records (made from a seed with numpy). The wall
clock that mints lock and allocation versions is pinned (a counter clock
in both packages' `indexing/locks.py` and `cluster/metadata.py`, reset
before each package), so both packages mint the same versions and their
descriptors compare equal; task ids are given. The reference's assertions
hold in each, and each scenario's observations are equal, exactly: task
statuses, descriptors (load_spec paths relative to the deep storage's
directory), the pulled segments column for column and bit for bit, and
timeseries rows (counts and long sums). The segments the index task persists to a LocalDeepStorage
are the same bytes in both packages, part for part.
"""
import os
import shutil
import time as _time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster as r_cluster
import druid_tpu.cluster.metadata as r_metadata
import druid_tpu.indexing as r_indexing
import druid_tpu.indexing.locks as r_locks
import druid_tpu.indexing.task as r_task
import druid_tpu.ingest as r_ingest
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.filters as r_filters
import druid_tpu.query.model as r_model
import druid_tpu.storage.deep as r_deep
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster as p_cluster
import druid_tpu_torch.cluster.metadata as p_metadata
import druid_tpu_torch.indexing as p_indexing
import druid_tpu_torch.indexing.locks as p_locks
import druid_tpu_torch.indexing.task as p_task
import druid_tpu_torch.ingest as p_ingest
import druid_tpu_torch.query.aggregators as p_aggs
import druid_tpu_torch.query.filters as p_filters
import druid_tpu_torch.query.model as p_model
import druid_tpu_torch.storage.deep as p_deep
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.utils.intervals import Interval as PInterval

torch.set_num_threads(1)

T0 = RInterval.of("2026-04-01", "2026-04-08").start
DAY_MS = 86_400_000


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(
            name="ref", C=r_cluster, MD=r_metadata, I=r_indexing, T=r_task,
            L=r_locks, ingest=r_ingest, A=r_aggs, F=r_filters, M=r_model,
            deep=r_deep, Interval=RInterval,
            WEEK=RInterval.of("2026-04-01", "2026-04-08"),
            DAY=RInterval.of("2026-04-01", "2026-04-02"),
            executor=lambda segs: RefExecutor(segs),
            node=lambda name: r_cluster.DataNode(name),
            broker=lambda view: r_cluster.Broker(view))
    return SimpleNamespace(
        name="port", C=p_cluster, MD=p_metadata, I=p_indexing, T=p_task,
        L=p_locks, ingest=p_ingest, A=p_aggs, F=p_filters, M=p_model,
        deep=p_deep, Interval=PInterval,
        WEEK=PInterval.of("2026-04-01", "2026-04-08"),
        DAY=PInterval.of("2026-04-01", "2026-04-02"),
        executor=lambda segs: PortExecutor(segs, device="cpu"),
        node=lambda name: p_cluster.DataNode(name, device="cpu"),
        broker=lambda view: p_cluster.Broker(view, device="cpu"))


REF, PORT = _pkg(True), _pkg(False)


class _CounterClock:
    """A stand-in for the `time` module of the modules that mint versions:
    time() advances 1 ms a call from a fixed instant."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0

    def time(self):
        self.n += 1
        return 1_780_000_000.0 + self.n / 1000.0

    sleep = staticmethod(_time.sleep)
    monotonic = staticmethod(_time.monotonic)


@pytest.fixture
def clock(monkeypatch):
    c = _CounterClock()
    for mod in (r_locks, p_locks, r_metadata, p_metadata):
        monkeypatch.setattr(mod, "time", c)
    return c


@pytest.fixture
def both(clock, tmp_path):
    """both(fn) runs fn(pkg, dir) for each package (dir: a fresh directory
    of its own), the clock reset before each; asserts the observations
    equal (load_spec paths taken relative to dir) and returns both."""
    def run(fn):
        out = []
        for pk in (REF, PORT):
            clock.reset()
            d = tmp_path / pk.name
            d.mkdir()
            out.append(_rel(fn(pk, str(d)), str(d)))
        assert out[1] == out[0]
        return out
    return run


def _rel(x, base):
    if isinstance(x, str) and x.startswith(base):
        return "<dir>" + x[len(base):]
    if isinstance(x, dict):
        return {k: _rel(v, base) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_rel(v, base) for v in x)
    return x


def specs(pk):
    return [pk.A.CountAggregator("rows"), pk.A.LongSumAggregator("v",
                                                                 "value")]


def qspecs(pk):
    return [pk.A.LongSumAggregator("rows", "rows"),
            pk.A.LongSumAggregator("v", "v")]


def _records(n, days=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"timestamp": int(T0 + (i % days) * DAY_MS + i * 1000 % DAY_MS),
             "page": f"p{int(rng.integers(10))}",
             "value": int(rng.integers(0, 10))} for i in range(n)]


def _overlord(pk, deep=None, **kw):
    md = pk.MD.MetadataStore()
    return md, pk.I.Overlord(md, deep or pk.deep.InMemoryDeepStorage(), **kw)


def _descs(md, ds, used=True):
    got = md.used_segments(ds) if used else md.unused_segments(ds)
    return [d.to_json() for d in got]


def _status(st):
    return st.task_id, st.state, st.error


def _ts(pk, segs, ds, **kw):
    return pk.executor(segs).run(pk.M.TimeseriesQuery.of(ds, [pk.WEEK],
                                                         qspecs(pk), **kw))


def _index(pk, ds, recs, tid, **kw):
    kw.setdefault("segment_granularity", "day")
    return pk.T.IndexTask(ds, pk.ingest.InlineFirehose(recs), None,
                          specs(pk), task_id=tid, **kw)


def _pulled(segs):
    """The pulled segments as comparable data, column for column and bit
    for bit: id, time, dictionaries, ids and metric values with dtypes."""
    def col(a):
        a = np.ascontiguousarray(a)
        return str(a.dtype), a.tobytes()
    return [(str(s.id), s.n_rows, col(s.time_ms),
             {d: (list(c.dictionary.values), col(c.ids))
              for d, c in s.dims.items()},
             {m: (c.type.value, col(c.values))
              for m, c in s.metrics.items()}) for s in segs]


# ---------------------------------------------------------------------------
# tests/test_indexing.py
# ---------------------------------------------------------------------------

def test_index_task_end_to_end(both):
    recs = _records(3000, days=3)

    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            st = ov.run_task(_index(pk, "batch_ds", recs, "idx-1"))
            assert st.state == "SUCCESS", st.error
            descs = md.used_segments("batch_ds")
            assert len(descs) == 3
            assert all(d.version == descs[0].version for d in descs)
            segs = [ov.deep_storage.pull(d) for d in descs]
            rows = _ts(pk, segs, "batch_ds")
            assert rows[0]["result"]["rows"] == 3000
            assert rows[0]["result"]["v"] == sum(r["value"] for r in recs)
            return _status(st), _descs(md, "batch_ds"), _pulled(segs), \
                rows
        finally:
            ov.shutdown()
    both(run)


def test_parallel_index_on_overlord_pool_of_one(both):
    recs = _records(1200, days=2)

    def run(pk, _):
        md, ov = _overlord(pk, max_workers=1)
        try:
            task = pk.I.ParallelIndexTask(
                "pov_ds", pk.ingest.InlineFirehose(recs), None, specs(pk),
                segment_granularity="day", max_num_subtasks=3,
                task_id="par-1")
            st = ov.run_task(task, timeout=120)
            assert st.state == "SUCCESS", st.error
            segs = [ov.deep_storage.pull(d)
                    for d in md.used_segments("pov_ds")]
            rows = _ts(pk, segs, "pov_ds")
            assert rows[0]["result"]["rows"] == 1200
            # every sub-task's appended segment, whatever order the
            # sub-task threads allocated their partitions in
            parts = sorted((d["interval"], d["numRows"])
                           for d in _descs(md, "pov_ds"))
            return _status(st), parts, rows
        finally:
            ov.shutdown()
    both(run)


def test_index_task_partitions_large_buckets(both):
    recs = _records(2000, days=1)

    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            st = ov.run_task(_index(pk, "big_ds", recs, "big-1",
                                    tuning=pk.T.IndexTuningConfig(
                                        max_rows_per_segment=600)))
            assert st.state == "SUCCESS"
            descs = md.used_segments("big_ds")
            assert len(descs) >= 3
            assert sorted(d.partition for d in descs) == \
                list(range(len(descs)))
            segs = [ov.deep_storage.pull(d) for d in descs]
            rows = _ts(pk, segs, "big_ds")
            assert rows[0]["result"]["rows"] == 2000
            return _status(st), _descs(md, "big_ds"), _pulled(segs), \
                rows
        finally:
            ov.shutdown()
    both(run)


def test_index_replace_overshadows(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            ov.run_task(_index(pk, "r_ds", _records(500, days=1), "r-1"))
            v1 = md.used_segments("r_ds")[0].version
            ov.run_task(_index(pk, "r_ds", _records(200, days=1, seed=9),
                               "r-2"))
            assert len({d.version for d in md.used_segments("r_ds")}) == 2
            coord = pk.C.Coordinator(md, pk.C.InventoryView(),
                                     lambda d: None)
            stats = coord.run_once()
            assert stats.overshadowed_marked == 1
            remaining = md.used_segments("r_ds")
            assert len(remaining) == 1 and remaining[0].version != v1
            return v1, dict(vars(stats)), _descs(md, "r_ds"), \
                _descs(md, "r_ds", used=False)
        finally:
            ov.shutdown()
    both(run)


def test_compaction_task(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            for seed in (1, 2, 3):
                t = _index(pk, "c_ds", _records(300, days=1, seed=seed),
                           f"c-{seed}", appending=True)
                assert ov.run_task(t).state == "SUCCESS"
            assert len(md.used_segments("c_ds")) == 3
            before = _ts(pk, [ov.deep_storage.pull(d)
                              for d in md.used_segments("c_ds")], "c_ds")
            ct = pk.T.CompactionTask("c_ds", pk.DAY, qspecs(pk),
                                     task_id="compact-1")
            st = ov.run_task(ct)
            assert st.state == "SUCCESS"
            pk.C.Coordinator(md, pk.C.InventoryView(),
                             lambda d: None).run_once()
            descs = md.used_segments("c_ds")
            assert len(descs) == 1
            merged = ov.deep_storage.pull(descs[0])
            after = _ts(pk, [merged], "c_ds")
            assert after == before
            return _status(st), _descs(md, "c_ds"), \
                _pulled([merged]), after
        finally:
            ov.shutdown()
    both(run)


def test_kill_task(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            ov.run_task(_index(pk, "k_ds", _records(100, days=1), "k-1"))
            desc = md.used_segments("k_ds")[0]
            md.mark_unused([desc.id])
            st = ov.run_task(pk.T.KillTask("k_ds", pk.WEEK, task_id="kill"))
            assert st.state == "SUCCESS"
            assert md.used_segments("k_ds") == []
            assert ov.deep_storage.pull(desc) is None
            return _status(st), desc.to_json(), _descs(md, "k_ds", False)
        finally:
            ov.shutdown()
    both(run)


def test_archive_move_restore_lifecycle(both):
    def run(pk, base):
        md = pk.MD.MetadataStore()
        deep = pk.deep.LocalDeepStorage(os.path.join(base, "base"))
        ov = pk.I.Overlord(md, deep)
        out = []
        try:
            ov.run_task(_index(pk, "a_ds", _records(200, days=1), "a-1"))
            desc = md.used_segments("a_ds")[0]
            live_path = desc.load_spec["path"]
            n_rows = deep.pull(desc).n_rows
            st = ov.run_task(pk.T.ArchiveTask("a_ds", pk.WEEK, task_id="ar0"))
            assert st.state == "SUCCESS"
            assert md.used_segments("a_ds")[0].load_spec["path"] == live_path
            md.mark_unused([desc.id])
            out.append(_status(ov.run_task(
                pk.T.ArchiveTask("a_ds", pk.WEEK, task_id="ar1"))))
            archived = md.unused_segments("a_ds")[0]
            assert "base_archive" in archived.load_spec["path"]
            assert not os.path.isdir(live_path)
            assert os.path.isdir(archived.load_spec["path"])
            out.append(archived.to_json())
            cold = os.path.join(base, "cold")
            out.append(_status(ov.run_task(
                pk.T.MoveTask("a_ds", pk.WEEK, cold, task_id="mv"))))
            moved = md.unused_segments("a_ds")[0]
            assert moved.load_spec["path"].startswith(cold)
            out.append(moved.to_json())
            out.append(_status(ov.run_task(
                pk.T.RestoreTask("a_ds", pk.WEEK, task_id="rs"))))
            assert md.unused_segments("a_ds") == []
            restored = md.used_segments("a_ds")[0]
            assert restored.load_spec["path"] == live_path
            assert deep.pull(restored).n_rows == n_rows
            out.append(restored.to_json())
            return out
        finally:
            ov.shutdown()
    both(run)


def test_archive_crash_idempotent_rerun(both):
    def run(pk, base):
        md = pk.MD.MetadataStore()
        deep = pk.deep.LocalDeepStorage(os.path.join(base, "base"))
        ov = pk.I.Overlord(md, deep)
        try:
            ov.run_task(_index(pk, "c_ds", _records(100, days=1), "c-1"))
            desc = md.used_segments("c_ds")[0]
            md.mark_unused([desc.id])
            src = desc.load_spec["path"]
            dst = src.replace(os.path.join(base, "base"),
                              os.path.join(base, "base_archive"))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.move(src, dst)
            st = ov.run_task(pk.T.ArchiveTask("c_ds", pk.WEEK, task_id="ar"))
            assert st.state == "SUCCESS"
            healed = md.unused_segments("c_ds")[0]
            assert healed.load_spec["path"] == dst
            assert deep.pull(healed).n_rows == 100
            shutil.rmtree(dst)
            st2 = ov.run_task(pk.T.MoveTask(
                "c_ds", pk.WEEK, os.path.join(base, "cold"), task_id="mv"))
            assert st2.state == "FAILED" and "missing" in st2.error
            return _status(st), healed.to_json(), _status(st2)
        finally:
            ov.shutdown()
    both(run)


def test_task_json_roundtrip_move_archive_restore(both):
    def run(pk, _):
        out = []
        for t in (pk.T.MoveTask("ds", pk.WEEK, "cold", task_id="m"),
                  pk.T.ArchiveTask("ds", pk.WEEK, task_id="a"),
                  pk.T.RestoreTask("ds", pk.WEEK, task_id="r")):
            rt = pk.T.task_from_json(t.to_json())
            assert type(rt) is type(t)
            assert rt.id == t.id and rt.datasource == "ds"
            assert str(rt.interval) == str(pk.WEEK)
            out.append((type(rt).__name__, rt.to_json()))
        assert pk.T.task_from_json(pk.T.MoveTask(
            "ds", pk.WEEK, "cold").to_json()).target == "cold"
        return out
    both(run)


def test_lockbox_priority_revocation(both):
    def run(pk, _):
        lb = pk.I.TaskLockbox()
        day = pk.DAY
        low = lb.acquire("compact1", "ds", day, priority=25)
        assert low is not None
        assert lb.acquire("compact2", "ds", day, priority=25) is None
        high = lb.acquire("index1", "ds", day, priority=50)
        assert high is not None
        assert lb.is_revoked("compact1")
        out = [(low.version, low.priority), (high.version, high.priority),
               [(x.task_id, x.revoked) for x in lb.locks_for("compact1")]]
        lb.release_all("index1")
        lb.release_all("compact1")
        a = lb.acquire("t1", "ds", pk.Interval.of("2026-04-01",
                                                  "2026-04-02"))
        b = lb.acquire("t2", "ds", pk.Interval.of("2026-04-02",
                                                  "2026-04-03"))
        assert a is not None and b is not None
        out.append((a.version, b.version, a.lock_type.value))
        return out
    both(run)


def test_compaction_loses_lock_race_to_index(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            ov.run_task(_index(pk, "race_ds", _records(100, days=1), "r-1"))
            tb = ov.toolbox()
            ct = pk.T.CompactionTask("race_ds", pk.DAY, qspecs(pk),
                                     task_id="compact")
            lock = tb.lock(ct, [pk.DAY])
            assert lock is not None
            it = _index(pk, "race_ds", _records(50, days=1), "r-2")
            assert tb.lock(it, [pk.DAY]) is not None
            assert tb.lockbox.is_revoked(ct.id)
            assert not tb.publish(ct, [])
            return lock.version, tb.lockbox.is_revoked(ct.id)
        finally:
            ov.shutdown()
    both(run)


def test_local_deep_storage_round_trip(both):
    recs = _records(500, days=2)

    def run(pk, base):
        md, ov = _overlord(pk, pk.deep.LocalDeepStorage(base))
        try:
            st = ov.run_task(_index(pk, "disk_ds", recs, "disk-1"))
            assert st.state == "SUCCESS"
            descs = md.used_segments("disk_ds")
            assert all(d.load_spec["type"] == "local" for d in descs)
            assert all(d.size_bytes > 0 for d in descs)
            segs = [ov.deep_storage.pull(d) for d in descs]
            rows = _ts(pk, segs, "disk_ds")
            assert rows[0]["result"]["rows"] == 500
            return _status(st), _descs(md, "disk_ds"), _pulled(segs), \
                rows, _tree_bytes(base)
        finally:
            ov.shutdown()
    both(run)


def test_auto_compaction_scheduling(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            for seed in (1, 2):
                ov.run_task(_index(pk, "ac_ds", _records(200, days=2,
                                                         seed=seed),
                                   f"ac-{seed}", appending=True))
            coord = pk.C.Coordinator(md, pk.C.InventoryView(),
                                     lambda d: None)
            task_ids = coord.schedule_compaction(ov, "ac_ds", qspecs(pk),
                                                 max_tasks=2)
            assert len(task_ids) == 2
            for tid in task_ids:
                assert ov.await_task(tid).state == "SUCCESS"
            coord.run_once()
            descs = md.used_segments("ac_ds")
            assert len(descs) == 2
            rows = _ts(pk, [ov.deep_storage.pull(d) for d in descs],
                       "ac_ds")
            assert rows[0]["result"]["rows"] == 400
            # the task ids hold a random suffix; the two compactions run
            # at once, so which of them mints which version varies
            return [t.rsplit("_", 1)[0] for t in task_ids], \
                sorted((d["interval"], d["numRows"])
                       for d in _descs(md, "ac_ds")), rows
        finally:
            ov.shutdown()
    both(run)


def test_hash_partitioning_matches_shard_pruning(both):
    recs = _records(2000, days=1, seed=4)

    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            ov.run_task(_index(
                pk, "h_ds", recs, "h-1",
                tuning=pk.T.IndexTuningConfig(
                    max_rows_per_segment=500,
                    partition_dimensions=("page",))))
            descs = md.used_segments("h_ds")
            assert len(descs) >= 3
            for d in descs:
                seg = ov.deep_storage.pull(d)
                if seg.n_rows == 0:
                    continue
                col = seg.dims["page"]
                for vid in np.unique(col.ids):
                    v = col.dictionary.values[vid]
                    assert d.shard_spec.is_in_chunk({"page": v}), (d.id, v)
            view = pk.C.InventoryView()
            node = pk.node("n0")
            view.register(node)
            for d in descs:
                node.load_segment(ov.deep_storage.pull(d))
                view.announce("n0", d)
            broker = pk.broker(view)
            out = [_descs(md, "h_ds")]
            try:
                for page in ("p0", "p7"):
                    q = pk.M.TimeseriesQuery.of(
                        "h_ds", [pk.WEEK], qspecs(pk),
                        filter=pk.F.SelectorFilter("page", page))
                    got = broker.run(q)
                    want = sum(1 for r in recs if r["page"] == page)
                    assert got[0]["result"]["rows"] == want
                    out.append(got)
            finally:
                broker.stop()
            return out
        finally:
            ov.shutdown()
    both(run)


def test_compaction_skips_overshadowed_versions(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            ov.run_task(_index(pk, "ov_ds", _records(400, days=1), "o-1"))
            ov.run_task(_index(pk, "ov_ds", _records(100, days=1, seed=8),
                               "o-2"))
            assert len(md.used_segments("ov_ds")) == 2
            st = ov.run_task(pk.T.CompactionTask("ov_ds", pk.DAY,
                                                 qspecs(pk), task_id="co"))
            assert st.state == "SUCCESS"
            pk.C.Coordinator(md, pk.C.InventoryView(),
                             lambda d: None).run_once()
            descs = md.used_segments("ov_ds")
            assert len(descs) == 1
            rows = _ts(pk, [ov.deep_storage.pull(descs[0])], "ov_ds")
            assert rows[0]["result"]["rows"] == 100
            return _status(st), _descs(md, "ov_ds"), rows
        finally:
            ov.shutdown()
    both(run)


def test_streaming_publishes_to_deep_storage(both):
    def run(pk, _):
        md = pk.MD.MetadataStore()
        deep = pk.deep.InMemoryDeepStorage()
        stream = pk.ingest.SimulatedStream(n_partitions=1)
        stream.append(0, _records(150, days=1, seed=3))
        sup = pk.ingest.StreamSupervisor(
            pk.ingest.StreamSupervisorSpec(
                "s_ds", specs(pk), dimensions=["page"],
                tuning=pk.ingest.StreamTuningConfig(
                    segment_granularity="day")),
            stream, md, deep_storage=deep)
        sup.run_once()
        assert sup.checkpoint_all()
        descs = md.used_segments("s_ds")
        assert descs and all(d.load_spec is not None for d in descs)
        view = pk.C.InventoryView()
        view.register(pk.node("hist"))
        md.set_rules("_default", [{"type": "loadForever",
                                   "tieredReplicants": {"_default_tier": 1}}])
        coord = pk.C.Coordinator(md, view, deep.pull, pk.C.DynamicConfig(
            replication_throttle_limit=100))
        stats = coord.run_once()
        assert stats.assigned == len(descs) and stats.unassigned == 0
        broker = pk.broker(view)
        try:
            rows = broker.run(pk.M.TimeseriesQuery.of("s_ds", [pk.WEEK],
                                                      qspecs(pk)))
        finally:
            broker.stop()
        assert rows[0]["result"]["rows"] == 150
        return dict(vars(stats)), rows, len(descs)
    both(run)


def test_task_from_json(both):
    def run(pk, _):
        t = pk.T.task_from_json({
            "type": "index", "id": "j-1",
            "spec": {"dataSchema": {
                "dataSource": "j_ds",
                "metricsSpec": [{"type": "count", "name": "rows"}],
                "granularitySpec": {"segmentGranularity": "hour"}},
                "ioConfig": {"firehose": {
                    "type": "inline",
                    "data": [{"timestamp": T0, "d": "x"}]}}}})
        assert isinstance(t, pk.T.IndexTask)
        assert str(t.segment_granularity) == "hour"
        t2 = pk.T.task_from_json({"type": "kill", "dataSource": "x",
                                  "interval": str(pk.WEEK), "id": "k"})
        assert isinstance(t2, pk.T.KillTask)
        return t.to_json(), t2.to_json()
    both(run)


def test_kill_task_takes_interval_lock(both):
    def run(pk, _):
        md, ov = _overlord(pk)
        try:
            ov.run_task(_index(pk, "kl_ds", _records(50, days=1), "kl"))
            desc = md.used_segments("kl_ds")[0]
            md.mark_unused([desc.id])
            blocker = ov.lockbox.acquire("someone_else", "kl_ds", pk.WEEK,
                                         priority=99)
            assert blocker is not None
            st = ov.run_task(pk.T.KillTask("kl_ds", pk.WEEK, task_id="k1"))
            assert st.state == "FAILED" and "lock" in st.error
            ov.lockbox.release_all("someone_else")
            st2 = ov.run_task(pk.T.KillTask("kl_ds", pk.WEEK, task_id="k2"))
            assert st2.state == "SUCCESS"
            assert md.unused_segments("kl_ds") == []
            return _status(st), _status(st2), blocker.version
        finally:
            ov.shutdown()
    both(run)


# ---------------------------------------------------------------------------
# the index task's persisted bytes
# ---------------------------------------------------------------------------

def _tree_bytes(base):
    """Every file under base: relative path -> bytes."""
    out = {}
    for root, _, files in os.walk(base):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = fh.read()
    return out


V2_CASES = {
    "day": dict(days=3, n=3000, kw={}),
    "hour-none": dict(days=1, n=2500, kw={"segment_granularity": "hour",
                                          "query_granularity": "none"}),
    "partitioned": dict(days=1, n=1800, kw={"max_rows": 500}),
    "hash": dict(days=1, n=1800, kw={"max_rows": 500, "hash": ("page",)}),
    "no-rollup": dict(days=2, n=1000, kw={"rollup": False}),
    "appending": dict(days=2, n=1000, kw={"appending": True}),
}


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_index_task_v2_bytes_equal(both, case):
    """The same firehose through both packages' IndexTask, pushed to a
    LocalDeepStorage: equal descriptors and the same V2 bytes, file for
    file (smoosh parts and index.json)."""
    spec = V2_CASES[case]
    recs = _records(spec["n"], days=spec["days"], seed=len(case))

    def run(pk, base):
        kw = dict(spec["kw"])
        max_rows, hash_dims = kw.pop("max_rows", None), kw.pop("hash", ())
        if max_rows:
            kw["tuning"] = pk.T.IndexTuningConfig(
                max_rows_per_segment=max_rows, partition_dimensions=hash_dims)
        md, ov = _overlord(pk, pk.deep.LocalDeepStorage(base))
        try:
            st = ov.run_task(_index(pk, "v2_ds", recs, "v2-1", **kw))
            assert st.state == "SUCCESS", st.error
            return _descs(md, "v2_ds"), _tree_bytes(base)
        finally:
            ov.shutdown()
    descs, files = both(run)[1]
    assert descs and files
    assert any(f.endswith("index.json") for f in files) or \
        any("smoosh" in f for f in files)


# ---------------------------------------------------------------------------
# tests/test_scaling_receiver.py: autoscaling
# ---------------------------------------------------------------------------

def test_provision_on_pending_pressure(both):
    def run(pk, _):
        strat = pk.I.PendingTaskProvisioningStrategy(pk.I.ProvisioningConfig(
            max_workers=4, worker_capacity=2, scale_up_step=2))
        workers = [pk.I.WorkerInfo("w0", capacity=2, running_tasks=2)]
        d = strat.compute(pending_tasks=5, workers=workers, now=1000.0)
        assert d.provision == 2 and d.terminate == []
        idle = [pk.I.WorkerInfo("w0", capacity=2, running_tasks=0,
                                last_task_time=999.0)]
        d2 = strat.compute(pending_tasks=1, workers=idle, now=1000.0)
        assert d2.provision == 0 and d2.terminate == []
        return vars(d), vars(d2)
    both(run)


def test_terminate_idle_respects_min_and_cooldown(both):
    def run(pk, _):
        cfg = pk.I.ProvisioningConfig(min_workers=1, max_workers=4,
                                      idle_seconds_before_terminate=600.0)
        strat = pk.I.PendingTaskProvisioningStrategy(cfg)
        now = 10_000.0
        workers = [pk.I.WorkerInfo("w0", running_tasks=0,
                                   last_task_time=now - 700),
                   pk.I.WorkerInfo("w1", running_tasks=0,
                                   last_task_time=now - 800),
                   pk.I.WorkerInfo("w2", running_tasks=0,
                                   last_task_time=now - 10)]
        d = strat.compute(0, workers, now=now)
        assert set(d.terminate) == {"w0", "w1"}
        cfg.min_workers = 2
        d2 = strat.compute(0, workers, now=now)
        assert d2.terminate == ["w1"]
        return vars(d), vars(d2)
    both(run)


def test_scaling_monitor_applies_decisions(both):
    def run(pk, _):
        created, killed, workers = [], [], []
        strat = pk.I.PendingTaskProvisioningStrategy(pk.I.ProvisioningConfig(
            max_workers=2, worker_capacity=1, scale_up_step=2))
        mon = pk.I.ScalingMonitor(strat, pending=lambda: 3,
                                  workers=lambda: list(workers),
                                  provision=lambda n: created.append(n),
                                  terminate=lambda ids: killed.extend(ids))
        d = mon.run_once(now=0.0)
        assert created == [2] and d.provision == 2
        assert len(mon.history) == 1
        return created, killed, vars(d)
    both(run)
