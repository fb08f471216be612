"""The port's forking task runner (druid_tpu_torch/indexing/forking.py:
the overlord's task-action server, the peon subprocess
`python -m druid_tpu_torch.peon` and its remote toolbox) against the
reference package's, on the CPU.

Each of the 9 cases of tests/test_forking.py runs as a scenario through
BOTH packages' runners, side by side on two threads (a peon is a process
of its own, so the two packages' peons run at once). Each package's lock
and allocation versions come from a counter clock of its own in the
overlord process (`indexing/locks.py`, `cluster/metadata.py`), so both
mint the same versions; task ids are given. The reference's assertions
hold in each, and the observations are equal, exactly: statuses,
attempts, the actions each peon sent, descriptors (load_spec paths
relative to the deep storage's directory), the deep storage's bytes and
timeseries rows (counts and long sums). Every port peon reports, with its
status, that it had no CUDA context and had imported neither jax nor the
reference package.
"""
import os
import subprocess
import sys
import time as _time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster.metadata as r_metadata
import druid_tpu.indexing as r_indexing
import druid_tpu.indexing.locks as r_locks
import druid_tpu.indexing.task as r_task
import druid_tpu.ingest as r_ingest
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.model as r_model
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster.metadata as p_metadata
import druid_tpu_torch.indexing as p_indexing
import druid_tpu_torch.indexing.locks as p_locks
import druid_tpu_torch.indexing.task as p_task
import druid_tpu_torch.ingest as p_ingest
import druid_tpu_torch.query.aggregators as p_aggs
import druid_tpu_torch.query.model as p_model
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.utils.intervals import Interval as PInterval
from tests.test_torch_indexing import _CounterClock, _rel, _tree_bytes

torch.set_num_threads(1)

T0 = RInterval.of("2026-04-01", "2026-04-08").start
DAY_MS = 86_400_000
CLEAN_PEON = {"cudaInitialized": False, "importedJax": False,
              "importedReference": False}


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(
            name="ref", MD=r_metadata, I=r_indexing, T=r_task, L=r_locks,
            ingest=r_ingest, A=r_aggs, M=r_model,
            WEEK=RInterval.of("2026-04-01", "2026-04-08"),
            executor=lambda segs: RefExecutor(segs))
    return SimpleNamespace(
        name="port", MD=p_metadata, I=p_indexing, T=p_task, L=p_locks,
        ingest=p_ingest, A=p_aggs, M=p_model,
        WEEK=PInterval.of("2026-04-01", "2026-04-08"),
        executor=lambda segs: PortExecutor(segs, device="cpu"))


REF, PORT = _pkg(True), _pkg(False)


@pytest.fixture
def both(monkeypatch, tmp_path):
    """both(fn) runs fn(pkg, md, runner) for the two packages at once, each
    with a MetadataStore, a ForkingTaskRunner over a deep storage directory
    of its own and its own counter clock; asserts the observations equal
    (paths relative to the runner's deep storage) and returns the port's
    runner and observations."""
    runners = {}

    def setup(pk):
        c = _CounterClock()
        monkeypatch.setattr(pk.L, "time", c)
        monkeypatch.setattr(pk.MD, "time", c)
        md = pk.MD.MetadataStore()
        deep = str(tmp_path / pk.name / "deep")
        runners[pk.name] = (md, pk.I.ForkingTaskRunner(
            md, deep_storage_dir=deep), deep)

    def run(fn):
        for pk in (REF, PORT):
            setup(pk)

        def one(pk):
            md, r, deep = runners[pk.name]
            return _rel(fn(pk, md, r), deep)
        with ThreadPoolExecutor(2) as pool:
            r_out, p_out = pool.map(one, (REF, PORT))
        assert p_out == r_out
        return runners["port"][1], p_out

    yield run
    for _, r, _ in runners.values():
        r.shutdown()


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


def _index(pk, ds, recs, tid, **kw):
    kw.setdefault("segment_granularity", "day")
    return pk.T.IndexTask(ds, pk.ingest.InlineFirehose(recs), None,
                          specs(pk), task_id=tid, **kw)


def _ts(pk, r, md, ds):
    segs = [r.deep_storage.pull(d) for d in md.used_segments(ds)]
    return pk.executor(segs).run(pk.M.TimeseriesQuery.of(ds, [pk.WEEK],
                                                         qspecs(pk)))


def _actions(r, task_id):
    return [a["action"] for a in r.actions.actions if a["task"] == task_id]


def _peon_clean(r, task_ids):
    """Every port peon said it had no CUDA context and no jax/reference
    import (the reference's peons report nothing)."""
    reports = {t: r.actions.peon_report(t) for t in task_ids}
    assert all(rep == CLEAN_PEON for rep in reports.values()), reports


def test_task_json_roundtrip(both):
    recs = _records(10)

    def run(pk, md, r):
        task = pk.T.IndexTask("rt_ds", pk.ingest.InlineFirehose(recs), None,
                              specs(pk), dimensions=["page"],
                              segment_granularity="day",
                              query_granularity="hour", rollup=False,
                              task_id="rt-1")
        j = task.to_json()
        back = pk.T.task_from_json(j)
        assert back.id == task.id
        assert back.datasource == "rt_ds"
        assert back.dimensions == ["page"]
        assert back.query_granularity == "hour"
        assert back.rollup is False
        assert list(back.firehose.batches(100))[0] == recs
        return j, back.to_json()
    both(run)


def test_forked_index_task_end_to_end(both):
    recs = _records(3000, days=3)

    def run(pk, md, r):
        st = r.run_task(_index(pk, "fork_ds", recs, "fork-1"), timeout=120)
        assert st.state == "SUCCESS", st.error
        descs = md.used_segments("fork_ds")
        assert len(descs) == 3
        proc = r.processes["fork-1"]
        assert proc.pid != os.getpid() and proc.returncode == 0
        kinds = _actions(r, "fork-1")
        assert "lock" in kinds and "publish" in kinds
        rows = _ts(pk, r, md, "fork_ds")
        assert rows[0]["result"]["rows"] == 3000
        assert rows[0]["result"]["v"] == sum(x["value"] for x in recs)
        return st.state, kinds, [d.to_json() for d in descs], rows, \
            _tree_bytes(r.deep_storage_dir)
    r, _ = both(run)
    _peon_clean(r, ["fork-1"])
    assert r.processes["fork-1"].args[:3] == [sys.executable, "-m",
                                              "druid_tpu_torch.peon"]


def _kill_on(r, action, after=False, once=True):
    """Kill the task's peon as `action` arrives (or after it ran)."""
    state = {"killed": 0}
    orig = r.actions._do_action

    def hook(payload):
        if after:
            out = orig(payload)
        if payload["action"] == action and (not once or not state["killed"]):
            state["killed"] += 1
            proc = r.processes[payload["task"]]
            proc.kill()
            proc.wait()
        return out if after else orig(payload)

    r.actions._do_action = hook
    return state


def test_peon_killed_mid_task_reruns_to_success(both):
    recs = _records(2000, days=2)

    def run(pk, md, r):
        state = _kill_on(r, "lock")
        st = r.run_task(_index(pk, "kill_ds", recs, "kill-1"), timeout=120)
        assert st.state == "SUCCESS", st.error
        assert state["killed"] and r.attempts["kill-1"] == 2
        descs = md.used_segments("kill_ds")
        assert len(descs) == 2
        rows = _ts(pk, r, md, "kill_ds")
        assert rows[0]["result"]["rows"] == 2000
        return st.state, r.attempts["kill-1"], \
            [d.to_json() for d in descs], rows
    r, _ = both(run)
    _peon_clean(r, ["kill-1"])


def test_peon_killed_after_publish_does_not_duplicate(both):
    recs = _records(800, days=1)

    def run(pk, md, r):
        state = _kill_on(r, "publish", after=True)
        st = r.run_task(_index(pk, "dup_ds", recs, "dup-1", appending=True),
                        timeout=120)
        assert st.state == "SUCCESS", st.error
        assert state["killed"] and r.attempts["dup-1"] == 2
        rows = _ts(pk, r, md, "dup_ds")
        assert rows[0]["result"]["rows"] == 800
        return st.state, r.attempts["dup-1"], \
            [d.to_json() for d in md.used_segments("dup_ds")], rows
    r, _ = both(run)
    _peon_clean(r, ["dup-1"])


def test_peon_that_always_dies_reports_failure(both):
    def run(pk, md, r):
        _kill_on(r, "lock", once=False)
        task = pk.T.IndexTask("dead_ds",
                              pk.ingest.InlineFirehose(_records(500)),
                              None, specs(pk), task_id="dead-1")
        st = r.run_task(task, timeout=120)
        assert st.state == "FAILED"
        assert "died" in st.error
        assert md.used_segments("dead_ds") == []
        return st.state, st.error.split(" (exit")[0], r.attempts["dead-1"]
    both(run)


def test_parallel_index_fans_out_over_peons(both):
    recs = _records(4000, days=2)

    def run(pk, md, r):
        task = pk.I.ParallelIndexTask("par_ds",
                                      pk.ingest.InlineFirehose(recs), None,
                                      specs(pk), segment_granularity="day",
                                      max_num_subtasks=3, task_id="par-1")
        st = r.run_task(task, timeout=180)
        assert st.state == "SUCCESS", st.error
        sub_ids = sorted({a["task"] for a in r.actions.actions
                          if a["task"].startswith("par-1_sub")})
        assert len(sub_ids) == 3
        assert all(f"par-1_sub{i}" in r.processes for i in range(3))
        descs = md.used_segments("par_ds")
        assert len(descs) >= 2
        rows = _ts(pk, r, md, "par_ds")
        assert rows[0]["result"]["rows"] == 4000
        assert rows[0]["result"]["v"] == sum(x["value"] for x in recs)
        # the sub-tasks append in whatever order their peons reach the
        # allocator: their partitions, not their numbering, must agree
        parts = sorted((d.to_json()["interval"], d.num_rows) for d in descs)
        return st.state, sub_ids, parts, rows
    r, _ = both(run)
    _peon_clean(r, ["par-1"] + [f"par-1_sub{i}" for i in range(3)])


def test_task_log_captured(both):
    def run(pk, md, r):
        st = r.run_task(_index(pk, "log_ds", _records(100, days=1),
                               "log-1"), timeout=120)
        assert st.state == "SUCCESS"
        log = r.task_log("log-1")
        assert "attempt 1" in log
        return st.state, log.splitlines()[0]
    r, _ = both(run)
    # the port's peon logs its own account of the process with its status
    assert "peon log-1: SUCCESS" in r.task_log("log-1")
    assert '"cudaInitialized": false' in r.task_log("log-1")


def test_monitor_wait_is_bounded_and_escalates_on_shutdown(both):
    def run(pk, md, r):
        r.PROC_WAIT_POLL_S = 0.05
        r.PROC_KILL_GRACE_S = 2.0
        proc = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(600)"])
        try:
            r._shutdown = True
            t0 = _time.monotonic()
            r._await_proc(proc)
            elapsed = _time.monotonic() - t0
            assert elapsed < 5.0, f"_await_proc parked {elapsed:.1f}s"
            assert proc.poll() is not None
        finally:
            if proc.poll() is None:
                proc.kill()
        return proc.returncode
    both(run)


def test_forked_kill_task(both):
    recs = _records(400, days=1)

    def run(pk, md, r):
        st = r.run_task(_index(pk, "purge_ds", recs, "purge-1"),
                        timeout=120)
        assert st.state == "SUCCESS"
        ids = [d.id for d in md.used_segments("purge_ds")]
        md.mark_unused(ids)
        st2 = r.run_task(pk.T.KillTask("purge_ds", pk.WEEK,
                                       task_id="purge-2"), timeout=120)
        assert st2.state == "SUCCESS"
        assert md.unused_segments("purge_ds", pk.WEEK) == []
        return ids, st2.state, _actions(r, "purge-2"), \
            _tree_bytes(r.deep_storage_dir)
    r, _ = both(run)
    _peon_clean(r, ["purge-1", "purge-2"])
