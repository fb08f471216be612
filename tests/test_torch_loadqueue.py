"""The port's per-server load queue (druid_tpu_torch/cluster/loadqueue.py)
over deep storage: loads pull from deep storage, load into the node and
announce in the view (queries then serve them, equal to the reference's
rows); drops unannounce; the queue bound defers, a pending id refuses a
second request; failures (a corrupt directory, a missing segment, a drop
of what is not loaded, a node that left the view) are recorded and the
worker goes on; completion callbacks fire before wait_idle returns."""
import os
import threading
import time

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine.executor import QueryExecutor as RefExecutor
from druid_tpu.query.model import query_from_json as ref_query
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                     descriptor_for)
from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
from druid_tpu_torch.storage.deep import InMemoryDeepStorage, LocalDeepStorage
from druid_tpu_torch.storage.format_v2 import LazyStringDimColumn
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

Q = {"queryType": "timeseries", "dataSource": "test",
     "intervals": ["2026-01-01/2026-01-05"], "granularity": "day",
     "aggregations": [{"type": "count", "name": "rows"},
                      {"type": "longSum", "name": "ls",
                       "fieldName": "metLong"}]}


@pytest.fixture(scope="module")
def ref_segments():
    return DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"), datasource="test")


@pytest.fixture(scope="module")
def pushed(ref_segments, tmp_path_factory):
    """The four segments pushed to a LocalDeepStorage (format V2)."""
    deep = LocalDeepStorage(str(tmp_path_factory.mktemp("deep")))
    descs = [deep.push(_carry(s), descriptor_for(_carry(s)))
             for s in ref_segments]
    return deep, descs


def _node(view, name="n0", **kw):
    node = DataNode(name, device="cpu", **kw)
    view.register(node)
    return node


def test_load_pulls_announces_and_serves(pushed, ref_segments):
    deep, descs = pushed
    view = InventoryView()
    node = _node(view)
    peon = LoadQueuePeon(node, view, deep.pull)
    done = []
    try:
        for d in descs:
            assert peon.load(d, callback=done.append)
        assert peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert peon.loads_done == 4 and peon.failures == [] and done == [True] * 4
    assert node.served_segment_ids() == {d.id for d in descs}
    for d in descs:
        rs = view.replica_set(d.id)
        assert rs is not None and rs.servers == {"n0"}
    # the node serves lazily loaded V2 segments
    assert all(isinstance(s.dims["dimA"], LazyStringDimColumn)
               for s in node.segments())
    broker = Broker(view, device="cpu")
    try:
        got = broker.run_json(Q)
    finally:
        broker.stop()
    assert got == RefExecutor(ref_segments).run(ref_query(Q))


def test_drop_unannounces(pushed):
    deep, descs = pushed
    view = InventoryView()
    node = _node(view)
    peon = LoadQueuePeon(node, view, deep.pull)
    try:
        for d in descs[:2]:
            peon.load(d)
        assert peon.wait_idle(30.0)
        assert peon.drop(descs[0])
        assert peon.wait_idle(30.0)
        # dropping what the node does not hold is a recorded failure
        assert peon.drop(descs[3])
        assert peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert peon.drops_done == 1
    assert node.served_segment_ids() == {descs[1].id}
    assert view.replica_set(descs[0].id) is None \
        or not view.replica_set(descs[0].id).servers
    assert peon.failures == [f"drop {descs[3].id}: not loaded"]


def test_queue_bound_defers_and_pending_refuses(pushed):
    deep, descs = pushed
    view = InventoryView()
    node = _node(view)
    gate = threading.Event()

    def slow_pull(d):
        gate.wait(30.0)
        return deep.pull(d)

    peon = LoadQueuePeon(node, view, slow_pull, max_queue_size=2)
    try:
        assert peon.load(descs[0])
        assert not peon.load(descs[0])          # already pending
        assert peon.load(descs[1])
        assert not peon.load(descs[2])          # the bound: defer
        assert peon.pending_count() == 2
        assert peon.pending_ids() == {descs[0].id, descs[1].id}
        assert peon.is_pending(descs[1].id)
        assert not peon.drop(descs[0])          # pending: refused too
        gate.set()
        assert peon.wait_idle(30.0)
        assert peon.pending_count() == 0
        assert peon.load(descs[2])              # room again
        assert peon.wait_idle(30.0)
    finally:
        gate.set()
        peon.stop()
    assert peon.loads_done == 3
    assert node.served_segment_ids() == {d.id for d in descs[:3]}


def test_failures_are_recorded_and_the_worker_goes_on(pushed, tmp_path):
    deep, descs = pushed
    # a corrupt copy of segment 0 in its own deep storage
    bad_deep = LocalDeepStorage(str(tmp_path / "bad"))
    seg0 = deep.pull(descs[0])
    bad = bad_deep.push(seg0, descs[0])
    with open(os.path.join(bad.load_spec["path"], "chunk_00000.bin"),
              "r+b") as f:
        f.truncate(64)
    missing = InMemoryDeepStorage()
    view = InventoryView()
    node = _node(view)
    sources = {bad.id: bad_deep.pull}
    calls = []

    def source(d):
        calls.append(d.id)
        if d.load_spec and d.load_spec.get("type") == "memory":
            return missing.pull(d)              # None: absent
        return sources.get(d.id, deep.pull)(d)

    peon = LoadQueuePeon(node, view, source)
    outcomes = []
    try:
        peon.load(bad, callback=outcomes.append)
        assert peon.wait_idle(30.0)
        absent = missing.push(seg0, descs[1])
        missing.kill(absent)
        peon.load(absent, callback=outcomes.append)
        peon.load(descs[2], callback=outcomes.append)
        assert peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert outcomes == [False, False, True]
    assert len(peon.failures) == 1
    assert peon.failures[0].startswith(f"load {bad.id}: corrupt segment")
    assert node.served_segment_ids() == {descs[2].id}
    assert len(calls) == 3


def test_no_ghost_announce_for_a_node_that_left(pushed):
    deep, descs = pushed
    view = InventoryView()
    node = DataNode("gone", device="cpu")      # never registered
    peon = LoadQueuePeon(node, view, deep.pull)
    result = []
    try:
        peon.load(descs[0], callback=result.append)
        assert peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert result == [False] and peon.loads_done == 0
    assert node.served_segment_ids() == set()
    assert view.replica_set(descs[0].id) is None


def test_callback_failure_does_not_kill_the_worker(pushed):
    deep, descs = pushed
    view = InventoryView()
    node = _node(view)
    peon = LoadQueuePeon(node, view, deep.pull)

    def boom(ok):
        raise RuntimeError("callback failed")
    try:
        peon.load(descs[0], callback=boom)
        peon.load(descs[1])
        assert peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert peon.loads_done == 2


def test_stop_joins_the_worker(pushed):
    deep, _ = pushed
    view = InventoryView()
    peon = LoadQueuePeon(_node(view), view, deep.pull)
    peon.stop()
    deadline = time.monotonic() + 5
    while peon._worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not peon._worker.is_alive()
