"""The port's query admission, cancellation and deadlines
(druid_tpu_torch/server/: Deadline, QueryToken, QueryScheduler,
QueryManager and the three errors), on the CPU: the scheduler cases of
tests/test_aux.py on the port's copy, and the broker's scatter under a
cancelled token and a spent deadline (strict: the typed error; with
allowPartialResults: a PartialResult naming the missing segments)."""
import threading
import time

import pytest
import torch

from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                     PartialResult, ResiliencePolicy,
                                     descriptor_for)
from druid_tpu_torch.data.generator import ColumnSpec, DataGenerator
from druid_tpu_torch.server import (Deadline, QueryCapacityError,
                                    QueryInterruptedError, QueryManager,
                                    QueryScheduler, QueryTimeoutError,
                                    context_timeout_ms)
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.utils.intervals import Interval

torch.set_num_threads(1)

IV = "2026-05-01/2026-05-03"
Q = {"queryType": "timeseries", "dataSource": "srv", "intervals": [IV],
     "granularity": "all",
     "aggregations": [{"type": "count", "name": "n"},
                      {"type": "longSum", "name": "s", "fieldName": "m"}]}


def test_scheduler_priority_order_and_capacity():
    sched = QueryScheduler(total_slots=1)
    assert sched.acquire(priority=0)
    admitted = []

    def waiter(name, prio):
        sched.acquire(priority=prio)
        admitted.append(name)
        sched.release()

    threads = [threading.Thread(target=waiter, args=("low", -1))]
    threads[0].start()
    time.sleep(0.05)
    threads.append(threading.Thread(target=waiter, args=("high", 10)))
    threads[1].start()
    time.sleep(0.05)
    assert admitted == []               # slot still held
    sched.release()
    for t in threads:
        t.join(5.0)
    # the later-arriving high-priority query was admitted first
    assert admitted == ["high", "low"]


def test_scheduler_lane_cap_does_not_block_other_lanes():
    sched = QueryScheduler(total_slots=4, lanes={"heavy": 1})
    assert sched.acquire(lane="heavy")
    assert not sched.acquire(lane="heavy", timeout=0.1)
    assert sched.acquire(timeout=0.1)
    sched.release("heavy")
    assert sched.acquire(lane="heavy", timeout=0.5)


def test_scheduler_abort_while_queued_frees_the_waiter():
    """A cancel polled while a query waits for a slot aborts the wait; the
    slot is not consumed."""
    sched = QueryScheduler(total_slots=1)
    qm = QueryManager()
    token = qm.register("waiting-q")
    sched.acquire()
    errs = []

    def run():
        try:
            sched.acquire(should_abort=token.check)
        except QueryInterruptedError as e:
            errs.append(e)
    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.1)
    assert qm.cancel("waiting-q")
    t.join(5.0)
    assert errs and "cancelled" in str(errs[0])
    assert sched.stats() == {"running": 1, "waiting": 0}
    sched.release()


def test_query_manager_refcounts_shared_ids():
    qm = QueryManager()
    a = qm.register("q")
    b = qm.register("q")
    assert a is b and qm.active_ids() == ["q"]
    qm.unregister("q")
    assert qm.token("q") is a
    qm.unregister("q")
    assert qm.token("q") is None and not qm.cancel("q")


def test_remote_cancel_hooks_fire_once_per_key():
    qm = QueryManager()
    tok = qm.register("q")
    fired = []
    done = threading.Event()

    def hook():
        fired.append(1)
        done.set()
    tok.add_remote_cancel(hook, key="node0")
    tok.add_remote_cancel(hook, key="node0")      # same key: a no-op
    tok.cancel()
    assert done.wait(5.0)
    time.sleep(0.05)
    assert fired == [1]


def test_deadline_arithmetic():
    assert Deadline(None).remaining() is None
    assert Deadline(None).clamp(3.0) == 3.0
    d = Deadline(50)
    assert 0 < d.remaining_ms() <= 50
    assert d.clamp(10.0) <= 0.05 and d.clamp(None) <= 0.05
    assert Deadline.after_s(None).remaining() is None
    gone = Deadline.until(time.monotonic() - 1)
    assert gone.expired() and gone.remaining() == 0.0
    with pytest.raises(QueryTimeoutError):
        gone.check()
    q = query_from_json(dict(Q, context={"timeout": 0}))
    assert context_timeout_ms(q) is None
    assert context_timeout_ms(query_from_json(
        dict(Q, context={"timeout": 250}))) == 250.0


def test_capacity_error_retry_after_header():
    assert QueryCapacityError("shed", retry_after_s=0.2) \
        .retry_after_header() == "1"
    assert QueryCapacityError("shed", retry_after_s=2.6) \
        .retry_after_header() == "3"


# ---------------------------------------------------------------------------
# the broker's scatter under a cancel and a deadline
# ---------------------------------------------------------------------------

class _SlowNode(DataNode):
    def __init__(self, name, delay_s, **kw):
        super().__init__(name, **kw)
        self.delay_s = delay_s

    def run_partials(self, query, segment_ids, check=None):
        time.sleep(self.delay_s)
        return super().run_partials(query, segment_ids, check)


def _cluster(delay_s=0.0):
    segs = DataGenerator((ColumnSpec("d", "string", cardinality=4),
                          ColumnSpec("m", "long", low=0, high=9)),
                         seed=3).segments(2, 500, Interval.parse(IV), "srv")
    view = InventoryView()
    slow = _SlowNode("slow", delay_s, device="cpu")
    fast = DataNode("fast", device="cpu")
    for n in (slow, fast):
        view.register(n)
    slow.load_segment(segs[0])
    view.announce("slow", descriptor_for(segs[0]))
    fast.load_segment(segs[1])
    view.announce("fast", descriptor_for(segs[1]))
    broker = Broker(view, device="cpu",
                    resilience_policy=ResiliencePolicy(hedge_enabled=False))
    return segs, broker


def test_broker_honours_a_cancelled_token():
    _, broker = _cluster()
    tok = broker.query_manager.register("gone")
    tok.cancel()
    with pytest.raises(QueryInterruptedError):
        broker.run_json(dict(Q, context={"queryId": "gone"}))
    broker.stop()


def test_broker_deadline_strict_and_partial():
    segs, broker = _cluster(delay_s=0.6)
    with pytest.raises(QueryTimeoutError):
        broker.run_json(dict(Q, context={"timeout": 150}))
    rows = broker.run_json(dict(Q, context={"timeout": 150,
                                            "allowPartialResults": True}))
    assert isinstance(rows, PartialResult)
    assert rows.missing_segments == [str(segs[0].id)]
    assert rows[0]["result"]["n"] == segs[1].n_rows
    broker.stop()
