"""The port's subscription hub (druid_tpu_torch/server/subscriptions.py) and
the subscription surface of its query resource (/druid/v2/subscriptions on
server/http.py), on the CPU: tests/test_subscriptions.py's seven cases.

Dedupe onto one standing program (one device dispatch a tick for 64
identical subscribers), long-poll with ETag and 304, the idle sweep, the
scheduler's flush loop as the tick driver, the HTTP surface end to end,
lifecycle leak hygiene under the leak witness, and the monitors' metric
names. The rows a subscriber receives equal the reference hub's after the
same ingest. Every long-poll has a bounded wait.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster.metadata as r_metadata
import druid_tpu.ingest as r_ingest
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.model as r_model
import druid_tpu.server.subscriptions as r_subs
from druid_tpu.utils.intervals import Interval as RInterval

from druid_tpu_torch.cluster.metadata import MetadataStore
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.ingest import (Appenderator, RowBatch, SegmentAllocator,
                                    StreamAppenderatorDriver)
from druid_tpu_torch.obs import dispatch as dispatch_mod
from druid_tpu_torch.query.aggregators import (CountAggregator,
                                               LongSumAggregator)
from druid_tpu_torch.query.model import TimeseriesQuery
from druid_tpu_torch.server.subscriptions import (SubscriptionHub,
                                                  SubscriptionMetricsMonitor,
                                                  UnknownSubscriptionError)
from druid_tpu_torch.utils.intervals import Interval
from tests.test_torch_ingest import close

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parent.parent

SPECS = [CountAggregator("rows"), LongSumAggregator("v", "value")]
QSPECS = [LongSumAggregator("rows", "rows"), LongSumAggregator("v", "v")]
DAY = Interval.of("2026-03-01", "2026-03-02")
T0 = DAY.start


def _cols(rng, n, off=0):
    ts = [int(T0 + (off + i) * 1000) for i in range(n)]
    return ts, {"page": [f"p{int(x)}" for x in rng.integers(5, size=n)],
                "value": [int(x) for x in rng.integers(10, size=n)]}


def _batch(rng, n, off=0):
    return RowBatch(*_cols(rng, n, off))


def _rig():
    md = MetadataStore()
    app = Appenderator("rt", SPECS, query_granularity="none")
    driver = StreamAppenderatorDriver(app, SegmentAllocator(md, "day"), md)
    return md, app, driver


def _query(granularity="all", **ctx):
    return TimeseriesQuery.of("rt", [DAY], QSPECS, granularity=granularity,
                              context=ctx or None)


def _hub(**kw):
    return SubscriptionHub(device="cpu", **kw)


def test_identical_subscriptions_share_one_program_one_dispatch():
    """N structurally identical subscriptions run ONE standing program: the
    tick's device dispatch count is independent of N; every subscriber
    gets the rows the reference hub gives after the same ingest."""
    rng = np.random.default_rng(0)
    b1, b2 = _cols(rng, 400), _cols(rng, 400, off=400)
    md, app, driver = _rig()
    hub = _hub(idle_timeout_s=0)
    hub.attach(app)
    try:
        subs = [hub.subscribe(_query()) for _ in range(64)]
        assert hub.active_subscriptions() == 64
        assert hub.active_programs() == 1
        driver.add_batch(RowBatch(*b1))
        hub.tick()
        driver.add_batch(RowBatch(*b2))
        d0 = dispatch_mod.count()
        hub.tick()
        fan64 = dispatch_mod.count() - d0
        assert fan64 == 1, \
            f"64 identical subscriptions cost {fan64} dispatches per tick"
        rows0, etag0, changed = hub.poll(subs[0][0], etag=subs[0][1])
        assert changed and rows0[0]["result"]["rows"] == 800
        for sid, etag in subs[1:]:
            rows, new_etag, ch = hub.poll(sid, etag=etag)
            assert ch and rows == rows0 and new_etag == etag0
        sid_ctx, _ = hub.subscribe(_query(queryId="abc"))
        assert hub.active_programs() == 1
        sid_g, _ = hub.subscribe(_query(granularity="hour"))
        assert hub.active_programs() == 2
        sid_b, _ = hub.subscribe(_query(granularity="hour",
                                        standingEmit="bucket"))
        assert hub.active_programs() == 3
        for sid in (sid_ctx, sid_g, sid_b):
            hub.unsubscribe(sid)
    finally:
        hub.stop()
    assert hub.active_subscriptions() == 0
    assert hub.active_programs() == 0
    assert app._listeners == []

    # the reference hub after the same ingest
    rmd = r_metadata.MetadataStore()
    rapp = r_ingest.Appenderator(
        "rt", [r_aggs.CountAggregator("rows"),
               r_aggs.LongSumAggregator("v", "value")],
        query_granularity="none")
    rdrv = r_ingest.StreamAppenderatorDriver(
        rapp, r_ingest.SegmentAllocator(rmd, "day"), rmd)
    rhub = r_subs.SubscriptionHub(idle_timeout_s=0)
    rhub.attach(rapp)
    try:
        rsid, retag = rhub.subscribe(r_model.TimeseriesQuery.of(
            "rt", [RInterval.of("2026-03-01", "2026-03-02")],
            [r_aggs.LongSumAggregator("rows", "rows"),
             r_aggs.LongSumAggregator("v", "v")], granularity="all"))
        rdrv.add_batch(r_ingest.RowBatch(*b1))
        rhub.tick()
        rdrv.add_batch(r_ingest.RowBatch(*b2))
        rhub.tick()
        want, _, _ = rhub.poll(rsid, etag=retag)
    finally:
        rhub.stop()
    close(want, rows0)


def test_long_poll_304_and_wakeup():
    rng = np.random.default_rng(1)
    md, app, driver = _rig()
    hub = _hub(idle_timeout_s=0)
    hub.attach(app)
    try:
        sid, etag = hub.subscribe(_query())
        t0 = time.monotonic()
        rows, new_etag, changed = hub.poll(sid, etag=etag, timeout_s=0.15)
        assert not changed and rows is None and new_etag == etag
        assert time.monotonic() - t0 >= 0.14

        got = {}

        def parked():
            got["r"] = hub.poll(sid, etag=etag, timeout_s=30.0)

        t = threading.Thread(target=parked)
        t.start()
        time.sleep(0.05)
        driver.add_batch(_batch(rng, 100))
        hub.tick()
        t.join(timeout=10)
        assert not t.is_alive()
        rows, _, changed = got["r"]
        assert changed and rows[0]["result"]["rows"] == 100

        errs = []

        def parked_dead():
            try:
                hub.poll(sid, etag=hub.poll(sid)[1], timeout_s=30.0)
            except UnknownSubscriptionError as e:
                errs.append(e)

        t2 = threading.Thread(target=parked_dead)
        t2.start()
        time.sleep(0.05)
        hub.unsubscribe(sid)
        t2.join(timeout=10)
        assert not t2.is_alive() and len(errs) == 1
    finally:
        hub.stop()


def test_idle_subscriptions_swept():
    md, app, driver = _rig()
    hub = _hub(idle_timeout_s=0.05)
    hub.attach(app)
    try:
        sid, _ = hub.subscribe(_query())
        assert hub.active_subscriptions() == 1
        time.sleep(0.1)
        hub.tick()
        assert hub.active_subscriptions() == 0
        assert hub.active_programs() == 0
        with pytest.raises(UnknownSubscriptionError):
            hub.poll(sid)
    finally:
        hub.stop()


def test_scheduler_flush_loop_drives_ticks():
    """drive_with(scheduler): the port's data-node scheduler's dispatcher
    loop is the tick driver — appended data surfaces to a subscriber
    without anyone calling hub.tick()."""
    from druid_tpu_torch.cluster.view import DataNode
    from druid_tpu_torch.server.scheduler import (DataNodeScheduler,
                                                  SchedulerConfig)
    rng = np.random.default_rng(2)
    md, app, driver = _rig()
    node = DataNode("n0", device="cpu")
    sched = DataNodeScheduler(node, SchedulerConfig()).start()
    hub = _hub(idle_timeout_s=0).drive_with(sched)
    hub.attach(app)
    try:
        sid, etag = hub.subscribe(_query())
        driver.add_batch(_batch(rng, 50))
        rows, _, changed = hub.poll(sid, etag=etag, timeout_s=30.0)
        assert changed and rows[0]["result"]["rows"] == 50
    finally:
        hub.stop()
        sched.stop()
    assert sched._tick_hooks == []


def _urlopen(req, timeout=30):
    return urllib.request.urlopen(req, timeout=timeout)


def test_http_subscription_surface_end_to_end():
    """POST subscribe → GET long-poll (200 + X-Druid-ETag, then 304 via
    If-None-Match, then 200 again after new data) → DELETE teardown; an
    ineligible query is a 400, an unknown id a 404; /metrics carries the
    subscription and standing gauges after a monitor tick."""
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle

    rng = np.random.default_rng(3)
    md, app, driver = _rig()
    hub = _hub(idle_timeout_s=0)
    hub.attach(app)
    ex = QueryExecutor(app.query_segments(), device="cpu")
    srv = QueryHttpServer(QueryLifecycle(ex), subscription_hub=hub,
                          port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        q = {"queryType": "timeseries", "dataSource": "rt",
             "intervals": [str(DAY)], "granularity": "all",
             "aggregations": [{"type": "longSum", "name": "rows",
                               "fieldName": "rows"}]}
        req = urllib.request.Request(
            f"{base}/druid/v2/subscriptions", data=json.dumps(q).encode(),
            headers={"Content-Type": "application/json"})
        with _urlopen(req) as r:
            body = json.loads(r.read())
        sub_id, etag = body["subscriptionId"], body["etag"]

        with _urlopen(f"{base}/druid/v2/subscriptions/{sub_id}") as r:
            assert r.status == 200
            assert r.headers["X-Druid-ETag"] == etag

        req = urllib.request.Request(
            f"{base}/druid/v2/subscriptions/{sub_id}?timeoutMs=100",
            headers={"If-None-Match": etag})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _urlopen(req)
        assert ei.value.code == 304

        driver.add_batch(_batch(rng, 75))
        hub.tick()
        req = urllib.request.Request(
            f"{base}/druid/v2/subscriptions/{sub_id}?timeoutMs=5000",
            headers={"If-None-Match": etag})
        with _urlopen(req) as r:
            rows = json.loads(r.read())
            new_etag = r.headers["X-Druid-ETag"]
        assert new_etag != etag
        assert rows[0]["result"]["rows"] == 75

        bad = dict(q, queryType="scan", columns=[])
        req = urllib.request.Request(
            f"{base}/druid/v2/subscriptions", data=json.dumps(bad).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            _urlopen(req)
        assert ei.value.code == 400

        srv.metrics_tick()
        with _urlopen(f"{base}/metrics") as r:
            text = r.read().decode()
        assert "druid_subscription_active" in text
        assert "druid_query_standing_ticks" in text

        req = urllib.request.Request(
            f"{base}/druid/v2/subscriptions/{sub_id}", method="DELETE")
        with _urlopen(req) as r:
            assert r.status == 202
            assert json.loads(r.read())["active"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _urlopen(f"{base}/druid/v2/subscriptions/{sub_id}")
        assert ei.value.code == 404
    finally:
        srv.stop()
        hub.stop()


def test_http_subscriptions_404_without_a_hub():
    """Without a hub the subscription paths answer 404, as the
    reference's do when the surface is not enabled."""
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
    srv = QueryHttpServer(QueryLifecycle(QueryExecutor(device="cpu")),
                          port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        for req in (urllib.request.Request(
                f"{base}/druid/v2/subscriptions", data=b"{}",
                headers={"Content-Type": "application/json"}),
                f"{base}/druid/v2/subscriptions/x",
                urllib.request.Request(f"{base}/druid/v2/subscriptions/x",
                                       method="DELETE")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _urlopen(req)
            assert ei.value.code == 404
    finally:
        srv.stop()


def test_hub_stress_returns_to_baseline():
    """Subscription-lifecycle leak hygiene under the leak witness:
    subscribe/poll/tick/unsubscribe churn plus hub start/stop cycles leave
    no thread, fd or device-pool residue."""
    import sys
    sys.path.insert(0, str(REPO_ROOT))
    from tools.druidlint.leakwitness import LeakWitness

    rng = np.random.default_rng(4)

    def cycle():
        md, app, driver = _rig()
        hub = _hub(idle_timeout_s=0, tick_period_s=0.01).start()
        hub.attach(app)
        subs = [hub.subscribe(_query()) for _ in range(8)]
        driver.add_batch(_batch(rng, 64))
        for sid, etag in subs:
            rows, _, changed = hub.poll(sid, etag=etag, timeout_s=10.0)
            assert changed and rows
        for sid, _ in subs[:4]:
            hub.unsubscribe(sid)
        hub.stop()
        assert hub.active_subscriptions() == 0
        assert app._listeners == []

    w = LeakWitness(str(REPO_ROOT)).install()
    try:
        cycle()
        base = w.snapshot()
        for _ in range(3):
            cycle()
        assert w.leaks(base, grace_s=10.0) == []
    finally:
        w.uninstall()


def test_subscription_monitor_names_in_catalog():
    from druid_tpu_torch.obs.catalog import validate_emitted
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    hub = _hub(idle_timeout_s=0)
    try:
        sink = InMemoryEmitter()
        SubscriptionMetricsMonitor(hub).do_monitor(
            ServiceEmitter("t", "h", sink))
        names = {e.metric for e in sink.events}
        assert names == {"subscription/active", "subscription/fanout",
                         "subscription/ticks"}
        assert validate_emitted(names) == []
    finally:
        hub.stop()
