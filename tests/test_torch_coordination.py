"""The port's coordination layer (druid_tpu_torch/coordination/: the lease
latch with its fencing terms, leader discovery and the chaos harness), the
coordinator's and overlord's leadership gating, the coordination surface
of the port's QueryHttpServer and the router's control-plane proxy,
against the reference package's, on the CPU.

Each of the 18 cases of tests/test_coordination.py runs as a scenario
through BOTH packages: the reference's assertions hold in each, and what
each scenario observes (leaders, terms, promotion intervals, fence logs,
HTTP codes and bodies, emitted metrics, listener events) is equal between
the two, exactly. The time is a ManualClock in every latch case, so the
observations are deterministic; URLs differ only by the servers' ports and
are compared as the server they point at.
"""
import contextlib
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import druid_tpu.cluster as r_cluster
import druid_tpu.coordination as r_coord
import druid_tpu.indexing as r_indexing
import druid_tpu.server as r_server
import druid_tpu.server.router as r_router
import druid_tpu.utils.emitter as r_emitter
import druid_tpu.utils.lifecycle as r_lifecycle
from druid_tpu.indexing import task as r_task
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster as p_cluster
import druid_tpu_torch.coordination as p_coord
import druid_tpu_torch.indexing as p_indexing
import druid_tpu_torch.server as p_server
import druid_tpu_torch.server.router as p_router
import druid_tpu_torch.utils.emitter as p_emitter
import druid_tpu_torch.utils.lifecycle as p_lifecycle
from druid_tpu_torch.indexing import task as p_task
from druid_tpu_torch.utils.intervals import Interval as PInterval

LEASE_MS = 1_000


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(
            name="ref", C=r_cluster, K=r_coord, I=r_indexing, T=r_task,
            S=r_server, R=r_router, E=r_emitter, L=r_lifecycle,
            DAY=RInterval.of("2026-01-01", "2026-01-02"), node_kw={})
    return SimpleNamespace(
        name="port", C=p_cluster, K=p_coord, I=p_indexing, T=p_task,
        S=p_server, R=p_router, E=p_emitter, L=p_lifecycle,
        DAY=PInterval.of("2026-01-01", "2026-01-02"),
        node_kw={"device": "cpu"})


REF, PORT = _pkg(True), _pkg(False)


def both(fn):
    """fn(pkg) -> observations, for each package; asserts they are equal
    and returns the port's."""
    r, p = fn(REF), fn(PORT)
    assert p == r
    return p


def mk_fleet(pk, n=3, service="coordinator"):
    md = pk.C.MetadataStore()
    clock = pk.K.ManualClock()
    h = pk.K.ChaosHarness.over_metadata(md, service, lease_ms=LEASE_MS,
                                        clock=clock)
    ps = [h.participant(f"node{i}",
                        meta={"url": f"http://127.0.0.1:{9000 + i}"})
          for i in range(n)]
    return md, clock, h, ps


def leaders_of(ps):
    return [p.node_id for p in ps if p.is_leader()]


def fence_entries(md, service):
    return [(e["op"], e["term"], e["holder"]) for e in md.fence_log(service)]


def assert_single_writer_per_term(md, service):
    """For every fencing term, all writes the store accepted came from one
    holder (no dual leader ever wrote)."""
    by_term = {}
    for e in md.fence_log(service):
        by_term.setdefault(e["term"], set()).add(e["holder"])
    for term, holders in sorted(by_term.items()):
        assert len(holders) == 1, \
            f"dual writer in term {term}: {sorted(holders)}"


# ---------------------------------------------------------------------------
# election basics
# ---------------------------------------------------------------------------

def test_first_heartbeat_elects_exactly_one_leader():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk)
        h.tick_all()
        out = [leaders_of(ps)]
        leader = h.leader()
        assert leader.term == 1
        for _ in range(5):
            clock.advance(LEASE_MS // 3)
            h.tick_all()
            assert leaders_of(ps) == [leader.node_id]
            assert leader.term == 1
            out.append((leaders_of(ps), leader.term, clock()))
        return out
    assert len(both(run)[0]) == 1


def test_graceful_release_promotes_standby_immediately():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk)
        first = h.await_leader()[0]
        first.stop(release=True)
        promoted, intervals = h.await_leader(max_intervals=1)
        assert promoted is not first
        assert intervals <= 1.0
        assert promoted.term == 2
        return first.node_id, promoted.node_id, intervals, promoted.term
    both(run)


def test_terms_are_monotonic_across_failovers():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk)
        seen = []
        for _ in range(3):
            leader, intervals = h.await_leader()
            seen.append((leader.node_id, leader.term, intervals))
            h.kill_leader()
        terms = [t for _, t, _ in seen]
        assert terms == sorted(terms) and len(set(terms)) == 3
        return seen
    both(run)


# ---------------------------------------------------------------------------
# the three injected faults: bounded failover + no dual leader
# ---------------------------------------------------------------------------

def _inject(h, fault):
    leader = h.leader()
    if fault == "kill":
        h.kill_leader()
    elif fault == "drop":
        h.drop_heartbeats(leader.node_id)
    elif fault == "partition":
        h.partition(leader.node_id)
    return leader


@pytest.mark.parametrize("fault", ["kill", "drop", "partition"])
def test_fault_promotes_standby_within_bounded_intervals(fault):
    def run(pk):
        md, clock, h, ps = mk_fleet(pk)
        old = h.await_leader()[0]
        old_term = old.term
        _inject(h, fault)
        promoted, intervals = h.await_leader(max_intervals=3, exclude=old)
        assert promoted is not old
        assert intervals <= 2.0, \
            f"{fault}: promotion took {intervals} intervals"
        assert promoted.term == old_term + 1
        assert not old.is_leader()
        assert leaders_of(ps) == [promoted.node_id]
        return old.node_id, promoted.node_id, intervals, promoted.term
    both(run)


@pytest.mark.parametrize("fault", ["kill", "drop", "partition"])
def test_no_two_accepted_writes_share_a_term_across_holders(fault):
    def run(pk):
        md, clock, h, ps = mk_fleet(pk)
        old = h.await_leader()[0]
        md.insert_task("t-pre", "ds", "RUNNING", {}, fence=old.fence())
        stale_fence = old.fence()
        _inject(h, fault)
        promoted, _ = h.await_leader(max_intervals=3, exclude=old)
        md.insert_task("t-post", "ds", "RUNNING", {},
                       fence=promoted.fence())
        with pytest.raises(pk.C.StaleTermError):
            md.insert_task("t-zombie", "ds", "RUNNING", {},
                           fence=stale_fence)
        with pytest.raises(pk.C.StaleTermError):
            md.publish_segments(
                [pk.C.SegmentDescriptor("ds", pk.DAY, "v1")],
                fence=stale_fence)
        assert_single_writer_per_term(md, "coordinator")
        assert md.task("t-zombie") is None
        assert md.used_segments("ds") == []
        return stale_fence, promoted.fence(), \
            fence_entries(md, "coordinator")
    both(run)


def test_healed_node_rejoins_as_standby():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk)
        old = h.await_leader()[0]
        h.partition(old.node_id)
        promoted, _ = h.await_leader(max_intervals=3, exclude=old)
        h.heal(old.node_id)
        out = []
        for _ in range(4):
            clock.advance(LEASE_MS // 3)
            h.tick_all()
            assert leaders_of(ps) == [promoted.node_id]
            out.append((leaders_of(ps), promoted.term))
        return out
    both(run)


def test_fenced_write_requires_current_term_not_just_any_term():
    def run(pk):
        md = pk.C.MetadataStore()
        store = pk.K.MetadataLeaseStore(md)
        clock = pk.K.ManualClock()
        a = pk.K.LeaderParticipant(store, "svc", "a", lease_ms=LEASE_MS,
                                   clock=clock)
        a.tick()
        errors = []
        for fence in (("svc", a.term + 5, "a"), ("svc", a.term, "impostor"),
                      ("other-svc", 1, "a")):
            with pytest.raises(pk.C.StaleTermError) as ei:
                md.mark_unused([], fence=fence)
            errors.append(str(ei.value))
        return a.term, errors
    both(run)


# ---------------------------------------------------------------------------
# duty-loop gating: coordinator + overlord idle on non-leaders
# ---------------------------------------------------------------------------

def _probe_node(pk, name):
    class ProbeCountingNode(pk.C.DataNode):
        def __init__(self, name):
            super().__init__(name, **pk.node_kw)
            self.pings = 0

        def ping(self):
            self.pings += 1
            return True
    return ProbeCountingNode(name)


def test_coordinator_duty_loop_idles_on_non_leader():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk, 2)
        leader, _ = h.await_leader()
        standby = next(p for p in ps if p is not leader)
        view = pk.C.InventoryView()
        node = _probe_node(pk, "n0")
        view.register(node)
        coord = pk.C.Coordinator(md, view, lambda d: None, leader=standby)
        stats = coord.run_once(now_ms=clock())
        assert stats.skipped_not_leader
        assert stats.leader_term == -1
        assert node.pings == 0
        assert md.fence_log("coordinator") == []
        out = [vars(stats).copy()]
        h.kill_leader()
        promoted, _ = h.await_leader(max_intervals=3)
        assert promoted is standby
        stats = coord.run_once(now_ms=clock())
        assert not stats.skipped_not_leader
        assert stats.leader_term == standby.term
        assert node.pings == 1
        out.append(vars(stats).copy())
        return out
    both(run)


def test_coordinator_writes_carry_fencing_term():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk, 1)
        leader, _ = h.await_leader()
        md.publish_segments([pk.C.SegmentDescriptor("ds", pk.DAY, "v1"),
                             pk.C.SegmentDescriptor("ds", pk.DAY, "v2")])
        coord = pk.C.Coordinator(md, pk.C.InventoryView(), lambda d: None,
                                 leader=leader)
        stats = coord.run_once(now_ms=clock())
        assert stats.overshadowed_marked == 1
        log = fence_entries(md, "coordinator")
        assert log == [("mark_unused", leader.term, leader.node_id)]
        return vars(stats).copy(), log, \
            [d.version for d in md.used_segments("ds")]
    both(run)


def test_overlord_rejects_submission_on_non_leader():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk, 2, service="overlord")
        leader, _ = h.await_leader()
        standby = next(p for p in ps if p is not leader)
        ov = pk.I.Overlord(md, leader=standby)
        try:
            with pytest.raises(pk.K.NotLeaderError) as ei:
                ov.submit(pk.T.KillTask("ds", pk.DAY, task_id="kill-0"))
            assert ei.value.leader_url == leader.meta["url"]
            assert md.tasks() == []
        finally:
            ov.shutdown()
        ov2 = pk.I.Overlord(md, leader=leader)
        try:
            tid = ov2.submit(pk.T.KillTask("ds", pk.DAY, task_id="kill-1"))
            assert ov2.await_task(tid).state == "SUCCESS"
            ops = [e[0] for e in fence_entries(md, "overlord")]
            assert "insert_task" in ops and "update_task_status" in ops
            assert_single_writer_per_term(md, "overlord")
        finally:
            ov2.shutdown()
        return str(ei.value), ei.value.leader_url, tid, \
            fence_entries(md, "overlord"), \
            [(t["id"], t["status"]) for t in md.tasks()]
    both(run)


def test_zombie_overlord_task_cannot_publish():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk, 2, service="overlord")
        a_leader, _ = h.await_leader()
        a = pk.I.Overlord(md, leader=a_leader)
        tb = a.toolbox()
        try:
            h.kill_leader()
            b_leader, _ = h.await_leader(max_intervals=3)

            class _T:
                id = "t-zombie"
            with pytest.raises(pk.C.StaleTermError) as ei:
                tb.publish(_T(), [pk.C.SegmentDescriptor("ds", pk.DAY,
                                                         "v1")])
            assert md.used_segments("ds") == []
            assert_single_writer_per_term(md, "overlord")
        finally:
            a.shutdown()
        return str(ei.value), a_leader.node_id, b_leader.node_id, \
            b_leader.term
    both(run)


# ---------------------------------------------------------------------------
# discovery + redirect (DruidLeaderClient pattern)
# ---------------------------------------------------------------------------

def _get(url, expect_redirect=False):
    req = urllib.request.Request(url, method="GET")

    class _NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(_NoRedirect)
    try:
        with opener.open(req, timeout=10) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), \
            json.loads(e.read() or b"null") if not expect_redirect else None


@contextlib.contextmanager
def http_pair(pk):
    """Two QueryHttpServers fronting one overlord latch: s1's participant
    leads, s2's stands by."""
    md = pk.C.MetadataStore()
    clock = pk.K.ManualClock()
    h = pk.K.ChaosHarness.over_metadata(md, "overlord", lease_ms=LEASE_MS,
                                        clock=clock)
    p1, p2 = h.participant("node1"), h.participant("node2")
    servers, overlords = [], []
    try:
        for p in (p1, p2):
            ov = pk.I.Overlord(md, leader=p)
            s = pk.S.QueryHttpServer(pk.S.QueryLifecycle(None),
                                     coordination={"overlord": p},
                                     overlord=ov)
            s.start()
            p.meta["url"] = f"http://127.0.0.1:{s.port}"
            servers.append(s)
            overlords.append(ov)
        p1.tick()
        p2.tick()
        assert p1.is_leader() and not p2.is_leader()
        yield md, clock, h, (p1, p2), servers
    finally:
        for s in servers:
            s.stop()
        for ov in overlords:
            ov.shutdown()


def _which(url, servers):
    """The server (0 or 1) a URL points at, with the rest of the URL."""
    for i, s in enumerate(servers):
        base = f"http://127.0.0.1:{s.port}"
        if url.startswith(base):
            return i, url[len(base):]
    return url


def test_http_leader_discovery_and_redirect():
    def run(pk):
        with http_pair(pk) as (md, clock, h, (p1, p2), (s1, s2)):
            u1 = f"http://127.0.0.1:{s1.port}"
            u2 = f"http://127.0.0.1:{s2.port}"
            out = []
            for u in (u1, u2):
                code, _, body = _get(u + "/druid/indexer/v1/leader")
                assert code == 200 and body["leader"] == u1
                assert body["term"] == p1.term
                out.append((code, _which(body["leader"], (s1, s2)),
                            body["term"], body["holder"]))
            assert _get(u1 + "/druid/indexer/v1/isLeader")[0] == 200
            code, _, body = _get(u2 + "/druid/indexer/v1/isLeader")
            assert code == 404 and body["leader"] is False
            out.append((code, body))
            code, headers, _ = _get(u2 + "/druid/indexer/v1/task/x/status",
                                    expect_redirect=True)
            assert code == 307
            assert headers["Location"] \
                == u1 + "/druid/indexer/v1/task/x/status"
            out.append((code, _which(headers["Location"], (s1, s2))))
            # 503 while no leader is live, on the standby
            p1.kill()
            clock.advance(LEASE_MS + 1)
            code, _, body = _get(u2 + "/druid/indexer/v1/task/x/status")
            assert code == 503
            out.append((code, body))
            return out
    both(run)


def test_http_task_submit_runs_on_leader_only():
    def run(pk):
        with http_pair(pk) as (md, clock, h, (p1, p2), (s1, s2)):
            u2 = f"http://127.0.0.1:{s2.port}"
            payload = {"type": "kill", "dataSource": "ds",
                       "interval": str(pk.DAY), "id": "kill-1"}
            client = pk.K.LeaderClient(h.store, "overlord", clock=clock)
            out = [client.go("/druid/indexer/v1/task", payload)]
            assert out[0]["task"] == "kill-1"
            assert md.task("kill-1") is not None
            stale = pk.K.LeaderClient(h.store, "overlord", clock=clock)
            stale._cached_url = u2
            out.append(stale.go("/druid/indexer/v1/task",
                                {**payload, "id": "kill-2"}))
            assert out[-1]["task"] == "kill-2"
            assert md.task("kill-2") is not None
            assert _which(stale._cached_url, (s1, s2)) == (0, "")
            # the leader's status read for the submitted task
            s1.overlord.await_task("kill-2")
            out.append(client.go("/druid/indexer/v1/task/kill-2/status"))
            return out
    assert both(run)[-1] == {"task": "kill-2", "status": "SUCCESS"}


def test_leader_client_no_leader():
    def run(pk):
        md = pk.C.MetadataStore()
        clock = pk.K.ManualClock()
        client = pk.K.LeaderClient(pk.K.MetadataLeaseStore(md), "overlord",
                                   clock=clock)
        assert client.leader() is None
        with pytest.raises(pk.K.NoLeaderError) as ei:
            client.request(lambda url: url, retries=2, backoff_s=0)
        return str(ei.value)
    both(run)


def test_router_fronts_the_control_plane():
    def run(pk):
        with http_pair(pk) as (md, clock, h, (p1, p2), servers):
            selector = pk.R.TieredBrokerSelector(
                {"_default": ["http://127.0.0.1:1"]}, "_default")
            router = pk.R.RouterHttpServer(
                selector, leader_clients={
                    "overlord": pk.K.LeaderClient(h.store, "overlord",
                                                  clock=clock)})
            router.start()
            try:
                out = []
                code, _, body = _get(router.url + "/druid/indexer/v1/leader")
                assert code == 200
                out.append((code, _which(body["leader"], servers)))
                p1.kill()
                clock.advance(LEASE_MS + 1)
                p2.tick()
                assert p2.is_leader()
                code, _, body = _get(router.url + "/druid/indexer/v1/leader")
                assert code == 200
                out.append((code, _which(body["leader"], servers),
                            body["term"]))
            finally:
                router.stop()
            return out
    assert both(run) == [(200, (0, "")), (200, (1, ""), 2)]


# ---------------------------------------------------------------------------
# observability + lifecycle stage
# ---------------------------------------------------------------------------

def test_emitter_reports_transitions_and_lease_age():
    def run(pk):
        sink = pk.E.InMemoryEmitter()
        emitter = pk.E.ServiceEmitter("coordinator", "localhost", sink)
        md = pk.C.MetadataStore()
        clock = pk.K.ManualClock()
        h = pk.K.ChaosHarness.over_metadata(md, "coordinator",
                                            lease_ms=LEASE_MS, clock=clock)
        p = h.participant("node0", emitter=emitter)
        p.tick()
        trans = sink.metrics("coordination/leader/transitions")
        assert len(trans) == 1
        assert trans[0].dims["event"] == "become" and trans[0].value == 1
        clock.advance(400)
        p.tick()
        ages = sink.metrics("coordination/lease/ageMs")
        assert ages and ages[-1].value == 400
        p.drop_heartbeats = True
        clock.advance(LEASE_MS + 1)
        p.tick()
        trans = sink.metrics("coordination/leader/transitions")
        assert [e.dims["event"] for e in trans] == ["become", "stop"]
        assert p.transitions == 2
        pk.K.LeaderMonitor(p).do_monitor(emitter)
        assert sink.metrics("coordination/leader/transitions")[-1].value == 2
        assert sink.metrics(
            "coordination/lease/ageMs")[-1].dims["leader"] is False
        return [(e.metric, e.value, dict(e.dims)) for e in sink.metrics()]
    both(run)


def test_become_and_stop_listeners_fire():
    def run(pk):
        md, clock, h, ps = mk_fleet(pk, 1)
        p = ps[0]
        events = []
        p.register_listener(
            on_become=lambda term: events.append(("up", term)),
            on_stop=lambda: events.append(("down", None)))
        p.tick()
        assert events == [("up", 1)]
        p.drop_heartbeats = True
        clock.advance(LEASE_MS + 1)
        p.tick()
        assert events == [("up", 1), ("down", None)]
        p.drop_heartbeats = False
        clock.advance(LEASE_MS + 1)
        p.tick()
        assert events[-1] == ("up", 2)
        return events
    both(run)


def test_lifecycle_coordination_stage_ordering():
    def run(pk):
        events = []

        def h(name):
            return dict(start=lambda: events.append(f"+{name}"),
                        stop=lambda: events.append(f"-{name}"))

        lc = pk.L.Lifecycle()
        lc.add(**h("announce"), stage=pk.L.Stage.ANNOUNCEMENTS)
        lc.add(**h("latch"), stage=pk.L.Stage.COORDINATION)
        lc.add(**h("http"), stage=pk.L.Stage.SERVER)
        lc.add(**h("meta"), stage=pk.L.Stage.INIT)
        lc.start()
        lc.stop()
        return events
    assert both(run) == ["+meta", "+http", "+latch", "+announce",
                         "-announce", "-latch", "-http", "-meta"]
