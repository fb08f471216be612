"""The port's configuration and CLI (druid_tpu_torch/utils/config.py,
druid_tpu_torch/cli.py, `python -m druid_tpu_torch`) against the reference
package's, on the CPU.

The Config and CLI cases of tests/test_aux.py and the historical's
skip-and-log case of tests/test_format_v2.py run through BOTH packages:
Config answers equal for everything given as `env=`; the segment tools
(`dump-segment`, `segment inspect`, `validate-segment`) print the same
output, byte for byte, from both packages over one persisted segment
(written once, by the reference); `build_historical` with `build_broker`
serves over HTTP the reference executor's rows. The port's `server` runs
on a thread (its coordinator loads a published segment from deep storage
into its data nodes) and stops on `_STOP`, and `python -m druid_tpu_torch`
runs as a subprocess.

The one divergence on purpose is pinned: the reference's Config.load()
reads a DRUID_TPU_* environment layer from os.environ when env is None,
the port's reads none (the port reads no environment).
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cli as r_cli
import druid_tpu.utils.config as r_config
from druid_tpu.data.generator import DataGenerator
from druid_tpu.data.segment import SegmentBuilder
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.storage.format import persist_segment as ref_persist_v1
from druid_tpu.storage.format_v2 import persist_segment_v2 as ref_persist_v2
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cli as p_cli
import druid_tpu_torch.utils.config as p_config
from druid_tpu_torch.cluster import MetadataStore, descriptor_for
from druid_tpu_torch.storage.deep import LocalDeepStorage
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAY = RInterval.of("2026-01-01", "2026-01-02")
TS = {"queryType": "timeseries", "dataSource": "test",
      "intervals": ["2026-01-01/2026-01-02"], "granularity": "all",
      "aggregations": [{"type": "count", "name": "n"},
                       {"type": "longSum", "name": "ls",
                        "fieldName": "metLong"}]}

REF = SimpleNamespace(name="ref", cli=r_cli, Config=r_config.Config)
PORT = SimpleNamespace(name="port", cli=p_cli, Config=p_config.Config)


@pytest.fixture(scope="module")
def segment():
    return DataGenerator(TEST_SCHEMA, seed=42).segment(
        4000, DAY, datasource="test")


@pytest.fixture(scope="module", params=["v1", "v2"])
def persisted(request, segment, tmp_path_factory):
    """The segment persisted once, by the reference's writer, in format
    V1 or V2."""
    d = str(tmp_path_factory.mktemp("seg") / request.param)
    (ref_persist_v1 if request.param == "v1" else ref_persist_v2)(segment, d)
    return d


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, payload, path="/druid/v2"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# Config (tests/test_aux.py)
# ---------------------------------------------------------------------------

def _config_layers(pk, tmp_path):
    f = tmp_path / "runtime.properties"
    f.write_text("server.port=8082\n# comment\nquery.cache=true\n")
    cfg = pk.Config.load(str(f), env={"DRUID_TPU_SERVER_PORT": "9000"},
                         overrides={"metadata.path": ":memory:"})
    assert cfg.get_int("server.port") == 9000
    assert cfg.get_bool("query.cache")
    assert cfg.get("metadata.path") == ":memory:"
    return cfg.to_dict()


def _config_json_and_select(pk, tmp_path):
    f = tmp_path / "conf.json"
    f.write_text(json.dumps({"storage": {"type": "local", "dir": "/x"},
                             "server": {"port": 1, "lanes": "a=1"}}))
    cfg = pk.Config.load(str(f), env={})
    assert cfg.get("storage.type") == "local"
    assert cfg.subtree("storage") == {"type": "local", "dir": "/x"}
    made = cfg.select("storage.type",
                      {"local": lambda: "L", "memory": lambda: "M"},
                      default="memory")
    assert made == "L"
    with pytest.raises(ValueError) as ei:
        cfg.with_overrides({"storage.type": "bogus"}).select(
            "storage.type", {"local": lambda: 1}, default="local")
    return cfg.to_dict(), made, str(ei.value), \
        cfg.get_float("server.port"), cfg.get_bool("missing", True)


def _config_env_camelcase(pk, tmp_path):
    cfg = pk.Config.load(env={"DRUID_TPU_SERVER_DATANODES": "4",
                              "OTHER_X": "1"})
    assert cfg.get_int("server.dataNodes", 1) == 4
    return cfg.to_dict()


@pytest.mark.parametrize("case", [_config_layers, _config_json_and_select,
                                  _config_env_camelcase],
                         ids=["layers", "json-select", "env-camelcase"])
def test_config_equal_for_a_given_env(case, tmp_path):
    r = case(REF, tmp_path)
    p = case(PORT, tmp_path)
    assert p == r


def test_config_reads_no_environment_unless_given(monkeypatch, tmp_path):
    """The divergence on purpose: with env=None the reference reads the
    DRUID_TPU_* layer from os.environ, the port none."""
    monkeypatch.setenv("DRUID_TPU_SERVER_DATANODES", "4")
    f = tmp_path / "conf.json"
    f.write_text(json.dumps({"server": {"port": 7}}))
    assert r_config.Config.load().get_int("server.dataNodes", 1) == 4
    assert p_config.Config.load().get_int("server.dataNodes", 1) == 1
    assert p_config.Config.load(str(f)).to_dict() == {"server.port": 7}
    env = {"DRUID_TPU_SERVER_DATANODES": "4"}
    assert p_config.Config.load(str(f), env=env).to_dict() \
        == r_config.Config.load(str(f), env=env).to_dict()


def test_cli_scheduler_config():
    def run(pk):
        cfg = pk.Config.load(None, env={}, overrides={
            "server.querySlots": "4", "server.lanes": "reports=1,adhoc=2"})
        sched = pk.cli._scheduler_from_config(cfg)
        assert sched.total_slots == 4
        assert sched.lane_caps == {"reports": 1, "adhoc": 2}
        assert pk.cli._scheduler_from_config(pk.Config.load(None, env={})) \
            is None
        return sched.total_slots, sched.lane_caps
    assert run(PORT) == run(REF)


# ---------------------------------------------------------------------------
# segment tools (tests/test_aux.py): the same output from both packages
# ---------------------------------------------------------------------------

def _cli_out(pk, argv, capsys):
    rc = pk.cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", [
    ["validate-segment"], ["dump-segment"], ["dump-segment", "--full"],
    ["dump-segment", "--full", "--rows", "3"], ["segment", "inspect"]],
    ids=["validate", "dump", "dump-full", "dump-rows", "inspect"])
def test_cli_dump_and_validate(persisted, segment, argv, capsys):
    args = argv + [persisted]
    r = _cli_out(REF, args, capsys)
    extra = ["--device", "cpu"] if "--rows" in argv else []
    p = _cli_out(PORT, args + extra, capsys)
    assert p == r and r[0] == 0
    if argv == ["validate-segment"]:
        assert "OK" in r[1] and f"rows={segment.n_rows}" in r[1]
    elif "--rows" in argv:
        dump = json.loads(r[1])
        assert dump["numRows"] == segment.n_rows
        assert dump["columns"]["dimA"]["cardinality"] == \
            segment.dims["dimA"].cardinality
        assert len(dump["rows"]) == 3


def test_cli_version(capsys):
    assert _cli_out(PORT, ["version"], capsys) \
        == (0, p_cli.VERSION + "\n", "")
    assert _cli_out(REF, ["version"], capsys)[0] == 0


def test_cli_validate_rejects_garbage(tmp_path, capsys):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "meta.smoosh").write_text("garbage")
    r = _cli_out(REF, ["validate-segment", str(d)], capsys)
    p = _cli_out(PORT, ["validate-segment", str(d)], capsys)
    assert r[0] == p[0] == 1
    assert p == r


# ---------------------------------------------------------------------------
# node builders (tests/test_aux.py, tests/test_format_v2.py)
# ---------------------------------------------------------------------------

def test_cli_node_builders_compose_a_cluster(tmp_path, segment):
    seg_dir = tmp_path / "segments" / "s0"
    ref_persist_v2(segment, str(seg_dir))
    node, hist_srv, loaded = p_cli.build_historical(
        "h0", str(tmp_path / "segments"), port=0, device="cpu")
    assert loaded == 1 and node.device.type == "cpu"
    view, broker, http = p_cli.build_broker([hist_srv.url], port=0,
                                            device="cpu")
    try:
        rows = _post(http.port, TS)
        assert rows == RefExecutor([segment]).run_json(TS)
        assert rows[0]["result"]["n"] == segment.n_rows
        out = _post(http.port, {"query": "SELECT COUNT(*) c FROM test"},
                    "/druid/v2/sql")
        assert out[0]["c"] == segment.n_rows
    finally:
        http.stop()
        broker.stop()
        hist_srv.stop()


def _rollup_segment(datasource):
    iv = RInterval.of("2026-01-01", "2026-01-02")
    rows, card = 4096, 16
    reps = -(-rows // card)
    b = SegmentBuilder(datasource, iv, version="v0", partition=0)
    b.add_columns(
        iv.start + (np.arange(rows, dtype=np.int64) // 64),
        {"dimA": np.repeat([f"a{i:02d}" for i in range(card)],
                           reps)[:rows].tolist()},
        {"cnt": np.ones(rows, dtype=np.int64),
         "val": np.repeat((np.arange(card) * 37) % 1000, reps)[:rows]
         .astype(np.int64)})
    return b.build()


def test_historical_skips_and_logs_corrupt_segment(tmp_path, capsys):
    ref_persist_v2(_rollup_segment("good"), str(tmp_path / "s0"))
    bad_dir = str(tmp_path / "s1")
    ref_persist_v2(_rollup_segment("bad"), bad_dir)
    with open(os.path.join(bad_dir, "chunk_00000.bin"), "r+b") as f:
        f.truncate(16)
    outs = []
    for pk, kw in ((REF, {}), (PORT, {"device": "cpu"})):
        node, srv, loaded = pk.cli.build_historical(
            f"h-{pk.name}", str(tmp_path), port=0, **kw)
        try:
            assert loaded == 1
            outs.append(sorted(str(s.id) for s in node.segments()))
        finally:
            srv.stop()
        assert "skipping corrupt segment" in capsys.readouterr().err
    assert outs[1] == outs[0]


def test_node_commands_need_cuda_without_a_device(monkeypatch):
    """A node command runs on the card unless --device cpu is given:
    without a card it raises before it serves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_cli.build_historical("h0", None, port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_cli.build_broker([], port=0)


# ---------------------------------------------------------------------------
# the single-process server, on a thread and as `python -m`
# ---------------------------------------------------------------------------

def test_server_on_a_thread_stops_on_stop_event(tmp_path, segment):
    """`server` with 2 data nodes over a metadata file and a deep storage:
    its coordinator loads the published segment, the HTTP endpoint answers
    the reference executor's rows, and setting _STOP ends the command."""
    deep = LocalDeepStorage(str(tmp_path / "deep"))
    seg = _carry(segment)
    desc = deep.push(seg, descriptor_for(seg))
    md_path = str(tmp_path / "metadata.db")
    md = MetadataStore(md_path)
    md.publish_segments([desc])
    md.set_rules("_default", [{"type": "loadForever",
                               "tieredReplicants": {"_default_tier": 1}}])
    port = _free_port()
    cfg = tmp_path / "server.json"
    cfg.write_text(json.dumps({
        "metadata": {"path": md_path}, "storage": {"dir": deep.base_dir},
        "server": {"dataNodes": 2, "port": port},
        "coordinator": {"period": 0.2}}))
    rc = []
    t = threading.Thread(target=lambda: rc.append(p_cli.main(
        ["server", "--config", str(cfg), "--device", "cpu"])))
    p_cli._STOP.clear()
    t.start()
    try:
        deadline = time.time() + 60
        rows = None
        while time.time() < deadline:
            try:
                rows = _post(port, TS)
                if rows and rows[0]["result"]["n"] == segment.n_rows:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        assert rows == RefExecutor([segment]).run_json(TS)
    finally:
        p_cli._STOP.set()
        t.join(30)
        p_cli._STOP.clear()
    assert not t.is_alive() and rc == [0]


def _serve_on_threads(commands):
    """Run each argv through cli.main on a thread of its own; returns the
    threads and their return codes (appended as they end)."""
    rcs = []
    threads = [threading.Thread(target=lambda a=a: rcs.append(
        p_cli.main(a))) for a in commands]
    p_cli._STOP.clear()
    for t in threads:
        t.start()
    return threads, rcs


def _wait_for(fn, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            got = fn()
            if got:
                return got
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("not within the timeout")


def test_node_commands_on_threads_stop_on_stop_event(tmp_path, segment,
                                                     capsys):
    """historical (preloading a persisted segment), broker (over the
    historical), router (over the broker) and coordinator --ha (over the
    historical, on a metadata file) run as the CLI runs them, each on a
    thread; a query through the router equals the reference executor's
    rows, the coordinator wins its latch, and _STOP ends all four, the
    coordinator releasing its lease."""
    from druid_tpu_torch.coordination import (LeaderClient,
                                              MetadataLeaseStore)
    seg_dir = tmp_path / "segments"
    ref_persist_v2(segment, str(seg_dir / "s0"))
    hist, brok, rout = _free_port(), _free_port(), _free_port()
    md_path = str(tmp_path / "md.db")
    threads, rcs = _serve_on_threads([
        ["historical", "--port", str(hist), "--segments-dir", str(seg_dir),
         "--device", "cpu"],
        ["broker", "--port", str(brok), "--data-node",
         f"http://127.0.0.1:{hist}", "--sync-period", "0.2",
         "--device", "cpu"],
        ["router", "--port", str(rout), "--broker",
         f"http://127.0.0.1:{brok}"],
        ["coordinator", "--ha", "--metadata", md_path, "--storage-dir",
         str(tmp_path / "deep"), "--data-node", f"http://127.0.0.1:{hist}",
         "--period", "0.2", "--node-id", "c0", "--lease-ms", "3000"]])
    store = MetadataLeaseStore(MetadataStore(md_path))
    try:
        rows = _wait_for(lambda: (lambda r: r if r and r[0]["result"]["n"]
                                  else None)(_post(rout, TS)))
        assert rows == RefExecutor([segment]).run_json(TS)
        lease = _wait_for(lambda: store.read("coordinator"))
        assert lease.holder == "c0" and lease.term == 1
    finally:
        p_cli._STOP.set()
        for t in threads:
            t.join(30)
        p_cli._STOP.clear()
    assert not any(t.is_alive() for t in threads) and rcs == [0] * 4
    # released: no live leader, without waiting out the lease
    assert LeaderClient(store, "coordinator").leader() is None
    out = capsys.readouterr().out
    assert "historical [historical0] listening" in out
    assert "coordinator running" in out and "HA node [c0]" in out


def test_cli_server_subprocess_smoke(tmp_path):
    """`python -m druid_tpu_torch server` brings the single-process stack
    up through the staged Lifecycle, serves native and SQL queries, and
    ends on SIGINT with exit 0 (tests/test_aux.py's case, on the CPU)."""
    import queue
    import re
    import signal
    cfg = tmp_path / "runtime.properties"
    cfg.write_text("server.port=0\nmetadata.path=:memory:\n"
                   f"storage.dir={tmp_path}/deep\n"
                   "server.querySlots=4\nserver.lanes=reports=1\n"
                   "coordinator.period=1\n")
    p = subprocess.Popen([sys.executable, "-m", "druid_tpu_torch", "server",
                          "--config", str(cfg), "--device", "cpu"],
                         cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in p.stdout]
                         + [lines.put("")], daemon=True).start()
        seen, line = [], ""
        while True:
            line = lines.get(timeout=120)
            seen.append(line)
            if line == "" or "listening on" in line:
                break
        m = re.search(r"listening on :(\d+)", line)
        assert m, "".join(seen)
        port = int(m.group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                    timeout=30) as r:
            assert json.loads(r.read())["version"].startswith("druid-tpu")
        assert _post(port, {"query": "SELECT TABLE_NAME FROM "
                            "INFORMATION_SCHEMA.TABLES"},
                     "/druid/v2/sql") == []
        p.send_signal(signal.SIGINT)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_module_entry_runs_as_a_subprocess(persisted):
    """`python -m druid_tpu_torch` from the repository root: version and
    validate-segment exit 0 and load neither jax nor the reference."""
    for argv, want in ((["version"], p_cli.VERSION),
                       (["validate-segment", persisted], "OK: ")):
        out = subprocess.run([sys.executable, "-m", "druid_tpu_torch"]
                             + argv, cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert want in out.stdout
    code = ("import runpy, sys; sys.argv = ['druid_tpu_torch', 'version'];"
            "\ntry:\n    runpy.run_module('druid_tpu_torch', "
            "run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'druid_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
