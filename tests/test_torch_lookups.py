"""The port's cluster lookups (druid_tpu_torch/cluster/lookups.py: the
coordinator's LookupCoordinatorManager and the nodes' LookupNodeSync over
the port's lookup registry) and the URI namespace loader
(druid_tpu_torch/ext/namespace_lookup.py, `load_uri_namespace`) against
the reference package's, on the CPU.

The lookup cases of tests/test_router_security.py and the seven URI
namespace cases of tests/test_extensions.py run as scenarios through BOTH
packages over the same local files (written by the test): the reference's
assertions hold in each, and what each observes (poll counts, the
registry's snapshot of names, versions and maps, loader output and error
messages, query rows through a registeredLookup extraction) is equal
between the two, exactly.
"""
import json
import time
from types import SimpleNamespace

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster as r_cluster
import druid_tpu.cluster.lookups as r_lookups
import druid_tpu.ext as r_ext
import druid_tpu.query.lookup as r_qlookup
from druid_tpu.engine import QueryExecutor as RefExecutor

import druid_tpu_torch.cluster as p_cluster
import druid_tpu_torch.cluster.lookups as p_lookups
import druid_tpu_torch.ext as p_ext
import druid_tpu_torch.query.lookup as p_qlookup
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from tests.test_torch_slice import _carry

torch.set_num_threads(1)


def _pkg(ref: bool):
    if ref:
        return SimpleNamespace(
            name="ref", C=r_cluster, LK=r_lookups, ext=r_ext, Q=r_qlookup,
            executor=lambda segs: RefExecutor(segs))
    return SimpleNamespace(
        name="port", C=p_cluster, LK=p_lookups, ext=p_ext, Q=p_qlookup,
        executor=lambda segs: PortExecutor(segs, device="cpu"))


REF, PORT = _pkg(True), _pkg(False)


@pytest.fixture
def both(tmp_path):
    """both(fn) runs fn(pkg, dir) for each package (dir: a fresh directory
    of its own, the same name under each); asserts the observations equal
    (the directory's path replaced) and returns the port's."""
    def run(fn):
        out = []
        for pk in (REF, PORT):
            d = tmp_path / pk.name
            d.mkdir()
            out.append(json.loads(json.dumps(fn(pk, d)).replace(
                str(d), "<dir>")))
        assert out[1] == out[0]
        return out[1]
    return run


def manager(pk):
    return pk.LK.LookupCoordinatorManager(pk.C.MetadataStore())


def snap(reg):
    return sorted((e["name"], e["version"], e["map"])
                  for e in reg.snapshot())


# ---------------------------------------------------------------------------
# tests/test_router_security.py: lookup cases
# ---------------------------------------------------------------------------

def test_lookup_version_ordering_past_v9(both):
    def run(pk, _):
        reg = pk.Q.LookupReferencesManager()
        for i in range(12):
            assert reg.add("x", {"n": str(i)}, version=f"v{i}")
        assert reg.get("x").mapping == {"n": "11"}
        assert not reg.add("x", {"n": "stale"}, version="v9")
        return snap(reg)
    both(run)


def test_lookup_coordinator_push_and_node_sync(both):
    def run(pk, _):
        mgr = manager(pk)
        out = [mgr.set_lookup("_default", "country_names",
                              {"us": "United States"})]
        reg = pk.Q.LookupReferencesManager()
        sync = pk.LK.LookupNodeSync(mgr, "_default", reg)
        assert sync.poll() == 1
        assert reg.get("country_names").mapping == {"us": "United States"}
        assert sync.poll() == 0
        out.append(mgr.set_lookup("_default", "country_names",
                                  {"us": "USA", "fr": "France"}))
        assert sync.poll() == 1
        assert reg.get("country_names").mapping["fr"] == "France"
        out.append(snap(reg))
        mgr.delete_lookup("_default", "country_names")
        assert sync.poll() == 1
        assert reg.get("country_names") is None
        mgr.set_lookup("_default", "x", {"1": "one"})
        reg2 = pk.Q.LookupReferencesManager()
        assert pk.LK.LookupNodeSync(mgr, "_default", reg2).poll() == 1
        assert reg2.get("x").mapping == {"1": "one"}
        out += [snap(reg), snap(reg2), mgr.get_tier("_default")]
        return out
    both(run)


def test_lookup_tiers_are_isolated(both):
    def run(pk, _):
        mgr = manager(pk)
        mgr.set_lookup("hot", "a", {"k": "hotval"})
        mgr.set_lookup("cold", "a", {"k": "coldval"})
        hot_reg = pk.Q.LookupReferencesManager()
        cold_reg = pk.Q.LookupReferencesManager()
        pk.LK.LookupNodeSync(mgr, "hot", hot_reg).poll()
        pk.LK.LookupNodeSync(mgr, "cold", cold_reg).poll()
        assert hot_reg.get("a").mapping == {"k": "hotval"}
        assert cold_reg.get("a").mapping == {"k": "coldval"}
        assert mgr.tiers() == ["cold", "hot"]
        return snap(hot_reg), snap(cold_reg), mgr.tiers()
    both(run)


# ---------------------------------------------------------------------------
# tests/test_extensions.py: URI namespace lookups
# ---------------------------------------------------------------------------

def test_uri_namespace_lookup_sync_and_repoll(both):
    def run(pk, d):
        path = d / "map.json"
        path.write_text(json.dumps({"a": "Alpha", "b": "Beta"}))
        mgr = manager(pk)
        mgr.set_namespace_lookup("_default", "codes", {
            "type": "uri", "uri": f"file://{path}",
            "namespaceParseSpec": {"format": "json"}, "pollPeriod": 0.05})
        reg = pk.Q.LookupReferencesManager()
        sync = pk.LK.LookupNodeSync(mgr, "_default", reg)
        out = []
        assert sync.poll() == 1
        assert reg.get("codes").mapping == {"a": "Alpha", "b": "Beta"}
        out.append(snap(reg))
        path.write_text(json.dumps({"a": "Alpha", "c": "Gamma"}))
        time.sleep(0.06)
        assert sync.poll() == 1
        assert reg.get("codes").mapping == {"a": "Alpha", "c": "Gamma"}
        out.append(snap(reg))
        path.write_text("{not json")
        time.sleep(0.06)
        assert sync.poll() == 0
        assert reg.get("codes").mapping == {"a": "Alpha", "c": "Gamma"}
        path.write_text(json.dumps({"z": "Zed"}))
        mgr.set_namespace_lookup("_default", "codes", {
            "type": "uri", "uri": f"file://{path}",
            "namespaceParseSpec": {"format": "json"}, "pollPeriod": 3600})
        assert sync.poll() == 1
        assert reg.get("codes").mapping == {"z": "Zed"}
        out.append(snap(reg))
        mgr.delete_lookup("_default", "codes")
        assert sync.poll() == 1
        assert reg.get("codes") is None
        return out
    both(run)


def test_uri_namespace_csv_and_customjson(both):
    def run(pk, d):
        c = d / "m.csv"
        c.write_text("code,name\nus,United States\nde,Germany\n")
        got = pk.ext.load_uri_namespace(
            {"uri": str(c), "namespaceParseSpec": {"format": "csv"}})
        assert got == {"us": "United States", "de": "Germany"}
        t = d / "m.tsv"
        t.write_text("code\tname\nfr\tFrance\n")
        got_tsv = pk.ext.load_uri_namespace(
            {"uri": str(t), "namespaceParseSpec": {"format": "tsv"}})
        j = d / "m.json"
        j.write_text(json.dumps([{"k": "x", "v": "X"}, {"k": "y", "v": "Y"}]))
        got_j = pk.ext.load_uri_namespace({
            "uri": f"file://{j}", "namespaceParseSpec": {
                "format": "customJson", "keyFieldName": "k",
                "valueFieldName": "v"}})
        assert got_j == {"x": "X", "y": "Y"}
        return got, got_tsv, got_j
    both(run)


@pytest.fixture(scope="module")
def lookup_segment(generator):
    from druid_tpu.utils.intervals import Interval
    return generator.segment(3000, Interval.of("2026-01-01", "2026-01-02"),
                             datasource="test")


def test_uri_namespace_lookup_queryable(both, lookup_segment):
    vals = list(lookup_segment.dims["dimA"].dictionary.values)

    def run(pk, d):
        seg = lookup_segment if pk is REF else _carry(lookup_segment)
        path = d / "dimmap.json"
        path.write_text(json.dumps({vals[0]: "FIRST"}))
        mgr = manager(pk)
        mgr.set_namespace_lookup("_default", "dimmap", {
            "type": "uri", "uri": str(path),
            "namespaceParseSpec": {"format": "json"}})
        pk.LK.LookupNodeSync(mgr, "_default", pk.Q.lookup_manager()).poll()
        try:
            rows = pk.executor([seg]).run_json({
                "queryType": "groupBy", "dataSource": "test",
                "intervals": ["2026-01-01/2026-01-02"],
                "granularity": "all",
                "dimensions": [{"type": "extraction", "dimension": "dimA",
                                "outputName": "d",
                                "extractionFn": {
                                    "type": "registeredLookup",
                                    "lookup": "dimmap",
                                    "retainMissingValue": True}}],
                "aggregations": [{"type": "count", "name": "n"}]})
            got = {r["event"]["d"] for r in rows}
            assert "FIRST" in got and vals[0] not in got
        finally:
            pk.Q.lookup_manager().remove("dimmap")
        return rows
    both(run)


def test_namespace_to_map_conversion_and_foreign_lookups(both):
    def run(pk, d):
        path = d / "m.json"
        path.write_text(json.dumps({"a": "FromUri"}))
        mgr = manager(pk)
        mgr.set_namespace_lookup("_default", "conv", {
            "type": "uri", "uri": str(path),
            "namespaceParseSpec": {"format": "json"}})
        reg = pk.Q.LookupReferencesManager()
        reg.add("local_only", {"k": "v"}, version="v0")
        sync = pk.LK.LookupNodeSync(mgr, "_default", reg)
        sync.poll()
        assert reg.get("conv").mapping == {"a": "FromUri"}
        out = [snap(reg)]
        mgr.set_lookup("_default", "conv", {"a": "Inline"})
        sync.poll()
        assert reg.get("conv").mapping == {"a": "Inline"}
        assert reg.get("local_only") is not None
        out.append(snap(reg))
        path.write_text(json.dumps({"a": "Reloaded"}))
        mgr.set_namespace_lookup("_default", "conv", {
            "type": "uri", "uri": str(path),
            "namespaceParseSpec": {"format": "json"}, "pollPeriod": 0.01})
        sync.poll()
        time.sleep(0.02)
        sync2 = pk.LK.LookupNodeSync(mgr, "_default", reg)
        path.write_text(json.dumps({"a": "Reloaded2"}))
        assert sync2.poll() == 1
        assert reg.get("conv").mapping == {"a": "Reloaded2"}
        out.append(snap(reg))
        return out
    both(run)


def test_customjson_object_payload_is_a_failure(both):
    def run(pk, d):
        p = d / "bad.json"
        p.write_text('{"x": "X"}')
        with pytest.raises(ValueError, match="list of objects") as ei:
            pk.ext.load_uri_namespace({"uri": str(p), "namespaceParseSpec": {
                "format": "customJson", "keyFieldName": "k",
                "valueFieldName": "v"}})
        with pytest.raises(ValueError) as ei2:
            pk.ext.load_uri_namespace({"uri": "s3://bucket/map.json"})
        return str(ei.value), str(ei2.value)
    both(run)


def test_recreated_sync_still_deletes_map_lookups(both):
    def run(pk, d):
        assert pk.LK._period_seconds("PT5M") == 300.0
        assert pk.LK._period_seconds(2.5) == 2.5
        assert pk.LK._period_seconds("garbage") == 0.0
        mgr = manager(pk)
        mgr.set_lookup("_default", "m", {"a": "1"})
        reg = pk.Q.LookupReferencesManager()
        pk.LK.LookupNodeSync(mgr, "_default", reg).poll()
        assert reg.get("m") is not None
        sync2 = pk.LK.LookupNodeSync(mgr, "_default", reg)
        sync2.poll()
        mgr.delete_lookup("_default", "m")
        assert sync2.poll() == 1
        assert reg.get("m") is None
        reg.add("mine", {"k": "v"}, version="1.2+build7")
        sync2.poll()
        assert reg.get("mine") is not None
        p = d / "n.json"
        p.write_text(json.dumps({"x": "X"}))
        mgr.set_namespace_lookup("_default", "ns", {
            "type": "uri", "uri": str(p),
            "namespaceParseSpec": {"format": "json"}, "pollPeriod": 0.01})
        assert sync2.poll() == 1
        v1 = reg.get("ns").version
        time.sleep(0.02)
        assert sync2.poll() == 0
        assert reg.get("ns").version == v1
        return snap(reg)
    both(run)


def test_local_lookup_with_conflicting_name_never_deleted(both):
    def run(pk, d):
        mgr = manager(pk)
        reg = pk.Q.LookupReferencesManager()
        reg.add("x", {"local": "yes"}, version="zzzzzzzzzzzz")
        mgr.set_lookup("_default", "x", {"coord": "yes"}, version="v1")
        sync = pk.LK.LookupNodeSync(mgr, "_default", reg)
        sync.poll()
        assert reg.get("x").mapping == {"local": "yes"}
        mgr.delete_lookup("_default", "x")
        sync.poll()
        assert reg.get("x") is not None
        p = d / "ns.json"
        p.write_text(json.dumps({"a": "A"}))
        reg.add("y", {"loc": "1"}, version="1.2+build7")
        mgr.set_namespace_lookup("_default", "y", {
            "type": "uri", "uri": str(p),
            "namespaceParseSpec": {"format": "json"}, "pollPeriod": 0.01},
            version="1.2")
        sync.poll()
        assert reg.get("y").mapping == {"loc": "1"}
        mgr.delete_lookup("_default", "y")
        sync.poll()
        assert reg.get("y") is not None
        p2 = d / "same.json"
        p2.write_text(json.dumps({"k": "FromUri"}))
        mgr.set_namespace_lookup("_default", "same", {
            "type": "uri", "uri": str(p2),
            "namespaceParseSpec": {"format": "json"}}, version="v7")
        sync.poll()
        assert reg.get("same").mapping == {"k": "FromUri"}
        mgr.set_lookup("_default", "same", {"k": "Inline"}, version="v7")
        sync.poll()
        assert reg.get("same").mapping == {"k": "Inline"}
        return snap(reg)
    both(run)


def test_map_spec_with_plus_version_converges(both):
    def run(pk, _):
        mgr = manager(pk)
        mgr.set_lookup("_default", "x", {"a": "1"}, version="1.0+hotfix")
        reg = pk.Q.LookupReferencesManager()
        sync = pk.LK.LookupNodeSync(mgr, "_default", reg)
        polls = [sync.poll(), sync.poll(), sync.poll()]
        assert polls == [1, 0, 0]
        assert reg.get("x").mapping == {"a": "1"}
        return polls, snap(reg)
    both(run)
