"""The harness finds configurations, mixes and metrics by name: a new
one is a new file, and no file that exists is edited."""
import json
import shutil

from portbench import registry


def test_every_cell_resolves():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cfg = registry.config(w["config"])
        mix = registry.mix(w["traffic"])
        assert cfg["datasource"] == mix["datasource"]
        assert (registry.HERE / "gen" / f"{cfg['generator']}.py").exists()
        for trace in (False, True):
            for m in registry.metrics_of(bench, w["name"], trace):
                assert callable(registry.reader(m["name"]).read)
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"


def test_a_new_mix_and_metric_are_new_files(tmp_path, monkeypatch):
    copy = tmp_path / "portbench"
    for d in ("configs", "mixes", "metrics"):
        shutil.copytree(registry.HERE / d, copy / d)
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    monkeypatch.setattr(registry, "HERE", copy)
    dummy = {"name": "ssb-dummy", "datasource": "lineorder", "clients": 1,
             "queries": [{"name": "count", "query": {
                 "queryType": "timeseries", "dataSource": "lineorder",
                 "intervals": ["1992-01-01/1993-01-01"],
                 "granularity": "all",
                 "aggregations": [{"type": "count", "name": "rows"}]}}]}
    (copy / "mixes" / "ssb-dummy.json").write_text(json.dumps(dummy))
    (copy / "metrics" / "queries_answered.py").write_text(
        "def read(run):\n    return len(run.completed())\n")
    assert "ssb-dummy" in registry.mixes()
    assert registry.mix("ssb-dummy") == dummy
    assert registry.reader("queries_answered").read.__name__ == "read"
    # a dotted name without a file of its own is read by its first part
    assert registry.metric_path("queries_answered.ssb-sf20.dummy") == \
        copy / "metrics" / "queries_answered.py"
    assert all(p.read_bytes() == b for p, b in before.items())


def test_cells_match_their_layouts():
    """A cell asks for as many chips as its configuration's layout holds,
    and the layout can be built on them."""
    from portbench import harness
    for w in registry.benchmark()["workloads"]:
        cfg = registry.config(w["config"])
        layout = harness.Layout.of(cfg, w["chips"])
        assert layout.chips == w["chips"], w["name"]


def test_each_per_layer_metric_moves_what_its_cells_report():
    """A per-layer metric's `moves` is an end-to-end metric that every
    cell it lists reports."""
    bench = registry.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            reported = {e["name"] for e in registry.metrics_of(bench, cell,
                                                               False)}
            assert m["moves"] in reported, (m["name"], cell)
