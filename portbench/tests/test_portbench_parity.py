"""The reference's answers equal the port's (device "cpu") for every
query of every mix, over the broker of two data nodes at a tiny scale:
as the configurations place them, and with each node sharding its
aggregates over a mesh of two CPU shards (a layout of 4 cards)."""
import pytest

from portbench import harness, reference, registry

MIXES = registry.mixes()
#: 4 cards, 2 data nodes, each sharding over a mesh of 2
MESHED = {"chips": 4, "data_nodes": 2, "mesh": 2}


@pytest.fixture(scope="module")
def clusters():
    """One broker a configuration and layout, over its tiny segments."""
    made = {}

    def get(name, layout):
        key = (name, str(layout))
        if key not in made:
            cfg = registry.config(name)
            cfg["scale_factor"] = 0.002
            if layout is not None:
                cfg["layout"] = layout
            segs, _, _, _ = harness.make_segments(cfg, 2 ** 32 + 5, "cpu")
            made[key] = (cfg, harness.Program(segs, "cpu",
                                              harness.Layout.of(cfg)))
        return made[key]
    yield get
    for _, prog in made.values():
        prog.stop()


def _config_of(mix):
    for name in registry.configs():
        if registry.config(name)["datasource"] == mix["datasource"]:
            return name
    raise LookupError(mix["datasource"])


@pytest.mark.parametrize("mix_name,layout", [
    pytest.param(m, lay, id=m + suffix) for suffix, lay in
    (("", None), ("-mesh2-of-4", MESHED)) for m in MIXES])
def test_reference_equals_port(mix_name, layout, clusters):
    from druid_tpu_torch.parallel.distributed import sharded_stats
    mix = registry.mix(mix_name)
    cfg, prog = clusters(_config_of(mix), layout)
    assert [n.mesh is not None for n in prog.nodes] == \
        [layout is not None] * 2
    queries = [q["query"] for q in mix["queries"]]
    want = reference.answers(cfg, queries, 2 ** 32 + 5, "cpu")
    # at this scale the narrowest (Q3.3, Q3.4) may hold no row at all
    assert sum(bool(w) for w in want) >= len(want) - 2
    sharded = sharded_stats().snapshot()[0]
    for q, w in zip(queries, want):
        got = reference.normalize(q, prog.broker.run_json(q))
        v = reference.compare(got, w)
        assert (v.keys_wrong, v.exact_wrong) == (0, 0), q
        assert v.rel_err <= 1e-12, q
    if layout is not None and mix_name == "tpch-timeseries":
        # TPC-H's full scans take the sharded run; at this scale SSB's
        # dictionaries differ from week to week, and its queries do not
        assert sharded_stats().snapshot()[0] > sharded


def test_compare_finds_each_kind_of_fault():
    want = {(0, "a"): {"n": 5, "x": 2.0}, (0, "b"): {"n": 1, "x": 1.0}}
    assert reference.compare(want, want) == reference.Verdict()
    v = reference.compare({(0, "a"): {"n": 5, "x": 2.0}}, want)
    assert v.keys_wrong == 1
    v = reference.compare({(0, "a"): {"n": 6, "x": 2.0},
                           (0, "b"): {"n": 1, "x": 1.0 + 1e-6}}, want)
    assert v.exact_wrong == 1 and abs(v.rel_err - 1e-6) < 1e-12
