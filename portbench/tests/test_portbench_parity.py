"""The reference's answers equal the port's (device "cpu") for every
query of every mix, over the broker of two data nodes at a tiny scale."""
import pytest

from portbench import harness, reference, registry

MIXES = registry.mixes()


@pytest.fixture(scope="module")
def clusters():
    """One broker a configuration, over its tiny segments."""
    made = {}

    def get(name):
        if name not in made:
            cfg = registry.config(name)
            cfg["scale_factor"] = 0.002
            segs, _, _, _ = harness.make_segments(cfg, 2 ** 32 + 5, "cpu")
            made[name] = (cfg, harness.Program(segs, "cpu"))
        return made[name]
    yield get
    for _, prog in made.values():
        prog.stop()


def _config_of(mix):
    for name in registry.configs():
        if registry.config(name)["datasource"] == mix["datasource"]:
            return name
    raise LookupError(mix["datasource"])


@pytest.mark.parametrize("mix_name", MIXES)
def test_reference_equals_port(mix_name, clusters):
    mix = registry.mix(mix_name)
    cfg, prog = clusters(_config_of(mix))
    queries = [q["query"] for q in mix["queries"]]
    want = reference.answers(cfg, queries, 2 ** 32 + 5, "cpu")
    # at this scale the narrowest (Q3.3, Q3.4) may hold no row at all
    assert sum(bool(w) for w in want) >= len(want) - 2
    for q, w in zip(queries, want):
        got = reference.normalize(q, prog.broker.run_json(q))
        v = reference.compare(got, w)
        assert (v.keys_wrong, v.exact_wrong) == (0, 0), q
        assert v.rel_err <= 1e-12, q


def test_compare_finds_each_kind_of_fault():
    want = {(0, "a"): {"n": 5, "x": 2.0}, (0, "b"): {"n": 1, "x": 1.0}}
    assert reference.compare(want, want) == reference.Verdict()
    v = reference.compare({(0, "a"): {"n": 5, "x": 2.0}}, want)
    assert v.keys_wrong == 1
    v = reference.compare({(0, "a"): {"n": 6, "x": 2.0},
                           (0, "b"): {"n": 1, "x": 1.0 + 1e-6}}, want)
    assert v.exact_wrong == 1 and abs(v.rel_err - 1e-6) < 1e-12
