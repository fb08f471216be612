"""The timeline MVCC and the shard specs, in both packages: each case of
tests/test_timeline.py runs once over the reference's
`cluster/timeline.py` and `cluster/shardspec.py` and once over the port's
copies (`druid_tpu_torch/cluster/`), with the same intervals, versions and
specs."""
import types

import pytest

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.cluster import shardspec as ref_shardspec
from druid_tpu.cluster import timeline as ref_timeline
from druid_tpu.utils import intervals as ref_intervals

from druid_tpu_torch.cluster import shardspec as port_shardspec
from druid_tpu_torch.cluster import timeline as port_timeline
from druid_tpu_torch.utils import intervals as port_intervals


def _pkg(tl, ss, iv):
    return types.SimpleNamespace(
        VersionedIntervalTimeline=tl.VersionedIntervalTimeline,
        PartitionChunk=tl.PartitionChunk, Interval=iv.Interval,
        NoneShardSpec=ss.NoneShardSpec,
        NumberedShardSpec=ss.NumberedShardSpec,
        HashBasedNumberedShardSpec=ss.HashBasedNumberedShardSpec,
        SingleDimensionShardSpec=ss.SingleDimensionShardSpec,
        shardspec_from_json=ss.shardspec_from_json)


PACKAGES = {"reference": _pkg(ref_timeline, ref_shardspec, ref_intervals),
            "port": _pkg(port_timeline, port_shardspec, port_intervals)}


@pytest.fixture(params=sorted(PACKAGES))
def P(request):
    return PACKAGES[request.param]


def IV(P, a, b):
    return P.Interval.of(f"2026-01-{a:02d}", f"2026-01-{b:02d}")


def chunk(P, obj, spec=None):
    return P.PartitionChunk(spec or P.NoneShardSpec(), obj)


def lookup_objs(tl, iv):
    return [(str(h.interval), h.version, sorted(h.payloads()))
            for h in tl.lookup(iv)]


def test_basic_add_lookup(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 2), "v1", chunk(P, "a"))
    tl.add(IV(P, 2, 3), "v1", chunk(P, "b"))
    out = tl.lookup(IV(P, 1, 3))
    assert [h.payloads() for h in out] == [["a"], ["b"]]
    # clipping to query interval
    out = tl.lookup(P.Interval.of("2026-01-01T06:00:00Z", "2026-01-02"))
    assert len(out) == 1 and out[0].payloads() == ["a"]
    assert out[0].interval == P.Interval.of("2026-01-01T06:00:00Z",
                                            "2026-01-02")


def test_higher_version_overshadows(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 3), "v1", chunk(P, "old"))
    tl.add(IV(P, 1, 3), "v2", chunk(P, "new"))
    assert lookup_objs(tl, IV(P, 1, 3)) == [
        ("2026-01-01T00:00:00.000Z/2026-01-03T00:00:00.000Z", "v2", ["new"])]
    # removing v2 resurrects v1
    tl.remove(IV(P, 1, 3), "v2", 0)
    assert lookup_objs(tl, IV(P, 1, 3)) == [
        ("2026-01-01T00:00:00.000Z/2026-01-03T00:00:00.000Z", "v1", ["old"])]


def test_partial_overshadow_splits(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 5), "v1", chunk(P, "wide"))
    tl.add(IV(P, 2, 3), "v2", chunk(P, "narrow"))
    assert lookup_objs(tl, IV(P, 1, 5)) == [
        ("2026-01-01T00:00:00.000Z/2026-01-02T00:00:00.000Z", "v1", ["wide"]),
        ("2026-01-02T00:00:00.000Z/2026-01-03T00:00:00.000Z", "v2",
         ["narrow"]),
        ("2026-01-03T00:00:00.000Z/2026-01-05T00:00:00.000Z", "v1", ["wide"]),
    ]


def test_incomplete_partition_set_invisible(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 2), "v2", chunk(P, "p0", P.NumberedShardSpec(0, 2)))
    tl.add(IV(P, 1, 2), "v1", chunk(P, "whole"))
    # v2 has 1 of 2 partitions: invisible, v1 shows
    assert lookup_objs(tl, IV(P, 1, 2))[0][1] == "v1"
    tl.add(IV(P, 1, 2), "v2", chunk(P, "p1", P.NumberedShardSpec(1, 2)))
    out = tl.lookup(IV(P, 1, 2))
    assert out[0].version == "v2"
    assert sorted(out[0].payloads()) == ["p0", "p1"]
    # incomplete entries visible through lookup_with_incomplete
    tl2 = P.VersionedIntervalTimeline()
    tl2.add(IV(P, 1, 2), "v1", chunk(P, "x", P.NumberedShardSpec(0, 3)))
    assert tl2.lookup(IV(P, 1, 2)) == []
    assert len(tl2.lookup_with_incomplete(IV(P, 1, 2))) == 1


def test_is_overshadowed_and_find_fully(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 3), "v1", chunk(P, "old"))
    tl.add(IV(P, 1, 2), "v2", chunk(P, "n1"))
    assert not tl.is_overshadowed(IV(P, 1, 3), "v1")  # only half covered
    tl.add(IV(P, 2, 3), "v3", chunk(P, "n2"))
    assert tl.is_overshadowed(IV(P, 1, 3), "v1")      # v2 + v3 cover it
    assert [h.version for h in tl.find_fully_overshadowed()] == ["v1"]
    # newer versions are not overshadowed
    assert not tl.is_overshadowed(IV(P, 1, 2), "v2")


def test_version_comparison_is_lexicographic(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 2), "2026-01-01T00:00:00Z", chunk(P, "older"))
    tl.add(IV(P, 1, 2), "2026-01-02T00:00:00Z", chunk(P, "newer"))
    assert tl.lookup(IV(P, 1, 2))[0].payloads() == ["newer"]


def test_adjacent_same_entry_merges(P):
    tl = P.VersionedIntervalTimeline()
    tl.add(IV(P, 1, 5), "v1", chunk(P, "w"))
    assert len(tl.lookup(IV(P, 1, 5))) == 1


def test_numbered_shardspec_completeness(P):
    s0, s1 = P.NumberedShardSpec(0, 2), P.NumberedShardSpec(1, 2)
    assert not s0.complete_set([s0])
    assert s0.complete_set([s0, s1])
    # open-ended (streaming) sets are always complete
    assert P.NumberedShardSpec(3, 0).complete_set([P.NumberedShardSpec(3, 0)])


def test_hashed_shardspec_routing_and_pruning(P):
    specs = [P.HashBasedNumberedShardSpec(i, 4, ("user",)) for i in range(4)]
    counts = [0] * 4
    for i in range(100):
        owners = [s for s in specs if s.is_in_chunk({"user": f"u{i}"})]
        assert len(owners) == 1  # exactly one shard owns each row
        counts[owners[0].partition_num] += 1
    assert all(c > 10 for c in counts)  # roughly balanced
    # pruning: a pinned value hits exactly one shard
    possible = [s for s in specs if s.possible_in_domain({"user": ["u7"]})]
    assert len(possible) == 1
    assert possible[0].is_in_chunk({"user": "u7"})
    # unconstrained dim: no pruning
    assert all(s.possible_in_domain({}) for s in specs)


def test_single_dimension_shardspec(P):
    a = P.SingleDimensionShardSpec("d", None, "m", 0)
    b = P.SingleDimensionShardSpec("d", "m", None, 1)
    assert a.is_in_chunk({"d": "apple"})
    assert not a.is_in_chunk({"d": "zebra"})
    assert b.is_in_chunk({"d": "zebra"})
    assert a.complete_set([a, b])
    assert not a.complete_set([a])
    gap = P.SingleDimensionShardSpec("d", "x", None, 1)
    assert not a.complete_set([a, gap])
    assert a.possible_in_domain({"d": ["apple"]})
    assert not a.possible_in_domain({"d": ["zebra"]})


def test_shardspec_json_roundtrip(P):
    for s in [P.NoneShardSpec(), P.NumberedShardSpec(1, 3),
              P.HashBasedNumberedShardSpec(2, 4, ("a", "b")),
              P.SingleDimensionShardSpec("d", "a", "b", 1)]:
        assert P.shardspec_from_json(s.to_json()) == s


def test_hash_routing_agrees_across_packages():
    """The same row lands in the same hashed shard in both packages (the
    broker's pruning must agree with where ingestion put the row)."""
    ref = [PACKAGES["reference"].HashBasedNumberedShardSpec(i, 5, ("a", "b"))
           for i in range(5)]
    port = [PACKAGES["port"].HashBasedNumberedShardSpec(i, 5, ("a", "b"))
            for i in range(5)]
    for i in range(200):
        row = {"a": f"x{i % 13}", "b": None if i % 7 == 0 else f"y{i}"}
        assert [s.is_in_chunk(row) for s in ref] \
            == [s.is_in_chunk(row) for s in port]
