"""The port data node's segment cache over batched runs, on the CPU: the
two cases tests/test_batching.py holds for the reference's DataNode (the
whole miss set in one batched wave, and a partial miss that mixes hits with
batched misses), on port DataNodes over the same arrays (`_carry`), with
the rows held against the reference node's; and `run_partials_group` with
a cache hit, a miss and an uncached request in one flush, each against the
request run alone."""
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.cluster import cache as ref_cache
from druid_tpu.cluster import view as ref_view
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine import batching as ref_batching
from druid_tpu.engine import engines as ref_engines
from druid_tpu.query.model import query_from_json as ref_query

from druid_tpu_torch.cluster import CacheConfig, DataNode, LruCache
from druid_tpu_torch.engine import batching, engines
from druid_tpu_torch.query.model import query_from_json
from tests.test_torch_batching import AGGS, IV, SCHEMA, _close
from tests.test_torch_slice import _carry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _batching_on(monkeypatch):
    monkeypatch.setattr(ref_batching, "_ENABLED", True)
    monkeypatch.setattr(batching, "_ENABLED", True)


def _cached_node(segs, name="n1"):
    node = DataNode(name, cache=LruCache(), device="cpu",
                    cache_config=CacheConfig(use_segment_cache=True,
                                             populate_segment_cache=True))
    for s in segs:
        node.load_segment(s)
    return node


def _plain_node(segs, name="plain"):
    node = DataNode(name, device="cpu")
    for s in segs:
        node.load_segment(s)
    return node


def _ref_rows(ref_segs, q):
    node = ref_view.DataNode("ref")
    for s in ref_segs:
        node.load_segment(s)
    ap, _ = node.run_partials(ref_query(q), [str(s.id) for s in ref_segs])
    return ref_engines.finish_timeseries(ref_query(q), ap)


def _finish(q, ap):
    return engines.finish_timeseries(query_from_json(q), ap)


def _ts(gran, aggs=AGGS, ds="mix"):
    return {"queryType": "timeseries", "dataSource": ds,
            "intervals": [str(IV)], "granularity": gran,
            "aggregations": aggs}


def test_cache_miss_set_runs_one_batched_wave():
    """The miss path computes the whole miss set through
    make_partials_by_segment: shape-compatible misses fuse into batched
    runs, the split-back entries serve later queries as hits, and the rows
    equal the uncached node's and the reference node's."""
    ref = DataGenerator(SCHEMA, seed=23).segments(6, 3000, IV,
                                                  datasource="mix")
    segs = [_carry(s) for s in ref]
    q = _ts("hour")
    node = _cached_node(segs)
    sids = [str(s.id) for s in segs]

    before = batching.stats().snapshot()
    ap_cold, served = node.run_partials(query_from_json(q), sids)
    after = batching.stats().snapshot()
    assert len(served) == 6
    assert after["batches"] > before["batches"], \
        "cold misses must go through the batched wave"
    assert node.cache.stats.misses >= 6

    hits_before = node.cache.stats.hits
    ap_warm, _ = node.run_partials(query_from_json(q), sids)
    assert node.cache.stats.hits >= hits_before + 6

    ap_plain, _ = _plain_node(segs).run_partials(query_from_json(q), sids)
    assert _finish(q, ap_cold) == _finish(q, ap_warm) == _finish(q, ap_plain)
    _close(_ref_rows(ref, q), _finish(q, ap_cold))


def test_cache_partial_miss_mixes_hits_and_batched_misses():
    """A second query over a superset: the cached segments hit, the new ones
    run in one wave; the merged rows stay exact."""
    ref = DataGenerator(SCHEMA, seed=29).segments(8, 3000, IV,
                                                  datasource="mix")
    segs = [_carry(s) for s in ref]
    q = _ts("all", [{"type": "longSum", "name": "ls",
                     "fieldName": "metLong"},
                    {"type": "doubleSum", "name": "ds",
                     "fieldName": "metDouble"}])
    node = _cached_node(segs)
    node.run_partials(query_from_json(q), [str(s.id) for s in segs[:4]])
    misses_before = node.cache.stats.misses
    hits_before = node.cache.stats.hits
    ap_all, _ = node.run_partials(query_from_json(q),
                                  [str(s.id) for s in segs])
    assert node.cache.stats.hits == hits_before + 4
    assert node.cache.stats.misses == misses_before + 4

    ap_plain, _ = _plain_node(segs).run_partials(
        query_from_json(q), [str(s.id) for s in segs])
    _close(_finish(q, ap_plain), _finish(q, ap_all))
    _close(_ref_rows(ref, q), _finish(q, ap_all))


class _ContextCacheConfig(CacheConfig):
    """Druid's `useCache` context flag on top of the query-type rule: a
    request with {"useCache": false} bypasses the segment cache."""

    def cacheable(self, query) -> bool:
        return super().cacheable(query) \
            and bool(query.context_map.get("useCache", True))


def test_group_flush_mixes_hit_miss_and_uncached():
    """One run_partials_group flush on a cached node holds a request whose
    segments are all cached (resolved without device work), a request over
    new segments (its misses run in the fused wave and split back into
    cache entries) and a request the cache does not take (fused, never
    probed or stored). Each result equals the request run alone on an
    uncached node."""
    ref = DataGenerator(SCHEMA, seed=31).segments(8, 3000, IV,
                                                  datasource="mix")
    segs = [_carry(s) for s in ref]
    sids = [str(s.id) for s in segs]
    first, second = sids[:4], sids[4:]
    q_hit = q_miss = query_from_json(_ts("hour"))
    q_unc = query_from_json(dict(_ts("hour"), context={"useCache": False}))
    node = DataNode("n1", cache=LruCache(), device="cpu",
                    cache_config=_ContextCacheConfig())
    for s in segs:
        node.load_segment(s)
    node.run_partials(q_hit, first)                # warm the cache
    stats = node.cache.stats
    hits, misses, puts = stats.hits, stats.misses, stats.puts
    fused = []
    out = node.run_partials_group(
        [(q_hit, first, None), (q_miss, second, None),
         (q_unc, sids, None)],
        on_batch=lambda nq, ns, fill: fused.append((nq, ns)))
    assert (stats.hits - hits, stats.misses - misses,
            stats.puts - puts) == (4, 4, 4)
    # the misses and the uncached request's segments share the fused wave
    assert sum(ns for _, ns in fused) == 4 + 8
    assert any(nq == 2 for nq, _ in fused)

    plain = _plain_node(segs)
    for (q, want_sids), (ap, served) in zip(
            ((q_hit, first), (q_miss, second), (q_unc, sids)), out):
        assert served == set(want_sids)
        want, _ = plain.run_partials(q, want_sids)
        _close(engines.finish_timeseries(q, want),
               engines.finish_timeseries(q, ap))
    # the split-back misses serve the next run as hits
    hits = stats.hits
    node.run_partials(q_miss, second)
    assert stats.hits == hits + 4


def test_dead_node_group_fails_every_request():
    segs = [_carry(s) for s in DataGenerator(SCHEMA, seed=37).segments(
        2, 500, IV, datasource="mix")]
    node = _plain_node(segs)
    node.alive = False
    out = node.run_partials_group([(query_from_json(_ts("all")),
                                    [str(s.id) for s in segs], None)] * 2)
    assert all(isinstance(e, ConnectionError) for e in out)


def test_query_cache_key_ignores_context_in_both_packages():
    q = _ts("hour")
    a = query_from_json(dict(q, context={"queryId": "a"}))
    b = query_from_json(dict(q, context={"queryId": "b", "priority": 3}))
    from druid_tpu_torch.cluster.cache import query_cache_key
    assert query_cache_key(a) == query_cache_key(b)
    assert ref_cache.query_cache_key(ref_query(dict(q, context={"x": 1}))) \
        == query_cache_key(a)
