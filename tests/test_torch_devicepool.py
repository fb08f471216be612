"""The port's byte-budgeted device pool (druid_tpu_torch/data/devicepool.py),
the counterparts of tests/test_devicepool.py that apply to it, on the CPU:
entry bytes, pooled and counted staging, LRU eviction by bytes and
restaging (rows unchanged), a single oversized entry, 0 as unbounded, a
segment's collection purging its entries, the finalizer that never takes
the lock, a purge during a build, `clear` keeping owners cacheable, and
packed entries counted compressed. Every segment's device data goes through
the pool: the segment has no device dict of its own.
"""
import gc

import numpy as np
import pytest
import torch

from druid_tpu_torch.data import devicepool, packed
from druid_tpu_torch.data.devicepool import (DeviceSegmentPool, entry_bytes,
                                             entry_logical_bytes)
from druid_tpu_torch.data.generator import ColumnSpec, DataGenerator
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.engine import batching
from druid_tpu_torch.engine.contracts import (DEVICE_POOL_BUDGET_BYTES,
                                              DEVICE_POOL_BUDGET_SHARE)
from druid_tpu_torch.utils.intervals import Interval

torch.set_num_threads(1)

IV = Interval.of("2026-04-01", "2026-04-02")
SCHEMA = (ColumnSpec("dimA", "string", cardinality=5),
          ColumnSpec("metLong", "long", low=0, high=50))


@pytest.fixture
def fresh_pool(monkeypatch):
    """An isolated pool; segments built after this bind to it."""
    pool = DeviceSegmentPool(budget_bytes=1 << 40)
    monkeypatch.setattr(devicepool, "_POOL", pool)
    return pool


def _segments(n, rows=2000, seed=5):
    return DataGenerator(SCHEMA, seed=seed).segments(
        n, rows, IV, datasource="pool")


COUNT_Q = {"queryType": "timeseries", "dataSource": "pool",
           "intervals": [str(IV)], "granularity": "all",
           "aggregations": [{"type": "count", "name": "n"},
                            {"type": "longSum", "name": "s",
                             "fieldName": "metLong"}]}

#: an hourly groupBy: blocks, and rows that differ per group
GROUP_Q = {"queryType": "groupBy", "dataSource": "pool",
           "intervals": [str(IV)], "granularity": "hour",
           "dimensions": ["dimA"],
           "aggregations": [{"type": "count", "name": "n"},
                            {"type": "longSum", "name": "s",
                             "fieldName": "metLong"},
                            {"type": "longMax", "name": "m",
                             "fieldName": "metLong"}]}


def _ex(segs):
    return QueryExecutor(segs, device="cpu")


def test_entry_bytes_accounts_tensors():
    a = torch.zeros(100, dtype=torch.int32)
    assert entry_bytes(a) == 400
    assert entry_bytes({"x": a, "y": a}) == 800
    assert entry_bytes((a, [a, a])) == 1200
    assert entry_bytes(None) == 0
    assert entry_bytes(torch.zeros((7, 16), dtype=torch.int8)) == 112

    class FakeBlock:
        arrays = {"c": torch.zeros(10, dtype=torch.int64)}
    assert entry_bytes(FakeBlock()) == 80


def test_block_bytes_match_the_pool(fresh_pool):
    """A staged block counts what its tensors hold, as the block reports."""
    seg = _segments(1)[0]
    block = seg.device_block(["dimA", "metLong"], torch.device("cpu"))
    s = fresh_pool.snapshot()
    assert s.entries == 1
    assert s.resident_bytes == entry_bytes(block) == block.resident_nbytes
    assert s.logical_bytes == block.logical_nbytes


def test_staging_is_pooled_and_counted(fresh_pool):
    segs = _segments(2)
    ex = _ex(segs)
    r1 = ex.run_json(COUNT_Q)
    s1 = fresh_pool.snapshot()
    assert s1.misses > 0 and s1.resident_bytes > 0
    r2 = ex.run_json(COUNT_Q)
    s2 = fresh_pool.snapshot()
    assert r1 == r2
    assert s2.hits > s1.hits, "a repeated query must hit the pooled blocks"
    assert s2.misses == s1.misses, "a repeated query must not restage"
    for seg in segs:
        assert not hasattr(seg, "_device_cache")
        assert any(k[0] == "block" for k in seg.device_entries())


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "per_segment"])
def test_byte_budget_evicts_lru_and_restages(fresh_pool, batched,
                                             monkeypatch):
    monkeypatch.setattr(batching, "_ENABLED", batched)
    segs = _segments(6, rows=4000)
    ex = _ex(segs)
    before = ex.run_json(GROUP_Q)
    baseline = fresh_pool.snapshot()
    per_entry = baseline.resident_bytes // max(baseline.entries, 1)
    # room for ~2 entries: the rest must go, and the budget holds
    budget = int(per_entry * 2.5)
    fresh_pool.configure(budget)
    s = fresh_pool.snapshot()
    assert s.resident_bytes <= budget
    assert s.evicted_bytes > 0 and s.evictions > 0
    # evicted blocks restage, and the rows stay the same
    after = ex.run_json(GROUP_Q)
    assert after == before
    s2 = fresh_pool.snapshot()
    assert s2.misses > s.misses, "evicted entries must restage as misses"
    assert s2.resident_bytes <= budget


def test_lru_order_keeps_the_recent_entry(fresh_pool):
    """The least recently used entry goes first, by bytes."""
    class Owner:
        pass

    owner = Owner()
    tok = fresh_pool.register_owner(owner)
    for name in ("a", "b", "c"):
        fresh_pool.get_or_build(tok, (name,),
                                lambda: torch.zeros(100, dtype=torch.int64))
    fresh_pool.get_or_build(tok, ("a",), lambda: None)     # a is recent
    fresh_pool.configure(2 * 800)
    keys = set(fresh_pool.owner_entries(tok))
    assert keys == {("a",), ("c",)}
    s = fresh_pool.snapshot()
    assert (s.evictions, s.evicted_bytes) == (1, 800)


def test_single_oversized_entry_survives(fresh_pool):
    """The entry just staged for the running query is never evicted from
    under it, even when it alone exceeds the budget."""
    fresh_pool.configure(1)            # nothing fits
    segs = _segments(2)
    r = _ex(segs).run_json(COUNT_Q)
    assert r[0]["result"]["n"] == sum(s.n_rows for s in segs)
    assert fresh_pool.snapshot().entries >= 1


def test_zero_budget_means_unbounded(fresh_pool):
    fresh_pool.configure(0)
    segs = _segments(4)
    _ex(segs).run_json(GROUP_Q)
    s = fresh_pool.snapshot()
    assert s.evictions == 0 and s.entries > 0
    assert s.budget_bytes == 0


def test_executor_sets_the_budget(fresh_pool):
    segs = _segments(2)
    QueryExecutor(segs, device="cpu", device_pool_bytes=12345)
    assert fresh_pool.snapshot().budget_bytes == 12345
    QueryExecutor(segs, device="cpu")              # None keeps it
    assert fresh_pool.snapshot().budget_bytes == 12345


def test_default_budget_without_a_card(monkeypatch):
    """No CUDA card: the fixed default; with one, the share of its memory
    (resolved at the pool's first use)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert DeviceSegmentPool().budget_bytes == DEVICE_POOL_BUDGET_BYTES

    class Props:
        total_memory = 80 * 10 ** 9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    assert DeviceSegmentPool().budget_bytes \
        == int(DEVICE_POOL_BUDGET_SHARE * 80 * 10 ** 9)


def test_segment_gc_purges_entries(fresh_pool):
    segs = _segments(2)
    _ex(segs).run_json(COUNT_Q)
    assert fresh_pool.snapshot().resident_bytes > 0
    del segs
    gc.collect()
    s = fresh_pool.snapshot()
    assert s.resident_bytes == 0, "collected segments must release memory"
    assert s.entries == 0


def test_finalizer_never_takes_the_pool_lock(fresh_pool):
    """The owner's finalizer can run at any allocation, also while this
    thread holds the pool lock: it only queues the dead token, and the next
    locked operation purges."""
    class Owner:
        pass

    owner_obj = Owner()
    token = fresh_pool.register_owner(owner_obj)
    fresh_pool.get_or_build(token, ("k",),
                            lambda: torch.zeros(64, dtype=torch.int64))
    assert fresh_pool.snapshot().resident_bytes == 64 * 8

    acquired = fresh_pool._lock.acquire(timeout=5)
    assert acquired
    try:
        del owner_obj
        gc.collect()       # the finalizer runs here, under our lock
        assert list(fresh_pool._dead_owners) == [token]
    finally:
        fresh_pool._lock.release()
    s = fresh_pool.snapshot()
    assert s.resident_bytes == 0 and s.entries == 0
    assert not fresh_pool._dead_owners


def test_purge_during_build_does_not_resurrect(fresh_pool):
    """get_or_build runs build() outside the lock; when the owner dies
    during the build, its value is returned but not cached."""
    class Owner:
        pass

    owner_obj = Owner()
    token = fresh_pool.register_owner(owner_obj)
    holder = {"obj": owner_obj}
    del owner_obj

    def build():
        del holder["obj"]
        gc.collect()
        return torch.zeros(32, dtype=torch.int64)

    value = fresh_pool.get_or_build(token, ("k",), build)
    assert entry_bytes(value) == 32 * 8
    s = fresh_pool.snapshot()
    assert s.entries == 0 and s.resident_bytes == 0, (
        "a dead owner's entry must not be cached")


def test_clear_keeps_live_owners_cacheable(fresh_pool):
    class Owner:
        pass

    owner_obj = Owner()
    token = fresh_pool.register_owner(owner_obj)
    fresh_pool.get_or_build(token, ("k",),
                            lambda: torch.zeros(8, dtype=torch.int64))
    fresh_pool.clear()
    assert fresh_pool.snapshot().entries == 0
    fresh_pool.get_or_build(token, ("k",),
                            lambda: torch.zeros(8, dtype=torch.int64))
    assert fresh_pool.snapshot().entries == 1


def test_clear_keeps_segments_cacheable(fresh_pool):
    """After `clear`, a live segment stages again, with the same rows."""
    segs = _segments(2)
    ex = _ex(segs)
    want = ex.run_json(GROUP_Q)
    fresh_pool.clear()
    assert not segs[0].device_entries()
    assert ex.run_json(GROUP_Q) == want
    assert segs[0].device_entries()


def test_purge_owner_refuses_later_inserts(fresh_pool):
    class Owner:
        pass

    owner_obj = Owner()
    token = fresh_pool.register_owner(owner_obj)
    fresh_pool.get_or_build(token, ("a",),
                            lambda: torch.zeros(8, dtype=torch.int64))
    assert fresh_pool.purge_owner(token) == 64
    fresh_pool.get_or_build(token, ("b",),
                            lambda: torch.zeros(8, dtype=torch.int64))
    s = fresh_pool.snapshot()
    assert s.entries == 0 and s.evictions == 0


def test_entry_bytes_counts_packed_entries_compressed():
    rows = 2048
    vals = np.arange(rows, dtype=np.int32) % 200          # width 8, base 0
    pc = packed.PackedColumn(torch.from_numpy(packed.pack_padded(vals, 8, 0)),
                             8, 0, rows)
    assert pc.vpw == 4
    assert entry_bytes(pc) == rows // 4 * 4               # the words
    assert entry_logical_bytes(pc) == rows * 4            # decoded

    dense = torch.zeros(rows, dtype=torch.int32)

    class FakeBlock:
        arrays = {"packed": pc, "dense": dense}
    assert entry_bytes(FakeBlock()) == pc.nbytes + rows * 4
    assert entry_logical_bytes(FakeBlock()) == rows * 4 + rows * 4

    aux = torch.zeros(16, dtype=torch.int64)
    assert entry_bytes((pc, aux)) == pc.nbytes + 128
    assert entry_bytes([pc, {"a": aux}, (pc,)]) == 2 * pc.nbytes + 128
    assert entry_logical_bytes((pc, aux)) == rows * 4 + 128
    assert entry_logical_bytes(None) == 0


def test_pool_accounts_packed_entries_and_ratio(fresh_pool):
    class Owner:
        pass

    owner_obj = Owner()
    token = fresh_pool.register_owner(owner_obj)
    rows = 4096
    vals = (np.arange(rows) % 16).astype(np.int32)        # width 4: 8x
    pc = packed.PackedColumn(torch.from_numpy(packed.pack_padded(vals, 4, 0)),
                             4, 0, rows)
    aux = torch.zeros(128, dtype=torch.int32)
    fresh_pool.get_or_build(token, ("p",), lambda: (pc, aux))
    s = fresh_pool.snapshot()
    assert s.resident_bytes == pc.nbytes + 512
    assert s.logical_bytes == rows * 4 + 512
    assert s.packed_ratio > 3.0
    fresh_pool.clear()
    s2 = fresh_pool.snapshot()
    assert s2.resident_bytes == 0 and s2.logical_bytes == 0
    assert s2.packed_ratio == 1.0


def test_packed_block_counted_compressed(fresh_pool):
    """A block staged with words (the B1/B2 value columns) counts the
    words, and its decoded size on the logical side."""
    seg = _segments(1, rows=5000)[0]
    block = seg.device_block(["metLong"], torch.device("cpu"),
                             words=["metLong"])
    assert isinstance(block.arrays["metLong"], packed.PackedColumn)
    s = fresh_pool.snapshot()
    assert s.resident_bytes == block.resident_nbytes
    assert s.logical_bytes == block.logical_nbytes > s.resident_bytes


def test_rung_block_has_its_own_key(fresh_pool):
    """A block padded to a batching rung never stands in for the one padded
    to 1024 rows."""
    seg = _segments(1, rows=3000)[0]
    cpu = torch.device("cpu")
    a = seg.device_block(["metLong"], cpu)
    b = seg.device_block(["metLong"], cpu, row_align=4096)
    assert (a.padded_rows, b.padded_rows) == (3072, 4096)
    assert a is not b
    assert seg.device_block(["metLong"], cpu, row_align=4096) is b
    assert fresh_pool.snapshot().entries == 2


def test_concurrent_builds_keep_the_counts(fresh_pool):
    """Threads building, hitting and evicting at once: the pool's resident
    bytes stay the sum of its entries' and within the budget."""
    import sys
    import threading

    class Owner:
        pass

    owners = [Owner() for _ in range(4)]
    tokens = [fresh_pool.register_owner(o) for o in owners]
    fresh_pool.configure(20 * 64)
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(300):
                tok = tokens[int(rng.integers(len(tokens)))]
                key = (int(rng.integers(40)),)
                v = fresh_pool.get_or_build(
                    tok, key, lambda: torch.zeros(8, dtype=torch.int64))
                assert entry_bytes(v) == 64
        except Exception as e:       # reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errors
    s = fresh_pool.snapshot()
    held = sum(entry_bytes(v) for tok in tokens
               for v in fresh_pool.owner_entries(tok).values())
    assert s.resident_bytes == held == 64 * s.entries <= 20 * 64
    assert s.hits + s.misses == 16 * 300
