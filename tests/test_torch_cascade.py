"""The staged cascade rungs (druid_tpu_torch/data/cascade.py) against the
reference's.

Segments made with numpy from a seed — time-ordered with gaps that fit 8
bits, dimension-sorted rollup layouts with runs and a constant metric, a
narrow shuffled time range, random data, and a layout whose floats repeat
(LZ4) — are built in both packages. `plan_pair` must give the reference's
descriptors, LZ4 rung included, permuted and not. Every rung's staged
arrays must be the reference's `encode_column` output, and every decode
the reference's `split_resident`, bit for bit, padding rows included, also
slot by slot in a stack. Query rows with the rungs on are the reference's,
and the port's rows with the rungs on and off are equal; loaded V2
segments stage their RLE, LZ4 and persisted packed columns without a host
decode; the batched run and the 8-shard mesh stack encoded columns; the
one switch turns code-domain work off as the reference's does.
"""
import json

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import cascade as ref_cascade
from druid_tpu.data import packed as ref_packed
from druid_tpu.data.dictionary import Dictionary
from druid_tpu.data.segment import (NumericColumn, Segment, SegmentId,
                                    StringDimColumn, ValueType)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.parallel import make_mesh as ref_make_mesh
from druid_tpu.parallel import use_mesh as ref_use_mesh
from druid_tpu.storage.format_v2 import persist_segment_v2 as ref_persist_v2
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade, devicepool, packed
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching, filters, megakernel
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import sorted_reduce
from druid_tpu_torch.parallel import distributed, make_mesh
from druid_tpu_torch.storage.format import load_segment
from druid_tpu_torch.storage.format_v2 import persist_segment_v2

from tests.test_format_v2 import _mixed_segment
from tests.test_torch_slice import _carry, _compare

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = Interval.of("2026-07-01", "2026-07-02")
CPU = torch.device("cpu")
A_DICT = [f"a{i:02d}" for i in range(12)]
B_DICT = [f"b{i:03d}" for i in range(300)]


def _segment(kind, seed=3, n=6000, partition=0):
    """A reference Segment of one layout kind (see the module docstring)."""
    rng = np.random.default_rng(seed)
    t0 = IV.start
    a = rng.integers(0, 12, n).astype(np.int32)
    b = rng.integers(0, 300, n).astype(np.int32)
    m = rng.integers(-500, 9000, n).astype(np.int64)
    f = rng.normal(10.0, 40.0, n).astype(np.float32)
    const = np.full(n, 7, np.int64)
    ordered = True
    if kind == "time-ordered":               # gaps of a few ms: delta
        t = t0 + np.sort(rng.integers(0, 6 * n, n))
    elif kind == "rollup":                   # dimension-sorted: RLE dims
        t = t0 + (rng.integers(0, 86_400_000, n) // 32) * 32
        order = np.lexsort((b, a))
        a, b, t, m, f = a[order], b[order], t[order], m[order], f[order]
        a, b = np.sort(a), np.repeat(np.arange(n // 60, dtype=np.int32),
                                     60)[:n] % 300
        ordered = False
    elif kind == "narrow-time":              # shuffled, 200 ms range: FOR
        t = t0 + 1024 + rng.integers(0, 200, n)
        ordered = False
    elif kind == "repeating":                # floats that LZ4 compresses
        t = t0 + np.sort(rng.integers(0, 6 * n, n))
        f = ((np.arange(n) % 50) * 0.25 - 3.0).astype(np.float32)
        f[::97] = np.float32(-0.0)
    else:                                    # random rows over the day
        t = t0 + np.sort(rng.integers(0, 86_400_000, n))
    dims = {"dimA": StringDimColumn(a, Dictionary(A_DICT)),
            "dimB": StringDimColumn(b, Dictionary(B_DICT))}
    metrics = {"metLong": NumericColumn(m, ValueType.LONG),
               "metFloat": NumericColumn(f, ValueType.FLOAT),
               "absFloat": NumericColumn(np.abs(f), ValueType.FLOAT),
               "cnt": NumericColumn(const, ValueType.LONG)}
    # the reference is told whether rows are time-ordered; the port checks
    return Segment(SegmentId("ds", IV, "v1", partition), t.astype(np.int64),
                   dims, metrics, time_ordered=ordered)


KINDS = ["time-ordered", "rollup", "narrow-time", "random", "repeating"]
COLS = ["dimA", "dimB", "metLong", "metFloat", "cnt"]


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_pair_matches_reference(kind, permuted):
    ref = _segment(kind)
    port = _carry(ref)
    assert port.time_ordered == ref.time_ordered
    want = ref_cascade.plan_pair(ref, COLS, permuted=permuted)
    got = cascade.plan_pair(port, COLS, permuted=permuted)
    assert got == want
    if permuted:
        assert got[0] == ()
    else:
        kinds = {e[0]: e[1] for e in got[0]}
        assert kinds.get("__time_offset") == {
            "time-ordered": "delta", "repeating": "delta",
            "narrow-time": "for"}.get(kind)
        assert ("cnt", "rle", 8) in got[0]
        assert (kinds.get("metFloat") == "lz4") == (kind == "repeating")
        if kind == "rollup":
            assert {e[0] for e in got[0]} >= {"dimA", "dimB", "cnt"}


def test_plan_pair_with_packing_off_plans_no_packs():
    ref = _segment("time-ordered")
    port = _carry(ref)
    prev = (packed.set_enabled(False), ref_packed.set_enabled(False))
    try:
        got = cascade.plan_pair(port, COLS)
        assert got == ref_cascade.plan_pair(ref, COLS)
        assert got[1] == () and {e[0] for e in got[0]} \
            == {"__time_offset", "cnt"}
    finally:
        packed.set_enabled(prev[0])
        ref_packed.set_enabled(prev[1])


@pytest.mark.parametrize("mode", ["host", "0"])
def test_plan_pair_lz4_modes_match_reference(mode):
    ref = _segment("repeating")
    port = _carry(ref)
    prev = (cascade.set_lz4_mode(mode), ref_cascade.set_lz4_mode(mode))
    try:
        got = cascade.plan_pair(port, COLS)
        assert got == ref_cascade.plan_pair(ref, COLS)
        kinds = {e[0]: e[1:] for e in got[0]}
        assert kinds.get("metFloat") == {"host": ("lz4host",)}.get(mode)
    finally:
        cascade.set_lz4_mode(prev[0])
        ref_cascade.set_lz4_mode(prev[1])


def test_switch_off_plans_no_rung_and_no_derived_for():
    ref = _segment("rollup")
    port = _carry(ref)
    prev = (cascade.set_enabled(False), ref_cascade.set_enabled(False))
    try:
        got = cascade.plan_pair(port, COLS)
        assert got == ref_cascade.plan_pair(ref, COLS)
        assert got[0] == () and {e[0] for e in got[1]} >= {"dimA", "dimB"}
        assert cascade.for_encode_derived(-1, 100) is None
    finally:
        cascade.set_enabled(prev[0])
        ref_cascade.set_enabled(prev[1])
    assert cascade.for_encode_derived(-1, 100) \
        == ref_cascade.for_encode_derived(-1, 100) == (8, -1)
    assert cascade.for_encode_derived(-1, 1 << 20) is None


def test_time_ordered_is_computed_not_assumed():
    """The reference's Segment takes `time_ordered` from its caller and
    defaults it to True; the port's computes it from the rows. Told nothing
    over rows with one step back in time, the reference plans the delta
    rung from the largest gap (and its staging then refuses the negative
    one), while the port plans no rung for `__time_offset`: a pinned
    divergence (ROADMAP, the traps)."""
    ref = _segment("time-ordered")
    t = ref.time_ms.copy()
    i = int(np.flatnonzero(np.diff(t) > 0)[10])
    t[i], t[i + 1] = t[i + 1], t[i]
    told_nothing = Segment(ref.id, t, ref.dims, ref.metrics)
    port = _carry(told_nothing)
    assert told_nothing.time_ordered and not port.time_ordered
    want = dict((e[0], e[1:]) for e in
                ref_cascade.plan_pair(told_nothing, COLS)[0])
    got = dict((e[0], e[1:]) for e in cascade.plan_pair(port, COLS)[0])
    assert want["__time_offset"] == ("delta", 8)
    assert "__time_offset" not in got
    with pytest.raises(AssertionError):
        told_nothing.device_block(COLS)
    blk = port.device_block(COLS, CPU)
    assert torch.is_tensor(blk.arrays["__time_offset"])


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _bits(a):
    a = _np(a)
    if a.dtype.kind == "f":
        return a.view(np.dtype(f"<i{a.dtype.itemsize}"))
    return a


def _fields(col):
    """{field: host array} of a staged entry (a scalar field as shape [])."""
    if torch.is_tensor(col) or isinstance(col, np.ndarray) \
            or not hasattr(col, "__slots__") and not hasattr(col, "words"):
        return {"dense": _np(col)}
    names = {"RleColumn": ("values", "ends", "n_rows"),
             "DeltaColumn": ("words", "first"),
             "Lz4Column": ("literals", "lit_lens", "match_lens", "offsets")
             }.get(type(col).__name__, ("words",))
    out = {f: _np(getattr(col, f)) for f in names}
    for f in ("n_rows", "first"):
        if f in out:
            out[f] = out[f].reshape(())
    return out


RUNGS = {
    "rle-dim": ("rollup", "dimA"),
    "rle-metric": ("random", "cnt"),
    "delta": ("time-ordered", "__time_offset"),
    "for": ("narrow-time", "__time_offset"),
    "lz4": ("repeating", "metFloat"),
    "lz4host": ("repeating", "metFloat"),
}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_encode_column_matches_reference(rung):
    """Each rung's staged arrays are the reference's encode_column output,
    and the decode is the reference's split_resident bit for bit, padding
    rows included."""
    kind, name = RUNGS[rung]
    ref = _segment(kind)
    port = _carry(ref)
    mode = "host" if rung == "lz4host" else "device"
    prev = (cascade.set_lz4_mode(mode), ref_cascade.set_lz4_mode(mode))
    try:
        entry = dict((e[0], e) for e in cascade.plan_pair(port, COLS)[0])[
            name]
        assert entry == dict((e[0], e) for e in ref_cascade.plan_pair(
            ref, COLS)[0])[name]
        assert entry[1] == rung.split("-")[0]
        pad_n = port.padded_rows()
        if name == "__time_offset":
            raw = (ref.time_ms - IV.start).astype(np.int32)
        elif name in ref.dims:
            raw = ref.dims[name].ids
        else:
            raw = ref.metrics[name].values.astype(ref.staged_dtype(name))
        padded = np.zeros(pad_n, dtype=raw.dtype)
        padded[: raw.shape[0]] = raw
        want = ref_cascade.encode_column(ref, name, entry, padded.copy(),
                                         lambda x: x)
        got = cascade.encode_column(port, name, entry, padded.copy(),
                                    lambda x: torch.from_numpy(
                                        np.ascontiguousarray(x)))
    finally:
        cascade.set_lz4_mode(prev[0])
        ref_cascade.set_lz4_mode(prev[1])
    if rung == "lz4host":
        assert torch.is_tensor(got)
    else:
        assert type(got).__name__ == type(want).__name__
        assert got.cascade_kind == want.cascade_kind
        assert got.logical_nbytes == want.logical_nbytes
    wf, gf = _fields(want), _fields(got)
    assert set(wf) == set(gf)
    for f in wf:
        assert gf[f].dtype == wf[f].dtype, f
        np.testing.assert_array_equal(gf[f], wf[f], err_msg=f)
    _, ref_dense = ref_cascade.split_resident({name: want})
    packed_cols, view = cascade.split_resident({name: got})
    assert set(packed_cols) == ({name} if rung == "for" else set())
    dec = view[name]
    assert dec.dtype == getattr(torch, str(padded.dtype))
    assert dec.shape == (pad_n,)
    np.testing.assert_array_equal(_bits(dec), _bits(ref_dense[name]))
    n = port.n_rows
    np.testing.assert_array_equal(_bits(dec)[:n], _bits(padded)[:n])
    pad = _np(dec)[n:]
    if rung == "delta":       # padding rows repeat the last value
        assert (pad == padded[n - 1]).all()
    elif rung == "for":       # the fill wraps to the base
        assert (pad == entry[3]).all()
    else:
        assert (_bits(pad) == 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_staged_words_and_decodes_match_reference(kind):
    """Asked to stage metLong and cnt as words, the port packs metLong with
    the reference's words, stages every rung plan_pair plans (cnt's RLE
    among them) with the reference's arrays, keeps every other column
    dense, and every column decodes to the reference's split_resident bit
    for bit, padding rows included."""
    ref = _segment(kind)
    port = _carry(ref)
    rb = ref.device_block(COLS)
    pb = port.device_block(COLS, CPU, words=["metLong", "cnt"])
    assert set(pb.arrays) == set(rb.arrays)
    assert pb.cascades == ref_cascade.plan_pair(ref, COLS)[0]
    claimed = {e[0] for e in pb.cascades}
    assert "cnt" in claimed
    _, ref_dense = ref_cascade.split_resident(rb.arrays)
    packed_cols, view = cascade.split_resident(pb.arrays)
    pc, rpc = pb.arrays["metLong"], rb.arrays["metLong"]
    assert pb.packs == (("metLong", pc.width, pc.base),)
    assert set(packed_cols) == {"metLong"} | {
        e[0] for e in pb.cascades if e[1] == "for"}
    assert pc.descriptor() == rpc.descriptor()
    np.testing.assert_array_equal(_np(pc.words), _np(rpc.words))
    for name in rb.arrays:
        got = pb.arrays[name]
        if name in claimed:
            assert got.cascade_kind == rb.arrays[name].cascade_kind
            wf, gf = _fields(rb.arrays[name]), _fields(got)
            for f in wf:
                np.testing.assert_array_equal(gf[f], wf[f], err_msg=name)
        else:
            assert name == "metLong" or torch.is_tensor(got), name
        np.testing.assert_array_equal(_bits(view[name]),
                                      _bits(ref_dense[name]), err_msg=name)
    assert set(view.decoded()) == claimed | {"metLong"}
    assert pb.logical_nbytes == sum(np.asarray(ref_dense[k]).nbytes
                                    for k in ref_dense)
    assert pb.resident_nbytes == sum(
        int(v.nbytes) for v in pb.arrays.values())
    assert pb.resident_nbytes < pb.logical_nbytes


def test_cache_key_tells_representations_apart():
    port = _carry(_segment("time-ordered"))
    on = port.device_block(["metLong"], CPU, words=["metLong"])
    prev = packed.set_enabled(False)
    try:
        off = port.device_block(["metLong"], CPU, words=["metLong"])
    finally:
        packed.set_enabled(prev)
    dense = port.device_block(["metLong"], CPU)
    prev = cascade.set_enabled(False)
    try:
        plain = port.device_block(["metLong"], CPU)
    finally:
        cascade.set_enabled(prev)
    assert isinstance(on.arrays["metLong"], packed.PackedColumn)
    assert all(torch.is_tensor(v) for b in (off, dense)
               for k, v in b.arrays.items() if k != "__time_offset")
    assert all(torch.is_tensor(v) for v in plain.arrays.values())
    assert (on.packs, off.packs, dense.packs, plain.packs) \
        == ((("metLong", 16, -512),), (), (), ())
    delta = (("__time_offset", "delta", 8),)
    assert (on.cascades, dense.cascades, plain.cascades) \
        == (delta, delta, ())
    assert off is dense and on is not off and plain is not dense
    assert port.device_block(["metLong"], CPU, words=["metLong"]) is on
    for b in (on, dense):
        view = cascade.split_resident(b.arrays)[1]
        for name in ("metLong", "__time_offset", "__valid"):
            np.testing.assert_array_equal(view[name].numpy(),
                                          plain.arrays[name].numpy()
                                          if name != "__time_offset" else
                                          view[name].numpy())
        np.testing.assert_array_equal(
            view["__time_offset"].numpy()[:port.n_rows],
            plain.arrays["__time_offset"].numpy()[:port.n_rows])


def test_permuted_block_packs_after_the_permutation():
    port = _carry(_segment("time-ordered"))
    perm = np.random.default_rng(1).permutation(port.n_rows).astype(np.int32)
    blk = port.device_block(["metLong"], CPU, perm=perm, perm_key=("p", 1),
                            words=["metLong"])
    assert isinstance(blk.arrays["metLong"], packed.PackedColumn)
    assert torch.is_tensor(blk.arrays["__time_offset"])
    assert blk.cascades == ()
    dense = cascade.split_resident(blk.arrays)[1]["metLong"].numpy()
    np.testing.assert_array_equal(dense[:port.n_rows],
                                  port.metrics["metLong"].values[perm])


def test_decoded_view_decodes_once_and_on_read():
    pc = packed.PackedColumn(torch.from_numpy(
        packed.pack_padded(np.arange(1024, dtype=np.int32) % 16, 4, 0)),
        4, 0, 1024)
    ends = np.full(8, 1000, np.int32)
    ends[:3] = (10, 500, 1000)
    rle = cascade.RleColumn(
        torch.tensor([3, 1, 4, 0, 0, 0, 0, 0], dtype=torch.int32),
        torch.from_numpy(ends), torch.tensor([1000], dtype=torch.int32),
        1024)
    view = cascade.split_resident({"m": pc, "r": rle,
                                   "t": torch.zeros(1024)})[1]
    before = cascade.decode_stats()
    assert "m" in view and view.decoded() == ()
    assert cascade.column_dtypes(view) == {"m": "int32", "r": "int32",
                                           "t": "float32"}
    assert view.decoded() == ()
    a, r = view["m"], view["r"]
    assert view["m"] is a and view["r"] is r and view.decoded() == ("m", "r")
    after = cascade.decode_stats()
    assert after.get("packed", 0) - before.get("packed", 0) == 1
    assert after.get("rle", 0) - before.get("rle", 0) == 1
    np.testing.assert_array_equal(a.numpy(), np.arange(1024) % 16)
    want = np.zeros(1024, np.int32)
    want[:10], want[10:500], want[500:1000] = 3, 1, 4
    np.testing.assert_array_equal(r.numpy(), want)
    # an encoded column is not a tensor: code that wants one fails loudly
    with pytest.raises((TypeError, AttributeError)):
        torch.stack([rle, rle])


def test_stacked_columns_decode_slot_by_slot():
    """Encoded columns of one descriptor stack field by field, and the
    stacked decode is each column's own decode, slot by slot; mismatched
    representations decode and stack dense."""
    segs = [_carry(_segment("repeating", seed=s)) for s in (1, 2, 3)]
    cols = ["cnt", "metFloat", "metLong"]
    blocks = [s.device_block(cols, CPU, words=["metLong"]) for s in segs]
    plans = {b.cascades for b in blocks}
    assert len(plans) == 1 and {e[1] for e in plans.pop()} \
        >= {"rle", "lz4", "delta"}
    for name in ["__time_offset", "__valid"] + cols:
        parts = [b.arrays[name] for b in blocks]
        st = cascade.stack_columns(parts)
        assert type(st) is type(parts[0])
        dec = cascade.decode(st)
        assert dec.shape[0] == 3
        for i, p in enumerate(parts):
            np.testing.assert_array_equal(_bits(dec[i]),
                                          _bits(cascade.decode(p)))
        z = cascade.decode(cascade.zeros_like_column(parts[0]))
        assert z.shape == dec[0].shape
    mixed = cascade.stack_columns([blocks[0].arrays["metLong"],
                                   cascade.decode(blocks[1].arrays[
                                       "metLong"])])
    assert torch.is_tensor(mixed) and mixed.shape[0] == 2


HEAD_Q = {"queryType": "groupBy", "dataSource": "ds",
          "intervals": [str(IV)], "granularity": "all",
          "dimensions": ["dimA", "dimB"],
          "aggregations": [{"type": "count", "name": "rows"},
                           {"type": "longSum", "name": "lsum",
                            "fieldName": "metLong"},
                           {"type": "floatMax", "name": "fmax",
                            "fieldName": "metFloat"}]}


@pytest.mark.parametrize("which", ["B1", "B2"])
def test_kernel_only_field_reaches_the_kernel_as_words(which, monkeypatch):
    """metLong, read only by the kernel, goes to B1/B2 as a PackedColumn and
    is not decoded before the call; the key goes in decoded (the projection
    is permuted: nothing cascades, and at G = 2^16 the key's range packs
    into the FOR rung)."""
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", "projection")
    port = _carry(_segment("random", seed=9, n=20_000))
    q = dict(HEAD_Q)
    if which == "B2":
        q["filter"] = {"type": "in", "dimension": "dimA",
                       "values": ["a00", "a03", "a07"]}
        mod, attr = megakernel, "mega_reduce"
    else:
        mod, attr = sorted_reduce, "sorted_reduce"
    seen = []
    orig = getattr(mod, attr)

    def spy(arrays, *a, packed_cols=None, **k):
        seen.append((isinstance(arrays, cascade.DecodedView)
                     and arrays.decoded(), dict(packed_cols or {}),
                     cascade.decode_stats(),
                     isinstance(arrays, cascade.DecodedView)
                     and arrays.staged.get("__key")))
        return orig(arrays, *a, packed_cols=packed_cols, **k)
    monkeypatch.setattr(mod, attr, spy)
    before = cascade.decode_stats()
    rows = PortExecutor([port], device="cpu").run_json(q)
    assert rows and len(seen) == 1
    decoded, cols, at_call, key = seen[0]
    assert decoded is not False and "metLong" not in decoded
    assert "__key" in decoded and isinstance(key, cascade.ForColumn)
    assert (key.width, key.base) == (16, -1)
    assert isinstance(cols["metLong"], packed.PackedColumn)
    assert cols["metLong"].width == 16
    # the one packed decode is the key's
    assert at_call.get("packed", 0) == before.get("packed", 0) + 1


# ---------------------------------------------------------------------------
# Queries with the rungs on and off
# ---------------------------------------------------------------------------

QUERIES = {
    "timeseries": {"queryType": "timeseries", "dataSource": "ds",
                   "intervals": [str(IV)], "granularity": "hour",
                   "aggregations": [
                       {"type": "count", "name": "rows"},
                       {"type": "longSum", "name": "lsum",
                        "fieldName": "metLong"},
                       {"type": "doubleSum", "name": "dsum",
                        "fieldName": "metFloat"},
                       {"type": "doubleSum", "name": "fabs",
                        "fieldName": "absFloat"},
                       {"type": "longMax", "name": "lmax",
                        "fieldName": "metLong"}]},
    "topn": {"queryType": "topN", "dataSource": "ds", "intervals": [str(IV)],
             "granularity": "all", "dimension": "dimB", "metric": "lsum",
             "threshold": 7,
             "aggregations": [{"type": "count", "name": "rows"},
                              {"type": "longSum", "name": "lsum",
                               "fieldName": "metLong"},
                              {"type": "floatMin", "name": "fmin",
                               "fieldName": "metFloat"}]},
    "groupby": {"queryType": "groupBy", "dataSource": "ds",
                "intervals": [str(IV)], "granularity": "all",
                "dimensions": ["dimA"],
                "aggregations": [{"type": "count", "name": "rows"},
                                 {"type": "longSum", "name": "lsum",
                                  "fieldName": "metLong"},
                                 {"type": "longSum", "name": "csum",
                                  "fieldName": "cnt"},
                                 {"type": "floatSum", "name": "fsum",
                                  "fieldName": "metFloat"},
                                 {"type": "floatSum", "name": "fabs",
                                  "fieldName": "absFloat"}]},
    "filtered": {"queryType": "groupBy", "dataSource": "ds",
                 "intervals": [str(IV)], "granularity": "all",
                 "dimensions": ["dimA", "dimB"],
                 "filter": {"type": "and", "fields": [
                     {"type": "in", "dimension": "dimA",
                      "values": ["a01", "a04", "a05", "a09"]},
                     {"type": "bound", "dimension": "metLong",
                      "lower": "0", "upper": "6000",
                      "ordering": "numeric"}]},
                 "aggregations": [{"type": "count", "name": "rows"},
                                  {"type": "longSum", "name": "lsum",
                                   "fieldName": "metLong"},
                                  {"type": "longMin", "name": "lmin",
                                   "fieldName": "metLong"}]},
}


def _segments(kind, n_segs=2, n=6000):
    return [_segment(kind, seed=11 + i, n=n, partition=i)
            for i in range(n_segs)]


@pytest.mark.parametrize("kind", ["rollup", "time-ordered", "repeating",
                                  "narrow-time"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_queries_match_reference_and_rungs_off(kind, name):
    """Rows with the rungs on are the reference's; with them off the port's
    rows are the same, floats included (every decode is exact)."""
    ref = _segments(kind)
    q = QUERIES[name]
    if kind == "narrow-time" and name == "timeseries":
        q = dict(q, granularity="second")
    want = RefExecutor(ref).run_json(q)
    port = [_carry(s) for s in ref]
    on = PortExecutor(port, device="cpu").run_json(q)
    _compare(want, on)
    staged = [b for s in port for k, b in s.device_entries().items()
              if k[0] == "block"]
    prev = cascade.set_enabled(False)
    try:
        off_port = [_carry(s) for s in ref]
        off = PortExecutor(off_port, device="cpu").run_json(q)
    finally:
        cascade.set_enabled(prev)
    assert on and json.dumps(on, sort_keys=True) \
        == json.dumps(off, sort_keys=True)
    assert all(b.cascades == () for s in off_port
               for k, b in s.device_entries().items() if k[0] == "block")
    if staged and kind != "rollup":
        assert any(b.cascades for b in staged)


# ---------------------------------------------------------------------------
# Loaded V2 segments
# ---------------------------------------------------------------------------

V2_QUERIES = [
    {"queryType": "groupBy", "dataSource": "fmt",
     "intervals": ["2026-01-01/2026-01-02"], "granularity": "all",
     "dimensions": ["r"],
     "filter": {"type": "in", "dimension": "d",
                "values": ["k01", "k03", "k07", "k12"]},
     "aggregations": [{"type": "count", "name": "rows"},
                      {"type": "longSum", "name": "s", "fieldName": "sm"},
                      {"type": "longSum", "name": "v", "fieldName": "val"},
                      {"type": "doubleSum", "name": "x",
                       "fieldName": "dbl"}]},
    {"queryType": "timeseries", "dataSource": "fmt",
     "intervals": ["2026-01-01/2026-01-02"], "granularity": "minute",
     "aggregations": [{"type": "count", "name": "rows"},
                      {"type": "longMax", "name": "s", "fieldName": "sm"},
                      {"type": "doubleSum", "name": "x",
                       "fieldName": "dbl"}]},
]


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("qi", range(len(V2_QUERIES)))
def test_loaded_v2_segment_stages_without_host_decode(tmp_path, writer, qi):
    """A V2 segment written by either package stages its RLE columns from
    the persisted run tables, its LZ4 column from the blob's tokens and
    its packed columns from the persisted words: the query counts no
    `host:` decode, and its rows are the in-memory segment's."""
    ref = _mixed_segment(rows=8192)
    d = str(tmp_path / "seg")
    if writer == "port":
        persist_segment_v2(_carry(ref), d)
    else:
        ref_persist_v2(ref, d)
    loaded = load_segment(d)
    q = V2_QUERIES[qi]
    before = cascade.decode_stats()
    got = PortExecutor([loaded], device="cpu").run_json(q)
    after = cascade.decode_stats()
    host = {k: after[k] - before.get(k, 0) for k in after
            if k.startswith("host:") and after[k] != before.get(k, 0)}
    assert host == {}
    (block,) = [b for k, b in loaded.device_entries().items()
                if k[0] == "block"]
    kinds = {k: getattr(v, "cascade_kind", None) or (
        "packed" if isinstance(v, packed.PackedColumn) else "dense")
        for k, v in block.arrays.items()}
    want_kinds = {"dbl": "lz4", "sm": "packed", "r": "packed",
                  "val": "rle", "d": "rle", "__time_offset": "delta"}
    assert {k: kinds[k] for k in kinds if k in want_kinds} \
        == {k: v for k, v in want_kinds.items() if k in kinds}
    assert len(kinds) > 3
    assert json.dumps(got, sort_keys=True) == json.dumps(
        PortExecutor([_carry(ref)], device="cpu").run_json(q),
        sort_keys=True)


# ---------------------------------------------------------------------------
# Batching and the mesh
# ---------------------------------------------------------------------------

def _rollup_segments(n_segs, n=3000):
    """Rollup-shaped segments with equal dictionaries: dimension-sorted
    dims, a narrow time range (FOR), a constant count, and repeating floats
    (LZ4), so every slot of a stack holds encoded columns."""
    out = []
    for i in range(n_segs):
        rng = np.random.default_rng(40 + i)
        a = np.sort(rng.integers(0, 12, n)).astype(np.int32)
        b = np.repeat(np.arange(n // 50, dtype=np.int32), 50)[:n] % 300
        t = IV.start + 1024 + rng.integers(0, 200, n)
        m = rng.integers(0, 900, n).astype(np.int64)
        f = ((np.arange(n) % 40) * 0.5).astype(np.float32)
        out.append(Segment(
            SegmentId("ds", IV, "v1", i), t.astype(np.int64),
            {"dimA": StringDimColumn(a, Dictionary(A_DICT)),
             "dimB": StringDimColumn(b, Dictionary(B_DICT))},
            {"metLong": NumericColumn(m, ValueType.LONG),
             "metFloat": NumericColumn(f, ValueType.FLOAT),
             "absFloat": NumericColumn(f, ValueType.FLOAT),
             "cnt": NumericColumn(np.ones(n, np.int64), ValueType.LONG)},
            time_ordered=False))
    return out


BATCH_Q = {"queryType": "groupBy", "dataSource": "ds",
           "intervals": [str(IV)], "granularity": "all",
           "dimensions": ["dimA"],
           "aggregations": [{"type": "count", "name": "rows"},
                            {"type": "longSum", "name": "lsum",
                             "fieldName": "metLong"},
                            {"type": "floatSum", "name": "fsum",
                             "fieldName": "metFloat"},
                            {"type": "floatSum", "name": "fabs",
                             "fieldName": "absFloat"},
                            {"type": "longMax", "name": "bmax",
                             "fieldName": "metLong"}]}


def test_batched_bucket_stacks_encoded_columns(monkeypatch):
    ref = _rollup_segments(4)
    port = [_carry(s) for s in ref]
    stacks = []
    orig = batching.stack_blocks

    def spy(*a, **k):
        out = orig(*a, **k)
        stacks.append(out)
        return out
    monkeypatch.setattr(batching, "stack_blocks", spy)
    before = batching.stats().snapshot()
    got = PortExecutor(port, device="cpu").run_json(BATCH_Q)
    after = batching.stats().snapshot()
    _compare(RefExecutor(ref).run_json(BATCH_Q), got)
    assert stacks and after["batches"] > before["batches"]
    kinds = {k: getattr(v, "cascade_kind", None)
             for k, v in stacks[0].items()}
    assert kinds["dimA"] == "rle" and kinds["__time_offset"] == "for"
    assert kinds["metFloat"] == "lz4"
    assert stacks[0]["dimA"].values.shape[0] == 4
    prev = cascade.set_enabled(False)
    try:
        off = PortExecutor([_carry(s) for s in ref],
                           device="cpu").run_json(BATCH_Q)
    finally:
        cascade.set_enabled(prev)
    assert json.dumps(off, sort_keys=True) == json.dumps(got,
                                                         sort_keys=True)


MESH_QUERIES = {
    "groupby": dict(BATCH_Q, aggregations=[
        {"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
        {"type": "doubleMax", "name": "fmax", "fieldName": "metFloat"}]),
    "topn": {"queryType": "topN", "dataSource": "ds", "intervals": [str(IV)],
             "granularity": "all", "dimension": "dimB", "metric": "lsum",
             "threshold": 9,
             "aggregations": [{"type": "count", "name": "rows"},
                              {"type": "longSum", "name": "lsum",
                               "fieldName": "metLong"}]},
}


@pytest.mark.parametrize("name", list(MESH_QUERIES))
def test_mesh_stacks_encoded_columns(name, monkeypatch):
    """The 8-shard CPU mesh (11 segments, K padded to 16) stacks encoded
    columns under the common descriptors and gives the reference mesh's
    rows."""
    monkeypatch.setattr(devicepool, "_POOL", devicepool.DeviceSegmentPool())
    ref = _rollup_segments(11, n=2000)
    q = MESH_QUERIES[name]
    with ref_use_mesh(ref_make_mesh(8)):
        want = RefExecutor(ref).run_json(q)
    port = [_carry(s) for s in ref]
    built = []
    orig = distributed._build_stack

    def spy(*a, **k):
        out = orig(*a, **k)
        built.append(out)
        return out
    monkeypatch.setattr(distributed, "_build_stack", spy)
    try:
        got = PortExecutor(port, device="cpu",
                           mesh=make_mesh(8, device="cpu")).run_json(q)
        pool = devicepool.device_pool().snapshot()
    finally:
        distributed.clear_stack_cache()
    assert got == want
    (stack,) = built
    shard = stack[0][0]
    kinds = {k: getattr(v, "cascade_kind", None) for k, v in shard.items()}
    assert kinds["__valid"] == "rle" and kinds["__time_offset"] == "for"
    assert any(kinds.get(c) == "rle" for c in ("dimA", "dimB"))
    assert pool.stacked_ratio > 2.0


def test_common_descriptors_match_reference():
    from druid_tpu.parallel import distributed as ref_distributed
    ref = _rollup_segments(3) + [_segment("rollup", seed=5, partition=3)]
    port = [_carry(s) for s in ref]
    cols = ("cnt", "dimA", "dimB", "metFloat", "metLong")
    got = distributed._common_descriptors(port, cols)
    assert got == ref_distributed._common_descriptors(ref, cols)
    assert ("dimA", "rle", max(
        e[2] for s in port for e in cascade.plan_pair(s, cols)[0]
        if e[0] == "dimA")) in got[0]


# ---------------------------------------------------------------------------
# The switch
# ---------------------------------------------------------------------------

RUN_Q = {"queryType": "groupBy", "dataSource": "ds",
         "intervals": [str(IV)], "granularity": "all",
         "dimensions": ["dimA"],
         "filter": {"type": "in", "dimension": "dimA",
                    "values": ["a02", "a05", "a06"]},
         "aggregations": [{"type": "count", "name": "rows"},
                          {"type": "longSum", "name": "c",
                           "fieldName": "cnt"}]}


def test_switch_off_turns_off_run_domain_and_run_leaves(monkeypatch):
    """`cascade.set_enabled(False)` turns off code-domain aggregation, the
    run-table filter leaves and the constant-LONG sum, as the reference's
    switch does; the rows stay the same."""
    ref = _rollup_segments(2)
    port = [_carry(s) for s in ref]
    seg = port[0]
    monkeypatch.setattr(batching, "_ENABLED", False)
    stats = cascade.code_domain_stats()
    h0 = stats.snapshot()["hits"]
    on = PortExecutor(port, device="cpu").run_json(RUN_Q)
    assert stats.snapshot()["hits"] - h0 == 2
    lut = np.zeros(12, dtype=bool)
    lut[[2, 5]] = True
    assert filters._run_leaf_payload(seg, "dimA", lut, 4096) is not None
    from druid_tpu_torch.engine.kernels import make_kernel
    from druid_tpu_torch.query.aggregators import agg_from_json
    agg = agg_from_json({"type": "longSum", "name": "c",
                         "fieldName": "cnt"})
    assert make_kernel(agg, seg).const_value == 1
    prev = (cascade.set_enabled(False), ref_cascade.set_enabled(False))
    try:
        h1 = stats.snapshot()["hits"]
        off = PortExecutor(port, device="cpu").run_json(RUN_Q)
        assert stats.snapshot()["hits"] == h1
        assert filters._run_leaf_payload(seg, "dimA", lut, 4096) is None
        assert make_kernel(agg, seg).const_value is None
        from druid_tpu.engine import filters as ref_filters
        assert ref_filters._run_leaf_payload(ref[0], "dimA", lut,
                                             4096) is None
    finally:
        cascade.set_enabled(prev[0])
        ref_cascade.set_enabled(prev[1])
    assert json.dumps(on, sort_keys=True) == json.dumps(off, sort_keys=True)
    _compare(RefExecutor(ref).run_json(RUN_Q), on)


@pytest.mark.parametrize("rung", ["delta", "for", "pack-w4", "pack-w8",
                                  "pack-w16"])
def test_device_encoding_matches_host(rung):
    """FOR, delta and packed words encode on the column's device, from a
    tensor already there (the mesh's stack): the host's (and the
    reference's) arrays bit for bit."""
    rng = np.random.default_rng(17)
    n, pad_n = 5000, 6144
    if rung == "delta":
        ref = _segment("time-ordered")
        entry = ("__time_offset", "delta", 8)
        raw = (ref.time_ms - IV.start).astype(np.int32)
    elif rung == "for":
        ref = _segment("narrow-time")
        entry = ("__time_offset", "for", 8, 1024)
        raw = (ref.time_ms - IV.start).astype(np.int32)
    else:
        w = int(rung.split("w")[1])
        base = -(1 << (w - 1))
        raw = rng.integers(base, base + (1 << w), n).astype(np.int32)
    padded = np.zeros(pad_n if rung.startswith("pack") else
                      _carry(ref).padded_rows(), dtype=np.int32)
    padded[: raw.shape[0]] = raw
    dev = torch.from_numpy(padded.copy())
    if rung.startswith("pack"):
        want = ref_packed.pack_padded(padded, w, base)
        np.testing.assert_array_equal(
            packed.pack_device(dev, w, base).numpy(), np.asarray(want))
        return
    port = _carry(ref)
    got = cascade.encode_column(port, entry[0], entry, dev, None)
    want = ref_cascade.encode_column(ref, entry[0], entry, padded.copy(),
                                     lambda x: x)
    wf, gf = _fields(want), _fields(got)
    assert set(wf) == set(gf)
    for f in wf:
        np.testing.assert_array_equal(gf[f], wf[f], err_msg=f)
    assert type(got).__name__ == type(want).__name__
