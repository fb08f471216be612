"""Staging plans (druid_tpu_torch/data/cascade.py) against the reference.

Segments made with numpy from a seed — time-ordered with gaps that fit 8
bits, dimension-sorted rollup layouts with runs and a constant metric, a
narrow shuffled time range, and random data — are built in both packages.
`plan_pair` must give the reference's descriptors (the reference with its
LZ4 rung off, which the port has not ported), permuted and not. The port
stages packed only the columns kernels B1/B2 read as words: those must
hold the reference's words, and every staged column must decode to the
reference's `split_resident`. On the query path a column that only B1/B2
read reaches the kernel as words and is never decoded.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import cascade as ref_cascade
from druid_tpu.data import packed as ref_packed
from druid_tpu.data.dictionary import Dictionary
from druid_tpu.data.segment import (NumericColumn, Segment, SegmentId,
                                    StringDimColumn, ValueType)
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade, packed
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import megakernel, sorted_reduce

from tests.test_torch_slice import _carry

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = Interval.of("2026-07-01", "2026-07-02")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _lz4_off():
    """The reference without its LZ4 rung, the port's staging set."""
    prev = ref_cascade.set_lz4_mode("0")
    yield
    ref_cascade.set_lz4_mode(prev)


def _segment(kind, seed=3, n=6000):
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
    else:                                    # random rows over the day
        t = t0 + np.sort(rng.integers(0, 86_400_000, n))
    dims = {"dimA": StringDimColumn(a, Dictionary(
                [f"a{i:02d}" for i in range(12)])),
            "dimB": StringDimColumn(b, Dictionary(
                [f"b{i:03d}" for i in range(300)]))}
    metrics = {"metLong": NumericColumn(m, ValueType.LONG),
               "metFloat": NumericColumn(f, ValueType.FLOAT),
               "cnt": NumericColumn(const, ValueType.LONG)}
    # the reference is told whether rows are time-ordered; the port checks
    return Segment(SegmentId("ds", IV, "v1"), t.astype(np.int64), dims,
                   metrics, time_ordered=ordered)


KINDS = ["time-ordered", "rollup", "narrow-time", "random"]
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
        time_kind = dict((e[0], e[1]) for e in got[0]).get("__time_offset")
        assert time_kind == {"time-ordered": "delta", "narrow-time": "for"} \
            .get(kind)
        assert ("cnt", "rle", 8) in got[0]
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


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("kind", KINDS)
def test_staged_words_and_decodes_match_reference(kind):
    """Asked to stage metLong and cnt as words, the port packs metLong with
    the reference's words and keeps cnt, which an RLE rung claims, dense;
    every column decodes to the reference's split_resident, and nothing
    else is encoded."""
    ref = _segment(kind)
    port = _carry(ref)
    rb = ref.device_block(COLS)
    pb = port.device_block(COLS, CPU, words=["metLong", "cnt"])
    assert set(pb.arrays) == set(rb.arrays)
    _, ref_dense = ref_cascade.split_resident(rb.arrays)
    packed_cols, view = cascade.split_resident(pb.arrays)
    pc, rpc = pb.arrays["metLong"], rb.arrays["metLong"]
    assert set(packed_cols) == {"metLong"}
    assert pb.packs == (("metLong", pc.width, pc.base),)
    assert pc.descriptor() == rpc.descriptor()
    np.testing.assert_array_equal(_np(pc.words), _np(rpc.words))
    for name in rb.arrays:
        assert name == "metLong" or torch.is_tensor(pb.arrays[name]), name
        # the reference's delta column repeats the last time on padding
        # rows, dense staging pads with 0; `__valid` masks both
        n = port.n_rows if name == "__time_offset" else None
        np.testing.assert_array_equal(_np(view[name])[:n],
                                      np.asarray(ref_dense[name])[:n])
    assert view.decoded() == ("metLong",)
    assert pb.resident_nbytes + pc.logical_nbytes - pc.nbytes \
        == pb.logical_nbytes == sum(np.asarray(ref_dense[k]).nbytes
                                    for k in ref_dense)


def test_cache_key_tells_representations_apart():
    port = _carry(_segment("time-ordered"))
    on = port.device_block(["metLong"], CPU, words=["metLong"])
    prev = packed.set_enabled(False)
    try:
        off = port.device_block(["metLong"], CPU, words=["metLong"])
    finally:
        packed.set_enabled(prev)
    dense = port.device_block(["metLong"], CPU)
    assert isinstance(on.arrays["metLong"], packed.PackedColumn)
    assert all(torch.is_tensor(v) for b in (off, dense)
               for v in b.arrays.values())
    assert (on.packs, off.packs, dense.packs) \
        == ((("metLong", 16, -512),), (), ())
    assert off is dense and on is not off
    assert port.device_block(["metLong"], CPU, words=["metLong"]) is on
    np.testing.assert_array_equal(
        cascade.split_resident(on.arrays)[1]["metLong"].numpy(),
        off.arrays["metLong"].numpy())


def test_permuted_block_packs_after_the_permutation():
    port = _carry(_segment("time-ordered"))
    perm = np.random.default_rng(1).permutation(port.n_rows).astype(np.int32)
    blk = port.device_block(["metLong"], CPU, perm=perm, perm_key=("p", 1),
                            words=["metLong"])
    assert isinstance(blk.arrays["metLong"], packed.PackedColumn)
    assert torch.is_tensor(blk.arrays["__time_offset"])
    dense = cascade.split_resident(blk.arrays)[1]["metLong"].numpy()
    np.testing.assert_array_equal(dense[:port.n_rows],
                                  port.metrics["metLong"].values[perm])


def test_decoded_view_decodes_once_and_on_read():
    pc = packed.PackedColumn(torch.from_numpy(
        packed.pack_padded(np.arange(1024, dtype=np.int32) % 16, 4, 0)),
        4, 0, 1024)
    view = cascade.split_resident({"m": pc, "t": torch.zeros(1024)})[1]
    before = cascade.decode_stats().get("packed", 0)
    assert "m" in view and view.decoded() == ()
    assert cascade.column_dtypes(view) == {"m": "int32", "t": "float32"}
    assert view.decoded() == ()
    a = view["m"]
    assert view["m"] is a and view.decoded() == ("m",)
    assert cascade.decode_stats().get("packed", 0) - before == 1
    np.testing.assert_array_equal(a.numpy(), np.arange(1024) % 16)


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
    is not decoded before the call; the key goes in decoded."""
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
                     cascade.decode_stats()))
        return orig(arrays, *a, packed_cols=packed_cols, **k)
    monkeypatch.setattr(mod, attr, spy)
    before = cascade.decode_stats()
    rows = PortExecutor([port], device="cpu").run_json(q)
    assert rows and len(seen) == 1
    decoded, cols, at_call = seen[0]
    assert decoded is not False and "metLong" not in decoded
    assert isinstance(cols["metLong"], packed.PackedColumn)
    assert cols["metLong"].width == 16
    assert at_call.get("packed", 0) == before.get("packed", 0)
