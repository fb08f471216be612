"""The port's bitmap indexes (druid_tpu_torch/data/bitmap.py) and the filter
leaves they feed (druid_tpu_torch/engine/filters.py): the cases of
tests/test_bitmap.py on the port, each held against the reference's classes
(sparse containers survive AND/OR/XOR without densifying, NOT-of-sparse,
empty-dictionary and all-rows selectivities are exact, the uint32 device
words round-trip, and `device_repr` gives the reference's kind and payload
for dense and sparse inputs); then the leaf pin: a leaf's words taken from a
bitmap index (a V2-loaded segment's persisted one, or one built already)
equal `lut[ids]`'s words, with and without a permutation, for dense and
sparse leaves, a sparse leaf expanding its row ids on the device; and a
filtered groupBy over loaded segments whose filter dimension stays
unmaterialized."""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import bitmap as ref_bitmap
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine.executor import QueryExecutor as RefExecutor
from druid_tpu.query import filters as RF
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data.bitmap import (Bitmap, BitmapIndex, SparseBitmap,
                                         bitmap_and, device_repr,
                                         sparse_if_small, to_words32)
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.engine import filters
from druid_tpu_torch.engine.filters import (bitmap_of, estimate_selectivity,
                                            filter_cardinality, host_mask)
from druid_tpu_torch.query import filters as F
from druid_tpu_torch.storage.format_v2 import (load_segment_v2,
                                               persist_segment_v2)
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = Interval.of("2026-03-01", "2026-03-02")
CPU = torch.device("cpu")


def _ref_segment(n_rows=3333, card=50, seed=3):
    """n_rows deliberately not a multiple of 32 (word-boundary coverage)."""
    gen = DataGenerator((ColumnSpec("d", "string", cardinality=card),
                        ColumnSpec("m", "long", low=0, high=9)), seed=seed)
    return gen.segment(n_rows, IV, datasource="bm")


def _same(port_bm, ref_bm):
    """Same representation class and the same rows as the reference's."""
    assert type(port_bm).__name__ == type(ref_bm).__name__
    assert port_bm.n_rows == ref_bm.n_rows
    np.testing.assert_array_equal(port_bm.to_bool(), ref_bm.to_bool())


@pytest.fixture()
def no_densify(monkeypatch):
    """Fail the test if any SparseBitmap is densified (words/_dense)."""
    def boom(self):
        raise AssertionError("SparseBitmap was densified")
    monkeypatch.setattr(SparseBitmap, "_dense", boom)
    monkeypatch.setattr(SparseBitmap, "words", property(boom))


# ---------------------------------------------------------------------------
# representation-aware algebra
# ---------------------------------------------------------------------------

def test_sparse_sparse_algebra_stays_sparse(no_densify):
    n = 3333
    ids_a, ids_b = [1, 5, 40, 999, 3332], [5, 40, 100]
    a = SparseBitmap(np.array(ids_a, np.int32), n)
    b = SparseBitmap(np.array(ids_b, np.int32), n)
    ra = ref_bitmap.SparseBitmap(np.array(ids_a, np.int32), n)
    rb = ref_bitmap.SparseBitmap(np.array(ids_b, np.int32), n)
    for got, want, ids in ((a & b, ra & rb, [5, 40]),
                           (a | b, ra | rb, [1, 5, 40, 100, 999, 3332]),
                           (a ^ b, ra ^ rb, [1, 100, 999, 3332])):
        assert isinstance(got, SparseBitmap)
        assert list(got.ids) == ids == list(want.ids)


def test_sparse_dense_and_probes_words_without_densify(no_densify):
    n = 3333
    dense = Bitmap.from_indices(np.arange(0, n, 2), n)
    sp = SparseBitmap(np.array([0, 1, 2, 31, 32, 33, 3332], np.int32), n)
    out = bitmap_and(sp, dense)
    assert isinstance(out, SparseBitmap)
    assert list(out.ids) == [0, 2, 32, 3332]
    assert list((dense & sp).ids) == [0, 2, 32, 3332]
    ref = ref_bitmap.bitmap_and(
        ref_bitmap.SparseBitmap(sp.ids.copy(), n),
        ref_bitmap.Bitmap.from_indices(np.arange(0, n, 2), n))
    assert list(ref.ids) == list(out.ids)


def test_sparse_dense_or_xor_fold_ids_into_words():
    n = 100
    dense = Bitmap.from_indices(np.array([0, 1, 2]), n)
    sp = SparseBitmap(np.array([2, 50, 99], np.int32), n)
    rdense = ref_bitmap.Bitmap.from_indices(np.array([0, 1, 2]), n)
    rsp = ref_bitmap.SparseBitmap(np.array([2, 50, 99], np.int32), n)
    assert sorted((sp | dense).to_indices()) == [0, 1, 2, 50, 99]
    assert sorted((sp ^ dense).to_indices()) == [0, 1, 50, 99]
    assert sorted((dense ^ sp).to_indices()) == [0, 1, 50, 99]
    _same(sp | dense, rsp | rdense)
    _same(sp ^ dense, rsp ^ rdense)
    _same(dense ^ sp, rdense ^ rsp)


def test_not_of_sparse_is_dense_and_exact():
    n = 3333
    sp = SparseBitmap(np.array([0, 5, 3332], np.int32), n)
    inv = ~sp
    assert inv.cardinality() == n - 3
    assert not inv.test_ids(np.array([0, 5, 3332])).any()
    _same(inv, ~ref_bitmap.SparseBitmap(np.array([0, 5, 3332], np.int32), n))


def test_sparse_if_small_demotes():
    n = 32 * 40
    for idx, kind in ((np.array([3, 700]), SparseBitmap),
                      (np.arange(0, n, 2), Bitmap)):
        got = sparse_if_small(Bitmap.from_indices(idx, n))
        assert isinstance(got, kind)
        _same(got, ref_bitmap.sparse_if_small(
            ref_bitmap.Bitmap.from_indices(idx, n)))


# ---------------------------------------------------------------------------
# selectivity / bitmap_of edge cases
# ---------------------------------------------------------------------------

def test_not_of_sparse_selectivity_exact_without_densify(monkeypatch):
    ref = _ref_segment(n_rows=3333, card=400)
    seg = _carry(ref)
    val = seg.dims["d"].dictionary.values[0]
    leaf = F.SelectorFilter("d", val)
    lb = bitmap_of(leaf, seg)
    assert isinstance(lb, SparseBitmap)
    _same(lb, ref_filters.bitmap_of(RF.SelectorFilter("d", val), ref))
    k = lb.cardinality()

    def boom(self):
        raise AssertionError("SparseBitmap was densified")
    monkeypatch.setattr(SparseBitmap, "_dense", boom)
    monkeypatch.setattr(SparseBitmap, "words", property(boom))
    assert filter_cardinality(F.NotFilter(leaf), seg) == seg.n_rows - k
    assert estimate_selectivity(F.NotFilter(leaf), seg) == \
        (seg.n_rows - k) / seg.n_rows


def test_empty_dictionary_dim_exact():
    ref = _ref_segment()
    seg = _carry(ref)
    flt = F.InFilter("d", ("no-such-value", "also-missing"))
    rflt = RF.InFilter("d", ("no-such-value", "also-missing"))
    assert bitmap_of(flt, seg).cardinality() == 0
    assert estimate_selectivity(flt, seg) == 0.0 \
        == ref_filters.estimate_selectivity(rflt, ref)
    assert filter_cardinality(F.NotFilter(flt), seg) == seg.n_rows
    assert estimate_selectivity(F.NotFilter(flt), seg) == 1.0


def test_zero_cardinality_index_and_empty_segment():
    idx = BitmapIndex.build(np.zeros(0, dtype=np.int32), 0)
    assert idx.union_of(np.array([], dtype=np.int64)).cardinality() == 0
    assert idx.union_of(np.array([0, 3])).cardinality() == 0


def test_all_rows_match_exact():
    seg = _carry(_ref_segment(card=1))
    flt = F.SelectorFilter("d", seg.dims["d"].dictionary.values[0])
    assert filter_cardinality(flt, seg) == seg.n_rows
    assert estimate_selectivity(flt, seg) == 1.0
    assert estimate_selectivity(F.TrueFilter(), seg) == 1.0
    assert estimate_selectivity(F.FalseFilter(), seg) == 0.0
    assert estimate_selectivity(None, seg) == 1.0


def test_bitmap_of_matches_host_truth_on_mixed_tree():
    ref = _ref_segment(n_rows=3333, card=30)
    seg = _carry(ref)
    vals = seg.dims["d"].dictionary.values

    def tree(M):
        return M.OrFilter((
            M.AndFilter((M.InFilter("d", tuple(vals[:3])),
                         M.NotFilter(M.SelectorFilter("d", vals[1])))),
            M.SelectorFilter("d", vals[7])))
    want = host_mask(tree(F), seg).numpy()
    got = bitmap_of(tree(F), seg)
    assert np.array_equal(got.to_bool(), want)
    _same(got, ref_filters.bitmap_of(tree(RF), ref))
    assert filter_cardinality(tree(F), seg) == int(want.sum())


# ---------------------------------------------------------------------------
# packed uint32 device words
# ---------------------------------------------------------------------------

def test_words32_round_trip_lsb_first():
    n, padded = 3333, 3584
    rng = np.random.default_rng(5)
    mask = rng.random(n) < 0.3
    w = to_words32(Bitmap.from_bool(mask), padded)
    assert w.dtype == np.uint32 and w.shape == (padded // 32,)
    rows = np.arange(padded)
    bits = (w[rows // 32] >> (rows % 32).astype(np.uint32)) & 1
    assert np.array_equal(bits[:n].astype(bool), mask)
    assert not bits[n:].any()
    np.testing.assert_array_equal(
        w, ref_bitmap.to_words32(ref_bitmap.Bitmap.from_bool(mask), padded))
    with pytest.raises(ValueError):
        to_words32(Bitmap.from_bool(mask), 3000)


def test_device_repr_density_split():
    n = 4096
    kind, payload = device_repr(
        SparseBitmap(np.array([1, 2, 3], np.int32), n), n)
    assert kind == "sparse" and payload.dtype == np.int32
    assert payload.shape[0] == 8 and (payload[3:] == n).all()
    dense_bm = Bitmap.from_indices(np.arange(0, n, 3), n)
    kind, payload = device_repr(dense_bm, n)
    assert kind == "dense" and payload.dtype == np.uint32
    assert np.array_equal(payload, to_words32(dense_bm, n))


@pytest.mark.parametrize("count", [0, 1, 3, 8, 9, 100, 127, 128, 129, 500])
@pytest.mark.parametrize("as_sparse", [True, False])
def test_device_repr_equals_the_reference(count, as_sparse):
    """The reference's kind and payload for dense and sparse inputs, on
    both sides of the rung cutover (padded_rows 16384: sparse up to 512
    ids)."""
    n, padded = 16_000, 16_384
    ids = np.sort(np.random.default_rng(count).choice(n, count,
                                                      replace=False))
    if as_sparse:
        mine = SparseBitmap(ids.astype(np.int32), n)
        ref = ref_bitmap.SparseBitmap(ids.astype(np.int32), n)
    else:
        mine = Bitmap.from_indices(ids, n)
        ref = ref_bitmap.Bitmap.from_indices(ids, n)
    (k1, p1), (k2, p2) = device_repr(mine, padded), \
        ref_bitmap.device_repr(ref, padded)
    assert k1 == k2
    assert p1.dtype == p2.dtype
    np.testing.assert_array_equal(p1, p2)


def test_union_of_stays_sparse_and_exact():
    ref = _ref_segment(n_rows=4000, card=500, seed=11)
    col = _carry(ref).dims["d"]
    bm = col.bitmap_index().union_of(np.array([0, 1]))
    assert isinstance(bm, SparseBitmap)
    truth = np.isin(col.ids, [0, 1])
    assert np.array_equal(bm.to_bool(), truth)
    assert bm.cardinality() == int(truth.sum())
    _same(bm, ref.dims["d"].bitmap_index().union_of(np.array([0, 1])))


def test_rows_of_is_the_sorted_value_rows():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 70_000, 200_000).astype(np.int32)  # > 16 bits
    for card, col in ((70_000, ids), (300, ids % 300)):
        idx = BitmapIndex.build(col, card)
        for v in (0, 7, card - 1):
            np.testing.assert_array_equal(idx.rows_of(v),
                                          np.flatnonzero(col == v))


# ---------------------------------------------------------------------------
# filter leaves from the bitmap index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def leaf_segments(tmp_path_factory):
    """A 20,000-row segment with a uniform dim and a zipf one (the zipf tail
    is sparse), as three port segments: in memory without an index, in
    memory with its indexes built, and V2-loaded (persisted indexes)."""
    gen = DataGenerator((
        ColumnSpec("u", "string", cardinality=40),
        ColumnSpec("z", "string", cardinality=800, distribution="zipf"),
        ColumnSpec("m", "long", low=0, high=9)), seed=5)
    ref = gen.segment(20_000, IV, datasource="bm")
    plain, built = _carry(ref), _carry(ref)
    for col in built.dims.values():
        col.bitmap_index()
    d = str(tmp_path_factory.mktemp("leaf") / "v2")
    persist_segment_v2(_carry(ref), d)
    return plain, built, load_segment_v2(d)


LEAVES = {"u_half": ("u", lambda v: np.arange(v.cardinality) % 2 == 0,
                     "dense"),
          "z_head": ("z", lambda v: np.arange(v.cardinality) < 3, "dense"),
          "z_tail": ("z", lambda v: np.arange(v.cardinality) == 700,
                     "sparse"),
          "z_not_head": ("z", lambda v: np.arange(v.cardinality) > 0,
                         "dense"),
          "none": ("u", lambda v: np.zeros(v.cardinality, bool), "sparse")}


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_leaf_words_from_the_index_equal_lut_ids(leaf_segments, leaf,
                                                 permuted):
    plain, built, loaded = leaf_segments
    dim, make_lut, kind = LEAVES[leaf]
    lut = make_lut(plain.dims[dim].dictionary)
    padded = plain.padded_rows()
    perm = perm_key = None
    if permuted:
        perm = np.random.default_rng(9).permutation(plain.n_rows)
        perm_key = ("test-perm", 9)
    bits = lut[plain.dims[dim].ids]
    if perm is not None:
        bits = bits[perm]
    want = np.zeros(padded, bool)
    want[:plain.n_rows] = bits
    want_words = filters.host_words(want)
    for seg, expect_kind in ((plain, "rows"), (built, kind),
                             (loaded, kind)):
        got_kind, _ = filters.leaf_repr(seg, dim, lut, padded, perm,
                                        perm_key)
        assert got_kind == expect_kind
        np.testing.assert_array_equal(
            filters.leaf_bits(seg, dim, lut, padded, perm, perm_key), want)
        words = filters.leaf_words(seg, dim, lut, padded, CPU, perm,
                                   perm_key)
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(words.numpy(), want_words)
    assert not loaded.dims[dim].materialized()


def test_sparse_leaf_words_expand_on_the_device():
    padded = 4096
    ids = np.array([0, 31, 32, 63, 95, 1000, 4095], np.int32)
    payload = np.full(16, padded, np.int32)
    payload[:ids.shape[0]] = ids
    got = filters.sparse_leaf_words(torch.from_numpy(payload), padded)
    want = np.zeros(padded, bool)
    want[ids] = True
    assert got.dtype == torch.int32 and got.shape == (padded // 32,)
    np.testing.assert_array_equal(got.numpy(), filters.host_words(want))


def test_filtered_groupby_over_loaded_segments_leaves_filter_dims_lazy(
        tmp_path):
    """A groupBy on u filtered on z (a selector on a sparse tail value and
    an in over the head) over V2-loaded segments: the rows equal the
    in-memory segments' and the reference's, and z's ids never
    materialize (its leaves come from the persisted index)."""
    gen = DataGenerator((
        ColumnSpec("u", "string", cardinality=40),
        ColumnSpec("z", "string", cardinality=800, distribution="zipf"),
        ColumnSpec("m", "long", low=0, high=9)), seed=8)
    refs = gen.segments(2, 12_000, IV, datasource="bm")
    loaded = []
    for i, r in enumerate(refs):
        d = str(tmp_path / f"s{i}")
        persist_segment_v2(_carry(r), d)
        loaded.append(load_segment_v2(d))
    zvals = refs[0].dims["z"].dictionary.values
    for flt in ({"type": "selector", "dimension": "z", "value": zvals[700]},
                {"type": "in", "dimension": "z", "values": zvals[:5]},
                {"type": "not", "field": {"type": "in", "dimension": "z",
                                          "values": zvals[:2]}}):
        q = {"queryType": "groupBy", "dataSource": "bm",
             "intervals": ["2026-03-01/2026-03-02"], "granularity": "all",
             "dimensions": ["u"], "filter": flt,
             "aggregations": [{"type": "count", "name": "rows"},
                              {"type": "longSum", "name": "s",
                               "fieldName": "m"}]}
        got = QueryExecutor(loaded, device="cpu").run_json(q)
        assert got == QueryExecutor([_carry(r) for r in refs],
                                    device="cpu").run_json(q)
        assert got == RefExecutor(refs).run_json(q)
    assert all(not s.dims["z"].materialized() for s in loaded)
    assert all(s.dims["u"].materialized() for s in loaded)
