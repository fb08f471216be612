"""Kernel B2 and the device-bitmap planning of the port against the reference.

B2's plain PyTorch version (`druid_tpu_torch.engine.megakernel.mega_reduce` on
CPU tensors) against the reference's TPU kernel
(`druid_tpu.engine.megakernel.mega_reduce`, Pallas in interpret mode, as the
reference's own tests run it): the same sorted projections, made with numpy
from a seed, the same leaf bitmaps and the same and/or/not structures. The
reference gets its leaf words in its width-1 tile-planar layout
(`data/packed.pack_padded`), the port in its LSB-first layout. Counts, long
sums and min/max must be exact (NaN included); float sums agree within
1e-5 * sum|v| per group (the two sum in different orders). The CUDA leg is
held against the plain version, and against B1, by chip_smoke.py on the card.

Also: the word algebra, the mask-word pack/expand helpers and the staged
fill against numpy, and the planner's bitmap nodes (structure, digest, LUTs,
the megakernel split) against the reference's for the same filter and data.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import packed as ref_packed
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import DEFAULT_ROW_ALIGN
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine import megakernel as ref_mk
from druid_tpu.engine import pallas_agg
from druid_tpu.query.filters import filter_from_json as ref_filter_json
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.data.convert import segment_from_arrays
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import megakernel as port_mk
from druid_tpu_torch.engine import sorted_reduce as sr
from druid_tpu_torch.query.filters import filter_from_json as port_filter_json
from tests.test_torch_sorted_reduce import (_assert_parity, _kernel_pairs,
                                            _shaped, _sorted_projection)

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)


def _eval_bits(structure, leaves):
    """numpy bool evaluation of a structure over leaf bool rows."""
    op = structure[0]
    if op == "leaf":
        return leaves[structure[1]]
    if op == "const":
        return np.full(leaves[0].shape, structure[1])
    if op == "not":
        return ~_eval_bits(structure[1], leaves)
    kids = [_eval_bits(c, leaves) for c in structure[1]]
    out = kids[0]
    for k in kids[1:]:
        out = (out & k) if op == "and" else (out | k)
    return out


def _round_up(x, m):
    return -(-x // m) * m


def _run_b2(key, mask, vlong, vfloat, nodes, num_total, span, chunk_rows,
            monkeypatch):
    """nodes: [(structure, [leaf bool rows])]; returns (ref, port) results
    and the effective row mask."""
    import jax.numpy as jnp
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    n = key.shape[0]
    ref_k, port_k = _kernel_pairs(chunk_rows)
    ref_arrays = {"vlong": jnp.asarray(vlong), "vfloat": jnp.asarray(vfloat)}
    port_arrays = {"vlong": torch.from_numpy(vlong),
                   "vfloat": torch.from_numpy(vfloat)}
    ref_nodes, port_nodes = [], []
    eff = mask.copy()
    for slot, (structure, leaf_rows) in enumerate(nodes):
        leaves = [("d", np.ones(1, bool)) for _ in leaf_rows]
        rn = ref_mk.MegaBitmapNode(structure, leaves, slot)
        pn = port_mk.MegaBitmapNode(structure, leaves, slot)
        for j, bits in enumerate(leaf_rows):
            padded = np.zeros(_round_up(max(n, 1), 4096), dtype=bool)
            padded[:n] = bits
            ref_arrays[rn.leaf_col(j)] = jnp.asarray(
                ref_packed.pack_padded(padded, 1, 0))
            port_arrays[pn.leaf_col(j)] = torch.from_numpy(
                port_filters.host_words(padded[:_round_up(n, 32)]))
        ref_nodes.append(rn)
        port_nodes.append(pn)
        eff &= _eval_bits(structure, leaf_rows)
    rc, rs, _ = ref_mk.mega_reduce(ref_arrays, jnp.asarray(mask),
                                   jnp.asarray(key), ref_nodes, ref_k,
                                   num_total, span)
    before = port_mk.PLAIN_CALLS
    pc, ps = port_mk.mega_reduce(port_arrays, torch.from_numpy(mask),
                                 torch.from_numpy(key), port_nodes, port_k,
                                 num_total, span)
    assert port_mk.PLAIN_CALLS == before + 1
    return ((np.asarray(rc), [np.asarray(s) for s in rs]),
            (pc.numpy(), [s.numpy() for s in ps]), eff)


AND_NOT = ("and", (("leaf", 0), ("not", ("leaf", 1))))
OR_AND = ("or", (("and", (("leaf", 0), ("leaf", 1))), ("not", ("leaf", 2))))


def _leaves(rng, n, k, p=0.7):
    return [rng.random(n) < p for _ in range(k)]


@pytest.mark.parametrize("case", [
    # n a multiple of neither 32 nor 4096; one node with and/not
    dict(seed=21, n=9_001, groups=300, lo=-1000, hi=1000, num_total=512,
         chunk=1 << 20, nodes=[AND_NOT]),
    # two mega nodes plus a residual (base) mask
    dict(seed=22, n=20_000, groups=700, lo=-50, hi=50, num_total=1024,
         chunk=1 << 20, nodes=[AND_NOT, OR_AND]),
    # int32 sums past 2^31 per group, across the reference's limb flushes
    dict(seed=23, n=64_000, groups=6, lo=400_000, hi=460_000, num_total=8,
         chunk=4096, nodes=[OR_AND]),
    # one key over five whole 2048-row blocks, masked rows and a NaN inside
    # it, its sum past 2^31; n % 32 != 0
    dict(seed=24, n=20_001, groups=300, lo=400_000, hi=460_000,
         num_total=512, chunk=4096, nodes=[OR_AND], shape="head-run"),
])
def test_b2_plain_matches_reference_kernel(case, monkeypatch):
    rng = np.random.default_rng(case["seed"])
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, case["n"], case["groups"], case["lo"], case["hi"])
    if "shape" in case:
        key, mask, vfloat, span = _shaped(case["shape"], rng, key, mask,
                                          vfloat)
    nodes = [(s, _leaves(rng, case["n"], 3 if s is OR_AND else 2))
             for s in case["nodes"]]
    ref, port, eff = _run_b2(key, mask, vlong, vfloat, nodes,
                             case["num_total"], span, case["chunk"],
                             monkeypatch)
    if case["lo"] >= 200_000:
        assert port[1][1].max() > 2 ** 31
    assert 0 < int(port[0].sum()) < int(mask.sum())
    _assert_parity(ref, port, key, eff, np.nan_to_num(vfloat),
                   case["num_total"])


def test_b2_plain_fully_masked_blocks_and_nan(monkeypatch):
    """Leaf bits zero over two whole 2048-row blocks: those blocks hold no
    live row (the kernel marks them and skips them); a NaN reaches float
    max through a row the words keep."""
    rng = np.random.default_rng(25)
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, 12_000, 400, 0, 100)
    leaves = _leaves(rng, 12_000, 2)
    leaves[0][2048:6144] = False
    vfloat[100] = np.nan
    mask[100], leaves[0][100], leaves[1][100] = True, True, False
    ref, port, eff = _run_b2(key, mask, vlong, vfloat, [(AND_NOT, leaves)],
                             512, span, 1 << 20, monkeypatch)
    assert eff[100] and not eff[2048:6144].any()
    assert np.isnan(port[1][4]).any()
    _assert_parity(ref, port, key, eff, np.nan_to_num(vfloat), 512)


def test_b2_plain_all_rows_masked(monkeypatch):
    rng = np.random.default_rng(26)
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, 5_000, 100, 0, 100)
    leaves = _leaves(rng, 5_000, 2)
    leaves[1][:] = True                       # and(leaf0, not all) = nothing
    ref, port, eff = _run_b2(key, mask, vlong, vfloat, [(AND_NOT, leaves)],
                             128, span, 1 << 20, monkeypatch)
    assert not eff.any() and port[0].sum() == 0
    _assert_parity(ref, port, key, eff, vfloat, 128)


def test_b2_plain_equals_b1_plain_on_the_same_mask():
    """B2 on words and B1 on the same bits as bools give the same bits,
    floats included (chip_smoke.py holds the two kernels to the same)."""
    rng = np.random.default_rng(27)
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, 30_001, 2000, -100, 100)
    _, port_k = _kernel_pairs(1 << 20)
    arrays = {"vlong": torch.from_numpy(vlong),
              "vfloat": torch.from_numpy(vfloat)}
    words = port_filters.pack_mask_words(torch.from_numpy(mask))
    a = port_mk.mega_reduce_plain(arrays, words, torch.from_numpy(key),
                                  port_k, 2048, span)
    b = sr.sorted_reduce_plain(arrays, torch.from_numpy(mask),
                               torch.from_numpy(key), port_k, 2048, span)
    for x, y in zip((a[0],) + tuple(a[1]), (b[0],) + tuple(b[1])):
        assert x.dtype == y.dtype
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)


# ---------------------------------------------------------------------------
# words: algebra, pack/expand, staged fill
# ---------------------------------------------------------------------------

def _rand_structure(rng, n_leaves, depth):
    if depth == 0 or rng.random() < 0.3:
        if rng.random() < 0.1:
            return ("const", bool(rng.integers(2)))
        return ("leaf", int(rng.integers(n_leaves)))
    op = ("and", "or", "not")[rng.integers(3)]
    if op == "not":
        return ("not", _rand_structure(rng, n_leaves, depth - 1))
    return (op, tuple(_rand_structure(rng, n_leaves, depth - 1)
                      for _ in range(int(rng.integers(2, 4)))))


@pytest.mark.parametrize("seed", range(8))
def test_combine_structure_words_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    n = 32 * 37
    leaves = _leaves(rng, n, 4, p=0.5)
    words = [torch.from_numpy(port_filters.host_words(b)) for b in leaves]
    structure = _rand_structure(rng, 4, 4)

    def const_words(v):
        return torch.full((n // 32,), -1 if v else 0, dtype=torch.int32)

    got = port_filters.combine_structure_words(
        structure, lambda i: words[i], const_words)
    assert got.dtype == torch.int32
    want = _eval_bits(structure, leaves)
    np.testing.assert_array_equal(
        port_filters.expand_mask_words(got, n).numpy(), want)


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4096, 9_001])
def test_pack_expand_round_trip_matches_reference_bits(n):
    """The port's pack is the LSB-first layout (np.packbits little), bit 31
    included; expanding gives back the reference's expand_mask_words bits of
    the same rows packed in its own layout."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n)
    bits = rng.random(n) < 0.5
    bits[31::32] = True                        # every word's sign bit
    words = port_filters.pack_mask_words(torch.from_numpy(bits))
    assert words.dtype == torch.int32 and words.shape[0] == -(-n // 32)
    padded = np.zeros(_round_up(n, 32), dtype=bool)
    padded[:n] = bits
    np.testing.assert_array_equal(words.numpy(),
                                  port_filters.host_words(padded))
    ref_padded = np.zeros(_round_up(n, 4096), dtype=bool)
    ref_padded[:n] = bits
    ref_bits = np.asarray(ref_mk.expand_mask_words(
        jnp.asarray(ref_packed.pack_padded(ref_padded, 1, 0)), n))
    np.testing.assert_array_equal(
        port_filters.expand_mask_words(words, n).numpy(), ref_bits)


@pytest.mark.parametrize("ones", [3, 40, 2000])
def test_staged_fill_sparse_and_dense_leaves(ones):
    """Leaves with few and with many matching rows stage as the same int32
    words: the fused path reads filters.leaf_words' cached tensor, except
    for a dimension with run tables in the segment's row order, whose mega
    leaf is built once per run under its own key and holds the same bits;
    the staged fill's combined words, in the segment's row order and
    permuted, are the numpy algebra's bits, and equal the fused node's
    words."""
    rng = np.random.default_rng(ones)
    n = 4000
    d = np.zeros(n, dtype=np.int32)
    d[rng.choice(n, ones, replace=False)] = 1
    d[31] = 1                                  # a sign bit
    e = rng.integers(0, 4, n).astype(np.int32)
    seg = segment_from_arrays(
        np.full(n, IV.start, dtype=np.int64),
        {"d": (d, ["a", "b"]), "e": (e, ["w", "x", "y", "z"])}, {}, "fill",
        (IV.start, IV.end))
    node = port_filters.plan_filter(port_filter_json(
        {"type": "or", "fields": [
            {"type": "selector", "dimension": "d", "value": "b"},
            {"type": "not", "field": {"type": "in", "dimension": "e",
                                      "values": ["x", "y"]}}]}),
        seg, device_bitmap=True)
    assert isinstance(node, port_filters.DeviceBitmapNode)
    rows, cpu = seg.padded_rows(), torch.device("cpu")
    want = (d == 1) | ~np.isin(e, [1, 2])
    perm = rng.permutation(n)
    for p, pk, bits in ((None, None, want), (perm, ("perm", ones),
                                             want[perm])):
        words = port_filters.stage_device_bitmaps(seg, node, rows, cpu, p,
                                                  pk)[node.col]
        # padding rows are 0 in every leaf, so not(in) sets them (the
        # aggregation's valid mask drops them)
        padded = np.ones(rows, dtype=bool)
        padded[:n] = bits
        np.testing.assert_array_equal(words.numpy(),
                                      port_filters.host_words(padded))
        mega = port_mk.MegaBitmapNode.from_bitmap(node)
        leaves = port_mk.stage_mega_leaves(seg, mega, rows, cpu, p, pk)
        for j, (dim, lut) in enumerate(node.leaves):
            shared = port_filters.leaf_words(seg, dim, lut, rows, cpu, p, pk)
            runs = p is None \
                and port_cascade.column_run_info(seg, dim) is not None
            assert torch.equal(leaves[mega.leaf_col(j)], shared)
            assert (leaves[mega.leaf_col(j)] is shared) == (not runs)
        assert torch.equal(mega.words(leaves), words)


# ---------------------------------------------------------------------------
# planning parity: the same filter on the same segment
# ---------------------------------------------------------------------------

IV = Interval.of("2026-05-01", "2026-05-05")
SCHEMA = (
    ColumnSpec("dLo", "string", cardinality=8),
    ColumnSpec("dMid", "string", cardinality=60),
    ColumnSpec("dHi", "string", cardinality=800, distribution="zipf"),
    ColumnSpec("metLong", "long", low=0, high=1000),
)


@pytest.fixture(scope="module")
def seg_pair():
    ref = DataGenerator(SCHEMA, seed=41).segments(1, 3333, IV,
                                                  datasource="mk")[0]
    port = segment_from_arrays(
        ref.time_ms,
        {n: (c.ids, c.dictionary.values) for n, c in ref.dims.items()},
        {n: (m.type.value, m.values) for n, m in ref.metrics.items()},
        "mk", (ref.interval.start, ref.interval.end))
    return ref, port


def _vals(seg, dim, idx):
    vals = list(seg.dims[dim].dictionary.values)
    return [vals[i] for i in idx]


def _filters(seg):
    sel = {"type": "selector", "dimension": "dHi",
           "value": _vals(seg, "dHi", [0])[0]}
    ins = {"type": "in", "dimension": "dLo",
           "values": _vals(seg, "dLo", [0, 2, 4, 6])}
    bnd = {"type": "bound", "dimension": "metLong", "lower": "100",
           "upper": "900", "ordering": "numeric"}
    lex = {"type": "bound", "dimension": "dMid",
           "lower": _vals(seg, "dMid", [10])[0],
           "upper": _vals(seg, "dMid", [40])[0], "lowerStrict": True}
    return [
        {"type": "and", "fields": [ins, {"type": "not", "field": sel}, bnd]},
        ins,
        {"type": "or", "fields": [sel, lex]},
        {"type": "or", "fields": [sel, bnd]},
        {"type": "not", "field": {"type": "and", "fields": [ins, bnd]}},
        {"type": "and", "fields": [
            {"type": "or", "fields": [ins, lex]}, bnd,
            {"type": "not", "field": sel}]},
        {"type": "and", "fields": [bnd, {"type": "selector",
                                         "dimension": "ghost",
                                         "value": "x"}]},
    ]


def _shape(node, mega_cls):
    """A package-neutral rendering of a planned tree."""
    name = type(node).__name__
    if isinstance(node, mega_cls):
        return ("mega", node.slot, node.structure_sig(), node.digest())
    if hasattr(node, "structure"):
        return ("bitmap", node.slot, node.structure_sig(), node.digest())
    if hasattr(node, "children"):
        return (name, tuple(_shape(c, mega_cls) for c in node.children))
    if hasattr(node, "child"):
        return (name, _shape(node.child, mega_cls))
    return (name,)


@pytest.mark.parametrize("i", range(7))
def test_bitmap_planning_matches_reference(seg_pair, i):
    ref_seg, port_seg = seg_pair
    j = _filters(ref_seg)[i]
    prev = ref_filters.set_device_bitmap_enabled(True)
    try:
        rn = ref_filters.simplify_node(ref_filters.plan_filter(
            ref_filter_json(j), ref_seg))
        ref_filters.assign_bitmap_slots(rn, [])
    finally:
        ref_filters.set_device_bitmap_enabled(prev)
    pn = port_filters.plan_filter(port_filter_json(j), port_seg,
                                  device_bitmap=True)
    rb = ref_filters.collect_bitmap_nodes(rn)
    pb = port_filters.collect_bitmap_nodes(pn)
    assert [(b.slot, b.structure, b.structure_sig(), b.digest()) for b in rb] \
        == [(b.slot, b.structure, b.structure_sig(), b.digest()) for b in pb]
    for a, b in zip(rb, pb):
        assert [d for d, _ in a.leaves] == [d for d, _ in b.leaves]
        for (_, la), (_, lb) in zip(a.leaves, b.leaves):
            np.testing.assert_array_equal(la, lb)
    assert _shape(rn, ref_mk.MegaBitmapNode) \
        == _shape(pn, port_mk.MegaBitmapNode)
    # nothing cached: every bitmap node fuses; the kernel split agrees
    padded = max(DEFAULT_ROW_ALIGN, _round_up(ref_seg.n_rows,
                                              DEFAULT_ROW_ALIGN))
    rm = ref_mk.megaize(rn, ref_seg, padded)
    pm = port_mk.megaize(pn, port_seg, port_seg.padded_rows(),
                         torch.device("cpu"))
    assert len(port_mk.collect_mega_nodes(pm)) == len(pb)
    (rmeg, rres), (pmeg, pres) = (ref_mk.split_for_kernel(rm),
                                  port_mk.split_for_kernel(pm))
    assert [_shape(m, ref_mk.MegaBitmapNode) for m in rmeg] \
        == [_shape(m, port_mk.MegaBitmapNode) for m in pmeg]
    assert (rres is None) == (pres is None)
    if rres is not None:
        assert _shape(rres, ref_mk.MegaBitmapNode) \
            == _shape(pres, port_mk.MegaBitmapNode)


def test_row_domain_planning_without_bitmaps(seg_pair):
    """device_bitmap=False plans the same filters to row-domain nodes
    only, reading the filter's dimensions."""
    _, port_seg = seg_pair
    j = _filters(port_seg)[0]
    pn = port_filters.plan_filter(port_filter_json(j), port_seg,
                                  device_bitmap=False)
    assert port_filters.collect_bitmap_nodes(pn) == []
    assert pn.required_device_columns() == {"dLo", "dHi", "metLong"}
    pb = port_filters.plan_filter(port_filter_json(j), port_seg)
    assert pb.required_device_columns() == {"metLong"}
