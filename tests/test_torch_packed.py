"""Bit-packed staging (druid_tpu_torch/data/packed.py) against the reference.

Columns made with numpy from a seed go through the reference's
`druid_tpu.data.packed` and the port's: the words must be equal bit for bit
at every width (a negative base and w16 slot-1 values >= 2^15 included),
every decode exact, and `plan_columns` equal on the same segments. Kernel
B1's packed-word input is held against the reference's `pallas_reduce` with
`packed_cols` (the Pallas kernel in interpret mode): the port's plain
version reads the dense view, so counts, long sums and min/max must agree
exactly and float sums within 1e-5 * sum|v| per group. The CUDA kernel reads
the words itself; chip_smoke.py holds it against the plain version and the
dense launch on the card.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import packed as ref_packed
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import pallas_agg
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade, packed
from druid_tpu_torch.engine import sorted_reduce as sr

from tests.test_torch_slice import _carry
from tests.test_torch_sorted_reduce import (_assert_parity, _kernel_pairs,
                                            _sorted_projection)

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)


def _column(rng, width, base, n=4096):
    """Values spanning the whole [base, base + 2^width) range; at w16 the
    rows of slot 1 (the word's top bit) hold values >= base + 2^15."""
    v = rng.integers(base, base + (1 << width), size=n).astype(np.int64)
    v[:2] = (base, base + (1 << width) - 1)
    if width == 16:
        tiles = v.reshape(-1, 128)
        tiles[1::2] = base + (1 << 15) + (tiles[1::2] - base) % (1 << 15)
    return v.astype(np.int32)


@pytest.mark.parametrize("width,base", [(4, 0), (8, 0), (16, 0), (4, -8),
                                        (8, -128), (16, -1024)])
def test_words_match_reference_bit_for_bit(width, base):
    rng = np.random.default_rng(width * 100 - base)
    v = _column(rng, width, base)
    words = packed.pack_padded(v, width, base)
    want = ref_packed.pack_padded(v, width, base)
    assert words.dtype == np.int32
    np.testing.assert_array_equal(words, want)
    if width == 16:
        assert (words < 0).any()                # slot 1's top bit is set
    np.testing.assert_array_equal(
        packed.unpack_host(words, width, base, v.shape[0]), v)
    pc = packed.PackedColumn(torch.from_numpy(words), width, base,
                             v.shape[0])
    np.testing.assert_array_equal(packed.unpack_device(pc).numpy(), v)
    np.testing.assert_array_equal(packed.unpack_host(pc), v)
    ref_pc = ref_packed.PackedColumn(np.asarray(want), width, base,
                                     v.shape[0])
    np.testing.assert_array_equal(np.asarray(ref_packed.unpack_device(ref_pc)),
                                  packed.unpack_device(pc).numpy())
    assert pc.nbytes * (32 // width) == pc.logical_nbytes


def test_pack_refuses_unaligned_length_and_wraps_padding():
    with pytest.raises(AssertionError):
        packed.pack_padded(np.zeros(1000, np.int32), 4, 0)
    # a padding fill outside the range wraps within its slot, as in the
    # reference, and leaves its neighbours alone
    v = np.zeros(1024, np.int32)
    v[-1] = -1
    np.testing.assert_array_equal(packed.pack_padded(v, 4, 0),
                                  ref_packed.pack_padded(v, 4, 0))
    np.testing.assert_array_equal(
        packed.unpack_host(packed.pack_padded(v, 4, 0), 4, 0, 1024)[:-1], 0)


@pytest.mark.parametrize("hi,base", [(0, 0), (15, 0), (16, 0), (255, 0),
                                     (65535, 0), (65536, 0), (9000, -512),
                                     (7, -8)])
def test_width_for_matches_reference(hi, base):
    assert packed.width_for(hi, base) == ref_packed.width_for(hi, base)


SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=12),
    ColumnSpec("dimB", "string", cardinality=300, distribution="zipf"),
    ColumnSpec("dimC", "string", cardinality=70_000),
    ColumnSpec("metLong", "long", low=0, high=10_000),
    ColumnSpec("metNeg", "long", low=-500, high=9_000),
    ColumnSpec("metWide", "long", low=0, high=1 << 20),
    ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
               std=40.0),
)


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(SCHEMA, seed=5).segments(
        2, 3_000, Interval.parse("2026-07-01/2026-07-02"), datasource="ds")
    return ref, [_carry(s) for s in ref]


def test_plan_columns_match_reference(segs):
    cols = ["dimA", "dimB", "dimC", "metLong", "metNeg", "metWide",
            "metFloat", "ghost"]
    for r, p in zip(*segs):
        plan = packed.plan_columns(p, cols)
        assert plan == ref_packed.plan_columns(r, cols)
        assert {c for c, _, _ in plan} == {"dimA", "dimB", "metLong",
                                           "metNeg"}
        assert dict((c, (w, b)) for c, w, b in plan)["metNeg"] == (16, -512)


def test_set_enabled_plans_nothing(segs):
    prev = packed.set_enabled(False)
    try:
        assert packed.plan_columns(segs[1][0], ["dimA", "metLong"]) == ()
    finally:
        packed.set_enabled(prev)
    assert packed.plan_columns(segs[1][0], ["dimA"]) == (("dimA", 4, 0),)


@pytest.mark.parametrize("width,lo,hi,n,groups,num_total", [
    (16, 0, 10_001, 20_480, 300, 512),     # the headline metLong, w16
    (16, -1024, 30_000, 12_288, 300, 512),  # negative base, slot-1 top bit
    (8, -128, 100, 9_216, 200, 200),       # G not a multiple of 128
    (4, -8, 7, 8_192, 5_000, 8192),        # BLK 1024: one w4 tile a block
])
def test_packed_input_matches_reference_kernel(width, lo, hi, n, groups,
                                               num_total, monkeypatch):
    """The reference's Pallas kernel reading metLong as words, against the
    port's B1 on the dense view of the same words."""
    import jax.numpy as jnp
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    rng = np.random.default_rng(width + n)
    key, mask, vlong, vfloat, span = _sorted_projection(rng, n, groups, lo,
                                                        hi)
    ref_k, port_k = _kernel_pairs(1 << 20)
    base = -(1 << ((-lo - 1).bit_length())) if lo < 0 else 0
    words = ref_packed.pack_padded(vlong, width, base)
    ref_pc = ref_packed.PackedColumn(jnp.asarray(words), width, base, n)
    rc, rs = pallas_agg.pallas_reduce(
        {"vlong": jnp.asarray(vlong), "vfloat": jnp.asarray(vfloat)},
        jnp.asarray(mask), jnp.asarray(key), ref_k, num_total, span,
        packed_cols={"vlong": ref_pc})
    pc = packed.PackedColumn(torch.from_numpy(
        packed.pack_padded(vlong, width, base)), width, base, n)
    packed_cols, view = cascade.split_resident(
        {"vlong": pc, "vfloat": torch.from_numpy(vfloat)})
    blk = sr.plan_window(span)[0]
    assert sr.packed_fields(["vfloat", "vlong"], packed_cols, blk, n) \
        == {"vlong": pc}
    before = cascade.decode_stats().get("packed", 0)
    got_c, got_s = sr.sorted_reduce(view, torch.from_numpy(mask),
                                    torch.from_numpy(key), port_k, num_total,
                                    span, packed_cols=packed_cols)
    # the plain version reads the dense view: one decode of the words
    assert cascade.decode_stats().get("packed", 0) - before == 1
    _assert_parity((np.asarray(rc), [np.asarray(s) for s in rs]),
                   (got_c.numpy(), [s.numpy() for s in got_s]),
                   key, mask, vfloat, num_total)


def test_packed_fields_follow_the_reference_rule():
    """Words go to the kernel only where a block is a whole number of word
    rows and the words cover the key's rows; otherwise the dense view."""
    words = torch.zeros(1024, dtype=torch.int32)
    w8 = packed.PackedColumn(words, 8, 0, 4096)
    w4 = packed.PackedColumn(words, 4, 0, 8192)
    assert sr.packed_fields(["a"], {"a": w8}, 2048, 4096) == {"a": w8}
    assert sr.packed_fields(["a"], {"a": w8}, 2048, 8192) == {}
    assert sr.packed_fields(["a"], {"a": w4}, 1024, 8192) == {"a": w4}
    assert sr.packed_fields(["a", "b"], None, 1024, 8192) == {}

