"""Kernel B1's plain PyTorch version against the reference TPU kernel.

The same sorted projections, made with numpy from a seed, go through
`druid_tpu.engine.pallas_agg.pallas_reduce` (the Pallas kernel in interpret
mode, as tests/test_pallas_interpret.py runs it) and through
`druid_tpu_torch.engine.sorted_reduce.sorted_reduce` on CPU tensors (its
plain version). Counts, long sums and min/max must be bit-exact (NaN
included); float sums agree within 1e-5 * sum|v| per group, because the two
sum in different orders. The CUDA leg of the same function is held against
the plain version by chip_smoke.py on the card.
"""
import re

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.segment import ValueType as RefValueType
from druid_tpu.engine import kernels as ref_kernels
from druid_tpu.engine import pallas_agg
from druid_tpu.query import aggregators as RA

from druid_tpu_torch import _build
from druid_tpu_torch.data.segment import ValueType
from druid_tpu_torch.engine import kernels as port_kernels
from druid_tpu_torch.engine import sorted_reduce as sr
from druid_tpu_torch.query import aggregators as PA

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

INT32_MAX = 2 ** 31 - 1


def _sorted_projection(rng, n, groups, lo, hi, keep=0.9):
    """Sorted compact keys (the Projection layout) + value columns."""
    key = np.sort(rng.integers(0, groups, size=n)).astype(np.int32)
    mask = rng.random(n) < keep
    vlong = rng.integers(lo, hi, size=n).astype(np.int32)
    vfloat = rng.normal(0.0, 100.0, size=n).astype(np.float32)
    return key, mask, vlong, vfloat, _span(key)


def _span(key):
    """The widest key range of any SPAN_BLOCK rows (Projection.max_span)."""
    pad = (-key.shape[0]) % sr.SPAN_BLOCK
    kp = np.concatenate([key, np.full(pad, key[-1], np.int32)]) if pad else key
    kb = kp.reshape(-1, sr.SPAN_BLOCK)
    return int((kb.max(axis=1) - kb.min(axis=1) + 1).max())


LONG_RUN = (1500, 1500 + 6 * 2048 + 300)   # fills five 2048-row blocks


def _shaped(shape, rng, key, mask, vfloat):
    """The run shapes the CUDA partial pass joins across threads and warps:
    "long-run", one key over LONG_RUN (starting and ending mid-block) with
    the masked rows of the projection inside it; "head-run", the same with
    a live NaN in its middle; "shuffled", every SPAN_BLOCK rows permuted
    in place (the sorted plan, many runs per slot); "runs-31-32-33", runs
    of 31, 32 and 33 rows in turn. Returns (key, mask, vfloat, span)."""
    if shape in ("long-run", "head-run"):
        lo, hi = LONG_RUN
        key[lo:hi] = key[lo]                  # still sorted
        if shape == "head-run":
            mid = (lo + hi) // 2
            vfloat[mid], mask[mid] = np.nan, True
    elif shape == "shuffled":
        key = np.stack([rng.permutation(b) for b in
                        key.reshape(-1, sr.SPAN_BLOCK)]).reshape(-1)
    elif shape == "runs-31-32-33":
        lengths = np.resize([31, 32, 33], key.shape[0] // 31 + 1)
        key = np.repeat(np.arange(lengths.shape[0], dtype=np.int32),
                        lengths)[:key.shape[0]]
    return key, mask, vfloat, _span(key)


def _kernel_pairs(chunk_rows):
    """The same five aggregators in both packages."""
    ref = [ref_kernels.CountKernel(RA.CountAggregator("rows")),
           ref_kernels.SumKernel(RA.LongSumAggregator("lsum", "vlong"),
                                 RefValueType.LONG),
           ref_kernels.SumKernel(RA.FloatSumAggregator("fsum", "vfloat"),
                                 RefValueType.FLOAT),
           ref_kernels.MinMaxKernel(RA.LongMinAggregator("lmin", "vlong"),
                                    RefValueType.LONG, False),
           ref_kernels.MinMaxKernel(RA.FloatMaxAggregator("fmax", "vfloat"),
                                    RefValueType.FLOAT, True)]
    port = [port_kernels.CountKernel(PA.CountAggregator("rows")),
            port_kernels.SumKernel(PA.LongSumAggregator("lsum", "vlong"),
                                   ValueType.LONG),
            port_kernels.SumKernel(PA.FloatSumAggregator("fsum", "vfloat"),
                                   ValueType.FLOAT),
            port_kernels.MinMaxKernel(PA.LongMinAggregator("lmin", "vlong"),
                                      ValueType.LONG, False),
            port_kernels.MinMaxKernel(PA.FloatMaxAggregator("fmax", "vfloat"),
                                      ValueType.FLOAT, True)]
    ref[1].chunk_rows = port[1].chunk_rows = chunk_rows
    return ref, port


def _run_both(key, mask, vlong, vfloat, num_total, span, chunk_rows,
              monkeypatch):
    import jax.numpy as jnp
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    ref_k, port_k = _kernel_pairs(chunk_rows)
    dts = {"vlong": np.dtype(np.int32), "vfloat": np.dtype(np.float32)}
    assert pallas_agg.usable(ref_k, dts, span, num_total)
    assert sr.usable(port_k, dts, span, num_total)
    rc, rs = pallas_agg.pallas_reduce(
        {"vlong": jnp.asarray(vlong), "vfloat": jnp.asarray(vfloat)},
        jnp.asarray(mask), jnp.asarray(key), ref_k, num_total, span)
    pc, ps = sr.sorted_reduce(
        {"vlong": torch.from_numpy(vlong), "vfloat": torch.from_numpy(vfloat)},
        torch.from_numpy(mask), torch.from_numpy(key), port_k, num_total,
        span)
    return ((np.asarray(rc), [np.asarray(s) for s in rs]),
            (pc.numpy(), [s.numpy() for s in ps]))


def _assert_parity(ref, port, key, mask, vfloat, num_total):
    (rc, rs), (pc, ps) = ref, port
    np.testing.assert_array_equal(pc.astype(np.int64), rc.astype(np.int64))
    np.testing.assert_array_equal(ps[0].astype(np.int64),
                                  rs[0].astype(np.int64))
    np.testing.assert_array_equal(ps[1].astype(np.int64),
                                  rs[1].astype(np.int64))
    assert ps[1].dtype == np.int64
    # float sums: |port - ref| <= 1e-5 * sum|v| per group (summation order)
    absum = np.zeros(num_total, np.float64)
    np.add.at(absum, key[mask], np.abs(vfloat[mask].astype(np.float64)))
    np.testing.assert_array_equal(np.isnan(ps[2]), np.isnan(rs[2]))
    fin = ~np.isnan(rs[2])
    assert np.all(np.abs(ps[2][fin].astype(np.float64)
                         - rs[2][fin].astype(np.float64))
                  <= 1e-5 * absum[fin])
    np.testing.assert_array_equal(ps[3], rs[3])
    np.testing.assert_array_equal(ps[4], rs[4])      # NaN compares equal


@pytest.mark.parametrize("case", [
    # test_pallas_interpret.py:81 — count/sum/min/max
    dict(seed=11, n=20_000, groups=300, lo=-1000, hi=1000, num_total=512,
         chunk=1 << 20),
    # test_pallas_interpret.py:101 / test_strategies.py:256 — totals far
    # above int32 across the reference's limb flushes
    dict(seed=7, n=64_000, groups=6, lo=300_000, hi=360_000, num_total=8,
         chunk=4096),
    # G not a multiple of 128
    dict(seed=3, n=9_000, groups=200, lo=-50, hi=50, num_total=200,
         chunk=1 << 20),
    # whole-block runs of one key with masked rows inside, sums past int32
    dict(seed=31, n=20_000, groups=300, lo=300_000, hi=360_000,
         num_total=512, chunk=4096, shape="long-run"),
    # a NaN inside a long run
    dict(seed=32, n=20_000, groups=300, lo=-1000, hi=1000, num_total=512,
         chunk=1 << 20, shape="head-run"),
    # keys shuffled within each 1024-row span block
    dict(seed=33, n=19_456, groups=400, lo=-100, hi=100, num_total=512,
         chunk=1 << 20, shape="shuffled"),
    # runs of 31, 32 and 33 rows
    dict(seed=34, n=20_000, groups=1, lo=-50, hi=50, num_total=640,
         chunk=1 << 20, shape="runs-31-32-33"),
])
def test_plain_matches_reference_kernel(case, monkeypatch):
    rng = np.random.default_rng(case["seed"])
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, case["n"], case["groups"], case["lo"], case["hi"])
    if "shape" in case:
        key, mask, vfloat, span = _shaped(case["shape"], rng, key, mask,
                                          vfloat)
    ref, port = _run_both(key, mask, vlong, vfloat, case["num_total"], span,
                          case["chunk"], monkeypatch)
    if case["lo"] >= 200_000:
        assert port[1][1].max() > 2 ** 31       # the sums overflow int32
    if case.get("shape") == "head-run":
        assert np.isnan(port[1][4]).any()       # the NaN reached float max
    _assert_parity(ref, port, key, mask, np.nan_to_num(vfloat),
                   case["num_total"])


def test_plain_fully_masked_blocks_and_nan(monkeypatch):
    """test_strategies.py:281 — whole blocks masked (their min key is the
    sentinel, clamped to G2 - W) contribute nothing; a NaN reaches float max."""
    rng = np.random.default_rng(5)
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, 12_000, 400, 0, 100)
    mask[2048:6144] = False                    # two whole 2048-row blocks
    vfloat[100] = np.nan
    mask[100] = True
    ref, port = _run_both(key, mask, vlong, vfloat, 512, span, 1 << 20,
                          monkeypatch)
    assert np.isnan(port[1][4]).any()
    _assert_parity(ref, port, key, mask, np.nan_to_num(vfloat), 512)


def test_plain_all_rows_masked(monkeypatch):
    rng = np.random.default_rng(9)
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, 5_000, 100, 0, 100)
    mask[:] = False
    ref, port = _run_both(key, mask, vlong, vfloat, 128, span, 1 << 20,
                          monkeypatch)
    assert port[0].sum() == 0
    _assert_parity(ref, port, key, mask, vfloat, 128)


def test_plain_wide_window_blk1024(monkeypatch):
    """A span too wide for BLK 2048 plans BLK 1024 (the wide-window path)."""
    rng = np.random.default_rng(13)
    key, mask, vlong, vfloat, span = _sorted_projection(
        rng, 8_192, 5_000, -10, 10)
    assert sr.plan_window(span)[0] == sr.BLK_WIDE_W
    assert sr.plan_window(span) == pallas_agg.plan_window(span)
    ref, port = _run_both(key, mask, vlong, vfloat, 8192, span, 1 << 20,
                          monkeypatch)
    _assert_parity(ref, port, key, mask, vfloat, 8192)


def test_partial_threads_match_cuda_source():
    """PARTIAL_THREADS is the CUDA block size of the partial pass, and every
    planned BLK gives each thread a multiple of 4 rows (the launch refuses
    anything else)."""
    src = (_build.CSRC / "sorted_reduce.cu").read_text()
    threads = int(re.search(r"#define SR_THREADS (\d+)", src).group(1))
    assert sr.PARTIAL_THREADS == threads
    for blk in (sr.BLK_SMALL_W, sr.BLK_WIDE_W):
        assert blk % (4 * sr.PARTIAL_THREADS) == 0


def test_usable_matches_reference_caps():
    ref_k, port_k = _kernel_pairs(1 << 20)
    dts = {"vlong": np.dtype(np.int32), "vfloat": np.dtype(np.float32)}
    f64 = {"vlong": np.dtype(np.int32), "vfloat": np.dtype(np.float64)}
    pallas_agg.force_interpret(True)
    try:
        for args in [(dts, 16, 512), (dts, 16, sr.MAX_PALLAS_GROUPS + 1),
                     (dts, sr.MAX_W + 1, 512), (f64, 16, 512)]:
            assert sr.usable(port_k, *args) == pallas_agg.usable(ref_k, *args)
    finally:
        pallas_agg.force_interpret(False)
