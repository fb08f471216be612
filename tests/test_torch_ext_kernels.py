"""The port's extension kernels (druid_tpu_torch/ext/) against the reference
package's, one update at a time.

Each case parses one aggregator's JSON in both packages, builds both
kernels over the same segment (the port's carried as plain arrays), runs
one `update` over the same staged columns, row mask and group keys (made
from a seed), and compares the `host_post` states: equal bit for bit
(quantile and histogram counts, histogram min/max, theta bucket minima,
bloom bits, distinct counts, time min/max, variance n), and variance's
float64 sum and sumsq within 1e-12 * sum|v| and 1e-12 * sum v^2 per group
(`index_add_` adds in no fixed order). The float column carries NaN,
+-inf, +-0, the least normal double, 1e300 and negative values; the
histogram's limits put rows above and below the grid (its saturating
cast), and theta runs with a size that is not a power of two on integer
and float columns. The
reference's update runs eagerly with JAX on the CPU.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ext  # noqa: F401  (registers the reference's extensions)
import jax.numpy as jnp
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import NumericColumn, ValueType
from druid_tpu.engine import kernels as ref_kernels
from druid_tpu.query.aggregators import agg_from_json as ref_agg
from druid_tpu.utils.intervals import Interval

import druid_tpu_torch.ext  # noqa: F401  (registers the port's extensions)
from druid_tpu_torch.engine import kernels as port_kernels
from druid_tpu_torch.ext import histogram, sketches
from druid_tpu_torch.query.aggregators import agg_from_json as port_agg
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

N, G = 4000, 7
EDGES = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5e-308, 1e300,
                    -1e300, -3.5, 2.5e-9, 200.0, 199.999, -1.0],
                   dtype=np.float64)


@pytest.fixture(scope="module")
def seg():
    schema = (ColumnSpec("dimA", "string", cardinality=5),
              ColumnSpec("dimB", "string", cardinality=90,
                         distribution="zipf"),
              ColumnSpec("metLong", "long", low=-700, high=9000),
              ColumnSpec("metFloat", "float", distribution="normal",
                         mean=100.0, std=25.0))
    ref = DataGenerator(schema, seed=11).segment(
        N, Interval.of("2026-02-01", "2026-02-02"), datasource="k")
    d = ref.metrics["metFloat"].values.astype(np.float64)
    d[:len(EDGES)] = EDGES
    ref.metrics["metDouble"] = NumericColumn(d, ValueType.DOUBLE)
    return ref, _carry(ref)


def _inputs(ref, seed):
    rng = np.random.default_rng(seed)
    cols = {"__time_offset": (ref.time_ms - ref.interval.start)
            .astype(np.int32)}
    for n, c in ref.dims.items():
        cols[n] = c.ids.astype(np.int32)
    for n, m in ref.metrics.items():
        cols[n] = m.values.astype(np.int32) if m.type is ValueType.LONG \
            else m.values
    mask = rng.random(N) < 0.8
    keys = rng.integers(0, G, N)
    keys[:len(EDGES)] = 0              # the edge values meet in group 0
    mask[:len(EDGES)] = True
    return cols, mask, keys


def _ref_state(k, ref, cols, mask, keys):
    aux = iter([jnp.asarray(a) for a in k.aux_arrays()])
    st = k.update({n: jnp.asarray(v) for n, v in cols.items()},
                  jnp.asarray(mask), jnp.asarray(keys, dtype=jnp.int32),
                  G, aux)
    return k.host_post(st, ref)


def _port_state(k, port, cols, mask, keys):
    st = k.update({n: torch.from_numpy(v) for n, v in cols.items()},
                  torch.from_numpy(mask), torch.from_numpy(keys), G)
    return k.host_post(st, port)


CASES = {
    "variance_float": {"type": "variance", "name": "v",
                       "fieldName": "metFloat"},
    "variance_long_sample": {"type": "variance", "name": "v",
                             "fieldName": "metLong", "estimator": "sample"},
    "variance_time": {"type": "variance", "name": "v", "fieldName": "__time"},
    "theta_dim": {"type": "thetaSketch", "name": "t", "fieldName": "dimB"},
    "theta_dim_1000": {"type": "thetaSketch", "name": "t",
                       "fieldName": "dimB", "size": 1000},
    "theta_long_1000": {"type": "thetaSketch", "name": "t",
                        "fieldName": "metLong", "size": 1000},
    "theta_double_777": {"type": "thetaSketch", "name": "t",
                         "fieldName": "metDouble", "size": 777},
    "theta_time": {"type": "thetaSketch", "name": "t", "fieldName": "__time",
                   "size": 512},
    "quantiles_float": {"type": "quantilesDoublesSketch", "name": "q",
                        "fieldName": "metFloat"},
    "quantiles_edges": {"type": "quantilesDoublesSketch", "name": "q",
                        "fieldName": "metDouble"},
    "quantiles_long": {"type": "quantilesDoublesSketch", "name": "q",
                       "fieldName": "metLong"},
    "hist_float": {"type": "approxHistogram", "name": "h",
                   "fieldName": "metFloat", "numBuckets": 64,
                   "lowerLimit": 0.0, "upperLimit": 200.0},
    "hist_edges": {"type": "approxHistogram", "name": "h",
                   "fieldName": "metDouble", "numBuckets": 10,
                   "lowerLimit": -2.0, "upperLimit": 150.0},
    "hist_tiny_upper": {"type": "approxHistogram", "name": "h",
                        "fieldName": "metLong", "numBuckets": 16,
                        "lowerLimit": 0.0, "upperLimit": 1e-9},
    "hist_above_lower": {"type": "approxHistogram", "name": "h",
                         "fieldName": "metLong", "numBuckets": 8,
                         "lowerLimit": 1e4, "upperLimit": 2e4},
    "bloom": {"type": "bloom", "name": "b", "fieldName": "dimB",
              "maxNumEntries": 100},
    "distinct": {"type": "distinctCount", "name": "d", "fieldName": "dimB"},
    "time_min": {"type": "timeMin", "name": "tmin"},
    "time_max": {"type": "timeMax", "name": "tmax"},
}


def _equal(a, b, where):
    assert type(a) is type(b) and a.dtype == b.dtype \
        and a.shape == b.shape, (where, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_reference(seg, case):
    ref, port = seg
    j = CASES[case]
    rk = ref_kernels.make_kernel(ref_agg(j), ref)
    pk = port_kernels.make_kernel(port_agg(j), port)
    assert type(pk).__name__ == type(rk).__name__
    assert pk.signature() == rk.signature()
    assert len(pk.aux_arrays()) == len(rk.aux_arrays())
    for a, b in zip(pk.aux_arrays(), rk.aux_arrays()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    cols, mask, keys = _inputs(ref, sorted(CASES).index(case))
    want = _ref_state(rk, ref, cols, mask, keys)
    got = _port_state(pk, port, cols, mask, keys)
    if not isinstance(want, dict):
        _equal(got, want, case)
        return
    assert set(got) == set(want)
    for k in want:
        if case.startswith("variance") and k != "n":
            continue
        _equal(got[k], want[k], (case, k))
    if case.startswith("variance"):
        f = "metFloat" if "float" in case else \
            "metLong" if "long" in case else "__time_offset"
        v = np.where(mask, cols[f].astype(np.float64), 0.0)
        absv = np.bincount(keys, np.abs(v), G)
        sq = np.bincount(keys, v * v, G)
        assert np.all(np.abs(got["sum"] - want["sum"]) <= 1e-12 * absv)
        assert np.all(np.abs(got["sumsq"] - want["sumsq"]) <= 1e-12 * sq)


def test_histogram_cast_saturates_as_xla():
    """The bucket of an out-of-range quotient: XLA's saturating cast, then
    the clip, on the CPU as on the card (NaN to bucket 0)."""
    x = torch.tensor([np.nan, np.inf, -np.inf, 1e14, -1e14, 3e9, -3e9,
                      -0.5, -1.0, 63.99, 64.0, 0.0], dtype=torch.float64)
    got = histogram.bucket_of(x, 0.0, 1.0, 64).tolist()
    want = np.clip(np.asarray(jnp.asarray(x.numpy()).astype(jnp.int32)),
                   0, 63).tolist()
    assert got == want == [0, 63, 0, 63, 0, 63, 0, 0, 0, 63, 63, 0]


def test_quantile_buckets_round_half_to_even():
    """round(log|x| / log gamma) halves go to the even exponent, as
    jnp.round's do; the bucket table matches the reference's."""
    from druid_tpu.ext import sketches as ref_sketches
    idx = np.arange(-40, 40) + 0.5
    x = np.exp(idx * sketches.LOG_GAMMA)
    x = np.concatenate([x, -x, [0.0, -0.0, np.nan, 2.5e-308, 1e308]])
    got = sketches.quantile_bucket(torch.from_numpy(x)).numpy()
    rx = jnp.asarray(x)
    ridx = jnp.clip(jnp.round(jnp.log(jnp.maximum(jnp.abs(rx), 1e-300))
                              / ref_sketches.LOG_GAMMA),
                    -ref_sketches.E, ref_sketches.E).astype(jnp.int32)
    want = np.where(x > 0, ref_sketches.P + 1 + (np.asarray(ridx)
                                                 + ref_sketches.E),
                    np.where(x < 0, ref_sketches.P - 1 - (np.asarray(ridx)
                                                          + ref_sketches.E),
                             ref_sketches.ZERO_BUCKET))
    assert np.array_equal(got, want)
    assert np.array_equal(sketches._BUCKET_VALUES,
                          ref_sketches._BUCKET_VALUES)


def test_theta_unsigned_modulus():
    """The bucket of a hash with the top bit set is its uint64 remainder."""
    rng = np.random.default_rng(3)
    h = np.concatenate([np.asarray([0, 1, 2**63, 2**64 - 1, 2**63 - 1],
                                   dtype=np.uint64),
                        rng.integers(0, 2**64 - 1, 10_000, dtype=np.uint64,
                                     endpoint=True)])
    t = torch.from_numpy(h.view(np.int64))
    for size in (1000, 4096, 777, 1, 2**31 - 1):
        got = sketches._unsigned_mod(t, size).numpy()
        assert np.array_equal(got, (h % np.uint64(size)).astype(np.int64))


def test_quantile_subnormal_divergence():
    """XLA on the CPU reads a subnormal double as zero (denormals-are-zero),
    so the reference counts 1e-320 in the zero bucket; the port keeps
    IEEE semantics, as numpy and the card do, and counts it in the least
    positive bucket (ROADMAP §C)."""
    from druid_tpu.ext import sketches as ref_sketches
    x = np.asarray([1e-320, -1e-320])
    rx = jnp.asarray(x)
    assert not bool((rx > 0)[0]) and not bool((rx < 0)[1])
    got = sketches.quantile_bucket(torch.from_numpy(x)).tolist()
    assert got == [sketches.P + 1, sketches.P - 1]
    assert ref_sketches.ZERO_BUCKET == sketches.P
