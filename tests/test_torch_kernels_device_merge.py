"""The kernels' device merge hooks against the reference's.

For every core and extension kernel: the same rows split over three
segments of three days (three time origins) and a padding segment (every
row masked, origin 0). Each package's `update` gives each segment's state
on the same staged columns, row mask and group keys; then each package's
own hooks run the sharded merge on them — `device_post` per segment, the
merge by the kernel's `reduce_kind` (the port through
parallel/distributed.py's own merge, over two shards of two segments), and
`host_from_device`. The port's host state must equal the reference's bit
for bit (float sums within 1e-12 of sum|v| per group, their order being
free), and equal the port's own host merge of the segments' `host_post`
states. Every kernel keeps the reference's merge kind, and a kernel that
folds defines `device_combine` (contracts.AGG_FOLD_REQUIRED).
"""
import functools

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ext  # noqa: F401  (registers the reference's extensions)
import jax
import jax.numpy as jnp
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import ValueType
from druid_tpu.engine import kernels as ref_kernels
from druid_tpu.query.aggregators import agg_from_json as ref_agg
from druid_tpu.utils.intervals import Interval

import druid_tpu_torch.ext  # noqa: F401  (registers the port's extensions)
from druid_tpu_torch.engine import contracts
from druid_tpu_torch.engine import kernels as port_kernels
from druid_tpu_torch.parallel import distributed
from druid_tpu_torch.query.aggregators import agg_from_json as port_agg
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

N, G = 3000, 6

CASES = {
    "count": {"type": "count", "name": "c"},
    "long_sum": {"type": "longSum", "name": "s", "fieldName": "metLong"},
    "double_sum": {"type": "doubleSum", "name": "s", "fieldName": "metFloat"},
    "float_sum": {"type": "floatSum", "name": "s", "fieldName": "metFloat"},
    "long_min": {"type": "longMin", "name": "m", "fieldName": "metLong"},
    "long_max": {"type": "longMax", "name": "m", "fieldName": "metLong"},
    "double_min": {"type": "doubleMin", "name": "m", "fieldName": "metFloat"},
    "float_max": {"type": "floatMax", "name": "m", "fieldName": "metFloat"},
    "long_first": {"type": "longFirst", "name": "f", "fieldName": "metLong"},
    "long_last": {"type": "longLast", "name": "f", "fieldName": "metLong"},
    "double_first": {"type": "doubleFirst", "name": "f",
                     "fieldName": "metFloat"},
    "float_last": {"type": "floatLast", "name": "f", "fieldName": "metFloat"},
    "filtered_sum": {"type": "filtered", "name": "fs",
                     "filter": {"type": "selector", "dimension": "dimA",
                                "value": "v00000001"},
                     "aggregator": {"type": "longSum", "name": "fs",
                                    "fieldName": "metLong"}},
    "filtered_last": {"type": "filtered", "name": "fl",
                      "filter": {"type": "in", "dimension": "dimB",
                                 "values": ["v00000000", "v00000003"]},
                      "aggregator": {"type": "doubleLast", "name": "fl",
                                     "fieldName": "metFloat"}},
    "cardinality": {"type": "cardinality", "name": "h",
                    "fields": ["dimB"]},
    "cardinality_by_row": {"type": "cardinality", "name": "h",
                           "fields": ["dimA", "metLong"], "byRow": True},
    "variance": {"type": "variance", "name": "v", "fieldName": "metFloat"},
    "theta": {"type": "thetaSketch", "name": "t", "fieldName": "dimB",
              "size": 512},
    "quantiles": {"type": "quantilesDoublesSketch", "name": "q",
                  "fieldName": "metFloat"},
    "histogram": {"type": "approxHistogram", "name": "h",
                  "fieldName": "metFloat", "numBuckets": 16,
                  "lowerLimit": 0.0, "upperLimit": 200.0},
    "bloom": {"type": "bloom", "name": "b", "fieldName": "dimB",
              "maxNumEntries": 50},
    "distinct": {"type": "distinctCount", "name": "d", "fieldName": "dimB"},
    "time_min": {"type": "timeMin", "name": "tmin"},
    "time_max": {"type": "timeMax", "name": "tmax"},
}
#: (case, state key or None) holding float sums: equal within 1e-12 * sum|v|
FLOAT_SUMS = {("double_sum", None), ("float_sum", None), ("variance", "sum"),
              ("variance", "sumsq")}


@pytest.fixture(scope="module")
def segs():
    schema = (ColumnSpec("dimA", "string", cardinality=4),
              ColumnSpec("dimB", "string", cardinality=40,
                         distribution="zipf"),
              ColumnSpec("metLong", "long", low=-700, high=9000),
              ColumnSpec("metFloat", "float", distribution="normal",
                         mean=100.0, std=25.0))
    ref = DataGenerator(schema, seed=31).segments(
        3, N, Interval.of("2026-02-01", "2026-02-04"), datasource="k")
    return ref, [_carry(s) for s in ref]


def _inputs(ref, seed, pad=False):
    rng = np.random.default_rng(seed)
    cols = {"__time_offset": (ref.time_ms - ref.interval.start)
            .astype(np.int32)}
    for n, c in ref.dims.items():
        cols[n] = c.ids.astype(np.int32)
    for n, m in ref.metrics.items():
        cols[n] = m.values.astype(np.int32) if m.type is ValueType.LONG \
            else m.values
    mask = (rng.random(N) < 0.8) & (not pad)
    return cols, mask, rng.integers(0, G, N)


def _ref_state(k, cols, mask, keys):
    aux = iter([jnp.asarray(a) for a in k.aux_arrays()])
    return k.update({n: jnp.asarray(v) for n, v in cols.items()},
                    jnp.asarray(mask), jnp.asarray(keys, dtype=jnp.int32),
                    G, aux)


def _port_state(k, cols, mask, keys):
    return k.update({n: torch.from_numpy(v) for n, v in cols.items()},
                    torch.from_numpy(mask), torch.from_numpy(keys), G)


def _ref_merge(k, states):
    """The reference's _merge_states on one device, for a list of
    device_post-ed states."""
    kind = k.reduce_kind
    if kind == "fold":
        return functools.reduce(k.device_combine, states)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *states)
    if kind == "sum":
        return jax.tree.map(
            lambda x: (x.astype(jnp.int64)
                       if jnp.issubdtype(x.dtype, jnp.integer)
                       else x).sum(axis=0), stacked)
    return jax.tree.map(lambda x: x.max(axis=0) if kind == "max"
                        else x.min(axis=0), stacked)


def _stack(states):
    if isinstance(states[0], tuple):
        return tuple(_stack(list(s)) for s in zip(*states))
    return torch.stack(states)


def _port_merge(k, states):
    """Two shards of two segments each, through distributed's merge."""
    per_shard = []
    for block in (states[:2], states[2:]):
        per_shard.append((torch.zeros(G, dtype=torch.int64),
                          [distributed._merge_local(k, _stack(block))]))
    return distributed._merge_shards([k], per_shard,
                                     torch.device("cpu"))[1][0]


def _equal(got, want, where, tol=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (where, got.dtype, want.dtype, got.shape, want.shape)
    if tol is not None:
        assert np.all(np.abs(got - want) <= tol), where
    else:
        assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), \
            where


def _compare(got, want, tols, where):
    """Equal states; a key of `tols` (None: a single-array state) compares
    within its tolerance array."""
    if isinstance(want, dict):
        # key sets: the reference's order comes from its program's output
        # pytree (sorted keys), which this emulation of its merge skips
        assert set(got) == set(want), where
        for key in want:
            _equal(got[key], want[key], (where, key), tols.get(key))
    else:
        _equal(got, want, where, tols.get(None))


def _tolerances(case, j, field, inputs):
    """Per state key, the float-sum bound: 1e-12 * sum|v| (1e-5 for a
    float32 sum) per group, of the summed values (v^2 for sumsq)."""
    if not any(c == case for c, _ in FLOAT_SUMS):
        return {}
    v, v2 = np.zeros(G), np.zeros(G)
    for cols, mask, keys in inputs:
        x = np.where(mask, cols[field].astype(np.float64), 0.0)
        v += np.bincount(keys, np.abs(x), G)
        v2 += np.bincount(keys, x * x, G)
    rel = 1e-5 if j["type"] == "floatSum" else 1e-12
    return {key: rel * (v2 if key == "sumsq" else v)
            for c, key in FLOAT_SUMS if c == case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_merge_matches_reference(segs, case):
    ref, port = segs
    j = CASES[case]
    inputs = [_inputs(s, 3 * i + sorted(CASES).index(case))
              for i, s in enumerate(ref)]
    inputs.append(_inputs(ref[0], 99, pad=True))
    time0s = [s.interval.start for s in ref] + [0]
    # the padding segment plans as the last segment
    rks = [ref_kernels.make_kernel(ref_agg(j), s, device_bitmap=False)
           for s in ref + [ref[-1]]]
    pks = [port_kernels.make_kernel(port_agg(j), s, device_bitmap=False)
           for s in port + [port[-1]]]
    rk, pk = rks[0], pks[0]
    assert pk.reduce_kind == rk.reduce_kind, case

    r_states = [k.device_post(_ref_state(k, *x), jnp.int64(t0))
                for k, x, t0 in zip(rks, inputs, time0s)]
    want = rk.host_from_device(_ref_merge(rk, r_states))
    p_raw = [_port_state(k, *x) for k, x in zip(pks, inputs)]
    p_states = [k.device_post(st, torch.tensor(t0))
                for k, st, t0 in zip(pks, p_raw, time0s)]
    got = pk.host_from_device(_port_merge(pk, p_states))
    tols = _tolerances(case, j, getattr(pk.spec, "field", None), inputs)
    _compare(got, want, tols, case)

    # the device merge equals the port's host merge of the real segments'
    # host_post states, in host_post's key order (the wire writes dict
    # states in it)
    host = functools.reduce(pk.combine, [
        k.host_post(st, s) for k, st, s in zip(pks, p_raw, port)])
    if isinstance(host, dict):
        assert list(got) == list(pk.host_post(p_raw[0], port[0])), case
    _compare(got, host, tols, (case, "host"))


def test_first_last_across_time_origins():
    """A group whose first and last rows lie in other segments than the
    first: the absolute times decide, ties keep the earlier segment."""
    from druid_tpu_torch.query import aggregators as A
    last = port_kernels.FirstLastKernel(A.agg_from_json(
        {"type": "longLast", "name": "l", "fieldName": "m"}),
        ValueType.LONG, True)
    first = port_kernels.FirstLastKernel(A.agg_from_json(
        {"type": "longFirst", "name": "f", "fieldName": "m"}),
        ValueType.LONG, False)

    def st(t, v, has):
        return (torch.tensor(t, dtype=torch.int32),
                torch.tensor(v, dtype=torch.int64),
                torch.tensor(has))
    day = 86_400_000
    # group 0: segment 1 holds the latest (day 1 + 5) and segment 0 the
    # earliest; group 1: a tie at the same instant (day 0 + day): the first
    # segment's value wins both ways; group 2: nothing anywhere
    a = st([5, day, 0], [10, 11, 0], [True, True, False])
    b = st([5, 0, 0], [20, 21, 0], [True, True, False])
    for k, want_v in ((last, [20, 11, 0]), (first, [10, 11, 0])):
        pa, pb = k.device_post(a, torch.tensor(0)), \
            k.device_post(b, torch.tensor(day))
        got = k.host_from_device(k.device_combine(pa, pb))
        assert got["value"].tolist() == want_v
        assert got["has"].tolist() == [True, True, False]
        ident = int(port_kernels.INT64_MIN if k.is_last
                    else port_kernels.INT64_MAX)
        assert got["time"][2] == ident


def _all_kernels(port):
    return [port_kernels.make_kernel(port_agg(j), port[0],
                                     device_bitmap=False)
            for j in CASES.values()]


def test_every_kernel_keeps_the_reference_merge_kind(segs):
    ref, port = segs
    for j in CASES.values():
        rk = ref_kernels.make_kernel(ref_agg(j), ref[0], device_bitmap=False)
        pk = port_kernels.make_kernel(port_agg(j), port[0],
                                      device_bitmap=False)
        assert pk.reduce_kind == rk.reduce_kind, j
        if rk.reduce_kind == "fold":
            assert type(pk).device_combine \
                is not port_kernels.AggKernel.device_combine, j


def test_fold_contract(segs):
    """contracts.AGG_FOLD_REQUIRED: every kernel that folds defines
    device_combine, and make_kernel refuses one that does not."""
    assert contracts.AGG_FOLD_REQUIRED == ("device_combine",)
    kinds = set()
    for k in _all_kernels(segs[1]):
        kinds.add(k.reduce_kind)
        assert port_kernels.fold_contract_missing(k) == [], k
    assert kinds == {"sum", "min", "max", "fold"}

    class Broken(port_kernels.AggKernel):
        def signature(self):
            return "broken"

    class Spec:
        name = "b"
    port_kernels.register_kernel(Spec, lambda spec, seg: Broken(spec))
    try:
        with pytest.raises(TypeError, match="device_combine"):
            port_kernels.make_kernel(Spec(), segs[1][0])
    finally:
        del port_kernels._EXTENSION_KERNELS[Spec]
