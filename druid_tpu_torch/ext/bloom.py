"""Bloom filter: a filter that tests a dimension's values against a
serialized bloom filter, and an aggregator that builds one per group.

The port of the reference package's `ext/bloom.py` (Druid's
extensions-core/druid-bloom-filter). The filter tests each dictionary
value once on the host (`value_predicate`), so it plans as any string
leaf: a LUT over the ids, a device bitmap, a megakernel leaf. The
aggregator gathers each row's k bit positions (md5 double hashing,
computed once per dictionary value on the host) and sets them in a
[groups, m_bits] grid (`kernels._presence`: each live row writes 1 into its
k cells, so no order of writes changes the bits). The host form is uint8
0/1, combined by max (bit OR).
"""
from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from druid_tpu_torch.engine.kernels import (AggKernel, HllKernel,
                                            _presence, register_kernel)
from druid_tpu_torch.query.aggregators import (AggregatorSpec,
                                               register_aggregator)
from druid_tpu_torch.query.filters import DimFilter, register_filter

NUM_HASHES = 7


def _bit_positions(value: str, m_bits: int, k: int = NUM_HASHES) -> np.ndarray:
    """k bit positions by double hashing of the md5 halves
    (Kirsch-Mitzenmacher)."""
    d = hashlib.md5(value.encode()).digest()
    h1 = int.from_bytes(d[:8], "big")
    h2 = int.from_bytes(d[8:], "big") | 1
    return np.asarray([(h1 + i * h2) % m_bits for i in range(k)],
                      dtype=np.int64)


class BloomFilterValue:
    """A serializable bloom filter: its bit array and a membership test."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, dtype=np.uint8)

    @property
    def m_bits(self) -> int:
        return len(self.bits)

    def test(self, value: Optional[str]) -> bool:
        v = "" if value is None else str(value)
        return bool(self.bits[_bit_positions(v, self.m_bits)].all())

    def union(self, other: "BloomFilterValue") -> "BloomFilterValue":
        return BloomFilterValue(np.maximum(self.bits, other.bits))

    def serialize(self) -> str:
        return base64.b64encode(np.packbits(self.bits).tobytes()).decode()

    @staticmethod
    def deserialize(b64: str, m_bits: int) -> "BloomFilterValue":
        raw = np.frombuffer(base64.b64decode(b64), dtype=np.uint8)
        return BloomFilterValue(np.unpackbits(raw)[:m_bits])

    def __repr__(self):
        return f"BloomFilterValue(m={self.m_bits}, set={int(self.bits.sum())})"


def optimal_m_bits(max_entries: int, fpp: float = 0.01) -> int:
    m = -max_entries * np.log(fpp) / (np.log(2) ** 2)
    return max(64, int(np.ceil(m)))


@dataclass(frozen=True)
class BloomDimFilter(DimFilter):
    """Rows whose dimension value is (probably) in the given filter."""
    dimension: str
    bloom_b64: str
    m_bits: int

    def required_columns(self):
        return {self.dimension}

    def value_predicate(self):
        blm = BloomFilterValue.deserialize(self.bloom_b64, self.m_bits)
        return blm.test

    def to_json(self):
        return {"type": "bloom", "dimension": self.dimension,
                "bloomKFilter": self.bloom_b64, "mBits": self.m_bits}


@dataclass(frozen=True)
class BloomFilterAggregator(AggregatorSpec):
    name: str
    field: str
    max_num_entries: int = 1500

    @property
    def m_bits(self) -> int:
        return optimal_m_bits(self.max_num_entries)

    def combining(self):
        return BloomFilterAggregator(self.name, self.name,
                                     self.max_num_entries)

    def to_json(self):
        return {"type": "bloom", "name": self.name, "fieldName": self.field,
                "maxNumEntries": self.max_num_entries}


class BloomKernel(AggKernel):
    reduce_kind = "max"   # bit OR

    def __init__(self, spec: BloomFilterAggregator, segment):
        super().__init__(spec)
        self.field = spec.field
        self.m = spec.m_bits
        col = segment.dims.get(self.field)
        if col is None and self.field in segment.metrics:
            raise self._not_a_dimension()
        # a segment without the column (the wire's merge-side null segment,
        # which only combines and finishes states) has no position table;
        # update refuses to run without one
        self._pos_tbl = None if col is None else segment.aux_cached(
            ("bloom_pos", self.field, self.m),
            lambda: np.stack([_bit_positions(v, self.m) for v in
                              col.dictionary.values]).astype(np.int32))

    def _not_a_dimension(self):
        return ValueError(f"bloom aggregator needs a string dimension, "
                          f"got {self.field!r}")

    def signature(self):
        return f"bloom({self.field},{self.m})"

    def aux_arrays(self):
        return [] if self._pos_tbl is None else [self._pos_tbl]

    def update(self, cols, mask, keys, num):
        if self._pos_tbl is None:
            raise self._not_a_dimension()
        pos, = HllKernel._gather((self._pos_tbl,), cols[self.field])
        return _presence(keys[:, None] * self.m + pos, mask[:, None],
                         num * self.m, torch.uint8).view(num, self.m)

    def host_from_device(self, state):
        return state.cpu().numpy().astype(np.uint8, copy=False)

    def combine(self, a, b):
        return np.maximum(a, b)

    def empty_state(self, n):
        return np.zeros((n, self.m), dtype=np.uint8)

    def finalize_array(self, state):
        arr = np.asarray(state, dtype=np.uint8)
        out = np.empty(arr.shape[0], dtype=object)
        for i in range(arr.shape[0]):
            out[i] = BloomFilterValue(arr[i])
        return out


register_aggregator(
    "bloom",
    lambda j: BloomFilterAggregator(j["name"], j["fieldName"],
                                    j.get("maxNumEntries", 1500)))
register_kernel(BloomFilterAggregator, BloomKernel)
register_filter(
    "bloom",
    lambda j: BloomDimFilter(j["dimension"], j["bloomKFilter"], j["mBits"]))
