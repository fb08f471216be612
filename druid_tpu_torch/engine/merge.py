"""Sparse cross-segment merge of partial aggregation states (host numpy).

The port's copy of the reference package's `engine/merge.py`: compact each
partial to its non-empty keys, re-encode them into a merged key space over
the merged dimension values, np.unique over all keys, then scatter-align
each partial and combine with the kernels' elementwise combine. A state is
an array (1-D, or 2-D for HLL registers) or a dict of arrays (first/last).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.engine.grouping import SegmentPartial


# ---------------------------------------------------------------------------
# States: arrays or dicts of arrays
# ---------------------------------------------------------------------------

def state_select(state, idx: np.ndarray):
    if isinstance(state, dict):
        return {k: state_select(v, idx) for k, v in state.items()}
    return state[idx]


def state_scatter(dest, pos: np.ndarray, src):
    """dest[pos] = src, in place (each array keeps its own dtype)."""
    if isinstance(dest, dict):
        for k in dest:
            state_scatter(dest[k], pos, src[k])
        return dest
    dest[pos] = src
    return dest


# ---------------------------------------------------------------------------
# Key decoding
# ---------------------------------------------------------------------------

def partial_nonzero_keys(p: SegmentPartial) -> np.ndarray:
    """Indices into the partial's dense key space that actually have rows."""
    return np.flatnonzero(p.counts > 0)


def decode_keys(p: SegmentPartial, keys: np.ndarray) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Decompose dense/compacted keys into (bucket_ids, [dim_ids...])."""
    spec = p.spec
    if spec.key_mode == "host":
        raw = spec.host_unique[keys].astype(np.int64)
    else:
        raw = keys.astype(np.int64)
    dim_ids: List[np.ndarray] = []
    for d in reversed(spec.dims):
        dim_ids.append((raw % d.cardinality).astype(np.int64))
        raw = raw // d.cardinality
    dim_ids.reverse()
    return raw, dim_ids  # raw is now the bucket id


def merge_partials(partials: Sequence[SegmentPartial],
                   dim_values: Sequence[Sequence[Sequence[str]]]):
    """Merge partial states across segments.

    dim_values[p][d] = list mapping local dim id -> string value for partial p,
    dimension d (from each segment's dictionary).

    Returns (buckets, dim_value_arrays, counts, states, kernels):
      buckets: int64 [G] bucket index per merged group
      dim_value_arrays: list of object arrays [G] of string values per dim
      counts: int64 [G]; states: merged state pytrees; kernels: from partial 0.
    """
    assert partials
    kernels = partials[0].kernels
    n_dims = len(partials[0].spec.dims)

    # 1. compact each partial + decode
    compacted = []
    for p_i, p in enumerate(partials):
        nz = partial_nonzero_keys(p)
        buckets, dim_ids = decode_keys(p, nz)
        compacted.append((p, nz, buckets, dim_ids))

    # 2. build merged per-dim value spaces
    merged_values: List[List[str]] = []
    value_to_merged: List[Dict[str, int]] = []
    for d in range(n_dims):
        vals = set()
        for p_i, (p, nz, buckets, dim_ids) in enumerate(compacted):
            local_vals = dim_values[p_i][d]
            vals.update(local_vals[int(i)] for i in np.unique(dim_ids[d]))
        # numbers (numeric dims) sort before strings so mixed schemas
        # (column numeric in one segment, absent -> "" in another) never
        # compare across types
        ordered = sorted(vals, key=lambda v: (isinstance(v, str), v))
        merged_values.append(ordered)
        value_to_merged.append({v: i for i, v in enumerate(ordered)})

    # 3. merged key per group entry
    cards = [max(len(v), 1) for v in merged_values]
    merged_keys_per_partial = []
    for p_i, (p, nz, buckets, dim_ids) in enumerate(compacted):
        key = buckets.copy()
        for d in range(n_dims):
            local_vals = dim_values[p_i][d]
            # local id -> merged id remap (vectorized via lookup table)
            # values with no live group in any partial map to -1 (never
            # referenced by dim_ids, which only cover live groups)
            lut = np.fromiter((value_to_merged[d].get(v, -1) for v in local_vals),
                              dtype=np.int64, count=len(local_vals))
            key = key * cards[d] + lut[dim_ids[d]]
        merged_keys_per_partial.append(key)

    all_keys = (np.concatenate(merged_keys_per_partial)
                if merged_keys_per_partial else np.zeros(0, dtype=np.int64))
    uniq = np.unique(all_keys)
    G = len(uniq)

    # 4. align + combine
    counts = np.zeros(G, dtype=np.int64)
    states: Optional[Dict[str, object]] = None
    for (p, nz, buckets, dim_ids), mkeys in zip(compacted, merged_keys_per_partial):
        pos = np.searchsorted(uniq, mkeys)
        np.add.at(counts, pos, p.counts[nz])
        aligned = {}
        for k in kernels:
            aligned[k.name] = state_scatter(
                k.empty_state(G), pos, state_select(p.states[k.name], nz))
        if states is None:
            states = aligned
        else:
            states = {k.name: k.combine(states[k.name], aligned[k.name])
                      for k in kernels}

    # 5. decode merged keys back to (bucket, values)
    raw = uniq.copy()
    dim_value_arrays: List[np.ndarray] = [None] * n_dims
    for d in range(n_dims - 1, -1, -1):
        ids = raw % cards[d]
        raw = raw // cards[d]
        vals = np.asarray(merged_values[d], dtype=object) if merged_values[d] \
            else np.asarray([""], dtype=object)
        dim_value_arrays[d] = vals[ids.astype(np.int64)]
    buckets = raw

    if states is None:
        states = {k.name: k.empty_state(G) for k in kernels}
    return buckets, dim_value_arrays, counts, states, kernels
