"""The mesh layout: the one place that splits stacked inputs into shards.

The port's counterpart of the reference package's `parallel/speclayout.py`,
where a frozen SpecLayout is the single source of the PartitionSpecs of the
sharded program. PyTorch has no sharding annotations; what the layout
decides here is the same thing said with tensors: every STACKED input
carries the segment axis first — the stacked columns [K, R], the filter
words [K, R / 32], the time origins [K], the interval bounds
[K, n_intervals, 2], the bucket offsets [K] — and splits over the mesh into
n contiguous blocks of K / n segments, shard i's block placed on the mesh's
device i, as shard_map splits its in_specs' leading axis. The stacker
(distributed.py) builds each shard's column block on its device from
`shard_slices`; the per-segment vectors go through `split`. Plan constants
(kernel and filter tables) are host arrays that every run moves to its own
device, so they need no placement. The merged states leave each shard for
the mesh's first device (distributed.py).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def shard_slices(K: int, n_shards: int) -> List[slice]:
    """The contiguous block of segments each shard takes: K / n each (K is
    padded to a multiple of n by the stacker)."""
    if K % n_shards:
        raise ValueError(f"{K} stacked segments do not split into "
                         f"{n_shards} equal shards")
    per = K // n_shards
    return [slice(i * per, (i + 1) * per) for i in range(n_shards)]


def split(mesh, value) -> List[torch.Tensor]:
    """A per-segment input with a leading [K] axis (a host array or a
    tensor) -> one [K / n, ...] block per shard, on its shard's device."""
    t = value if torch.is_tensor(value) \
        else torch.from_numpy(np.ascontiguousarray(value))
    if t.dim() < 1:
        raise ValueError("stacked inputs carry a leading segment axis")
    return [t[sl].contiguous().to(dev) for sl, dev in
            zip(shard_slices(t.shape[0], mesh.size), mesh.devices)]


def layout_sig(mesh) -> Tuple[str, ...]:
    """What a stack specializes on from the mesh: its exact devices in
    shard order (so the shard count too). Joins the stack's pool key, so a
    2-shard and a 1-shard mesh never share an entry."""
    return tuple(str(d) for d in mesh.devices)
