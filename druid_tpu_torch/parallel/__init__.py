"""More than one device: the mesh, the sharded stacked run, its merge.

The port's counterpart of the reference package's `druid_tpu/parallel/`.
Within a process, segments split over a mesh of devices in contiguous
blocks (speclayout.py); each shard runs one stacked run over its block,
its per-segment states merge on its device, and the shards' states merge
on the mesh's first device in shard order (distributed.py): the host
receives one merged partial. Across processes the broker's scatter over
data nodes carries the combine, each node with its own mesh.
"""
from druid_tpu_torch.parallel.context import (SEGMENT_AXIS, Mesh, get_mesh,
                                              initialize_multihost,
                                              make_mesh, set_mesh, use_mesh)

__all__ = ["SEGMENT_AXIS", "Mesh", "get_mesh", "initialize_multihost",
           "make_mesh", "set_mesh", "use_mesh"]
