"""Constants shared by the grouped-reduction planner and the sorted-projection
kernel (csrc/sorted_reduce.cu).

Block and window constants carry the reference package's values
(`druid_tpu/engine/contracts.py`), so both packages plan the same windows for
the same projection. Hopper's shared-memory budget (227 KB per thread block)
is held by a static_assert in the CUDA source at the largest plan these caps
allow.
"""

LANE = 128            # window bases align to a multiple of this

BLK_SMALL_W = 2048    # rows per block when the window is narrow
BLK_WIDE_W = 1024     # rows per block for wide windows
SPAN_BLOCK = 1024     # block size Projection.max_span is measured over
MAX_W = 1024          # widest supported aligned key window

#: cap on the group space of the sorted-projection strategy
MAX_PALLAS_GROUPS = 1 << 17

#: max distinct value columns one kernel call reads
MAX_PALLAS_FIELDS = 8

#: max output slots in the reference's layout (1 counts grid + at most 2
#: slots per op), kept so both packages accept the same plans
MAX_PALLAS_SLOTS = 1 + 2 * MAX_PALLAS_FIELDS

#: bits per packed storage word (data/packed.py): int32 words
PACK_WORD_BITS = 32

#: supported pack widths, each dividing PACK_WORD_BITS so no value crosses a
#: word boundary, and values per word (32 // width) dividing the 128-row
#: tiles of every kernel block (BLK // LANE is 8 or 16)
PACK_WIDTHS = (4, 8, 16)

#: cap on the pow2-padded run count of an RLE column (data/cascade.py)
CASCADE_MAX_RUNS = 1 << 16

# ---- batched multi-segment execution (engine/batching.py) ------------------

#: most segments stacked into one batched run
BATCH_MAX_SEGMENTS = 64

#: below this many shape-compatible segments no batch forms
BATCH_MIN_SEGMENTS = 2

#: rows per segment above which a segment runs alone: its own work already
#: amortizes the per-segment host cost, and a [K, R] stack of it would
#: double its device footprint for nothing
BATCH_MAX_SEGMENT_ROWS = 1 << 21

#: base rung of the padded-row ladder; rungs are powers of two times this.
#: Must equal data.segment.DEFAULT_ROW_ALIGN (asserted by engine/batching.py)
#: so that a rung is a valid `row_align` for Segment.device_block
BATCH_ROW_ALIGN = 1024

#: cells of one step's [K, G, rows] broadcast in the batched blocked and mm
#: reductions. Its widest temporary (a masked 4-byte copy of a value column,
#: the int32 counts' cast) then stays below 2^31 bytes, so that no kernel
#: splits its 32-bit indexing into two launches. The blocked reduction sizes
#: its steps for K = BATCH_MAX_SEGMENTS, so that a chunk of any size takes
#: the same steps and launches; mm sizes them for the K at hand (its
#: one-hot is G bytes a row, so a K-independent step would be far shorter
#: than it need be)
BATCH_STEP_CELLS = 1 << 29

# ---- the device pool (data/devicepool.py) ----------------------------------

#: share of the card's memory the process-wide device pool may hold (staged
#: blocks, padded key columns, filter words, run tables), fixed at the
#: pool's first use with a CUDA card. The rest is the working set of the
#: queries themselves: grids, one-hots, masked copies and the [K, R] stacks
#: of the batched path
DEVICE_POOL_BUDGET_SHARE = 0.4

#: the pool's byte budget where there is no CUDA card (the plain PyTorch
#: versions on the CPU). DeviceSegmentPool.configure(0) means unbounded
DEVICE_POOL_BUDGET_BYTES = 4 * 1024 ** 3

# ---- AggKernel shape (engine/kernels.py) ------------------------------------

#: methods a kernel whose reduce_kind is "fold" must define: the sharded
#: merge (parallel/distributed.py) folds its states pairwise on the device.
#: kernels.make_kernel refuses a kernel that breaks it
AGG_FOLD_REQUIRED = ("device_combine",)
