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
