// Grouped reduction over a sorted, key-compacted projection, for Hopper.
//
// Two TPU kernels, for int32/float32 value columns, dense or bit-packed:
//   B1 (sr_partial): druid_tpu/engine/pallas_agg.py::pallas_reduce
//      (pl.pallas_call at pallas_agg.py:400); masked rows arrive as the key
//      sentinel.
//   B2 (sr_partial_words): druid_tpu/engine/megakernel.py::mega_reduce
//      (pl.pallas_call at megakernel.py:742); the row mask arrives as bits.
// Python side: druid_tpu_torch/engine/sorted_reduce.py (B1's wrapper, the
// shared launch) and engine/megakernel.py (B2's wrapper); plain PyTorch
// versions and launch counters beside them. Built with nvcc for sm_90a into a
// shared library with a plain C interface (druid_tpu_torch/_build.py).
//
// What it computes. Rows come in blocks of `blk` rows (2048 or 1024). Each
// block takes the minimum key over its rows (masked rows carry the sentinel
// 2^31-1), aligns it down to a multiple of 128 and clamps it to
// [0, round_up(G,128)], and reduces every row whose key falls in the W-wide
// window from there. Rows outside the window are dropped, as the reference
// drops them. Per output slot: count (int32), sum of an int32 column (int64,
// exact), sum of a float32 column, min/max of an int32 or float32 column.
//
// Design. The TPU kernel keeps every [G] grid resident in VMEM across a
// sequential grid; Hopper has 227 KB of shared memory per block and runs
// blocks in no order, so the reduction takes two passes:
//   1. sr_partial_kernel: one thread block of SR_THREADS threads per row
//      block. The block's local slots and the value words of its in-window
//      rows (one copy per distinct value column, however many output slots
//      read it) are staged in shared memory with coalesced loads. Then, once
//      per output slot, threads own rows, not window slots: thread t folds
//      the contiguous chunk of blk / SR_THREADS rows at t * chunk in row
//      order. A run is a maximal sequence of in-window rows with one slot;
//      masked and out-of-window rows are transparent and end no run. A run
//      inside one chunk is finished there; a run that crosses chunks is
//      joined by a segmented reduction of per-chunk summaries (first run,
//      last run, whether there are more) over the warp with __shfl_down_sync
//      and then over the warps, a tree whose shape depends on blk and
//      SR_THREADS only. Each finished run's total lands in shared memory at
//      its first row. A slot's partial is its runs folded in row order,
//      from the first and last run start of each slot (integer atomics):
//      with sorted keys a slot has one run, whose total is the partial; with
//      unsorted keys a thread walks the rows between the two starts. Each
//      thread writes W / SR_THREADS entries of the partial row [W] of each
//      output slot, the identity for an empty slot. No float atomics: every
//      float output has one order of operations, so two runs give the same
//      bits.
//   2. sr_combine_kernel: one thread per group. It folds the partial rows of
//      the blocks whose window covers the group, in an order fixed by the
//      caller (window base, then block index), from a CSR list.
// A value column is dense (fwidth 0: one int32/float32 word a row) or packed
// int32 words (data/packed.py): width w in {4, 8, 16}, vpw = 32 / w values a
// word, stored as value - fbase, in the reference's tile-planar layout (word
// q * 128 + l holds rows (q * vpw + s) * 128 + l at bit slot s). Step 2
// unpacks a packed row into the same shared-memory word a dense row would
// fill: an unsigned shift and mask, then + fbase. Nothing after that load
// knows the difference, so packed and dense inputs give the same bits, in B1
// and B2 alike. A block of blk rows is a whole number of 128 * vpw row tiles
// (the wrapper's plan rule), so its words are contiguous and 32 consecutive
// rows of a warp read 32 consecutive words.
//
// Float min/max propagate NaN the way jnp.min/jnp.max do (fminf/fmaxf would
// drop it). Fully masked blocks are marked with base -1 and contribute
// nothing; a ragged last block reads rows past n as the sentinel.
//
// B2 differs from B1 at one place, the read of a row's key: the key if the
// row's mask bit is set, else the sentinel. Everything after that read is
// B1's, so for the same mask the two give the same bits, floats included.
// The mask is plain LSB-first int32 words (row r is bit r % 32 of word
// r / 32), the layout of the port's staged filter words, not the TPU's
// width-1 tile-planar layout (which exists for its sub-lane unpack): the 32
// consecutive rows a warp reads share one word, so a warp makes one
// broadcast load per 32 rows. The words cost n / 8 bytes against B1's n
// bytes of bool mask plus the sentinel-folded key copy the wrapper makes.
//
// Bound. Bytes, over 3.35 TB/s on an H100 SXM: the whole row mask (B1's
// bools, B2's words), the key (4 B a row) and each value column (4 B a row
// dense, w / 8 B packed) only in the 32-row groups that hold a live row, and
// the [G] grids, each once. The
// operations per row (a compare and an add or min/max per output slot) are
// far below the card's integer and float rates. Above the bound, this
// design writes the [nblk, W] partial rows of every output slot (16 B per
// window slot for count + long sum + float max, about W / blk x 16 / 12 of
// the input again) and the combine reads them back.

#include <cuda_runtime.h>
#include <stdint.h>

#define SR_MAX_SLOTS 17
#define SR_MAX_FIELDS 8
#define SR_MAX_BLK 2048
#define SR_MAX_W 1024
#define SR_SENTINEL 0x7fffffff
#define SR_THREADS 256             // threads per sr_partial_kernel block
#define SR_WARPS (SR_THREADS / 32)
#define SR_EMPTY 1                 // SrRuns flags: no in-window row
#define SR_MULTI 2                 //   more than one run

enum SrKind {
  SR_COUNT = 0,
  SR_SUM_I32 = 1,
  SR_SUM_F32 = 2,
  SR_MIN_I32 = 3,
  SR_MAX_I32 = 4,
  SR_MIN_F32 = 5,
  SR_MAX_F32 = 6,
};

// Mirrored field for field by the ctypes Structure in sorted_reduce.py.
struct SrParams {
  const int* keys;         // [n] int32, masked rows = SR_SENTINEL
  int* abase;              // [nblk] window base per block, -1 = no row
  const int* row_off;      // [ceil(G/128) + 1] CSR offsets per 128 groups
  const int* row_blocks;   // CSR: blocks covering each 128-group row
  long long n;
  int blk;                 // rows per block
  int W;                   // window width, a multiple of 128
  int gbase_max;           // round_up(G, 128): largest window base
  int nblk;
  int G;                   // groups in the output grids
  int nslots;
  int nfields;             // distinct value columns
  int kind[SR_MAX_SLOTS];
  int field[SR_MAX_SLOTS];         // value column of each slot (slot 0: -)
  const void* fsrc[SR_MAX_FIELDS]; // [n] int32/float32 value columns, or
                                   // [n / vpw] packed words
  void* part[SR_MAX_SLOTS];        // [nblk, W] partial rows per slot
  void* out[SR_MAX_SLOTS];         // [G] result per slot
  const int* mask_words;           // B2: [ceil(n/32)] row mask bits
  int fwidth[SR_MAX_FIELDS];       // bits a packed value (4/8/16), 0: dense
  int fbase[SR_MAX_FIELDS];        // packed: value = stored + fbase
};

// The int32 word of row `row` of value column f: the dense word, or the
// packed value unpacked (unsigned shift and mask, then + fbase).
__device__ __forceinline__ int sr_value_word(const SrParams& p, int f,
                                             long long row) {
  const int* src = static_cast<const int*>(p.fsrc[f]);
  const int w = p.fwidth[f];
  if (w == 0) return __ldg(src + row);
  const int lvpw = 6 - __ffs(w);                   // log2(32 / w)
  const long long tile = row >> 7;                  // 128-row tile
  const unsigned word =
      (unsigned)__ldg(src + ((tile >> lvpw) << 7) + (row & 127));
  const unsigned slot = (unsigned)(tile & ((1 << lvpw) - 1));
  return (int)((word >> (slot * w)) & ((1u << w) - 1u)) + p.fbase[f];
}

__device__ __forceinline__ float sr_fmax(float a, float v) {
  return (v > a || v != v) ? v : a;   // NaN in either stays NaN
}

__device__ __forceinline__ float sr_fmin(float a, float v) {
  return (v < a || v != v) ? v : a;
}

__device__ __forceinline__ long long sr_lmin(long long a, long long v) {
  return v < a ? v : a;
}

__device__ __forceinline__ long long sr_lmax(long long a, long long v) {
  return v > a ? v : a;
}

__device__ __forceinline__ void sr_init(const SrParams& p,
                                        long long* ai, float* af) {
#pragma unroll
  for (int q = 0; q < SR_MAX_SLOTS; ++q) {
    ai[q] = 0;
    af[q] = 0.0f;
    if (q < p.nslots) {
      switch (p.kind[q]) {
        case SR_MIN_I32: ai[q] = 0x7fffffffLL; break;
        case SR_MAX_I32: ai[q] = -0x80000000LL; break;
        case SR_MIN_F32: af[q] = __int_as_float(0x7f800000); break;
        case SR_MAX_F32: af[q] = __int_as_float(0xff800000); break;
        default: break;
      }
    }
  }
}

// One output kind: its accumulator type T (the type of its partial row),
// identity, value of a staged word, and fold.
template <int K> struct SrOp;
template <> struct SrOp<SR_COUNT> {
  typedef int T;
  static __device__ T id() { return 0; }
  static __device__ T load(int) { return 1; }
  static __device__ T op(T a, T v) { return a + v; }
};
template <> struct SrOp<SR_SUM_I32> {   // exact: int32 words summed in int64
  typedef long long T;
  static __device__ T id() { return 0; }
  static __device__ T load(int w) { return (long long)w; }
  static __device__ T op(T a, T v) { return a + v; }
};
template <> struct SrOp<SR_SUM_F32> {
  typedef float T;
  static __device__ T id() { return 0.0f; }
  static __device__ T load(int w) { return __int_as_float(w); }
  static __device__ T op(T a, T v) { return a + v; }
};
template <> struct SrOp<SR_MIN_I32> {
  typedef int T;
  static __device__ T id() { return 0x7fffffff; }
  static __device__ T load(int w) { return w; }
  static __device__ T op(T a, T v) { return min(a, v); }
};
template <> struct SrOp<SR_MAX_I32> {
  typedef int T;
  static __device__ T id() { return (int)0x80000000; }
  static __device__ T load(int w) { return w; }
  static __device__ T op(T a, T v) { return max(a, v); }
};
template <> struct SrOp<SR_MIN_F32> {
  typedef float T;
  static __device__ T id() { return __int_as_float(0x7f800000); }
  static __device__ T load(int w) { return __int_as_float(w); }
  static __device__ T op(T a, T v) { return sr_fmin(a, v); }
};
template <> struct SrOp<SR_MAX_F32> {
  typedef float T;
  static __device__ T id() { return __int_as_float(0xff800000); }
  static __device__ T load(int w) { return __int_as_float(w); }
  static __device__ T op(T a, T v) { return sr_fmax(a, v); }
};

// The runs of a contiguous range of a block's rows. With SR_MULTI clear the
// range holds one run: fs == ls, fstart == lstart, hv == lv.
template <typename T>
struct SrRuns {
  int fs, ls;           // window slot of the first and of the last run
  int fstart, lstart;   // first row of the first and of the last run
  int flags;            // SR_EMPTY, SR_MULTI
  T hv, lv;             // total over the range of the first and last run
};

// Static shared memory of one sr_partial_kernel block.
struct __align__(16) SrSmem {
  long long run[SR_MAX_BLK];      // total of each finished run, at its start
  long long wv[SR_WARPS][2];      // warp summaries: hv, lv
  int slot[SR_MAX_BLK];           // window slot of each row, -1: not counted
  int first[SR_MAX_W];            // first and last run start of each slot
  int last[SR_MAX_W];
  int red[32];
  int wi[SR_WARPS][5];            // warp summaries: fs, ls, fstart, lstart,
                                  // flags
  unsigned char head[SR_MAX_BLK]; // 1 where a run starts
};

// The static arrays plus one staged word per row per value column, at the
// largest plan: within Hopper's 227 KB per block, so no plan the wrapper
// accepts can exceed it (and the static part within the 48 KB a kernel may
// declare).
static_assert(sizeof(SrSmem) + 4 * SR_MAX_FIELDS * SR_MAX_BLK <= 232448,
              "sr_partial_kernel shared memory exceeds Hopper's 227 KB");
static_assert(sizeof(SrSmem) <= 48 * 1024,
              "sr_partial_kernel static shared memory exceeds 48 KB");

// A finished run of slot s starting at row `start` with total v. The count
// pass (the first) also records where runs start, for every later pass.
template <int K>
__device__ __forceinline__ void sr_emit(SrSmem& sm, int s,
                                        typename SrOp<K>::T v, int start) {
  *reinterpret_cast<typename SrOp<K>::T*>(sm.run + start) = v;
  if (K == SR_COUNT) {
    sm.head[start] = 1;
    atomicMin(sm.first + s, start);   // integer atomics: order-free
    atomicMax(sm.last + s, start);
  }
}

// The runs of range a followed by those of range b. A run that the join
// closes on both sides is emitted; the order of every fold is a's then b's.
template <int K>
__device__ __forceinline__ SrRuns<typename SrOp<K>::T> sr_join(
    SrRuns<typename SrOp<K>::T> a, const SrRuns<typename SrOp<K>::T>& b,
    SrSmem& sm) {
  typedef SrOp<K> O;
  if (b.flags & SR_EMPTY) return a;
  if (a.flags & SR_EMPTY) return b;
  const bool join = a.ls == b.fs;
  const bool am = a.flags & SR_MULTI, bm = b.flags & SR_MULTI;
  if (join && !am && !bm) {           // still one run
    a.hv = a.lv = O::op(a.lv, b.hv);
    return a;
  }
  SrRuns<typename O::T> r;
  r.fs = a.fs;
  r.fstart = a.fstart;
  r.ls = b.ls;
  r.lstart = b.lstart;
  r.flags = SR_MULTI;
  if (join) {                         // a's last run goes on into b
    const typename O::T m = O::op(a.lv, b.hv);
    if (am && bm) sr_emit<K>(sm, a.ls, m, a.lstart);
    r.hv = am ? a.hv : m;
    r.lv = bm ? b.lv : m;
    if (!bm) r.lstart = a.lstart;
  } else {
    if (am) sr_emit<K>(sm, a.ls, a.lv, a.lstart);
    if (bm) sr_emit<K>(sm, b.fs, b.hv, b.fstart);
    r.hv = a.hv;
    r.lv = b.lv;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ SrRuns<T> sr_shfl_down(const SrRuns<T>& x, int o) {
  SrRuns<T> y;
  y.fs = __shfl_down_sync(0xffffffffu, x.fs, o);
  y.ls = __shfl_down_sync(0xffffffffu, x.ls, o);
  y.fstart = __shfl_down_sync(0xffffffffu, x.fstart, o);
  y.lstart = __shfl_down_sync(0xffffffffu, x.lstart, o);
  y.flags = __shfl_down_sync(0xffffffffu, x.flags, o);
  y.hv = __shfl_down_sync(0xffffffffu, x.hv, o);
  y.lv = __shfl_down_sync(0xffffffffu, x.lv, o);
  return y;
}

// Lane 0 of the warp ends with the runs of the warp's 32 ranges; a fixed
// tree (lane i takes lane i + o at distance o = 1, 2, 4, ...), `levels`
// levels deep.
template <int K>
__device__ __forceinline__ SrRuns<typename SrOp<K>::T> sr_warp_join(
    SrRuns<typename SrOp<K>::T> r, int levels, SrSmem& sm) {
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < levels; ++l) {
    const int o = 1 << l;
    const SrRuns<typename SrOp<K>::T> nb = sr_shfl_down(r, o);
    if ((lane & (2 * o - 1)) == 0) r = sr_join<K>(r, nb, sm);
  }
  return r;
}

// Step 3 for output slot q of kind K: every thread folds its chunk of rows,
// runs crossing chunks are joined across the warp and then the warps, and
// each window slot's runs are folded in row order into partial row q.
template <int K>
__device__ void sr_slot_pass(const SrParams& p, SrSmem& sm, const int* col,
                             int q) {
  typedef SrOp<K> O;
  typedef typename O::T T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = p.blk / SR_THREADS;   // a multiple of 4 (launch check)
  const int j0 = tid * chunk;
  SrRuns<T> r;
  r.fs = r.ls = -1;
  r.fstart = r.lstart = 0;
  r.flags = SR_EMPTY;
  r.hv = r.lv = O::id();
  int cur = -1, cstart = 0;
  T acc = O::id();
  for (int i0 = 0; i0 < chunk; i0 += 4) {
    const int4 s4 = *reinterpret_cast<const int4*>(sm.slot + j0 + i0);
    int4 w4 = make_int4(0, 0, 0, 0);
    if constexpr (K != SR_COUNT) {
      w4 = *reinterpret_cast<const int4*>(col + j0 + i0);
    }
    const int ss[4] = {s4.x, s4.y, s4.z, s4.w};
    const int ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ss[i];
      if (s < 0) continue;              // masked or outside: transparent
      const T v = O::load(ww[i]);
      if (s == cur) {
        acc = O::op(acc, v);
        continue;
      }
      if (cur >= 0) {                   // the run of `cur` ends here
        if (r.flags & SR_EMPTY) {       // the chunk's first run
          r.flags = 0;
          r.fs = cur;
          r.fstart = cstart;
          r.hv = acc;
        } else {                        // a run inside the chunk: finished
          r.flags = SR_MULTI;
          sr_emit<K>(sm, cur, acc, cstart);
        }
      }
      cur = s;
      cstart = j0 + i0 + i;
      acc = v;
    }
  }
  if (cur >= 0) {                       // the chunk's last run
    if (r.flags & SR_EMPTY) {
      r.flags = 0;
      r.fs = cur;
      r.fstart = cstart;
      r.hv = acc;
    } else {
      r.flags = SR_MULTI;
    }
    r.ls = cur;
    r.lstart = cstart;
    r.lv = acc;
  }
  r = sr_warp_join<K>(r, 5, sm);
  if (lane == 0) {
    sm.wi[warp][0] = r.fs;
    sm.wi[warp][1] = r.ls;
    sm.wi[warp][2] = r.fstart;
    sm.wi[warp][3] = r.lstart;
    sm.wi[warp][4] = r.flags;
    *reinterpret_cast<T*>(&sm.wv[warp][0]) = r.hv;
    *reinterpret_cast<T*>(&sm.wv[warp][1]) = r.lv;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < SR_WARPS) {
      r.fs = sm.wi[lane][0];
      r.ls = sm.wi[lane][1];
      r.fstart = sm.wi[lane][2];
      r.lstart = sm.wi[lane][3];
      r.flags = sm.wi[lane][4];
      r.hv = *reinterpret_cast<const T*>(&sm.wv[lane][0]);
      r.lv = *reinterpret_cast<const T*>(&sm.wv[lane][1]);
    } else {
      r.flags = SR_EMPTY;
    }
    int levels = 0;
    while ((1 << levels) < SR_WARPS) ++levels;
    r = sr_warp_join<K>(r, levels, sm);
    if (lane == 0 && !(r.flags & SR_EMPTY)) {   // the block's end runs
      sr_emit<K>(sm, r.fs, r.hv, r.fstart);
      if (r.flags & SR_MULTI) sr_emit<K>(sm, r.ls, r.lv, r.lstart);
    }
  }
  __syncthreads();
  // each slot: its runs in row order; one run (sorted keys) is read once,
  // several (unsorted keys) are found between the first and last start
  T* part = static_cast<T*>(p.part[q]) + (long long)blockIdx.x * p.W;
  for (int s = tid; s < p.W; s += SR_THREADS) {
    const int lo = sm.first[s], hi = sm.last[s];
    T a = O::id();
    if (lo == hi) {
      a = O::op(a, *reinterpret_cast<const T*>(sm.run + lo));
    } else {
      for (int j = lo; j <= hi; ++j) {
        if (sm.head[j] && sm.slot[j] == s) {
          a = O::op(a, *reinterpret_cast<const T*>(sm.run + j));
        }
      }
    }
    part[s] = a;                       // empty slot: the identity
  }
  __syncthreads();                     // run[] and wi/wv are reused
}

// kWords: the row mask is p.mask_words (B2), else folded into p.keys (B1).
template <bool kWords>
__global__ void __launch_bounds__(SR_THREADS) sr_partial_kernel(
    const SrParams p) {
  __shared__ SrSmem sm;
  extern __shared__ __align__(16) int vals_sh[];   // nfields * blk words
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * p.blk;
  for (int s = tid; s < p.W; s += SR_THREADS) {
    sm.first[s] = p.blk;
    sm.last[s] = -1;
  }
  for (int j = tid; j < p.blk; j += SR_THREADS) sm.head[j] = 0;

  // 1. stage the block's keys; block minimum over every row
  int m = SR_SENTINEL;
  for (int j = tid; j < p.blk; j += SR_THREADS) {
    const long long row = row0 + j;
    int k = SR_SENTINEL;
    if (row < p.n) {
      k = p.keys[row];
      if (kWords && !((__ldg(p.mask_words + (row >> 5)) >> (row & 31)) & 1)) {
        k = SR_SENTINEL;
      }
    }
    sm.slot[j] = k;
    m = min(m, k);
  }
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) sm.red[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    int v = tid < SR_WARPS ? sm.red[tid] : SR_SENTINEL;
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (tid == 0) sm.red[0] = v;
  }
  __syncthreads();
  const int base = sm.red[0];
  if (base == SR_SENTINEL) {            // fully masked block
    if (tid == 0) p.abase[b] = -1;
    return;
  }
  int ab = base >= 0 ? (base / 128) * 128 : -((-base + 127) / 128) * 128;
  ab = max(min(ab, p.gbase_max), 0);
  if (tid == 0) p.abase[b] = ab;
  // 2. keys -> window slots (-1 outside [0, W), sentinel rows included), and
  //    the value words of the rows in the window staged in shared memory
  //    with coalesced loads (vals_sh[f * blk + j] for value column f)
  for (int j = tid; j < p.blk; j += SR_THREADS) {
    const long long local = (long long)sm.slot[j] - ab;
    const bool in = local >= 0 && local < p.W;
    sm.slot[j] = in ? (int)local : -1;
    if (in) {
      for (int f = 0; f < p.nfields; ++f) {
        vals_sh[f * p.blk + j] = sr_value_word(p, f, row0 + j);
      }
    }
  }
  __syncthreads();

  // 3. one pass per output slot, the count first (it records the runs)
  for (int q = 0; q < p.nslots; ++q) {
    const int* col = q ? vals_sh + p.field[q] * p.blk : nullptr;
    switch (p.kind[q]) {
      case SR_COUNT: sr_slot_pass<SR_COUNT>(p, sm, col, q); break;
      case SR_SUM_I32: sr_slot_pass<SR_SUM_I32>(p, sm, col, q); break;
      case SR_SUM_F32: sr_slot_pass<SR_SUM_F32>(p, sm, col, q); break;
      case SR_MIN_I32: sr_slot_pass<SR_MIN_I32>(p, sm, col, q); break;
      case SR_MAX_I32: sr_slot_pass<SR_MAX_I32>(p, sm, col, q); break;
      case SR_MIN_F32: sr_slot_pass<SR_MIN_F32>(p, sm, col, q); break;
      default: sr_slot_pass<SR_MAX_F32>(p, sm, col, q); break;
    }
  }
}

__global__ void sr_combine_kernel(const SrParams p) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.G) return;
  const int r = g >> 7;
  int cnt = 0;
  long long ai[SR_MAX_SLOTS];
  float af[SR_MAX_SLOTS];
  sr_init(p, ai, af);
  for (int e = p.row_off[r]; e < p.row_off[r + 1]; ++e) {
    const int b = p.row_blocks[e];
    const long long at = (long long)b * p.W + (g - p.abase[b]);
    cnt += static_cast<const int*>(p.part[0])[at];
#pragma unroll
    for (int q = 1; q < SR_MAX_SLOTS; ++q) {
      if (q >= p.nslots) break;
      switch (p.kind[q]) {
        case SR_SUM_I32: ai[q] += static_cast<const long long*>(p.part[q])[at]; break;
        case SR_MIN_I32: ai[q] = sr_lmin(ai[q], (long long)static_cast<const int*>(p.part[q])[at]); break;
        case SR_MAX_I32: ai[q] = sr_lmax(ai[q], (long long)static_cast<const int*>(p.part[q])[at]); break;
        case SR_SUM_F32: af[q] += static_cast<const float*>(p.part[q])[at]; break;
        case SR_MIN_F32: af[q] = sr_fmin(af[q], static_cast<const float*>(p.part[q])[at]); break;
        case SR_MAX_F32: af[q] = sr_fmax(af[q], static_cast<const float*>(p.part[q])[at]); break;
        default: break;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < SR_MAX_SLOTS; ++q) {
    if (q >= p.nslots) break;
    switch (p.kind[q]) {
      case SR_COUNT: static_cast<int*>(p.out[q])[g] = cnt; break;
      case SR_SUM_I32: static_cast<long long*>(p.out[q])[g] = ai[q]; break;
      case SR_MIN_I32:
      case SR_MAX_I32: static_cast<int*>(p.out[q])[g] = (int)ai[q]; break;
      default: static_cast<float*>(p.out[q])[g] = af[q]; break;
    }
  }
}

template <bool kWords>
static int sr_partial_launch(const SrParams* p, void* stream) {
  if (p->blk <= 0 || p->blk > SR_MAX_BLK || p->blk % (4 * SR_THREADS) != 0
      || p->W <= 0 || p->W % 128 != 0 || p->W > SR_MAX_W
      || p->nslots < 1 || p->nslots > SR_MAX_SLOTS
      || p->nfields < 0 || p->nfields > SR_MAX_FIELDS
      || p->kind[0] != SR_COUNT) {
    return (int)cudaErrorInvalidValue;
  }
  for (int q = 1; q < p->nslots; ++q) {
    if (p->field[q] < 0 || p->field[q] >= p->nfields
        || p->kind[q] < SR_SUM_I32 || p->kind[q] > SR_MAX_F32) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int f = 0; f < p->nfields; ++f) {      // packed: whole word tiles
    const int w = p->fwidth[f];
    if (w != 0 && ((w != 4 && w != 8 && w != 16)
                   || p->blk % (128 * (32 / w)) != 0)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (p->nblk == 0) return 0;
  const int smem = p->nfields * p->blk * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      sr_partial_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  sr_partial_kernel<kWords><<<p->nblk, SR_THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" {

// Pass 1 of B1: partial rows and window bases, masked rows already carry
// the sentinel key. Returns the launch's cudaError_t.
int sr_partial(const SrParams* p, void* stream) {
  return sr_partial_launch<false>(p, stream);
}

// Pass 1 of B2: as sr_partial, with raw keys and the row mask as words.
int sr_partial_words(const SrParams* p, void* stream) {
  if (p->mask_words == nullptr) return (int)cudaErrorInvalidValue;
  return sr_partial_launch<true>(p, stream);
}

// Pass 2 of B1 and B2: fold the partial rows into the [G] grids. Returns
// cudaError_t.
int sr_combine(const SrParams* p, void* stream) {
  if (p->G == 0) return 0;
  const int threads = 128;
  sr_combine_kernel<<<(p->G + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
