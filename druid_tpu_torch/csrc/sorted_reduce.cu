// Grouped reduction over a sorted, key-compacted projection, for Hopper.
//
// Two TPU kernels, for dense int32/float32 value columns:
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
//   1. sr_partial_kernel: one thread block per row block, one thread per
//      window slot. The block's local slots and the value words of its
//      in-window rows (one copy per distinct value column, however many
//      output slots read it) are staged in shared memory with coalesced loads,
//      with each slot's first and last row (integer atomics). Each thread
//      then walks its slot's row range in row order, once per output slot,
//      and writes one partial row [W] per output slot. For sorted keys the
//      range is the slot's run, so a block's rows are read about once per
//      output slot; unsorted keys stay correct at up to W x blk compares.
//      No atomics: float sums are summed in row order, so two runs give the
//      same bits.
//   2. sr_combine_kernel: one thread per group. It folds the partial rows of
//      the blocks whose window covers the group, in an order fixed by the
//      caller (window base, then block index), from a CSR list.
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
// Bound. The kernel must read each key (4 B) and each value column (4 B per
// column) once: bytes / 3.35 TB/s on an H100 SXM. This first design
// stages every block through shared memory and writes [nblk, W] partial
// rows per slot (about W / blk of the input again), then re-reads them.

#include <cuda_runtime.h>
#include <stdint.h>

#define SR_MAX_SLOTS 17
#define SR_MAX_FIELDS 8
#define SR_MAX_BLK 2048
#define SR_MAX_W 1024
#define SR_SENTINEL 0x7fffffff

// Shared memory of one sr_partial_kernel block at the largest plan: the
// static slot, first/last-row and reduction arrays plus one staged word per
// row per value column. Within Hopper's 227 KB per block, so no plan the
// wrapper accepts can exceed it.
static_assert(4 * (SR_MAX_BLK + 2 * SR_MAX_W + 32 + SR_MAX_FIELDS * SR_MAX_BLK)
                  <= 232448,
              "sr_partial_kernel shared memory exceeds Hopper's 227 KB");

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
  const void* fsrc[SR_MAX_FIELDS]; // [n] int32/float32 value columns
  void* part[SR_MAX_SLOTS];        // [nblk, W] partial rows per slot
  void* out[SR_MAX_SLOTS];         // [G] result per slot
  const int* mask_words;           // B2: [ceil(n/32)] row mask bits
};

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

// up to MAX_W = 1024 threads (one per window slot): cap registers to fit.
// kWords: the row mask is p.mask_words (B2), else folded into p.keys (B1).
template <bool kWords>
__global__ void __launch_bounds__(1024) sr_partial_kernel(const SrParams p) {
  __shared__ int slot_sh[SR_MAX_BLK];
  __shared__ int first_sh[SR_MAX_W];   // first / last row of each slot
  __shared__ int last_sh[SR_MAX_W];
  __shared__ int red[32];
  extern __shared__ int vals_sh[];   // nfields * blk value words
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * p.blk;
  first_sh[tid] = p.blk;               // blockDim.x == W: one entry each
  last_sh[tid] = -1;

  // 1. stage the block's keys; block minimum over every row
  int m = SR_SENTINEL;
  for (int j = tid; j < p.blk; j += blockDim.x) {
    const long long row = row0 + j;
    int k = SR_SENTINEL;
    if (row < p.n) {
      k = p.keys[row];
      if (kWords && !((__ldg(p.mask_words + (row >> 5)) >> (row & 31)) & 1)) {
        k = SR_SENTINEL;
      }
    }
    slot_sh[j] = k;
    m = min(m, k);
  }
  for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    int v = tid < (int)(blockDim.x >> 5) ? red[tid] : SR_SENTINEL;
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (tid == 0) red[0] = v;
  }
  __syncthreads();
  const int base = red[0];
  if (base == SR_SENTINEL) {            // fully masked block
    if (tid == 0) p.abase[b] = -1;
    return;
  }
  int ab = base >= 0 ? (base / 128) * 128 : -((-base + 127) / 128) * 128;
  ab = max(min(ab, p.gbase_max), 0);
  if (tid == 0) p.abase[b] = ab;
  // 2. keys -> window slots (sentinel rows land far outside [0, W)), and
  //    the value words of the rows in the window staged in shared memory
  //    with coalesced loads (vals_sh[f * blk + j] for value column f)
  for (int j = tid; j < p.blk; j += blockDim.x) {
    const long long local = (long long)slot_sh[j] - ab;
    const bool in = local >= 0 && local < p.W;
    slot_sh[j] = in ? (int)local : -1;
    if (in) {
      atomicMin(&first_sh[local], j);   // integer atomics: order-free
      atomicMax(&last_sh[local], j);
      for (int f = 0; f < p.nfields; ++f) {
        vals_sh[f * p.blk + j] =
            __ldg(static_cast<const int*>(p.fsrc[f]) + row0 + j);
      }
    }
  }
  __syncthreads();

  // 3. thread s reduces the rows of window slot s in row order, over the
  //    row range [first, last] where its slot occurs (its run when the
  //    keys are sorted), one output slot at a time with a branch-free loop
  const int s = tid;
  const int lo = first_sh[s], hi = last_sh[s];
  const long long at = (long long)b * p.W + s;
  int cnt = 0;
  for (int j = lo; j <= hi; ++j) cnt += slot_sh[j] == s;
  static_cast<int*>(p.part[0])[at] = cnt;
  for (int q = 1; q < p.nslots; ++q) {
    const int* col = vals_sh + p.field[q] * p.blk;
    const int kind = p.kind[q];
    if (kind == SR_SUM_I32) {
      long long a = 0;
      for (int j = lo; j <= hi; ++j) {
        if (slot_sh[j] == s) a += col[j];
      }
      static_cast<long long*>(p.part[q])[at] = a;
    } else if (kind == SR_MIN_I32 || kind == SR_MAX_I32) {
      const bool mx = kind == SR_MAX_I32;
      int a = mx ? (int)0x80000000 : 0x7fffffff;
      for (int j = lo; j <= hi; ++j) {
        if (slot_sh[j] == s) a = mx ? max(a, col[j]) : min(a, col[j]);
      }
      static_cast<int*>(p.part[q])[at] = a;
    } else if (kind == SR_SUM_F32) {
      float a = 0.0f;
      for (int j = lo; j <= hi; ++j) {
        if (slot_sh[j] == s) a += __int_as_float(col[j]);
      }
      static_cast<float*>(p.part[q])[at] = a;
    } else {
      const bool mx = kind == SR_MAX_F32;
      float a = __int_as_float(mx ? (int)0xff800000 : 0x7f800000);
      for (int j = lo; j <= hi; ++j) {
        if (slot_sh[j] == s) {
          const float v = __int_as_float(col[j]);
          a = mx ? sr_fmax(a, v) : sr_fmin(a, v);
        }
      }
      static_cast<float*>(p.part[q])[at] = a;
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
  if (p->blk > SR_MAX_BLK || p->W % 128 != 0 || p->W > SR_MAX_W
      || p->nslots < 1 || p->nslots > SR_MAX_SLOTS
      || p->nfields < 0 || p->nfields > SR_MAX_FIELDS
      || p->kind[0] != SR_COUNT) {
    return (int)cudaErrorInvalidValue;
  }
  for (int q = 1; q < p->nslots; ++q) {
    if (p->field[q] < 0 || p->field[q] >= p->nfields) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (p->nblk == 0) return 0;
  const int smem = p->nfields * p->blk * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      sr_partial_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  sr_partial_kernel<kWords><<<p->nblk, p->W, smem,
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
