// Host codec of druid_tpu_torch's segment storage: the LZ4 block format and
// the bitmap-word unpack.
//
// The port's own copy of the LZ4 and bit-unpacking entry points of the
// reference package's host library (native/druid_native.cpp), with the same
// C signatures and the same bytes out: a block this file compresses is the
// block the reference's library compresses, so either package reads the
// other's segments. Host C++, not a device kernel: it compresses the column
// parts a segment persists (storage/codec.py, storage/format*.py) and
// decompresses them at load.
//
// Contents:
//   * LZ4 block-format compressor/decompressor (standard LZ4 block format;
//     greedy hash-table matcher over 4-byte windows).
//   * Multi-threaded batch decompression of a column's blocks.
//   * Bit-unpacking of packed MSB-first bitmap words into byte masks.
//
// Built with g++ (-O3 -fPIC -shared -std=c++17) into build/host/ the first
// time a codec call needs it, and loaded with ctypes
// (druid_tpu_torch/_build.py, druid_tpu_torch/native/__init__.py). A failed
// build raises; there is no fallback codec.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format
// ---------------------------------------------------------------------------

int64_t druid_lz4_compress_bound(int64_t n) {
  return n + n / 255 + 16;
}

// Compress src[0..n) into dst (capacity dst_cap). Returns compressed size,
// or -1 on overflow. Greedy hash-table matcher over 4-byte windows.
int64_t druid_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t dst_cap) {
  const int HASH_LOG = 16;
  const int64_t MIN_MATCH = 4;
  const int64_t MFLIMIT = 12;   // last match must start before n-MFLIMIT
  const int64_t LAST_LITERALS = 5;

  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  int64_t anchor = 0;

  auto emit_sequence = [&](int64_t lit_start, int64_t lit_len, int64_t offset,
                           int64_t match_len) -> bool {
    // token
    int64_t ml = match_len >= MIN_MATCH ? match_len - MIN_MATCH : 0;
    uint8_t tok_lit = lit_len >= 15 ? 15 : (uint8_t)lit_len;
    uint8_t tok_ml = (match_len > 0) ? (ml >= 15 ? 15 : (uint8_t)ml) : 0;
    if (op >= oend) return false;
    *op++ = (uint8_t)((tok_lit << 4) | tok_ml);
    if (lit_len >= 15) {
      int64_t rest = lit_len - 15;
      while (rest >= 255) { if (op >= oend) return false; *op++ = 255; rest -= 255; }
      if (op >= oend) return false;
      *op++ = (uint8_t)rest;
    }
    if (op + lit_len > oend) return false;
    std::memcpy(op, src + lit_start, (size_t)lit_len);
    op += lit_len;
    if (match_len > 0) {
      if (op + 2 > oend) return false;
      *op++ = (uint8_t)(offset & 0xFF);
      *op++ = (uint8_t)((offset >> 8) & 0xFF);
      if (ml >= 15) {
        int64_t rest = ml - 15;
        while (rest >= 255) { if (op >= oend) return false; *op++ = 255; rest -= 255; }
        if (op >= oend) return false;
        *op++ = (uint8_t)rest;
      }
    }
    return true;
  };

  if (n >= MFLIMIT + 1) {
    std::vector<int64_t> table((size_t)1 << HASH_LOG, -1);
    const int64_t match_limit = n - LAST_LITERALS;
    int64_t p = 0;
    while (p < n - MFLIMIT) {
      uint32_t seq;
      std::memcpy(&seq, src + p, 4);
      uint32_t h = (seq * 2654435761u) >> (32 - HASH_LOG);
      int64_t cand = table[h];
      table[h] = p;
      uint32_t cand_seq = 0;
      if (cand >= 0 && p - cand <= 0xFFFF) {
        std::memcpy(&cand_seq, src + cand, 4);
      }
      if (cand >= 0 && p - cand <= 0xFFFF && cand_seq == seq) {
        // extend match
        int64_t m = 4;
        while (p + m < match_limit && src[cand + m] == src[p + m]) m++;
        if (!emit_sequence(anchor, p - anchor, p - cand, m)) return -1;
        p += m;
        anchor = p;
      } else {
        p++;
      }
    }
  }
  // final literals
  if (!emit_sequence(anchor, n - anchor, 0, 0)) return -1;
  return op - dst;
}

// Decompress src[0..src_len) into dst (exact capacity dst_cap).
// Returns decompressed size, or -1 on malformed input.
int64_t druid_lz4_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                             int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  while (ip < iend) {
    unsigned token = *ip++;
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        lit_len += s;
      } while (s == 255);
    }
    // compare against remaining space, NOT `ip + lit_len` — a crafted
    // multi-byte length (~2^40) would overflow the pointer sum into UB
    if (lit_len > iend - ip || lit_len > oend - op) return -1;
    std::memcpy(op, ip, (size_t)lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // last sequence: literals only
    if (ip + 2 > iend) return -1;
    int64_t offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t match_len = (int64_t)(token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        match_len += s;
      } while (s == 255);
    }
    if (match_len > oend - op) return -1;
    const uint8_t* match = op - offset;
    for (int64_t i = 0; i < match_len; i++) op[i] = match[i];  // overlap-safe
    op += match_len;
  }
  return op - dst;
}

// Decompress k blocks (possibly in parallel) from a concatenated source blob
// into a contiguous destination. Returns 0 on success, -(i+1) if block i
// failed. The per-block layout arrays are int64.
int64_t druid_lz4_decompress_batch(const uint8_t* src,
                                   const int64_t* src_offsets,
                                   const int64_t* src_sizes,
                                   uint8_t* dst,
                                   const int64_t* dst_offsets,
                                   const int64_t* dst_sizes,
                                   int64_t k, int64_t n_threads) {
  if (n_threads <= 1 || k <= 1) {
    for (int64_t i = 0; i < k; i++) {
      int64_t got = druid_lz4_decompress(src + src_offsets[i], src_sizes[i],
                                         dst + dst_offsets[i], dst_sizes[i]);
      if (got != dst_sizes[i]) return -(i + 1);
    }
    return 0;
  }
  int64_t nt = std::min<int64_t>(n_threads, k);
  std::vector<std::thread> threads;
  std::vector<int64_t> status((size_t)nt, 0);
  for (int64_t t = 0; t < nt; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < k; i += nt) {
        int64_t got = druid_lz4_decompress(src + src_offsets[i], src_sizes[i],
                                           dst + dst_offsets[i], dst_sizes[i]);
        if (got != dst_sizes[i]) { status[(size_t)t] = -(i + 1); return; }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int64_t t = 0; t < nt; t++) if (status[(size_t)t] != 0) return status[(size_t)t];
  return 0;
}

// ---------------------------------------------------------------------------
// Bitmap word unpack: packed MSB-first uint8 words -> byte mask (0/1),
// the staging step that turns a host bitmap-planner result into a device
// row mask.
// ---------------------------------------------------------------------------
void druid_unpack_bits(const uint8_t* words, int64_t n_rows, uint8_t* out) {
  int64_t full = n_rows / 8;
  for (int64_t w = 0; w < full; w++) {
    uint8_t v = words[w];
    uint8_t* o = out + w * 8;
    o[0] = (v >> 7) & 1; o[1] = (v >> 6) & 1; o[2] = (v >> 5) & 1;
    o[3] = (v >> 4) & 1; o[4] = (v >> 3) & 1; o[5] = (v >> 2) & 1;
    o[6] = (v >> 1) & 1; o[7] = v & 1;
  }
  int64_t rem = n_rows - full * 8;
  if (rem) {
    uint8_t v = words[full];
    for (int64_t i = 0; i < rem; i++) out[full * 8 + i] = (v >> (7 - i)) & 1;
  }
}

}  // extern "C"
