// The training MLP's dropout masks, shared by the forward (csrc/fused_mlp.cu)
// and the backward (csrc/fused_mlp_train.cu).
//
// A mask element is a pure function of the call's two seed words and the
// element's global index e = row * width + col, so forward and backward
// rebuild the same masks whatever their tiles: Philox-4x32-10 keyed on
// (seed[0], seed[1]) with the counter (lo32(e >> 2), stream, hi32(e >> 2), 0)
// gives four words, and word e & 3 belongs to element e.  Stream 1 is the
// hidden mask m1 (width Hd), stream 2 the output mask m2 (width D).  Where
// tensor parallelism gives a launch the i-th of k column blocks of the
// hidden units (Hd of k Hd), m1's index is that of the whole mask, e = row *
// Hw + hoff + col with Hw = k Hd and hoff = i Hd, so that each shard drops
// its columns of the replicated MLP's mask; m2 is every shard's whole.  A unit
// is kept iff its word >= thr (unsigned compare, thr = min(floor(rate 2^32),
// 2^32 - 1)) and kept units scale by 1 / (1 - rate).  The plain version,
// `dropout_mask` in kernels/fused_mlp.py, computes the same words with int64
// torch ops.

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t STREAM_HIDDEN = 1, STREAM_OUT = 2;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the four words of the group of element e of a mask
__device__ __forceinline__ uint4 mask_words(long e, uint32_t stream, uint32_t k0, uint32_t k1) {
  const uint64_t g = (uint64_t)e >> 2;
  return philox4x32_10(make_uint4((uint32_t)g, stream, (uint32_t)(g >> 32), 0u), k0, k1);
}

// m1's columns hoff .. hoff + Hd - 1 of a mask Hw wide: whole groups of
// four, inside the mask
__host__ __device__ inline bool mask_part_ok(int Hd, int Hw, int hoff) {
  return hoff >= 0 && hoff % 4 == 0 && Hw % 4 == 0 && (long)hoff + Hd <= Hw;
}

}  // namespace philox
