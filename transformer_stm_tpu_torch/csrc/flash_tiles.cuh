// Tiles shared by the flash attention kernels (flash_attention.cu and
// flash_attention_bwd.cu).
//
// Every product of those kernels is a 64 x 64 tile summed over 64 rows of
// two operands in shared memory: a block of 256 threads computes it with
// each thread owning a 4 x 4 piece, rows 4*ty .. 4*ty+3 (one float4 shared
// load) and columns tx, tx+16, tx+32, tx+48 (four conflict-free scalar
// loads).  A head dim above 64 is cut into chunks of 64 columns, each
// loaded and summed in turn, so shared memory and the per-thread pieces do
// not grow with Dh; columns past Dh and rows past the sequence load zeros.
//
// Loads take a runtime flag `vec`: when Dh is a multiple of 4 and every
// base pointer is 16-byte aligned, rows are read as float4; otherwise one
// float at a time (odd head dims).
//
// Offsets that multiply a row index by the token stride are 64-bit: at
// B 128, S 16,384, H 1 a head's rows span 2^27 floats and a batch 2^31.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int TILE = 64;          // rows of a tile; columns of a Dh chunk
constexpr int LD = TILE + 4;      // shared row stride in floats
constexpr int THREADS = 256;      // 16 x 16 threads, a 4 x 4 piece each
constexpr int BUF = TILE * LD;    // floats of one shared tile
constexpr int MAX_DH = 256;       // four chunks

// acc[i][j] += sum_r A[r][4*ty + i] * B[r][tx + 16*j], r < 64.
__device__ __forceinline__ void tile_product(float (&acc)[4][4],
                                             const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(A + r * LD + 4 * ty);
    const float* brow = B + r * LD + tx;
    const float b0 = brow[0], b1 = brow[16], b2 = brow[32], b3 = brow[48];
    acc[0][0] = fmaf(a.x, b0, acc[0][0]); acc[0][1] = fmaf(a.x, b1, acc[0][1]);
    acc[0][2] = fmaf(a.x, b2, acc[0][2]); acc[0][3] = fmaf(a.x, b3, acc[0][3]);
    acc[1][0] = fmaf(a.y, b0, acc[1][0]); acc[1][1] = fmaf(a.y, b1, acc[1][1]);
    acc[1][2] = fmaf(a.y, b2, acc[1][2]); acc[1][3] = fmaf(a.y, b3, acc[1][3]);
    acc[2][0] = fmaf(a.z, b0, acc[2][0]); acc[2][1] = fmaf(a.z, b1, acc[2][1]);
    acc[2][2] = fmaf(a.z, b2, acc[2][2]); acc[2][3] = fmaf(a.z, b3, acc[2][3]);
    acc[3][0] = fmaf(a.w, b0, acc[3][0]); acc[3][1] = fmaf(a.w, b1, acc[3][1]);
    acc[3][2] = fmaf(a.w, b2, acc[3][2]); acc[3][3] = fmaf(a.w, b3, acc[3][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// Rows row0 .. row0+63 (those < n) and columns c0 .. c0+63 (those < dh) of
// one head into dst[col][row], transposed.  `base` points at row 0 of the
// head, `tok` floats between rows.  Neighbouring threads take neighbouring
// rows, so the shared stores of a warp hit 32 consecutive words.
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const float* __restrict__ base,
                                                int row0, int n, long tok,
                                                int c0, int dh, bool vec) {
  const int r = threadIdx.x % TILE;
  const bool ok = row0 + r < n;
  const float* src = base + (long)(row0 + r) * tok + c0;
  if (vec) {
#pragma unroll
    for (int p = 0; p < TILE / 16; ++p) {
      const int d = 4 * (threadIdx.x / TILE + 4 * p);  // float4 chunk start
      const float4 x = ok && c0 + d < dh
          ? *reinterpret_cast<const float4*>(src + d)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[d * LD + r] = x.x;
      dst[(d + 1) * LD + r] = x.y;
      dst[(d + 2) * LD + r] = x.z;
      dst[(d + 3) * LD + r] = x.w;
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < TILE / 4; ++p) {
      const int d = threadIdx.x / TILE + 4 * p;
      dst[d * LD + r] = ok && c0 + d < dh ? src[d] : 0.f;
    }
  }
}

// The same block into dst[row][col], as it lies in memory.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ base,
                                          int row0, int n, long tok, int c0,
                                          int dh, bool vec) {
  if (vec) {
#pragma unroll
    for (int p = 0; p < TILE * TILE / 4 / THREADS; ++p) {
      const int idx = threadIdx.x + THREADS * p;
      const int r = idx / (TILE / 4);
      const int d = 4 * (idx % (TILE / 4));
      const float4 x = row0 + r < n && c0 + d < dh
          ? *reinterpret_cast<const float4*>(base + (long)(row0 + r) * tok +
                                             c0 + d)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * LD + d) = x;
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < TILE * TILE / THREADS; ++p) {
      const int idx = threadIdx.x + THREADS * p;
      const int r = idx / TILE;
      const int d = idx % TILE;
      dst[r * LD + d] = row0 + r < n && c0 + d < dh
          ? base[(long)(row0 + r) * tok + c0 + d] : 0.f;
    }
  }
}

}  // namespace flash
