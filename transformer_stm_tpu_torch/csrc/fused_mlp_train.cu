// fused_mlp_train: the training MLP y = Drop2(Drop1(GELU(x W1 + b1)) W2 + b2)
// in f32, forward and backward, with both dropout masks drawn inside the
// kernels and the (N, Hd) hidden activation never in device memory.
//
// Replaces the Pallas TPU kernels of `make_fused_mlp_train`
// (transformer_stm_tpu/kernels/fused_mlp.py:291): the forward
// `_mlp_train_fwd_kernel` (:170) and the backward `_mlp_train_bwd_kernel`
// (:189).  GELU is the exact erf form through `erff`.
//
// Dropout masks.  The TPU kernels drew their bits from the core PRNG seeded
// per token block.  Here a mask element is a pure function of the call's two
// seed words and the element's global index e = row * width + col, so forward
// and backward rebuild the same masks whatever the block size: Philox-4x32-10
// keyed on (seed[0], seed[1]) with the counter (lo32(e >> 2), stream,
// hi32(e >> 2), 0) gives four words, and word e & 3 belongs to element e.
// Stream 1 is the hidden mask m1 (width Hd), stream 2 the output mask m2
// (width D).  A unit is kept iff its word >= thr (unsigned compare,
// thr = min(floor(rate 2^32), 2^32 - 1)) and kept units scale by `scale`
// = 1 / (1 - rate).  thr == 0 (rate 0) skips the masks.  The plain version
// in kernels/fused_mlp.py computes the same function with int64 torch ops.
// The slot index of the multi-target trainer is deliberately not in the key:
// two slots with the same seed train alike, as in JAX.
//
// Bound: operations (f32 FMA outside the tensor cores).  The forward does
// 4 N D Hd flops, the backward 10 N D Hd (a recomputed, dh = g W2^T,
// dx = da W1^T, dW1 = x^T da, dW2 = h^T g), against a few bytes per row.
//
// Forward: the layout of csrc/fused_mlp.cu (32-row blocks walk the hidden
// width in 64-unit chunks; x and the hidden chunk are kept transposed in
// shared memory) with the two masks applied from keep bits that the block
// draws into shared memory.
//
// Backward: a block owns BM rows and walks the hidden width in chunks of BH
// units.  Per chunk it recomputes a = x W1[:, chunk] + b1, h = GELU(a) m1 and
// GELU'(a) m1, forms dh = g W2[chunk, :]^T and da = dh GELU'(a) m1 (g = dy m2
// is built once per block), adds da W1[:, chunk]^T into register
// accumulators of dx, and writes this block's partial dW1[:, chunk] = x^T da,
// db1[chunk], dW2[chunk, :] = h^T g (db2 once).  The caller sums the partials
// over blocks in a fixed order: no atomics, so two calls agree bit for bit.
// Every shared-memory operand is either read as a warp-wide broadcast float4
// along the reduction axis or by consecutive lanes from rows padded by one
// word, so no read has a bank conflict.  BM x D is 8,192 or 16,384 floats;
// (D, BM, BH) = (64, 128, 64), (128, 128, 32), (256, 64, 32) keep shared
// memory under 227 KB and the partials near 134 MB at CvT stages 1 and 2
// (273 MB at stage 3, where 64-row blocks keep 130 blocks in flight).
//
// Layout: x, dy, dx (N, D); w1 (D, Hd); b1 (Hd); w2 (Hd, D); b2 (D); seed
// int32[2] on the device; partials dw1p (nb, D, Hd), db1p (nb, Hd), dw2p
// (nb, Hd, D), db2p (nb, D) with nb = ceil(N / BM); all contiguous.  Rows
// past N are zero-filled, contribute nothing and are not stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

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

// Keep bits of the (rows x cols) tile at (row0, col0) of a mask of `width`
// columns, one byte per element, row-major into dst; cols % 4 == 0 and
// col0 % 4 == 0.  All threads of the block take part.
__device__ __forceinline__ void keep_bits(uint8_t* dst, int rows, int cols, long row0,
                                          int col0, int width, uint32_t stream,
                                          uint32_t k0, uint32_t k1, uint32_t thr) {
  const int groups = rows * cols / 4;
  for (int idx = threadIdx.x; idx < groups; idx += THREADS) {
    const int r = idx / (cols / 4);
    const int c = 4 * (idx % (cols / 4));
    const uint64_t g = (uint64_t)((row0 + r) * width + col0 + c) >> 2;
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)g, stream, (uint32_t)(g >> 32), 0u), k0, k1);
    uchar4 keep = make_uchar4(w.x >= thr, w.y >= thr, w.z >= thr, w.w >= thr);
    *reinterpret_cast<uchar4*>(dst + r * cols + c) = keep;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int FBM = 32;         // rows per block
constexpr int FBH = 64;         // hidden units per chunk
constexpr int FPAD = FBM + 4;   // row length of the transposed tiles

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(D * FPAD + D * FBH + FBH * D + FBH * FPAD) +
         (size_t)(FBM * FBH + FBM * D);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
mlp_train_fwd(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, const int* __restrict__ seed,
              float* __restrict__ y, int N, int Hd, uint32_t thr, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;               // [D][FPAD]    x tile, transposed
  float* w1s = xt + D * FPAD;     // [D][FBH]     W1[:, chunk]
  float* w2s = w1s + D * FBH;     // [FBH][D]     W2[chunk, :]
  float* ht = w2s + FBH * D;      // [FBH][FPAD]  hidden chunk, transposed
  uint8_t* m1 = reinterpret_cast<uint8_t*>(ht + FBH * FPAD);  // [FBM][FBH]
  uint8_t* m2 = m1 + FBM * FBH;                                // [FBM][D]

  constexpr int NC = D / 32;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 4;
  const long row0 = (long)blockIdx.x * FBM;
  const uint32_t k0 = (uint32_t)seed[0], k1 = (uint32_t)seed[1];

  for (int idx = tid; idx < FBM * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    xt[c * FPAD + r] = row0 + r < N ? x[(row0 + r) * D + c] : 0.f;
  }
  if (thr) keep_bits(m2, FBM, D, row0, 0, D, 2u, k0, k1, thr);

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;

  for (int h0 = 0; h0 < Hd; h0 += FBH) {
    __syncthreads();  // x tile written; the previous chunk fully consumed
    for (int idx = tid; idx < D * FBH / 4; idx += THREADS) {
      const int r = idx / (FBH / 4);
      const int c4 = idx % (FBH / 4);
      reinterpret_cast<float4*>(w1s)[idx] =
          *reinterpret_cast<const float4*>(w1 + (long)r * Hd + h0 + 4 * c4);
    }
    const float4* w2src = reinterpret_cast<const float4*>(w2 + (long)h0 * D);
    for (int idx = tid; idx < FBH * D / 4; idx += THREADS) {
      reinterpret_cast<float4*>(w2s)[idx] = w2src[idx];
    }
    if (thr) keep_bits(m1, FBM, FBH, row0, h0, Hd, 1u, k0, k1, thr);
    __syncthreads();

    // Hidden units lane and lane + 32 of the chunk, rows r0..r0+3.
    float ha[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) ha[r][0] = ha[r][1] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(xt + kk * FPAD + r0);
      const float wa = w1s[kk * FBH + lane];
      const float wb = w1s[kk * FBH + lane + 32];
      ha[0][0] = fmaf(xv.x, wa, ha[0][0]); ha[0][1] = fmaf(xv.x, wb, ha[0][1]);
      ha[1][0] = fmaf(xv.y, wa, ha[1][0]); ha[1][1] = fmaf(xv.y, wb, ha[1][1]);
      ha[2][0] = fmaf(xv.z, wa, ha[2][0]); ha[2][1] = fmaf(xv.z, wb, ha[2][1]);
      ha[3][0] = fmaf(xv.w, wa, ha[3][0]); ha[3][1] = fmaf(xv.w, wb, ha[3][1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lane + 32 * j;
      const float bias = b1[h0 + col];
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        m[r] = thr ? (m1[(r0 + r) * FBH + col] ? scale : 0.f) : 1.f;
      *reinterpret_cast<float4*>(ht + col * FPAD + r0) = make_float4(
          gelu_erf(ha[0][j] + bias) * m[0], gelu_erf(ha[1][j] + bias) * m[1],
          gelu_erf(ha[2][j] + bias) * m[2], gelu_erf(ha[3][j] + bias) * m[3]);
    }
    __syncthreads();

    // acc[r][i] += sum_j ht[j][r0 + r] * W2[h0 + j][lane + 32 i].
#pragma unroll 4
    for (int j = 0; j < FBH; ++j) {
      const float4 hv = *reinterpret_cast<const float4*>(ht + j * FPAD + r0);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float w = w2s[j * D + lane + 32 * i];
        acc[0][i] = fmaf(hv.x, w, acc[0][i]);
        acc[1][i] = fmaf(hv.y, w, acc[1][i]);
        acc[2][i] = fmaf(hv.z, w, acc[2][i]);
        acc[3][i] = fmaf(hv.w, w, acc[3][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long row = row0 + r0 + r;
    if (row < N) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        const float m = thr ? (m2[(r0 + r) * D + c] ? scale : 0.f) : 1.f;
        y[row * D + c] = (acc[r][i] + b2[c]) * m;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int D, int BM, int BH>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BM * D + 2 * BM * BH + D * (BH + 1) +
                                  BH * (D + 1)) +
         (size_t)(BM * BH);
}

template <int D, int BM, int BH>
__global__ void __launch_bounds__(THREADS, 1)
mlp_train_bwd(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w2, const int* __restrict__ seed,
              float* __restrict__ dx, float* __restrict__ dw1p,
              float* __restrict__ db1p, float* __restrict__ dw2p,
              float* __restrict__ db2p, int N, int Hd, uint32_t thr, float scale) {
  constexpr int RW = BM / 8;   // rows per warp
  constexpr int NC = D / 32;   // output columns per lane
  constexpr int JN = BH / 32;  // hidden units per lane
  constexpr int W1S = BH + 1;  // padded row lengths
  constexpr int W2S = D + 1;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // [BM][D]   x tile
  float* gs = xs + BM * D;     // [BM][D]   g = dy m2
  float* hs = gs + BM * D;     // [BM][BH]  h = GELU(a) m1
  float* das = hs + BM * BH;   // [BM][BH]  da
  float* w1s = das + BM * BH;  // [D][BH + 1]  W1[:, chunk]
  float* w2s = w1s + D * W1S;  // [BH][D + 1]  W2[chunk, :]
  uint8_t* m1 = reinterpret_cast<uint8_t*>(w2s + BH * W2S);  // [BM][BH]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w = tid / 32;
  const int r0 = w * RW;
  const long blk = blockIdx.x;
  const long row0 = blk * BM;
  const uint32_t k0 = (uint32_t)seed[0], k1 = (uint32_t)seed[1];

  // x tile and g = dy m2, four columns at a time.
  for (int idx = tid; idx < BM * D / 4; idx += THREADS) {
    const int r = idx / (D / 4);
    const int c = 4 * (idx % (D / 4));
    const long row = row0 + r;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), gv = xv;
    if (row < N) {
      xv = *reinterpret_cast<const float4*>(x + row * D + c);
      gv = *reinterpret_cast<const float4*>(dy + row * D + c);
      if (thr) {
        const uint64_t g = (uint64_t)(row * D + c) >> 2;
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)g, 2u, (uint32_t)(g >> 32), 0u), k0, k1);
        gv.x *= bits.x >= thr ? scale : 0.f;
        gv.y *= bits.y >= thr ? scale : 0.f;
        gv.z *= bits.z >= thr ? scale : 0.f;
        gv.w *= bits.w >= thr ? scale : 0.f;
      }
    }
    *reinterpret_cast<float4*>(xs + r * D + c) = xv;
    *reinterpret_cast<float4*>(gs + r * D + c) = gv;
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += gs[r * D + tid];
    db2p[blk * D + tid] = s;
  }

  float acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;

  for (int h0 = 0; h0 < Hd; h0 += BH) {
    __syncthreads();  // the previous chunk fully consumed
    for (int idx = tid; idx < D * BH; idx += THREADS) {
      const int k = idx / BH;
      const int j = idx % BH;
      w1s[k * W1S + j] = w1[(long)k * Hd + h0 + j];
    }
    for (int idx = tid; idx < BH * D; idx += THREADS) {
      const int j = idx / D;
      const int c = idx % D;
      w2s[j * W2S + c] = w2[(long)(h0 + j) * D + c];
    }
    if (thr) keep_bits(m1, BM, BH, row0, h0, Hd, 1u, k0, k1, thr);
    __syncthreads();

    // a = x W1[:, chunk] + b1 for rows r0.., units lane + 32 jj.
    float gp[RW][JN];
    {
      float a[RW][JN];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) a[r][jj] = 0.f;
#pragma unroll 2
      for (int k = 0; k < D; k += 4) {
        float wv[4][JN];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) wv[q][jj] = w1s[(k + q) * W1S + lane + 32 * jj];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + (r0 + r) * D + k);
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) {
            float s = a[r][jj];
            s = fmaf(xv.x, wv[0][jj], s);
            s = fmaf(xv.y, wv[1][jj], s);
            s = fmaf(xv.z, wv[2][jj], s);
            s = fmaf(xv.w, wv[3][jj], s);
            a[r][jj] = s;
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        const int j = lane + 32 * jj;
        const float bias = b1[h0 + j];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float av = a[r][jj] + bias;
          const float m = thr ? (m1[(r0 + r) * BH + j] ? scale : 0.f) : 1.f;
          hs[(r0 + r) * BH + j] = gelu_erf(av) * m;
          gp[r][jj] = gelu_grad(av) * m;
        }
      }
    }

    // dh = g W2[chunk, :]^T; da = dh GELU'(a) m1.
    {
      float dh[RW][JN];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) dh[r][jj] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        float wv[4][JN];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) wv[q][jj] = w2s[(lane + 32 * jj) * W2S + c + q];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 gv = *reinterpret_cast<const float4*>(gs + (r0 + r) * D + c);
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) {
            float s = dh[r][jj];
            s = fmaf(gv.x, wv[0][jj], s);
            s = fmaf(gv.y, wv[1][jj], s);
            s = fmaf(gv.z, wv[2][jj], s);
            s = fmaf(gv.w, wv[3][jj], s);
            dh[r][jj] = s;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int jj = 0; jj < JN; ++jj)
          das[(r0 + r) * BH + lane + 32 * jj] = dh[r][jj] * gp[r][jj];
    }
    __syncthreads();

    // dx[r][lane + 32 i] += sum_j da[r][j] W1[lane + 32 i][h0 + j].
#pragma unroll 2
    for (int j = 0; j < BH; j += 4) {
      float wv[4][NC];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < NC; ++i) wv[q][i] = w1s[(lane + 32 * i) * W1S + j + q];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(das + (r0 + r) * BH + j);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          float s = acc[r][i];
          s = fmaf(dv.x, wv[0][i], s);
          s = fmaf(dv.y, wv[1][i], s);
          s = fmaf(dv.z, wv[2][i], s);
          s = fmaf(dv.w, wv[3][i], s);
          acc[r][i] = s;
        }
      }
    }

    // dW1[k][h0 + j] = sum_r x[r][k] da[r][j], k = 32 m + 4 w + q,
    // j = lane + 32 jj; db1[h0 + j] = sum_r da[r][j].
    {
      float p[D / 32][4][JN];
      float s1[JN];
#pragma unroll
      for (int jj = 0; jj < JN; ++jj) {
        s1[jj] = 0.f;
#pragma unroll
        for (int m = 0; m < D / 32; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[m][q][jj] = 0.f;
      }
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float dv[JN];
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) {
          dv[jj] = das[r * BH + lane + 32 * jj];
          s1[jj] += dv[jj];
        }
#pragma unroll
        for (int m = 0; m < D / 32; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * D + 32 * m + 4 * w);
#pragma unroll
          for (int jj = 0; jj < JN; ++jj) {
            p[m][0][jj] = fmaf(xv.x, dv[jj], p[m][0][jj]);
            p[m][1][jj] = fmaf(xv.y, dv[jj], p[m][1][jj]);
            p[m][2][jj] = fmaf(xv.z, dv[jj], p[m][2][jj]);
            p[m][3][jj] = fmaf(xv.w, dv[jj], p[m][3][jj]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < D / 32; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int jj = 0; jj < JN; ++jj)
            dw1p[(blk * D + 32 * m + 4 * w + q) * Hd + h0 + lane + 32 * jj] = p[m][q][jj];
      if (w == 0) {
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) db1p[blk * Hd + h0 + lane + 32 * jj] = s1[jj];
      }
    }

    // dW2[h0 + j][c] = sum_r h[r][j] g[r][c], j = 32 p + 4 w + q,
    // c = lane + 32 i.
    {
      float p[JN][4][NC];
#pragma unroll
      for (int pp = 0; pp < JN; ++pp)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < NC; ++i) p[pp][q][i] = 0.f;
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float gv[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) gv[i] = gs[r * D + lane + 32 * i];
#pragma unroll
        for (int pp = 0; pp < JN; ++pp) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + r * BH + 32 * pp + 4 * w);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            p[pp][0][i] = fmaf(hv.x, gv[i], p[pp][0][i]);
            p[pp][1][i] = fmaf(hv.y, gv[i], p[pp][1][i]);
            p[pp][2][i] = fmaf(hv.z, gv[i], p[pp][2][i]);
            p[pp][3][i] = fmaf(hv.w, gv[i], p[pp][3][i]);
          }
        }
      }
#pragma unroll
      for (int pp = 0; pp < JN; ++pp)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < NC; ++i)
            dw2p[(blk * Hd + h0 + 32 * pp + 4 * w + q) * D + lane + 32 * i] = p[pp][q][i];
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const long row = row0 + r0 + r;
    if (row < N) {
#pragma unroll
      for (int i = 0; i < NC; ++i) dx[row * D + lane + 32 * i] = acc[r][i];
    }
  }
}

template <int D>
int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const int* seed, float* y, int N, int Hd,
               uint32_t thr, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + FBM - 1) / FBM);
  mlp_train_fwd<D><<<grid, THREADS, smem, stream>>>(x, w1, b1, w2, b2, seed, y, N,
                                                     Hd, thr, scale);
  return (int)cudaGetLastError();
}

template <int D, int BM, int BH>
int launch_bwd(const float* x, const float* dy, const float* w1, const float* b1,
               const float* w2, const int* seed, float* dx, float* dw1p, float* db1p,
               float* dw2p, float* db2p, int N, int Hd, int rows_per_block,
               uint32_t thr, float scale, cudaStream_t stream) {
  if (rows_per_block != BM || Hd % BH != 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = bwd_smem_bytes<D, BM, BH>();
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_train_bwd<D, BM, BH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + BM - 1) / BM);
  mlp_train_bwd<D, BM, BH><<<grid, THREADS, smem, stream>>>(
      x, dy, w1, b1, w2, seed, dx, dw1p, db1p, dw2p, db2p, N, Hd, thr, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return a cudaError_t as int: 0 when the launch was accepted.
extern "C" int launch_fused_mlp_train_fwd(const float* x, const float* w1,
                                          const float* b1, const float* w2,
                                          const float* b2, const int* seed, float* y,
                                          int N, int D, int Hd, int Dout,
                                          unsigned thr, float scale,
                                          cudaStream_t stream) {
  if (N <= 0 || Dout != D || Hd <= 0 || Hd % FBH != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_fwd<64>(x, w1, b1, w2, b2, seed, y, N, Hd, thr, scale, stream);
    case 128: return launch_fwd<128>(x, w1, b1, w2, b2, seed, y, N, Hd, thr, scale, stream);
    case 256: return launch_fwd<256>(x, w1, b1, w2, b2, seed, y, N, Hd, thr, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// rows_per_block must be the block height compiled for D (64: 128,
// 128: 128, 256: 64); the partials hold ceil(N / rows_per_block) blocks.
extern "C" int launch_fused_mlp_train_bwd(const float* x, const float* dy,
                                          const float* w1, const float* b1,
                                          const float* w2, const int* seed, float* dx,
                                          float* dw1p, float* db1p, float* dw2p,
                                          float* db2p, int N, int D, int Hd, int Dout,
                                          int rows_per_block, unsigned thr, float scale,
                                          cudaStream_t stream) {
  if (N <= 0 || Dout != D || Hd <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_bwd<64, 128, 64>(x, dy, w1, b1, w2, seed, dx, dw1p, db1p, dw2p, db2p,
                                     N, Hd, rows_per_block, thr, scale, stream);
    case 128:
      return launch_bwd<128, 128, 32>(x, dy, w1, b1, w2, seed, dx, dw1p, db1p, dw2p, db2p,
                                      N, Hd, rows_per_block, thr, scale, stream);
    case 256:
      return launch_bwd<256, 64, 32>(x, dy, w1, b1, w2, seed, dx, dw1p, db1p, dw2p, db2p,
                                     N, Hd, rows_per_block, thr, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
