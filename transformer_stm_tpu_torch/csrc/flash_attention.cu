// flash_attention forward: o = softmax(q k^T / sqrt(Dh)) v in f32 for any
// head dim from 1 to 256 and any lengths, and in training the per-row
// log-sum-exp that the backward reads.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (transformer_stm_tpu/kernels/flash_attention.py:48, launched by
// `_flash_fwd_impl` :102 through `flash_attention` :175).  The TPU kernel
// pads Dh to 128 lanes, walks K/V blocks on a sequential grid axis with
// the running max, denominator and output in VMEM scratch, and writes the
// lse into a padding channel of the output.  Here one block owns 64 query
// rows of one (batch, head) and loops over 64-key tiles itself, keeping the
// running state in registers; the lse is its own (B, H, T) array, and the
// inference launch passes a null pointer for it.
//
// Bound: operations.  4*B*H*T*S*Dh flops of f32 FMA against 4 tensors of
// about B*T*H*Dh floats; at the 512px CvT's stage 1 (B 128, T = S = 16,384,
// H 1, Dh 64) that is 8.80 TFLOP against 2.1 GB, 131 ms at the 67 TFLOP/s
// of f32 outside the tensor cores.
//
// Design (flash_tiles.cuh): per key tile, the 64 x 64 score tile is summed
// over Dh in 64-column chunks, each thread holding a 4 x 4 piece; the row
// max is reduced over the 16 threads of a row with warp shuffles, and each
// thread keeps a partial row sum over its own columns (rescaled with the
// row, reduced once at the end).  p goes to shared memory key-major, and
// the output tile o[64][Dh] += p^T-product with the V tile, one 64-column
// chunk at a time, 4 x 4 accumulators per chunk (at most 64 per thread).
// Shared memory is four 64 x 68 tiles (69,632 bytes) whatever Dh is.  With
// one chunk (Dh <= 64) q stays resident and K and V load together; with
// more, q and K chunks reload per key tile.  Plain f32 FMA; no tensor cores.
//
// Masking: keys past S get the score -1e30 (p = 0); query rows past T load
// zeros and store nothing; columns past Dh load zeros (no effect on the
// scores) and store nothing.
//
// Layout: q (B, T, H, Dh), k and v (B, S, H, Dh), o like q, lse (B, H, T),
// all contiguous f32.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

constexpr int SMEM = 4 * BUF * (int)sizeof(float);  // 69,632 bytes
constexpr float MASKED = -1e30f;

// Three blocks of 69,632 bytes fill an SM's shared memory at one chunk, so
// the register cap is 85 a thread there.
template <int NC>
__global__ void __launch_bounds__(THREADS, NC == 1 ? 3 : 1)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int T, int S, int H, int dh, float scale,
          bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;        // [d][query], one Dh chunk
  float* kt = qt + BUF;    // [d][key]
  float* vn = kt + BUF;    // [key][d]
  float* ps = vn + BUF;    // [key][query] p

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long tok = (long)H * dh;
  const float* qbase = q + (long)b * T * tok + (long)h * dh;
  const float* kbase = k + (long)b * S * tok + (long)h * dh;
  const float* vbase = v + (long)b * S * tok + (long)h * dh;

  float acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  float m[4], l[4];  // running row max; this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  if (NC == 1) load_transposed(qt, qbase, t0, T, tok, 0, dh, vec);
  for (int s0 = 0; s0 < S; s0 += TILE) {
    float sc[4][4];
    zero(sc);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __syncthreads();  // every thread is done with the previous tiles
      if (NC > 1) load_transposed(qt, qbase, t0, T, tok, TILE * c, dh, vec);
      load_transposed(kt, kbase, s0, S, tok, TILE * c, dh, vec);
      if (NC == 1) load_rows(vn, vbase, s0, S, tok, 0, dh, vec);
      __syncthreads();
      tile_product(sc, qt, kt, ty, tx);  // q . k
    }

    // Online softmax.  The 16 threads of a row are 16 consecutive lanes of
    // one warp (threadIdx = 16 ty + tx), so xor shuffles over 8, 4, 2, 1
    // stay inside the row.  Key 0 is in the first tile, so m is finite
    // from then on and alpha is 0 there.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = s0 + tx + 16 * j < S ? sc[i][j] * scale : MASKED;
        mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float alpha = expf(m[i] - mt);
      m[i] = mt;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][i][j] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - mt);
        l[i] += sc[i][j];
      }
    }
    // ps was last read before this tile's first barrier.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (tx + 16 * j) * LD + 4 * ty) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    if (NC == 1) {
      __syncthreads();
      tile_product(acc[0], ps, vn, ty, tx);  // p v
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        __syncthreads();  // ps is written; the previous chunk of vn is read
        load_rows(vn, vbase, s0, S, tok, TILE * c, dh, vec);
        __syncthreads();
        tile_product(acc[c], ps, vn, ty, tx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int t = t0 + 4 * ty + i;
    if (t >= T) continue;
    float* orow = o + ((long)b * T + t) * tok + (long)h * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = TILE * c + tx + 16 * j;
        if (d < dh) orow[d] = acc[c][i][j] / lt;
      }
    }
    if (lse != nullptr && tx == 0) lse[(long)bh * T + t] = m[i] + logf(lt);
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int T, int S, int H, int dh, float scale,
           bool vec, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  flash_fwd<NC><<<grid, THREADS, SMEM, stream>>>(q, k, v, o, lse, T, S, H,
                                                 dh, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.  `lse` may be
// null (inference).  `vec` != 0 promises Dh % 4 == 0 and 16-byte aligned
// q, k, v and o.
extern "C" int launch_flash_attention(const float* q, const float* k,
                                      const float* v, float* o, float* lse,
                                      int B, int T, int S, int H, int Dh,
                                      float scale, int vec,
                                      cudaStream_t stream) {
  if (Dh < 1 || Dh > MAX_DH || B <= 0 || T <= 0 || S <= 0 || H <= 0 ||
      (long)B * H > 65535 || (vec && Dh % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  switch ((Dh + TILE - 1) / TILE) {
    case 1: return launch<1>(q, k, v, o, lse, B, T, S, H, Dh, scale, vec, stream);
    case 2: return launch<2>(q, k, v, o, lse, B, T, S, H, Dh, scale, vec, stream);
    case 3: return launch<3>(q, k, v, o, lse, B, T, S, H, Dh, scale, vec, stream);
    default: return launch<4>(q, k, v, o, lse, B, T, S, H, Dh, scale, vec, stream);
  }
}
