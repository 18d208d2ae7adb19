// flash_attention backward: dq, dk, dv of o = softmax(q k^T * scale) v in
// f32, for any head dim from 1 to 256 and any lengths.
//
// Replaces both Pallas TPU backward pairs of `flash_attention`
// (transformer_stm_tpu/kernels/flash_attention.py:175): `_bwd_pallas` :296
// with `_flash_bwd_dq_kernel` :185 and `_flash_bwd_dkv_kernel` :221 (the
// whole other side resident in VMEM), and `_bwd_pallas_streaming` :469 with
// `_stream_bwd_dq_kernel` :388 and `_stream_bwd_dkv_kernel` :429 (both sides
// blocked, picked by `_bwd` :601 once residency passes 12 MiB, as at 512px).
// The two differ only in what stays in VMEM; a Hopper block has no such
// budget to fit, so one design serves both.  With p = exp(q.k * scale -
// lse), dp = dO.v and delta = rowsum(dO * o) (one torch reduction before
// the launch, as the JAX package computes it outside its kernels, :284):
//
//   dq = scale * sum_s p (dp - delta) k     (kernel `flash_bwd_dq`, one block
//                                            per 64 query rows, K/V streamed)
//   dk = scale * sum_t p (dp - delta) q     (kernel `flash_bwd_dkv`, one block
//   dv =         sum_t p dO                  per 64 key rows, Q/dO streamed)
//
// Both kernels rebuild p from the forward's saved lse.  Every output row is
// owned by exactly one block and written once: no atomics, and two calls
// give the same bits.
//
// Bound: operations.  The least work is five products of 2*B*H*T*S*Dh flops;
// at the 512px CvT's stage 1 (B 128, T = S = 16,384, H 1, Dh 64) that is
// 22.0 TFLOP, 328 ms at the 67 TFLOP/s of f32 FMA.  The split recomputes
// q k^T and dO v^T in both kernels, as the JAX split does: 14 units of work
// where 10 are needed, for no atomics.
//
// Design: `attention_small_bwd.cu`'s 64 x 64 tiles (flash_tiles.cuh), with
// Dh cut into 64-column chunks: the scores and dp sum over the chunks of
// both sides, and each output chunk has its own 4 x 4 accumulators (dq: 16
// per chunk; dk and dv: 32).  Shared memory is six 64 x 68 tiles (104,448
// bytes) whatever Dh is.  With one chunk (Dh <= 64) the owned side stays
// resident and two blocks fit an SM; with more, both sides' chunks reload
// per streamed tile and one block (up to 255 registers) runs per SM.
//
// Masking: keys past S and query rows past T load zeros, get p = 0, and
// store nothing; columns past Dh load zeros and store nothing.
//
// Layout: q, dO, dq (B, T, H, Dh); k, v, dk, dv (B, S, H, Dh); lse and
// delta (B, H, T); all contiguous f32.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

constexpr int SMEM = 6 * BUF * (int)sizeof(float);  // 104,448 bytes

// dq for 64 query rows of one (batch, head); K and V stream through in
// 64-key tiles.
template <int NC>
__global__ void __launch_bounds__(THREADS, NC == 1 ? 2 : 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int T, int S, int H, int dh, float scale,
             bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;          // [d][query]
  float* gt = qt + BUF;      // [d][query]   dO
  float* kt = gt + BUF;      // [d][key]
  float* kn = kt + BUF;      // [key][d]
  float* vt = kn + BUF;      // [d][key]
  float* dst = vt + BUF;     // [key][query] dS

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long tok = (long)H * dh;
  const float* qbase = q + (long)b * T * tok + (long)h * dh;
  const float* gbase = g + (long)b * T * tok + (long)h * dh;
  const float* kbase = k + (long)b * S * tok + (long)h * dh;
  const float* vbase = v + (long)b * S * tok + (long)h * dh;

  float row_lse[4], row_delta[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    row_ok[i] = t < T;
    row_lse[i] = row_ok[i] ? lse[(long)bh * T + t] : 0.f;
    row_delta[i] = row_ok[i] ? delta[(long)bh * T + t] : 0.f;
  }
  float acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);

  if (NC == 1) {
    load_transposed(qt, qbase, t0, T, tok, 0, dh, vec);
    load_transposed(gt, gbase, t0, T, tok, 0, dh, vec);
  }
  for (int s0 = 0; s0 < S; s0 += TILE) {
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __syncthreads();  // every thread is done with the previous tiles
      if (NC > 1) {
        load_transposed(qt, qbase, t0, T, tok, TILE * c, dh, vec);
        load_transposed(gt, gbase, t0, T, tok, TILE * c, dh, vec);
      }
      load_transposed(kt, kbase, s0, S, tok, TILE * c, dh, vec);
      load_transposed(vt, vbase, s0, S, tok, TILE * c, dh, vec);
      if (NC == 1) load_rows(kn, kbase, s0, S, tok, 0, dh, vec);
      __syncthreads();
      tile_product(sc, qt, kt, ty, tx);  // q . k
      tile_product(dp, gt, vt, ty, tx);  // dO . v
    }
    // dst was last read before this tile's first barrier.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = s0 + tx + 16 * j < S;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key_ok && row_ok[i]
            ? expf(sc[i][j] * scale - row_lse[i]) : 0.f;
        ds[i] = p * (dp[i][j] - row_delta[i]);
      }
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * LD + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    if (NC == 1) {
      __syncthreads();
      tile_product(acc[0], dst, kn, ty, tx);  // dS k
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        __syncthreads();  // dst is written; the previous chunk of kn is read
        load_rows(kn, kbase, s0, S, tok, TILE * c, dh, vec);
        __syncthreads();
        tile_product(acc[c], dst, kn, ty, tx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    float* out = dq + ((long)b * T + t0 + 4 * ty + i) * tok + (long)h * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = TILE * c + tx + 16 * j;
        if (d < dh) out[d] = acc[c][i][j] * scale;
      }
    }
  }
}

// dk and dv for 64 key rows of one (batch, head); Q, dO, lse and delta
// stream through in 64-query tiles.
template <int NC>
__global__ void __launch_bounds__(THREADS, NC == 1 ? 2 : 1)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int T, int S,
              int H, int dh, float scale, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;          // [d][key]
  float* vt = kt + BUF;      // [d][key]
  float* qt = vt + BUF;      // [d][query], then p as [query][key]
  float* gt = qt + BUF;      // [d][query] dO, then dS as [query][key]
  float* qn = gt + BUF;      // [query][d]
  float* gn = qn + BUF;      // [query][d] dO
  float* ps = qt;
  float* dss = gt;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int s0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long tok = (long)H * dh;
  const float* qbase = q + (long)b * T * tok + (long)h * dh;
  const float* gbase = g + (long)b * T * tok + (long)h * dh;
  const float* kbase = k + (long)b * S * tok + (long)h * dh;
  const float* vbase = v + (long)b * S * tok + (long)h * dh;

  float acc_k[NC][4][4], acc_v[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    zero(acc_k[c]);
    zero(acc_v[c]);
  }

  if (NC == 1) {
    load_transposed(kt, kbase, s0, S, tok, 0, dh, vec);
    load_transposed(vt, vbase, s0, S, tok, 0, dh, vec);
  }
  for (int t0 = 0; t0 < T; t0 += TILE) {
    float col_lse[4], col_delta[4];
    bool col_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      col_ok[j] = t < T;
      col_lse[j] = col_ok[j] ? lse[(long)bh * T + t] : 0.f;
      col_delta[j] = col_ok[j] ? delta[(long)bh * T + t] : 0.f;
    }
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __syncthreads();  // every thread is done with the previous tiles
      if (NC > 1) {
        load_transposed(kt, kbase, s0, S, tok, TILE * c, dh, vec);
        load_transposed(vt, vbase, s0, S, tok, TILE * c, dh, vec);
      }
      load_transposed(qt, qbase, t0, T, tok, TILE * c, dh, vec);
      load_transposed(gt, gbase, t0, T, tok, TILE * c, dh, vec);
      if (NC == 1) {
        load_rows(qn, qbase, t0, T, tok, 0, dh, vec);
        load_rows(gn, gbase, t0, T, tok, 0, dh, vec);
      }
      __syncthreads();
      tile_product(sc, kt, qt, ty, tx);  // k . q
      tile_product(dp, vt, gt, ty, tx);  // v . dO
    }
    __syncthreads();  // qt and gt are read; p and dS take their place
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = col_ok[j] && s0 + 4 * ty + i < S
            ? expf(sc[i][j] * scale - col_lse[j]) : 0.f;
        ds[i] = p[i] * (dp[i][j] - col_delta[j]);
      }
      const int at = (tx + 16 * j) * LD + 4 * ty;
      *reinterpret_cast<float4*>(ps + at) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + at) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    if (NC == 1) {
      __syncthreads();
      tile_product(acc_v[0], ps, gn, ty, tx);   // p^T dO
      tile_product(acc_k[0], dss, qn, ty, tx);  // dS^T q
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        __syncthreads();  // p and dS are written; the last chunk is read
        load_rows(qn, qbase, t0, T, tok, TILE * c, dh, vec);
        load_rows(gn, gbase, t0, T, tok, TILE * c, dh, vec);
        __syncthreads();
        tile_product(acc_v[c], ps, gn, ty, tx);
        tile_product(acc_k[c], dss, qn, ty, tx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
    if (s >= S) continue;
    const long at = ((long)b * S + s) * tok + (long)h * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = TILE * c + tx + 16 * j;
        if (d < dh) {
          dk[at + d] = acc_k[c][i][j] * scale;
          dv[at + d] = acc_v[c][i][j];
        }
      }
    }
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, const float* g,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, int B, int T, int S, int H, int dh, float scale,
           bool vec, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((T + TILE - 1) / TILE, B * H);
  flash_bwd_dq<NC><<<grid_q, THREADS, SMEM, stream>>>(
      q, k, v, g, lse, delta, dq, T, S, H, dh, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((S + TILE - 1) / TILE, B * H);
  flash_bwd_dkv<NC><<<grid_k, THREADS, SMEM, stream>>>(
      q, k, v, g, lse, delta, dk, dv, T, S, H, dh, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when both launches were accepted.  `vec`
// != 0 promises Dh % 4 == 0 and 16-byte aligned q, k, v and dO.
extern "C" int launch_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* g,
    const float* lse, const float* delta, float* dq, float* dk, float* dv,
    int B, int T, int S, int H, int Dh, float scale, int vec,
    cudaStream_t stream) {
  if (Dh < 1 || Dh > MAX_DH || B <= 0 || T <= 0 || S <= 0 || H <= 0 ||
      (long)B * H > 65535 || (vec && Dh % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  switch ((Dh + TILE - 1) / TILE) {
    case 1: return launch<1>(q, k, v, g, lse, delta, dq, dk, dv, B, T, S, H,
                             Dh, scale, vec, stream);
    case 2: return launch<2>(q, k, v, g, lse, delta, dq, dk, dv, B, T, S, H,
                             Dh, scale, vec, stream);
    case 3: return launch<3>(q, k, v, g, lse, delta, dq, dk, dv, B, T, S, H,
                             Dh, scale, vec, stream);
    default: return launch<4>(q, k, v, g, lse, delta, dq, dk, dv, B, T, S, H,
                              Dh, scale, vec, stream);
  }
}
