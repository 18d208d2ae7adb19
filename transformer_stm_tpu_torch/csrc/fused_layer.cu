// Fused ViT-layer inference on folded (B * t_pad, E) token rows, in f32, and
// the int8 layer in f32 or bf16:
//
//   mode ATTN        y = x + OutProj(MHA(LN1 x))           attn_layer_infer
//   mode MLP         y = x + MLP(LN2 x)                     ln_mlp_infer
//   mode ATTN|MLP    z = x + MHA(LN1 x), y = z + MLP(LN2 z) vit_layer_infer
//   ATTN|MLP|Q8      the same with the six projections int8 vit_layer_infer_int8
//
// Replaces the Pallas TPU kernels of transformer_stm_tpu/kernels/fused_layer.py:
// `_attn_layer_kernel` :62 (`attn_layer_infer` :200), `_ln_mlp_kernel` :590
// (`ln_mlp_infer` :602), `_layer_kernel` :279 (`vit_layer_infer` :335) in
// float32, and `_layer_kernel_int8` :440 with `_quant_rows` :410 and `_qdot`
// :430 (`vit_layer_infer_int8` :509).  The first three in bfloat16 are
// csrc/vit_layer_sm90.cu (wgmma and TMA).
//
// Bound: operations.  At ViT-S (E 384, H 6, Dh 64, hidden 1536, t_pad 200) a
// layer does 0.77 GFLOP an image against 0.3 MB of x in and y out, far above
// the card's balance point.  The TPU kernels hold a block of images in VMEM:
// q, k, v and the attention output of every head plus the scores, 614 KB an
// image at ViT-S in bf16, where a block here has 227 KB of shared memory.  So
// the design is one block per image (a segment of rows) and the phases in
// turn, separated by __syncthreads(): LN1; the packed q/k/v projection; the
// attention of one head at a time with that head's K and V for the image in
// shared memory, query tiles of 32 rows and a whole-row softmax; the out
// projection plus the residual; LN2; the MLP as two products.  In f32 the
// products are FMA tiles (true f32: 4x4 outputs a thread) and the attention
// holds K^T and V in f32 (136 KB, one block an SM); in int8 the products run
// on the tensor cores (wmma 16x16x16 int8 -> int32, 64x128 tiles, operands
// staged with cp.async in two stages) and a bf16 layer's attention too (K
// and V in bf16, 104 KB at t_pad 200, so two blocks fit an SM).
// The per-image intermediates (xn, q/k/v, the attention output, z in f32,
// zn, the MLP hidden) go through a workspace in device memory, one slot per
// resident block, which the wrapper allocates; a block walks the images
// blockIdx.x, blockIdx.x + gridDim.x, ...
//
// Rounding points are the JAX kernels': q/k/v, p before p v (l sums the
// unrounded p) and the per-head output are rounded to x's type; products
// accumulate in f32 (int32 for int8); scores, softmax, l and z stay f32 (the
// merged modes keep z f32 in the workspace; mode ATTN writes it out in x's
// type).  At f32 every value is f32 and every product is true f32.  GELU is
// the Abramowitz-Stegun form of `_gelu_exact` (kernels/fused_mlp.py:33-49).
// Int8: weights come quantised per column from the wrapper; rows are
// quantised here per row (amax clamped at 1e-6, q = rint(v * (127 / amax))
// clipped to +-127), and the epilogue is ((acc * sx) * sw) + b.  Keys at or
// past t_real are masked to -1e30; padded query rows carry junk, as on the
// TPU.  Every offset that multiplies a row index is 64-bit.
//
// Limits (fused_layer.py states them for the router): Dh 64; E, H * Dh and
// the hidden width multiples of 64; t_pad a multiple of 8 whose attention
// phase fits 227 KB (t_pad <= 344 in f32, <= 464 for the bf16 int8 layer).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 64, TN = 64, TK = 32;  // product tile
constexpr int APAD = TM + 4;              // row length of the transposed A tile
constexpr int DH = 64;                    // head dim
constexpr int QT = 32;                    // query rows per attention tile
constexpr float NEG_INF = -1e30f;
constexpr int MODE_ATTN = 1, MODE_MLP = 2, MODE_Q8 = 4;

typedef __nv_bfloat16 bf16;
using namespace nvcuda;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded through T (round to nearest even) and back
template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

// `_gelu_exact`: x * 0.5 * (1 + erf(x / sqrt 2)), A&S 7.1.26 erf
__device__ __forceinline__ float gelu_as(float x) {
  const float z = x * 0.70710678118654752f;
  const float az = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.f - poly * expf(-az * az);
  const float erf = z > 0.f ? y : (z < 0.f ? -y : 0.f);
  return x * 0.5f * (1.f + erf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The f32 products: 64x64 output tiles, 4x4 outputs a thread, A (transposed)
// and B tiles of depth TK staged in shared memory, FMA sums (true f32).
template <class Epi>
__device__ void gemm_fma(const float* __restrict__ A, long lda, int rows,
                         const float* __restrict__ B, long ldb, int K, int N, float* smem,
                         Epi epi) {
  float* As = smem;              // [TK][APAD]  A tile, transposed
  float* Bs = smem + TK * APAD;  // [TK][TN]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int m0 = 0; m0 < rows; m0 += TM) {
    for (int n0 = 0; n0 < N; n0 += TN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += TK) {
        __syncthreads();  // the previous tile consumed
        for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
          const int r = i / TK, c = i % TK;
          As[c * APAD + r] = m0 + r < rows ? A[(long)(m0 + r) * lda + k0 + c] : 0.f;
        }
        for (int i = threadIdx.x; i < TK * TN; i += THREADS) {
          const int r = i / TN, c = i % TN;
          Bs[r * TN + c] = B[(long)(k0 + r) * ldb + n0 + c];
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * APAD + 4 * ty);
          const float4 b = *reinterpret_cast<const float4*>(Bs + kk * TN + 4 * tx);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + 4 * ty + i;
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < 4; ++j) epi(r, n0 + 4 * tx + j, acc[i][j]);
        }
      }
    }
  }
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int MM = 64, MN = 128, MK = 64;  // tensor-core product tile
constexpr int STAGES = 2;                  // A and B tiles in flight
constexpr int WLD = 36;                    // row length of a warp's f32 scratch

// shared memory of gemm_mma: STAGES stages of int8 A and B tiles, which the
// warps' epilogue scratch reuses once the last stage is consumed
constexpr size_t MMA_SMEM = STAGES * (size_t)(MM * MK + MK * MN) > (THREADS / 32) * 32 * WLD * 4
                                ? STAGES * (size_t)(MM * MK + MK * MN)
                                : (THREADS / 32) * 32 * WLD * 4;

// The int8 products on the tensor cores (wmma 16x16x16 int8 x int8 ->
// int32, the rounding points of the JAX kernel): 64x128 output tiles, warp w
// owns the 32x32 piece at rows 32 (w / 4), columns 32 (w % 4) (2x2
// accumulator fragments).  The A and B tiles of depth 64 are staged in
// shared memory with cp.async, STAGES deep so that the next tile loads while
// the tensor cores work on this one, in chunks of 16 columns,
// [chunk][row][16], so that every fragment starts 32-byte aligned.
// A warp's sums go through its own scratch (over the stage buffers) to the
// epilogue, one row at a time across the lanes (coalesced stores).  Columns
// past N (N % 128 == 64) and rows past `rows` are zero-filled, and a warp
// whose whole piece lies past them skips its products.
template <class Epi>
__device__ void gemm_mma(const int8_t* __restrict__ A, long lda, int rows,
                         const int8_t* __restrict__ B, long ldb, int K, int N, char* smem, Epi epi) {
  typedef int8_t TE;
  typedef int Acc;
  constexpr int VEC = 16;  // elements per 16-byte copy
  constexpr int A_EL = MM * MK, B_EL = MK * MN;
  TE* As = reinterpret_cast<TE*>(smem);  // [STAGES][MK / 16][MM][16]
  TE* Bs = As + STAGES * A_EL;           // [STAGES][MN / 16][MK][16]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Acc* Cw = reinterpret_cast<Acc*>(smem) + warp * 32 * WLD;  // [32][WLD]
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;
  const int nk = K / MK;
  for (int m0 = 0; m0 < rows; m0 += MM) {
    for (int n0 = 0; n0 < N; n0 += MN) {
      auto load = [&](int st, int k0) {
        TE* as = As + st * A_EL;
        TE* bs = Bs + st * B_EL;
        for (int i = threadIdx.x; i < A_EL / VEC; i += THREADS) {
          const int r = i / (MK / VEC), k = (i % (MK / VEC)) * VEC;
          const bool ok = m0 + r < rows;
          cp_async16(as + (k / 16) * MM * 16 + r * 16 + k % 16,
                     ok ? A + (long)(m0 + r) * lda + k0 + k : A, ok);
        }
        for (int i = threadIdx.x; i < B_EL / VEC; i += THREADS) {
          const int r = i / (MN / VEC), n = (i % (MN / VEC)) * VEC;
          const bool ok = n0 + n < N;
          cp_async16(bs + (n / 16) * MK * 16 + r * 16 + n % 16,
                     ok ? B + (long)(k0 + r) * ldb + n0 + n : B, ok);
        }
        cp_async_commit();
      };
      // the warp's 32 columns exist and its rows hold one at least (the last
      // row tile of an image of 200 rows has 8)
      const bool active = n0 + wc < N && m0 + wr < rows;
      wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> c[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], Acc(0));
      // one commit group per stage, empty past the last, so that
      // wait<STAGES - 2> at step ks always means "stage ks has landed"
      for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nk)
          load(st, st * MK);
        else
          cp_async_commit();
      }
      for (int ks = 0; ks < nk; ++ks) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage ks landed for every thread; step ks - 1 done
        const int next = ks + STAGES - 1;  // into the slot step ks - 1 used
        if (next < nk)
          load(next % STAGES, next * MK);
        else
          cp_async_commit();
        if (active) {
          const TE* as = As + (ks % STAGES) * A_EL;
          const TE* bs = Bs + (ks % STAGES) * B_EL;
#pragma unroll
          for (int kk = 0; kk < MK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, TE, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, TE, wmma::row_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::load_matrix_sync(a[i], as + (kk / 16) * MM * 16 + (wr + 16 * i) * 16, 16);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::load_matrix_sync(b[j], bs + ((wc + 16 * j) / 16) * MK * 16 + kk * 16, 16);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every stage consumed: the scratch may reuse them
      if (active) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cw + 16 * i * WLD + 16 * j, c[i][j], WLD, wmma::mem_row_major);
        __syncwarp();
        for (int i = 0; i < 32; ++i) {
          const int r = m0 + wr + i;
          if (r < rows) epi(r, n0 + wc + lane, Cw[i * WLD + lane]);
        }
      }
      __syncthreads();  // the scratch read before the next tile's loads
    }
  }
}

// C = A B over `rows` rows: A (rows, K) row-major with row stride lda, B (K, N)
// row-major with row stride ldb; K and N multiples of 64, and for int8 the
// strides multiples of 16 bytes.  For each output (r, c) with r < rows calls
// epi(r, c, acc): acc is f32, or int32 for int8 operands.
template <typename T, class Epi>
__device__ void gemm(const T* __restrict__ A, long lda, int rows, const T* __restrict__ B,
                     long ldb, int K, int N, float* smem, Epi epi) {
  if constexpr (std::is_same<T, float>::value)
    gemm_fma(A, lda, rows, B, ldb, K, N, smem, epi);
  else
    gemm_mma(A, lda, rows, B, ldb, K, N, reinterpret_cast<char*>(smem), epi);
  __syncthreads();  // outputs visible to the block, shared memory free
}

// LayerNorm of rows [0, rows) of x (row stride E), one warp a row, as
// `_layer_norm_rows`: mean, then the mean of the squared deviations, then
// ((x - mean) * rsqrt(var + eps)) * gamma + beta, written as TO.
template <typename TI, typename TO>
__device__ void layer_norm_rows(const TI* __restrict__ x, int rows, int E,
                                const float* __restrict__ g, const float* __restrict__ b,
                                float eps, TO* __restrict__ out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const TI* xr = x + (long)r * E;
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += to_f(xr[c]);
    const float mu = warp_sum(s) / (float)E;
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = to_f(xr[c]) - mu;
      v += d * d;
    }
    const float rs = 1.f / sqrtf(warp_sum(v) / (float)E + eps);
    for (int c = lane; c < E; c += 32)
      out[(long)r * E + c] =
          from_f<TO>(__fadd_rn(__fmul_rn(__fmul_rn(to_f(xr[c]) - mu, rs), g[c]), b[c]));
  }
  __syncthreads();
}

// `_quant_rows`: per-row symmetric int8 of rows [0, rows) of v (width W):
// amax clamped at 1e-6, q = clip(rint(v * (127 / amax)), -127, 127), and the
// dequantisation scale amax * (1 / 127).
template <typename TI>
__device__ void quant_rows(const TI* __restrict__ v, int rows, int W, int8_t* __restrict__ q,
                           float* __restrict__ scale) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const TI* vr = v + (long)r * W;
    float m = 0.f;
    for (int c = lane; c < W; c += 32) m = fmaxf(m, fabsf(to_f(vr[c])));
    const float amax = fmaxf(warp_max(m), 1e-6f);
    const float inv = 127.f / amax;
    for (int c = lane; c < W; c += 32) {
      const float t = fminf(fmaxf(rintf(to_f(vr[c]) * inv), -127.f), 127.f);
      q[(long)r * W + c] = (int8_t)t;
    }
    if (lane == 0) scale[r] = amax * (1.f / 127.f);
  }
  __syncthreads();
}

// softmax(q k^T) v for each head of one image: qkv (Tp, 3 HD) holds q (pre-
// scaled by 1/sqrt(Dh)), k and v, head h at columns h Dh of each third; the
// output o (Tp, HD) is rounded to T.
template <typename T>
__device__ void attention(const T* __restrict__ qkv, int HD, int H, int Tp, int t_real,
                          T* __restrict__ o, float* smem) {
  const long ld = 3L * HD;
  float* Kt = smem;             // [DH][Tp]   K^T of the head
  float* Vs = Kt + DH * Tp;     // [Tp][DH]
  float* Ss = Vs + Tp * DH;     // [QT][Tp]   scores, then p rounded to T
  float* Qt = Ss + QT * Tp;     // [DH][QT]   query tile, transposed
  float* Ls = Qt + DH * QT;     // [QT]       row sums l of the unrounded p
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head consumed
    for (int i = threadIdx.x; i < Tp * DH; i += THREADS) {
      const int s = i / DH, d = i % DH;
      const T* row = qkv + (long)s * ld + h * DH + d;
      Kt[d * Tp + s] = to_f(row[HD]);
      Vs[s * DH + d] = to_f(row[2 * HD]);
    }
    for (int q0 = 0; q0 < Tp; q0 += QT) {
      __syncthreads();  // K and V written; the previous tile consumed
      for (int i = threadIdx.x; i < QT * DH; i += THREADS) {
        const int q = i / DH, d = i % DH;
        Qt[d * QT + q] = q0 + q < Tp ? to_f(qkv[(long)(q0 + q) * ld + h * DH + d]) : 0.f;
      }
      __syncthreads();
      // scores: rows 2ty, 2ty + 1 of the tile, keys 4tx + 64 j .. + 3
      for (int s0 = 4 * tx; s0 < Tp; s0 += 64) {
        float a[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float2 qv = *reinterpret_cast<const float2*>(Qt + d * QT + 2 * ty);
          const float4 kv = *reinterpret_cast<const float4*>(Kt + d * Tp + s0);
          a[0][0] = fmaf(qv.x, kv.x, a[0][0]); a[0][1] = fmaf(qv.x, kv.y, a[0][1]);
          a[0][2] = fmaf(qv.x, kv.z, a[0][2]); a[0][3] = fmaf(qv.x, kv.w, a[0][3]);
          a[1][0] = fmaf(qv.y, kv.x, a[1][0]); a[1][1] = fmaf(qv.y, kv.y, a[1][1]);
          a[1][2] = fmaf(qv.y, kv.z, a[1][2]); a[1][3] = fmaf(qv.y, kv.w, a[1][3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ss[(2 * ty + r) * Tp + s0 + j] = s0 + j < t_real ? a[r][j] : NEG_INF;
      }
      __syncthreads();
      // whole-row softmax, one warp a row: m, p = exp(s - m), l = sum p
      for (int r = warp; r < QT; r += THREADS / 32) {
        float* sr = Ss + r * Tp;
        float m = NEG_INF;
        for (int s = lane; s < Tp; s += 32) m = fmaxf(m, sr[s]);
        m = warp_max(m);
        float l = 0.f;
        for (int s = lane; s < Tp; s += 32) {
          const float p = expf(sr[s] - m);
          l += p;
          sr[s] = round_t<T>(p);
        }
        l = warp_sum(l);
        if (lane == 0) Ls[r] = l;
      }
      __syncthreads();
      // o = (p v) / l: rows 2ty, 2ty + 1, columns 4tx .. 4tx + 3
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const float* p0 = Ss + (2 * ty) * Tp;
      const float* p1 = p0 + Tp;
#pragma unroll 4
      for (int s = 0; s < Tp; ++s) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + s * DH + 4 * tx);
        const float a0 = p0[s], a1 = p1[s];
        acc[0][0] = fmaf(a0, vv.x, acc[0][0]); acc[0][1] = fmaf(a0, vv.y, acc[0][1]);
        acc[0][2] = fmaf(a0, vv.z, acc[0][2]); acc[0][3] = fmaf(a0, vv.w, acc[0][3]);
        acc[1][0] = fmaf(a1, vv.x, acc[1][0]); acc[1][1] = fmaf(a1, vv.y, acc[1][1]);
        acc[1][2] = fmaf(a1, vv.z, acc[1][2]); acc[1][3] = fmaf(a1, vv.w, acc[1][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 2 * ty + r;
        if (q < Tp) {
          const float l = Ls[2 * ty + r];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[(long)q * HD + h * DH + 4 * tx + j] = from_f<T>(acc[r][j] / l);
        }
      }
    }
  }
  __syncthreads();
}

constexpr int LKV = DH + 8;  // row length of the bf16 K, V and Q tiles

// softmax(q k^T) v of each head of one image on the tensor cores, bf16: K and
// V of the head in shared memory (bf16, rows padded with zeros to T16, a
// multiple of 16), a query tile of QT rows; S = Q K^T (f32) by 16x16
// fragments spread over the warps, the whole-row softmax in f32 with p
// rounded to bf16 into P, O = P V (f32) by one fragment a warp, divided by l
// and rounded to bf16.
__device__ void attention_mma(const bf16* __restrict__ qkv, int HD, int H, int Tp, int t_real,
                              bf16* __restrict__ o, char* smem) {
  const long ld = 3L * HD;
  const int T16 = (Tp + 15) / 16 * 16, LP = T16 + 8;
  const int LS = (T16 > DH ? T16 : DH) + 4;  // Ss holds the scores, then p v
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [T16][LKV]
  bf16* Vs = Ks + T16 * LKV;                 // [T16][LKV]
  bf16* Qs = Vs + T16 * LKV;                 // [QT][LKV]
  bf16* Ps = Qs + QT * LKV;                  // [QT][LP]   p rounded to bf16
  float* Ss = reinterpret_cast<float*>(Ps + QT * LP);  // [QT][LS]
  float* Ls = Ss + QT * LS;                  // [QT]       row sums l
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nt = T16 / 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head consumed
    for (int i = threadIdx.x; i < T16 * (DH / 8); i += THREADS) {
      const int s = i / (DH / 8), d = (i % (DH / 8)) * 8;
      const bf16* row = qkv + (long)s * ld + h * DH + d;
      *reinterpret_cast<uint4*>(Ks + s * LKV + d) =
          s < Tp ? *reinterpret_cast<const uint4*>(row + HD) : zero;
      *reinterpret_cast<uint4*>(Vs + s * LKV + d) =
          s < Tp ? *reinterpret_cast<const uint4*>(row + 2 * HD) : zero;
    }
    for (int q0 = 0; q0 < Tp; q0 += QT) {
      __syncthreads();  // K and V written; the previous tile consumed
      for (int i = threadIdx.x; i < QT * (DH / 8); i += THREADS) {
        const int q = i / (DH / 8), d = (i % (DH / 8)) * 8;
        *reinterpret_cast<uint4*>(Qs + q * LKV + d) =
            q0 + q < Tp
                ? *reinterpret_cast<const uint4*>(qkv + (long)(q0 + q) * ld + h * DH + d)
                : zero;
      }
      __syncthreads();
      for (int f = warp; f < (QT / 16) * nt; f += THREADS / 32) {
        const int i = f % (QT / 16), j = f / (QT / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
#pragma unroll
        for (int kk = 0; kk < DH; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, Qs + 16 * i * LKV + kk, LKV);
          wmma::load_matrix_sync(b, Ks + 16 * j * LKV + kk, LKV);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(Ss + 16 * i * LS + 16 * j, c, LS, wmma::mem_row_major);
      }
      __syncthreads();
      for (int r = warp; r < QT; r += THREADS / 32) {
        const float* sr = Ss + r * LS;
        bf16* pr = Ps + r * LP;
        float m = NEG_INF;
        for (int s = lane; s < Tp; s += 32) m = fmaxf(m, s < t_real ? sr[s] : NEG_INF);
        m = warp_max(m);
        float l = 0.f;
        for (int s = lane; s < T16; s += 32) {
          const float p = s < Tp ? expf((s < t_real ? sr[s] : NEG_INF) - m) : 0.f;
          l += p;
          pr[s] = __float2bfloat16_rn(p);
        }
        l = warp_sum(l);
        if (lane == 0) Ls[r] = l;
      }
      __syncthreads();
      {  // O = P V: warp w owns rows 16 (w / 4), columns 16 (w % 4)
        const int i = warp / (DH / 16), j = warp % (DH / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::fill_fragment(c, 0.f);
        for (int k0 = 0; k0 < T16; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, Ps + 16 * i * LP + k0, LP);
          wmma::load_matrix_sync(b, Vs + k0 * LKV + 16 * j, LKV);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(Ss + 16 * i * LS + 16 * j, c, LS, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < QT * DH; i += THREADS) {
        const int q = i / DH, d = i % DH;
        if (q0 + q < Tp)
          o[(long)(q0 + q) * HD + h * DH + d] = __float2bfloat16_rn(Ss[q * LS + d] / Ls[q]);
      }
    }
  }
  __syncthreads();
}

// shared memory of the attention phase at t_pad Tp: f32 (FMA) or bf16 (mma)
size_t attention_smem_bytes(int Tp, bool bf16_mma) {
  if (!bf16_mma)
    return sizeof(float) * ((size_t)2 * DH * Tp + (size_t)QT * Tp + DH * QT + QT);
  const size_t T16 = (Tp + 15) / 16 * 16, LS = (T16 > DH ? T16 : DH) + 4;
  return 2 * (2 * T16 * LKV + QT * LKV + QT * (T16 + 8)) + 4 * (QT * LS + QT);
}

constexpr size_t FMA_SMEM = sizeof(float) * (TK * APAD + TK * TN);

__host__ __device__ inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// ((acc * sx) * sw) + b, each step rounded (no fused multiply-add), as `_qdot`
__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sx), sw), b);
}

// Byte offsets of the regions of one workspace slot (fused_layer.py mirrors
// this in `workspace_bytes`).
struct Layout {
  size_t xn, qkv, o, z, hid, f, aq, sa, total;
};

__host__ __device__ inline Layout layout(int seg, int E, int HD, int hidden, int ts, bool q8) {
  const size_t s = (size_t)seg;
  Layout L;
  L.xn = 0;                                    // xn, then zn, in T
  L.qkv = L.xn + align256(s * E * ts);         // q | k | v, in T
  L.o = L.qkv + align256(s * 3 * HD * ts);     // attention output, in T
  L.z = L.o + align256(s * HD * ts);           // z, f32
  L.hid = L.z + align256(s * E * 4);           // MLP hidden, in T
  L.f = L.hid + align256(s * hidden * ts);     // int8 modes: LN or hidden in f32
  const int wmax = imax(imax(E, HD), hidden);
  L.aq = L.f + (q8 ? align256(s * imax(E, hidden) * 4) : 0);  // quantised rows
  L.sa = L.aq + (q8 ? align256(s * wmax) : 0);               // their scales
  L.total = L.sa + (q8 ? align256(s * 4) : 0);
  return L;
}

struct Args {
  const void* x;
  void* y;
  char* ws;
  const float *g1, *be1;
  const void* wqkv;
  const float *sqkv, *bqkv;
  const void* wo;
  const float *so, *bo;
  const float *g2, *be2;
  const void* w1;
  const float *s1, *b1;
  const void* w2;
  const float *s2, *b2;
  long n_rows;
  int seg, t_real, E, H, hidden;
  float eps;
};

// At most 128 registers a thread, so that two blocks share an SM.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, 2) fused_layer(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool ATTN = MODE & MODE_ATTN, MLP = MODE & MODE_MLP, Q8 = MODE & MODE_Q8;
  typedef typename std::conditional<Q8, int8_t, T>::type W;  // weight type
  const int E = a.E, HD = a.H * DH, HID = a.hidden;
  const Layout L = layout(a.seg, E, HD, HID, (int)sizeof(T), Q8);
  char* ws = a.ws + (size_t)blockIdx.x * L.total;
  T* xn = reinterpret_cast<T*>(ws + L.xn);
  T* qkv = reinterpret_cast<T*>(ws + L.qkv);
  T* o = reinterpret_cast<T*>(ws + L.o);
  float* z = reinterpret_cast<float*>(ws + L.z);
  T* hid = reinterpret_cast<T*>(ws + L.hid);
  float* f = reinterpret_cast<float*>(ws + L.f);
  int8_t* aq = reinterpret_cast<int8_t*>(ws + L.aq);
  float* sa = reinterpret_cast<float*>(ws + L.sa);
  const W* wqkv = static_cast<const W*>(a.wqkv);
  const W* wo = static_cast<const W*>(a.wo);
  const W* w1 = static_cast<const W*>(a.w1);
  const W* w2 = static_cast<const W*>(a.w2);

  const long nseg = (a.n_rows + a.seg - 1) / a.seg;
  for (long sg = blockIdx.x; sg < nseg; sg += gridDim.x) {
    const long base = sg * a.seg;
    const int rows = (int)(a.n_rows - base < a.seg ? a.n_rows - base : a.seg);
    const T* x = static_cast<const T*>(a.x) + base * E;
    T* y = static_cast<T*>(a.y) + base * E;

    if constexpr (ATTN) {
      if constexpr (Q8) {
        layer_norm_rows(x, rows, E, a.g1, a.be1, a.eps, f);
        quant_rows(f, rows, E, aq, sa);
        gemm(aq, E, rows, wqkv, 3 * HD, E, 3 * HD, smem, [&](int r, int c, int acc) {
          qkv[(long)r * 3 * HD + c] = from_f<T>(dequant(acc, sa[r], a.sqkv[c], a.bqkv[c]));
        });
      } else {
        layer_norm_rows(x, rows, E, a.g1, a.be1, a.eps, xn);
        gemm(xn, E, rows, wqkv, 3 * HD, E, 3 * HD, smem, [&](int r, int c, float acc) {
          qkv[(long)r * 3 * HD + c] = from_f<T>(acc + a.bqkv[c]);
        });
      }
      if constexpr (std::is_same<T, bf16>::value)
        attention_mma(qkv, HD, a.H, rows, a.t_real, o, reinterpret_cast<char*>(smem));
      else
        attention(qkv, HD, a.H, rows, a.t_real, o, smem);
      if constexpr (Q8) {
        quant_rows(o, rows, HD, aq, sa);
        gemm(aq, HD, rows, wo, E, HD, E, smem, [&](int r, int c, int acc) {
          const long i = (long)r * E + c;
          z[i] = to_f(x[i]) + dequant(acc, sa[r], a.so[c], a.bo[c]);
        });
      } else {
        gemm(o, HD, rows, wo, E, HD, E, smem, [&](int r, int c, float acc) {
          const long i = (long)r * E + c;
          const float v = to_f(x[i]) + a.bo[c] + acc;
          if constexpr (MLP)
            z[i] = v;
          else
            y[i] = from_f<T>(v);
        });
      }
    }

    if constexpr (MLP) {
      // the residual: z (f32) after the attention sublayer, else x
      auto res = [&](long i) { return ATTN ? z[i] : to_f(x[i]); };
      if constexpr (Q8) {
        layer_norm_rows(z, rows, E, a.g2, a.be2, a.eps, f);
        quant_rows(f, rows, E, aq, sa);
        gemm(aq, E, rows, w1, HID, E, HID, smem, [&](int r, int c, int acc) {
          f[(long)r * HID + c] = gelu_as(dequant(acc, sa[r], a.s1[c], a.b1[c]));
        });
        quant_rows(f, rows, HID, aq, sa);
        gemm(aq, HID, rows, w2, E, HID, E, smem, [&](int r, int c, int acc) {
          const long i = (long)r * E + c;
          y[i] = from_f<T>(res(i) + dequant(acc, sa[r], a.s2[c], a.b2[c]));
        });
      } else {
        if constexpr (ATTN)
          layer_norm_rows(z, rows, E, a.g2, a.be2, a.eps, xn);
        else
          layer_norm_rows(x, rows, E, a.g2, a.be2, a.eps, xn);
        gemm(xn, E, rows, w1, HID, E, HID, smem, [&](int r, int c, float acc) {
          hid[(long)r * HID + c] = from_f<T>(gelu_as(acc + a.b1[c]));
        });
        gemm(hid, HID, rows, w2, E, HID, E, smem, [&](int r, int c, float acc) {
          const long i = (long)r * E + c;
          y[i] = from_f<T>(res(i) + (acc + a.b2[c]));
        });
      }
    }
  }
}

template <typename T, int MODE>
int launch(const Args& a, int slots, size_t ws_bytes, cudaStream_t stream) {
  const int HD = a.H * DH;
  const Layout L = layout(a.seg, a.E, HD, a.hidden, (int)sizeof(T), MODE & MODE_Q8);
  if (L.total != ws_bytes) return (int)cudaErrorInvalidValue;
  constexpr bool BF = std::is_same<T, bf16>::value;
  size_t smem = (MODE & MODE_Q8) ? MMA_SMEM : FMA_SMEM;
  if (MODE & MODE_ATTN) {
    const size_t att = attention_smem_bytes(a.seg, BF);
    if (att > smem) smem = att;
  }
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_layer<T, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layer<T, MODE>, THREADS,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long nseg = (a.n_rows + a.seg - 1) / a.seg;
  long grid = (long)per_sm * sms;
  if (grid > slots) grid = slots;
  if (grid > nseg) grid = nseg;
  fused_layer<T, MODE><<<(unsigned)grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// f32: every mode; bf16: the int8 layer only (vit_layer_sm90.cu has the rest)
int launch_f32(int mode, const Args& a, int slots, size_t ws_bytes, cudaStream_t stream) {
  switch (mode) {
    case MODE_ATTN: return launch<float, MODE_ATTN>(a, slots, ws_bytes, stream);
    case MODE_MLP: return launch<float, MODE_MLP>(a, slots, ws_bytes, stream);
    case MODE_ATTN | MODE_MLP:
      return launch<float, MODE_ATTN | MODE_MLP>(a, slots, ws_bytes, stream);
    case MODE_ATTN | MODE_MLP | MODE_Q8:
      return launch<float, MODE_ATTN | MODE_MLP | MODE_Q8>(a, slots, ws_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the fused layer in `mode` (1 ATTN, 2 MLP, 3 ATTN|MLP, 7 with
// int8) on `n_rows` rows of x, in segments of `seg` rows (an image of t_pad
// rows for the attention modes), dtype 0 f32 or 1 bf16 (mode 7 only).
// Weights: wqkv (E, 3 HD) = [Wq / sqrt(Dh) | Wk | Wv], wo (HD, E), w1 (E,
// hidden), w2 (hidden, E) in x's type, or int8 with per-column scales s* in
// mode 7; biases and LN parameters f32.  ws holds `slots` slots of `ws_bytes` each.  Returns a
// cudaError_t as int: 0 when the launch was accepted.
extern "C" int launch_fused_layer(int mode, int dtype, const void* x, void* y, void* ws,
                                  int slots, long long ws_bytes, const float* g1,
                                  const float* be1, const void* wqkv, const float* sqkv,
                                  const float* bqkv, const void* wo, const float* so,
                                  const float* bo, const float* g2, const float* be2,
                                  const void* w1, const float* s1, const float* b1,
                                  const void* w2, const float* s2, const float* b2,
                                  long long n_rows, int seg, int t_real, int E, int H,
                                  int hidden, float eps, cudaStream_t stream) {
  if (n_rows <= 0 || seg <= 0 || slots <= 0 || E % 64 || (H * DH) % 64 || hidden % 64 ||
      ((mode & MODE_ATTN) && (seg % 8 || t_real <= 0 || t_real > seg || n_rows % seg)))
    return (int)cudaErrorInvalidValue;
  Args a{x, y, static_cast<char*>(ws), g1, be1, wqkv, sqkv, bqkv, wo, so, bo, g2, be2,
         w1, s1, b1, w2, s2, b2, (long)n_rows, seg, t_real, E, H, hidden, eps};
  if (dtype == 0) return launch_f32(mode, a, slots, (size_t)ws_bytes, stream);
  if (dtype == 1 && mode == (MODE_ATTN | MODE_MLP | MODE_Q8))
    return launch<bf16, MODE_ATTN | MODE_MLP | MODE_Q8>(a, slots, (size_t)ws_bytes, stream);
  return (int)cudaErrorInvalidValue;
}
