// Fused ViT-layer inference on folded (B * t_pad, E) token rows in float32,
// the int8 layer too:
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
// :430 (`vit_layer_infer_int8` :509).  All four in bfloat16 are
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
// staged with cp.async in two stages).
// The per-image intermediates (xn, q/k/v, the attention output, z in f32,
// zn, the MLP hidden) go through a workspace in device memory, one slot per
// resident block, which the wrapper allocates; a block walks the images
// blockIdx.x, blockIdx.x + gridDim.x, ...
//
// Every value is f32 and every product is true f32 (int32 sums for int8),
// so the JAX kernels' rounding points to x's type are no-ops here.  GELU is
// the Abramowitz-Stegun form of `_gelu_exact` (kernels/fused_mlp.py:33-49).
// Int8: weights come quantised per column from the wrapper; rows are
// quantised here per row (amax clamped at 1e-6, q = rint(v * (127 / amax))
// clipped to +-127), and the epilogue is ((acc * sx) * sw) + b.  Keys at or
// past t_real are masked to -1e30; padded query rows carry junk, as on the
// TPU.  Every offset that multiplies a row index is 64-bit.
//
// Limits (fused_layer.py states them for the router): Dh 64; E, H * Dh and
// the hidden width multiples of 64; t_pad a multiple of 8 whose attention
// phase fits 227 KB (t_pad <= 344).

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

using namespace nvcuda;

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
__device__ void layer_norm_rows(const float* __restrict__ x, int rows, int E,
                                const float* __restrict__ g, const float* __restrict__ b,
                                float eps, float* __restrict__ out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const float* xr = x + (long)r * E;
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += xr[c];
    const float mu = warp_sum(s) / (float)E;
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rs = 1.f / sqrtf(warp_sum(v) / (float)E + eps);
    for (int c = lane; c < E; c += 32)
      out[(long)r * E + c] =
          __fadd_rn(__fmul_rn(__fmul_rn(xr[c] - mu, rs), g[c]), b[c]);
  }
  __syncthreads();
}

// `_quant_rows`: per-row symmetric int8 of rows [0, rows) of v (width W):
// amax clamped at 1e-6, q = clip(rint(v * (127 / amax)), -127, 127), and the
// dequantisation scale amax * (1 / 127).
__device__ void quant_rows(const float* __restrict__ v, int rows, int W, int8_t* __restrict__ q,
                           float* __restrict__ scale) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const float* vr = v + (long)r * W;
    float m = 0.f;
    for (int c = lane; c < W; c += 32) m = fmaxf(m, fabsf(vr[c]));
    const float amax = fmaxf(warp_max(m), 1e-6f);
    const float inv = 127.f / amax;
    for (int c = lane; c < W; c += 32) {
      const float t = fminf(fmaxf(rintf(vr[c] * inv), -127.f), 127.f);
      q[(long)r * W + c] = (int8_t)t;
    }
    if (lane == 0) scale[r] = amax * (1.f / 127.f);
  }
  __syncthreads();
}

// softmax(q k^T) v for each head of one image: qkv (Tp, 3 HD) holds q (pre-
// scaled by 1/sqrt(Dh)), k and v, head h at columns h Dh of each third; the
// output o is (Tp, HD).
__device__ void attention(const float* __restrict__ qkv, int HD, int H, int Tp, int t_real,
                          float* __restrict__ o, float* smem) {
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
      const float* row = qkv + (long)s * ld + h * DH + d;
      Kt[d * Tp + s] = row[HD];
      Vs[s * DH + d] = row[2 * HD];
    }
    for (int q0 = 0; q0 < Tp; q0 += QT) {
      __syncthreads();  // K and V written; the previous tile consumed
      for (int i = threadIdx.x; i < QT * DH; i += THREADS) {
        const int q = i / DH, d = i % DH;
        Qt[d * QT + q] = q0 + q < Tp ? qkv[(long)(q0 + q) * ld + h * DH + d] : 0.f;
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
          sr[s] = p;
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
            o[(long)q * HD + h * DH + 4 * tx + j] = acc[r][j] / l;
        }
      }
    }
  }
  __syncthreads();
}

// shared memory of the attention phase at t_pad Tp
size_t attention_smem_bytes(int Tp) {
  return sizeof(float) * ((size_t)2 * DH * Tp + (size_t)QT * Tp + DH * QT + QT);
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

__host__ __device__ inline Layout layout(int seg, int E, int HD, int hidden, bool q8) {
  const size_t s = (size_t)seg;
  Layout L;
  L.xn = 0;                                    // xn, then zn
  L.qkv = L.xn + align256(s * E * 4);          // q | k | v
  L.o = L.qkv + align256(s * 3 * HD * 4);      // attention output
  L.z = L.o + align256(s * HD * 4);            // z
  L.hid = L.z + align256(s * E * 4);           // MLP hidden
  L.f = L.hid + align256(s * hidden * 4);      // int8 mode: LN or hidden
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
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) fused_layer(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool ATTN = MODE & MODE_ATTN, MLP = MODE & MODE_MLP, Q8 = MODE & MODE_Q8;
  typedef typename std::conditional<Q8, int8_t, float>::type W;  // weight type
  const int E = a.E, HD = a.H * DH, HID = a.hidden;
  const Layout L = layout(a.seg, E, HD, HID, Q8);
  char* ws = a.ws + (size_t)blockIdx.x * L.total;
  float* xn = reinterpret_cast<float*>(ws + L.xn);
  float* qkv = reinterpret_cast<float*>(ws + L.qkv);
  float* o = reinterpret_cast<float*>(ws + L.o);
  float* z = reinterpret_cast<float*>(ws + L.z);
  float* hid = reinterpret_cast<float*>(ws + L.hid);
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
    const float* x = static_cast<const float*>(a.x) + base * E;
    float* y = static_cast<float*>(a.y) + base * E;

    if constexpr (ATTN) {
      if constexpr (Q8) {
        layer_norm_rows(x, rows, E, a.g1, a.be1, a.eps, f);
        quant_rows(f, rows, E, aq, sa);
        gemm(aq, E, rows, wqkv, 3 * HD, E, 3 * HD, smem, [&](int r, int c, int acc) {
          qkv[(long)r * 3 * HD + c] = (dequant(acc, sa[r], a.sqkv[c], a.bqkv[c]));
        });
      } else {
        layer_norm_rows(x, rows, E, a.g1, a.be1, a.eps, xn);
        gemm(xn, E, rows, wqkv, 3 * HD, E, 3 * HD, smem, [&](int r, int c, float acc) {
          qkv[(long)r * 3 * HD + c] = (acc + a.bqkv[c]);
        });
      }
      attention(qkv, HD, a.H, rows, a.t_real, o, smem);
      if constexpr (Q8) {
        quant_rows(o, rows, HD, aq, sa);
        gemm(aq, HD, rows, wo, E, HD, E, smem, [&](int r, int c, int acc) {
          const long i = (long)r * E + c;
          z[i] = x[i] + dequant(acc, sa[r], a.so[c], a.bo[c]);
        });
      } else {
        gemm(o, HD, rows, wo, E, HD, E, smem, [&](int r, int c, float acc) {
          const long i = (long)r * E + c;
          const float v = x[i] + a.bo[c] + acc;
          if constexpr (MLP)
            z[i] = v;
          else
            y[i] = (v);
        });
      }
    }

    if constexpr (MLP) {
      // the residual: z (f32) after the attention sublayer, else x
      auto res = [&](long i) { return ATTN ? z[i] : x[i]; };
      if constexpr (Q8) {
        layer_norm_rows(z, rows, E, a.g2, a.be2, a.eps, f);
        quant_rows(f, rows, E, aq, sa);
        gemm(aq, E, rows, w1, HID, E, HID, smem, [&](int r, int c, int acc) {
          f[(long)r * HID + c] = gelu_as(dequant(acc, sa[r], a.s1[c], a.b1[c]));
        });
        quant_rows(f, rows, HID, aq, sa);
        gemm(aq, HID, rows, w2, E, HID, E, smem, [&](int r, int c, int acc) {
          const long i = (long)r * E + c;
          y[i] = (res(i) + dequant(acc, sa[r], a.s2[c], a.b2[c]));
        });
      } else {
        if constexpr (ATTN)
          layer_norm_rows(z, rows, E, a.g2, a.be2, a.eps, xn);
        else
          layer_norm_rows(x, rows, E, a.g2, a.be2, a.eps, xn);
        gemm(xn, E, rows, w1, HID, E, HID, smem, [&](int r, int c, float acc) {
          hid[(long)r * HID + c] = (gelu_as(acc + a.b1[c]));
        });
        gemm(hid, HID, rows, w2, E, HID, E, smem, [&](int r, int c, float acc) {
          const long i = (long)r * E + c;
          y[i] = (res(i) + (acc + a.b2[c]));
        });
      }
    }
  }
}

template <int MODE>
int launch(const Args& a, int slots, size_t ws_bytes, cudaStream_t stream) {
  const int HD = a.H * DH;
  const Layout L = layout(a.seg, a.E, HD, a.hidden, MODE & MODE_Q8);
  if (L.total != ws_bytes) return (int)cudaErrorInvalidValue;
  size_t smem = (MODE & MODE_Q8) ? MMA_SMEM : FMA_SMEM;
  if (MODE & MODE_ATTN) {
    const size_t att = attention_smem_bytes(a.seg);
    if (att > smem) smem = att;
  }
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_layer<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layer<MODE>, THREADS,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long nseg = (a.n_rows + a.seg - 1) / a.seg;
  long grid = (long)per_sm * sms;
  if (grid > slots) grid = slots;
  if (grid > nseg) grid = nseg;
  fused_layer<MODE><<<(unsigned)grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_mode(int mode, const Args& a, int slots, size_t ws_bytes, cudaStream_t stream) {
  switch (mode) {
    case MODE_ATTN: return launch<MODE_ATTN>(a, slots, ws_bytes, stream);
    case MODE_MLP: return launch<MODE_MLP>(a, slots, ws_bytes, stream);
    case MODE_ATTN | MODE_MLP:
      return launch<MODE_ATTN | MODE_MLP>(a, slots, ws_bytes, stream);
    case MODE_ATTN | MODE_MLP | MODE_Q8:
      return launch<MODE_ATTN | MODE_MLP | MODE_Q8>(a, slots, ws_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the f32 fused layer in `mode` (1 ATTN, 2 MLP, 3 ATTN|MLP, 7
// with int8) on `n_rows` rows of x, in segments of `seg` rows (an image of
// t_pad rows for the attention modes).  Weights: wqkv (E, 3 HD) = [Wq /
// sqrt(Dh) | Wk | Wv], wo (HD, E), w1 (E, hidden), w2 (hidden, E) in f32, or
// int8 with per-column scales s* in mode 7; biases and LN parameters f32.
// ws holds `slots` slots of `ws_bytes` each.  Returns a cudaError_t as int: 0
// when the launch was accepted.
extern "C" int launch_fused_layer(int mode, const void* x, void* y, void* ws,
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
  return launch_mode(mode, a, slots, (size_t)ws_bytes, stream);
}
