// Fused ViT-layer inference on folded (B * t_pad, E) token rows in float32,
// the int8 layer on float32 x too:
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
// the card's balance point: at B 192 (n = 38,400 rows) 147.7 GFLOP, 2.20 ms
// in f32 FMA (67 TFLOP/s) and 0.90 ms as three TF32 products (495 TFLOP/s).
// The TPU kernels hold a block of images in VMEM: q, k, v and the attention
// output of every head plus the scores, 614 KB an image at ViT-S in bf16,
// where a block here has 227 KB of shared memory.
//
// Modes 1-3 (namespace f32layer): the layer as products over row chunks on
// the tensor cores in 3xTF32 (csrc/tf32x3.cuh).  The rows go in chunks of R
// (whole images in the attention modes; kernels/fused_layer.py,
// layer_chunk_rows), and each chunk runs, one launch after another on the
// caller's stream:
//
// - LN1 (ln_rows, a warp a row) into xn;
// - q|k|v = xn Wqkv + bqkv on chunk_gemm (csrc/chunk_gemm.cuh, the training
//   MLP's GEMM kernel: 128 x 192 tiles, A as stored, W^T split by the
//   wrapper once per model), q pre-scaled by 1/sqrt(Dh) in the packing;
// - attention per (image, head) on the 3xTF32 flash forward
//   (csrc/flash_attention.cu, launch_flash_attention_ld), T = t_pad queries
//   over S = t_real keys, read from the packed q|k|v rows (row stride 3 HD):
//   keys past t_real get p = 0 and the padded query rows carry junk, as on
//   the TPU;
// - the out projection, its bias and the residual x in chunk_gemm's
//   epilogue, into y (mode ATTN) or into the chunk's z (ATTN|MLP);
// - LN2 of z (or of x) into xn; fc1 with GELU in the epilogue into the
//   chunk's hidden (over q|k|v and o, dead by then); fc2, its bias and the
//   residual into y.
//
// Every product is done once, f32-accurate (three TF32 products, the small
// terms first); the (R, 3 HD) q|k|v, (R, HD) o and (R, hidden) hidden of a
// chunk go through device memory (mostly L2).  R is chosen so that the
// narrow products (E columns: the out projection and fc2) fill the SMs with
// whole tiles: 132 x 128 x 192 / E rows, rounded down to whole images.
//
// Mode 7 (namespace q8), the int8 layer on f32 x: one block per image (a
// segment of rows) and the phases in turn, separated by __syncthreads(): LN1
// and its per-row quantisation; the packed q/k/v projection; the attention
// of one head at a time with that head's K^T and V for the image in shared
// memory (f32 FMA, 136 KB at t_pad 200, so one block an SM), query tiles of
// 32 rows and a whole-row softmax; the out projection plus the residual;
// LN2; the MLP as two products.  The products run on the tensor cores (wmma
// 16x16x16 int8 -> int32, 64x128 tiles, operands staged with cp.async in
// two stages).  The per-image intermediates (q/k/v, the attention output, z
// in f32, the LN and hidden rows and their int8 form) go through a
// workspace in device memory, one slot per resident block, which the
// wrapper allocates; a block walks the images blockIdx.x, blockIdx.x +
// gridDim.x, ...  Weights come quantised per column from the wrapper; rows
// are quantised here per row (amax clamped at 1e-6, q = rint(v * (127 /
// amax)) clipped to +-127), and the epilogue is ((acc * sx) * sw) + b.
//
// Both: every value is f32, so the JAX kernels' rounding points to x's type
// are no-ops here.  GELU is the Abramowitz-Stegun form of `_gelu_exact`
// (kernels/fused_mlp.py:33-49).  Keys at or past t_real are masked; padded
// query rows carry junk, as on the TPU.  Every offset that multiplies a row
// index is 64-bit.
//
// Limits (fused_layer.py states them for the router): Dh 64; E, H * Dh and
// the hidden width multiples of 64; t_pad a multiple of 8; in mode 7 the
// attention phase must fit 227 KB (t_pad <= 344).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "chunk_gemm.cuh"

// csrc/flash_attention.cu
extern "C" int launch_flash_attention_ld(const float* q, const float* k, const float* v, float* o,
                                         float* lse, int B, int T, int S, int s_rows, int H,
                                         int Dh, int ld, float scale, cudaStream_t stream);

namespace {

constexpr int DH = 64;  // head dim
constexpr int MODE_ATTN = 1, MODE_MLP = 2, MODE_Q8 = 4;

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

// ---------------------------------------------------------------------------
// Modes 1-3: products over row chunks in 3xTF32
// ---------------------------------------------------------------------------

namespace f32layer {

using namespace cgemm;

// What a tile's epilogue writes into `out` (rows r < rows of the chunk,
// columns c < N; b the job's bias, res its residual rows):
// - L_QKV   acc + b           q | k | v (q's kernel and bias pre-scaled)
// - L_OUT   (res + b) + acc   the out projection and the residual
// - L_GELU  GELU(acc + b)     fc1
// - L_FC2   res + (acc + b)   fc2 and the residual
enum { L_QKV = 0, L_OUT = 1, L_GELU = 2, L_FC2 = 3 };

struct LayerParams {
  Job job[MAX_JOBS];
  int jobs;
  const float* bias;  // (N)
  const float* res;   // (rows, N): L_OUT, L_FC2
  float* out;         // (rows, N)
  int rows, N;
};

// Each pass over JB columns j issues all its loads before it uses any (with
// 8 warps an SM, a load used at once stalls for the whole of its latency).
constexpr int JB = 8;

__device__ __forceinline__ void epilogue(const LayerParams& p, int epi, int, int mb, int nb,
                                         const float (&acc)[BN / 2]) {
  const long N = p.N;
  const bool res = epi == L_OUT || epi == L_FC2;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += JB) {
    float2 bias[JB], old[JB][2];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int col = nb + 8 * (j0 + jj);
      const bool in = col < p.N;
      bias[jj] = in ? *reinterpret_cast<const float2*>(p.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const long r = mb + 8 * e2;
        old[jj][e2] = res && in && r < p.rows
                          ? *reinterpret_cast<const float2*>(p.res + r * N + col)
                          : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = j0 + jj, col = nb + 8 * j;
      if (col >= p.N) continue;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const long r = mb + 8 * e2;
        if (r >= p.rows) continue;
        const float a0 = acc[4 * j + 2 * e2], a1 = acc[4 * j + 2 * e2 + 1];
        const float2 b = bias[jj], o = old[jj][e2];
        float2 v;
        if (epi == L_QKV)
          v = make_float2(a0 + b.x, a1 + b.y);
        else if (epi == L_OUT)
          v = make_float2((o.x + b.x) + a0, (o.y + b.y) + a1);
        else if (epi == L_GELU)
          v = make_float2(gelu_as(a0 + b.x), gelu_as(a1 + b.y));
        else
          v = make_float2(o.x + (a0 + b.x), o.y + (a1 + b.y));
        *reinterpret_cast<float2*>(p.out + r * N + col) = v;
      }
    }
  }
}

// LayerNorm of rows [0, rows) of x (E floats a row, E a multiple of 4) into
// out, one warp a row, as `_layer_norm_rows`: the mean, then the mean of the
// squared deviations, then ((x - mean) * rsqrt(var + eps)) * gamma + beta.
// Each pass reads the row again (from L1).
constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS) ln_rows(const float* __restrict__ x, int rows, int E,
                                                      const float* __restrict__ g,
                                                      const float* __restrict__ b, float eps,
                                                      float* __restrict__ out) {
  const long r = ((long)blockIdx.x * LN_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + r * E);
  float s = 0.f;
  for (int c = lane; c < E / 4; c += 32) {
    const float4 v = xr[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / (float)E;
  float q = 0.f;
  for (int c = lane; c < E / 4; c += 32) {
    const float4 v = xr[c];
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float rs = 1.f / sqrtf(warp_sum(q) / (float)E + eps);
  float4* orow = reinterpret_cast<float4*>(out + r * E);
  for (int c = lane; c < E / 4; c += 32) {
    const float4 v = xr[c];
    const float4 gg = reinterpret_cast<const float4*>(g)[c];
    const float4 bb = reinterpret_cast<const float4*>(b)[c];
    orow[c] = make_float4(__fadd_rn(__fmul_rn(__fmul_rn(v.x - mu, rs), gg.x), bb.x),
                          __fadd_rn(__fmul_rn(__fmul_rn(v.y - mu, rs), gg.y), bb.y),
                          __fadd_rn(__fmul_rn(__fmul_rn(v.z - mu, rs), gg.z), bb.z),
                          __fadd_rn(__fmul_rn(__fmul_rn(v.w - mu, rs), gg.w), bb.w));
  }
}

int layer_norm(const float* x, int rows, int E, const float* g, const float* b, float eps,
               float* out, cudaStream_t stream) {
  const long threads = 32L * rows;
  ln_rows<<<(unsigned)((threads + LN_THREADS - 1) / LN_THREADS), LN_THREADS, 0, stream>>>(
      x, rows, E, g, b, eps, out);
  return (int)cudaGetLastError();
}

// One product on `rows` rows of A (K floats a row) against the split W^T
// whose map P.job[0].b holds (N rows), its epilogue `epi` into out.
int product(LayerParams& P, int epi, const float* a, int rows, int K, int N, const float* bias,
            const float* res, float* out, cudaStream_t stream) {
  int rc = map_a(&P.job[0].a, a, K, rows, K);
  if (rc != 0) return rc;
  set_job(P.job[0], epi, (rows + BM - 1) / BM, (N + BN - 1) / BN, K / BK);
  P.jobs = 1, P.bias = bias, P.res = res, P.out = out, P.rows = rows, P.N = N;
  return launch(P, stream);
}

// Floats of the workspace for chunks of R rows (kernels/fused_layer.py,
// workspace_bytes): xn (R, E); in ATTN|MLP z (R, E); then the wide region:
// q|k|v (R, 3 HD) and o (R, HD) in the attention modes, the MLP's hidden
// (R, hidden) over them.
long workspace_floats(int mode, long R, int E, int HD, int hidden) {
  const bool attn = mode & MODE_ATTN, mlp = mode & MODE_MLP;
  const long wide = attn ? 4L * HD : 0, hid = mlp ? (long)hidden : 0;
  return R * ((attn && mlp ? 2L : 1L) * E + (wide > hid ? wide : hid));
}

}  // namespace f32layer

// ---------------------------------------------------------------------------
// Mode 7: the int8 layer, one block per image
// ---------------------------------------------------------------------------

namespace q8 {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int QT = 32;                    // query rows per attention tile
constexpr float NEG_INF = -1e30f;

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

// C = A B over `rows` rows: A (rows, K) int8 row-major with row stride lda,
// B (K, N) row-major with row stride ldb; K and N multiples of 64, the
// strides multiples of 16 bytes.  For each output (r, c) with r < rows calls
// epi(r, c, acc) with the int32 sum.
template <class Epi>
__device__ void gemm(const int8_t* __restrict__ A, long lda, int rows, const int8_t* __restrict__ B,
                     long ldb, int K, int N, char* smem, Epi epi) {
  gemm_mma(A, lda, rows, B, ldb, K, N, smem, epi);
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

__host__ __device__ inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// ((acc * sx) * sw) + b, each step rounded (no fused multiply-add), as `_qdot`
__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sx), sw), b);
}

// Byte offsets of the regions of one workspace slot (fused_layer.py mirrors
// this in `q8_slot_bytes`).
struct Layout {
  size_t qkv, o, z, f, aq, sa, total;
};

__host__ __device__ inline Layout layout(int seg, int E, int HD, int hidden) {
  const size_t s = (size_t)seg;
  Layout L;
  L.qkv = 0;                                             // q | k | v
  L.o = L.qkv + align256(s * 3 * HD * 4);                // attention output
  L.z = L.o + align256(s * HD * 4);                      // z
  L.f = L.z + align256(s * E * 4);                       // LN or hidden rows
  L.aq = L.f + align256(s * imax(E, hidden) * 4);        // quantised rows
  L.sa = L.aq + align256(s * imax(imax(E, HD), hidden));  // their scales
  L.total = L.sa + align256(s * 4);
  return L;
}

struct Args {
  const float* x;
  float* y;
  char* ws;
  const float *g1, *be1;
  const int8_t* wqkv;
  const float *sqkv, *bqkv;
  const int8_t* wo;
  const float *so, *bo;
  const float *g2, *be2;
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  long n_rows;
  int seg, t_real, E, H, hidden;
  float eps;
};

// At most 128 registers a thread, so that two blocks share an SM.
__global__ void __launch_bounds__(THREADS, 2) fused_layer_q8(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int E = a.E, HD = a.H * DH, HID = a.hidden;
  const Layout L = layout(a.seg, E, HD, HID);
  char* ws = a.ws + (size_t)blockIdx.x * L.total;
  float* qkv = reinterpret_cast<float*>(ws + L.qkv);
  float* o = reinterpret_cast<float*>(ws + L.o);
  float* z = reinterpret_cast<float*>(ws + L.z);
  float* f = reinterpret_cast<float*>(ws + L.f);
  int8_t* aq = reinterpret_cast<int8_t*>(ws + L.aq);
  float* sa = reinterpret_cast<float*>(ws + L.sa);
  char* sm = reinterpret_cast<char*>(smem);

  const long nseg = (a.n_rows + a.seg - 1) / a.seg;
  for (long sg = blockIdx.x; sg < nseg; sg += gridDim.x) {
    const long base = sg * a.seg;
    const int rows = (int)(a.n_rows - base < a.seg ? a.n_rows - base : a.seg);
    const float* x = a.x + base * E;
    float* y = a.y + base * E;

    layer_norm_rows(x, rows, E, a.g1, a.be1, a.eps, f);
    quant_rows(f, rows, E, aq, sa);
    gemm(aq, E, rows, a.wqkv, 3 * HD, E, 3 * HD, sm, [&](int r, int c, int acc) {
      qkv[(long)r * 3 * HD + c] = (dequant(acc, sa[r], a.sqkv[c], a.bqkv[c]));
    });
    attention(qkv, HD, a.H, rows, a.t_real, o, smem);
    quant_rows(o, rows, HD, aq, sa);
    gemm(aq, HD, rows, a.wo, E, HD, E, sm, [&](int r, int c, int acc) {
      const long i = (long)r * E + c;
      z[i] = x[i] + dequant(acc, sa[r], a.so[c], a.bo[c]);
    });

    layer_norm_rows(z, rows, E, a.g2, a.be2, a.eps, f);
    quant_rows(f, rows, E, aq, sa);
    gemm(aq, E, rows, a.w1, HID, E, HID, sm, [&](int r, int c, int acc) {
      f[(long)r * HID + c] = gelu_as(dequant(acc, sa[r], a.s1[c], a.b1[c]));
    });
    quant_rows(f, rows, HID, aq, sa);
    gemm(aq, HID, rows, a.w2, E, HID, E, sm, [&](int r, int c, int acc) {
      const long i = (long)r * E + c;
      y[i] = (z[i] + dequant(acc, sa[r], a.s2[c], a.b2[c]));
    });
  }
}

int launch(const Args& a, int slots, size_t ws_bytes, cudaStream_t stream) {
  const Layout L = layout(a.seg, a.E, a.H * DH, a.hidden);
  if (L.total != ws_bytes) return (int)cudaErrorInvalidValue;
  size_t smem = MMA_SMEM;
  const size_t att = attention_smem_bytes(a.seg);
  if (att > smem) smem = att;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_layer_q8,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layer_q8, THREADS,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long nseg = (a.n_rows + a.seg - 1) / a.seg;
  long grid = (long)per_sm * sms;
  if (grid > slots) grid = slots;
  if (grid > nseg) grid = nseg;
  fused_layer_q8<<<(unsigned)grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace q8

}  // namespace

// One launch of the int8 layer on f32 x (mode 7, the only mode this entry
// takes) on `n_rows` rows of x, in segments of `seg` rows (an image of t_pad
// rows).  Weights: wqkv (E, 3 HD) = [Wq / sqrt(Dh) | Wk | Wv], wo (HD, E), w1
// (E, hidden), w2 (hidden, E) in int8 with per-column scales s*; biases and
// LN parameters f32.  ws holds `slots` slots of `ws_bytes` each.  Returns a
// cudaError_t as int: 0 when the launch was accepted.
extern "C" int launch_fused_layer(int mode, const void* x, void* y, void* ws,
                                  int slots, long long ws_bytes, const float* g1,
                                  const float* be1, const void* wqkv, const float* sqkv,
                                  const float* bqkv, const void* wo, const float* so,
                                  const float* bo, const float* g2, const float* be2,
                                  const void* w1, const float* s1, const float* b1,
                                  const void* w2, const float* s2, const float* b2,
                                  long long n_rows, int seg, int t_real, int E, int H,
                                  int hidden, float eps, cudaStream_t stream) {
  if (mode != (MODE_ATTN | MODE_MLP | MODE_Q8) || n_rows <= 0 || seg <= 0 || slots <= 0 ||
      E % 64 || (H * DH) % 64 || hidden % 64 || seg % 8 || t_real <= 0 || t_real > seg ||
      n_rows % seg)
    return (int)cudaErrorInvalidValue;
  using I8 = const int8_t*;
  q8::Args a{static_cast<const float*>(x), static_cast<float*>(y), static_cast<char*>(ws), g1, be1,
             static_cast<I8>(wqkv), sqkv, bqkv, static_cast<I8>(wo), so, bo, g2, be2,
             static_cast<I8>(w1), s1, b1, static_cast<I8>(w2), s2, b2, (long)n_rows, seg, t_real,
             E, H, hidden, eps};
  return q8::launch(a, slots, (size_t)ws_bytes, stream);
}

// The products' kernel of `mode` (1, 2 or 3; chunk_gemm with the layer's
// epilogue, one kernel for the three): its registers a thread, its local
// memory a thread (stack and spills), its dynamic shared memory and the
// blocks an SM holds.  Returns a cudaError_t as int.
extern "C" int fused_layer_tf32x3_info(int mode, int* regs, int* local, int* smem,
                                       int* blocks) {
  if (mode != MODE_ATTN && mode != MODE_MLP && mode != (MODE_ATTN | MODE_MLP))
    return (int)cudaErrorInvalidValue;
  return cgemm::info<f32layer::LayerParams>(regs, smem, blocks, local);
}

// The f32 layer in `mode` (1 ATTN, 2 MLP, 3 ATTN|MLP) on `n_rows` rows of x,
// in chunks of R rows (whole images of t_pad rows in the attention modes, a
// multiple of 128 in mode 2).  Weights as the wrapper packs them, once per
// model: every W^T split into TF32 big and small halves, (2, N, K): wqkv
// (2, 3 HD, E) from [Wq / sqrt(Dh) | Wk | Wv], wo (2, E, HD), w1 (2,
// hidden, E), w2 (2, E, hidden); biases (bqkv pre-scaled as Wq) and LN
// parameters f32.  ws holds ws_floats floats (f32layer::workspace_floats).
// x, y and ws 16-byte aligned.  Returns a cudaError_t as int (or 1000 + a
// CUresult from encoding a tensor map): 0 when every launch was accepted.
extern "C" int launch_fused_layer_tf32x3(int mode, const float* x, float* y, float* ws,
                                         long long ws_floats, int R, const float* g1,
                                         const float* be1, const float* wqkv,
                                         const float* bqkv, const float* wo, const float* bo,
                                         const float* g2, const float* be2, const float* w1,
                                         const float* b1, const float* w2, const float* b2,
                                         long long n_rows, int t_pad, int t_real, int E, int H,
                                         int hidden, float eps, cudaStream_t stream) {
  using namespace f32layer;
  const bool attn = mode & MODE_ATTN, mlp = mode & MODE_MLP;
  const int HD = H * DH;
  if ((mode != MODE_ATTN && mode != MODE_MLP && mode != (MODE_ATTN | MODE_MLP)) ||
      n_rows <= 0 || R <= 0 || E % 64 || HD % 64 || hidden % 64 ||
      !aligned(x) || !aligned(y) || !aligned(ws) ||
      (attn && (t_pad % 8 || t_real <= 0 || t_real > t_pad || n_rows % t_pad || R % t_pad)) ||
      (!attn && R % BM) || ws_floats != workspace_floats(mode, R, E, HD, hidden))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<LayerParams>();
  if (err != cudaSuccess) return (int)err;
  float* xn = ws;
  float* z = xn + (long)R * E;                 // ATTN|MLP
  float* wide = z + (attn && mlp ? (long)R * E : 0);
  float* qkv = wide;
  float* o = qkv + (long)R * 3 * HD;
  float* hid = wide;
  // the weights' maps, the same for every chunk
  LayerParams Pqkv, Po, P1, P2;
  memset(&Pqkv, 0, sizeof(LayerParams));
  Po = P1 = P2 = Pqkv;
  int rc = 0;
  if (attn) {
    rc = map_b(&Pqkv.job[0].b, wqkv, E, 3 * HD, E, 3L * HD * E);
    if (rc == 0) rc = map_b(&Po.job[0].b, wo, HD, E, HD, (long)E * HD);
  }
  if (mlp && rc == 0) {
    rc = map_b(&P1.job[0].b, w1, E, hidden, E, (long)hidden * E);
    if (rc == 0) rc = map_b(&P2.job[0].b, w2, hidden, E, hidden, (long)E * hidden);
  }
  for (long r0 = 0; r0 < n_rows && rc == 0; r0 += R) {
    const int rows = (int)(n_rows - r0 < R ? n_rows - r0 : R);
    const float* xc = x + r0 * E;
    float* yc = y + r0 * E;
    const float* src = xc;  // the MLP's input and residual
    if (attn) {
      rc = layer_norm(xc, rows, E, g1, be1, eps, xn, stream);
      if (rc == 0) rc = product(Pqkv, L_QKV, xn, rows, E, 3 * HD, bqkv, nullptr, qkv, stream);
      if (rc == 0)
        rc = launch_flash_attention_ld(qkv, qkv + HD, qkv + 2 * HD, o, nullptr, rows / t_pad,
                                       t_pad, t_real, t_pad, H, DH, 3 * HD, 1.f, stream);
      if (rc == 0) rc = product(Po, L_OUT, o, rows, HD, E, bo, xc, mlp ? z : yc, stream);
      src = z;
    }
    if (mlp && rc == 0) {
      rc = layer_norm(src, rows, E, g2, be2, eps, xn, stream);
      if (rc == 0) rc = product(P1, L_GELU, xn, rows, E, hidden, b1, nullptr, hid, stream);
      if (rc == 0) rc = product(P2, L_FC2, hid, rows, hidden, E, b2, src, yc, stream);
    }
  }
  return rc;
}
