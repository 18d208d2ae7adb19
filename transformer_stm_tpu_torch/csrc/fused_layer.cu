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
// Mode 7 (namespace q8layer), the int8 layer on f32 x, runs the same chunks
// with its six projections as int8 products (chunk_gemm_s8, the int8
// sibling of chunk_gemm: s8 wgmma m64n192k32 with int32 sums, four k32
// steps a 128-byte stage).  Bound at ViT-S B 192: 135.9 G int8 operations
// in the projections (0.069 ms at 1,979 TOP/s) and the attention's 11.8
// GFLOP as 3xTF32 (0.072 ms at 495 TFLOP/s).  Each chunk runs, one launch
// after another on the caller's stream:
//
// - LN1 and the quantisation of each row (ln_quant, a warp a row) into the
//   int8 rows aq and their scales sa;
// - q|k|v = ((acc * sx) * sw) + b on chunk_gemm_s8 against int8 W^T (q's
//   kernel and bias pre-scaled by 1/sqrt(Dh) before the kernel is
//   quantised), f32;
// - the attention on the 3xTF32 flash forward, as in modes 1-3, into o f32;
// - o quantised per row (quant_rows) into aq, sa;
// - the out projection: z = x + ((acc * so) * sw) + b, f32 (the order of
//   `xf + _qdot(...)`);
// - LN2 of z and its quantisation into aq, sa (ln_quant, which also zeroes
//   the hidden's row maxima);
// - fc1: hidden = GELU(dequantised sum) f32, over q|k|v and o; the
//   epilogue gathers each row's max |hidden| by atomicMax, so that
// - the hidden's quantisation over its whole width (quant_rows) reads it
//   once;
// - fc2: y = z + dequantised sum.
//
// Rows are quantised as `_quant_rows`, bit for bit: amax clamped at 1e-6,
// q = rint(v * (127 / amax)) clipped to +-127 (a true division), scale amax
// * (1 / 127).  Weights come quantised per column from the wrapper, once per
// model.  The workspace follows the chunk: z, q|k|v and o (the hidden over
// them) in f32, the int8 rows and two f32 values a row (q8layer::
// workspace_bytes).
//
// All modes: every value is f32, so the JAX kernels' rounding points to x's
// type are no-ops here.  GELU is the Abramowitz-Stegun form of
// `_gelu_exact` (kernels/fused_mlp.py:33-49).  Keys at or past t_real are
// masked; padded query rows carry junk, as on the TPU.  Every offset that
// multiplies a row index is 64-bit.
//
// Limits (fused_layer.py states them for the router): Dh 64; E, H * Dh and
// the hidden width multiples of 64; t_pad a multiple of 8, any t_pad in
// every mode (the attention is the flash forward).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
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

// The mean and 1 / sqrt(var + eps) of a row of E floats (E a multiple of
// 4), one warp, as `_layer_norm_rows`: the mean, then the mean of the
// squared deviations.  Each pass reads the row again (from L1).
__device__ __forceinline__ float2 ln_stats(const float4* __restrict__ xr, int E, float eps) {
  const int lane = threadIdx.x % 32;
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
  return make_float2(mu, 1.f / sqrtf(warp_sum(q) / (float)E + eps));
}

// ((x - mean) * rs) * gamma + beta of the row's columns 4c .. 4c + 3, st =
// (mean, rs) from ln_stats
__device__ __forceinline__ float4 ln_apply(const float4* __restrict__ xr,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b, int c, float2 st) {
  const float4 v = xr[c];
  const float4 gg = reinterpret_cast<const float4*>(g)[c];
  const float4 bb = reinterpret_cast<const float4*>(b)[c];
  return make_float4(__fadd_rn(__fmul_rn(__fmul_rn(v.x - st.x, st.y), gg.x), bb.x),
                     __fadd_rn(__fmul_rn(__fmul_rn(v.y - st.x, st.y), gg.y), bb.y),
                     __fadd_rn(__fmul_rn(__fmul_rn(v.z - st.x, st.y), gg.z), bb.z),
                     __fadd_rn(__fmul_rn(__fmul_rn(v.w - st.x, st.y), gg.w), bb.w));
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
// out, one warp a row (ln_stats, ln_apply).
constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS) ln_rows(const float* __restrict__ x, int rows, int E,
                                                      const float* __restrict__ g,
                                                      const float* __restrict__ b, float eps,
                                                      float* __restrict__ out) {
  const long r = ((long)blockIdx.x * LN_THREADS + threadIdx.x) / 32;
  if (r >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + r * E);
  const float2 st = ln_stats(xr, E, eps);
  float4* orow = reinterpret_cast<float4*>(out + r * E);
  for (int c = threadIdx.x % 32; c < E / 4; c += 32) orow[c] = ln_apply(xr, g, b, c, st);
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
// Mode 7: the int8 layer, products over row chunks on wgmma s8
// ---------------------------------------------------------------------------

namespace q8layer {

using namespace cgemm;

// What a tile's epilogue writes into `out` from the int32 sum acc (rows r <
// rows of the chunk, columns c < N; sx the A rows' scales, sw the weights'
// column scales, b the bias, res the residual rows), d = ((acc * sx[r]) *
// sw[c]) + b[c] as `_qdot`:
// - Q_QKV   d               q | k | v (q's kernel and bias pre-scaled)
// - Q_OUT   res + d         the out projection and the residual x: z
// - Q_GELU  GELU(d)         fc1; each row's max |GELU(d)| into rmax
// - Q_FC2   res + d         fc2 and the residual z
enum { Q_QKV = 0, Q_OUT = 1, Q_GELU = 2, Q_FC2 = 3 };

struct Q8Params {
  Job job[MAX_JOBS];
  int jobs;
  const float* sx;    // (rows)
  const float* sw;    // (N)
  const float* bias;  // (N)
  const float* res;   // (rows, N): Q_OUT, Q_FC2
  float* out;         // (rows, N)
  float* rmax;        // (rows), as int bits: Q_GELU
  int rows, N;
};

// ((acc * sx) * sw) + b, each step rounded (no fused multiply-add), the
// int32 sum converted to f32 first, as `_qdot`
__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

// Each pass over JB columns j issues all its loads before it uses any, as
// the f32 layer's epilogue.  Q_GELU keeps each of the thread's two rows'
// max |value|, takes the max over the quad that shares the rows and adds
// it to rmax by atomicMax on the bits (non-negative floats order as ints):
// what the tiles of a row give is its max over the whole hidden, exactly.
__device__ __forceinline__ void epilogue(const Q8Params& p, int epi, int, int mb, int nb,
                                         const int (&acc)[BN / 2]) {
  constexpr int JB = 8;
  const long N = p.N;
  const bool res = epi == Q_OUT || epi == Q_FC2;
  float sx[2], m[2] = {0.f, 0.f};
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) sx[e2] = mb + 8 * e2 < p.rows ? p.sx[mb + 8 * e2] : 0.f;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += JB) {
    float2 sw[JB], bias[JB], old[JB][2];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int col = nb + 8 * (j0 + jj);
      const bool in = col < p.N;
      sw[jj] = in ? *reinterpret_cast<const float2*>(p.sw + col) : make_float2(0.f, 0.f);
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
        float2 v = make_float2(dequant(acc[4 * j + 2 * e2], sx[e2], sw[jj].x, bias[jj].x),
                               dequant(acc[4 * j + 2 * e2 + 1], sx[e2], sw[jj].y, bias[jj].y));
        if (res) {
          v.x = __fadd_rn(old[jj][e2].x, v.x);
          v.y = __fadd_rn(old[jj][e2].y, v.y);
        } else if (epi == Q_GELU) {
          v.x = gelu_as(v.x);
          v.y = gelu_as(v.y);
          m[e2] = fmaxf(m[e2], fmaxf(fabsf(v.x), fabsf(v.y)));
        }
        *reinterpret_cast<float2*>(p.out + r * N + col) = v;
      }
    }
  }
  if (epi == Q_GELU) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      m[e2] = fmaxf(m[e2], __shfl_xor_sync(0xffffffffu, m[e2], 1));
      m[e2] = fmaxf(m[e2], __shfl_xor_sync(0xffffffffu, m[e2], 2));
      if ((threadIdx.x & 3) == 0 && mb + 8 * e2 < p.rows)
        atomicMax(reinterpret_cast<int*>(p.rmax) + mb + 8 * e2, __float_as_int(m[e2]));
    }
  }
}

constexpr int ROW_THREADS = 256;  // the row kernels: a warp a row

// 4 values as int8 clip(rint(v * inv), -127, 127)
__device__ __forceinline__ char4 quant4(float4 v, float inv) {
  auto q = [inv](float a) {
    return (signed char)(int)fminf(fmaxf(rintf(__fmul_rn(a, inv)), -127.f), 127.f);
  };
  return make_char4(q(v.x), q(v.y), q(v.z), q(v.w));
}

// `_quant_rows` of a row of W values, 4 at a time from val(c4), into q and
// *scale, by one warp: amax (the row's max |v| where amax < 0) clamped at
// 1e-6, q = clip(rint(v * (127 / amax)), -127, 127), scale amax * (1 / 127)
template <class Val>
__device__ __forceinline__ void quant_row(int W, Val val, float amax, int8_t* __restrict__ q,
                                          float* __restrict__ scale) {
  const int lane = threadIdx.x % 32;
  if (amax < 0.f) {
    float m = 0.f;
    for (int c = lane; c < W / 4; c += 32) {
      const float4 v = val(c);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    amax = warp_max(m);
  }
  amax = fmaxf(amax, 1e-6f);
  const float inv = __fdiv_rn(127.f, amax);
  for (int c = lane; c < W / 4; c += 32) reinterpret_cast<char4*>(q)[c] = quant4(val(c), inv);
  if (lane == 0) *scale = __fmul_rn(amax, 1.f / 127.f);
}

// LayerNorm of rows [0, rows) of x (E floats a row, a multiple of 4) as
// f32layer's `ln_rows` computes it, each row then quantised (quant_row) into
// q (rows, E) and scale (rows); rmax, where given, is zeroed for the fc1
// that follows
__global__ void __launch_bounds__(ROW_THREADS)
    ln_quant(const float* __restrict__ x, int rows, int E, const float* __restrict__ g,
             const float* __restrict__ b, float eps, int8_t* __restrict__ q,
             float* __restrict__ scale, float* __restrict__ rmax) {
  const long r = ((long)blockIdx.x * ROW_THREADS + threadIdx.x) / 32;
  if (r >= rows) return;
  const float4* xr = reinterpret_cast<const float4*>(x + r * E);
  const float2 st = ln_stats(xr, E, eps);
  quant_row(E, [&](int c) { return ln_apply(xr, g, b, c, st); }, -1.f, q + r * E, scale + r);
  if (rmax != nullptr && threadIdx.x % 32 == 0) rmax[r] = 0.f;
}

// rows [0, rows) of v (W floats a row, a multiple of 4) quantised per row
// (quant_row) into q and scale; the row maxima from rmax where given
__global__ void __launch_bounds__(ROW_THREADS)
    quant_rows(const float* __restrict__ v, int rows, int W, const float* __restrict__ rmax,
               int8_t* __restrict__ q, float* __restrict__ scale) {
  const long r = ((long)blockIdx.x * ROW_THREADS + threadIdx.x) / 32;
  if (r >= rows) return;
  const float4* vr = reinterpret_cast<const float4*>(v + r * W);
  quant_row(W, [&](int c) { return vr[c]; }, rmax != nullptr ? rmax[r] : -1.f, q + r * W,
            scale + r);
}

unsigned row_blocks(int rows) { return (unsigned)((32L * rows + ROW_THREADS - 1) / ROW_THREADS); }

// One int8 product on `rows` rows of A (K int8 a row) against the W^T whose
// map P.job[0].b holds (N rows), its epilogue `epi` into out.
int product(Q8Params& P, int epi, const int8_t* a, int rows, int K, int N, const float* sx,
            const float* sw, const float* bias, const float* res, float* rmax, float* out,
            cudaStream_t stream) {
  int rc = map_a_s8(&P.job[0].a, a, K, rows, K);
  if (rc != 0) return rc;
  set_job(P.job[0], epi, (rows + BM - 1) / BM, (N + BN - 1) / BN, (K + QK - 1) / QK);
  P.jobs = 1, P.sx = sx, P.sw = sw, P.bias = bias, P.res = res, P.rmax = rmax, P.out = out;
  P.rows = rows, P.N = N;
  return launch<Q8Params, true>(P, stream);
}

// Bytes of the workspace for chunks of R rows (kernels/fused_layer.py,
// workspace_bytes): z (R, E) f32; the wide region, q|k|v (R, 3 HD) and o
// (R, HD) f32 with the hidden (R, hidden) f32 over them; the int8 rows, the
// A operand of every product (R, max(E, HD, hidden)); their scales (R) and
// the hidden's row maxima (R) f32.  With R a multiple of 8 and the widths
// multiples of 64, every region starts 16-byte aligned.
long wide_floats(int HD, int hidden) { return 4L * HD > hidden ? 4L * HD : hidden; }

long int8_bytes(int E, int HD, int hidden) {
  const long a = E > HD ? E : HD;
  return hidden > a ? hidden : a;
}

long workspace_bytes(long R, int E, int HD, int hidden) {
  return R * (4L * E + 4 * wide_floats(HD, hidden) + int8_bytes(E, HD, hidden) + 8);
}

}  // namespace q8layer

}  // namespace

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

// The int8 products' kernel (chunk_gemm_s8 with the int8 layer's
// epilogue), `mode` 7: its registers a thread, its local memory a thread
// (stack and spills), its dynamic shared memory and the blocks an SM holds.
// Returns a cudaError_t as int.
extern "C" int fused_layer_q8_info(int mode, int* regs, int* local, int* smem, int* blocks) {
  if (mode != (MODE_ATTN | MODE_MLP | MODE_Q8)) return (int)cudaErrorInvalidValue;
  return cgemm::info<q8layer::Q8Params, true>(regs, smem, blocks, local);
}

// The int8 layer on f32 x (`mode` 7, the only mode this entry takes) on
// `n_rows` rows of x, in chunks of R rows (whole images of t_pad rows).
// Weights as the wrapper packs them, once per model: int8 W^T (out, in)
// with f32 per-column scales s*, wqkv (3 HD, E) from [Wq / sqrt(Dh) | Wk |
// Wv], wo (E, HD), w1 (hidden, E), w2 (E, hidden); biases (bqkv pre-scaled
// as Wq) and LN parameters f32.  ws holds ws_bytes bytes
// (q8layer::workspace_bytes).  x, y and ws 16-byte aligned.  Returns a
// cudaError_t as int (or 1000 + a CUresult from encoding a tensor map): 0
// when every launch was accepted.
extern "C" int launch_fused_layer(int mode, const float* x, float* y, void* ws,
                                  long long ws_bytes, int R, const float* g1, const float* be1,
                                  const void* wqkv, const float* sqkv, const float* bqkv,
                                  const void* wo, const float* so, const float* bo,
                                  const float* g2, const float* be2, const void* w1,
                                  const float* s1, const float* b1, const void* w2,
                                  const float* s2, const float* b2, long long n_rows, int t_pad,
                                  int t_real, int E, int H, int hidden, float eps,
                                  cudaStream_t stream) {
  using namespace q8layer;
  const int HD = H * DH;
  if (mode != (MODE_ATTN | MODE_MLP | MODE_Q8) || n_rows <= 0 || R <= 0 || E % 64 || HD % 64 ||
      hidden % 64 || !aligned(x) || !aligned(y) || !aligned(ws) || t_pad % 8 || t_real <= 0 ||
      t_real > t_pad || n_rows % t_pad || R % t_pad ||
      ws_bytes != workspace_bytes(R, E, HD, hidden))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<Q8Params, true>();
  if (err != cudaSuccess) return (int)err;
  float* z = static_cast<float*>(ws);
  float* qkv = z + (long)R * E;
  float* o = qkv + (long)R * 3 * HD;
  float* hid = qkv;
  int8_t* aq = reinterpret_cast<int8_t*>(qkv + R * wide_floats(HD, hidden));
  float* sa = reinterpret_cast<float*>(aq + R * int8_bytes(E, HD, hidden));
  float* hmax = sa + R;
  using I8 = const int8_t*;
  // the weights' maps, the same for every chunk
  Q8Params Pqkv, Po, P1, P2;
  memset(&Pqkv, 0, sizeof(Q8Params));
  Po = P1 = P2 = Pqkv;
  int rc = map_b_s8(&Pqkv.job[0].b, static_cast<I8>(wqkv), E, 3 * HD);
  if (rc == 0) rc = map_b_s8(&Po.job[0].b, static_cast<I8>(wo), HD, E);
  if (rc == 0) rc = map_b_s8(&P1.job[0].b, static_cast<I8>(w1), E, hidden);
  if (rc == 0) rc = map_b_s8(&P2.job[0].b, static_cast<I8>(w2), hidden, E);
  for (long r0 = 0; r0 < n_rows && rc == 0; r0 += R) {
    const int rows = (int)(n_rows - r0 < R ? n_rows - r0 : R);
    const float* xc = x + r0 * E;
    float* yc = y + r0 * E;
    ln_quant<<<row_blocks(rows), ROW_THREADS, 0, stream>>>(xc, rows, E, g1, be1, eps, aq, sa,
                                                           nullptr);
    rc = (int)cudaGetLastError();
    if (rc == 0)
      rc = product(Pqkv, Q_QKV, aq, rows, E, 3 * HD, sa, sqkv, bqkv, nullptr, nullptr, qkv,
                   stream);
    if (rc == 0)
      rc = launch_flash_attention_ld(qkv, qkv + HD, qkv + 2 * HD, o, nullptr, rows / t_pad,
                                     t_pad, t_real, t_pad, H, DH, 3 * HD, 1.f, stream);
    if (rc == 0) {
      quant_rows<<<row_blocks(rows), ROW_THREADS, 0, stream>>>(o, rows, HD, nullptr, aq, sa);
      rc = (int)cudaGetLastError();
    }
    if (rc == 0) rc = product(Po, Q_OUT, aq, rows, HD, E, sa, so, bo, xc, nullptr, z, stream);
    if (rc == 0) {
      ln_quant<<<row_blocks(rows), ROW_THREADS, 0, stream>>>(z, rows, E, g2, be2, eps, aq, sa,
                                                             hmax);
      rc = (int)cudaGetLastError();
    }
    if (rc == 0)
      rc = product(P1, Q_GELU, aq, rows, E, hidden, sa, s1, b1, nullptr, hmax, hid, stream);
    if (rc == 0) {
      quant_rows<<<row_blocks(rows), ROW_THREADS, 0, stream>>>(hid, rows, hidden, hmax, aq, sa);
      rc = (int)cudaGetLastError();
    }
    if (rc == 0) rc = product(P2, Q_FC2, aq, rows, hidden, E, sa, s2, b2, z, nullptr, yc, stream);
  }
  return rc;
}
