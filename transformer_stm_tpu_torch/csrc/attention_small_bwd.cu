// attention_small backward: dq, dk, dv of o = softmax(q k^T * scale) v, f32.
//
// Replaces the Pallas TPU kernels `_small_bwd_dq_kernel` and
// `_small_bwd_dkv_kernel` (transformer_stm_tpu/kernels/flash_attention.py:764
// and :791, launched by `_small_bwd_impl` :825, the custom_vjp backward of
// `attention_small` :935).  With p = exp(q.k * scale - lse), dp = dO.v and
// delta = rowsum(dO * o) (one torch reduction before the launch, as the JAX
// package computes it outside its kernels, :852-860):
//
//   dq = scale * sum_s p (dp - delta) k     (kernel `bwd_dq`, one block per
//                                            64 query rows, K/V streamed)
//   dk = scale * sum_t p (dp - delta) q     (kernel `bwd_dkv`, one block per
//   dv =         sum_t p dO                  64 key rows, Q/dO streamed)
//
// Both kernels rebuild p from the forward's saved lse, so neither needs a
// softmax pass.  Every output row is owned by exactly one block and written
// once: no atomics, and the result is the same from run to run.
//
// Bound: operations.  The least work is five products of 2*B*H*T*S*Dh flops
// (q k^T, dO v^T, dS k, dS^T q, p^T dO); at CvT stage 1 (B 128, T = S =
// 1,024, H 1, Dh 64) that is 85.9 GFLOP, 1.28 ms at the 67 TFLOP/s of f32
// FMA, against about 0.27 GB of inputs and outputs (0.08 ms at 3.35 TB/s).
// The split recomputes q k^T and dO v^T in both kernels, as the JAX split
// does: 14 units of work where 10 are needed, for no atomics.
//
// Design: every product here is a 64 x 64 tile summed over 64 (Dh, or a
// 64-row tile).  A block of 256 threads computes one such tile with each
// thread owning a 4 x 4 piece: rows 4*ty .. 4*ty+3 (one float4 shared load)
// and columns tx, tx+16, tx+32, tx+48 (four conflict-free scalar loads), so a
// thread holds 16 accumulators per product and at most four products' worth
// (dq: 48, dk/dv: 64) rather than whole 64-float rows, which would spill.
// Operands sit in shared memory with the summed index outermost (q, k, dO
// and v transposed as they are loaded); rows are padded to 68 floats, so the
// float4 stores of p and dS (key-major in one kernel, query-major in the
// other) hit distinct banks.  Plain f32 FMA; no tensor cores yet.
//
// Masking: keys past S (the ragged last tile of stage 3's 65 tokens) and
// query rows past T load zeros, get p = 0, and store nothing.
//
// Layout: q, dO, o, dq (B, T, H, 64); k, v, dk, dv (B, S, H, 64); lse and
// delta (B, H, T); all contiguous f32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;            // head dim
constexpr int TILE = 64;          // rows a block owns, rows of a streamed tile
constexpr int LD = DH + 4;        // shared row stride in floats
constexpr int THREADS = 256;      // 16 x 16 threads, a 4 x 4 piece each;
                                  // two blocks per SM (128 registers)
constexpr int BUF = TILE * LD;    // floats of one shared tile
constexpr int DQ_SMEM = 6 * BUF * (int)sizeof(float);    // 104,448 bytes
constexpr int DKV_SMEM = 6 * BUF * (int)sizeof(float);   // 104,448 bytes

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

// Rows row0 .. row0+63 of one head (base points at row 0 of the head, tok
// floats between rows) into dst[d][row], transposed; rows >= n are zeros.
// Neighbouring threads take neighbouring rows, so the shared stores of a
// warp hit 32 consecutive words.
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const float* __restrict__ base,
                                                int row0, int n, long tok) {
  const int r = threadIdx.x % TILE;
  const bool ok = row0 + r < n;
  const float* src = base + (long)(row0 + r) * tok;
#pragma unroll
  for (int p = 0; p < DH / 16; ++p) {
    const int c = threadIdx.x / TILE + 4 * p;  // float4 chunk 0..15
    const float4 x = ok ? *reinterpret_cast<const float4*>(src + 4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(4 * c) * LD + r] = x.x;
    dst[(4 * c + 1) * LD + r] = x.y;
    dst[(4 * c + 2) * LD + r] = x.z;
    dst[(4 * c + 3) * LD + r] = x.w;
  }
}

// The same rows into dst[row][d], as they lie in memory.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ base,
                                          int row0, int n, long tok) {
#pragma unroll
  for (int p = 0; p < TILE * DH / 4 / THREADS; ++p) {
    const int idx = threadIdx.x + THREADS * p;
    const int r = idx / (DH / 4);
    const int c = idx % (DH / 4);
    const float4 x = row0 + r < n
        ? *reinterpret_cast<const float4*>(base + (long)(row0 + r) * tok + 4 * c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = x;
  }
}

// dq for 64 query rows of one (batch, head); K and V stream through in
// 64-key tiles.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ g,
       const float* __restrict__ lse, const float* __restrict__ delta,
       float* __restrict__ dq, int T, int S, int H, float scale) {
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
  const long tok = (long)H * DH;
  const float* qbase = q + (long)b * T * tok + (long)h * DH;
  const float* gbase = g + (long)b * T * tok + (long)h * DH;
  const float* kbase = k + (long)b * S * tok + (long)h * DH;
  const float* vbase = v + (long)b * S * tok + (long)h * DH;

  load_transposed(qt, qbase, t0, T, tok);
  load_transposed(gt, gbase, t0, T, tok);
  float row_lse[4], row_delta[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    row_ok[i] = t < T;
    row_lse[i] = row_ok[i] ? lse[(long)bh * T + t] : 0.f;
    row_delta[i] = row_ok[i] ? delta[(long)bh * T + t] : 0.f;
  }
  float acc[4][4];
  zero(acc);

  for (int s0 = 0; s0 < S; s0 += TILE) {
    __syncthreads();  // every thread is done with the previous tiles
    load_transposed(kt, kbase, s0, S, tok);
    load_rows(kn, kbase, s0, S, tok);
    load_transposed(vt, vbase, s0, S, tok);
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    tile_product(sc, qt, kt, ty, tx);  // q . k
    tile_product(dp, gt, vt, ty, tx);  // dO . v
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
    __syncthreads();
    tile_product(acc, dst, kn, ty, tx);  // dS k
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    float* out = dq + ((long)b * T + t0 + 4 * ty + i) * tok + (long)h * DH;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[tx + 16 * j] = acc[i][j] * scale;
  }
}

// dk and dv for 64 key rows of one (batch, head); Q, dO, lse and delta
// stream through in 64-query tiles.
__global__ void __launch_bounds__(THREADS, 2)
bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ g,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int T, int S, int H,
        float scale) {
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
  const long tok = (long)H * DH;
  const float* qbase = q + (long)b * T * tok + (long)h * DH;
  const float* gbase = g + (long)b * T * tok + (long)h * DH;
  const float* kbase = k + (long)b * S * tok + (long)h * DH;
  const float* vbase = v + (long)b * S * tok + (long)h * DH;

  load_transposed(kt, kbase, s0, S, tok);
  load_transposed(vt, vbase, s0, S, tok);
  float acc_k[4][4], acc_v[4][4];
  zero(acc_k);
  zero(acc_v);

  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncthreads();  // every thread is done with the previous tiles
    load_transposed(qt, qbase, t0, T, tok);
    load_transposed(gt, gbase, t0, T, tok);
    load_rows(qn, qbase, t0, T, tok);
    load_rows(gn, gbase, t0, T, tok);
    float col_lse[4], col_delta[4];
    bool col_ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx + 16 * j;
      col_ok[j] = t < T;
      col_lse[j] = col_ok[j] ? lse[(long)bh * T + t] : 0.f;
      col_delta[j] = col_ok[j] ? delta[(long)bh * T + t] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    tile_product(sc, kt, qt, ty, tx);  // k . q
    tile_product(dp, vt, gt, ty, tx);  // v . dO
    __syncthreads();  // qt and gt are read; p and dS take their place
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = col_ok[j] ? expf(sc[i][j] * scale - col_lse[j]) : 0.f;
        ds[i] = p[i] * (dp[i][j] - col_delta[j]);
      }
      const int at = (tx + 16 * j) * LD + 4 * ty;
      *reinterpret_cast<float4*>(ps + at) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + at) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    tile_product(acc_v, ps, gn, ty, tx);   // p^T dO
    tile_product(acc_k, dss, qn, ty, tx);  // dS^T q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
    if (s >= S) continue;
    const long at = ((long)b * S + s) * tok + (long)h * DH;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[at + tx + 16 * j] = acc_k[i][j] * scale;
      dv[at + tx + 16 * j] = acc_v[i][j];
    }
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 when both launches were accepted.
extern "C" int launch_attention_small_bwd(
    const float* q, const float* k, const float* v, const float* g,
    const float* lse, const float* delta, float* dq, float* dk, float* dv,
    int B, int T, int S, int H, int Dh, float scale, cudaStream_t stream) {
  if (Dh != DH || B <= 0 || T <= 0 || S <= 0 || H <= 0 || (long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((T + TILE - 1) / TILE, B * H);
  bwd_dq<<<grid_q, THREADS, DQ_SMEM, stream>>>(q, k, v, g, lse, delta, dq, T,
                                               S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((S + TILE - 1) / TILE, B * H);
  bwd_dkv<<<grid_k, THREADS, DKV_SMEM, stream>>>(q, k, v, g, lse, delta, dk,
                                                 dv, T, S, H, scale);
  return (int)cudaGetLastError();
}
