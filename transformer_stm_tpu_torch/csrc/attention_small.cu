// attention_small forward: o = softmax(q k^T / sqrt(Dh)) v in f32, inference.
//
// Replaces the Pallas TPU kernel `_small_fwd_kernel`
// (transformer_stm_tpu/kernels/flash_attention.py:680, launched by
// `_small_fwd_impl` :703 through `attention_small` :935), without the lse
// output that only its backward reads.
//
// The TPU kernel keeps a whole K/V row of a head in VMEM.  At CvT stage 1
// (S = 1,024, Dh = 64, f32) K and V are 256 KB each, more than the 227 KB of
// shared memory a Hopper block may use, so this kernel streams K/V through
// shared memory in tiles of BK keys and keeps an online softmax per query row
// (running max m, running sum l, accumulator rescaled when m grows).
//
// Bound: operations.  4*B*H*T*S*Dh flops of f32 FMA against 4 tensors of
// B*T*H*Dh floats; at stage 1 (B 128, T = S = 1,024, H 1) that is 34.4 GFLOP
// against 134 MB.  Design: one thread owns one query row (q and the output
// accumulator live in registers); the 128 threads of a block share each K/V
// tile.  K is stored transposed, so one broadcast float4 shared load feeds
// four independent score accumulators, and V row-major, so one float4 load
// feeds four output columns.  Plain FMA; no tensor cores yet.
//
// Layout: q (B, T, H, 64), k and v (B, S, H, 64), o like q, all contiguous.
// Keys past S in the last tile are zero-filled and their scores masked to
// -1e30 (the ragged edge of stage 3's 65 tokens); query rows past T load
// zeros and store nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;          // head dim
constexpr int BQ = 128;         // query rows per block = threads per block
constexpr int BK = 32;          // keys per shared-memory tile
constexpr float MASKED = -1e30f;

__global__ void __launch_bounds__(BQ)
attention_small_fwd(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int T, int S, int H, float scale) {
  __shared__ __align__(16) float kt[DH][BK];  // K tile, transposed
  __shared__ __align__(16) float vs[BK][DH];  // V tile

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int t = blockIdx.x * BQ + tid;
  const bool row_ok = t < T;
  const long tok = (long)H * DH;  // floats between consecutive tokens
  const float* kbase = k + (long)b * S * tok + (long)h * DH;
  const float* vbase = v + (long)b * S * tok + (long)h * DH;

  float qr[DH];
  {
    const float* qrow = q + ((long)b * T + t) * tok + (long)h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 x = row_ok ? *reinterpret_cast<const float4*>(qrow + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    }
  }
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int s0 = 0; s0 < S; s0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    {
      // K: lane j loads key s0 + j; the 4 warps split its 16 float4 chunks,
      // so the transposed stores of a warp hit 32 consecutive words.
      const int j = tid % BK;
      const int key = s0 + j;
      const float* krow = kbase + (long)key * tok;
#pragma unroll
      for (int p = 0; p < DH / 16; ++p) {
        const int c = tid / BK + 4 * p;  // float4 chunk 0..15
        const float4 x = key < S ? *reinterpret_cast<const float4*>(krow + 4 * c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        kt[4 * c][j] = x.x;
        kt[4 * c + 1][j] = x.y;
        kt[4 * c + 2][j] = x.z;
        kt[4 * c + 3][j] = x.w;
      }
    }
#pragma unroll
    for (int p = 0; p < BK * DH / 4 / BQ; ++p) {
      // V: a row-major copy, 16 float4 per key
      const int idx = tid + BQ * p;
      const int j = idx / (DH / 4);
      const int c = idx % (DH / 4);
      const int key = s0 + j;
      const float4 x = key < S
          ? *reinterpret_cast<const float4*>(vbase + (long)key * tok + 4 * c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&vs[j][4 * c]) = x;
    }
    __syncthreads();

    float sc[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) sc[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < BK; j += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&kt[d][j]);
        sc[j] = fmaf(qd, kk.x, sc[j]);
        sc[j + 1] = fmaf(qd, kk.y, sc[j + 1]);
        sc[j + 2] = fmaf(qd, kk.z, sc[j + 2]);
        sc[j + 3] = fmaf(qd, kk.w, sc[j + 3]);
      }
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      sc[j] = s0 + j < S ? sc[j] * scale : MASKED;
      m_new = fmaxf(m_new, sc[j]);
    }
    // The first tile holds key 0, so m_new is finite and alpha is 0 there.
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      sc[j] = expf(sc[j] - m_new);
      l += sc[j];
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = sc[j];
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    float* orow = o + ((long)b * T + t) * tok + (long)h * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    }
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int launch_attention_small(const float* q, const float* k, const float* v,
                                      float* o, int B, int T, int S, int H, int Dh,
                                      float scale, cudaStream_t stream) {
  if (Dh != DH || B <= 0 || T <= 0 || S <= 0 || H <= 0 || (long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  attention_small_fwd<<<grid, BQ, 0, stream>>>(q, k, v, o, T, S, H, scale);
  return (int)cudaGetLastError();
}
