// fused_mlp inference: y = GELU(x W1 + b1) W2 + b2 in f32, with the hidden
// activation kept on chip.
//
// Replaces the Pallas TPU kernel `_mlp_kernel`
// (transformer_stm_tpu/kernels/fused_mlp.py:52, launched by `fused_mlp` :62).
// GELU is the exact erf form through `erff`; the TPU kernel's rational erf
// (fused_mlp.py:33) only stood in for an erf that Mosaic lacked.
//
// Bound: operations.  4*N*D*Hd flops of f32 FMA against x, W1, W2 and y;
// at CvT stage 1 (N 131,072, D 64, Hd 256) that is 8.6 GFLOP against 67 MB.
// The TPU kernel keeps all of W1 and W2 and a whole row block of the hidden
// activation in VMEM.  Here a block owns BM rows and walks the hidden width
// in chunks of BH units: it computes GELU(x W1[:, chunk] + b1[chunk]) into
// shared memory and adds chunk @ W2[chunk, :] into register accumulators,
// so the (N, Hd) activation never reaches device memory.  Warp w owns rows
// 4w..4w+3 in both phases and lane l owns columns l, l + 32, ...; the row
// operands are read as warp-wide broadcast float4s from transposed tiles and
// the column operands as conflict-free consecutive words.  Shared memory:
// 177 KB at D 256, above the 48 KB default, so the launcher opts in.
//
// Layout: x (N, D), w1 (D, Hd), b1 (Hd), w2 (Hd, D), b2 (D), y (N, D), all
// contiguous; D is 64, 128 or 256 (the CvT stage widths) and Hd a multiple
// of 64.  Rows past N are zero-filled and not stored.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BH = 64;        // hidden units per chunk
constexpr int THREADS = 256;  // 8 warps x 4 rows = BM
constexpr int PAD = BM + 4;   // row length of the transposed tiles

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * PAD + D * BH + BH * D + BH * PAD);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fused_mlp_fwd(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ y, int N, int Hd) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;              // [D][PAD]   x tile, transposed
  float* w1s = xt + D * PAD;     // [D][BH]    W1[:, chunk]
  float* w2s = w1s + D * BH;     // [BH][D]    W2[chunk, :]
  float* ht = w2s + BH * D;      // [BH][PAD]  GELU(hidden chunk), transposed

  constexpr int NC = D / 32;     // output columns per lane
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 4;
  const long row0 = (long)blockIdx.x * BM;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    xt[c * PAD + r] = row0 + r < N ? x[(row0 + r) * D + c] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;

  for (int h0 = 0; h0 < Hd; h0 += BH) {
    __syncthreads();  // x tile written; the previous chunk fully consumed
    for (int idx = tid; idx < D * BH / 4; idx += THREADS) {
      const int r = idx / (BH / 4);
      const int c4 = idx % (BH / 4);
      reinterpret_cast<float4*>(w1s)[idx] =
          *reinterpret_cast<const float4*>(w1 + (long)r * Hd + h0 + 4 * c4);
    }
    const float4* w2src = reinterpret_cast<const float4*>(w2 + (long)h0 * D);
    for (int idx = tid; idx < BH * D / 4; idx += THREADS) {
      reinterpret_cast<float4*>(w2s)[idx] = w2src[idx];
    }
    __syncthreads();

    // Phase A: hidden units lane and lane + 32 of the chunk, rows r0..r0+3.
    float ha[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) ha[r][0] = ha[r][1] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(xt + kk * PAD + r0);
      const float wa = w1s[kk * BH + lane];
      const float wb = w1s[kk * BH + lane + 32];
      ha[0][0] = fmaf(xv.x, wa, ha[0][0]); ha[0][1] = fmaf(xv.x, wb, ha[0][1]);
      ha[1][0] = fmaf(xv.y, wa, ha[1][0]); ha[1][1] = fmaf(xv.y, wb, ha[1][1]);
      ha[2][0] = fmaf(xv.z, wa, ha[2][0]); ha[2][1] = fmaf(xv.z, wb, ha[2][1]);
      ha[3][0] = fmaf(xv.w, wa, ha[3][0]); ha[3][1] = fmaf(xv.w, wb, ha[3][1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lane + 32 * j;
      const float bias = b1[h0 + col];
      *reinterpret_cast<float4*>(ht + col * PAD + r0) =
          make_float4(gelu_erf(ha[0][j] + bias), gelu_erf(ha[1][j] + bias),
                      gelu_erf(ha[2][j] + bias), gelu_erf(ha[3][j] + bias));
    }
    __syncthreads();

    // Phase B: acc[r][i] += sum_j ht[j][r0 + r] * W2[h0 + j][lane + 32 i].
#pragma unroll 4
    for (int j = 0; j < BH; ++j) {
      const float4 hv = *reinterpret_cast<const float4*>(ht + j * PAD + r0);
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
        y[row * D + c] = acc[r][i] + b2[c];
      }
    }
  }
}

template <int D>
int launch_width(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* b2, float* y, int N, int Hd, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + BM - 1) / BM);
  fused_mlp_fwd<D><<<grid, THREADS, smem, stream>>>(x, w1, b1, w2, b2, y, N, Hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int launch_fused_mlp(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, float* y, int N,
                                int D, int Hd, int Dout, cudaStream_t stream) {
  if (N <= 0 || Dout != D || Hd <= 0 || Hd % BH != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_width<64>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 128: return launch_width<128>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 256: return launch_width<256>(x, w1, b1, w2, b2, y, N, Hd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
