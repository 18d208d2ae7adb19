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
// activation in VMEM.  Here a block owns BM = 8 RW rows and walks the hidden
// width in chunks of BH units: it computes GELU(x W1[:, chunk] + b1[chunk])
// into shared memory and adds chunk @ W2[chunk, :] into register
// accumulators, so the (N, Hd) activation never reaches device memory.
// Warp w owns rows RW w .. RW w + RW - 1 in both phases.  In phase A lane l
// takes the units l % U, l % U + U, ... of the chunk (U = min(BH, 32)) on
// rows l / U, l / U + 32 / U, ... of its warp's; in phase B it takes output
// columns l, l + 32, ....  Row operands are warp-wide broadcasts from
// transposed tiles (float4s where a lane's rows are consecutive and four
// or more), column operands conflict-free consecutive words.
//
// (RW, BH) per width: the x tile and both weight chunks must fit the 227 KB
// a block may use, and RW x D / 32 accumulators a thread at most 48
// registers.  CvT widths 64, 128, 256 and ViT-Ti's 192: (4, 64), 177 KB at
// D 256, above the 48 KB default, so the launcher opts in.  ViT-S's 384:
// (4, 32), 158 KB.  ViT-B's 768: (2, 16), 161 KB.
//
// Layout: x (N, D), w1 (D, Hd), b1 (Hd), w2 (Hd, D), b2 (D), y (N, D), all
// contiguous; D is 64, 128, 192, 256, 384 or 768 and Hd a multiple of 64.
// Rows past N are zero-filled and not stored.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int HD_STEP = 64;   // Hd must be a multiple of this

// RW rows a warp (BM a block), BH hidden units a chunk
template <int D, int RW, int BH>
struct Tiling {
  static constexpr int BM = 8 * RW;        // rows per block
  static constexpr int PAD = BM + 4;       // row length of transposed tiles
  static constexpr int U = BH < 32 ? BH : 32;  // lanes across a row's units
  static constexpr int RL = RW * U / 32;   // phase-A rows of a lane
  static constexpr int UL = BH / U;        // phase-A units of a lane
  static constexpr int NC = D / 32;        // phase-B output columns of a lane
  static constexpr size_t smem =
      sizeof(float) * (size_t)(D * PAD + 2 * D * BH + BH * PAD);
  static_assert((RW * U) % 32 == 0 && BH % U == 0 && HD_STEP % BH == 0 &&
                    D % 32 == 0,
                "tiling");
};

// v[i] = p[S * i]: float4 or float2 loads where S is 1 and N allows (the
// callers' offsets are then multiples of the vector width).
template <int N, int S>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[N]) {
  if constexpr (S == 1 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (S == 1 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x; v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[S * i];
  }
}

template <int N, int S>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[N]) {
  if constexpr (S == 1 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (S == 1 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[S * i] = v[i];
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int D, int RW, int BH>
__global__ void __launch_bounds__(THREADS)
fused_mlp_fwd(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, float* __restrict__ y, int N, int Hd) {
  using T = Tiling<D, RW, BH>;
  constexpr int BM = T::BM, PAD = T::PAD, U = T::U, RL = T::RL, UL = T::UL,
                NC = T::NC;
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;              // [D][PAD]   x tile, transposed
  float* w1s = xt + D * PAD;     // [D][BH]    W1[:, chunk]
  float* w2s = w1s + D * BH;     // [BH][D]    W2[chunk, :]
  float* ht = w2s + BH * D;      // [BH][PAD]  GELU(hidden chunk), transposed

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * RW;  // the warp's first row
  const int ra = r0 + lane / U;    // the lane's first phase-A row
  const int ua = lane % U;         // the lane's first phase-A unit
  const long row0 = (long)blockIdx.x * BM;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    xt[c * PAD + r] = row0 + r < N ? x[(row0 + r) * D + c] : 0.f;
  }

  float acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r)
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

    // Phase A: ha[k][j] = x[ra + (32 / U) k] . W1[:, h0 + ua + U j].
    float ha[RL][UL];
#pragma unroll
    for (int k = 0; k < RL; ++k)
#pragma unroll
      for (int j = 0; j < UL; ++j) ha[k][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float xv[RL];
      load_rows<RL, 32 / U>(xt + kk * PAD + ra, xv);
#pragma unroll
      for (int j = 0; j < UL; ++j) {
        const float w = w1s[kk * BH + ua + U * j];
#pragma unroll
        for (int k = 0; k < RL; ++k) ha[k][j] = fmaf(xv[k], w, ha[k][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < UL; ++j) {
      const int col = ua + U * j;
      const float bias = b1[h0 + col];
      float g[RL];
#pragma unroll
      for (int k = 0; k < RL; ++k) g[k] = gelu_erf(ha[k][j] + bias);
      store_rows<RL, 32 / U>(ht + col * PAD + ra, g);
    }
    __syncthreads();

    // Phase B: acc[r][i] += sum_j ht[j][r0 + r] * W2[h0 + j][lane + 32 i].
#pragma unroll 4
    for (int j = 0; j < BH; ++j) {
      float hv[RW];
      load_rows<RW, 1>(ht + j * PAD + r0, hv);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float w = w2s[j * D + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[r][i] = fmaf(hv[r], w, acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
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

template <int D, int RW, int BH>
int launch_width(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* b2, float* y, int N, int Hd, cudaStream_t stream) {
  using T = Tiling<D, RW, BH>;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd<D, RW, BH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + T::BM - 1) / T::BM);
  fused_mlp_fwd<D, RW, BH><<<grid, THREADS, T::smem, stream>>>(x, w1, b1, w2, b2,
                                                               y, N, Hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted.
extern "C" int launch_fused_mlp(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, float* y, int N,
                                int D, int Hd, int Dout, cudaStream_t stream) {
  if (N <= 0 || Dout != D || Hd <= 0 || Hd % HD_STEP != 0)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_width<64, 4, 64>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 128: return launch_width<128, 4, 64>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 192: return launch_width<192, 4, 64>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 256: return launch_width<256, 4, 64>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 384: return launch_width<384, 4, 32>(x, w1, b1, w2, b2, y, N, Hd, stream);
    case 768: return launch_width<768, 2, 16>(x, w1, b1, w2, b2, y, N, Hd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
