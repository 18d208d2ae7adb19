// The fused MLPs in f32, with the hidden activation kept on chip, on
// Hopper's tensor cores in 3xTF32 (csrc/tf32x3.cuh), one templated body:
//
//   inference      y = GELU(x W1 + b1) W2 + b2                  fused_mlp
//   training fwd   y = ((GELU(x W1 + b1) m1) W2 + b2) m2         fused_mlp_train
//
// Replaces the Pallas TPU kernels `_mlp_kernel`
// (transformer_stm_tpu/kernels/fused_mlp.py:52, launched by `fused_mlp` :62)
// and `_mlp_train_fwd_kernel` (:170, the forward of `make_fused_mlp_train`
// :291; its backward is csrc/fused_mlp_train.cu) at D 64 to 256; at D 384 and
// 768 the training forward runs as products over row chunks in
// csrc/fused_mlp_train.cu.  GELU is the exact erf
// form through `erff`; the TPU kernel's rational erf (fused_mlp.py:33) only
// stood in for an erf that Mosaic lacked.
//
// Bound: operations.  4 N D Hd flops; at ViT-S width (N 37,824, D 384, Hd
// 1536) that is 89.2 GFLOP: 1.332 ms at the 67 TFLOP/s of f32 FMA, 0.540 ms
// as three TF32 products at 495 TFLOP/s, against 58 MB of x and y (0.018 ms
// at 3.35 TB/s).  At each CvT stage (N D Hd = 2^31) 0.128 ms and 0.052 ms.
//
// Design.  A block of two consumer warpgroups owns a 64-row tile of x (and,
// at D 768, one of two column halves of y) and walks the hidden width in
// chunks of 128 units, 64 for each warpgroup:
//
// - TMA loads run through a ring of three 48 KB stages with full/empty
//   mbarriers, issued by one consumer thread up to two stages ahead, never
//   waiting for a slot it does not need yet.  (A producer warp would make a
//   third warpgroup, which caps every thread at 168 registers: ptxas does
//   not widen the allocation for setmaxnreg, and y alone takes 96 at D 384.)
//   An fc1 stage holds a 32-column slab of the x tile (f32 as stored) and
//   the same slab of the chunk's 128 rows of W1^T, big and small; an fc2
//   stage the 32-unit slab of W2^T for one warpgroup, big and small.  The
//   wrapper packs W1^T and W2^T as (2, rows, cols) big/small pairs, K-major,
//   as .tf32 wgmma needs them, once per pair of weights.
// - fc1: x is the register A operand, split into big and small in
//   registers as it is read from the stage (x's split for a whole tile
//   would take 192 KB of shared memory at D 384, beside the ring), W1^T the
//   B operand; GELU (+ b1) runs on the accumulators.
// - fc2, split K (D <= 128): each warpgroup multiplies its own 64 hidden
//   units, straight from its registers as the A operand (W2^T's rows come
//   in the matching `kpos` order), into all D columns of y; the two partial
//   sums meet in shared memory once, at the end of the tile.
// - fc2, split columns (D >= 192): the warpgroups trade their halves of the
//   chunk, split, through a 64 x 128 shared tile between two barriers, and
//   each multiplies the whole chunk into its D / 2 columns (192 of a half at
//   D 768; there fc1 runs once for each half, 1.5x that width's flops).
// - y accumulates in registers across the chunks; b2 is added in the
//   epilogue.  Each stage's products go into a fresh accumulator that f32
//   adds fold into the running one (csrc/tf32x3.cuh: the tensor cores
//   truncate as they accumulate; over Hd 1536 that bias reached 2e-5 of
//   max |y|).  Every wgmma is as wide in N as its tile: narrower ones,
//   tried on the H100, cost nearly as much each.
//
// Dropout (the training forward, DROP): m1 and m2 are the Philox masks of
// csrc/philox.cuh, equal to `dropout_mask` bit for bit.  Each element's
// mask word comes from its global index (row, hidden unit) for m1 and (row,
// column) for m2; m1's is that of the whole mask (Hw wide, this launch's
// units from column hoff) where tensor parallelism split the hidden units.
// m1 multiplies the GELU output in registers, before the split that feeds
// fc2; a thread holds units 8 j + 2 t and 8 j + 2 t + 1 of rows ra and ra +
// 8, which share one Philox group per row with the neighbour thread t ^ 1
// (Hw and hoff are multiples of 4, so the groups stay whole), so each thread draws
// one group (row ra for even t, ra + 8 for odd t) and the pair trades the
// two words the other needs (`keep_quad`): one Philox call per four
// elements.  A chunk's words are drawn a share per fc1 stage, between the
// issue of its products and the wait for them, so that they run while the
// tensor cores work.  m2 multiplies (y + b2) in the epilogue, after the
// split-K partial sums meet, as the plain version orders it.  thr == 0
// (rate 0) skips both masks.  Training changes the weights every step, so
// the training launch splits them into its own scratch at every call (a
// small packing launch) instead of keeping a pack per pair of weights.
//
// Every TMA box past N rows or Hd units is zero-filled; b1 past Hd reads as
// 0, so a ragged last chunk adds GELU(0) = 0.  Rows past N are not stored.
//
// Layout: x (N, D), b1 (Hd), b2 (D), y (N, D), f32 contiguous; w1 the packed
// W1^T, (2, Hd, D): big then small; w2 the packed W2^T, (2, D, Hd), its
// columns in kpos order at D 64 and 128.  D is 64, 128, 192, 256, 384 or
// 768 (the training forward 64 to 256); Hd a multiple of 64; x, w1
// and w2 16-byte aligned; seed int32[2] on the device.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int ROWS = 64;                    // rows of a tile: one wgmma M
constexpr int KS = 32;                      // floats of a slab row (128 bytes)
constexpr int HW = 64;                      // hidden units of a warpgroup in a chunk
constexpr int HC = 2 * HW;                  // hidden chunk
constexpr int THREADS = 256;                // two consumer warpgroups
constexpr int NSTAGE = 3;
constexpr int STAGE_BYTES = 48 * 1024;      // an fc1 stage; an fc2 stage of up to 192 columns
constexpr int X_BYTES = ROWS * KS * 4;      // an x slab, 8 KB
constexpr int W1_BYTES = HC * KS * 4;       // a W1^T slab (big or small), 16 KB
constexpr int H_BYTES = ROWS * HC * 4;      // the hidden chunk (big or small), 32 KB
constexpr int HEAD_BYTES = 1024;            // mbarriers
constexpr int ALIGN = 1024;                 // of the swizzled tiles
constexpr int SMEM = ALIGN + HEAD_BYTES + NSTAGE * STAGE_BYTES + 2 * H_BYTES;
constexpr int SPLIT_K_MAX_D = 128;          // widths that split fc2's K between warpgroups
constexpr int BAR_H_FREE = 1, BAR_H_READY = 2;  // named barriers (0: __syncthreads)
static_assert(X_BYTES + 2 * W1_BYTES <= STAGE_BYTES, "an fc1 stage");

struct Params {
  CUtensorMap m_x;   // x, (N, D), box 32 x 64
  CUtensorMap m_w1;  // packed W1^T, (2, Hd, D), box 32 x 128 x 1
  CUtensorMap m_w2;  // packed W2^T, (2, D, Hd), box 32 x NW x 1
  const float* b1;
  const float* b2;
  float* y;
  const int* seed;  // the training forward's masks (DROP)
  uint32_t thr;
  float scale;
  int N, D, Hd;
  int Hw, hoff;  // m1's whole width and this launch's first column in it
};

// The two ways a tile's warpgroups share the work, by the output columns NW
// a warpgroup accumulates:
// - split K (SK, D <= 128): each warpgroup runs fc2 on its own 64 hidden
//   units, from its registers, into all NW = D columns; the two partial y
//   are summed once, at the end of the tile.
// - split columns (D >= 192): each warpgroup runs fc2 on the whole chunk,
//   exchanged through shared memory, into its NW = D / 2 columns (192 of a
//   column half at D 768).
// FC2 is a chunk's fc2 stages: one for each 32-unit slab and warpgroup.
template <int NW, bool SK>
struct Plan {
  static constexpr int FC2 = SK ? 2 * (HW / KS) : 2 * (HC / KS);
  static_assert(2 * NW * KS * 4 <= STAGE_BYTES, "an fc2 stage");
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Keep bits of the thread's accumulator elements 4 j + 0..3 (rows ra and ra
// + 8, columns 8 j + 2 t and 8 j + 2 t + 1) of a mask of `width` columns:
// e_top is the element index of (row ra, column 8 j + 2 t).  Threads t and
// t ^ 1 hold the two halves of the same two groups of four; each draws one
// (even t the group of row ra, odd t that of row ra + 8) and they trade the
// two words the other needs.  Every lane of the warp must call it.
__device__ __forceinline__ uint32_t keep_quad(long e_top, int width, int t, uint32_t stream,
                                              uint32_t k0, uint32_t k1, uint32_t thr) {
  const bool odd = t & 1;
  const uint4 w =
      philox::mask_words(e_top - 2 * odd + (odd ? 8L * width : 0L), stream, k0, k1);
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const uint32_t a0 = odd ? r0 : w.x, a1 = odd ? r1 : w.y;  // row ra
  const uint32_t c0 = odd ? w.z : r0, c1 = odd ? w.w : r1;  // row ra + 8
  return (uint32_t)(a0 >= thr) | (uint32_t)(a1 >= thr) << 1 | (uint32_t)(c0 >= thr) << 2 |
         (uint32_t)(c1 >= thr) << 3;
}

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* stages;
  int stage = 0;
  uint32_t phase = 0;
  __device__ uint8_t* at() const { return stages + stage * STAGE_BYTES; }
  __device__ void next() {
    if (++stage == NSTAGE) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The loads of stage u into the ring's next slot once both warpgroups have
// released it.  Without `wait` it issues nothing and returns false while
// the slot is still in use.  A chunk's stages: one fc1 stage for each
// 32-column slab of x (the slab and both warpgroups' W1^T rows), then fc2
// stage f for warpgroup f % 2 and 32-unit slab f / 2 of the chunk (split K:
// of that warpgroup's half).
template <int NW, bool SK>
__device__ __forceinline__ bool issue(const Params& p, Ring& r, int u, int row0, int col0,
                                      bool wait) {
  if (wait)
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
  else if (!mbar_test(&r.empty[r.stage], r.phase ^ 1))
    return false;
  const int n1 = p.D / KS, per = n1 + Plan<NW, SK>::FC2, j = u % per;
  const int h0 = u / per * HC;
  uint8_t* s = r.at();
  uint64_t* bar = &r.full[r.stage];
  if (j < n1) {
    mbar_expect_tx(bar, X_BYTES + 2 * W1_BYTES);
    tma_3d(s, &p.m_x, bar, KS * j, row0, 0);
    tma_3d(s + X_BYTES, &p.m_w1, bar, KS * j, h0, 0);
    tma_3d(s + X_BYTES + W1_BYTES, &p.m_w1, bar, KS * j, h0, 1);
  } else {
    const int f = j - n1, w = f % 2;
    const int k0 = h0 + KS * (f / 2) + (SK ? HW * w : 0), n0 = col0 + (SK ? 0 : NW * w);
    mbar_expect_tx(bar, 2 * NW * KS * 4);
    tma_3d(s, &p.m_w2, bar, k0, n0, 0);
    tma_3d(s + NW * KS * 4, &p.m_w2, bar, k0, n0, 1);
  }
  r.next();
  return true;
}

// Both warpgroups walk every stage (waiting for it to arrive and releasing
// it), so that neither can run a ring ahead of the other.  Thread 0 also
// fills the ring: before it waits for a stage it issues every stage up to
// NSTAGE - 1 ahead whose slot is free, and waits for a slot only when the
// stage it needs next is not issued yet.  Products go into a fresh
// accumulator for each stage, added into the running one with f32 adds
// (csrc/tf32x3.cuh: the tensor cores truncate as they accumulate).
template <int NW, bool SK, bool DROP>
__device__ __forceinline__ void mlp_tile(const Params& p, Ring r, uint8_t* hbuf, int row0,
                                         int col0) {
  const int w = warpgroup();
  const int tid = threadIdx.x % 128;
  const int wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;        // the thread's first accumulator row
  uint8_t* hbig = hbuf;
  uint8_t* hsmall = hbuf + H_BYTES;
  const int total = (p.Hd + HC - 1) / HC * (p.D / KS + Plan<NW, SK>::FC2);
  // dropout: the masks are drawn only at a rate above 0
  const bool masks = DROP && p.thr != 0;
  const uint32_t k0 = DROP ? (uint32_t)p.seed[0] : 0u, k1 = DROP ? (uint32_t)p.seed[1] : 0u;
  const float keep_scale = DROP ? p.scale : 1.f;
  const int nslab = p.D / KS, per = (HW / 8 + nslab - 1) / nslab;  // m1 groups an fc1 stage
  Ring loads = r;  // thread 0's view of the ring as the one who fills it
  int issued = 0, u = 0;
  auto fill = [&]() {
    if (threadIdx.x == 0) {
      const int ahead = min(total, u + NSTAGE);
      while (issued < ahead && issue<NW, SK>(p, loads, issued, row0, col0, issued == u))
        ++issued;
    }
    __syncwarp();
  };
  auto release = [&]() {
    if (lane == 0) mbar_arrive(&r.empty[r.stage]);
    r.next();
    ++u;
  };

  float y[NW / 2], part[NW / 2];
  zero(y);
  for (int h0 = 0; h0 < p.Hd; h0 += HC) {
    // fc1: this warpgroup's 64 hidden units of the chunk
    float acc[HW / 2], part1[HW / 2];
    zero(acc);
    uint32_t keep = 0;  // m1's keep bits of the chunk: element i of acc at bit i
    const long m1_top = (row0 + ra) * (long)p.Hw + p.hoff + h0 + w * HW + 2 * t;
    for (int ks = 0; ks < nslab; ++ks) {
      fill();
      mbar_wait(&r.full[r.stage], r.phase);
      const uint8_t* s = r.at();
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = 8 * kk + t;
        const float a[4] = {*reinterpret_cast<const float*>(s + sw_off(ra, c, ROWS)),
                            *reinterpret_cast<const float*>(s + sw_off(ra + 8, c, ROWS)),
                            *reinterpret_cast<const float*>(s + sw_off(ra, c + 4, ROWS)),
                            *reinterpret_cast<const float*>(s + sw_off(ra + 8, c + 4, ROWS))};
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ab[kk][e], as[kk][e]);
      }
      fence_frag(ab);
      fence_frag(as);
      zero(part1);
      wg_fence();
      mma3_rs<HW, 4>(part1, ab, as, desc_sw128(s + X_BYTES + w * HW * 128),
                        desc_sw128(s + X_BYTES + W1_BYTES + w * HW * 128), HC);
      wg_commit();
      fill();
      if (masks) {
        // this stage's share of m1's words, while the products run
        for (int j = ks * per; j < min(HW / 8, (ks + 1) * per); ++j)
          keep |= keep_quad(m1_top + 8 * j, p.Hw, t, philox::STREAM_HIDDEN, k0, k1, p.thr)
                  << (4 * j);
      }
      wg_wait<0>();
      fence_acc(part1);
      release();
#pragma unroll
      for (int i = 0; i < HW / 2; ++i) acc[i] += part1[i];
    }

    // GELU(acc + b1) m1: in place (split K), or split into this warpgroup's
    // half of the shared chunk
    if (!SK) bar_sync(BAR_H_FREE, THREADS);  // both warpgroups are done with the last chunk
#pragma unroll
    for (int j = 0; j < HW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + 8 * (e >> 1);
        const int col = w * HW + 8 * j + 2 * t + (e & 1);
        const int unit = h0 + col;
        float v = gelu_erf(acc[4 * j + e] + (unit < p.Hd ? p.b1[unit] : 0.f));
        if (masks) v *= (keep >> (4 * j + e)) & 1 ? keep_scale : 0.f;
        if (SK) {
          acc[4 * j + e] = v;
        } else {
          float big, small;
          split(v, big, small);
          const uint32_t off = sw_off(row, col, ROWS);
          *reinterpret_cast<float*>(hbig + off) = big;
          *reinterpret_cast<float*>(hsmall + off) = small;
        }
      }
    }
    if (!SK) {
      fence_proxy_shared();
      bar_sync(BAR_H_READY, THREADS);
    }

    // fc2 into this warpgroup's NW output columns
    for (int f = 0; f < Plan<NW, SK>::FC2; ++f) {
      fill();
      mbar_wait(&r.full[r.stage], r.phase);
      if (f % 2 == w) {
        const uint8_t* s = r.at();
        const int slab = f / 2;
        const uint64_t bb = desc_sw128(s), bs = desc_sw128(s + NW * KS * 4);
        if (SK) {
          // A: k-steps 4 slab .. 4 slab + 3 of h in registers, in the kpos
          // order the wrapper packs W2^T's rows in at these widths
          uint32_t hb[4][4], hs[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc_as_a(acc, 4 * slab + kk, hb[kk], hs[kk]);
          fence_frag(hb);
          fence_frag(hs);
          zero(part);
          wg_fence();
          mma3_rs<NW, 4>(part, hb, hs, bb, bs, NW);
        } else {
          zero(part);
          wg_fence();
          mma3_ss<NW, 4>(part, desc_sw128(hbig + slab * ROWS * 128),
                            desc_sw128(hsmall + slab * ROWS * 128), ROWS, bb, bs, NW);
        }
        wg_commit();
        fill();
        wg_wait<0>();
        fence_acc(part);
        release();
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) y[i] += part[i];
      } else {
        release();
      }
    }
  }

  if (SK) {
    // the two partial sums meet in shared memory (the chunk's buffer, unused
    // with split K): row-major 64 x D floats each, then y = (sum + b2) m2,
    // four columns (one m2 group) a thread at a time
    float* sum = reinterpret_cast<float*>(hbuf);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum[w * ROWS * NW + (ra + 8 * (e >> 1)) * NW + 8 * j + 2 * t + (e & 1)] = y[4 * j + e];
    __syncthreads();
    for (int i = 4 * threadIdx.x; i < ROWS * NW; i += 4 * THREADS) {
      const long row = (long)row0 + i / NW;
      const int col = i % NW;
      if (row >= p.N) continue;
      const float4 a = *reinterpret_cast<const float4*>(sum + i);
      const float4 b = *reinterpret_cast<const float4*>(sum + ROWS * NW + i);
      const float* bias = p.b2 + col;
      float v[4] = {a.x + b.x + bias[0], a.y + b.y + bias[1], a.z + b.z + bias[2],
                    a.w + b.w + bias[3]};
      if (masks) {
        const uint4 m = philox::mask_words(row * p.D + col, philox::STREAM_OUT, k0, k1);
        const uint32_t words[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] *= words[e] >= p.thr ? keep_scale : 0.f;
      }
      *reinterpret_cast<float4*>(p.y + row * p.D + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }

  // y = (y + b2) m2, rows past N not stored
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = col0 + w * NW + 8 * j + 2 * t;
    const float2 bias = *reinterpret_cast<const float2*>(p.b2 + col);
    const uint32_t keep2 =
        masks ? keep_quad((row0 + ra) * (long)p.D + col, p.D, t, philox::STREAM_OUT, k0, k1, p.thr)
              : 0u;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = (long)row0 + ra + 8 * half;
      float2 v = make_float2(y[4 * j + 2 * half] + bias.x, y[4 * j + 2 * half + 1] + bias.y);
      if (masks) {
        v.x *= (keep2 >> (2 * half)) & 1 ? keep_scale : 0.f;
        v.y *= (keep2 >> (2 * half + 1)) & 1 ? keep_scale : 0.f;
      }
      if (row < p.N) *reinterpret_cast<float2*>(p.y + row * p.D + col) = v;
    }
  }
}

// blockIdx.x: the 64-row tile; blockIdx.y: the column half at D 768
template <int NW, bool SK, bool DROP>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_tf32x3(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  Ring r;
  r.full = reinterpret_cast<uint64_t*>(base);
  r.empty = r.full + NSTAGE;
  r.stages = base + HEAD_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], THREADS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  mlp_tile<NW, SK, DROP>(p, r, r.stages + NSTAGE * STAGE_BYTES, blockIdx.x * ROWS,
                         blockIdx.y * (SK ? NW : 2 * NW));
}

// The training launch's weights, split at every call: W1^T (2, Hd, D) into
// pk1 and W2^T (2, D, Hd) into pk2, each big then small, W2^T's columns in
// kpos order at the split-K widths (as `pack_mlp_weights` packs them)
__global__ void mlp_train_pack(const float* __restrict__ w1, const float* __restrict__ w2,
                               float* __restrict__ pk1, float* __restrict__ pk2, int D, int Hd) {
  const long n = (long)D * Hd;
  const bool kp = D <= SPLIT_K_MAX_D;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int d = (int)(i / Hd), u = (int)(i % Hd);  // w1[d][u]
    float b, s;
    split(w1[i], b, s);
    pk1[(long)u * D + d] = b;
    pk1[n + (long)u * D + d] = s;
    const long j = (long)d * Hd + (kp ? kpos(u) : u);  // W2^T[d][u] = w2[u][d]
    split(w2[(long)u * D + d], b, s);
    pk2[j] = b;
    pk2[n + j] = s;
  }
}

// the output columns a warpgroup accumulates at width D (Plan)
int columns(int D) { return D <= SPLIT_K_MAX_D ? D : D == 768 ? 192 : D / 2; }

// the kernel of width D, the inference kernel or the training forward (DROP;
// D 384 and 768 train in chunks, csrc/fused_mlp_train.cu)
template <bool DROP>
const void* kernel_of(int D) {
  switch (D) {
    case 64: return (const void*)fused_mlp_tf32x3<64, true, DROP>;
    case 128: return (const void*)fused_mlp_tf32x3<128, true, DROP>;
    case 192: return (const void*)fused_mlp_tf32x3<96, false, DROP>;
    case 256: return (const void*)fused_mlp_tf32x3<128, false, DROP>;
  }
  if constexpr (DROP) return nullptr;
  else return (const void*)fused_mlp_tf32x3<192, false, false>;
}

bool width_ok(int D) {
  return D == 64 || D == 128 || D == 192 || D == 256 || D == 384 || D == 768;
}

bool train_width_ok(int D) { return width_ok(D) && D <= 256; }

int info(const void* fn, int* regs, int* smem, int* blocks) {
  *smem = SMEM;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, SMEM);
  *regs = attr.numRegs;
  return (int)err;
}

// Encodes the tensor maps of x and the packed weights into P and launches
// the kernel of width D.  Returns a cudaError_t as int (or 1000 + a CUresult
// from encoding a tensor map): 0 when the launch was accepted.
template <bool DROP>
int launch(Params& P, const float* x, const float* w1, const float* w2, cudaStream_t stream) {
  const int N = P.N, D = P.D, Hd = P.Hd, DN = columns(D);
  const cuuint64_t xd[3] = {(cuuint64_t)D, (cuuint64_t)N, 1};
  const cuuint64_t xs[2] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4};
  const cuuint32_t xb[3] = {KS, ROWS, 1};
  const cuuint64_t w1d[3] = {(cuuint64_t)D, (cuuint64_t)Hd, 2};
  const cuuint64_t w1s[2] = {(cuuint64_t)D * 4, (cuuint64_t)Hd * D * 4};
  const cuuint32_t w1b[3] = {KS, HC, 1};
  const cuuint64_t w2d[3] = {(cuuint64_t)Hd, (cuuint64_t)D, 2};
  const cuuint64_t w2s[2] = {(cuuint64_t)Hd * 4, (cuuint64_t)D * Hd * 4};
  const cuuint32_t w2b[3] = {KS, (cuuint32_t)DN, 1};
  int rc = encode_f32(&P.m_x, x, 3, xd, xs, xb);
  if (rc == 0) rc = encode_f32(&P.m_w1, w1, 3, w1d, w1s, w1b);
  if (rc == 0) rc = encode_f32(&P.m_w2, w2, 3, w2d, w2s, w2b);
  if (rc != 0) return rc;
  const void* fn = kernel_of<DROP>(D);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + ROWS - 1) / ROWS), D == 768 ? 2 : 1);
  void* args[] = {&P};
  err = cudaLaunchKernel(fn, grid, dim3(THREADS), args, SMEM, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// The inference kernel of width D: its registers a thread, its dynamic
// shared memory and the blocks an SM holds.  Returns a cudaError_t as int.
extern "C" int fused_mlp_info(int D, int* regs, int* smem, int* blocks) {
  if (!width_ok(D)) return (int)cudaErrorInvalidValue;
  return info(kernel_of<false>(D), regs, smem, blocks);
}

// The same for the training forward's kernel of width D.
extern "C" int fused_mlp_train_fwd_info(int D, int* regs, int* smem, int* blocks) {
  if (!train_width_ok(D)) return (int)cudaErrorInvalidValue;
  return info(kernel_of<true>(D), regs, smem, blocks);
}

// The inference MLP on the packed weights of `pack_mlp_weights`.  Returns a
// cudaError_t as int (or 1000 + a CUresult from encoding a tensor map): 0
// when the launch was accepted.
extern "C" int launch_fused_mlp(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* b2, float* y, int N, int D, int Hd,
                                int Dout, cudaStream_t stream) {
  if (N <= 0 || Dout != D || !width_ok(D) || Hd <= 0 || Hd % 64 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params P;
  memset(&P, 0, sizeof(P));
  P.b1 = b1, P.b2 = b2, P.y = y, P.N = N, P.D = D, P.Hd = Hd;
  return launch<false>(P, x, w1, w2, stream);
}

// The training forward y = ((GELU(x W1 + b1) m1) W2 + b2) m2 on w1 (D, Hd)
// and w2 (Hd, D) as stored: a packing launch splits them into `pack` (4 D Hd
// floats, 16-byte aligned), then the kernel runs with the masks of `seed`
// at keep threshold thr and keep scale `scale`, m1 being columns hoff ..
// hoff + Hd - 1 of a mask Hw wide (Hw = Hd, hoff = 0 unless tensor
// parallelism split the hidden units).  Returns a cudaError_t as
// int (or 1000 + a CUresult): 0 when both launches were accepted.
extern "C" int launch_fused_mlp_train_fwd(const float* x, const float* w1, const float* b1,
                                          const float* w2, const float* b2, const int* seed,
                                          float* y, float* pack, int N, int D, int Hd, int Dout,
                                          int Hw, int hoff, unsigned thr, float scale,
                                          cudaStream_t stream) {
  if (N <= 0 || Dout != D || !train_width_ok(D) || Hd <= 0 || Hd % 64 != 0 ||
      !philox::mask_part_ok(Hd, Hw, hoff) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(pack) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long n = (long)D * Hd;
  const int pack_blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  mlp_train_pack<<<pack_blocks, 256, 0, stream>>>(w1, w2, pack, pack + 2 * n, D, Hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params P;
  memset(&P, 0, sizeof(P));
  P.b1 = b1, P.b2 = b2, P.y = y, P.seed = seed, P.thr = thr, P.scale = scale;
  P.N = N, P.D = D, P.Hd = Hd, P.Hw = Hw, P.hoff = hoff;
  return launch<true>(P, x, pack, pack + 2 * n, stream);
}
