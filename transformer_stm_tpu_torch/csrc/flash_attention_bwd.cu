// flash_attention and attention_small backward: dq, dk, dv of o =
// softmax(q k^T * scale) v in f32 on Hopper's tensor cores in 3xTF32
// (csrc/tf32x3.cuh), for any head dim from 1 to 256 and any lengths.
//
// Replaces both Pallas TPU backward pairs of `flash_attention`
// (transformer_stm_tpu/kernels/flash_attention.py:175): `_bwd_pallas` :296
// with `_flash_bwd_dq_kernel` :185 and `_flash_bwd_dkv_kernel` :221 (the
// whole other side resident in VMEM), and `_bwd_pallas_streaming` :469 with
// `_stream_bwd_dq_kernel` :388 and `_stream_bwd_dkv_kernel` :429 (both sides
// blocked, picked by `_bwd` :601 once residency passes 12 MiB, as at 512px);
// and the pair of `attention_small` (:935), `_small_bwd_dq_kernel` :764 and
// `_small_bwd_dkv_kernel` :791 (`_small_bwd_impl` :825), the same function
// at Dh 64 for the CvT's short sequences.  The TPU kernels differ only in
// what stays in VMEM; one design serves all.  With p = exp(q.k * scale -
// lse), dp = dO.v and delta = rowsum(dO * o) (one torch reduction before the
// launch, as the JAX package computes it outside its kernels, :284):
//
//   dq = scale * sum_s p (dp - delta) k     (kernel DQ: a block per 64 query
//                                            rows, K and V streamed)
//   dk = scale * sum_t p (dp - delta) q     (kernel DKV: a block per 64 key
//   dv =         sum_t p dO                  rows, Q and dO streamed)
//
// Every output row is owned by exactly one block and written once: no
// atomics, and two calls give the same bits.
//
// Bound: operations.  The least work is five products of 2 B H T S Dh flops;
// at the 512px CvT's stage 1 (B 128, T = S = 16,384, H 1, Dh 64) that is
// 22.0 TFLOP: 328 ms at the 67 TFLOP/s of f32 FMA, 133 ms as three TF32
// products at 495 TFLOP/s; at the 128px stage 1 (B 128, T = S = 1,024) 85.9
// GFLOP, 1.28 and 0.52 ms.  The split recomputes q k^T and dO v^T in both
// kernels, as the JAX split does (seven products where five are needed),
// so that no atomics are used.
//
// Design.  A block holds 64 rows of its own side R (DKV: k and v; DQ: q and
// dO) and streams the other side S in tiles of 64 rows (DKV: q and dO; DQ:
// k and v), for one 64-column chunk `co` of the head dim it writes
// (blockIdx.z; one chunk for Dh <= 64).  TMA loads use 4-d maps over (Dh,
// H, rows, B), so rows past the sequence are zero-filled, never the next
// batch's.
//
// - Dh <= 64 (every main path): two consumer warpgroups split the work by
//   operand.  Warpgroup 0 splits R's and S's first tensor (DKV: k, q; DQ:
//   q, k) into big and small tiles and computes X = R1 S1^T, warpgroup 1
//   the second (v, dO; dO, v) and Y = R2 S2^T, side by side; p = 2^(X scale
//   log2 e - lse log2 e), masked past the sequence, goes from warpgroup 0
//   to 1 through a big tile that X no longer needs, and ds = p (Y - delta)
//   is formed there.  DKV: warpgroup 0 adds p dO into dv, warpgroup 1 ds q
//   into dk; DQ: ds comes back through Y's freed tile and each warpgroup
//   adds ds k into half of dq's columns.  p and ds are register A operands
//   (accumulator columns in `kpos` order), B the streamed tensor's chunk
//   written transposed and split during the split pass (.tf32 wgmma takes
//   shared operands only K-major), so the wrapper makes no transposed copy.
//   Thread 0 issues the TMA loads (R and the first S tile, then each next
//   S tile once the raw stage is split): a producer warp would make a
//   288-thread block, which ptxas caps at 168 registers a thread.
// - Dh > 64: one consumer warpgroup and a producer warp; R's chunk is
//   reloaded with each chunk of each S tile and the scores are recomputed
//   for each output chunk: slower, off the main path.
// - Each S tile's products go into fresh accumulators that f32 adds fold
//   into the running ones: the tensor cores truncate as they accumulate,
//   and over 16,384 keys (6,144 wgmma into one accumulator) that bias would
//   pass the 1e-5 tolerance.
//
// Shared memory (DKV): R big/small 64 KB, S big/small 64 KB, S^T big/small
// 64 KB, one raw S stage 32 KB: 224 KB, one block an SM.  DQ needs one
// transposed operand, 192 KB.
//
// Layout: q, dO, dq (B, T, H, Dh); k, v, dk, dv (B, S, H, Dh); lse and delta
// (B, H, T); all contiguous f32, 16-byte aligned, with Dh a multiple of 8 and
// at least 32 (the wrapper zero-pads q, k, v and dO; scale stays 1/sqrt of
// the true head dim).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int TILE = 64;                  // rows of a tile; columns of a Dh chunk
constexpr int MAX_DH = 256;
constexpr int CONSUMERS = 128;            // a consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;   // one of them and a producer warp
constexpr int THREADS2 = 2 * CONSUMERS;   // DKV at Dh <= 64: two, no producer warp
constexpr int TILE_BYTES = TILE * TILE * 4;  // 64 x 64 f32, two atoms, 16 KB
constexpr int HEAD_BYTES = 1024;
constexpr int ALIGN = 1024;
constexpr int BAR_SPLIT = 1;              // named barrier of the consumers
constexpr int BAR_P = 2;                  // two consumer warpgroups: p is written
constexpr int BAR_DS = 3;                 // and (DQ) ds is written
constexpr float LOG2E = 1.44269504088896341f;
enum { DKV = 0, DQ = 1 };

// operands: R1, R2 the block's rows; S1, S2 the streamed rows
struct Params {
  CUtensorMap r1, r2, s1, s2;  // (Dh, H, rows, B), box 32 x 1 x 64 x 1
  const float* lse;
  const float* delta;
  float* out1;  // DKV: dk, DQ: dq
  float* out2;  // DKV: dv
  int T, H, Dh, LR, LS, nc;
  float scale;
};

// byte offsets of the shared regions: R big and small (two tensors each),
// S big and small, S's chunk transposed big and small (NT tensors), the raw
// S stage
template <int KIND>
struct Layout {
  static constexpr int NT = KIND == DKV ? 2 : 1;
  static constexpr int R_BIG = 0, R_SMALL = 2 * TILE_BYTES;
  static constexpr int S_BIG = 4 * TILE_BYTES, S_SMALL = 6 * TILE_BYTES;
  static constexpr int T_BIG = 8 * TILE_BYTES, T_SMALL = T_BIG + NT * TILE_BYTES;
  static constexpr int RAW = T_SMALL + NT * TILE_BYTES;
  static constexpr int BYTES = RAW + 2 * TILE_BYTES;
  static constexpr int SMEM = ALIGN + HEAD_BYTES + BYTES;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// both 32-column halves of a 64 x 64 chunk of rows row0.. of one head
__device__ __forceinline__ void load_chunk(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c, int h, int row0, int b) {
  tma_4d(dst, map, bar, c, h, row0, b);
  tma_4d(dst + TILE_BYTES / 2, map, bar, c + 32, h, row0, b);
}

template <int KIND>
__device__ void producer(const Params& p, uint8_t* sm, uint64_t* full, uint64_t* empty, int b,
                         int h, int r0) {
  using L = Layout<KIND>;
  if (threadIdx.x % 32 != 0) return;
  uint32_t phase = 0;
  for (int s0 = 0; s0 < p.LS; s0 += TILE) {
    for (int c = 0; c < p.nc; ++c) {
      const bool load_r = p.nc > 1 || s0 == 0;
      mbar_wait(empty, phase ^ 1);
      mbar_expect_tx(full, (load_r ? 4 : 2) * TILE_BYTES);
      if (load_r) {
        load_chunk(sm + L::R_BIG, &p.r1, full, TILE * c, h, r0, b);
        load_chunk(sm + L::R_BIG + TILE_BYTES, &p.r2, full, TILE * c, h, r0, b);
      }
      load_chunk(sm + L::RAW, &p.s1, full, TILE * c, h, s0, b);
      load_chunk(sm + L::RAW + TILE_BYTES, &p.s2, full, TILE * c, h, s0, b);
      phase ^= 1;
    }
  }
}

// in place: big over the raw tile, small at the same offset of `small`
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* small, int tid) {
#pragma unroll 4
  for (int i = tid; i < TILE_BYTES / 16; i += CONSUMERS) {
    float4 v = reinterpret_cast<float4*>(raw)[i];
    float4 s;
    split(v.x, v.x, s.x);
    split(v.y, v.y, s.y);
    split(v.z, v.z, s.z);
    split(v.w, v.w, s.w);
    reinterpret_cast<float4*>(raw)[i] = v;
    reinterpret_cast<float4*>(small)[i] = s;
  }
}

// the raw S tile (rows x chunk columns) into big and small at the same
// offsets and, with `transpose`, into the transposed tiles (chunk column x
// kpos(row)).  A thread takes one row and every other float4 of it, so
// that a warp's transposed stores hit 32 banks.
__device__ __forceinline__ void split_s(const uint8_t* raw, uint8_t* big, uint8_t* small,
                                        uint8_t* tbig, uint8_t* tsmall, bool transpose, int tid) {
  const int row = tid % TILE;
  const int kp = kpos(row);
#pragma unroll 4
  for (int q = tid / TILE; q < TILE / 4; q += CONSUMERS / TILE) {
    const uint32_t off = sw_off(row, 4 * q, TILE);
    const float4 v = *reinterpret_cast<const float4*>(raw + off);
    float4 vb, vs;
    split(v.x, vb.x, vs.x);
    split(v.y, vb.y, vs.y);
    split(v.z, vb.z, vs.z);
    split(v.w, vb.w, vs.w);
    *reinterpret_cast<float4*>(big + off) = vb;
    *reinterpret_cast<float4*>(small + off) = vs;
    if (transpose) {
      const float b4[4] = {vb.x, vb.y, vb.z, vb.w}, s4[4] = {vs.x, vs.y, vs.z, vs.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t toff = sw_off(4 * q + e, kp, TILE);
        *reinterpret_cast<float*>(tbig + toff) = b4[e];
        *reinterpret_cast<float*>(tsmall + toff) = s4[e];
      }
    }
  }
}

template <int KIND>
__device__ void consumer(const Params& p, uint8_t* sm, uint64_t* full, uint64_t* empty, int b,
                         int h, int r0, int co) {
  using L = Layout<KIND>;
  const int tid = threadIdx.x;
  const int wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;  // the thread's first accumulator row
  const long bh = (long)b * p.H + h;
  const float sl = p.scale * LOG2E;

  // DQ: the rows' lse (log2 e folded in) and delta, once
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (KIND == DQ) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = r0 + ra + 8 * i;
      if (q < p.T) {
        row_lse[i] = p.lse[bh * p.T + q] * LOG2E;
        row_delta[i] = p.delta[bh * p.T + q];
      }
    }
  }

  float acc1[TILE / 2], acc2[TILE / 2];  // DKV: dk, dv; DQ: dq (acc2 unused)
  zero(acc1);
  zero(acc2);
  uint32_t phase = 0;
  for (int s0 = 0; s0 < p.LS; s0 += TILE) {
    // DKV: the columns' lse and delta (queries s0 + 8 j + 2 t + e)
    float col_lse[TILE / 4], col_delta[TILE / 4];
    if (KIND == DKV) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = s0 + 8 * j + 2 * t + e;
          const bool ok = q < p.T;
          col_lse[2 * j + e] = ok ? p.lse[bh * p.T + q] * LOG2E : 0.f;
          col_delta[2 * j + e] = ok ? p.delta[bh * p.T + q] : 0.f;
        }
      }
    }
    float x[TILE / 2], y[TILE / 2];  // scores: R1 S1^T and R2 S2^T
    zero(x);
    zero(y);
    for (int c = 0; c < p.nc; ++c) {
      const bool load_r = p.nc > 1 || s0 == 0;
      mbar_wait(full, phase);
      phase ^= 1;
      if (load_r) {
        split_tile(sm + L::R_BIG, sm + L::R_SMALL, tid);
        split_tile(sm + L::R_BIG + TILE_BYTES, sm + L::R_SMALL + TILE_BYTES, tid);
      }
      const bool tr = c == co;
      split_s(sm + L::RAW, sm + L::S_BIG, sm + L::S_SMALL, sm + L::T_BIG, sm + L::T_SMALL, tr,
              tid);
      split_s(sm + L::RAW + TILE_BYTES, sm + L::S_BIG + TILE_BYTES, sm + L::S_SMALL + TILE_BYTES,
              sm + L::T_BIG + TILE_BYTES, sm + L::T_SMALL + TILE_BYTES, tr && KIND == DKV, tid);
      fence_proxy_shared();
      bar_sync(BAR_SPLIT, CONSUMERS);
      // with one chunk R stays and the raw stage is free once split
      if (p.nc == 1 && tid == 0) mbar_arrive(empty);

      // the chunk's scores in fresh accumulators, added into x and y
      const uint64_t rb = desc_sw128(sm + L::R_BIG), rs = desc_sw128(sm + L::R_SMALL);
      const uint64_t sb = desc_sw128(sm + L::S_BIG), ss = desc_sw128(sm + L::S_SMALL);
      constexpr int AT = TILE_BYTES >> 4;  // the second tensor, in descriptor units
      float xc[TILE / 2], yc[TILE / 2];
      zero(xc);
      zero(yc);
      wg_fence();
      // x's and y's chains interleave, every small term of both first
#pragma unroll
      for (int kk = 0; kk < TILE / 8; ++kk) {
        mma3_ss_small<TILE, 1>(xc, desc_k(rb, kk, TILE), desc_k(rs, kk, TILE), TILE,
                                  desc_k(sb, kk, TILE), desc_k(ss, kk, TILE), TILE);
        mma3_ss_small<TILE, 1>(yc, desc_k(rb + AT, kk, TILE), desc_k(rs + AT, kk, TILE), TILE,
                                  desc_k(sb + AT, kk, TILE), desc_k(ss + AT, kk, TILE), TILE);
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 8; ++kk) {
        mma3_ss_big<TILE, 1>(xc, desc_k(rb, kk, TILE), TILE, desc_k(sb, kk, TILE), TILE);
        mma3_ss_big<TILE, 1>(yc, desc_k(rb + AT, kk, TILE), TILE, desc_k(sb + AT, kk, TILE),
                                TILE);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(xc);
      fence_acc(yc);
      if (p.nc > 1) {
        bar_sync(BAR_SPLIT, CONSUMERS);  // every warp's products are done
        if (tid == 0) mbar_arrive(empty);
      }
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) {
        x[i] += xc[i];
        y[i] += yc[i];
      }
    }

    // p and ds in place of x and y
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, col = s0 + 8 * j + 2 * t + (e & 1);
        const float lse2 = KIND == DKV ? col_lse[2 * j + (e & 1)] : row_lse[e >> 1];
        const float dl = KIND == DKV ? col_delta[2 * j + (e & 1)] : row_delta[e >> 1];
        const float pv = col < p.LS ? exp2_approx(x[i] * sl - lse2) : 0.f;
        x[i] = pv;
        y[i] = pv * (y[i] - dl);
      }
    }

    // DKV: dv += p dO_co, dk += ds q_co; DQ: dq += ds k_co
    float part[TILE / 2];
    uint32_t ab[TILE / 8][4], as[TILE / 8][4];
    if (KIND == DKV) {
#pragma unroll
      for (int kk = 0; kk < TILE / 8; ++kk) acc_as_a(x, kk, ab[kk], as[kk]);
      fence_frag(ab);
      fence_frag(as);
      zero(part);
      wg_fence();
      mma3_rs<TILE, TILE / 8>(part, ab, as, desc_sw128(sm + L::T_BIG + TILE_BYTES),
                              desc_sw128(sm + L::T_SMALL + TILE_BYTES), TILE);
      wg_commit();
      wg_wait<0>();
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) acc2[i] += part[i];
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 8; ++kk) acc_as_a(y, kk, ab[kk], as[kk]);
    fence_frag(ab);
    fence_frag(as);
    zero(part);
    wg_fence();
    mma3_rs<TILE, TILE / 8>(part, ab, as, desc_sw128(sm + L::T_BIG), desc_sw128(sm + L::T_SMALL),
                            TILE);
    wg_commit();
    wg_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) acc1[i] += part[i];
  }

  // the epilogue: rows past LR and columns past Dh are not stored
  const long tok = (long)p.H * p.Dh;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    const int col = TILE * co + 8 * j + 2 * t;
    if (col >= p.Dh) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + ra + 8 * half;
      if (row >= p.LR) continue;
      const long at = ((long)b * p.LR + row) * tok + (long)h * p.Dh + col;
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<float2*>(p.out1 + at) =
          make_float2(acc1[i] * p.scale, acc1[i + 1] * p.scale);
      if (KIND == DKV)
        *reinterpret_cast<float2*>(p.out2 + at) = make_float2(acc2[i], acc2[i + 1]);
    }
  }
}

// DKV with two consumer warpgroups at Dh <= 64 (one chunk): warpgroup 0
// owns k, q and dv (X = k q^T, p = 2^(X scale log2 e - lse log2 e), dv +=
// p dO), warpgroup 1 owns v, dO and dk (Y = v dO^T, ds = p (Y - delta), dk
// += ds q), with p traded through q's big tile, free once X is done.  Each
// splits its own streamed tensor (and, once, its own resident one), so the
// split pass takes half as long, and the two chains of products run side
// by side on the tensor cores.  Thread 0 issues the loads: R and the first
// S tile, then each next S tile as soon as the raw stage is split (a
// producer warp would make ptxas cap every thread at 168 registers).
__device__ void consumer_dkv2(const Params& p, uint8_t* sm, uint64_t* full, int b, int h, int r0) {
  using L = Layout<DKV>;
  const int w = warpgroup();
  const int tid = threadIdx.x % CONSUMERS, wi = tid / 32, lane = tid % 32, g = lane / 4,
            t = lane % 4;
  const int ra = 16 * wi + g;
  const long bh = (long)b * p.H + h;
  const float sl = p.scale * LOG2E;
  const int own = w * TILE_BYTES;  // this warpgroup's tensor in each region
  float* P = reinterpret_cast<float*>(sm + L::S_BIG);

  if (threadIdx.x == 0) {
    mbar_expect_tx(full, 4 * TILE_BYTES);
    load_chunk(sm + L::R_BIG, &p.r1, full, 0, h, r0, b);
    load_chunk(sm + L::R_BIG + TILE_BYTES, &p.r2, full, 0, h, r0, b);
    load_chunk(sm + L::RAW, &p.s1, full, 0, h, 0, b);
    load_chunk(sm + L::RAW + TILE_BYTES, &p.s2, full, 0, h, 0, b);
  }

  float acc[TILE / 2];  // w 0: dv; w 1: dk
  zero(acc);
  uint32_t phase = 0;
  for (int s0 = 0; s0 < p.LS; s0 += TILE) {
    // the columns' lse (log2 e folded in; w 0) or delta (w 1): queries
    // s0 + 8 j + 2 t + e
    float col[TILE / 4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = s0 + 8 * j + 2 * t + e;
        col[2 * j + e] = q < p.T ? (w == 0 ? p.lse[bh * p.T + q] * LOG2E : p.delta[bh * p.T + q])
                                 : 0.f;
      }
    mbar_wait(full, phase);
    phase ^= 1;
    if (s0 > 0) bar_sync(BAR_SPLIT, 2 * CONSUMERS);  // the last tile's products are done
    else split_tile(sm + L::R_BIG + own, sm + L::R_SMALL + own, tid);
    split_s(sm + L::RAW + own, sm + L::S_BIG + own, sm + L::S_SMALL + own, sm + L::T_BIG + own,
            sm + L::T_SMALL + own, true, tid);
    fence_proxy_shared();
    bar_sync(BAR_SPLIT, 2 * CONSUMERS);
    if (threadIdx.x == 0 && s0 + TILE < p.LS) {  // the raw stage is free: the next S tile
      mbar_expect_tx(full, 2 * TILE_BYTES);
      load_chunk(sm + L::RAW, &p.s1, full, 0, h, s0 + TILE, b);
      load_chunk(sm + L::RAW + TILE_BYTES, &p.s2, full, 0, h, s0 + TILE, b);
    }

    float x[TILE / 2];  // w 0: X, then p; w 1: Y, then ds
    zero(x);
    wg_fence();
    mma3_ss<TILE, TILE / 8>(x, desc_sw128(sm + L::R_BIG + own), desc_sw128(sm + L::R_SMALL + own),
                            TILE, desc_sw128(sm + L::S_BIG + own),
                            desc_sw128(sm + L::S_SMALL + own), TILE);
    wg_commit();
    wg_wait<0>();
    fence_acc(x);
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, c = s0 + 8 * j + 2 * t + (e & 1);
          x[i] = c < p.LS ? exp2_approx(x[i] * sl - col[2 * j + (e & 1)]) : 0.f;
          P[i * CONSUMERS + tid] = x[i];
        }
      bar_arrive(BAR_P, 2 * CONSUMERS);
    } else {
      bar_sync(BAR_P, 2 * CONSUMERS);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          x[i] = P[i * CONSUMERS + tid] * (x[i] - col[2 * j + (e & 1)]);
        }
    }

    // w 0: dv += p dO (B: dO^T, the other tensor's transposed copy);
    // w 1: dk += ds q (B: q^T)
    const int other = (1 - w) * TILE_BYTES;
    float part[TILE / 2];
    uint32_t ab[TILE / 8][4], as[TILE / 8][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 8; ++kk) acc_as_a(x, kk, ab[kk], as[kk]);
    fence_frag(ab);
    fence_frag(as);
    zero(part);
    wg_fence();
    mma3_rs<TILE, TILE / 8>(part, ab, as, desc_sw128(sm + L::T_BIG + other),
                            desc_sw128(sm + L::T_SMALL + other), TILE);
    wg_commit();
    wg_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) acc[i] += part[i];
  }

  // the epilogue: w 0 stores dv, w 1 dk (scaled); rows past LR and
  // columns past Dh are not stored
  const long tok = (long)p.H * p.Dh;
  float* out = w == 0 ? p.out2 : p.out1;
  const float f = w == 0 ? 1.f : p.scale;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= p.Dh) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + ra + 8 * half;
      if (row >= p.LR) continue;
      const long at = ((long)b * p.LR + row) * tok + (long)h * p.Dh + c;
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<float2*>(out + at) = make_float2(acc[i] * f, acc[i + 1] * f);
    }
  }
}

// DQ with two consumer warpgroups at Dh <= 64: warpgroup 0 owns q and k
// (X = q k^T, p = 2^(X scale log2 e - lse log2 e)), warpgroup 1 owns dO and
// v (Y = dO v^T, ds = p (Y - delta)); p goes to warpgroup 1 through k's big
// tile and ds back through v's, both free once the scores are done, and
// each adds ds k into its half of dq's 64 columns.  Thread 0 issues the
// loads, as in consumer_dkv2.
__device__ void consumer_dq2(const Params& p, uint8_t* sm, uint64_t* full, int b, int h, int r0) {
  using L = Layout<DQ>;
  constexpr int HALF = TILE / 2;
  const int w = warpgroup();
  const int tid = threadIdx.x % CONSUMERS, wi = tid / 32, lane = tid % 32, g = lane / 4,
            t = lane % 4;
  const int ra = 16 * wi + g;
  const long bh = (long)b * p.H + h;
  const float sl = p.scale * LOG2E;
  const int own = w * TILE_BYTES;
  float* P = reinterpret_cast<float*>(sm + L::S_BIG);                // p: k's big tile
  float* DS = reinterpret_cast<float*>(sm + L::S_BIG + TILE_BYTES);  // ds: v's big tile
  if (threadIdx.x == 0) {
    mbar_expect_tx(full, 4 * TILE_BYTES);
    load_chunk(sm + L::R_BIG, &p.r1, full, 0, h, r0, b);
    load_chunk(sm + L::R_BIG + TILE_BYTES, &p.r2, full, 0, h, r0, b);
    load_chunk(sm + L::RAW, &p.s1, full, 0, h, 0, b);
    load_chunk(sm + L::RAW + TILE_BYTES, &p.s2, full, 0, h, 0, b);
  }
  // the rows' lse (w 0, log2 e folded in) or delta (w 1), once
  float row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = r0 + ra + 8 * i;
    row[i] = q < p.T ? (w == 0 ? p.lse[bh * p.T + q] * LOG2E : p.delta[bh * p.T + q]) : 0.f;
  }

  float acc[HALF / 2];  // dq's columns HALF w .. HALF w + HALF - 1
  zero(acc);
  uint32_t phase = 0;
  for (int s0 = 0; s0 < p.LS; s0 += TILE) {
    mbar_wait(full, phase);
    phase ^= 1;
    if (s0 > 0) bar_sync(BAR_SPLIT, 2 * CONSUMERS);  // the last tile's products are done
    else split_tile(sm + L::R_BIG + own, sm + L::R_SMALL + own, tid);
    // k (w 0) also transposed: the B operand of dq += ds k
    split_s(sm + L::RAW + own, sm + L::S_BIG + own, sm + L::S_SMALL + own, sm + L::T_BIG,
            sm + L::T_SMALL, w == 0, tid);
    fence_proxy_shared();
    bar_sync(BAR_SPLIT, 2 * CONSUMERS);
    if (threadIdx.x == 0 && s0 + TILE < p.LS) {  // the raw stage is free: the next S tile
      mbar_expect_tx(full, 2 * TILE_BYTES);
      load_chunk(sm + L::RAW, &p.s1, full, 0, h, s0 + TILE, b);
      load_chunk(sm + L::RAW + TILE_BYTES, &p.s2, full, 0, h, s0 + TILE, b);
    }

    float x[TILE / 2];  // w 0: X, then p, then ds; w 1: Y, then ds
    zero(x);
    wg_fence();
    mma3_ss<TILE, TILE / 8>(x, desc_sw128(sm + L::R_BIG + own), desc_sw128(sm + L::R_SMALL + own),
                            TILE, desc_sw128(sm + L::S_BIG + own),
                            desc_sw128(sm + L::S_SMALL + own), TILE);
    wg_commit();
    wg_wait<0>();
    fence_acc(x);
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, c = s0 + 8 * j + 2 * t + (e & 1);
          P[i * CONSUMERS + tid] = c < p.LS ? exp2_approx(x[i] * sl - row[e >> 1]) : 0.f;
        }
      bar_arrive(BAR_P, 2 * CONSUMERS);
      bar_sync(BAR_DS, 2 * CONSUMERS);
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) x[i] = DS[i * CONSUMERS + tid];
    } else {
      bar_sync(BAR_P, 2 * CONSUMERS);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          x[i] = P[i * CONSUMERS + tid] * (x[i] - row[e >> 1]);
          DS[i * CONSUMERS + tid] = x[i];
        }
      bar_arrive(BAR_DS, 2 * CONSUMERS);
    }

    // dq[:, HALF w ..] += ds k: B is rows HALF w .. of k's transposed tile
    float part[HALF / 2];
    uint32_t ab[TILE / 8][4], as[TILE / 8][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 8; ++kk) acc_as_a(x, kk, ab[kk], as[kk]);
    fence_frag(ab);
    fence_frag(as);
    zero(part);
    wg_fence();
    mma3_rs<HALF, TILE / 8>(part, ab, as, desc_sw128(sm + L::T_BIG + w * HALF * 128),
                            desc_sw128(sm + L::T_SMALL + w * HALF * 128), TILE);
    wg_commit();
    wg_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[i] += part[i];
  }

  const long tok = (long)p.H * p.Dh;
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
    const int c = HALF * w + 8 * j + 2 * t;
    if (c >= p.Dh) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = r0 + ra + 8 * half;
      if (q >= p.LR) continue;
      const long at = ((long)b * p.LR + q) * tok + (long)h * p.Dh + c;
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<float2*>(p.out1 + at) =
          make_float2(acc[i] * p.scale, acc[i + 1] * p.scale);
    }
  }
}

// blockIdx.x: 64 rows of R; blockIdx.y: batch * H + head; blockIdx.z: the
// output chunk of the head dim.  One consumer warpgroup and a producer
// warp, or (WGS 2: Dh <= 64) two consumer warpgroups.
template <int KIND, int WGS>
__global__ void __launch_bounds__(WGS == 2 ? THREADS2 : THREADS, 1)
    flash_bwd_tf32x3(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + 1;
  uint8_t* sm = base + HEAD_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(empty, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, r0 = blockIdx.x * TILE;
  if constexpr (WGS == 2 && KIND == DKV)
    consumer_dkv2(p, sm, full, b, h, r0);
  else if constexpr (WGS == 2)
    consumer_dq2(p, sm, full, b, h, r0);
  else if (warpgroup() == 1)
    producer<KIND>(p, sm, full, empty, b, h, r0);
  else
    consumer<KIND>(p, sm, full, empty, b, h, r0, blockIdx.z);
}

// the main path's kernels (Dh 64): two consumer warpgroups
const void* kernel_of(int kind) {
  return kind == DKV ? (const void*)flash_bwd_tf32x3<DKV, 2> : (const void*)flash_bwd_tf32x3<DQ, 2>;
}

int smem_of(int kind) { return kind == DKV ? Layout<DKV>::SMEM : Layout<DQ>::SMEM; }

// a map of one of q, k, v, dO: (Dh, H, rows, B)
int encode_qkv(CUtensorMap* map, const float* ptr, int B, int L, int H, int Dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 4, (cuuint64_t)H * Dh * 4,
                                 (cuuint64_t)L * H * Dh * 4};
  const cuuint32_t box[4] = {32, 1, TILE, 1};
  return encode_f32(map, ptr, 4, dims, strides, box);
}

template <int KIND, int WGS>
int launch(Params& P, int B, int H, cudaStream_t stream) {
  const int smem = Layout<KIND>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tf32x3<KIND, WGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((P.LR + TILE - 1) / TILE), (unsigned)(B * H), (unsigned)P.nc);
  flash_bwd_tf32x3<KIND, WGS><<<grid, WGS == 2 ? THREADS2 : THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// kind 0 (dk, dv) or 1 (dq): its registers a thread, its dynamic shared
// memory and the blocks an SM holds.  Returns a cudaError_t as int.
extern "C" int flash_attention_bwd_info(int kind, int* regs, int* smem, int* blocks) {
  if (kind != DKV && kind != DQ) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(kind);
  *smem = smem_of(kind);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS2, *smem);
  *regs = attr.numRegs;
  return (int)err;
}

// Returns a cudaError_t as int (or 1000 + a CUresult from encoding a tensor
// map): 0 when both launches were accepted.  Dh is the stored (padded) head
// dim, a multiple of 8 from 32 to 256; `vec` != 0 promises 16-byte aligned
// q, k, v and dO (the kernels take nothing else).
extern "C" int launch_flash_attention_bwd(const float* q, const float* k, const float* v,
                                          const float* g, const float* lse, const float* delta,
                                          float* dq, float* dk, float* dv, int B, int T, int S,
                                          int H, int Dh, float scale, int vec,
                                          cudaStream_t stream) {
  if (Dh < 32 || Dh > MAX_DH || Dh % 8 != 0 || B <= 0 || T <= 0 || S <= 0 || H <= 0 ||
      (long)B * H > 65535 || !vec || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(g))
    return (int)cudaErrorInvalidValue;
  Params P;
  memset(&P, 0, sizeof(P));
  P.lse = lse, P.delta = delta, P.T = T, P.H = H, P.Dh = Dh, P.scale = scale;
  P.nc = (Dh + TILE - 1) / TILE;
  CUtensorMap mq, mk, mv, mg;
  int rc = encode_qkv(&mq, q, B, T, H, Dh);
  if (rc == 0) rc = encode_qkv(&mk, k, B, S, H, Dh);
  if (rc == 0) rc = encode_qkv(&mv, v, B, S, H, Dh);
  if (rc == 0) rc = encode_qkv(&mg, g, B, T, H, Dh);
  if (rc != 0) return rc;
  // dq: R = (q, dO), S = (k, v)
  P.r1 = mq, P.r2 = mg, P.s1 = mk, P.s2 = mv;
  P.out1 = dq, P.out2 = nullptr, P.LR = T, P.LS = S;
  rc = P.nc == 1 ? launch<DQ, 2>(P, B, H, stream) : launch<DQ, 1>(P, B, H, stream);
  if (rc != 0) return rc;
  // dk, dv: R = (k, v), S = (q, dO)
  P.r1 = mk, P.r2 = mv, P.s1 = mq, P.s2 = mg;
  P.out1 = dk, P.out2 = dv, P.LR = S, P.LS = T;
  return P.nc == 1 ? launch<DKV, 2>(P, B, H, stream) : launch<DKV, 1>(P, B, H, stream);
}
