// fused_mlp_train's backward: the gradients of the training MLP
// y = Drop2(Drop1(GELU(x W1 + b1)) W2 + b2) in f32, with both dropout masks
// drawn inside the kernels (csrc/philox.cuh).  At the CvT widths and D 192
// the (N, Hd) hidden activation is never in device memory and the forward
// is csrc/fused_mlp.cu's body with its dropout flag; at D 384 and 768 both
// directions are products over row chunks, each done once (namespace chunk,
// the last section of this file).
//
// Replaces the Pallas TPU kernel `_mlp_train_bwd_kernel`
// (transformer_stm_tpu/kernels/fused_mlp.py:189) of `make_fused_mlp_train`
// (:291).  GELU is the exact erf form through `erff`.  The TPU kernels drew
// their mask bits from the core PRNG seeded per token block; here a mask
// element is a pure function of the seed and the element's index, so the
// forward and the backward rebuild the same masks whatever their tiles.  thr
// == 0 (rate 0) skips the masks.  The slot index of the multi-target trainer
// is deliberately not in the key: two slots with the same seed train alike,
// as in JAX.
//
// Bound: operations.  The backward does 10 N D Hd flops (a recomputed, dh =
// g W2^T, dx = da W1^T, dW1 = x^T da, dW2 = h^T g) against a few bytes per
// row.  At each CvT stage (N D Hd = 2^31, 2.18e9 at stage 3) its least time
// is 0.32 ms in f32 FMA (67 TFLOP/s) and 0.13 ms as three TF32 products on
// the tensor cores (495 TFLOP/s).
//
// Backward: every product on the tensor cores in 3xTF32 (csrc/tf32x3.cuh),
// as two kernels of one templated body and a small packing launch, with no
// atomics, so that two calls agree bit for bit:
//
// - pack: W1^T and W2 as (2, Hd, D) big/small pairs (K-major along D, the
//   B operands of the scores) and W1 with its hidden units in kpos order,
//   (2, D, Hd) (the B operand of dx), 6 D Hd floats of scratch.  Training
//   changes the weights every step, so they are split at every call.
// - DX, a block a 64-row tile, walking every 64-unit hidden tile:
//   warpgroup 0 computes a = x W1[:, tile], warpgroup 1 dh = g W2[tile, :]^T
//   (A: the x or dy tile, split from shared memory into registers; B: the
//   packed slabs from a TMA ring), then q = GELU'(a + b1) m1 and da = dh q
//   meet in shared memory in fragment order, and each warpgroup adds
//   da W1[cols, tile]^T into its half of dx's columns (da as register A in
//   kpos order).  A fresh accumulator per hidden tile is folded into dx with
//   f32 adds.
// - DW, a block a hidden tile and a fixed set of row tiles (b, b + slots,
//   b + 2 slots, ...): the same scores per row tile; warpgroup 0 writes
//   h^T = (GELU(a + b1) m1)^T, split, and q; warpgroup 1 forms da = dh q;
//   then dW2[tile, :]^T += g^T h and dW1[:, tile] += x^T da in M-tiles of 64
//   columns of D shared between the warpgroups, A the transposed x or g
//   tile read from shared memory into registers, B h^T or da^T (written
//   transposed and split).  Each row tile's products go into fresh
//   accumulators folded into the block's with f32 adds: the tensor cores
//   truncate as they accumulate, and a row slot spans up to 64,000 rows at
//   N 2,097,152.  db1 sums da by warp shuffles in a fixed order, db2 sums g
//   in hidden tile 0's blocks.  Each block writes its part of its slot's
//   partial (slot-major: dW1, dW2, db1, db2), and a last launch sums the
//   slots in slot order.  The scratch is slots x (2 D Hd + Hd + D) floats,
//   with slots = 132 / (Hd / 64) row slots (kernels/fused_mlp.py,
//   train_bwd_slots): 5 to 24 MB with the packed weights at the CvT
//   widths, whatever N; 94.4 MB at D 768, Hd 3,072 (2 slots, 96 blocks).
// - g = dy m2 is written in place over the dy tile in shared memory, one
//   Philox call per group of four elements; m1 is drawn for each pair of
//   accumulator elements a thread holds (units 8 j + 2 t and 8 j + 2 t + 1
//   share a Philox group), so both equal `dropout_mask` bit for bit.
// - Up to D 256 the scores accumulate over K = D in one accumulator (96
//   truncating adds at most; the folds above are over the long sums).
// - D 192 takes the general DX and DW.
//
// D 384 and 768 (ViT-S and ViT-B; kernels/fused_mlp.py, CHUNKED_WIDTHS):
// there a 64-row f32 tile of x or dy (96 or 192 KB) leaves no room for a
// ring, and keeping the hidden on chip cost recomputed products (18 N D Hd
// flops where 10 suffice).  A 1,024-row chunk of h in f32 is 12.6 MB, so
// at these widths the hidden goes through device memory (mostly L2) and
// every product is done once, as a tile of a generic 3xTF32 GEMM kernel
// (chunk_gemm, csrc/chunk_gemm.cuh, which the f32 ViT layer shares: C = A
// B^T, 128 x 192 tiles, A as stored, B split, both K-major through a TMA
// ring; the epilogue of this file picks what the tile is for):
//
// - forward, per chunk of 132 x 128 x 192 / D rows: both masks as bits
//   (mask_bits), h = Drop1(GELU(x W1 + b1)) into an (R, Hd) hidden, y =
//   Drop2(h W2 + b2): 4 N D Hd flops.
// - backward, per chunk of R rows (384 at D 768, 768 at D 384): prep (x
//   and g = dy m2 as the products read them, split, and db2's sums);
//   m1's bits; one launch of a^T = W1^T x^T + b1 and dh^T = W2 g^T (4 N D
//   Hd); chunk_combine (h^T, da^T = (dh GELU'(a) m1)^T, da split, db1's
//   sums); then, in a second stream so that they run beside the next
//   chunk's scores, one launch of dx^T = W1 da^T in four parts of K = Hd
//   (2 N D Hd) and dW1^T += da^T x, dW2 += h^T g over the chunk's rows (4 N
//   D Hd), and the sum of dx's parts.  10 N D Hd flops in all.
// - Bound: operations; at ViT-B B 64 (N 12,608, D 768, Hd 3,072) the
//   backward's 2.98e11 flops take at least 1.80 ms as three TF32 products
//   at 495 TFLOP/s, the forward's 0.72 ms.
// - No atomics: each output tile belongs to one block, the weight
//   gradients are added to chunk after chunk in order and the bias sums
//   are taken in a fixed order, so two calls agree bit for bit.  The
//   scratch does not grow with N past one chunk (train_bwd_scratch: 63 MiB
//   at D 768, 56 MiB at D 384).
//
// Layout: x, dy, dx (N, D); w1 (D, Hd); b1 (Hd); w2 (Hd, D); b2 (D); seed
// int32[2] on the device; all contiguous, x and dy 16-byte aligned.  Rows
// past N are zero-filled (g = 0 there, so they add nothing) and are not
// stored.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chunk_gemm.cuh"
#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// Backward, on the tensor cores in 3xTF32 (csrc/tf32x3.cuh)
// ---------------------------------------------------------------------------

namespace bwd {

using namespace tf32x3;
using philox::mask_words;

constexpr int ROWS = 64;                  // a row tile: one wgmma M
constexpr int HT = 64;                    // hidden units of a tile
constexpr int KS = 32;                    // floats of a slab row (one 128-byte atom)
constexpr int THREADS = 256;              // two warpgroups
constexpr int SLAB_BYTES = 64 * KS * 4;   // a 64 x 32 f32 slab, 8 KB
constexpr int Q_BYTES = ROWS * HT * 4;    // a 64 x 64 f32 tile, 16 KB
constexpr int B_BYTES = 2 * Q_BYTES;      // h^T or da^T, big and small
constexpr int ALIGN = 1024;               // of the swizzled tiles
constexpr int SMEM_MAX = 232448;          // 227 KB, a block's most
constexpr int MAX_SLABS = 8;              // D / KS at D 256
constexpr int MAX_STAGES = 4;
// Kinds of kernel, picked by width (each measured fastest at its widths on
// the H100 against the general DX and DW by the package's
// tools/compare_mlp_bwd_kinds.py; the registers do not hold a width-256 row
// of dx, nor shared memory DWS's or DW1's tiles at width 256):
// - DX (dx, D 256): the two warpgroups share one row tile; warpgroup 0
//   computes a, warpgroup 1 dh and da (a traded through Q), and each adds
//   da W1^T into half of dx's columns.
// - DX1 (dx, D 64 and 128): each warpgroup takes its own row tile and all
//   of dx's columns; one ring of weight stages feeds both, so each slab
//   read from L2 serves 128 rows.
// - DW (weights, D 256): both warpgroups work on one row tile; warpgroup 0
//   forms h^T and q, warpgroup 1 da, and both take M-tiles of dW1 and dW2.
// - DWS (weights, D 128): warpgroup 0 owns x and dW1, warpgroup 1 owns g
//   and dW2; each streams its own weight and reloads its own tile, and they
//   trade h^T and dh once a row tile.
// - DW1 (weights, D 64): each warpgroup runs every step on its own row
//   tiles with its own accumulators, the weights resident for the block; no
//   barrier across the block until the end, so one warpgroup's element-wise
//   work overlaps the other's products.
// - CHUNKED (D 384 and 768): no kind of this body; the products over row
//   chunks of namespace `chunk` below, each done once.
enum { DX = 0, DW = 1, DX1 = 2, DW1 = 3, DWS = 4, CHUNKED = 5 };

// the kinds of each width: 384 and 768 chunked, 192 on the general ones
__host__ __device__ constexpr int dx_kind(int D) { return D >= 384 ? CHUNKED : D <= 128 ? DX1 : DX; }
__host__ __device__ constexpr int dw_kind(int D) { return D >= 384 ? CHUNKED : D == 64 ? DW1 : D == 128 ? DWS : DW; }

// The shared-memory plan of a kernel:
// - the x and dy row tiles as loaded (dy masked in place into g; DX1: one
//   pair for each warpgroup, DW1: in each warpgroup's half);
// - Q, a 64 x 64 exchange tile (DX, DW, DWS);
// - B tiles, h^T or da^T split (DW: one, used in turn; DW1: one in each
//   half; DWS: one each);
// - a ring of weight stages (DWS: one for each warpgroup).  DX and DX1
//   stages hold one 32-column slab of both weights' hidden tile (W1^T and
//   W2, big and small) for the scores, or OUT_PER "units" of W1 in kpos
//   order for dx (a unit: NOUT rows of W1 by one 32-unit K-slab, big and
//   small); DW and DWS stages one slab of one weight;
// - DW1: both weights' hidden tile, resident.
template <int KIND, int D>
struct Cfg {
  static constexpr bool PER_WG = KIND == DW1;  // a half of shared memory each
  static constexpr int NSLAB = D / KS;
  static constexpr int NOUT = KIND == DX ? D / 2 : D;  // dx columns of a warpgroup
  static constexpr int TILE = ROWS * D * 4;
  static constexpr int STAGE = KIND == DX || KIND == DX1 ? 4 * SLAB_BYTES : 2 * SLAB_BYTES;
  static constexpr int UNIT = 2 * NOUT * KS * 4;
  static constexpr int UNITS = KIND == DX ? 4 : KIND == DX1 ? 2 : 0;  // (K-slab, warpgroup)
  static constexpr int OUT_PER = STAGE / UNIT < UNITS ? STAGE / UNIT : UNITS;
  static constexpr int OUT_STAGES = UNITS ? UNITS / OUT_PER : 0;
  static constexpr int PER_ITEM = KIND == DW || KIND == DW1 ? 2 * NSLAB
                                  : KIND == DWS ? NSLAB : NSLAB + OUT_STAGES;
  static constexpr bool RING_PER_WG = KIND == DWS;
  static constexpr int X = 0, G = TILE, Q = (KIND == DX1 ? 4 : 2) * TILE;
  static constexpr int B = Q + (KIND == DX || KIND == DW || KIND == DWS ? Q_BYTES : 0);
  static constexpr int FIXED =
      B + (KIND == DW || KIND == DW1 ? B_BYTES : KIND == DWS ? 2 * B_BYTES : 0);
  static constexpr int W = 2 * FIXED;  // DW1: the resident weights, after both halves
  static constexpr int W_BYTES = KIND == DW1 ? 2 * 2 * HT * D * 4 : 0;
  static constexpr int RINGS = KIND == DW1 ? 0 : KIND == DWS ? 2 : 1;
  // head: mbarriers (1 KB), then db1's warp sums (DW, DWS, DW1)
  static constexpr int HEAD =
      1024 + (KIND == DW || KIND == DWS ? 1024 : KIND == DW1 ? 2048 : 0);
  static constexpr int FIT =
      RINGS ? (SMEM_MAX - ALIGN - HEAD - FIXED) / (RINGS * STAGE) : 0;
  static constexpr int NSTAGE = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int HALF = FIXED;  // DW1: one warpgroup's region
  static constexpr int SMEM = ALIGN + HEAD + W_BYTES +
                              (PER_WG ? 2 * HALF : FIXED + RINGS * NSTAGE * STAGE);
  static constexpr int NT = D >= 128 ? (D + 127) / 128 : 1;  // DW: M-tiles of each output a warpgroup owns
  static constexpr int KB = D >= 192 ? 4 : 8;  // k-steps of A fragments held at once
  static_assert(!RINGS || NSTAGE >= 2, "a ring of two stages at least");
  static_assert(UNITS == 0 || (OUT_PER >= 1 && UNITS % OUT_PER == 0), "dx stages");
  static_assert(NSLAB <= MAX_SLABS && SMEM <= SMEM_MAX, "shared memory");
};

struct Params {
  CUtensorMap m_x, m_dy;    // (N, D): box 32 x 64
  CUtensorMap m_w1t, m_w2;  // packed (2, Hd, D), big then small: box 32 x 64 x 1
  CUtensorMap m_w1k;        // packed (2, D, Hd), hidden units in kpos order: box 32 x NOUT x 1
  const float* b1;
  const int* seed;
  float* dx;
  // slot 0's partials dW1 (D, Hd), dW2 (Hd, D), db1 (Hd), db2 (D); slot s's
  // are pstride floats further on
  float* dw1p;
  float* dw2p;
  float* db1p;
  float* db2p;
  long pstride;
  int N, Hd, slots;
  int Hw, hoff;  // m1's whole width and this launch's first column in it
  uint32_t thr;
  float scale;
};

template <int NS>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* stages;
  int bytes;
  int stage = 0;
  uint32_t phase = 0;
  __device__ uint8_t* at() const { return stages + stage * bytes; }
  __device__ void next() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// GELU(v) and GELU'(v), exact erf form, from one erf
__device__ __forceinline__ void gelu_both(float v, float& h, float& d) {
  const float e = erff(v * 0.70710678118654752f);
  h = 0.5f * v * (1.f + e);
  d = 0.5f * (1.f + e) + v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

__device__ __forceinline__ float ld(const uint8_t* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + sw_off(r, c, ROWS));
}

// A fragments, split, of k-steps 0..3 of 32-column slab `slab` of a raw
// 64-row tile: A[m][k] = T[m][32 slab + k]
__device__ __forceinline__ void row_frags(const uint8_t* T, int slab, int ra, int t,
                                          uint32_t (&b)[4][4], uint32_t (&s)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = KS * slab + 8 * kk + t;
    const float a[4] = {ld(T, ra, c), ld(T, ra + 8, c), ld(T, ra, c + 4), ld(T, ra + 8, c + 4)};
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], b[kk][e], s[kk][e]);
  }
}

// A fragments, split, of k-steps kk0 .. kk0 + KB - 1 of the transpose of a
// raw 64-row tile from column m0: A[m][k] = T[k][m0 + m] (k runs over rows)
template <int KB>
__device__ __forceinline__ void col_frags(const uint8_t* T, int m0, int kk0, int wi, int g, int t,
                                          uint32_t (&b)[KB][4], uint32_t (&s)[KB][4]) {
  const int m = m0 + 16 * wi + g;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    const int k = 8 * (kk0 + kk) + t;
    const float a[4] = {ld(T, k, m), ld(T, k, m + 8), ld(T, k + 4, m), ld(T, k + 4, m + 8)};
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], b[kk][e], s[kk][e]);
  }
}

// g = dy m2 in place over one raw 64 x 32 slab S of dy, columns col0 ..
// col0 + 31, rows from row0: 128 threads, a Philox call for each group of
// four columns
template <int D>
__device__ __forceinline__ void mask_slab(uint8_t* S, int col0, long row0, const Params& p,
                                          uint32_t k0, uint32_t k1, int tid) {
#pragma unroll
  for (int q = tid; q < ROWS * KS / 4; q += 128) {
    const int row = q / (KS / 4), col = 4 * (q % (KS / 4));
    const uint4 w = mask_words((row0 + row) * D + col0 + col, 2u, k0, k1);
    float4* at = reinterpret_cast<float4*>(S + sw_off(row, col, ROWS));
    float4 v = *at;
    v.x *= w.x >= p.thr ? p.scale : 0.f;
    v.y *= w.y >= p.thr ? p.scale : 0.f;
    v.z *= w.z >= p.thr ? p.scale : 0.f;
    v.w *= w.w >= p.thr ? p.scale : 0.f;
    *at = v;
  }
  fence_proxy_shared();  // before a later TMA load writes the tile again
}

// the same over 32-column slab `slab` of a raw 64-row tile at row0
template <int D>
__device__ __forceinline__ void mask_g(uint8_t* T, int slab, long row0, const Params& p,
                                       uint32_t k0, uint32_t k1, int tid) {
  mask_slab<D>(T + slab * SLAB_BYTES, KS * slab, row0, p, k0, k1, tid);
}

// m1 of the accumulator elements 4 j + 2 e2 + (0, 1): row, units u and u + 1
// (u = 8 j + 2 t: one Philox group holds both)
__device__ __forceinline__ float2 mask1(long row, long unit, const Params& p, uint32_t k0,
                                        uint32_t k1) {
  if (p.thr == 0) return make_float2(1.f, 1.f);
  const long e = row * p.Hw + p.hoff + unit;
  const uint4 w = mask_words(e, 1u, k0, k1);
  const int i = (int)(e & 3);
  return make_float2(word(w, i) >= p.thr ? p.scale : 0.f, word(w, i + 1) >= p.thr ? p.scale : 0.f);
}

// the x or dy tile at row0, one mbarrier per 32-column slab
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* m, uint8_t* dst, uint64_t* bars,
                                          long row0) {
#pragma unroll
  for (int s = 0; s < D / KS; ++s) {
    mbar_expect_tx(&bars[s], SLAB_BYTES);
    tma_3d(dst + s * SLAB_BYTES, m, &bars[s], KS * s, (int)row0, 0);
  }
}

// The loads of ring stage u of a schedule into the ring's next slot once
// every warp of the ring has released it; without `wait` it issues nothing
// and returns false while the slot is in use.  DX, DX1: an item is a hidden
// tile (NSLAB score stages, then OUT_STAGES dx stages; DX1's score stages
// also carry the slab of x and dy at row0); DW: an item is a row tile, the
// hidden tile is the block's (W1^T's slab j / 2 for even j, W2's for odd j).
template <int KIND, int D>
__device__ __forceinline__ bool issue(const Params& p, Ring<Cfg<KIND, D>::NSTAGE>& r, int u,
                                      bool wait) {
  using C = Cfg<KIND, D>;
  if (wait)
    mbar_wait(&r.empty[r.stage], r.phase ^ 1);
  else if (!mbar_test(&r.empty[r.stage], r.phase ^ 1))
    return false;
  const int item = u / C::PER_ITEM, j = u % C::PER_ITEM;
  uint8_t* s = r.at();
  uint64_t* bar = &r.full[r.stage];
  if constexpr (KIND == DX || KIND == DX1) {
    const int h0 = HT * (item % (p.Hd / HT));  // DX1: the items of each row pair
    if (j < C::NSLAB) {
      mbar_expect_tx(bar, 4 * SLAB_BYTES);
      tma_3d(s, &p.m_w1t, bar, KS * j, h0, 0);
      tma_3d(s + SLAB_BYTES, &p.m_w1t, bar, KS * j, h0, 1);
      tma_3d(s + 2 * SLAB_BYTES, &p.m_w2, bar, KS * j, h0, 0);
      tma_3d(s + 3 * SLAB_BYTES, &p.m_w2, bar, KS * j, h0, 1);
    } else {
      mbar_expect_tx(bar, C::OUT_PER * C::UNIT);
#pragma unroll
      for (int v = 0; v < C::OUT_PER; ++v) {
        const int unit = (j - C::NSLAB) * C::OUT_PER + v;  // DX: 2 ks + w; DX1: ks
        const int ks = KIND == DX ? unit / 2 : unit, n0 = KIND == DX ? C::NOUT * (unit % 2) : 0;
        uint8_t* d = s + v * C::UNIT;
        tma_3d(d, &p.m_w1k, bar, h0 + KS * ks, n0, 0);
        tma_3d(d + C::UNIT / 2, &p.m_w1k, bar, h0 + KS * ks, n0, 1);
      }
    }
  } else {
    // DW: W1^T's slab j / 2 for even j, W2's for odd j; DWS: the
    // warpgroup's own weight's slab j
    const int h0 = HT * blockIdx.x, sl = KIND == DWS ? j : j / 2;
    const bool w1 = KIND == DWS ? threadIdx.x < 128 : j % 2 == 0;  // one lane runs this
    const CUtensorMap* m = w1 ? &p.m_w1t : &p.m_w2;
    mbar_expect_tx(bar, 2 * SLAB_BYTES);
    tma_3d(s, m, bar, KS * sl, h0, 0);
    tma_3d(s + SLAB_BYTES, m, bar, KS * sl, h0, 1);
  }
  r.next();
  return true;
}

// A schedule of ring stages: every warp of the ring's group (the block, or
// one warpgroup for DX1) walks every stage in order (waits for it, releases
// it), and the group's first thread fills the ring as csrc/fused_mlp.cu
// does, up to NSTAGE stages ahead, waiting for a slot only when the stage
// it needs next is not issued yet.
template <int KIND, int D>
struct Walk {
  using C = Cfg<KIND, D>;
  const Params& p;
  Ring<C::NSTAGE> r, loads;
  int total, issued = 0, u = 0;
  bool producer;
  __device__ Walk(const Params& p_, Ring<C::NSTAGE> r_, int total_)
      : p(p_), r(r_), loads(r_), total(total_),
        producer(threadIdx.x % (C::RING_PER_WG ? 128 : THREADS) == 0) {}
  __device__ void fill() {
    if (producer) {
      const int ahead = min(total, u + C::NSTAGE);
      while (issued < ahead && issue<KIND, D>(p, loads, issued, issued == u)) ++issued;
    }
    __syncwarp();
  }
  __device__ uint8_t* wait() {
    fill();
    mbar_wait(&r.full[r.stage], r.phase);
    return r.at();
  }
  __device__ void release() {
    if (threadIdx.x % 32 == 0) mbar_arrive(&r.empty[r.stage]);
    r.next();
    ++u;
  }
};

// fresh = A B over the k-steps of one 64-row K, A the transpose of raw tile
// T from column m0 (k-steps KB at a time), B the split tile at bb / bs
template <int KB>
__device__ __forceinline__ void tile_product(float (&fresh)[HT / 2], const uint8_t* T, int m0,
                                             uint64_t bb, uint64_t bs, int wi, int g, int t) {
  zero(fresh);
#pragma unroll
  for (int kk0 = 0; kk0 < ROWS / 8; kk0 += KB) {
    uint32_t fb[KB][4], fs[KB][4];
    col_frags<KB>(T, m0, kk0, wi, g, t, fb, fs);
    fence_frag(fb);
    fence_frag(fs);
    wg_fence();
    mma3_rs<HT, KB>(fresh, fb, fs, desc_k(bb, kk0, HT), desc_k(bs, kk0, HT), HT);
    wg_commit();
    wg_wait<0>();
    fence_acc(fresh);
  }
}

// v^T split into the B tile at (unit 8 j + 2 t + e1, row ra + 8 e2) for
// accumulator element 4 j + 2 e2 + e1 of a 64 x 64 tile
__device__ __forceinline__ void store_t(uint8_t* Bb, uint8_t* Bs, int j, int e2, int e1, int ra,
                                        int t, float v) {
  float hb, hs;
  split(v, hb, hs);
  const uint32_t off = sw_off(8 * j + 2 * t + e1, ra + 8 * e2, HT);
  *reinterpret_cast<float*>(Bb + off) = hb;
  *reinterpret_cast<float*>(Bs + off) = hs;
}

// db1's partial of one row tile from da (a warpgroup's accumulator layout):
// column sums over the thread's two rows, then over the warp's eight row
// groups by shuffles in a fixed order, added into sums[HT] by lane g == 0
__device__ __forceinline__ void col_sums(const float (&da)[HT / 2], float* sums, int g, int t) {
#pragma unroll
  for (int j = 0; j < HT / 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      float v = da[4 * j + e1] + da[4 * j + 2 + e1];
      v += __shfl_xor_sync(0xffffffff, v, 4);
      v += __shfl_xor_sync(0xffffffff, v, 8);
      v += __shfl_xor_sync(0xffffffff, v, 16);
      if (g == 0) sums[8 * j + 2 * t + e1] += v;
    }
}

// db2's partial of one row tile: column col's sum over the 64 rows of g,
// eight independent chains
__device__ __forceinline__ float col_sum(const uint8_t* G, int col) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r % 8] += ld(G, r, col);
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// DX: a block takes one row tile and walks every hidden tile:
//   a = x W1[:, tile] (warpgroup 0), dh = g W2[tile, :]^T (warpgroup 1),
//   da = dh GELU'(a + b1) m1, dx[:, NOUT w ..] += da W1[NOUT w .., tile]^T.
template <int D>
__device__ void body_dx(const Params& p, uint8_t* sm, Ring<Cfg<DX, D>::NSTAGE> ring,
                        uint64_t* xfull, uint64_t* gfull) {
  using C = Cfg<DX, D>;
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;
  const long row0 = (long)blockIdx.x * ROWS;
  const uint8_t* X = sm + C::X;
  uint8_t* G = sm + C::G;
  float* Q = reinterpret_cast<float*>(sm + C::Q);
  const uint32_t k0 = (uint32_t)p.seed[0], k1 = (uint32_t)p.seed[1];
  const int items = p.Hd / HT;
  Walk<DX, D> walk(p, ring, items * C::PER_ITEM);
  if (threadIdx.x == 0) {
    load_tile<D>(&p.m_x, sm + C::X, xfull, row0);
    load_tile<D>(&p.m_dy, G, gfull, row0);
  }

  float dx[C::NOUT / 2];
  zero(dx);
  for (int c = 0; c < items; ++c) {
    // the scores: warpgroup 0 a = x W1^T-slabs, warpgroup 1 dh = g W2-slabs
    float s[HT / 2];
    zero(s);
    for (int j = 0; j < C::NSLAB; ++j) {
      if (c == 0) {  // the slab's first use: wait for it (and mask dy)
        mbar_wait(w == 0 ? &xfull[j] : &gfull[j], 0);
        if (w == 1 && p.thr) {
          mask_g<D>(G, j, row0, p, k0, k1, tid);
          bar_sync(2, 128);
        }
      }
      const uint8_t* st = walk.wait();
      uint32_t ab[4][4], as[4][4];
      row_frags(w == 0 ? X : G, j, ra, t, ab, as);
      fence_frag(ab);
      fence_frag(as);
      wg_fence();
      mma3_rs<HT, 4>(s, ab, as, desc_sw128(st + 2 * w * SLAB_BYTES),
                     desc_sw128(st + (2 * w + 1) * SLAB_BYTES), HT);
      wg_commit();
      walk.fill();
      wg_wait<0>();
      fence_acc(s);
      walk.release();
    }

    // warpgroup 0 puts a into Q (fragment order: thread i of either
    // warpgroup holds the same (row, unit) elements); warpgroup 1 forms
    // da = dh GELU'(a + b1) m1 there
    __syncthreads();  // every thread has read the last tile's da
    walk.fill();
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < HT / 2; ++i) Q[i * 128 + tid] = s[i];
    }
    __syncthreads();
    if (w == 1) {
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const long unit = (long)HT * c + 8 * j + 2 * t;
          const float2 m = mask1(row0 + ra + 8 * e2, unit, p, k0, k1);
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = 4 * j + 2 * e2 + e1;
            float h, d;
            gelu_both(Q[i * 128 + tid] + p.b1[unit + e1], h, d);
            Q[i * 128 + tid] = s[i] * d * (e1 ? m.y : m.x);
          }
        }
    }
    __syncthreads();
    float da[HT / 2];
#pragma unroll
    for (int i = 0; i < HT / 2; ++i) da[i] = Q[i * 128 + tid];

    // dx columns NOUT w .. NOUT w + NOUT - 1 += da W1k: a fresh accumulator
    // for the tile, folded into dx with f32 adds
    float part[C::NOUT / 2];
    zero(part);
    for (int f = 0; f < C::OUT_STAGES; ++f) {
      const uint8_t* st = walk.wait();
      bool used = false;
#pragma unroll
      for (int v = 0; v < C::OUT_PER; ++v) {
        const int unit = f * C::OUT_PER + v, ks = unit / 2;
        if (unit % 2 != w) continue;
        uint32_t fb[4][4], fs[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_as_a(da, 4 * ks + kk, fb[kk], fs[kk]);
        fence_frag(fb);
        fence_frag(fs);
        wg_fence();
        mma3_rs<C::NOUT, 4>(part, fb, fs, desc_sw128(st + v * C::UNIT),
                            desc_sw128(st + v * C::UNIT + C::UNIT / 2), C::NOUT);
        wg_commit();
        wg_wait<0>();
        fence_acc(part);
        used = true;
      }
      if (used) walk.fill();
      walk.release();
    }
#pragma unroll
    for (int i = 0; i < C::NOUT / 2; ++i) dx[i] += part[i];
  }

  // rows past N are not stored
#pragma unroll
  for (int j = 0; j < C::NOUT / 8; ++j) {
    const int col = C::NOUT * w + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = row0 + ra + 8 * half;
      if (row < p.N)
        *reinterpret_cast<float2*>(p.dx + row * D + col) =
            make_float2(dx[4 * j + 2 * half], dx[4 * j + 2 * half + 1]);
    }
  }
}

// DX1: block b takes the row-tile pairs b, b + G, ... (G blocks);
// warpgroup w takes tile 2 pair + w of each and walks every hidden tile:
// a = x W1[:, tile] and dh = g W2[tile, :]^T from its own x and dy tiles
// (dy masked in place at the first hidden tile), da = dh GELU'(a + b1) m1
// in registers, dx += da W1[:, tile]^T in a fresh accumulator per tile.
// One ring of weight stages serves both warpgroups, so every weight slab
// read from L2 feeds 128 rows; the next pair's tiles load while the last
// hidden tile's dx products run.
template <int D>
__device__ void body_dx1(const Params& p, uint8_t* sm, Ring<Cfg<DX1, D>::NSTAGE> ring,
                         uint64_t* xfull, uint64_t* gfull) {
  using C = Cfg<DX1, D>;
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;
  uint8_t* X = sm + C::X + 2 * w * C::TILE;
  uint8_t* G = sm + C::G + 2 * w * C::TILE;
  xfull += MAX_SLABS * w;
  gfull += MAX_SLABS * w;
  const int pairs = (p.N + 2 * ROWS - 1) / (2 * ROWS);
  const int b = blockIdx.x, nb = gridDim.x;
  const int mine = b < pairs ? (pairs - b + nb - 1) / nb : 0;
  const uint32_t k0 = (uint32_t)p.seed[0], k1 = (uint32_t)p.seed[1];
  const int items = p.Hd / HT;
  Walk<DX1, D> walk(p, ring, mine * items * C::PER_ITEM);
  auto tile_row = [&](int k) { return (long)(2 * (b + k * nb) + w) * ROWS; };
  if (tid == 0 && mine > 0) {
    load_tile<D>(&p.m_x, X, xfull, tile_row(0));
    load_tile<D>(&p.m_dy, G, gfull, tile_row(0));
  }

  for (int k = 0; k < mine; ++k) {
    const long row0 = tile_row(k);
    float dx[D / 2];
    zero(dx);
    for (int c = 0; c < items; ++c) {
      float a[HT / 2], dh[HT / 2];
      zero(a);
      zero(dh);
      for (int j = 0; j < C::NSLAB; ++j) {
        if (c == 0) {  // the slabs' first use: wait for them, mask dy
          mbar_wait(&xfull[j], k & 1);
          mbar_wait(&gfull[j], k & 1);
          if (p.thr) {
            mask_g<D>(G, j, row0, p, k0, k1, tid);
            bar_sync(1 + w, 128);
          }
        }
        const uint8_t* st = walk.wait();
        uint32_t xb[4][4], xs[4][4], gb[4][4], gs[4][4];
        row_frags(X, j, ra, t, xb, xs);
        row_frags(G, j, ra, t, gb, gs);
        fence_frag(xb);
        fence_frag(xs);
        fence_frag(gb);
        fence_frag(gs);
        wg_fence();
        mma3_rs<HT, 4>(a, xb, xs, desc_sw128(st), desc_sw128(st + SLAB_BYTES), HT);
        mma3_rs<HT, 4>(dh, gb, gs, desc_sw128(st + 2 * SLAB_BYTES),
                       desc_sw128(st + 3 * SLAB_BYTES), HT);
        wg_commit();
        walk.fill();
        wg_wait<0>();
        fence_acc(a);
        fence_acc(dh);
        walk.release();
      }
      if (c == items - 1 && k + 1 < mine) {  // the tiles are read: load the next pair's
        bar_sync(1 + w, 128);
        if (tid == 0) {
          load_tile<D>(&p.m_x, X, xfull, tile_row(k + 1));
          load_tile<D>(&p.m_dy, G, gfull, tile_row(k + 1));
        }
      }
      walk.fill();
      // da = dh GELU'(a + b1) m1, in place of dh
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const long unit = (long)HT * c + 8 * j + 2 * t;
          const float2 m = mask1(row0 + ra + 8 * e2, unit, p, k0, k1);
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = 4 * j + 2 * e2 + e1;
            float h, d;
            gelu_both(a[i] + p.b1[unit + e1], h, d);
            dh[i] *= d * (e1 ? m.y : m.x);
          }
        }

      float part[D / 2];
      zero(part);
      for (int f = 0; f < C::OUT_STAGES; ++f) {
        const uint8_t* st = walk.wait();
#pragma unroll
        for (int v = 0; v < C::OUT_PER; ++v) {
          const int ks = f * C::OUT_PER + v;
          uint32_t fb[4][4], fs[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc_as_a(dh, 4 * ks + kk, fb[kk], fs[kk]);
          fence_frag(fb);
          fence_frag(fs);
          wg_fence();
          mma3_rs<D, 4>(part, fb, fs, desc_sw128(st + v * C::UNIT),
                        desc_sw128(st + v * C::UNIT + C::UNIT / 2), D);
          wg_commit();
          wg_wait<0>();
          fence_acc(part);
        }
        walk.fill();
        walk.release();
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dx[i] += part[i];
    }

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const long row = row0 + ra + 8 * h2;
        if (row < p.N)
          *reinterpret_cast<float2*>(p.dx + row * D + col) =
              make_float2(dx[4 * j + 2 * h2], dx[4 * j + 2 * h2 + 1]);
      }
    }
  }
}

// DW: a block takes hidden tile blockIdx.x and row tiles blockIdx.y,
// blockIdx.y + slots, ...; per row tile
//   a = x W1[:, tile] (warpgroup 0), dh = g W2[tile, :]^T (warpgroup 1),
//   then, a traded through Q, h = GELU(a + b1) m1 (warpgroup 0) and
//   da = dh GELU'(a + b1) m1 (warpgroup 1); dW2[tile, :]^T += g^T h and
//   dW1[:, tile] += x^T da,
// each M-tile of 64 columns of D in a fresh accumulator folded into the
// block's own; db1 from da, db2 from g (hidden tile 0's blocks).
template <int D>
__device__ void body_dw(const Params& p, uint8_t* sm, Ring<Cfg<DW, D>::NSTAGE> ring,
                        uint64_t* xfull, uint64_t* gfull, float* db1s) {
  using C = Cfg<DW, D>;
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;
  const int c = blockIdx.x, slot = blockIdx.y;
  uint8_t* X = sm + C::X;
  uint8_t* G = sm + C::G;
  float* Q = reinterpret_cast<float*>(sm + C::Q);
  uint8_t* Bb = sm + C::B;
  uint8_t* Bs = Bb + Q_BYTES;
  const uint32_t k0 = (uint32_t)p.seed[0], k1 = (uint32_t)p.seed[1];
  const int tiles = (p.N + ROWS - 1) / ROWS;
  const int items = slot < tiles ? (tiles - slot + p.slots - 1) / p.slots : 0;
  Walk<DW, D> walk(p, ring, items * C::PER_ITEM);
  if (threadIdx.x == 0 && items > 0) {
    load_tile<D>(&p.m_x, X, xfull, (long)slot * ROWS);
    load_tile<D>(&p.m_dy, G, gfull, (long)slot * ROWS);
  }

  // acc[o][q]: output o (0: dW2^T, 1: dW1) M-tile i = 2 q + (w + o) % 2
  float acc[2][C::NT][HT / 2];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int q = 0; q < C::NT; ++q) zero(acc[o][q]);
  float db2 = 0.f;
  const uint64_t bb = desc_sw128(Bb), bs = desc_sw128(Bs);

  for (int it = 0; it < items; ++it) {
    const long row0 = (long)(slot + it * p.slots) * ROWS;
    const uint32_t ph = it & 1;
    float s[HT / 2];  // warpgroup 0: a; warpgroup 1: dh, then da
    zero(s);
    for (int j = 0; j < 2 * C::NSLAB; ++j) {
      const int sl = j / 2;
      const bool mine = j % 2 == w;
      if (mine) {
        mbar_wait(w == 0 ? &xfull[sl] : &gfull[sl], ph);
        if (w == 1 && p.thr) {
          mask_g<D>(G, sl, row0, p, k0, k1, tid);
          bar_sync(2, 128);
        }
      }
      const uint8_t* st = walk.wait();
      if (mine) {
        uint32_t ab[4][4], as[4][4];
        row_frags(w == 0 ? X : G, sl, ra, t, ab, as);
        fence_frag(ab);
        fence_frag(as);
        wg_fence();
        mma3_rs<HT, 4>(s, ab, as, desc_sw128(st), desc_sw128(st + SLAB_BYTES), HT);
        wg_commit();
        walk.fill();
        wg_wait<0>();
        fence_acc(s);
      }
      walk.release();
    }
    walk.fill();  // the next row tile's weight slabs, while this one finishes

    // warpgroup 0: h^T, split, into B and q = GELU'(a + b1) m1 into Q
    // (fragment order: thread i of either warpgroup holds the same (row,
    // unit) elements); then warpgroup 1: da = dh q into Q, and db1
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int unit = HT * c + 8 * j + 2 * t;
          const float2 m = mask1(row0 + ra + 8 * e2, unit, p, k0, k1);
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = 4 * j + 2 * e2 + e1;
            float h, d;
            gelu_both(s[i] + p.b1[unit + e1], h, d);
            const float mv = e1 ? m.y : m.x;
            store_t(Bb, Bs, j, e2, e1, ra, t, h * mv);
            Q[i * 128 + tid] = d * mv;
          }
        }
      fence_proxy_shared();
    }
    __syncthreads();  // h^T and q are written; g is masked
    if (w == 1) {
#pragma unroll
      for (int i = 0; i < HT / 2; ++i) {
        s[i] *= Q[i * 128 + tid];
        Q[i * 128 + tid] = s[i];
      }
      col_sums(s, db1s + wi * HT, g, t);
    }
    if (c == 0 && threadIdx.x < D) db2 += col_sum(G, threadIdx.x);

    // dW2^T's M-tiles: A = g^T, B = h^T
#pragma unroll
    for (int q = 0; q < C::NT; ++q) {
      const int i = 2 * q + (w & 1);
      if (i >= D / 64) continue;
      float fresh[HT / 2];
      tile_product<C::KB>(fresh, G, 64 * i, bb, bs, wi, g, t);
#pragma unroll
      for (int e = 0; e < HT / 2; ++e) acc[0][q][e] += fresh[e];
    }
    __syncthreads();  // g and h^T are read; da is in Q
    if (threadIdx.x == 0 && it + 1 < items)
      load_tile<D>(&p.m_dy, G, gfull, row0 + (long)p.slots * ROWS);

    // da^T, split, into B: element i of warpgroup 1's thread jt is row
    // 16 (jt / 32) + (jt % 32) / 4 + 8 ((i % 4) / 2), unit 8 (i / 4) + 2 (jt % 4) + i % 2
    for (int idx = threadIdx.x; idx < ROWS * HT; idx += THREADS) {
      const int i = idx / 128, jt = idx % 128;
      store_t(Bb, Bs, i >> 2, (i & 3) >> 1, i & 1, 16 * (jt / 32) + (jt % 32) / 4, jt % 4,
              Q[idx]);
    }
    fence_proxy_shared();
    __syncthreads();

    // dW1's M-tiles: A = x^T, B = da^T
#pragma unroll
    for (int q = 0; q < C::NT; ++q) {
      const int i = 2 * q + ((w + 1) & 1);
      if (i >= D / 64) continue;
      float fresh[HT / 2];
      tile_product<C::KB>(fresh, X, 64 * i, bb, bs, wi, g, t);
#pragma unroll
      for (int e = 0; e < HT / 2; ++e) acc[1][q][e] += fresh[e];
    }
    __syncthreads();  // x and da^T are read
    if (threadIdx.x == 0 && it + 1 < items)
      load_tile<D>(&p.m_x, X, xfull, row0 + (long)p.slots * ROWS);
  }

  // the block's partials: dW1 (D, Hd) and dW2 (Hd, D) of its hidden tile,
  // db1, and db2 from hidden tile 0
  const long pw = (long)slot * p.pstride;
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int q = 0; q < C::NT; ++q) {
      const int i = 2 * q + ((w + o) & 1);
      if (i >= D / 64) continue;
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int m = 64 * i + ra + 8 * e2;  // a column of D
          const int unit = HT * c + 8 * j + 2 * t;
          const float v0 = acc[o][q][4 * j + 2 * e2], v1 = acc[o][q][4 * j + 2 * e2 + 1];
          if (o == 1) {
            *reinterpret_cast<float2*>(p.dw1p + pw + (long)m * p.Hd + unit) = make_float2(v0, v1);
          } else {
            p.dw2p[pw + (long)unit * D + m] = v0;
            p.dw2p[pw + (long)(unit + 1) * D + m] = v1;
          }
        }
    }
  __syncthreads();
  if (threadIdx.x < HT)
    p.db1p[(long)slot * p.pstride + HT * c + threadIdx.x] =
        (db1s[threadIdx.x] + db1s[HT + threadIdx.x]) +
        (db1s[2 * HT + threadIdx.x] + db1s[3 * HT + threadIdx.x]);
  if (c == 0 && threadIdx.x < D) p.db2p[(long)slot * p.pstride + threadIdx.x] = db2;
}

// DW1 (D 64): a block takes hidden tile blockIdx.x, whose W1^T and W2 rows
// stay resident, and row slot blockIdx.y; its warpgroup w takes every
// other row tile of the slot alone: a and dh, h and da in registers, h^T
// then da^T through its own B tile for dW2^T += g^T h and dW1 += x^T da in
// fresh accumulators, and its own db1 and db2 sums; the two warpgroups'
// partials are added in a fixed order at the end.
template <int D>
__device__ void body_dw1(const Params& p, uint8_t* sm, uint64_t* bars, float* db1s) {
  using C = Cfg<DW1, D>;
  static_assert(D == 64, "DW1 holds one M-tile of each output");
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;
  const int c = blockIdx.x, slot = blockIdx.y;
  uint8_t* half = sm + w * C::HALF;
  uint8_t* X = half + C::X;
  uint8_t* G = half + C::G;
  uint8_t* Bb = half + C::B;
  uint8_t* Bs = Bb + Q_BYTES;
  const uint8_t* Wt = sm + C::W;  // W1^T tile: 2 slabs big, 2 small; then W2's
  uint64_t* wbar = bars;
  uint64_t* xfull = bars + 1 + 2 * MAX_SLABS * w;
  uint64_t* gfull = xfull + MAX_SLABS;
  float* sums = db1s + 4 * HT * w + wi * HT;
  const uint32_t k0 = (uint32_t)p.seed[0], k1 = (uint32_t)p.seed[1];
  const int tiles = (p.N + ROWS - 1) / ROWS;
  const int items = slot < tiles ? (tiles - slot + p.slots - 1) / p.slots : 0;
  const int mine = items > w ? (items - w + 1) / 2 : 0;  // the slot's tiles w, w + 2, ...
  const bool producer = tid == 0;
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, C::W_BYTES);
    for (int s = 0; s < C::NSLAB; ++s)
      for (int h = 0; h < 2; ++h) {
        tma_3d((uint8_t*)Wt + (h * C::NSLAB + s) * SLAB_BYTES, &p.m_w1t, wbar, KS * s, HT * c, h);
        tma_3d((uint8_t*)Wt + ((2 + h) * C::NSLAB + s) * SLAB_BYTES, &p.m_w2, wbar, KS * s,
               HT * c, h);
      }
  }
  if (producer && mine > 0) {
    const long r0 = (long)(slot + w * p.slots) * ROWS;
    load_tile<D>(&p.m_x, X, xfull, r0);
    load_tile<D>(&p.m_dy, G, gfull, r0);
  }
  mbar_wait(wbar, 0);

  float acc2[HT / 2], acc1[HT / 2], db2 = 0.f;
  zero(acc2);
  zero(acc1);
  const uint64_t bb = desc_sw128(Bb), bs = desc_sw128(Bs);
  for (int it = 0; it < mine; ++it) {
    const long row0 = (long)(slot + (2 * it + w) * p.slots) * ROWS;
    const uint32_t ph = it & 1;
    float a[HT / 2], dh[HT / 2];
    zero(a);
    zero(dh);
    for (int sl = 0; sl < C::NSLAB; ++sl) {
      mbar_wait(&xfull[sl], ph);
      mbar_wait(&gfull[sl], ph);
      if (p.thr) {
        mask_g<D>(G, sl, row0, p, k0, k1, tid);
        bar_sync(1 + w, 128);
      }
      uint32_t xb[4][4], xs[4][4], gb[4][4], gs[4][4];
      row_frags(X, sl, ra, t, xb, xs);
      row_frags(G, sl, ra, t, gb, gs);
      fence_frag(xb);
      fence_frag(xs);
      fence_frag(gb);
      fence_frag(gs);
      wg_fence();
      mma3_rs<HT, 4>(a, xb, xs, desc_sw128(Wt + sl * SLAB_BYTES),
                     desc_sw128(Wt + (C::NSLAB + sl) * SLAB_BYTES), HT);
      mma3_rs<HT, 4>(dh, gb, gs, desc_sw128(Wt + (2 * C::NSLAB + sl) * SLAB_BYTES),
                     desc_sw128(Wt + (3 * C::NSLAB + sl) * SLAB_BYTES), HT);
      wg_commit();
      wg_wait<0>();
      fence_acc(a);
      fence_acc(dh);
    }
    // h^T into B; da in place of dh
#pragma unroll
    for (int j = 0; j < HT / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int unit = HT * c + 8 * j + 2 * t;
        const float2 m = mask1(row0 + ra + 8 * e2, unit, p, k0, k1);
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int i = 4 * j + 2 * e2 + e1;
          float h, d;
          gelu_both(a[i] + p.b1[unit + e1], h, d);
          const float mv = e1 ? m.y : m.x;
          store_t(Bb, Bs, j, e2, e1, ra, t, h * mv);
          dh[i] *= d * mv;
        }
      }
    col_sums(dh, sums, g, t);
    if (c == 0 && tid < D) db2 += col_sum(G, tid);
    fence_proxy_shared();
    bar_sync(1 + w, 128);

    float fresh[HT / 2];
    tile_product<C::KB>(fresh, G, 0, bb, bs, wi, g, t);
#pragma unroll
    for (int e = 0; e < HT / 2; ++e) acc2[e] += fresh[e];
    bar_sync(1 + w, 128);  // g and h^T are read
    const bool more = it + 1 < mine;
    const long next = row0 + 2L * p.slots * ROWS;
    if (producer && more) load_tile<D>(&p.m_dy, G, gfull, next);
#pragma unroll
    for (int j = 0; j < HT / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) store_t(Bb, Bs, j, e2, e1, ra, t, dh[4 * j + 2 * e2 + e1]);
    fence_proxy_shared();
    bar_sync(1 + w, 128);
    tile_product<C::KB>(fresh, X, 0, bb, bs, wi, g, t);
#pragma unroll
    for (int e = 0; e < HT / 2; ++e) acc1[e] += fresh[e];
    bar_sync(1 + w, 128);  // x and da^T are read
    if (producer && more) load_tile<D>(&p.m_x, X, xfull, next);
  }

  // warpgroup 1's partials through shared memory (the first half's X and
  // G), added to warpgroup 0's in a fixed order
  __syncthreads();
  float* park = reinterpret_cast<float*>(sm);
  if (w == 1) {
#pragma unroll
    for (int e = 0; e < HT / 2; ++e) {
      park[e * 128 + tid] = acc2[e];
      park[(HT / 2 + e) * 128 + tid] = acc1[e];
    }
    if (c == 0 && tid < D) park[HT * 128 + tid] = db2;
  }
  __syncthreads();
  if (w == 0) {
    const long pw = (long)slot * p.pstride;
#pragma unroll
    for (int j = 0; j < HT / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int i = 4 * j + 2 * e2, m = ra + 8 * e2, unit = HT * c + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(p.dw1p + pw + (long)m * p.Hd + unit) =
            make_float2(acc1[i] + park[(HT / 2 + i) * 128 + tid],
                        acc1[i + 1] + park[(HT / 2 + i + 1) * 128 + tid]);
        p.dw2p[pw + (long)unit * D + m] = acc2[i] + park[i * 128 + tid];
        p.dw2p[pw + (long)(unit + 1) * D + m] = acc2[i + 1] + park[(i + 1) * 128 + tid];
      }
    if (tid < HT) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s0 += db1s[k * HT + tid];
        s1 += db1s[4 * HT + k * HT + tid];
      }
      p.db1p[(long)slot * p.pstride + HT * c + tid] = s0 + s1;
    }
    if (c == 0 && tid < D) p.db2p[(long)slot * p.pstride + tid] = db2 + park[HT * 128 + tid];
  }
}

// DWS: a block takes hidden tile blockIdx.x and row tiles blockIdx.y,
// blockIdx.y + slots, ...; warpgroup 0 owns x: a = x W1[:, tile], h and
// q = GELU'(a + b1) m1 (h^T, split, into Bh), then da = dh q (da^T into Bd)
// and dW1[:, tile] += x^T da; warpgroup 1 owns g: dh = g W2[tile, :]^T (dh
// into Q), then dW2[tile, :]^T += g^T h.  Each warpgroup streams its own
// weight's slabs and reloads its own tile as soon as it is done with it;
// the two meet at two barriers a row tile (Q and Bh free; h^T and dh
// written).  Each output M-tile's products of a row tile go into a fresh
// accumulator folded into the warpgroup's own.
template <int D>
__device__ void body_dws(const Params& p, uint8_t* sm, Ring<Cfg<DWS, D>::NSTAGE> ring,
                         uint64_t* tfull, float* db1s) {
  using C = Cfg<DWS, D>;
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * wi + g;
  const int c = blockIdx.x, slot = blockIdx.y;
  uint8_t* T = sm + (w == 0 ? C::X : C::G);  // x (warpgroup 0) or dy, then g (warpgroup 1)
  float* Q = reinterpret_cast<float*>(sm + C::Q);
  uint8_t* Bh = sm + C::B;
  uint8_t* Bd = Bh + B_BYTES;
  const uint32_t k0 = (uint32_t)p.seed[0], k1 = (uint32_t)p.seed[1];
  const int tiles = (p.N + ROWS - 1) / ROWS;
  const int items = slot < tiles ? (tiles - slot + p.slots - 1) / p.slots : 0;
  Walk<DWS, D> walk(p, ring, items * C::PER_ITEM);
  const CUtensorMap* own = w == 0 ? &p.m_x : &p.m_dy;
  if (tid == 0 && items > 0) load_tile<D>(own, T, tfull, (long)slot * ROWS);

  float acc[D / 64][HT / 2];  // the warpgroup's output: dW1 (w 0) or dW2^T (w 1), by M-tile
#pragma unroll
  for (int i = 0; i < D / 64; ++i) zero(acc[i]);
  float db2 = 0.f;
  const uint64_t bb = desc_sw128(w == 0 ? Bd : Bh), bs = bb + (Q_BYTES >> 4);

  for (int it = 0; it < items; ++it) {
    const long row0 = (long)(slot + it * p.slots) * ROWS;
    float s[HT / 2];  // warpgroup 0: a, then q, then da; warpgroup 1: dh
    zero(s);
    for (int j = 0; j < C::NSLAB; ++j) {
      mbar_wait(&tfull[j], it & 1);
      if (w == 1 && p.thr) {
        mask_g<D>(T, j, row0, p, k0, k1, tid);
        bar_sync(2, 128);
      }
      const uint8_t* st = walk.wait();
      uint32_t ab[4][4], as[4][4];
      row_frags(T, j, ra, t, ab, as);
      fence_frag(ab);
      fence_frag(as);
      wg_fence();
      mma3_rs<HT, 4>(s, ab, as, desc_sw128(st), desc_sw128(st + SLAB_BYTES), HT);
      wg_commit();
      walk.fill();
      wg_wait<0>();
      fence_acc(s);
      walk.release();
    }
    walk.fill();

    __syncthreads();  // Q and Bh are free: the last row tile's dh and h^T are read
    if (w == 1) {
#pragma unroll
      for (int i = 0; i < HT / 2; ++i) Q[i * 128 + tid] = s[i];
    } else {
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int unit = HT * c + 8 * j + 2 * t;
          const float2 m = mask1(row0 + ra + 8 * e2, unit, p, k0, k1);
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = 4 * j + 2 * e2 + e1;
            float h, d;
            gelu_both(s[i] + p.b1[unit + e1], h, d);
            const float mv = e1 ? m.y : m.x;
            store_t(Bh, Bh + Q_BYTES, j, e2, e1, ra, t, h * mv);
            s[i] = d * mv;
          }
        }
      fence_proxy_shared();
    }
    __syncthreads();  // h^T and dh are written

    if (w == 0) {  // da = dh q, da^T into Bd, db1; then dW1 += x^T da
#pragma unroll
      for (int j = 0; j < HT / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = 4 * j + 2 * e2 + e1;
            s[i] *= Q[i * 128 + tid];
            store_t(Bd, Bd + Q_BYTES, j, e2, e1, ra, t, s[i]);
          }
      col_sums(s, db1s + wi * HT, g, t);
      fence_proxy_shared();
      bar_sync(1, 128);
    } else if (c == 0 && tid < D) {
      db2 += col_sum(T, tid);
    }
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      float fresh[HT / 2];
      tile_product<C::KB>(fresh, T, 64 * i, bb, bs, wi, g, t);
#pragma unroll
      for (int e = 0; e < HT / 2; ++e) acc[i][e] += fresh[e];
    }
    bar_sync(1 + w, 128);  // the warpgroup's tile is read
    if (tid == 0 && it + 1 < items) load_tile<D>(own, T, tfull, row0 + (long)p.slots * ROWS);
  }

  const long pw = (long)slot * p.pstride;
#pragma unroll
  for (int i = 0; i < D / 64; ++i)
#pragma unroll
    for (int j = 0; j < HT / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int m = 64 * i + ra + 8 * e2;  // a column of D
        const int unit = HT * c + 8 * j + 2 * t;
        const float v0 = acc[i][4 * j + 2 * e2], v1 = acc[i][4 * j + 2 * e2 + 1];
        if (w == 0) {
          *reinterpret_cast<float2*>(p.dw1p + pw + (long)m * p.Hd + unit) = make_float2(v0, v1);
        } else {
          p.dw2p[pw + (long)unit * D + m] = v0;
          p.dw2p[pw + (long)(unit + 1) * D + m] = v1;
        }
      }
  __syncthreads();
  if (threadIdx.x < HT)
    p.db1p[(long)slot * p.pstride + HT * c + threadIdx.x] =
        (db1s[threadIdx.x] + db1s[HT + threadIdx.x]) +
        (db1s[2 * HT + threadIdx.x] + db1s[3 * HT + threadIdx.x]);
  if (w == 1 && c == 0 && tid < D) p.db2p[(long)slot * p.pstride + tid] = db2;
}

template <int KIND, int D>
__global__ void __launch_bounds__(THREADS, 1) mlp_bwd_tf32x3(const __grid_constant__ Params p) {
  using C = Cfg<KIND, D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  float* db1s = reinterpret_cast<float*>(base + 1024);
  uint8_t* sm = base + C::HEAD;
  const int w = warpgroup();
  if constexpr (KIND == DW1) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 1 + 4 * MAX_SLABS; ++i) mbar_init(&bars[i], 1);
      mbar_init_fence();
    }
    for (int i = threadIdx.x; i < 8 * HT; i += THREADS) db1s[i] = 0.f;
    __syncthreads();
    body_dw1<D>(p, sm, bars, db1s);
  } else {
    // rings: full[MAX_STAGES], empty[MAX_STAGES] for each warpgroup
    // (RING_PER_WG) or the block; then the x and dy slab barriers
    Ring<C::NSTAGE> r;
    r.full = bars + 2 * MAX_STAGES * (C::RING_PER_WG ? w : 0);
    r.empty = r.full + MAX_STAGES;
    r.stages = sm + C::FIXED + (C::RING_PER_WG ? w * C::NSTAGE * C::STAGE : 0);
    r.bytes = C::STAGE;
    // x and dy slab barriers: DX1's warpgroup w at xfull + 8 w and gfull + 8 w
    uint64_t* xfull = bars + 4 * MAX_STAGES;
    uint64_t* gfull = xfull + 2 * MAX_SLABS;
    if (threadIdx.x == 0) {
      for (int gr = 0; gr < (C::RING_PER_WG ? 2 : 1); ++gr)
        for (int s = 0; s < C::NSTAGE; ++s) {
          mbar_init(&bars[2 * MAX_STAGES * gr + s], 1);
          mbar_init(&bars[2 * MAX_STAGES * gr + MAX_STAGES + s], C::RING_PER_WG ? 4 : THREADS / 32);
        }
      for (int s = 0; s < 4 * MAX_SLABS; ++s) mbar_init(&xfull[s], 1);
      mbar_init_fence();
    }
    if constexpr (KIND == DW || KIND == DWS)
      for (int i = threadIdx.x; i < (C::HEAD - 1024) / 4; i += THREADS) db1s[i] = 0.f;
    __syncthreads();
    if constexpr (KIND == DX)
      body_dx<D>(p, sm, r, xfull, gfull);
    else if constexpr (KIND == DW)
      body_dw<D>(p, sm, r, xfull, gfull, db1s);
    else if constexpr (KIND == DWS)
      body_dws<D>(p, sm, r, w == 0 ? xfull : gfull, db1s);
    else
      body_dx1<D>(p, sm, r, xfull, gfull);
  }
}

// W1^T (2, Hd, D), W2 (2, Hd, D) and W1 with its hidden units in kpos
// order (2, D, Hd), each big then small, from w1 (D, Hd) and w2 (Hd, D)
__global__ void mlp_bwd_pack(const float* __restrict__ w1, const float* __restrict__ w2,
                             float* __restrict__ pk, int D, int Hd) {
  const long n = (long)D * Hd;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int d = (int)(i / Hd), u = (int)(i % Hd);
    float b, s;
    split(w1[i], b, s);
    pk[(long)u * D + d] = b;
    pk[n + (long)u * D + d] = s;
    pk[4 * n + (long)d * Hd + kpos(u)] = b;
    pk[5 * n + (long)d * Hd + kpos(u)] = s;
    split(w2[i], b, s);
    pk[2 * n + i] = b;
    pk[3 * n + i] = s;
  }
}

// grads[e] = the slots' partials at e summed in slot order: dW1, dW2, db1
// and db2 of the whole batch (total floats)
__global__ void mlp_bwd_sum(const float* __restrict__ part, float* __restrict__ grads, long total,
                            int slots) {
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slots; ++k) s += part[k * total + e];
    grads[e] = s;
  }
}

// kind 0: the dx kernel of width D; 1: the weight-partial kernel
template <int D>
const void* kernel_of_d(int kind) {
  return kind == 0 ? (const void*)mlp_bwd_tf32x3<dx_kind(D), D>
                   : (const void*)mlp_bwd_tf32x3<dw_kind(D), D>;
}

// the widths of this body (384 and 768: namespace chunk)
bool width_ok(int D) { return D == 64 || D == 128 || D == 192 || D == 256; }

const void* kernel_of(int kind, int D) {
  switch (D) {
    case 64: return kernel_of_d<64>(kind);
    case 128: return kernel_of_d<128>(kind);
    case 192: return kernel_of_d<192>(kind);
    default: return kernel_of_d<256>(kind);
  }
}

template <int D>
int smem_of_d(int kind) {
  return kind == 0 ? Cfg<dx_kind(D), D>::SMEM : Cfg<dw_kind(D), D>::SMEM;
}

int smem_of(int kind, int D) {
  switch (D) {
    case 64: return smem_of_d<64>(kind);
    case 128: return smem_of_d<128>(kind);
    case 192: return smem_of_d<192>(kind);
    default: return smem_of_d<256>(kind);
  }
}

template <int KIND, int D>
int launch_kind(const Params& P, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Cfg<KIND, D>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_tf32x3<KIND, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_tf32x3<KIND, D><<<grid, THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(Params& P, const float* x, const float* dy, const float* pk, cudaStream_t stream) {
  constexpr int KX = dx_kind(D), KW = dw_kind(D);
  const int N = P.N, Hd = P.Hd;
  const cuuint64_t xd[3] = {(cuuint64_t)D, (cuuint64_t)N, 1};
  const cuuint64_t xs[2] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4};
  const cuuint32_t xb[3] = {KS, ROWS, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)D, (cuuint64_t)Hd, 2};
  const cuuint64_t ws[2] = {(cuuint64_t)D * 4, (cuuint64_t)Hd * D * 4};
  const cuuint32_t wb[3] = {KS, HT, 1};
  const cuuint64_t kd[3] = {(cuuint64_t)Hd, (cuuint64_t)D, 2};
  const cuuint64_t kst[2] = {(cuuint64_t)Hd * 4, (cuuint64_t)D * Hd * 4};
  const cuuint32_t kb[3] = {KS, (cuuint32_t)Cfg<KX, D>::NOUT, 1};
  const long n = (long)D * Hd;
  int rc = encode_f32(&P.m_x, x, 3, xd, xs, xb);
  if (rc == 0) rc = encode_f32(&P.m_dy, dy, 3, xd, xs, xb);
  if (rc == 0) rc = encode_f32(&P.m_w1t, pk, 3, wd, ws, wb);
  if (rc == 0) rc = encode_f32(&P.m_w2, pk + 2 * n, 3, wd, ws, wb);
  if (rc == 0) rc = encode_f32(&P.m_w1k, pk + 4 * n, 3, kd, kst, kb);
  if (rc != 0) return rc;
  const int tiles = (N + ROWS - 1) / ROWS;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const int pairs = (tiles + 1) / 2;
  rc = launch_kind<KX, D>(P, dim3((unsigned)(KX == DX1 ? (pairs < sms ? pairs : sms) : tiles)),
                          stream);
  if (rc != 0) return rc;
  return launch_kind<KW, D>(P, dim3((unsigned)(Hd / HT), (unsigned)P.slots), stream);
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// D 384 and 768: the products over row chunks, each done once
// ---------------------------------------------------------------------------

namespace chunk {

using namespace cgemm;
using bwd::gelu_both;
using bwd::word;
using philox::mask_words;

constexpr int PREP = 32;                           // rows and columns of a prep block
constexpr int DX_PARTS = 4;                        // dx's K (Hd) in parts, each a tile

// What a tile's epilogue does with its accumulators (m: the tile's rows, n:
// its columns; "chunk rows" count from the chunk's first row r0).
// - E_A   (scores, a^T): m units, n chunk rows.  a + b1 into da^T's place.
// - E_DH  (scores, dh^T): m units, n chunk rows.  dh into h^T's place
//         (`chunk_combine` then forms h^T, da^T, da and db1's sums).
// - E_DX  (dx^T over part `part` of K = Hd): m columns of D, n chunk rows,
//         into partial `part` (R, D) of dxp.
// - E_DW1 (dW1^T): m units, n columns of D.  dW1 stored, or added to.
// - E_DW2 (dW2): m units, n columns of D.  The same.
// - E_FH  (the forward's fc1): m chunk rows, n units.  h = GELU(a + b1) m1.
// - E_FY  (the forward's fc2): m chunk rows, n columns.  y = (acc + b2) m2.
enum { E_A = 0, E_DH = 1, E_DX = 2, E_DW1 = 3, E_DW2 = 4, E_FH = 5, E_FY = 6 };

struct Params {
  Job job[MAX_JOBS];
  int jobs;
  const float* b1;
  const float* b2;
  const uint32_t* bits1;  // m1's keep bits of the chunk, (R, Hd / 32) words
  const uint32_t* bits2;  // m2's (E_FY), (R, D / 32) words
  float* ht;      // (Hd, R) dh, then h^T
  float* dat;     // (Hd, R) a + b1, then da^T
  float* dxp;     // (DX_PARTS, R, D) dx's partials
  float* dw1;     // (D, Hd)
  float* dw2;     // (Hd, D)
  float* hid;     // (R, Hd) the forward's hidden chunk
  float* y;       // (N, D)
  long r0;        // the chunk's first row
  int rows;       // the chunk's rows below N
  int R, D, Hd;
  int accumulate;  // E_DW1, E_DW2: add to the gradients (every chunk after the first)
  uint32_t thr;
  float scale;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The epilogue of a tile: acc[4 j + 2 e2 + e1] is element (mb + 8 e2, nb +
// 8 j + e1) of the job's C, mb and nb the thread's first row and column;
// part is the tile's part of K.  Each pass over JB columns j issues all its
// loads before it uses any (with 8 warps an SM, a load used at once stalls
// for the whole of its latency).
constexpr int JB = 8;

__device__ __forceinline__ void epilogue(const Params& p, int epi, int part, int mb, int nb,
                                         const float (&acc)[BN / 2]) {
  // rate 0 (thr 0): every element kept, and the scale is 1
  const bool masks = p.thr != 0;
  const long R = p.R, D = p.D, Hd = p.Hd;
  const int hw = p.Hd / 32, dw = p.D / 32;  // mask words a row
  if (epi == E_A || epi == E_DH) {
    const bool a = epi == E_A;
    float* out = a ? p.dat : p.ht;
    const float bias[2] = {a ? p.b1[mb] : 0.f, a ? p.b1[mb + 8] : 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        *reinterpret_cast<float2*>(out + (long)(mb + 8 * e2) * R + nb + 8 * j) =
            make_float2(acc[4 * j + 2 * e2] + bias[e2], acc[4 * j + 2 * e2 + 1] + bias[e2]);
  } else if (epi == E_DX) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        float* row = p.dxp + (part * R + nb + 8 * j + e1) * D;
        row[mb] = acc[4 * j + e1];
        row[mb + 8] = acc[4 * j + 2 + e1];
      }
  } else if (epi == E_DW1) {
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JB) {
      float old[JB][4];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          old[jj][c] = p.accumulate
                           ? p.dw1[(long)(nb + 8 * (j0 + jj) + (c & 1)) * Hd + mb + 8 * (c >> 1)]
                           : 0.f;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          p.dw1[(long)(nb + 8 * (j0 + jj) + (c & 1)) * Hd + mb + 8 * (c >> 1)] =
              p.accumulate ? old[jj][c] + acc[4 * (j0 + jj) + c] : acc[4 * (j0 + jj) + c];
    }
  } else if (epi == E_DW2) {
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JB) {
      float2 old[JB][2];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          old[jj][e2] = p.accumulate ? *reinterpret_cast<const float2*>(
                                           p.dw2 + (long)(mb + 8 * e2) * D + nb + 8 * (j0 + jj))
                                     : make_float2(0.f, 0.f);
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int i = 4 * (j0 + jj) + 2 * e2;
          *reinterpret_cast<float2*>(p.dw2 + (long)(mb + 8 * e2) * D + nb + 8 * (j0 + jj)) =
              p.accumulate ? make_float2(old[jj][e2].x + acc[i], old[jj][e2].y + acc[i + 1])
                           : make_float2(acc[i], acc[i + 1]);
        }
    }
  } else {
    // E_FH, E_FY: rows mb, mb + 8 are chunk rows, columns units (E_FH) or
    // columns of D (E_FY); the mask's words of the tile's 192 columns, six
    // a row (column nb + 8 j is in word j / 4 of them)
    const bool fh = epi == E_FH;
    const uint32_t* bits = fh ? p.bits1 : p.bits2;
    const float* bvec = fh ? p.b1 : p.b2;
    const int words = fh ? hw : dw;
    uint32_t keep[2][BN / 32];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
      for (int q = 0; q < BN / 32; ++q)
        keep[e2][q] = masks ? bits[(long)(mb + 8 * e2) * words + (nb >> 5) + q] : ~0u;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JB) {
      float2 bias[JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        bias[jj] = *reinterpret_cast<const float2*>(bvec + nb + 8 * (j0 + jj));
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int j = j0 + jj, col = nb + 8 * j;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const uint32_t w = keep[e2][j / 4];
          float v0 = acc[4 * j + 2 * e2] + bias[jj].x, v1 = acc[4 * j + 2 * e2 + 1] + bias[jj].y;
          if (fh) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          const float2 v = make_float2(v0 * ((w >> (col & 31)) & 1 ? p.scale : 0.f),
                                       v1 * ((w >> ((col + 1) & 31)) & 1 ? p.scale : 0.f));
          const long r = mb + 8 * e2;
          if (fh)
            *reinterpret_cast<float2*>(p.hid + r * Hd + col) = v;
          else if (r < p.rows)
            *reinterpret_cast<float2*>(p.y + (p.r0 + r) * D + col) = v;
        }
      }
    }
  }
}

// dst (cols, rows) = src (rows, cols)^T; with `split` the TF32 big half at
// dst and the small half rows x cols floats on.  Blocks of 32 x 8 threads,
// a 32 x 32 tile each; rows and cols multiples of 32.
__global__ void transpose_split(const float* __restrict__ src, float* __restrict__ dst, int rows,
                                int cols, int split_it) {
  __shared__ float tile[32][33];
  const int c0 = 32 * blockIdx.x, r0 = 32 * blockIdx.y;
  for (int k = threadIdx.y; k < 32; k += 8)
    tile[k][threadIdx.x] = src[(long)(r0 + k) * cols + c0 + threadIdx.x];
  __syncthreads();
  const long n = (long)rows * cols;
  for (int k = threadIdx.y; k < 32; k += 8) {
    const long at = (long)(c0 + k) * rows + r0 + threadIdx.x;
    const float v = tile[threadIdx.x][k];
    if (split_it) {
      float b, s;
      split(v, b, s);
      dst[at] = b;
      dst[n + at] = s;
    } else {
      dst[at] = v;
    }
  }
}

// A chunk's x and g = dy m2 as the products read them: x and g split, (2,
// R, D) each (B of the scores), and x^T and g^T split, (2, D, R) each (B of
// dW1 and dW2); rows at or past N are zeros.  A block takes 32 chunk rows by
// 32 columns, a Philox call for each group of four columns, and writes the
// column sums of its g (in row order) into gpart (R / 32, D), for db2.
__global__ void chunk_prep(const float* __restrict__ x, const float* __restrict__ dy,
                           const int* __restrict__ seed, float* __restrict__ xs,
                           float* __restrict__ gs, float* __restrict__ xts,
                           float* __restrict__ gts, float* __restrict__ gpart, long r0, int rows,
                           int R, int D, uint32_t thr, float scale) {
  __shared__ float xt[PREP][PREP + 1], gt[PREP][PREP + 1];
  const int tid = threadIdx.x, lr = PREP * blockIdx.y + tid / 8, c0 = PREP * blockIdx.x;
  const int col = c0 + 4 * (tid % 8);
  float xv[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
  if (lr < rows) {
    const long at = (r0 + lr) * D + col;
    const float4 a = *reinterpret_cast<const float4*>(x + at);
    const float4 d = *reinterpret_cast<const float4*>(dy + at);
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
    gv[0] = d.x, gv[1] = d.y, gv[2] = d.z, gv[3] = d.w;
    if (thr) {
      const uint4 w = mask_words(at, philox::STREAM_OUT, (uint32_t)seed[0], (uint32_t)seed[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) gv[e] *= word(w, e) >= thr ? scale : 0.f;
    }
  }
  const long RD = (long)R * D;
  float4 big, small;
  split(xv[0], big.x, small.x), split(xv[1], big.y, small.y);
  split(xv[2], big.z, small.z), split(xv[3], big.w, small.w);
  *reinterpret_cast<float4*>(xs + (long)lr * D + col) = big;
  *reinterpret_cast<float4*>(xs + RD + (long)lr * D + col) = small;
  split(gv[0], big.x, small.x), split(gv[1], big.y, small.y);
  split(gv[2], big.z, small.z), split(gv[3], big.w, small.w);
  *reinterpret_cast<float4*>(gs + (long)lr * D + col) = big;
  *reinterpret_cast<float4*>(gs + RD + (long)lr * D + col) = small;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    xt[4 * (tid % 8) + e][tid / 8] = xv[e];
    gt[4 * (tid % 8) + e][tid / 8] = gv[e];
  }
  __syncthreads();
  // transposed: column c0 + tid / 8, chunk rows 4 (tid % 8) .. + 3 of the block's
  const int c = tid / 8, rr = 4 * (tid % 8);
  const long at = (long)(c0 + c) * R + PREP * blockIdx.y + rr;
  split(xt[c][rr], big.x, small.x), split(xt[c][rr + 1], big.y, small.y);
  split(xt[c][rr + 2], big.z, small.z), split(xt[c][rr + 3], big.w, small.w);
  *reinterpret_cast<float4*>(xts + at) = big;
  *reinterpret_cast<float4*>(xts + RD + at) = small;
  split(gt[c][rr], big.x, small.x), split(gt[c][rr + 1], big.y, small.y);
  split(gt[c][rr + 2], big.z, small.z), split(gt[c][rr + 3], big.w, small.w);
  *reinterpret_cast<float4*>(gts + at) = big;
  *reinterpret_cast<float4*>(gts + RD + at) = small;
  if (tid < PREP) {
    float s = 0.f;
    for (int r = 0; r < PREP; ++r) s += gt[tid][r];
    gpart[(long)blockIdx.y * D + c0 + tid] = s;
  }
}

// db1 (Hd) and db2 (D) of a chunk: the tiles' partial sums in order, stored
// at the first chunk and added to after it.
__global__ void chunk_bias(const float* __restrict__ dapart, const float* __restrict__ gpart,
                           float* __restrict__ db1, float* __restrict__ db2, int Hd, int D,
                           int tiles32, int first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Hd) {
    float s = 0.f;
    for (int k = 0; k < tiles32; ++k) s += dapart[(long)k * Hd + i];
    db1[i] = first ? s : db1[i] + s;
  } else if (i < Hd + D) {
    const int d = i - Hd;
    float s = 0.f;
    for (int k = 0; k < tiles32; ++k) s += gpart[(long)k * D + d];
    db2[d] = first ? s : db2[d] + s;
  }
}

// dx's rows r0 .. r0 + rows - 1: its DX_PARTS partials (R, D) summed in
// order, four columns a thread
__global__ void chunk_dx_sum(const float* __restrict__ dxp, float* __restrict__ dx, long r0,
                             int rows, int R, int D) {
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= (long)rows * D) return;
  float4 s = *reinterpret_cast<const float4*>(dxp + i);
  for (int k = 1; k < DX_PARTS; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(dxp + (long)k * R * D + i);
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  *reinterpret_cast<float4*>(dx + r0 * D + i) = s;
}

// A chunk's keep bits of `width` columns from column `off` of the mask of
// `stream` and `whole` columns: word i = (r, q) of rows r < rows_all holds
// bit c % 32 for element (row0 + r, off + 32 q + c % 32), eight Philox calls
// a word; rows at or past `rows` are zeros.
__global__ void mask_bits(const int* __restrict__ seed, long row0, int rows, int rows_all,
                          int width, int whole, int off, uint32_t stream, uint32_t thr,
                          uint32_t* __restrict__ bits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int words = width / 32;
  if (i >= (long)rows_all * words) return;
  const long r = i / words;
  uint32_t v = 0;
  if (r < rows) {
    const uint32_t k0 = (uint32_t)seed[0], k1 = (uint32_t)seed[1];
    const long e = (row0 + r) * whole + off + 32 * (i % words);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 w = mask_words(e + 4 * q, stream, k0, k1);
      v |= (uint32_t)(w.x >= thr) << (4 * q) | (uint32_t)(w.y >= thr) << (4 * q + 1) |
           (uint32_t)(w.z >= thr) << (4 * q + 2) | (uint32_t)(w.w >= thr) << (4 * q + 3);
    }
  }
  bits[i] = v;
}

// From the scores' a + b1 (in dat) and dh (in ht), (Hd, R) both: h^T =
// GELU(a) m1 in place of dh, da^T = dh GELU'(a) m1 in place of a, da split
// into das (2, R, Hd), and da summed over each 32 chunk rows into dapart (R
// / 32, Hd); zeros at or past `rows`.  A block takes 32 units by 32 chunk
// rows (32 x 8 threads) and writes das's rows through a shared transpose;
// m1 from the chunk's bits, whose word of the block's 32 units in each of
// its rows it reads once into shared memory (rate 0: thr 0, scale 1).
__global__ void chunk_combine(float* __restrict__ dat, float* __restrict__ ht,
                              float* __restrict__ das, float* __restrict__ dapart,
                              const uint32_t* __restrict__ bits, int rows, int R, int Hd,
                              uint32_t thr, float scale) {
  __shared__ float tda[32][33];
  __shared__ uint32_t word[32];
  const int u0 = 32 * blockIdx.x, r0 = 32 * blockIdx.y, tx = threadIdx.x, ty = threadIdx.y;
  const int r = r0 + tx;
  if (ty == 0) word[tx] = thr == 0 ? ~0u : bits[(long)r * (Hd / 32) + u0 / 32];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int u = u0 + ty + 8 * k;
    const long at = (long)u * R + r;
    float h, d;
    gelu_both(dat[at], h, d);
    const bool keep = r < rows && (word[tx] >> (u & 31)) & 1;
    const float m = keep ? scale : 0.f;
    const float da = ht[at] * (d * m);
    ht[at] = h * m;
    dat[at] = da;
    tda[ty + 8 * k][tx] = da;
  }
  __syncthreads();
  const long RH = (long)R * Hd;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int rr = ty + 8 * k;
    float b, s;
    split(tda[tx][rr], b, s);
    das[(long)(r0 + rr) * Hd + u0 + tx] = b;
    das[RH + (long)(r0 + rr) * Hd + u0 + tx] = s;
  }
  if (ty == 0) {
    float s = 0.f;
    for (int rr = 0; rr < 32; ++rr) s += tda[tx][rr];
    dapart[(long)blockIdx.y * Hd + u0 + tx] = s;
  }
}

// D and Hd are tiled by 128 and by 192; the chunk rows R by `rows`
bool shapes_ok(int N, int D, int Hd, int R, int rows) {
  return N > 0 && (D == 384 || D == 768) && Hd > 0 && Hd % (3 * BM) == 0 && R > 0 &&
         R % rows == 0;
}

// The backward's second stream and its events, one set for each device,
// made at the first call on it.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t start, done, scores[2], products[2];
};

Side* side_stream() {
  static Side sides[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return nullptr;
  Side& sd = sides[dev];
  if (sd.stream == nullptr) {
    cudaEvent_t* evs[6] = {&sd.start, &sd.done, &sd.scores[0], &sd.scores[1], &sd.products[0],
                           &sd.products[1]};
    for (cudaEvent_t* e : evs)
      if (cudaEventCreateWithFlags(e, cudaEventDisableTiming) != cudaSuccess) return nullptr;
    if (cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking) != cudaSuccess) {
      sd.stream = nullptr;
      return nullptr;
    }
  }
  return &sd;
}

}  // namespace chunk


}  // namespace

// Kernel kind 0 (dx) or 1 (the weight partials) at width D: its registers
// a thread, its dynamic shared memory and the blocks an SM holds.  Returns
// a cudaError_t as int.
extern "C" int fused_mlp_train_bwd_info(int kind, int D, int* regs, int* smem, int* blocks) {
  if ((kind != 0 && kind != 1) || !bwd::width_ok(D)) return (int)cudaErrorInvalidValue;
  const void* fn = bwd::kernel_of(kind, D);
  *smem = bwd::smem_of(kind, D);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, bwd::THREADS, *smem);
  *regs = attr.numRegs;
  return (int)err;
}

// pack: scratch of 6 D Hd floats for the split weights; part: scratch of
// slots x (2 D Hd + Hd + D) floats for the row slots' partials; grads: 2 D
// Hd + Hd + D floats, dW1 (D, Hd), dW2 (Hd, D), db1 (Hd) and db2 (D).  x, dy
// and pack 16-byte aligned.  Returns a cudaError_t as int (or 1000 + a
// CUresult from encoding a tensor map): 0 when every launch was accepted.
extern "C" int launch_fused_mlp_train_bwd(const float* x, const float* dy,
                                          const float* w1, const float* b1,
                                          const float* w2, const int* seed, float* dx,
                                          float* grads, float* pack, float* part, int N, int D,
                                          int Hd, int Dout, int slots, int Hw, int hoff,
                                          unsigned thr, float scale, cudaStream_t stream) {
  if (N <= 0 || Dout != D || Hd <= 0 || Hd % bwd::HT != 0 || slots <= 0 || slots > 65535 ||
      !philox::mask_part_ok(Hd, Hw, hoff) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pack) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long n = (long)D * Hd, total = 2 * n + Hd + D;
  const int pack_blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  bwd::mlp_bwd_pack<<<pack_blocks, 256, 0, stream>>>(w1, w2, pack, D, Hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd::Params P;
  memset(&P, 0, sizeof(P));
  P.b1 = b1, P.seed = seed, P.dx = dx, P.dw1p = part, P.dw2p = part + n, P.db1p = part + 2 * n;
  P.db2p = part + 2 * n + Hd, P.pstride = total, P.N = N, P.Hd = Hd, P.slots = slots;
  P.Hw = Hw, P.hoff = hoff, P.thr = thr, P.scale = scale;
  int rc;
  switch (D) {
    case 64: rc = bwd::launch_bwd<64>(P, x, dy, pack, stream); break;
    case 128: rc = bwd::launch_bwd<128>(P, x, dy, pack, stream); break;
    case 192: rc = bwd::launch_bwd<192>(P, x, dy, pack, stream); break;
    case 256: rc = bwd::launch_bwd<256>(P, x, dy, pack, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const int sum_blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  bwd::mlp_bwd_sum<<<sum_blocks, 256, 0, stream>>>(part, grads, total, slots);
  return (int)cudaGetLastError();
}

// The chunked products' GEMM kernel at width D (384 or 768; one kernel for
// both): its registers a thread, its dynamic shared memory and the blocks
// an SM holds.  Returns a cudaError_t as int.
extern "C" int fused_mlp_train_chunked_info(int D, int* regs, int* smem, int* blocks) {
  if (D != 384 && D != 768) return (int)cudaErrorInvalidValue;
  return cgemm::info<chunk::Params>(regs, smem, blocks);
}

// The backward at D 384 and 768 over chunks of R rows (a multiple of 192).
// Per chunk: prep (x, g and their transposes, split; db2's sums), m1's bits,
// one launch of both scores (a^T: E_A, dh^T: E_DH), chunk_combine (h^T,
// da^T, da split, db1's sums), the bias sums, one launch of dx^T's parts
// (E_DX), dW1^T (E_DW1) and dW2 (E_DW2), and the sum of dx's parts.  The
// caller's stream runs each chunk up to the bias sums and a second stream
// its products and dx's sum, so that chunk c + 1's scores fill the SMs that
// chunk c's products leave idle; the arrays that the products read are kept
// for two chunks (sets c % 2).  scratch (16-byte aligned), in floats: W1^T
// (Hd, D); x, g split (2, R, D) each; dapart (R / 32, Hd); gpart (R / 32,
// D); dxp (DX_PARTS, R, D); m1's bits (R, Hd / 32); then twice: x^T, g^T
// split (2, D, R) each, h^T and da^T (Hd, R) each, da split (2, R, Hd).
// grads: dW1 (D, Hd), dW2 (Hd, D), db1 (Hd), db2 (D).  Returns a
// cudaError_t as int (or 1000 + a CUresult from encoding a tensor map): 0
// when every launch was accepted.
extern "C" int launch_fused_mlp_train_bwd_chunked(const float* x, const float* dy,
                                                  const float* w1, const float* b1,
                                                  const float* w2, const int* seed, float* dx,
                                                  float* grads, float* scratch, int N, int D,
                                                  int Hd, int R, int Hw, int hoff,
                                                  unsigned thr, float scale,
                                                  cudaStream_t stream) {
  using namespace chunk;
  if (!shapes_ok(N, D, Hd, R, BN) || !philox::mask_part_ok(Hd, Hw, hoff) || !aligned(x) ||
      !aligned(dy) || !aligned(w1) || !aligned(w2) || !aligned(scratch) || !aligned(grads))
    return (int)cudaErrorInvalidValue;
  Side* side = side_stream();
  if (side == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<Params>();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t second = side->stream;
  const long DH = (long)D * Hd, RD = (long)R * D, RH = (long)R * Hd;
  float* w1t = scratch;
  float* xs = w1t + DH;
  float* gs = xs + 2 * RD;
  float* dapart = gs + 2 * RD;
  float* gpart = dapart + (R / PREP) * (long)Hd;
  float* dxp = gpart + (R / PREP) * (long)D;
  uint32_t* bits = reinterpret_cast<uint32_t*>(dxp + DX_PARTS * RD);
  float* db1 = grads + 2 * DH;
  float* db2 = db1 + Hd;
  struct Buf {
    float *xts, *gts, *ht, *dat, *das;
  } buf[2];
  float* at = reinterpret_cast<float*>(bits + RH / 32);
  for (int k = 0; k < 2; ++k) {
    Buf& b = buf[k];
    b.xts = at, b.gts = at + 2 * RD, b.ht = at + 4 * RD, b.dat = b.ht + RH, b.das = b.dat + RH;
    at = b.das + 2 * RH;
  }
  transpose_split<<<dim3(Hd / 32, D / 32), dim3(32, 8), 0, stream>>>(w1, w1t, D, Hd, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Params S[2], P[2];  // per set: a^T and dh^T; dx^T, dW1^T and dW2
  int rc = 0;
  for (int k = 0; k < 2 && rc == 0; ++k) {
    memset(&S[k], 0, sizeof(Params));
    S[k].b1 = b1, S[k].ht = buf[k].ht, S[k].dat = buf[k].dat, S[k].dxp = dxp;
    S[k].dw1 = grads, S[k].dw2 = grads + DH, S[k].R = R, S[k].D = D, S[k].Hd = Hd;
    S[k].thr = thr, S[k].scale = scale, S[k].jobs = 2;
    P[k] = S[k];
    P[k].jobs = 3;
    rc = map_a(&S[k].job[0].a, w1t, D, Hd, D);
    if (rc == 0) rc = map_b(&S[k].job[0].b, xs, D, R, D, RD);
    if (rc == 0) rc = map_a(&S[k].job[1].a, w2, D, Hd, D);
    if (rc == 0) rc = map_b(&S[k].job[1].b, gs, D, R, D, RD);
    if (rc == 0) rc = map_a(&P[k].job[0].a, w1, Hd, D, Hd);
    if (rc == 0) rc = map_b(&P[k].job[0].b, buf[k].das, Hd, R, Hd, RH);
    if (rc == 0) rc = map_a(&P[k].job[1].a, buf[k].dat, R, Hd, R);
    if (rc == 0) rc = map_b(&P[k].job[1].b, buf[k].xts, R, D, R, RD);
    if (rc == 0) rc = map_a(&P[k].job[2].a, buf[k].ht, R, Hd, R);
    if (rc == 0) rc = map_b(&P[k].job[2].b, buf[k].gts, R, D, R, RD);
  }
  if (rc != 0) return rc;
  // the second stream starts after the caller's work so far, and the
  // caller's stream goes on after the second's last launch: every exit past
  // this wait joins them, so that the caller frees no buffer that a launch
  // on the second stream may still use
  err = cudaEventRecord(side->start, stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(second, side->start, 0);
  if (err != cudaSuccess) return (int)err;
  int c = 0;
  for (long r0 = 0; r0 < N && err == cudaSuccess && rc == 0; r0 += R, ++c) {
    const int k = c & 1, rows = (int)(N - r0 < R ? N - r0 : R);
    const int nt = (rows + BN - 1) / BN;  // tiles of the chunk's rows
    if (c >= 2) {  // chunk c - 2's products are done with set k
      err = cudaStreamWaitEvent(stream, side->products[k], 0);
      if (err != cudaSuccess) break;
    }
    chunk_prep<<<dim3(D / PREP, nt * (BN / PREP)), 256, 0, stream>>>(
        x, dy, seed, xs, gs, buf[k].xts, buf[k].gts, gpart, r0, rows, R, D, thr, scale);
    if (thr != 0)
      mask_bits<<<(nt * BN * (Hd / 32) + 255) / 256, 256, 0, stream>>>(
          seed, r0, rows, nt * BN, Hd, Hw, hoff, philox::STREAM_HIDDEN, thr, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    S[k].r0 = P[k].r0 = r0, S[k].rows = P[k].rows = rows;
    set_job(S[k].job[0], E_A, Hd / BM, nt, D / BK);
    set_job(S[k].job[1], E_DH, Hd / BM, nt, D / BK);
    rc = launch(S[k], stream);
    if (rc != 0) break;
    chunk_combine<<<dim3(Hd / 32, nt * (BN / 32)), dim3(32, 8), 0, stream>>>(
        buf[k].dat, buf[k].ht, buf[k].das, dapart, bits, rows, R, Hd, thr, scale);
    chunk_bias<<<(Hd + D + 255) / 256, 256, 0, stream>>>(dapart, gpart, db1, db2, Hd, D,
                                                         nt * (BN / PREP), r0 == 0);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventRecord(side->scores[k], stream);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(second, side->scores[k], 0);
    if (err != cudaSuccess) break;
    set_job(P[k].job[0], E_DX, D / BM, nt, Hd / BK / DX_PARTS, 0, DX_PARTS);
    set_job(P[k].job[1], E_DW1, Hd / BM, D / BN, nt * (BN / BK));
    set_job(P[k].job[2], E_DW2, Hd / BM, D / BN, nt * (BN / BK));
    P[k].accumulate = r0 > 0;
    rc = launch(P[k], second);
    if (rc != 0) break;
    chunk_dx_sum<<<((long)rows * D / 4 + 255) / 256, 256, 0, second>>>(dxp, dx, r0, rows, R, D);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventRecord(side->products[k], second);
  }
  cudaError_t joined = cudaEventRecord(side->done, second);
  if (joined == cudaSuccess) joined = cudaStreamWaitEvent(stream, side->done, 0);
  if (joined != cudaSuccess) cudaStreamSynchronize(second);
  if (rc != 0) return rc;
  return (int)(err != cudaSuccess ? err : joined);
}

// The forward at D 384 and 768 over chunks of R rows (a multiple of 128):
// W1^T split (2, Hd, D) and W2^T split (2, D, Hd) into scratch, then per
// chunk both masks' bits, h = GELU(x W1 + b1) m1 into scratch's (R, Hd)
// hidden (E_FH) and y = (h W2 + b2) m2 (E_FY).  scratch: 4 D Hd + R Hd + R
// (Hd + D) / 32 floats, 16-byte aligned.  Returns a cudaError_t as int (or
// 1000 + a CUresult): 0 when every launch was accepted.
extern "C" int launch_fused_mlp_train_fwd_chunked(const float* x, const float* w1,
                                                  const float* b1, const float* w2,
                                                  const float* b2, const int* seed, float* y,
                                                  float* scratch, int N, int D, int Hd, int R,
                                                  int Hw, int hoff, unsigned thr, float scale,
                                                  cudaStream_t stream) {
  using namespace chunk;
  if (!shapes_ok(N, D, Hd, R, BM) || !philox::mask_part_ok(Hd, Hw, hoff) || !aligned(x) ||
      !aligned(scratch))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<Params>();
  if (err != cudaSuccess) return (int)err;
  const long DH = (long)D * Hd;
  float* w1ts = scratch;
  float* w2ts = w1ts + 2 * DH;
  float* hid = w2ts + 2 * DH;
  uint32_t* bits1 = reinterpret_cast<uint32_t*>(hid + (long)R * Hd);
  uint32_t* bits2 = bits1 + (long)R * (Hd / 32);
  transpose_split<<<dim3(Hd / 32, D / 32), dim3(32, 8), 0, stream>>>(w1, w1ts, D, Hd, 1);
  transpose_split<<<dim3(D / 32, Hd / 32), dim3(32, 8), 0, stream>>>(w2, w2ts, Hd, D, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params F1, F2;
  memset(&F1, 0, sizeof(F1));
  F1.b1 = b1, F1.b2 = b2, F1.bits1 = bits1, F1.bits2 = bits2, F1.hid = hid, F1.y = y;
  F1.R = R, F1.D = D, F1.Hd = Hd, F1.thr = thr, F1.scale = scale, F1.jobs = 1;
  F2 = F1;
  int rc = map_a(&F1.job[0].a, x, D, N, D);
  if (rc == 0) rc = map_b(&F1.job[0].b, w1ts, D, Hd, D, DH);
  if (rc == 0) rc = map_a(&F2.job[0].a, hid, Hd, R, Hd);
  if (rc == 0) rc = map_b(&F2.job[0].b, w2ts, Hd, D, Hd, DH);
  if (rc != 0) return rc;
  for (long r0 = 0; r0 < N; r0 += R) {
    const int rows = (int)(N - r0 < R ? N - r0 : R), mt = (rows + BM - 1) / BM;
    if (thr != 0) {
      mask_bits<<<(mt * BM * (Hd / 32) + 255) / 256, 256, 0, stream>>>(
          seed, r0, rows, mt * BM, Hd, Hw, hoff, philox::STREAM_HIDDEN, thr, bits1);
      mask_bits<<<(mt * BM * (D / 32) + 255) / 256, 256, 0, stream>>>(
          seed, r0, rows, mt * BM, D, D, 0, philox::STREAM_OUT, thr, bits2);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    F1.r0 = F2.r0 = r0, F1.rows = F2.rows = rows;
    set_job(F1.job[0], E_FH, mt, Hd / BN, D / BK, (int)r0);
    rc = launch(F1, stream);
    if (rc != 0) return rc;
    set_job(F2.job[0], E_FY, mt, D / BN, Hd / BK);
    rc = launch(F2, stream);
    if (rc != 0) return rc;
  }
  return 0;
}
