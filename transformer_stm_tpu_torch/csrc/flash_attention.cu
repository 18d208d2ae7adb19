// flash_attention and attention_small forward: o = softmax(q k^T * scale) v
// in f32 on Hopper's tensor cores in 3xTF32 (csrc/tf32x3.cuh), and in
// training the per-row log-sum-exp that the backward reads, for any head dim
// from 1 to 256 and any lengths.
//
// Replaces both Pallas TPU forwards of transformer_stm_tpu/kernels/
// flash_attention.py: `_flash_kernel` :48 (launched by `_flash_fwd_impl`
// :102 through `flash_attention` :175; K/V blocks on a sequential grid axis,
// the running max, denominator and output in VMEM scratch, the lse in a
// padding channel of the output) and `_small_fwd_kernel` :680 (launched by
// `_small_fwd_impl` :703 through `attention_small` :935; a whole K/V row of a
// head in VMEM, the lse in lane 0 of an aux array).  The two differ only in
// what stays in VMEM; here one design serves both: a block loops over
// 64-key tiles itself with the running state in registers.  lse = m +
// log(l) in natural log is its own (B, H, T) array; the inference launch
// passes a null pointer and stores none.
//
// Bound: operations.  Two products of 2 B H T S Dh flops; at the 512px
// CvT's stage 1 (B 128, T = S = 16,384, H 1, Dh 64) 8.80 TFLOP: 131 ms at
// the 67 TFLOP/s of f32 FMA, 53.3 ms as three TF32 products at 495 TFLOP/s;
// at the 128px stage 1 (B 128, T = S = 1,024) 34.4 GFLOP, 0.51 and 0.21 ms.
//
// Design.  A block owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows each, which share every K/V tile.  TMA loads use
// 4-d maps over (Dh, H, rows, B), so rows past the sequence are zero-filled,
// never the next batch's; thread 0 issues them (a producer warp would make
// a 288-thread block, which ptxas caps at 168 registers a thread).
//
// - Dh <= 64 (every main path): q is loaded once and split in place into
//   big and small TF32 halves, K-major along Dh in the 128-byte swizzle.  K
//   and V tiles of 64 keys stream through two raw stages (full mbarriers);
//   all 256 threads split each tile: K into big and small as stored (the B
//   operand of s = q k^T, K-major along Dh), V transposed into V^T big and
//   small with its keys in `kpos` order (.tf32 wgmma reads shared operands
//   only K-major, and p v's K is the keys).  Once a stage is split, thread 0
//   loads the tile two ahead into it.
// - Each warpgroup: s = q k^T (three TF32 products, the small terms first;
//   K = Dh <= 64 accumulates directly), then the online softmax in
//   registers: keys past S get p = 0, the row max is reduced across the
//   four lanes that share an accumulator row, p = 2^(s scale log2 e - m)
//   with m in the same units, each lane keeps its share of the row sum
//   (rescaled with the row, reduced once at the end).  p feeds p v from
//   registers (`acc_as_a`); the tile's product lands in fresh accumulators
//   and o = alpha o + (p v): over 16,384 keys the tensor cores' truncation
//   would otherwise bias o.  o is rescaled while the product runs.
// - Dh > 64 (off the main path): blockIdx.z picks a 64-column chunk of the
//   output; for each key tile the scores are summed over every chunk of
//   Dh, each loaded with its q chunk (q is reloaded), and V's chunk follows;
//   one raw stage, no overlap, slower.
//
// Shared memory: q big/small 64 KB, K big/small 32 KB, V^T big/small 32 KB,
// two raw K/V stages 64 KB: 192 KB, one block an SM.
//
// Layout: q, o (B, T, H, Dh); k, v (B, S, H, Dh); lse (B, H, T); all
// contiguous f32, q, k, v 16-byte aligned, Dh a multiple of 8 and at least
// 32 (the wrapper zero-pads q, k and v; the scale stays 1/sqrt of the true
// head dim, and zero columns change no score).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int TILE = 64;                     // keys of a tile; rows of a warpgroup
constexpr int MAX_DH = 256;
constexpr int WG = 128;                      // a consumer warpgroup
constexpr int THREADS = 2 * WG;              // two, no producer warp
constexpr int ROWS = 2 * TILE;               // query rows of a block
constexpr int TILE_BYTES = TILE * TILE * 4;  // 64 x 64 f32, two atoms, 16 KB
constexpr int HEAD_BYTES = 1024;
constexpr int ALIGN = 1024;
constexpr int BAR_TILE = 1;                  // named barrier of the block
constexpr float LOG2E = 1.44269504088896341f;
constexpr float LN2 = 0.69314718055994531f;

struct Params {
  CUtensorMap q, k, v;  // (Dh, H, rows, B), box 32 x 1 x 64 x 1
  float* o;
  float* lse;           // or null
  int T, S, H, Dh, nc;
  float sl;             // scale * log2 e
};

// byte offsets of the shared regions: q big and small (one 64-row tile for
// each warpgroup), K big and small, V^T big and small, two raw stages of K
// and V (the chunked path uses the first)
constexpr int Q_BIG = 0, Q_SMALL = 2 * TILE_BYTES;
constexpr int K_BIG = 4 * TILE_BYTES, K_SMALL = 5 * TILE_BYTES;
constexpr int VT_BIG = 6 * TILE_BYTES, VT_SMALL = 7 * TILE_BYTES;
constexpr int RAW = 8 * TILE_BYTES, STAGE = 2 * TILE_BYTES;
constexpr int SMEM = ALIGN + HEAD_BYTES + RAW + 2 * STAGE;

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

// in place: big over the raw 64 x 64 tile, small at the same offset of
// `small`; n threads from tid
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* small, int tid, int n) {
#pragma unroll 4
  for (int i = tid; i < TILE_BYTES / 16; i += n) {
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

// the raw tile into big and small at the same offsets (the swizzle is kept)
__device__ __forceinline__ void split_copy(const uint8_t* raw, uint8_t* big, uint8_t* small,
                                           int tid) {
#pragma unroll 4
  for (int i = tid; i < TILE_BYTES / 16; i += THREADS) {
    const float4 v = reinterpret_cast<const float4*>(raw)[i];
    float4 vb, vs;
    split(v.x, vb.x, vs.x);
    split(v.y, vb.y, vs.y);
    split(v.z, vb.z, vs.z);
    split(v.w, vb.w, vs.w);
    reinterpret_cast<float4*>(big)[i] = vb;
    reinterpret_cast<float4*>(small)[i] = vs;
  }
}

// the raw V tile (keys x 64 columns) into V^T big and small (column x
// kpos(key)).  A thread takes one key and every fourth float4 of it, so that
// a warp's transposed stores hit 32 banks.
__device__ __forceinline__ void split_transpose(const uint8_t* raw, uint8_t* tbig,
                                                uint8_t* tsmall, int tid) {
  const int row = tid % TILE;
  const int kp = kpos(row);
#pragma unroll
  for (int q = tid / TILE; q < TILE / 4; q += THREADS / TILE) {
    const float4 v = *reinterpret_cast<const float4*>(raw + sw_off(row, 4 * q, TILE));
    float4 vb, vs;
    split(v.x, vb.x, vs.x);
    split(v.y, vb.y, vs.y);
    split(v.z, vb.z, vs.z);
    split(v.w, vb.w, vs.w);
    const float b4[4] = {vb.x, vb.y, vb.z, vb.w}, s4[4] = {vs.x, vs.y, vs.z, vs.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t toff = sw_off(4 * q + e, kp, TILE);
      *reinterpret_cast<float*>(tbig + toff) = b4[e];
      *reinterpret_cast<float*>(tsmall + toff) = s4[e];
    }
  }
}

// s += q k^T for the warpgroup's q tile (`own` bytes into the q regions)
__device__ __forceinline__ void scores(float (&s)[TILE / 2], uint8_t* sm, int own) {
  wg_fence();
  mma3_ss<TILE, TILE / 8>(s, desc_sw128(sm + Q_BIG + own), desc_sw128(sm + Q_SMALL + own), TILE,
                          desc_sw128(sm + K_BIG), desc_sw128(sm + K_SMALL), TILE);
  wg_commit();
  wg_wait<0>();
  fence_acc(s);
}

// The online softmax of one key tile, then o = alpha o + p v.  s holds the
// tile's scores (rows ra and ra + 8 of the warpgroup, columns s0 + 8 j + 2 t
// + e); m is the running row max in units of scale log2 e, l the lane's
// share of the row sum.
__device__ __forceinline__ void softmax_pv(float (&s)[TILE / 2], float (&o)[TILE / 2],
                                           float (&m)[2], float (&l)[2], uint8_t* sm, int s0,
                                           int S, float sl, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      s[i] = s0 + 8 * j + 2 * t + (e & 1) < S ? s[i] * sl : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[i]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // key s0 = 0 is in the first tile, so mx is finite from there on and
    // alpha = 2^-inf = 0 there
    alpha[r] = exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) {
    s[i] = exp2_approx(s[i] - mx[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }

  uint32_t ab[TILE / 8][4], as[TILE / 8][4];
#pragma unroll
  for (int kk = 0; kk < TILE / 8; ++kk) acc_as_a(s, kk, ab[kk], as[kk]);
  fence_frag(ab);
  fence_frag(as);
  float part[TILE / 2];
  zero(part);
  wg_fence();
  mma3_rs<TILE, TILE / 8>(part, ab, as, desc_sw128(sm + VT_BIG), desc_sw128(sm + VT_SMALL), TILE);
  wg_commit();
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  wg_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) o[i] += part[i];
}

// o / l for rows row0 + ra, + 8 and the 64 columns of chunk co (those past
// T and Dh are not stored); lse = m ln 2 + log l from chunk 0
__device__ __forceinline__ void epilogue(const Params& p, const float (&o)[TILE / 2],
                                         const float (&m)[2], float (&l)[2], int b, int h,
                                         int row0, int co, int ra, int t) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const long tok = (long)p.H * p.Dh;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    const int c = TILE * co + 8 * j + 2 * t;
    if (c >= p.Dh) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + ra + 8 * r;
      if (row >= p.T) continue;
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<float2*>(p.o + ((long)b * p.T + row) * tok + (long)h * p.Dh + c) =
          make_float2(o[i] * inv[r], o[i + 1] * inv[r]);
    }
  }
  if (p.lse != nullptr && co == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + ra + 8 * r;
      if (row < p.T) p.lse[((long)b * p.H + h) * p.T + row] = m[r] * LN2 + logf(l[r]);
    }
  }
}

// Dh <= 64: q resident, K and V double-buffered
__device__ void fwd_main(const Params& p, uint8_t* sm, uint64_t* full, int b, int h, int r0) {
  const int w = warpgroup();
  const int tid = threadIdx.x, wt = tid % WG, lane = tid % 32, t = lane % 4;
  const int ra = 16 * (wt / 32) + lane / 4;  // the thread's first accumulator row
  const int own = w * TILE_BYTES;            // this warpgroup's q tile
  if (tid == 0) {
    mbar_expect_tx(&full[0], 4 * TILE_BYTES);
    load_chunk(sm + Q_BIG, &p.q, &full[0], 0, h, r0, b);
    load_chunk(sm + Q_BIG + TILE_BYTES, &p.q, &full[0], 0, h, r0 + TILE, b);
    for (int st = 0; st < 2 && st * TILE < p.S; ++st) {
      if (st > 0) mbar_expect_tx(&full[st], STAGE);
      load_chunk(sm + RAW + st * STAGE, &p.k, &full[st], 0, h, st * TILE, b);
      load_chunk(sm + RAW + st * STAGE + TILE_BYTES, &p.v, &full[st], 0, h, st * TILE, b);
    }
  }

  float o[TILE / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  for (int i = 0, s0 = 0; s0 < p.S; ++i, s0 += TILE) {
    const int st = i & 1;
    uint8_t* raw = sm + RAW + st * STAGE;
    mbar_wait(&full[st], (i >> 1) & 1);
    if (i > 0) bar_sync(BAR_TILE, THREADS);  // every warpgroup's products of the last tile are done
    else split_tile(sm + Q_BIG + own, sm + Q_SMALL + own, wt, WG);
    split_copy(raw, sm + K_BIG, sm + K_SMALL, tid);
    split_transpose(raw + TILE_BYTES, sm + VT_BIG, sm + VT_SMALL, tid);
    fence_proxy_shared();
    bar_sync(BAR_TILE, THREADS);
    if (tid == 0 && s0 + 2 * TILE < p.S) {  // the stage is free: the tile two ahead
      mbar_expect_tx(&full[st], STAGE);
      load_chunk(raw, &p.k, &full[st], 0, h, s0 + 2 * TILE, b);
      load_chunk(raw + TILE_BYTES, &p.v, &full[st], 0, h, s0 + 2 * TILE, b);
    }

    float s[TILE / 2];
    zero(s);
    scores(s, sm, own);
    softmax_pv(s, o, m, l, sm, s0, p.S, p.sl, t);
  }
  epilogue(p, o, m, l, b, h, r0 + TILE * w, 0, ra, t);
}

// Dh > 64: output chunk co; per key tile the scores over every chunk of Dh
// (q's chunk reloaded with K's), then V's chunk co; one raw stage
__device__ void fwd_chunked(const Params& p, uint8_t* sm, uint64_t* full, int b, int h, int r0,
                            int co) {
  const int w = warpgroup();
  const int tid = threadIdx.x, wt = tid % WG, lane = tid % 32, t = lane % 4;
  const int ra = 16 * (wt / 32) + lane / 4;
  const int own = w * TILE_BYTES;
  uint8_t* raw = sm + RAW;
  float o[TILE / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  uint32_t phase = 0;
  for (int s0 = 0; s0 < p.S; s0 += TILE) {
    float s[TILE / 2];
    zero(s);
    for (int c = 0; c < p.nc; ++c) {
      bar_sync(BAR_TILE, THREADS);  // every warpgroup's products are done
      if (tid == 0) {
        const bool last = c == p.nc - 1;
        mbar_expect_tx(&full[0], (last ? 4 : 3) * TILE_BYTES);
        load_chunk(sm + Q_BIG, &p.q, &full[0], TILE * c, h, r0, b);
        load_chunk(sm + Q_BIG + TILE_BYTES, &p.q, &full[0], TILE * c, h, r0 + TILE, b);
        load_chunk(raw, &p.k, &full[0], TILE * c, h, s0, b);
        if (last) load_chunk(raw + TILE_BYTES, &p.v, &full[0], TILE * co, h, s0, b);
      }
      mbar_wait(&full[0], phase);
      phase ^= 1;
      split_tile(sm + Q_BIG + own, sm + Q_SMALL + own, wt, WG);
      split_copy(raw, sm + K_BIG, sm + K_SMALL, tid);
      if (c == p.nc - 1) split_transpose(raw + TILE_BYTES, sm + VT_BIG, sm + VT_SMALL, tid);
      fence_proxy_shared();
      bar_sync(BAR_TILE, THREADS);
      scores(s, sm, own);
    }
    softmax_pv(s, o, m, l, sm, s0, p.S, p.sl, t);
  }
  epilogue(p, o, m, l, b, h, r0 + TILE * w, co, ra, t);
}

// blockIdx.x: 128 query rows; blockIdx.y: batch * H + head; blockIdx.z: the
// output chunk of the head dim (CHUNKED: Dh > 64)
template <bool CHUNKED>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tf32x3(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint8_t* sm = base + HEAD_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, r0 = blockIdx.x * ROWS;
  if constexpr (CHUNKED)
    fwd_chunked(p, sm, full, b, h, r0, blockIdx.z);
  else
    fwd_main(p, sm, full, b, h, r0);
}

const void* kernel_of(int kind) {
  return kind == 0 ? (const void*)flash_fwd_tf32x3<false> : (const void*)flash_fwd_tf32x3<true>;
}

// a map of one of q, k, v: (Dh, H, rows, B), rows ld floats apart
int encode_qkv(CUtensorMap* map, const float* ptr, int B, int L, int H, int Dh, int ld) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 4, (cuuint64_t)ld * 4,
                                 (cuuint64_t)L * ld * 4};
  const cuuint32_t box[4] = {32, 1, TILE, 1};
  return encode_f32(map, ptr, 4, dims, strides, box);
}

template <bool CHUNKED>
int launch(const Params& P, int B, int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3<CHUNKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((P.T + ROWS - 1) / ROWS), (unsigned)(B * H), (unsigned)P.nc);
  flash_fwd_tf32x3<CHUNKED><<<grid, THREADS, SMEM, stream>>>(P);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// kind 0 (Dh <= 64) or 1 (Dh > 64): its registers a thread, its dynamic
// shared memory and the blocks an SM holds.  Returns a cudaError_t as int.
extern "C" int flash_attention_fwd_info(int kind, int* regs, int* smem, int* blocks) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(kind);
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

// Returns a cudaError_t as int (or 1000 + a CUresult from encoding a tensor
// map): 0 when the launch was accepted.  `lse` may be null (inference).  Dh
// is the stored (padded) head dim, a multiple of 8 from 32 to 256; q, k and
// v must be 16-byte aligned, their rows (tokens) `ld` floats apart, ld a
// multiple of 4 and at least H Dh, and k and v hold `s_rows` >= S rows a
// batch, the keys past S masked (the f32 ViT layer, csrc/fused_layer.cu,
// reads them from its packed q|k|v rows: ld = 3 H Dh, T = s_rows = t_pad,
// S = t_real).  o is (B, T, H, Dh).
extern "C" int launch_flash_attention_ld(const float* q, const float* k, const float* v, float* o,
                                         float* lse, int B, int T, int S, int s_rows, int H,
                                         int Dh, int ld, float scale, cudaStream_t stream) {
  if (Dh < 32 || Dh > MAX_DH || Dh % 8 != 0 || B <= 0 || T <= 0 || S <= 0 || s_rows < S ||
      H <= 0 || (long)B * H > 65535 || ld < H * Dh || ld % 4 != 0 || !aligned(q) ||
      !aligned(k) || !aligned(v))
    return (int)cudaErrorInvalidValue;
  Params P;
  memset(&P, 0, sizeof(P));
  P.o = o, P.lse = lse, P.T = T, P.S = S, P.H = H, P.Dh = Dh;
  P.nc = (Dh + TILE - 1) / TILE;
  P.sl = scale * LOG2E;
  int rc = encode_qkv(&P.q, q, B, T, H, Dh, ld);
  if (rc == 0) rc = encode_qkv(&P.k, k, B, s_rows, H, Dh, ld);
  if (rc == 0) rc = encode_qkv(&P.v, v, B, s_rows, H, Dh, ld);
  if (rc != 0) return rc;
  return P.nc == 1 ? launch<false>(P, B, H, stream) : launch<true>(P, B, H, stream);
}

// The same with q, k and v (B, T or S, H, Dh) contiguous.
extern "C" int launch_flash_attention(const float* q, const float* k, const float* v, float* o,
                                      float* lse, int B, int T, int S, int H, int Dh, float scale,
                                      cudaStream_t stream) {
  return launch_flash_attention_ld(q, k, v, o, lse, B, T, S, S, H, Dh, H * Dh, scale, stream);
}
