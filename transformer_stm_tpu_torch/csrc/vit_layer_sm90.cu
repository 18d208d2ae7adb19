// The fused ViT layer in bf16 for Hopper (sm_90a), on folded (B * t_pad, E)
// token rows:
//
//   mode ATTN        y = x + OutProj(MHA(LN1 x))            attn_layer_infer
//   mode MLP         y = x + MLP(LN2 x)                      ln_mlp_infer
//   mode ATTN|MLP    z = x + MHA(LN1 x), y = z + MLP(LN2 z)  vit_layer_infer
//   ATTN|MLP|Q8      the same with the six projections int8  vit_layer_infer_int8
//
// Replaces the Pallas TPU kernels of transformer_stm_tpu/kernels/fused_layer.py
// `_layer_kernel` :279 (`vit_layer_infer` :335), `_attn_layer_kernel` :62
// (`attn_layer_infer` :200), `_ln_mlp_kernel` :590 (`ln_mlp_infer` :602) and
// `_layer_kernel_int8` :440 (`vit_layer_infer_int8` :509) in bfloat16;
// csrc/fused_layer.cu keeps the float32 modes.
//
// Bound: operations.  At ViT-S (E 384, H 6, Dh 64, hidden 1536, t_pad 200) a
// layer does 0.77 GFLOP an image against 0.3 MB of x in and y out, far above
// the card's balance point, so the design is about keeping the tensor cores
// fed:
//
// - Every product is `wgmma.mma_async` (m64nNk16, bf16 in, f32 sums in
//   registers) on operands in the 128-byte swizzled layout, brought into a
//   ring of NSTAGE shared-memory stages by TMA (`cp.async.bulk.tensor`, one
//   mbarrier per stage for "full" and one for "empty").  A block is two
//   consumer warpgroups, which issue the products and run the epilogues on
//   the accumulator registers, and one producer warpgroup, one thread of
//   which keeps the loads in flight; setmaxnreg moves the producer's
//   registers to the consumers.  Weights are packed once per model as W^T
//   (out, in), so that both operands of every projection are K-major.
// - Work is cut into items that a persistent grid (one block an SM) takes
//   in order from a counter in device memory: A, a 64-row tile of the
//   folded rows (LN1, then q|k|v = xn Wqkv + b); B, one (image, head) of the
//   attention; C, a 64-row tile (out projection + residual, LN2, the MLP).
//   Row tiles run over the folded rows, not images, so no product pads an
//   image of 200 rows to 256, and the 600 tiles of ViT-S at B 192 spread
//   over 132 SMs where 192 images did not; a block that finishes early
//   takes the next item, whatever its kind.  An item waits (acquire loads
//   on per-tile and per-image counters) for the items it reads: B for the A
//   tiles of its image, C for the heads of its images; it only waits on
//   items taken before it by running blocks, so the earliest unfinished
//   item never waits.  Items are ordered group by group, A of group s, B of
//   group s - 2, C of group s - 5, so that what an item waits for was
//   handed out steps earlier, and the q|k|v and attention output of the
//   groups in flight (32 MB, `WINDOW_BYTES`) stay in the 50 MB L2.
// - LN1 and LN2 are the prologue of the product that reads them.  LN1 (and
//   LN2 of mode MLP) reads the block's 64 rows of x from shared memory,
//   where TMA has put them, and normalises them into the block's slot (bf16,
//   64 x E, L2-resident), from which TMA brings the A tiles.  In the merged
//   mode LN2 runs on the out projection's accumulators, which hold all of z
//   for E <= 384 (the two warpgroups trade their row sums through shared
//   memory); z (f32) waits in the block's other slot for the MLP's
//   epilogue.  The MLP is fused per tile: hidden chunks of 128, h =
//   GELU(zn W1[:, chunk] + b1) rounded to bf16 in shared memory, y_acc +=
//   h W2[chunk, :] in registers; the 4x hidden never reaches device memory.
//   A chunk's fc2 stages alternate in the ring with the next chunk's fc1
//   stages (two 64-deep steps each), so that the loads stay ahead of GELU.
// - Attention: Q, K and V of one (image, head) come into shared memory by
//   TMA through a 3-D map (columns, row in the image, image), so rows past
//   t_pad are zero-filled, never the next image's.  S = Q K^T runs on wgmma
//   for 64 query rows against up to 256 keys at once (4 accumulators of 64
//   keys), the masked softmax in registers, p is rounded to bf16 and P V runs
//   with P as the register A operand and V as an MN-major B operand.  Past
//   256 keys a first pass over 256-key blocks finds the row max and a second
//   recomputes the scores: p and l are exactly those of the whole-row form.
// - Each item kind is a function of its own; the bf16 modes' attention is
//   not inlined, so that its registers are allocated apart from the
//   products' (the int8 layer inlines it, with two 64-key chunks of scores
//   held at once: `attention_item`).  Weight loads carry an L2 evict-last
//   policy, ahead of the activations.
//
// Rounding points are the JAX kernel's: xn, zn, q/k/v, p (l sums the
// unrounded p), the per-head output and the hidden after GELU are rounded to
// bf16; scores, softmax, l and z stay f32.  Epilogues add acc + b, (x + bo)
// + acc and z + (acc + b2) in that order; LN is ((x - mean) * rsqrt(var +
// eps)) * gamma + beta with __fmul_rn/__fadd_rn.  GELU is the A&S form of
// `_gelu_exact` and the softmax's exp is 2^x, both with the special-function
// unit's reciprocal and exp2 (about an ulp of f32, below the bf16 rounding
// that follows).  Keys at or past t_real are masked to -1e30; padded query
// rows carry junk, as on the TPU.  Any B; rows past the last tile's are
// zero-filled by TMA and not stored.
//
// The int8 layer (Q8; `_layer_kernel_int8`, with `_quant_rows` :410 and
// `_qdot` :430) keeps the items, the ring and the attention, and changes
// the products and their prologues and epilogues:
//
// - Weights are packed once per model as int8 W^T (out, in) with f32
//   per-output-column scales (the wrapper's `quant_cols`): `wgmma` with
//   .s8 takes both shared operands K-major.  A stage's 128-byte swizzled
//   row then holds 128 int8 columns, so a stage is four m64nNk32 steps and
//   every product has the wide form (N 192 a warpgroup, one stage of the A
//   tile and both B tiles) with int32 sums in registers.  Past E, HD or the
//   hidden width TMA fills the weights with zeros, so what a stage reads past
//   a row's end adds nothing.
// - Rows are quantised per row as `_quant_rows` does, bit for bit: amax
//   clamped at 1e-6, q = rint(v * (127 / amax)) clipped to +-127, scale amax
//   * (1 / 127); one consumer warp a row, the int8 row into the block's slot
//   (int8, 64 x max(E, HD, hidden)), from which TMA brings the A tiles, and
//   the scale into shared memory.  The epilogue of every product is ((acc *
//   sx) * sw) + b, each step rounded, the int32 sum converted to f32 first.
// - Item A: LN1 of the x tile in f32, then its quantisation, into the slot;
//   q|k|v = bf16 of the int8 product's epilogue.
// - Item C: the whole 64 x HD bf16 attention-output tile comes into the
//   ring's memory, is quantised per row into the slot, and the out
//   projection gives z = x + epilogue (f32, the block's z slot).  LN2 reads
//   z back by rows and quantises it into the slot.  fc1 runs in 384-column
//   passes; GELU of its epilogue is kept in f32 in the block's hidden slot
//   (64 x hidden f32 in device memory, read back at once, from L2) while
//   each row's absolute maximum gathers in registers, since the hidden is
//   quantised over all its units: the maxima meet across the warpgroups,
//   the hidden is quantised into the slot, and fc2 gives y = bf16(z +
//   epilogue).  (Quantising a bf16-rounded hidden would change the function;
//   computing fc1 twice, once for the maxima, would cost half of fc1 again
//   and GELU twice, and GELU's ALU work is what the bf16 layer's tensor
//   cores already wait on.)
//
// Limits (fused_layer.py states them for the router): Dh 64; E, H * Dh and
// the hidden width multiples of 64; t_pad a multiple of 8 with Q, K and V of
// one head within a block's shared memory (t_pad <= 576, also for int8).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MODE_ATTN = 1, MODE_MLP = 2, MODE_Q8 = 4;
constexpr int DH = 64;                      // head dim
constexpr int CONSUMERS = 256;              // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;    // and one producer warpgroup
constexpr int ROWS = 64;                    // rows of a tile: one wgmma M
constexpr int KT = 64;                      // depth of a stage: 128 bytes of bf16
constexpr int KQ = 128;                     // depth of an int8 stage: 128 bytes
constexpr int NW = 192;                     // columns of a warpgroup in the wide products
constexpr int NH = 64;                      // hidden columns of a warpgroup in a chunk
constexpr int HCHUNK = 2 * NH;              // hidden chunk
constexpr int NSTAGE = 3;                   // ring stages
constexpr int TILE_BYTES = ROWS * KT * 2;   // one 64 x 64 bf16 tile, 8 KB
constexpr int BW_BYTES = NW * KT * 2;       // a warpgroup's B tile in a wide stage
constexpr int STAGE_BYTES = TILE_BYTES + 2 * BW_BYTES;  // A tile + both B tiles
constexpr int H_BYTES = ROWS * HCHUNK * 2;  // the hidden chunk
constexpr int GEMM_BYTES = NSTAGE * STAGE_BYTES + H_BYTES;
static_assert(2 * TILE_BYTES + 2 * HCHUNK * KT * 2 <= STAGE_BYTES, "an fc1 stage: two steps");
constexpr int HEAD_BYTES = 1024;            // mbarriers and the item slots
constexpr int ALIGN = 1024;                 // of the swizzled tiles
constexpr int KEY_BLOCK = 4;                // 64-key chunks of scores held at once
constexpr int KEY_BLOCK_Q8 = 2;             // the same in the int8 layer (attention inlined)
constexpr int FC2_STEPS = HCHUNK / KT;      // fc2 stages a hidden chunk
// the widest E whose x tile the ring's memory holds for LN (1344)
constexpr int X_SMEM_MAX_E = NSTAGE * STAGE_BYTES / (ROWS * 2);
constexpr int BAR_CONSUMERS = 1, BAR_ALL = 2;  // named barriers (0: __syncthreads)
constexpr float NEG_INF = -1e30f;
// Step s hands out the A tiles of group s, the heads of group s - LAG_B and
// the C tiles of group s - LAG: the items an item waits for were handed out
// steps earlier (measured fastest of the lags tried on the H100)
constexpr int LAG_B = 2, LAG = 5;
// bytes of q|k|v (LAG_B + 1 groups) and attention output (LAG - LAG_B + 1
// groups) live at once
constexpr long long WINDOW_BYTES = 32ll << 20;

struct Params {
  CUtensorMap m_wqkv, m_wo, m_w1, m_w2;  // W^T, (out, in), boxes 64 x NW (m_w1: 64 x HCHUNK;
                                         // int8: 128 x NW each)
  CUtensorMap m_slot;                    // the blocks' slots, (grid * 64, E), box 64 x 64
                                         // (int8: (grid * 64, slot_w), box 128 x 64)
  CUtensorMap m_x;                       // x, (n, E), box 64 x 64
  CUtensorMap m_o;                       // attention output, (n, HD), box 64 x 64
  CUtensorMap m_qkv;                     // q|k|v as (3 HD, t_pad, B), box 64 x 64 x 1
  const bf16* x;
  bf16* y;
  bf16* qkv;
  bf16* o;
  bf16* slot;
  float* zslot;
  float* hslot;  // int8: each block's f32 hidden, 64 x hidden
  int* flags;  // [0] items taken; then items done: per A tile, heads per image
  const float *g1, *be1, *bqkv, *bo, *g2, *be2, *b1, *b2;
  const float *sqkv, *so, *s1, *s2;  // int8: the weights' column scales
  long long n;
  int tiles, images, t_pad, t_real, E, H, hidden, group;
  int slot_w;  // int8: bytes of a slot row, max(E, HD, hidden)
  float eps;
};

__host__ __device__ inline int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same with an L2 cache policy (createpolicy)
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// an L2 policy that keeps the lines (the weights, read by every tile) in L2
// ahead of the activations that stream past them
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to device memory before TMA reads them, and a
// generic-proxy acquire before the TMA loads that it guards
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// generic-proxy writes to shared memory before wgmma reads them
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// spins until *p >= want (written by other blocks with release semantics)
__device__ __forceinline__ void wait_count(const int* p, int want) {
  while (ld_acquire(p) < want) __nanosleep(64);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties the accumulators to the point of the call, so that the compiler
// neither reads them before a wgmma.wait_group nor moves writes past a
// wgmma.fence
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// wgmma descriptor of a tile of 128-byte rows in the 128-byte swizzle
// (1024-byte aligned): start address, leading offset 16 B (unused by the
// swizzled layouts), 1024 B between groups of 8 rows, swizzle mode 1.
// A K-major operand steps 16 deep by adding 32 bytes (2 in the address
// field); an MN-major one by 16 rows, 2048 bytes (128).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint32_t a = smem_u32(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// byte offset of bf16 element (r, c), c < 64, in a swizzled 64-column tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1)));
}

// d (m64n64 f32) += A (shared, K-major) B (shared, K-major), bf16 in;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n192 f32) += A (shared, K-major) B (shared, K-major), bf16 in;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64 f32) += A (registers, bf16 pairs) B (shared, MN-major), bf16 in
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<NW>(float (&d)[NW / 2], uint64_t da, uint64_t db) {
  wgmma_n192(d, da, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_ss<NH>(float (&d)[NH / 2], uint64_t da, uint64_t db) {
  wgmma_n64(d, da, db, 1);
}

// d (m64n192 s32) += A (shared, K-major) B (shared, K-major), s8 in: the
// int8 layer's products
__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "%96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0;
}

// ---------------------------------------------------------------------------
// Arithmetic and stores
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.44269504088896341f;

// 2^x on the special-function unit (about 2 ulps of f32; 0 far below)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// `_gelu_exact`: x * 0.5 * (1 + erf(x / sqrt 2)), A&S 7.1.26 erf, on the
// special-function unit and free of branches, so that the compiler
// interleaves the elements: t = 1 / (1 + p |z|) and exp(-z^2) are the
// hardware reciprocal and base-2 exponential (within about an ulp of f32,
// far below the bf16 rounding of h that follows), sign(z) erf(|z|) is a
// copysign (at z = 0 both give x = 0).
__device__ __forceinline__ float gelu_as(float x) {
  const float z = x * 0.70710678118654752f;
  const float az = fabsf(z);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(1.f + 0.3275911f * az));
  const float e = exp2_approx(az * az * -LOG2E);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.f - poly * e;
  return x * 0.5f * (1.f + copysignf(y, z));
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

// the two lanes' values of a row sit in the 4 lanes of a quad
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// an accumulator element as f32: the value, or (int8 layer) the bits of its
// dequantised value kept in place of the int32 sum
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }

// Lanes of a quad trade the f32 pairs of 4 consecutive 8-column groups of
// an accumulator row (jj .. jj + 3, row half rr): afterwards lane q holds
// the 8 columns of group jj + q in order.
template <int N, class T>
__device__ __forceinline__ void quad_gather_f32(const T (&d)[N], int jj, int rr,
                                                float (&v)[8]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pub = (q - r) & 3, src = (q + r) & 3;
    float s0 = as_f32(d[4 * jj + 2 * rr]), s1 = as_f32(d[4 * jj + 2 * rr + 1]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      s0 = pub == k ? as_f32(d[4 * (jj + k) + 2 * rr]) : s0;
      s1 = pub == k ? as_f32(d[4 * (jj + k) + 2 * rr + 1]) : s1;
    }
    const float g0 = __shfl_sync(0xffffffffu, s0, (lane & ~3) | src);
    const float g1 = __shfl_sync(0xffffffffu, s1, (lane & ~3) | src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = src == k ? g0 : v[2 * k];
      v[2 * k + 1] = src == k ? g1 : v[2 * k + 1];
    }
  }
}

// The epilogue of an m64 accumulator of NG 8-column groups, by rows: lane
// q of each quad gets the 8 columns col .. col + 7 of one row (rq + 8rr) as
// v and calls row(rr, col, v), which loads and stores whole vectors.
template <int NG, int N, class T, class R>
__device__ __forceinline__ void epi_rows(const T (&d)[N], R row) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int jj = 0; jj < NG; jj += 4)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float v[8];
      quad_gather_f32(d, jj, rr, v);
      row(rr, 8 * (jj + q), v);
    }
}

__device__ __forceinline__ uint4 pack8_bf16(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float2 bf16x2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f32x2_at(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// LayerNorm of the tile's `rows` rows of src (row stride E) into dst, bf16,
// as `_layer_norm_rows`: the mean, then the mean of the squared deviations,
// then ((x - mean) * rsqrt(var + eps)) * gamma + beta; the rows past `rows`
// are zeroed.  A consumer warp takes Raw<TI>::ROWS of its 8 rows at a time,
// one vector of 8 columns a lane per 256 columns, and keeps LN_VEC of them
// a row (E <= 768) as loaded, so that all its loads are in flight together;
// wider rows read the rest again in each pass.
constexpr int LN_VEC = 3;

template <typename TI>
struct Raw;  // 8 columns as loaded
template <>
struct Raw<bf16> {
  static constexpr int ROWS = 2;
  uint4 u;
  __device__ void load(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ void get(float (&v)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};
template <>
struct Raw<float> {
  static constexpr int ROWS = 2;
  float4 a, b;
  __device__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ void get(float (&v)[8]) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  }
};

template <typename TI>
__device__ void ln_tile(const TI* __restrict__ src, int rows, int E, const float* __restrict__ g,
                        const float* __restrict__ b, float eps, bf16* __restrict__ dst) {
  constexpr int R = Raw<TI>::ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto out8 = [&](const float (&x)[8], int c, float m, float r) {
    float gg[8], bb[8];
    load8(g + c, gg);
    load8(b + c, bb);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(x[2 * k] - m, r), gg[2 * k]), bb[2 * k]),
                       __fadd_rn(__fmul_rn(__fmul_rn(x[2 * k + 1] - m, r), gg[2 * k + 1]),
                                 bb[2 * k + 1]));
    return make_uint4(w[0], w[1], w[2], w[3]);
  };
  for (int r0 = R * warp; r0 < ROWS; r0 += R * (CONSUMERS / 32)) {
    Raw<TI> raw[R][LN_VEC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < LN_VEC; ++k) {
        const int c = 8 * lane + 256 * k;
        if (r0 + i < rows && c < E) raw[i][k].load(src + (long long)(r0 + i) * E + c);
      }
    float mu[R], rs[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float sum = 0.f, t[8];
#pragma unroll
      for (int k = 0; k < LN_VEC; ++k)
        if (8 * lane + 256 * k < E) {
          raw[i][k].get(t);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += t[e];
        }
      for (int c = 8 * lane + 256 * LN_VEC; c < E && r0 + i < rows; c += 256) {
        load8(src + (long long)(r0 + i) * E + c, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += t[e];
      }
      mu[i] = warp_sum(sum) / (float)E;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float var = 0.f, t[8];
#pragma unroll
      for (int k = 0; k < LN_VEC; ++k)
        if (8 * lane + 256 * k < E) {
          raw[i][k].get(t);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = t[e] - mu[i];
            var += d * d;
          }
        }
      for (int c = 8 * lane + 256 * LN_VEC; c < E && r0 + i < rows; c += 256) {
        load8(src + (long long)(r0 + i) * E + c, t);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = t[e] - mu[i];
          var += d * d;
        }
      }
      rs[i] = 1.f / sqrtf(warp_sum(var) / (float)E + eps);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      bf16* d = dst + (long long)(r0 + i) * E;
      const bool live = r0 + i < rows;
#pragma unroll
      for (int k = 0; k < LN_VEC; ++k) {
        const int c = 8 * lane + 256 * k;
        if (c < E) {
          float t[8];
          raw[i][k].get(t);
          *reinterpret_cast<uint4*>(d + c) =
              live ? out8(t, c, mu[i], rs[i]) : make_uint4(0, 0, 0, 0);
        }
      }
      for (int c = 8 * lane + 256 * LN_VEC; c < E; c += 256) {
        float t[8];
        uint4 o = make_uint4(0, 0, 0, 0);
        if (live) {
          load8(src + (long long)(r0 + i) * E + c, t);
          o = out8(t, c, mu[i], rs[i]);
        }
        *reinterpret_cast<uint4*>(d + c) = o;
      }
    }
  }
}

// LayerNorm of the tile's `rows` rows of x, which TMA has put in shared
// memory as E / 64 swizzled 64 x 64 tiles, into dst, bf16, as ln_tile: one
// consumer warp a row, 16-byte vectors; the rows past `rows` are zeroed.
__device__ void ln_smem(const uint8_t* xs, int rows, int E, const float* __restrict__ g,
                        const float* __restrict__ b, float eps, bf16* __restrict__ dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto get = [&](int r, int c, float (&v)[8]) {
    Raw<bf16> raw;
    raw.u = *reinterpret_cast<const uint4*>(xs + (c >> 6) * TILE_BYTES + sw128(r, c & 63));
    raw.get(v);
  };
  for (int r = warp; r < ROWS; r += CONSUMERS / 32) {
    bf16* d = dst + (long long)r * E;
    if (r >= rows) {
      for (int c = 8 * lane; c < E; c += 256)
        *reinterpret_cast<uint4*>(d + c) = make_uint4(0, 0, 0, 0);
      continue;
    }
    float v[8], sum = 0.f;
    for (int c = 8 * lane; c < E; c += 256) {
      get(r, c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[k];
    }
    const float mu = warp_sum(sum) / (float)E;
    float var = 0.f;
    for (int c = 8 * lane; c < E; c += 256) {
      get(r, c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = v[k] - mu;
        var += t * t;
      }
    }
    const float rs = 1.f / sqrtf(warp_sum(var) / (float)E + eps);
    for (int c = 8 * lane; c < E; c += 256) {
      float gv[8], bv[8];
      get(r, c, v);
      load8(g + c, gv);
      load8(b + c, bv);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = pack_bf16(__fadd_rn(__fmul_rn(__fmul_rn(v[2 * k] - mu, rs), gv[2 * k]), bv[2 * k]),
                         __fadd_rn(__fmul_rn(__fmul_rn(v[2 * k + 1] - mu, rs), gv[2 * k + 1]),
                                   bv[2 * k + 1]));
      *reinterpret_cast<uint4*>(d + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// LN of the tile's rows from the two warpgroups' m64n192 accumulators,
// which hold all E <= 2 NW columns (z; this warpgroup's from column cw):
// the row sums, then the sums of squared deviations, each a quad reduction
// and an exchange of the two warpgroups' halves through `red` (4 x 64
// floats of shared memory), then zn = ((z - mean) * rsqrt(var + eps)) *
// gamma + beta into dst, bf16.
__device__ __forceinline__ void ln_regs(const float (&z)[NW / 2], int cw, int E,
                                        const float* __restrict__ g, const float* __restrict__ b,
                                        float eps, float* red, bf16* __restrict__ dst) {
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  const int rq = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[e >> 1] += z[4 * j + e];  // zero past E
  float mu[2], rs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    part[rr] = quad_sum(part[rr]);
    if (q == 0) red[w * 64 + rq + 8 * rr] = part[rr];
  }
  bar_sync(BAR_CONSUMERS, CONSUMERS);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mu[rr] = (red[rq + 8 * rr] + red[64 + rq + 8 * rr]) / (float)E;
    part[rr] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = cw + 8 * j + 2 * q < E ? z[4 * j + e] - mu[e >> 1] : 0.f;
      part[e >> 1] += d * d;
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    part[rr] = quad_sum(part[rr]);
    if (q == 0) red[128 + w * 64 + rq + 8 * rr] = part[rr];
  }
  bar_sync(BAR_CONSUMERS, CONSUMERS);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    rs[rr] = 1.f / sqrtf((red[128 + rq + 8 * rr] + red[192 + rq + 8 * rr]) / (float)E + eps);
  epi_rows<NW / 8>(z, [&](int rr, int col, float (&v)[8]) {
    const int c = cw + col;
    if (c >= E) return;
    float gg[8], bb[8];
    load8(g + c, gg);
    load8(b + c, bb);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[e] - mu[rr], rs[rr]), gg[e]), bb[e]);
    *reinterpret_cast<uint4*>(dst + (rq + 8 * rr) * E + c) = pack8_bf16(v);
  });
}

// ---------------------------------------------------------------------------
// The int8 layer: rows quantised as `_quant_rows`, and the epilogue of `_qdot`
// ---------------------------------------------------------------------------

// 8 values as int8 clip(rint(v * inv), -127, 127), packed in column order
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(v[k], inv)), -127.f), 127.f);
    w[k >> 2] |= ((uint32_t)(int)q & 0xFFu) << (8 * (k & 3));
  }
  return make_uint2(w[0], w[1]);
}

// ((acc * sx) * sw) + b, each step rounded, the int32 sum converted first
__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

// Per-row int8 of the tile's 64 rows of W values into dst (row stride ld
// bytes) and their scales into scale[64], one consumer warp a row:
// stats(r) runs first for each row and val(r, c, st, v) then gives the 8
// values of columns c .. c + 7 (c a multiple of 8); the row's amax, clamped
// at 1e-6, then q = clip(rint(v * (127 / amax)), -127, 127) and the scale
// amax * (1 / 127).  Rows past `rows` become zeros with scale 0 (nothing
// stores them).
template <class Stats, class Val>
__device__ __forceinline__ void quant_tile(int rows, int W, Stats stats, Val val, int8_t* dst,
                                           int ld, float* scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += CONSUMERS / 32) {
    int8_t* d = dst + (long long)r * ld;
    if (r >= rows) {
      for (int c = 8 * lane; c < W; c += 256) *reinterpret_cast<uint2*>(d + c) = make_uint2(0, 0);
      if (lane == 0) scale[r] = 0.f;
      continue;
    }
    const float2 st = stats(r);
    float m = 0.f, v[8];
    for (int c = 8 * lane; c < W; c += 256) {
      val(r, c, st, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
    }
    const float amax = fmaxf(warp_max(m), 1e-6f);
    const float inv = __fdiv_rn(127.f, amax);
    for (int c = 8 * lane; c < W; c += 256) {
      val(r, c, st, v);
      *reinterpret_cast<uint2*>(d + c) = quant8(v, inv);
    }
    if (lane == 0) scale[r] = __fmul_rn(amax, 1.f / 127.f);
  }
}

// LayerNorm of the tile's rows in f32 (E values a row, 8 at a time from
// get(r, c, v)), as `_layer_norm_rows`, quantised per row as quant_tile
template <class Get>
__device__ __forceinline__ void ln_quant(int rows, int E, Get get, const float* __restrict__ g,
                                         const float* __restrict__ b, float eps, int8_t* dst,
                                         int ld, float* scale) {
  const int lane = threadIdx.x & 31;
  auto stats = [&](int r) {
    float v[8], sum = 0.f;
    for (int c = 8 * lane; c < E; c += 256) {
      get(r, c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[k];
    }
    const float mu = warp_sum(sum) / (float)E;
    float var = 0.f;
    for (int c = 8 * lane; c < E; c += 256) {
      get(r, c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = v[k] - mu;
        var += t * t;
      }
    }
    return make_float2(mu, 1.f / sqrtf(warp_sum(var) / (float)E + eps));
  };
  auto val = [&](int r, int c, float2 st, float (&v)[8]) {
    float gg[8], bb[8];
    get(r, c, v);
    load8(g + c, gg);
    load8(b + c, bb);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[k] - st.x, st.y), gg[k]), bb[k]);
  };
  quant_tile(rows, E, stats, val, dst, ld, scale);
}

// 8 bf16 columns c .. c + 7 of row r of a 64-row tile that TMA put in shared
// memory as swizzled 64 x 64 tiles
__device__ __forceinline__ void smem_row8(const uint8_t* tiles, int r, int c, float (&v)[8]) {
  Raw<bf16> raw;
  raw.u = *reinterpret_cast<const uint4*>(tiles + (c >> 6) * TILE_BYTES + sw128(r, c & 63));
  raw.get(v);
}

// `_qdot`'s epilogue on a warpgroup's int32 accumulator of columns cw ..
// cw + NW - 1: ((acc * sx[row]) * sw[col]) + b[col], the thread's two rows'
// scales in sx, in place (as f32 bits, which `as_f32` reads); columns at or
// past ncols give 0
__device__ __forceinline__ void dequant_acc(int (&acc)[NW / 2], const float (&sx)[2],
                                            const float* __restrict__ sw,
                                            const float* __restrict__ b, int cw, int ncols) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = cw + 8 * j + 2 * q;  // c even, ncols too
    const bool in = c < ncols;
    const float2 s = f32x2_at(sw + (in ? c : 0)), bb = f32x2_at(b + (in ? c : 0));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * j + e] = __float_as_int(
          in ? dequant(acc[4 * j + e], sx[e >> 1], (e & 1) ? s.y : s.x, (e & 1) ? bb.y : bb.x)
             : 0.f);
  }
}

// ---------------------------------------------------------------------------
// The ring, consumer side
// ---------------------------------------------------------------------------

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == NSTAGE) {
    stage = 0;
    phase ^= 1;
  }
}

// lane 0 of each consumer warp gives the stage back (empty counts 8)
__device__ __forceinline__ void release(uint64_t* empty, int s) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
}

// The products of one stage, 128 bytes deep: four bf16 k16 steps into an
// f32 accumulator, or four s8 k32 steps into an int32 one
__device__ __forceinline__ void wgmma_stage(float (&d)[NW / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) wgmma_ss<NW>(d, da + 2 * kk, db + 2 * kk);
}
__device__ __forceinline__ void wgmma_stage(int (&d)[NW / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < KQ / 32; ++kk) wgmma_s8_n192(d, da + 2 * kk, db + 2 * kk);
}

// acc (m64n192 per warpgroup) += sum over nk stages of A(k) B(k)^T, 128
// bytes deep each: a(k, stage) and b(k, stage) give the swizzled tiles.  One
// group of wgmmas stays in flight while the next stage is awaited.  Both
// warpgroups run every stage, also where one's columns lie past N (zeros or
// stale tiles, never stored), so that no wgmma sits behind a divergent
// branch.
template <class Acc, class FA, class FB>
__device__ __forceinline__ void mma_loop(Acc& acc, int nk, uint64_t* full, uint64_t* empty,
                                         int& stage, uint32_t& phase, FA a, FB b) {
  int prev = -1;
  for (int k = 0; k < nk; ++k) {
    mbar_wait(&full[stage], phase);
    const uint64_t da = desc_sw128(a(k, stage)), db = desc_sw128(b(k, stage));
    fence_acc(acc);
    wg_fence();
    wgmma_stage(acc, da, db);
    wg_commit();
    fence_acc(acc);
    if (prev >= 0) {
      wg_wait<1>();
      release(empty, prev);
    }
    prev = stage;
    advance(stage, phase);
  }
  wg_wait<0>();
  fence_acc(acc);
  if (prev >= 0) release(empty, prev);
}

// ---------------------------------------------------------------------------
// Attention of one (image b, head h), consumer side
// ---------------------------------------------------------------------------

// Q, K and V of the head lie in `data` as nq tiles each (64 rows, swizzled);
// warpgroup w takes the query tiles w, w + 2, ...  Writes the head's output,
// divided by l and rounded to bf16, into o.  Every branch around a wgmma is
// uniform over the block: an odd last query tile is recomputed by the other
// warpgroup and not stored, and a key block past the last tile repeats the
// last tile with every key masked.  KB 64-key chunks of scores are held at
// once; past KB chunks a first pass finds the row max.
template <int KB>
__device__ __forceinline__ void attention(const Params& p, const uint8_t* data, int b, int h) {
  const int t = threadIdx.x & 127, w = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  const int rq = 16 * (t >> 5) + (lane >> 2);
  const int nq = cdiv(p.t_pad, 64), nblk = cdiv(nq, KB);
  const uint8_t* Q = data;
  const uint8_t* K = data + nq * TILE_BYTES;
  const uint8_t* V = data + 2 * nq * TILE_BYTES;
  const int HD = p.H * DH;
  for (int qi = 0; qi < cdiv(nq, 2); ++qi) {
    const int qt = 2 * qi + w;
    const uint64_t dq = desc_sw128(Q + min(qt, nq - 1) * TILE_BYTES);
    float o[32];
    zero(o);
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    // past 256 keys, pass 0 finds the row max over every block first
    for (int pass = nblk > 1 ? 0 : 1; pass < 2; ++pass) {
      for (int blk = 0; blk < nblk; ++blk) {
        const int c0 = blk * KB;
        float s[KB][32];
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          zero(s[c]);
          fence_acc(s[c]);
        }
        wg_fence();
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          const uint64_t dk = desc_sw128(K + min(c0 + c, nq - 1) * TILE_BYTES);
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) wgmma_n64(s[c], dq + 2 * kk, dk + 2 * kk, 1);
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < KB; ++c) fence_acc(s[c]);
        // keys at or past t_real (and every key of a repeated tile) masked
        float bm[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int c = 0; c < KB; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = (c0 + c) * 64 + 8 * j + 2 * q + (e & 1);
              float& v = s[c][4 * j + e];
              v = key < p.t_real ? v : NEG_INF;
              bm[e >> 1] = fmaxf(bm[e >> 1], v);
            }
        bm[0] = quad_max(bm[0]);
        bm[1] = quad_max(bm[1]);
        if (pass == 0) {
          m[0] = fmaxf(m[0], bm[0]);
          m[1] = fmaxf(m[1], bm[1]);
          continue;
        }
        if (nblk == 1) {
          m[0] = bm[0];
          m[1] = bm[1];
        }
        // p = exp(s - m) as 2^(s log2 e - m log2 e) on the special-function
        // unit; l sums it unrounded, P V takes it rounded to bf16,
        // packed in pairs into the first half of each s[c] as the A
        // fragments of P V (the accumulator layout of 16 keys is that of a
        // 64 x 16 A operand), all before the fence
        const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
        for (int c = 0; c < KB; ++c)
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const float p0 = exp2_approx(fmaf(s[c][i], LOG2E, -ml[(i >> 1) & 1]));
            const float p1 = exp2_approx(fmaf(s[c][i + 1], LOG2E, -ml[(i >> 1) & 1]));
            l[(i >> 1) & 1] += p0 + p1;
            s[c][i >> 1] = __uint_as_float(pack_bf16(p0, p1));
          }
        fence_acc(o);
        wg_fence();
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          const uint64_t dv = desc_sw128(V + min(c0 + c, nq - 1) * TILE_BYTES);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_rs_n64(o, __float_as_uint(s[c][4 * ks]), __float_as_uint(s[c][4 * ks + 1]),
                         __float_as_uint(s[c][4 * ks + 2]), __float_as_uint(s[c][4 * ks + 3]),
                         dv + 128 * ks);
        }
        wg_commit();
        wg_wait<0>();
        fence_acc(o);
      }
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const long long row0 = (long long)b * p.t_pad + qt * 64;
    const int rows = qt < nq ? min(64, p.t_pad - qt * 64) : 0;
    epi_rows<8>(o, [&](int rr, int col, float (&v)[8]) {
      const int r = rq + 8 * rr;
      if (r >= rows) return;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] /= l[rr];
      *reinterpret_cast<uint4*>(p.o + (row0 + r) * HD + h * DH + col) = pack8_bf16(v);
    });
  }
}

// The bf16 modes' attention, a function of its own, so that its registers
// are allocated apart from the products'.  (The int8 layer inlines it with
// KEY_BLOCK_Q8: a call there costs its products ptxas's serialisation of
// every wgmma (C7510) and spills of what lives across the call.)
__device__ __noinline__ void attention_item(const Params& p, const uint8_t* data, int b, int h) {
  attention<KEY_BLOCK>(p, data, b, h);
}

// ---------------------------------------------------------------------------
// Work items
// ---------------------------------------------------------------------------

// first image owned by group g (an image belongs to the group of its last row)
__device__ __forceinline__ int image_lo(const Params& p, int g, int groups) {
  return g >= groups ? p.images
                     : min(p.images, (int)((long long)g * p.group * ROWS / p.t_pad));
}

// item i -> kind (0 A tile, 1 (image, head), 2 C tile) and index.  In the
// attention modes step s hands out A of group s, B of group s - LAG_B, C of
// group s - LAG; mode MLP has C tiles only.
template <bool ATTN>
__device__ void decode(const Params& p, int i, int& kind, int& idx) {
  kind = 2, idx = i;
  if (!ATTN) return;
  const int groups = cdiv(p.tiles, p.group);
  for (int s = 0; s < groups + LAG; ++s) {
    if (s < groups) {
      const int a0 = s * p.group, cnt = min(p.group, p.tiles - a0);
      if (i < cnt) {
        kind = 0, idx = a0 + i;
        return;
      }
      i -= cnt;
    }
    if (s >= LAG_B && s - LAG_B < groups) {
      const int b0 = image_lo(p, s - LAG_B, groups);
      const int cnt = (image_lo(p, s - LAG_B + 1, groups) - b0) * p.H;
      if (i < cnt) {
        kind = 1, idx = b0 * p.H + i;
        return;
      }
      i -= cnt;
    }
    if (s >= LAG) {
      const int a0 = (s - LAG) * p.group, cnt = min(p.group, p.tiles - a0);
      if (i < cnt) {
        kind = 2, idx = a0 + i;
        return;
      }
      i -= cnt;
    }
  }
}

struct Smem {
  int* item;            // [2] the block's next items, taken in turn
  uint64_t* full;       // [NSTAGE]
  uint64_t* empty;      // [NSTAGE]
  uint64_t* attn_full;  // Q, K and V of a head have landed
  uint64_t* x_full;     // the tile of x has landed
  uint8_t* data;        // the ring, then the hidden chunk; or Q, K, V
  uint8_t* hbuf;
};

// The producer warpgroup: one thread issues every TMA load of the block's
// items, in the consumers' order; the others only keep the barriers.
template <int MODE>
__device__ void producer(const Params& p, const Smem& sm, int total) {
  constexpr bool ATTN = MODE & MODE_ATTN, MLP = MODE & MODE_MLP, Q8 = MODE & MODE_Q8;
  constexpr int KD = Q8 ? KQ : KT;  // columns of an A or B tile's row
  const int E = p.E, HD = p.H * DH, N3 = 3 * HD;
  const bool issuer = threadIdx.x == CONSUMERS;
  const uint64_t keep = evict_last_policy();
  const int* done_a = p.flags + 1;
  const int* done_b = done_a + p.tiles;
  const int slot_row0 = blockIdx.x * ROWS;
  int stage = 0;
  uint32_t phase = 0;
  // the next ring stage, once the consumers have given it back
  auto next_stage = [&](uint32_t bytes) {
    mbar_wait(&sm.empty[stage], phase ^ 1);
    mbar_expect_tx(&sm.full[stage], bytes);
    return sm.data + stage * STAGE_BYTES;
  };
  // the stages of a wide product (N 192 a warpgroup) of ncols output
  // columns over depth K: the A tile (rows a_row of map a) and the two
  // warpgroups' B tiles (weights w)
  auto wide = [&](const CUtensorMap* a, int a_row, const CUtensorMap* w, int ncols, int K) {
    for (int c0 = 0; c0 < ncols; c0 += 2 * NW) {
      const bool two = c0 + NW < ncols;
      for (int k = 0; k < cdiv(K, KD); ++k) {
        uint8_t* st = next_stage(TILE_BYTES + (two ? 2 : 1) * BW_BYTES);
        tma_2d(st, a, &sm.full[stage], k * KD, a_row);
        tma_2d(st + TILE_BYTES, w, &sm.full[stage], k * KD, c0, keep);
        if (two) tma_2d(st + TILE_BYTES + BW_BYTES, w, &sm.full[stage], k * KD, c0 + NW, keep);
        advance(stage, phase);
      }
    }
  };
  for (int it = 0;; ++it) {
    bar_sync(0, THREADS);  // the block has finished the previous item
    const int item = sm.item[it & 1];
    if (item >= total) break;
    int kind, idx;
    decode<ATTN>(p, item, kind, idx);
    // the tile of x for LN into the ring's memory, free at an item's start
    auto load_x = [&]() {
      if (issuer && E <= X_SMEM_MAX_E) {
        mbar_expect_tx(sm.x_full, E / 64 * TILE_BYTES);
        for (int k = 0; k < E / 64; ++k)
          tma_2d(sm.data + k * TILE_BYTES, &p.m_x, sm.x_full, k * 64, idx * ROWS);
      }
    };
    // waits until the heads of the tile's images are done
    auto wait_heads = [&]() {
      const long long r0 = (long long)idx * ROWS, r1 = min(r0 + ROWS, p.n) - 1;
      for (int b = (int)(r0 / p.t_pad); b <= (int)(r1 / p.t_pad); ++b)
        wait_count(&done_b[b], p.H);
      fence_proxy_global();
    };
    if (kind == 0) {
      load_x();
      bar_sync(BAR_ALL, THREADS);  // xn (int8: xq) is in the slot
      if (issuer) wide(&p.m_slot, slot_row0, &p.m_wqkv, N3, E);
    } else if (kind == 1) {
      if (issuer) {
        const int b = idx / p.H, h = idx % p.H;
        const int t0 = (int)((long long)b * p.t_pad / ROWS);
        const int t1 = (int)(((long long)(b + 1) * p.t_pad - 1) / ROWS);
        for (int t = t0; t <= t1; ++t) wait_count(&done_a[t], 1);
        fence_proxy_global();
        const int nq = cdiv(p.t_pad, 64);
        mbar_expect_tx(sm.attn_full, 3 * nq * TILE_BYTES);
        for (int j = 0; j < nq; ++j)
          for (int part = 0; part < 3; ++part)
            tma_3d(sm.data + (part * nq + j) * TILE_BYTES, &p.m_qkv, sm.attn_full,
                   part * HD + h * DH, j * 64, b);
      }
    } else if (Q8) {
      // the attention output tile into the ring's memory, to be quantised
      if (issuer) {
        wait_heads();
        if (HD <= X_SMEM_MAX_E) {
          mbar_expect_tx(sm.x_full, HD / 64 * TILE_BYTES);
          for (int k = 0; k < HD / 64; ++k)
            tma_2d(sm.data + k * TILE_BYTES, &p.m_o, sm.x_full, k * 64, idx * ROWS);
        }
      }
      bar_sync(BAR_ALL, THREADS);  // oq is in the slot
      if (issuer) wide(&p.m_slot, slot_row0, &p.m_wo, E, HD);
      bar_sync(BAR_ALL, THREADS);  // zq is in the slot
      if (issuer) wide(&p.m_slot, slot_row0, &p.m_w1, p.hidden, E);
      bar_sync(BAR_ALL, THREADS);  // hq is in the slot
      if (issuer) wide(&p.m_slot, slot_row0, &p.m_w2, E, p.hidden);
    } else {
      if (ATTN && issuer) {
        wait_heads();
        wide(&p.m_o, idx * ROWS, &p.m_wo, E, HD);
      }
      if (MLP) {
        if (!ATTN) load_x();
        bar_sync(BAR_ALL, THREADS);  // zn is in the slot
        if (issuer) {
          for (int c0 = 0; c0 < E; c0 += 2 * NW) {
            const bool two = c0 + NW < E;
            // the consumers' order: fc1 of chunk 0; then for each chunk its
            // fc2 stages alternating with the next chunk's fc1 stages.  An fc1
            // stage holds two 64-deep steps: A(k), A(k + 1), W1(k), W1(k + 1);
            // past E and past the hidden width TMA fills zeros.
            const int nst1 = (E / KT + 1) / 2;
            auto fc1 = [&](int hc, int st) {
              const int k = 2 * st;
              uint8_t* s8 = next_stage(2 * TILE_BYTES + 2 * HCHUNK * KT * 2);
              for (int half = 0; half < 2; ++half) {
                tma_2d(s8 + half * TILE_BYTES, &p.m_slot, &sm.full[stage], (k + half) * KT,
                       slot_row0);
                tma_2d(s8 + 2 * TILE_BYTES + half * HCHUNK * KT * 2, &p.m_w1, &sm.full[stage],
                       (k + half) * KT, hc, keep);
              }
              advance(stage, phase);
            };
            auto fc2 = [&](int hc, int kk) {
              uint8_t* s8 = next_stage((two ? 2 : 1) * BW_BYTES);
              tma_2d(s8 + TILE_BYTES, &p.m_w2, &sm.full[stage], hc + kk * KT, c0, keep);
              if (two)
                tma_2d(s8 + TILE_BYTES + BW_BYTES, &p.m_w2, &sm.full[stage], hc + kk * KT,
                       c0 + NW, keep);
              advance(stage, phase);
            };
            for (int st = 0; st < nst1; ++st) fc1(0, st);
            for (int hc = 0; hc < p.hidden; hc += HCHUNK) {
              const int n1 = hc + HCHUNK < p.hidden ? nst1 : 0;
              for (int i = 0; i < FC2_STEPS || i < n1; ++i) {
                if (i < FC2_STEPS) fc2(hc, i);
                if (i < n1) fc1(hc + HCHUNK, i);
              }
            }
          }
        }
      }
    }
    __syncwarp();
  }
}

// The consumers' place in the ring and the parities of their single
// barriers, kept across items.
struct Ring {
  int stage;
  uint32_t phase, attn_phase, x_phase;
};

// Item A (a 64-row tile): LN1 into the slot, then q|k|v = xn Wqkv + b.
template <int MODE>
__device__ __forceinline__ void item_a(const Params& p, const Smem& sm, int idx, Ring& ring) {
  const int E = p.E, N3 = 3 * p.H * DH;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 7, q = lane & 3;
  const int rq = 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int slot_row0 = blockIdx.x * ROWS;
  bf16* slot = p.slot + (long long)slot_row0 * E;
  uint8_t* data = sm.data;
  int stage = ring.stage;
  uint32_t phase = ring.phase;
  auto stage_a = [&](int, int s) -> const void* { return data + s * STAGE_BYTES; };
  auto stage_b = [&](int, int s) -> const void* {
    return data + s * STAGE_BYTES + TILE_BYTES + w * BW_BYTES;
  };
  const long long row0 = (long long)idx * ROWS;
  const int rows = (int)min((long long)ROWS, p.n - row0);
  // LN of the tile's rows of x into the slot: from the TMA copy in shared
  // memory, or (E past X_SMEM_MAX_E) from device memory
  auto ln_x = [&](const float* g, const float* b) {
    if (E <= X_SMEM_MAX_E) {
      mbar_wait(sm.x_full, ring.x_phase);
      ring.x_phase ^= 1;
      ln_smem(data, rows, E, g, b, p.eps, slot);
    } else {
      ln_tile(p.x + row0 * E, rows, E, g, b, p.eps, slot);
    }
  };
  if constexpr (MODE & MODE_Q8) {
    // LN1 in f32, quantised per row into the slot; q|k|v = bf16 of the int8
    // product's epilogue
    float* qs = reinterpret_cast<float*>(sm.hbuf);  // the rows' scales
    if (E <= X_SMEM_MAX_E) {
      mbar_wait(sm.x_full, ring.x_phase);
      ring.x_phase ^= 1;
    }
    ln_quant(
        rows, E,
        [&](int r, int c, float (&v)[8]) {
          if (E <= X_SMEM_MAX_E)
            smem_row8(data, r, c, v);
          else
            load8(p.x + (row0 + r) * E + c, v);
        },
        p.g1, p.be1, p.eps, reinterpret_cast<int8_t*>(p.slot) + (long long)slot_row0 * p.slot_w,
        p.slot_w, qs);
    fence_proxy_global();
    bar_sync(BAR_ALL, THREADS);
    const float sx[2] = {qs[rq], qs[rq + 8]};
    for (int c0 = 0; c0 < N3; c0 += 2 * NW) {
      const int cw = c0 + w * NW;
      int acc[NW / 2];
      zero(acc);
      mma_loop(acc, cdiv(E, KQ), sm.full, sm.empty, stage, phase, stage_a, stage_b);
      dequant_acc(acc, sx, p.sqkv, p.bqkv, cw, N3);
      epi_rows<NW / 8>(acc, [&](int rr, int col, float (&v)[8]) {
        const int r = rq + 8 * rr, c = cw + col;
        if (r < rows && c < N3)
          *reinterpret_cast<uint4*>(p.qkv + (row0 + r) * N3 + c) = pack8_bf16(v);
      });
    }
  } else {
    // LN1 into the slot, then q|k|v = xn Wqkv + b
    ln_x(p.g1, p.be1);
    fence_proxy_global();
    bar_sync(BAR_ALL, THREADS);
    for (int c0 = 0; c0 < N3; c0 += 2 * NW) {
      const int cw = c0 + w * NW;
      float acc[NW / 2];
      zero(acc);
      mma_loop(acc, E / KT, sm.full, sm.empty, stage, phase, stage_a, stage_b);
      // q|k|v = acc + b, a row's 8 columns a lane
      epi_rows<NW / 8>(acc, [&](int rr, int col, float (&v)[8]) {
        const int r = rq + 8 * rr, c = cw + col;
        if (r >= rows || c >= N3) return;
        float b[8];
        load8(p.bqkv + c, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += b[e];
        *reinterpret_cast<uint4*>(p.qkv + (row0 + r) * N3 + c) = pack8_bf16(v);
      });
    }
  }
  ring.stage = stage, ring.phase = phase;
  fence_proxy_global();
  bar_sync(BAR_CONSUMERS, CONSUMERS);
  if (tid == 0) {
    __threadfence();
    atomicAdd(&p.flags[1 + idx], 1);
  }
}

// Item C of the int8 layer (a 64-row tile): the attention output quantised
// per row, z = x + its out projection into the z slot, LN2 of z quantised,
// fc1 with GELU into the hidden slot while the rows' maxima gather, the
// hidden quantised, and y = z + fc2.
__device__ __forceinline__ void item_c_q8(const Params& p, const Smem& sm, int idx, Ring& ring) {
  const int E = p.E, HD = p.H * DH, HID = p.hidden;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 7, q = lane & 3;
  const int rq = 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int slot_row0 = blockIdx.x * ROWS;
  int8_t* slot = reinterpret_cast<int8_t*>(p.slot) + (long long)slot_row0 * p.slot_w;
  float* zslot = p.zslot + (long long)slot_row0 * E;
  float* hslot = p.hslot + (long long)slot_row0 * HID;
  float* qs = reinterpret_cast<float*>(sm.hbuf);  // [64] the rows' scales
  float* red = qs + ROWS;                          // [2][64] the warpgroups' row maxima
  uint8_t* data = sm.data;
  int stage = ring.stage;
  uint32_t phase = ring.phase;
  auto stage_a = [&](int, int s) -> const void* { return data + s * STAGE_BYTES; };
  auto stage_b = [&](int, int s) -> const void* {
    return data + s * STAGE_BYTES + TILE_BYTES + w * BW_BYTES;
  };
  const long long row0 = (long long)idx * ROWS;
  const int rows = (int)min((long long)ROWS, p.n - row0);
  auto no_stats = [](int) { return make_float2(0.f, 0.f); };
  // the slot is ready for the next product's A tiles (the producer waits)
  auto slot_ready = [&]() {
    fence_proxy_global();
    bar_sync(BAR_ALL, THREADS);
  };

  // the attention output, quantised per row: from the ring's memory, where
  // TMA put the tile, or (HD past X_SMEM_MAX_E) from device memory
  if (HD <= X_SMEM_MAX_E) {
    mbar_wait(sm.x_full, ring.x_phase);
    ring.x_phase ^= 1;
  }
  quant_tile(
      rows, HD, no_stats,
      [&](int r, int c, float2, float (&v)[8]) {
        if (HD <= X_SMEM_MAX_E)
          smem_row8(data, r, c, v);
        else
          load8(p.o + (row0 + r) * HD + c, v);
      },
      slot, p.slot_w, qs);
  slot_ready();
  float sx[2] = {qs[rq], qs[rq + 8]};

  // z = x + ((acc so) sw + bo), f32, into the z slot (0 past the last row)
  for (int c0 = 0; c0 < E; c0 += 2 * NW) {
    const int cw = c0 + w * NW;
    int acc[NW / 2];
    zero(acc);
    mma_loop(acc, cdiv(HD, KQ), sm.full, sm.empty, stage, phase, stage_a, stage_b);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = cw + 8 * j + 2 * q;
      if (c < E) {
        const float2 s = f32x2_at(p.so + c), b = f32x2_at(p.bo + c);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = rq + 8 * rr;
          float2 z = make_float2(0.f, 0.f);
          if (r < rows) {
            const float2 xv = bf16x2_at(p.x + (row0 + r) * E + c);
            z.x = __fadd_rn(xv.x, dequant(acc[4 * j + 2 * rr], sx[rr], s.x, b.x));
            z.y = __fadd_rn(xv.y, dequant(acc[4 * j + 2 * rr + 1], sx[rr], s.y, b.y));
          }
          *reinterpret_cast<float2*>(zslot + r * E + c) = z;
        }
      }
    }
  }
  bar_sync(BAR_CONSUMERS, CONSUMERS);  // z is in its slot

  // LN2 of z in f32, quantised per row
  ln_quant(
      rows, E, [&](int r, int c, float (&v)[8]) { load8(zslot + r * E + c, v); }, p.g2, p.be2,
      p.eps, slot, p.slot_w, qs);
  slot_ready();
  sx[0] = qs[rq], sx[1] = qs[rq + 8];

  // fc1: h = GELU((acc sz) s1 + b1) into the hidden slot, f32, while each
  // row's absolute maximum gathers
  float hmax[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < HID; c0 += 2 * NW) {
    const int cw = c0 + w * NW;
    int acc[NW / 2];
    zero(acc);
    mma_loop(acc, cdiv(E, KQ), sm.full, sm.empty, stage, phase, stage_a, stage_b);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = cw + 8 * j + 2 * q;
      if (c < HID) {
        const float2 s = f32x2_at(p.s1 + c), b = f32x2_at(p.b1 + c);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float h0 = gelu_as(dequant(acc[4 * j + 2 * rr], sx[rr], s.x, b.x));
          const float h1 = gelu_as(dequant(acc[4 * j + 2 * rr + 1], sx[rr], s.y, b.y));
          hmax[rr] = fmaxf(hmax[rr], fmaxf(fabsf(h0), fabsf(h1)));
          *reinterpret_cast<float2*>(hslot + (rq + 8 * rr) * HID + c) = make_float2(h0, h1);
        }
      }
    }
  }
  // the rows' maxima meet: over each quad, then across the warpgroups
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float m = quad_max(hmax[rr]);
    if (q == 0) red[w * ROWS + rq + 8 * rr] = m;
  }
  bar_sync(BAR_CONSUMERS, CONSUMERS);  // the maxima, and the hidden, are in place
  // the hidden, quantised per row over all its units, into the slot
  for (int i = 8 * tid; i < ROWS * HID; i += 8 * CONSUMERS) {
    const int r = i / HID, c = i % HID;
    const float amax = fmaxf(fmaxf(red[r], red[ROWS + r]), 1e-6f);
    float v[8];
    load8(hslot + r * HID + c, v);
    *reinterpret_cast<uint2*>(slot + (long long)r * p.slot_w + c) =
        quant8(v, __fdiv_rn(127.f, amax));
  }
  if (tid < ROWS) qs[tid] = __fmul_rn(fmaxf(fmaxf(red[tid], red[ROWS + tid]), 1e-6f), 1.f / 127.f);
  slot_ready();
  sx[0] = qs[rq], sx[1] = qs[rq + 8];

  // fc2: y = bf16(z + ((acc sh) s2 + b2))
  for (int c0 = 0; c0 < E; c0 += 2 * NW) {
    const int cw = c0 + w * NW;
    int acc[NW / 2];
    zero(acc);
    mma_loop(acc, cdiv(HID, KQ), sm.full, sm.empty, stage, phase, stage_a, stage_b);
    dequant_acc(acc, sx, p.s2, p.b2, cw, E);
    epi_rows<NW / 8>(acc, [&](int rr, int col, float (&v)[8]) {
      const int r = rq + 8 * rr, c = cw + col;
      if (r >= rows || c >= E) return;
      float z[8];
      load8(zslot + r * E + c, z);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(z[e], v[e]);
      *reinterpret_cast<uint4*>(p.y + (row0 + r) * E + c) = pack8_bf16(v);
    });
  }
  ring.stage = stage, ring.phase = phase;
}

// Item C (a 64-row tile): the out projection with the residual into z (or
// y), LN2, the MLP and y = z + MLP.
template <int MODE>
__device__ __forceinline__ void item_c(const Params& p, const Smem& sm, int idx, Ring& ring) {
  constexpr bool ATTN = MODE & MODE_ATTN, MLP = MODE & MODE_MLP;
  const int E = p.E, HD = p.H * DH;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 7, q = lane & 3;
  const int rq = 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int slot_row0 = blockIdx.x * ROWS;
  bf16* slot = p.slot + (long long)slot_row0 * E;
  float* zslot = p.zslot + (long long)slot_row0 * E;
  uint8_t* data = sm.data;
  uint8_t* hbuf = sm.hbuf;
  int stage = ring.stage;
  uint32_t phase = ring.phase;
  auto stage_a = [&](int, int s) -> const void* { return data + s * STAGE_BYTES; };
  auto stage_b = [&](int, int s) -> const void* {
    return data + s * STAGE_BYTES + TILE_BYTES + w * BW_BYTES;
  };
  const long long row0 = (long long)idx * ROWS;
  const int rows = (int)min((long long)ROWS, p.n - row0);
  // LN of the tile's rows of x into the slot: from the TMA copy in shared
  // memory, or (E past X_SMEM_MAX_E) from device memory
  auto ln_x = [&](const float* g, const float* b) {
    if (E <= X_SMEM_MAX_E) {
      mbar_wait(sm.x_full, ring.x_phase);
      ring.x_phase ^= 1;
      ln_smem(data, rows, E, g, b, p.eps, slot);
    } else {
      ln_tile(p.x + row0 * E, rows, E, g, b, p.eps, slot);
    }
  };
  auto h_a = [&](int k, int) -> const void* { return hbuf + k * TILE_BYTES; };
  if (ATTN) {
    // out projection: (x + bo) + acc, into z (merged) or y
    for (int c0 = 0; c0 < E; c0 += 2 * NW) {
      const int cw = c0 + w * NW;
      float acc[NW / 2];
      zero(acc);
      mma_loop(acc, HD / KT, sm.full, sm.empty, stage, phase, stage_a, stage_b);
      auto value = [&](int j, int rr) {
        const int r = rq + 8 * rr, c = cw + 8 * j + 2 * q;
        if (r >= rows || c >= E) return make_float2(0.f, 0.f);
        const float2 xv = bf16x2_at(p.x + (row0 + r) * E + c), b = f32x2_at(p.bo + c);
        return make_float2(__fadd_rn(__fadd_rn(xv.x, b.x), acc[4 * j + 2 * rr]),
                           __fadd_rn(__fadd_rn(xv.y, b.y), acc[4 * j + 2 * rr + 1]));
      };
      // z in place of the sums
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 v = value(j, rr);
          acc[4 * j + 2 * rr] = v.x;
          acc[4 * j + 2 * rr + 1] = v.y;
        }
      epi_rows<NW / 8>(acc, [&](int rr, int col, float (&v)[8]) {
        const int r = rq + 8 * rr, c = cw + col;
        if (c >= E) return;
        if (MLP) {
          float4* d = reinterpret_cast<float4*>(zslot + r * E + c);
          d[0] = make_float4(v[0], v[1], v[2], v[3]);
          d[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else if (r < rows) {
          *reinterpret_cast<uint4*>(p.y + (row0 + r) * E + c) = pack8_bf16(v);
        }
      });
      // one pass holds the tile's whole z: LN2 runs on the registers
      if (MLP && E <= 2 * NW)
        ln_regs(acc, cw, E, p.g2, p.be2, p.eps, reinterpret_cast<float*>(hbuf), slot);
    }
  }
  if (MLP) {
    // LN2 into the slot (above, from the registers, where E <= 2 NW)
    if (ATTN && E > 2 * NW) {
      bar_sync(BAR_CONSUMERS, CONSUMERS);  // z is in the slot
      ln_tile(static_cast<const float*>(zslot), rows, E, p.g2, p.be2, p.eps, slot);
    } else if (!ATTN) {
      ln_x(p.g2, p.be2);
    }
    fence_proxy_global();
    bar_sync(BAR_ALL, THREADS);
    for (int c0 = 0; c0 < E; c0 += 2 * NW) {
      const int cw = c0 + w * NW;
      float yacc[NW / 2];
      zero(yacc);
      // h = GELU(acc + b1) of chunk hc in place: free of branches so that
      // the compiler interleaves the elements; columns past the hidden
      // width (a last, partial chunk) are zero
      auto gelu = [&](float (&h)[NH / 2], int hc) {
#pragma unroll
        for (int j = 0; j < NH / 8; ++j) {
          const int c = hc + w * NH + 8 * j + 2 * q;  // c even, the hidden width too
          const bool in = c < p.hidden;
          const float2 b = f32x2_at(p.b1 + (in ? c : 0));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = gelu_as(h[4 * j + e] + ((e & 1) ? b.y : b.x));
            h[4 * j + e] = in ? v : 0.f;
          }
        }
      };
      // The products of the MLP as one stream of ring stages: an fc1 stage
      // holds two 64-deep steps (zn and W1; a step past E is zeros), an fc2
      // stage one (W2; h from hbuf).  Each stage is released once the
      // wgmmas of the next have been issued.
      int prev = -1;
      auto retire = [&]() {
        if (prev >= 0) {
          wg_wait<1>();
          release(sm.empty, prev);
        }
        prev = stage;
        advance(stage, phase);
      };
      auto issue_fc1 = [&](float (&acc)[NH / 2]) {
        mbar_wait(&sm.full[stage], phase);
        const uint8_t* base = data + stage * STAGE_BYTES;
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint64_t da = desc_sw128(base + half * TILE_BYTES);
          const uint64_t db =
              desc_sw128(base + 2 * TILE_BYTES + half * HCHUNK * 128 + w * NH * 128);
#pragma unroll
          for (int k16 = 0; k16 < KT / 16; ++k16) wgmma_ss<NH>(acc, da + 2 * k16, db + 2 * k16);
        }
        wg_commit();
        fence_acc(acc);
        retire();
      };
      auto issue_fc2 = [&](int kk) {
        mbar_wait(&sm.full[stage], phase);
        const uint64_t da = desc_sw128(hbuf + kk * TILE_BYTES), db = desc_sw128(stage_b(kk, stage));
        fence_acc(yacc);
        wg_fence();
#pragma unroll
        for (int k16 = 0; k16 < KT / 16; ++k16) wgmma_ss<NW>(yacc, da + 2 * k16, db + 2 * k16);
        wg_commit();
        fence_acc(yacc);
        retire();
      };
      auto drain = [&]() {
        wg_wait<0>();
        if (prev >= 0) release(sm.empty, prev);
        prev = -1;
      };
      const int nst1 = (E / KT + 1) / 2;  // fc1 stages a chunk
      // The chunks, their fc1 sums in hacc: GELU of hacc; h to hbuf; then
      // this chunk's fc2 stages alternate with the next chunk's fc1 stages
      // (into hacc again).  The producer loads the stages in that order.
      float hacc[NH / 2];
      zero(hacc);
      for (int st = 0; st < nst1; ++st) issue_fc1(hacc);
      for (int hc = 0; hc < p.hidden; hc += HCHUNK) {
        drain();  // this chunk's fc1 and the previous chunk's fc2 are done
        fence_acc(hacc);
        gelu(hacc, hc);
        bar_sync(BAR_CONSUMERS, CONSUMERS);  // both have read the previous chunk
#pragma unroll
        for (int j = 0; j < NH / 8; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int cl = w * NH + 8 * j + 2 * q;
            *reinterpret_cast<uint32_t*>(hbuf + (cl >> 6) * TILE_BYTES +
                                         sw128(rq + 8 * rr, cl & 63)) =
                pack_bf16(hacc[4 * j + 2 * rr], hacc[4 * j + 2 * rr + 1]);
          }
        fence_proxy_shared();
        bar_sync(BAR_CONSUMERS, CONSUMERS);  // the chunk is in hbuf
        const int n1 = hc + HCHUNK < p.hidden ? nst1 : 0;
        zero(hacc);
        for (int i = 0; i < FC2_STEPS || i < n1; ++i) {
          if (i < FC2_STEPS) issue_fc2(i);
          if (i < n1) issue_fc1(hacc);
        }
      }
      drain();
      fence_acc(yacc);
      // y = z + (acc + b2), a row's 8 columns a lane
      epi_rows<NW / 8>(yacc, [&](int rr, int col, float (&v)[8]) {
        const int r = rq + 8 * rr, c = cw + col;
        if (r >= rows || c >= E) return;
        float res[8], b[8];
        if (ATTN)
          load8(zslot + r * E + c, res);
        else
          load8(p.x + (row0 + r) * E + c, res);
        load8(p.b2 + c, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(res[e], __fadd_rn(v[e], b[e]));
        *reinterpret_cast<uint4*>(p.y + (row0 + r) * E + c) = pack8_bf16(v);
      });
    }
  }
  ring.stage = stage, ring.phase = phase;
}

// The two consumer warpgroups: the prologues, every product and epilogue.
template <int MODE>
__device__ void consumer(const Params& p, const Smem& sm, int total) {
  Ring ring{0, 0, 0, 0};
  for (int it = 0;; ++it) {
    // thread 0 takes the next item from the launch's counter; the slot it
    // writes was last read before the previous barrier
    if (threadIdx.x == 0) sm.item[it & 1] = atomicAdd(p.flags, 1);
    bar_sync(0, THREADS);  // the block has finished the previous item
    const int item = sm.item[it & 1];
    if (item >= total) break;
    int kind, idx;
    decode<MODE & MODE_ATTN>(p, item, kind, idx);
    if (kind == 0) {
      item_a<MODE>(p, sm, idx, ring);
    } else if (kind == 1) {
      mbar_wait(sm.attn_full, ring.attn_phase);
      ring.attn_phase ^= 1;
      if constexpr (MODE & MODE_Q8)
        attention<KEY_BLOCK_Q8>(p, sm.data, idx / p.H, idx % p.H);
      else
        attention_item(p, sm.data, idx / p.H, idx % p.H);
      fence_proxy_global();
      bar_sync(BAR_CONSUMERS, CONSUMERS);
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(&p.flags[1 + p.tiles + idx / p.H], 1);
      }
    } else if constexpr (MODE & MODE_Q8) {
      item_c_q8(p, sm, idx, ring);
    } else {
      item_c<MODE>(p, sm, idx, ring);
    }
  }
}

// One block an SM takes items from the launch's counter until none are
// left; an item only waits on items taken before it by running blocks, so
// the earliest unfinished item never waits.  The producer warpgroup gives
// its registers to the consumers (setmaxnreg).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) vit_layer_sm90(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  Smem sm;
  sm.full = reinterpret_cast<uint64_t*>(base);
  sm.empty = sm.full + NSTAGE;
  sm.attn_full = sm.empty + NSTAGE;
  sm.x_full = sm.attn_full + 1;
  sm.item = reinterpret_cast<int*>(sm.x_full + 1);
  sm.data = base + HEAD_BYTES;
  sm.hbuf = sm.data + NSTAGE * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS / 32);
    }
    mbar_init(sm.attn_full, 1);
    mbar_init(sm.x_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = (MODE & MODE_ATTN) ? 2 * p.tiles + p.images * p.H : p.tiles;
  // registers a thread: producer 128 x P + consumers 256 x C <= 65,536;
  // mode MLP measured fastest with the most for its consumers, the
  // attention modes with 232 (their producer needs more than 24)
  constexpr int CONSUMER_REGS = MODE == MODE_MLP ? 240 : 232;
  constexpr int PRODUCER_REGS = MODE == MODE_MLP ? 24 : 40;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    producer<MODE>(p, sm, total);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    consumer<MODE>(p, sm, total);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver PyTorch has loaded, found once
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int ENCODE_FAILED = 1000;  // + the CUresult

// a map of a bf16 (or int8) array of `rank` dims (innermost first, each row
// of the box 128 bytes wide, 128-byte swizzle, zero fill past the edges)
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint32_t* box, bool int8 = false) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return ENCODE_FAILED;
  cuuint64_t strides[2];
  strides[0] = dims[0] * (int8 ? 1 : 2);
  if (rank > 2) strides[1] = strides[0] * dims[1];
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        rank, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

int encode_2d(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows,
              bool int8 = false) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint32_t box[2] = {int8 ? (cuuint32_t)KQ : (cuuint32_t)KT, (cuuint32_t)box_rows};
  return encode(map, ptr, 2, dims, box, int8);
}

__host__ inline size_t align1k(size_t b) { return (b + 1023) / 1024 * 1024; }

// bytes of a row of the int8 layer's slot: every A operand it holds
int slot_width(int E, int HD, int hidden) {
  const int w = E > HD ? E : HD;
  return w > hidden ? w : hidden;
}

// Byte offsets of the workspace regions (fused_layer.py mirrors this in
// `sm90_workspace_bytes`): the counters, q|k|v and the attention output of
// every row (attention modes), each block's slot (bf16, 64 x E; int8, 64 x
// slot_width), in the merged modes its f32 slot for z, and for int8 its
// f32 slot for the hidden.
struct Layout {
  size_t flags, qkv, o, slot, zslot, hslot, total;
};

Layout layout(int mode, long long n, int t_pad, int E, int HD, int hidden, int slots) {
  const bool attn = mode & MODE_ATTN, q8 = mode & MODE_Q8;
  const size_t tiles = (size_t)cdiv(n, ROWS), images = attn ? (size_t)(n / t_pad) : 0;
  Layout L;
  L.flags = 0;
  L.qkv = align1k(4 * (1 + tiles + images));
  L.o = L.qkv + (attn ? align1k((size_t)n * 3 * HD * 2) : 0);
  L.slot = L.o + (attn ? align1k((size_t)n * HD * 2) : 0);
  L.zslot = L.slot + align1k((size_t)slots * ROWS * (q8 ? slot_width(E, HD, hidden) : E * 2));
  L.hslot = L.zslot + ((mode & (MODE_ATTN | MODE_MLP)) == (MODE_ATTN | MODE_MLP)
                           ? align1k((size_t)slots * ROWS * E * 4)
                           : 0);
  L.total = L.hslot + (q8 ? align1k((size_t)slots * ROWS * hidden * 4) : 0);
  return L;
}

size_t smem_bytes(int mode, int t_pad) {
  const size_t attn = (mode & MODE_ATTN) ? (size_t)3 * cdiv(t_pad, 64) * TILE_BYTES : 0;
  return ALIGN + HEAD_BYTES + (attn > (size_t)GEMM_BYTES ? attn : (size_t)GEMM_BYTES);
}

template <int MODE>
int launch(Params& P, int slots, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, P.t_pad);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vit_layer_sm90<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int total = (MODE & MODE_ATTN) ? 2 * P.tiles + P.images * P.H : P.tiles;
  const int grid = slots < total ? slots : total;
  vit_layer_sm90<MODE><<<grid, THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel of `mode` at t_pad: its registers a thread, its dynamic shared
// memory and the blocks an SM holds.  Returns a cudaError_t as int.
extern "C" int vit_layer_sm90_info(int mode, int t_pad, int* regs, int* smem, int* blocks) {
  constexpr int BOTH = MODE_ATTN | MODE_MLP;
  const void* fn = mode == MODE_ATTN          ? (const void*)vit_layer_sm90<MODE_ATTN>
                   : mode == MODE_MLP         ? (const void*)vit_layer_sm90<MODE_MLP>
                   : mode == (BOTH | MODE_Q8) ? (const void*)vit_layer_sm90<BOTH | MODE_Q8>
                                              : (const void*)vit_layer_sm90<BOTH>;
  *smem = (int)smem_bytes(mode, t_pad);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, *smem);
  *regs = attr.numRegs;
  return (int)err;
}

// The four weight maps of a layer into `maps` (host memory, 4 x 128
// bytes, in the order wqkv, wo, w1, w2): the packed W^T, bf16 (int8 with
// q8), (3 HD, E), (E, HD), (hidden, E) and (E, hidden); a null pointer
// leaves its map zero.  Returns 0, or an error code.
extern "C" int vit_layer_sm90_weight_maps(void* maps, const void* wqkv_t, const void* wo_t,
                                          const void* w1_t, const void* w2_t, int E, int H,
                                          int hidden, int q8) {
  const int HD = H * DH;
  const void* ptr[4] = {wqkv_t, wo_t, w1_t, w2_t};
  const long long rows[4] = {3LL * HD, E, hidden, E};
  // int8 runs every product in the wide form, fc1 too
  const int cols[4] = {E, HD, E, hidden}, box[4] = {NW, NW, q8 ? NW : HCHUNK, NW};
  for (int i = 0; i < 4; ++i) {
    CUtensorMap m;
    memset(&m, 0, sizeof(m));
    if (ptr[i] != nullptr) {
      const int rc = encode_2d(&m, ptr[i], rows[i], cols[i], box[i], q8 != 0);
      if (rc != 0) return rc;
    }
    memcpy(static_cast<char*>(maps) + i * sizeof(CUtensorMap), &m, sizeof(m));
  }
  return 0;
}

// One launch of the bf16 layer in `mode` (1 ATTN, 2 MLP, 3 ATTN|MLP, 7 the
// int8 layer) on n_rows rows of x (images of t_pad rows in the attention
// modes), at most `slots` blocks.  `maps` holds the weight maps of
// vit_layer_sm90_weight_maps; biases, LN parameters and the int8 weights'
// column scales (sqkv, so, s1, s2; mode 7 only) are f32, bqkv with q's part
// pre-scaled.  ws holds `ws_bytes` (`layout`).
// Returns a cudaError_t as int (or 1000 + a CUresult): 0 when the launch was
// accepted.
extern "C" int launch_vit_layer_sm90(int mode, const void* x, void* y, void* ws,
                                     long long ws_bytes, int slots, const void* maps,
                                     const float* g1, const float* be1, const float* bqkv,
                                     const float* bo, const float* g2, const float* be2,
                                     const float* b1, const float* b2, const float* sqkv,
                                     const float* so, const float* s1, const float* s2,
                                     long long n_rows, int t_pad, int t_real, int E, int H,
                                     int hidden, float eps, cudaStream_t stream) {
  const bool attn = mode & MODE_ATTN, q8 = mode & MODE_Q8;
  if ((mode < 1 || mode > 3) && mode != (MODE_ATTN | MODE_MLP | MODE_Q8))
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0 || slots <= 0 || E % 64 || hidden % 64 || H <= 0 ||
      (attn && (t_pad <= 0 || t_pad % 8 || t_real <= 0 || t_real > t_pad || n_rows % t_pad)))
    return (int)cudaErrorInvalidValue;
  const int HD = H * DH;
  const Layout L = layout(mode, n_rows, t_pad, E, HD, hidden, slots);
  if ((long long)L.total != ws_bytes) return (int)cudaErrorInvalidValue;
  Params P;
  memset(&P, 0, sizeof(P));
  memcpy(&P.m_wqkv, maps, 4 * sizeof(CUtensorMap));
  char* w = static_cast<char*>(ws);
  P.x = static_cast<const bf16*>(x);
  P.y = static_cast<bf16*>(y);
  P.qkv = reinterpret_cast<bf16*>(w + L.qkv);
  P.o = reinterpret_cast<bf16*>(w + L.o);
  P.slot = reinterpret_cast<bf16*>(w + L.slot);
  P.zslot = reinterpret_cast<float*>(w + L.zslot);
  P.hslot = reinterpret_cast<float*>(w + L.hslot);
  P.flags = reinterpret_cast<int*>(w + L.flags);
  P.g1 = g1, P.be1 = be1, P.bqkv = bqkv, P.bo = bo, P.g2 = g2, P.be2 = be2, P.b1 = b1, P.b2 = b2;
  P.sqkv = sqkv, P.so = so, P.s1 = s1, P.s2 = s2;
  P.slot_w = slot_width(E, HD, hidden);
  P.n = n_rows;
  P.tiles = cdiv(n_rows, ROWS);
  P.images = attn ? (int)(n_rows / t_pad) : 0;
  P.t_pad = attn ? t_pad : ROWS;
  P.t_real = t_real, P.E = E, P.H = H, P.hidden = hidden, P.eps = eps;
  // a group of row tiles whose live q|k|v and attention output fit
  // WINDOW_BYTES
  const long long live = (long long)ROWS * HD * 2 * (3 * (LAG_B + 1) + (LAG - LAG_B + 1));
  P.group = (int)(WINDOW_BYTES / live);
  if (P.group < 1) P.group = 1;
  int rc = q8 ? encode_2d(&P.m_slot, P.slot, (long long)slots * ROWS, P.slot_w, ROWS, true)
              : encode_2d(&P.m_slot, P.slot, (long long)slots * ROWS, E, ROWS);
  if (rc == 0) rc = encode_2d(&P.m_x, P.x, n_rows, E, 64);
  if (rc == 0 && attn) rc = encode_2d(&P.m_o, P.o, n_rows, HD, 64);
  if (rc == 0 && attn) {
    const cuuint64_t dims[3] = {(cuuint64_t)3 * HD, (cuuint64_t)t_pad,
                                (cuuint64_t)(n_rows / t_pad)};
    const cuuint32_t box[3] = {64, 64, 1};
    rc = encode(&P.m_qkv, P.qkv, 3, dims, box);
  }
  if (rc != 0) return rc;
  cudaError_t err = cudaMemsetAsync(w + L.flags, 0, 4 * (1 + P.tiles + P.images), stream);
  if (err != cudaSuccess) return (int)err;
  switch (mode) {
    case MODE_ATTN: return launch<MODE_ATTN>(P, slots, stream);
    case MODE_MLP: return launch<MODE_MLP>(P, slots, stream);
    case MODE_ATTN | MODE_MLP: return launch<MODE_ATTN | MODE_MLP>(P, slots, stream);
    default: return launch<MODE_ATTN | MODE_MLP | MODE_Q8>(P, slots, stream);
  }
}
