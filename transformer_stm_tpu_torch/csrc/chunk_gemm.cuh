// chunk_gemm: the 3xTF32 GEMM kernel over row chunks, shared by the
// training MLP at D 384 and 768 (csrc/fused_mlp_train.cu, namespace chunk)
// and the float32 ViT layer (csrc/fused_layer.cu, namespace f32layer); and
// chunk_gemm_s8, its int8 sibling, the int8 ViT layer's on float32 x
// (csrc/fused_layer.cu, namespace q8layer).
//
// One launch computes up to MAX_JOBS products C = A B^T, each cut into 128 x
// 192 tiles (m-major), K in stages of 32: A f32 as stored (K inner, M rows),
// B split into TF32 big and small halves (K inner, N rows, big/small), both
// K-major as .tf32 wgmma reads them.  A block takes one tile: its two
// warpgroups take 64 rows each and every column; thread 0 fills a ring of
// NSTAGE stages by TMA.  What a tile's sums become is the caller's: the
// kernel is a template over the caller's parameter block P, whose first
// members are `Job job[MAX_JOBS]; int jobs;`, and calls
//
//   epilogue(const P&, int epi, int part, int mb, int nb, const float (&acc)[BN / 2])
//
// found by argument-dependent lookup in P's namespace: acc[4 j + 2 e2 + e1]
// is element (mb + 8 e2, nb + 8 j + e1) of the job's C, and `part` the
// tile's part of K (Job::k_parts).
//
// chunk_gemm_s8 takes the same jobs, tiles and ring with int8 operands,
// both as stored and K-major, as .s8 wgmma reads them: A (K inner, M rows)
// and B = W^T (K inner, N rows).  A stage is one 128-byte swizzled atom of
// each, 128 int8 columns: four m64n192k32 steps into int32 sums, which are
// exact (|acc| <= 127^2 K < 2^31 for K below 133,000), so the stages run
// back to back into one accumulator.  Past K (a multiple of 64, so the last
// stage may be half past the end) and past N, TMA fills both operands with
// zeros.  Its epilogue has the same form with `const int (&acc)[BN / 2]`.
//
// The kernel's design and its measured limits are in csrc/fused_mlp_train.cu
// (its header) and PERF.md.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace cgemm {

using namespace tf32x3;

constexpr int BM = 128;                            // rows of a tile: two warpgroups of 64
constexpr int BN = 192;                            // columns of a tile
constexpr int BK = 32;                             // K of a stage: one 128-byte atom of f32
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 4;               // A's box as stored, 16 KB
constexpr int B_BYTES = BN * BK * 4;               // B's big or small box, 24 KB
constexpr int STAGE = A_BYTES + 2 * B_BYTES;       // 64 KB
constexpr int NSTAGE = 3;
constexpr int SMALL_BYTES = A_BYTES / 2;           // a warpgroup's 64 rows of A's small half
constexpr int ALIGN = 1024;                        // of the swizzled boxes
constexpr int HEAD = 1024;                         // mbarriers
// the ring, then two small-half buffers for each warpgroup: 231,424 bytes
constexpr int SMEM = ALIGN + HEAD + NSTAGE * STAGE + 2 * 2 * SMALL_BYTES;
static_assert(SMEM <= 232448, "shared memory");
constexpr int MAX_JOBS = 3;
// chunk_gemm_s8: a stage is 128 int8 columns of A's box and B's
constexpr int QK = 128;                            // K of an int8 stage
constexpr int QA_BYTES = BM * QK;                  // 16 KB
constexpr int QB_BYTES = BN * QK;                  // 24 KB
constexpr int QSTAGE = QA_BYTES + QB_BYTES;        // 40 KB
constexpr int QNSTAGE = 4;
constexpr int QSMEM = ALIGN + HEAD + QNSTAGE * QSTAGE;  // 165,888 bytes
static_assert(QSMEM <= 232448, "shared memory");

// One product C = A B^T of a launch: tiles of 128 x 192 in m-major order,
// K in stages of 32.
struct Job {
  CUtensorMap a;  // box 32 x 128
  CUtensorMap b;  // box 32 x 192 x 1
  int a_row0;     // A's row of the first tile row
  int m_tiles, n_tiles, k_stages, epi;
  int k_parts;    // K in parts of k_stages stages, each part its own tiles
};

// One 128 x 192 tile of one job a block: the two warpgroups take 64 rows
// each and every column.  Thread 0 also fills a ring of NSTAGE stages by
// TMA (A's box as stored, B's big and small boxes), up to NSTAGE stages
// ahead, waiting for a slot only when the stage it needs next is not issued
// yet; every warp releases each stage.  A warpgroup splits its 64 rows of
// A in shared memory (split_a), so that every product reads both operands
// from there, and takes the stages in pairs: it splits the next stage while
// the last one's products run.  A pair's products (3 a k-step, 24) go into
// a fresh accumulator added into the tile's with f32 adds (the tensor
// cores truncate as they accumulate).
// the job of a launch's tile `tile`, which becomes the tile's index in it
template <class P>
__device__ __forceinline__ int job_of(const P& p, int& tile) {
  int jn = 0;
  while (jn + 1 < p.jobs && tile >= p.job[jn].m_tiles * p.job[jn].n_tiles * p.job[jn].k_parts) {
    tile -= p.job[jn].m_tiles * p.job[jn].n_tiles * p.job[jn].k_parts;
    ++jn;
  }
  return jn;
}

template <class P>
__global__ void __launch_bounds__(THREADS, 1) chunk_gemm(const __grid_constant__ P p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + NSTAGE;
  uint8_t* stages = base + HEAD;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int tile = blockIdx.x;
  const Job& jb = p.job[job_of(p, tile)];
  const int mt = tile % jb.m_tiles, nt = tile / jb.m_tiles % jb.n_tiles, nk = jb.k_stages;
  const int part = tile / (jb.m_tiles * jb.n_tiles), k0 = BK * nk * part;
  const int arow = jb.a_row0 + BM * mt, brow = BN * nt;
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ra = 64 * w + 16 * wi + g;  // the thread's first row of A's box

  int issued = 0;  // thread 0's count of stages issued
  auto fill = [&](int need) {
    if (threadIdx.x == 0) {
      const int ahead = min(nk, need + NSTAGE);
      while (issued < ahead) {
        const int s = issued % NSTAGE, use = issued / NSTAGE;
        if (use > 0) {
          if (issued == need)
            mbar_wait(&empty[s], (use - 1) & 1);
          else if (!mbar_test(&empty[s], (use - 1) & 1))
            break;
        }
        uint8_t* st = stages + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_3d(st, &jb.a, &full[s], k0 + BK * issued, arow, 0);
        tma_3d(st + A_BYTES, &jb.b, &full[s], k0 + BK * issued, brow, 0);
        tma_3d(st + A_BYTES + B_BYTES, &jb.b, &full[s], k0 + BK * issued, brow, 1);
        ++issued;
      }
    }
    __syncwarp();
  };

  // Stage u's A rows of this warpgroup, split once they have arrived: the
  // big half over the box in place, the small half into the warpgroup's
  // buffer u % 2 (the same swizzled positions: the split maps each 16-byte
  // chunk to itself).
  uint8_t* smalls = stages + NSTAGE * STAGE + w * 2 * SMALL_BYTES;
  auto split_a = [&](int u) {
    fill(u);
    mbar_wait(&full[u % NSTAGE], (u / NSTAGE) & 1);
    uint8_t* box = stages + (u % NSTAGE) * STAGE + w * SMALL_BYTES;
    uint8_t* small = smalls + (u & 1) * SMALL_BYTES;
#pragma unroll
    for (int q = tid; q < SMALL_BYTES / 16; q += 128) {
      float4* at = reinterpret_cast<float4*>(box + 16 * q);
      const float4 v = *at;
      float4 b, sm;
      split(v.x, b.x, sm.x), split(v.y, b.y, sm.y), split(v.z, b.z, sm.z), split(v.w, b.w, sm.w);
      *at = b;
      *reinterpret_cast<float4*>(small + 16 * q) = sm;
    }
    fence_proxy_shared();
    bar_sync(1 + w, 128);
  };
  auto products = [&](int u, float(&d)[BN / 2]) {
    const uint8_t* st = stages + (u % NSTAGE) * STAGE;
    wg_fence();
    mma3_ss<BN, 4>(d, desc_sw128(st + w * SMALL_BYTES), desc_sw128(smalls + (u & 1) * SMALL_BYTES),
                   BM / 2, desc_sw128(st + A_BYTES), desc_sw128(st + A_BYTES + B_BYTES), BN);
    wg_commit();
  };
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(&empty[u % NSTAGE]);
  };

  // Stages in pairs, a pair's products (six a k-step) into one fresh
  // accumulator: the next stage's A is split while the last stage's
  // products run, so that a warpgroup keeps the tensor cores fed.
  float acc[BN / 2], fresh[BN / 2];
  zero(acc);
  split_a(0);
  for (int u = 0; u < nk; u += 2) {
    zero(fresh);
    products(u, fresh);
    if (u + 1 < nk) {
      split_a(u + 1);
      products(u + 1, fresh);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    release(u);
    if (u + 2 < nk) split_a(u + 2);  // its small buffer is stage u's, whose products are done
    if (u + 1 < nk) {
      wg_wait<0>();
      release(u + 1);
    }
    fence_acc(fresh);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += fresh[i];
  }
  epilogue(p, jb.epi, part, BM * mt + ra, brow + 2 * t, acc);
}

// d (m64n192 s32) += A (shared, K-major) B (shared, K-major), s8 in
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

// One 128 x 192 tile of one job a block, int8: the ring of chunk_gemm with
// QNSTAGE stages of A's and B's 128-column boxes as stored.  Each
// warpgroup runs a stage's four k32 steps as soon as it has landed and
// gives the stage back once they are done: no wgmma is in flight across a
// barrier wait, whose trap path would make ptxas serialise every wgmma
// (C7518).
template <class P>
__global__ void __launch_bounds__(THREADS, 1) chunk_gemm_s8(const __grid_constant__ P p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + QNSTAGE;
  uint8_t* stages = base + HEAD;
  if (threadIdx.x == 0) {
    for (int s = 0; s < QNSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int tile = blockIdx.x;
  const Job& jb = p.job[job_of(p, tile)];
  const int mt = tile % jb.m_tiles, nt = tile / jb.m_tiles % jb.n_tiles, nk = jb.k_stages;
  const int part = tile / (jb.m_tiles * jb.n_tiles), k0 = QK * nk * part;
  const int arow = jb.a_row0 + BM * mt, brow = BN * nt;
  const int w = warpgroup();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  int issued = 0;  // thread 0's count of stages issued
  auto fill = [&](int need) {
    if (threadIdx.x == 0) {
      const int ahead = min(nk, need + QNSTAGE);
      while (issued < ahead) {
        const int s = issued % QNSTAGE, use = issued / QNSTAGE;
        if (use > 0) {
          if (issued == need)
            mbar_wait(&empty[s], (use - 1) & 1);
          else if (!mbar_test(&empty[s], (use - 1) & 1))
            break;
        }
        uint8_t* st = stages + s * QSTAGE;
        mbar_expect_tx(&full[s], QSTAGE);
        tma_3d(st, &jb.a, &full[s], k0 + QK * issued, arow, 0);
        tma_3d(st + QA_BYTES, &jb.b, &full[s], k0 + QK * issued, brow, 0);
        ++issued;
      }
    }
    __syncwarp();
  };

  int acc[BN / 2];
  zero(acc);
  for (int u = 0; u < nk; ++u) {
    fill(u);
    mbar_wait(&full[u % QNSTAGE], (u / QNSTAGE) & 1);
    const uint8_t* st = stages + (u % QNSTAGE) * QSTAGE;
    const uint64_t da = desc_sw128(st + w * (QA_BYTES / 2)), db = desc_sw128(st + QA_BYTES);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < QK / 32; ++kk) wgmma_s8_n192(acc, da + 2 * kk, db + 2 * kk);
    wg_commit();
    wg_wait<0>();
    if (lane == 0) mbar_arrive(&empty[u % QNSTAGE]);
  }
  fence_acc(acc);
  epilogue(p, jb.epi, part, BM * mt + 64 * w + 16 * wi + g, brow + 2 * t, acc);
}

// A's map: (K inner, rows) f32 with ld floats between rows, box 32 x 128
inline int map_a(CUtensorMap* m, const float* ptr, long k, long rows, long ld) {
  const cuuint64_t d[3] = {(cuuint64_t)k, (cuuint64_t)rows, 1};
  const cuuint64_t s[2] = {(cuuint64_t)ld * 4, (cuuint64_t)ld * rows * 4};
  const cuuint32_t b[3] = {BK, BM, 1};
  return encode_f32(m, ptr, 3, d, s, b);
}

// B's map: (K inner, rows, 2), the small half `half` floats after the big,
// box 32 x 192 x 1
inline int map_b(CUtensorMap* m, const float* ptr, long k, long rows, long ld, long half) {
  const cuuint64_t d[3] = {(cuuint64_t)k, (cuuint64_t)rows, 2};
  const cuuint64_t s[2] = {(cuuint64_t)ld * 4, (cuuint64_t)half * 4};
  const cuuint32_t b[3] = {BK, BN, 1};
  return encode_f32(m, ptr, 3, d, s, b);
}

// the int8 operands' maps: A (K inner, rows) with ld bytes between rows,
// box 128 x 128; B = W^T (K inner, rows), box 128 x 192
inline int map_a_s8(CUtensorMap* m, const int8_t* ptr, long k, long rows, long ld) {
  const cuuint64_t d[3] = {(cuuint64_t)k, (cuuint64_t)rows, 1};
  const cuuint64_t s[2] = {(cuuint64_t)ld, (cuuint64_t)ld * rows};
  const cuuint32_t b[3] = {QK, BM, 1};
  return encode_tiled(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 3, d, s, b);
}

inline int map_b_s8(CUtensorMap* m, const int8_t* ptr, long k, long rows) {
  const cuuint64_t d[3] = {(cuuint64_t)k, (cuuint64_t)rows, 1};
  const cuuint64_t s[2] = {(cuuint64_t)k, (cuuint64_t)k * rows};
  const cuuint32_t b[3] = {QK, BN, 1};
  return encode_tiled(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 3, d, s, b);
}

inline void set_job(Job& j, int epi, int m_tiles, int n_tiles, int k_stages, int a_row0 = 0,
                    int k_parts = 1) {
  j.epi = epi, j.m_tiles = m_tiles, j.n_tiles = n_tiles, j.k_stages = k_stages;
  j.a_row0 = a_row0, j.k_parts = k_parts;
}

// the kernel's shared memory, set once for each device; S8 picks
// chunk_gemm_s8
template <class P, bool S8 = false>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidValue;
  if (!done[dev]) {
    if constexpr (S8)
      err = cudaFuncSetAttribute(chunk_gemm_s8<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 QSMEM);
    else
      err = cudaFuncSetAttribute(chunk_gemm<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    done[dev] = err == cudaSuccess;
  }
  return err;
}

template <class P, bool S8 = false>
int launch(const P& params, cudaStream_t stream) {
  int tiles = 0;
  for (int j = 0; j < params.jobs; ++j)
    tiles += params.job[j].m_tiles * params.job[j].n_tiles * params.job[j].k_parts;
  if constexpr (S8)
    chunk_gemm_s8<P><<<tiles, THREADS, QSMEM, stream>>>(params);
  else
    chunk_gemm<P><<<tiles, THREADS, SMEM, stream>>>(params);
  return (int)cudaGetLastError();
}

// The kernel for P: its registers a thread, its dynamic shared memory, the
// blocks an SM holds and, where `local` is given, its local memory a thread
// (the stack frame, spills included).  Returns a cudaError_t as int.
template <class P, bool S8 = false>
int info(int* regs, int* smem, int* blocks, int* local = nullptr) {
  const void* kernel;
  if constexpr (S8)
    kernel = reinterpret_cast<const void*>(chunk_gemm_s8<P>);
  else
    kernel = reinterpret_cast<const void*>(chunk_gemm<P>);
  *smem = S8 ? QSMEM : SMEM;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_smem<P, S8>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, *smem);
  *regs = attr.numRegs;
  if (local != nullptr) *local = (int)attr.localSizeBytes;
  return (int)err;
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace cgemm
