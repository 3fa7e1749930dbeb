// flash_attention — whole-prompt prefill attention on Hopper.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py: q [B, Sq, Hq, D] against k/v
// [B, Skv, Hkv, D], causal with the offset of a query block that sits at the
// end of the keys (query i sees keys j <= i + (Skv - Sq)) or, with
// causal = 0, every key.  Online softmax with f32 m / l / acc, scale D^-0.5,
// the finite NEG_INF = -0.7 * FLT_MAX of the reference, division by l at the
// end, output in q's type.  Query head h reads KV head h / G (G = Hq / Hkv).
//
// The Pallas grid walks (B, Hq, query block, key block) in order and carries
// m / l / acc across the key blocks in VMEM scratch.  Hopper blocks run in no
// order, so here one block of 128 threads owns (batch, query head, tile of 64
// query rows) and loops over the key tiles of 64 itself, carrying the softmax
// state in registers.  The loop stops at the causal limit of the tile's last
// row (qpos_max + Skv - Sq), so a causal prompt reads about half the keys.
//
// What bounds it on the H100: the work is 4 * B * Hq * Sq * Skv * D flops (half
// that when causal) against q, k, v and out read or written once.  At head
// dim 64 in bf16 that is about S / 4 flops per byte for a causal prompt of S
// tokens, so the bytes over 3.35 TB/s bound it below some 1,200 tokens and
// the tensor cores' 989 TFLOP/s above.  Reaching either needs the products on
// the tensor cores and the key tiles' loads off the threads' critical path.
//
// bf16 (flash_wgmma_kernel): the block is one warpgroup.
//   * Loads: one thread issues TMA copies through 4-D tensor maps over
//     [B, S, H, D] (encoded on the host for each call), Q once and K/V tiles
//     of 64 keys into a ring of two stages, each with its mbarrier, so the
//     next tile's copy overlaps this tile's products.  A box past Skv (or
//     past Sq) reads TMA's zero fill, never the next batch row.  A box is 64
//     rows by 64 bf16 columns (128 bytes) under the 128-byte swizzle; D = 16
//     and 32 read zeros past D, D = 128 takes two boxes.
//   * S = Q.K^T: wgmma m64n64k16, Q and K K-major from shared memory, f32
//     accumulators in registers.
//   * Softmax on the accumulator fragment: each thread holds two rows, whose
//     max and sum reduce over the fragment's four lanes by shuffles; the
//     causal and ragged mask is applied only on the tiles that need it, and
//     each probability is one multiply-add (the scale folded in) and one
//     ex2.approx on the special-function unit.
//   * O += P.V: wgmma with P converted to bf16 in registers (the score
//     fragment is the A fragment's layout) and V read MN-major from the same
//     swizzled tile through the descriptor's transpose bit.
// f32 (flash_kernel) keeps the CUDA-core body: TF32 or bf16 products
// cannot hold the f32 parity band of 2e-5.  Each of its 128 threads holds a
// 4 x 8 patch of the 64 x 64 score tile and a 4 x (D/8) patch of the output
// in registers, over f32 shared rows padded to D + 1 floats; rows of 8
// threads reduce the row max and sum with warp shuffles.

#include <cuda.h>            // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kLanes = 8;                  // threads sharing one row group
constexpr int kRows = kBQ / (kThreads / kLanes);   // 4 query rows per thread
constexpr int kCols = kBK / kLanes;                // 8 keys per thread per tile
constexpr int kLdp = kBK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Copies rows [0, n) of D elements (row stride `row` elements) into f32
// shared rows of stride ld, 16 bytes per thread per step; rows [n, fill) are
// zeroed.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long row, int n,
                                           int fill, float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < fill * kPerRow; i += kThreads) {
    const int j = i / kPerRow, c = i - j * kPerRow;
    float* d = dst + j * ld + c * kVec;
    if (j < n) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + (long long)j * row + c * kVec);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = to_float(e[x]);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = 0.f;
    }
  }
}

__device__ __forceinline__ float group_max(float x) {
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal, float scale) {
  constexpr int kDCols = D / kLanes;       // output dims per thread
  constexpr int ld = D + 1;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x;
  const int tr = tid / kLanes;             // row group: rows tr*kRows ..
  const int tc = tid % kLanes;             // keys tc + 8*j, dims tc + 8*j

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kBQ][D+1]
  float* k_s = q_s + kBQ * ld;             // [kBK][D+1]
  float* v_s = k_s + kBK * ld;             // [kBK][D+1]
  float* p_s = v_s + kBK * ld;             // [kBQ][kBK+1]

  const long long qrow = (long long)Hq * D;    // elements between consecutive tokens
  const long long krow = (long long)Hkv * D;
  stage_rows<T, D>(q + ((long long)b * Sq + q0) * qrow + (long long)h * D, qrow, nq, kBQ,
                   q_s, ld);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  const int off = Skv - Sq;
  // keys past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them
  const int kend = causal ? min(Skv, q0 + nq + off) : Skv;
  const T* kb = k + (long long)b * Skv * krow + (long long)hk * D;
  const T* vb = v + (long long)b * Skv * krow + (long long)hk * D;

  for (int t0 = 0; t0 < kend; t0 += kBK) {
    const int n = min(kBK, kend - t0);
    __syncthreads();                       // the last tile's P.V reads are done
    stage_rows<T, D>(kb + (long long)t0 * krow, krow, n, n, k_s, ld);
    stage_rows<T, D>(vb + (long long)t0 * krow, krow, n, n, v_s, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(tr * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tc + kLanes * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = tr * kRows + i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = tc + kLanes * j;
        const bool ok = key < n && (!causal || t0 + key <= qpos + off);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = tc + kLanes * j;
        const float p = key < n ? expf(s[i][j] - m_new) : 0.f;
        p_s[row * kLdp + key] = p;
        sum += p;
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(tr * kRows + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const float vv = v_s[j * ld + tc + kLanes * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = tr * kRows + i;
    if (row >= nq) continue;
    T* o = out + ((long long)b * Sq + q0 + row) * qrow + (long long)h * D;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) o[tc + kLanes * c] = from_float<T>(acc[i][c] / l[i]);
  }
}


constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
                          (size_t)kBQ * kLdp);
}

// ---------------------------------------------------------------------------
// bf16: one warpgroup on wgmma, K/V by TMA
// ---------------------------------------------------------------------------

constexpr int kStages = 2;                 // K/V tiles in flight

// Q, kStages K and V tiles, their mbarriers, and 1 KB to align the boxes to
// the 1024 bytes the 128-byte swizzle repeats over.
constexpr size_t wgmma_smem_bytes(int D) {
  return 1024 + (size_t)(1 + 2 * kStages) * tile_bytes(D) + 8 * (1 + kStages);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier has completed the phase of parity `phase`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Fragment of a wgmma m64nN f32 accumulator: thread (warp w, lane l) holds
// d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   int Sq, int Skv, int Hq, int Hkv, int causal, float scale_log2) {
  constexpr int kBoxes = D > 64 ? 2 : 1;   // 64-column boxes across the head dim
  constexpr int kDP = 64 * kBoxes;         // head dim padded to the boxes
  constexpr int kTile = tile_bytes(D);
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                          // [kBoxes][64][64]
  unsigned char* k_s = q_s + kTile;                   // [kStages][kBoxes][64][64]
  unsigned char* v_s = k_s + kStages * kTile;         // [kStages][kBoxes][64][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * kTile);   // Q, then stages

  const int off = Skv - Sq;
  const int nq = min(kBQ, Sq - q0);
  // keys past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them
  const int kend = causal ? min(Skv, q0 + nq + off) : Skv;
  const int ntiles = (kend + kBK - 1) / kBK;

  auto load_kv = [&](int j) {
    const int st = j % kStages;
    uint64_t* bar = &bars[1 + st];
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(k_s + st * kTile + x * kAtom, &kmap, bar, 64 * x, hk, j * kBK, b);
      tma_load(v_s + st * kTile + x * kAtom, &vmap, bar, 64 * x, hk, j * kBK, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bars[0], kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) tma_load(q_s + x * kAtom, &qmap, &bars[0], 64 * x, h, q0, b);
    load_kv(0);
  }
  __syncthreads();

  float o[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows r0 and r0 + 8, log2 units
  const int r0 = warp * 16 + lane / 4;
  const int lim0 = q0 + r0 + off;          // last key row r0 sees; row r0 + 8 sees 8 more
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(&bars[0], 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (tid == 0 && j + 1 < ntiles) load_kv(j + 1);   // its stage was freed by tile j - 1
    mbar_wait(&bars[1 + st], (j / kStages) & 1);

    // S = Q.K^T: K-major boxes; a k16 step is 32 bytes along a 128-byte row
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(k_s + st * kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
      const uint32_t step = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(s, gmma_desc(q_addr + step, 16, 1024), gmma_desc(k_addr + step, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the mask and the row max act on raw scores; the scale (positive)
    // enters once, in the exponent's multiply-add
    const int t0 = j * kBK;
    const bool edge = t0 + kBK > Skv || (causal && t0 + kBK - 1 > q0 + off);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int lim = lim0 + 8 * ((i >> 1) & 1);
        if (key >= Skv || (causal && key > lim)) s[i] = kNegInf;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == r) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -m[r]));
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];   // this thread's columns
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P.V: P's k16 step kk is score columns 16 kk .. 16 kk + 15, which
    // the accumulator fragment holds as the A fragment wants them; V's k16
    // step is 16 key rows, two 1024-byte swizzle atoms
    const uint32_t v_addr = smem_u32(v_s + st * kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      wgmma_rs<kDP>(o, a, gmma_desc(v_addr + kk * 2048, kAtom, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();                       // every warp is done with stage st
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
  const long long qrow = (long long)Hq * D;
#pragma unroll
  for (int i = 0; i < kDP / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = r0 + 8 * r;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (col < D && row < nq) {
      __nv_bfloat16* dst = out + ((long long)b * Sq + q0 + row) * qrow + (long long)h * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[i] * l[r], o[i + 1] * l[r]);
    }
  }
}

// cuTensorMapEncodeTiled is a driver function; the library links no libcuda,
// so the runtime hands out its address once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a contiguous bf16 [B, S, H, D] whose box is 64 columns by 1 head
// by 64 rows by 1 batch row, 128-byte swizzled; reads past any edge are zeros.
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S, int H,
                int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * S * H * D};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kBQ, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                         int Skv, int Hq, int Hkv, int causal, float scale,
                         cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(enc, &qmap, q, B, Sq, Hq, D) || !encode_map(enc, &kmap, k, B, Skv, Hkv, D) ||
      !encode_map(enc, &vmap, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, Hkv, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  flash_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Skv, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* out,
                         int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                         cudaStream_t s) {
  if (dtype == 0) return launch<D>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 1) return launch_wgmma<D>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared memory (bytes) one block needs at dtype code `dtype` and head dim D.
extern "C" long long repro_flash_attention_smem(int dtype, int D) {
  return (long long)(dtype == 1 ? wgmma_smem_bytes(D) : smem_bytes(D));
}

// dtype: 0 = float32 (flash_kernel), 1 = bfloat16 (flash_wgmma_kernel).
// q/out [B,Sq,Hq,D], k/v [B,Skv,Hkv,D], contiguous and 16-byte aligned; D in
// {16, 32, 64, 128}; Hq % Hkv == 0; a causal call needs Sq <= Skv (every
// query row sees a key).  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                                     int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dtype<16>(dtype, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 32: return launch_dtype<32>(dtype, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 64: return launch_dtype<64>(dtype, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
