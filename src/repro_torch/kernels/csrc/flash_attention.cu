// flash_attention — whole-prompt prefill attention on Hopper.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py: q [B, Sq, Hq, D] against k/v
// [B, Skv, Hkv, D], causal with the offset of a query block that sits at the
// end of the keys (query i sees keys j <= i + (Skv - Sq)) or, with
// causal = 0, every key.  Online softmax with f32 m / l / acc, scale D^-0.5,
// the finite NEG_INF = -0.7 * FLT_MAX of the reference, division by l at the
// end, output in q's type.  Query head h reads KV head h / G (G = Hq / Hkv).
// Where the caller asks for it (training), each query row's log-sum-exp
// m + log l goes to an f32 [B, Hq, Sq] buffer for the backward
// (flash_attention_bwd.cu); serving passes no buffer and writes none.
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
//     next tile's copy overlaps this tile's products (at D = 192, where only
//     the split instance runs this body, one stage: kv_stages).  A box
//     past Skv (or past Sq) reads TMA's zero fill, never the next batch
//     row.  A box is 64 rows by 64 bf16 columns (128 bytes) under the
//     128-byte swizzle; D = 16 and 32 read zeros past D, D = 128 takes two
//     boxes, D = 96 two with the second half zeros, D = 192 three.  Q.K^T
//     walks D / 16 steps, so the zero columns cost no product there.
//   * S = Q.K^T: wgmma m64n64k16, Q and K K-major from shared memory, f32
//     accumulators in registers.
//   * Softmax on the accumulator fragment: each thread holds two rows, whose
//     max and sum reduce over the fragment's four lanes by shuffles; the
//     causal and ragged mask is applied only on the tiles that need it, and
//     each probability is one multiply-add (the scale folded in) and one
//     ex2.approx on the special-function unit.
//   * O += P.V: wgmma with P converted to bf16 in registers (the score
//     fragment is the A fragment's layout) and V read MN-major from the same
//     swizzled tile through the descriptor's transpose bit.  N is the padded
//     head dim: 64, 128 (D = 96 computes its 32 zero columns and stores
//     none) or 192, whose O accumulator is 96 f32 registers a thread.
//   * Split-K over a thread-block cluster where the query tiles leave the
//     card short.  A query tile's block walks its key tiles in series, so
//     ceil(Sq / 64) * Hq * B blocks below twice the 132 SMs idle part of the
//     card and leave the rest a long serial chain: seamless-m4t's
//     cross-attention, 4 x 16 heads over 1,024 source frames, is 64 blocks of
//     16 key tiles, at Sq = 64 and at Sq = 1 alike.  There the host (from the
//     shapes alone) gives each query tile a cluster of `splits` <= 8 blocks
//     along grid x: the fewest for which the blocks cover the SMs twice,
//     while every cluster of the launch stays resident at once (the
//     runtime's occupancy count) and each block keeps two key tiles or more,
//     then the fewest that give the same longest range.  Each block runs
//     the loop above over its contiguous share of the tiles below the query
//     tile's causal limit (a block may get none), then the blocks combine on
//     chip (combine_split): partials pushed to the row's owning block, one
//     cluster barrier, no workspace, one launch, the sums in rank order, so
//     a call is deterministic.  Seamless's cross-attention becomes 256 blocks
//     of 4 tiles.  Measured in turns on an H100 (tools/kernel_ab.py): 8
//     blocks of 2 tiles, or four K/V stages, were slower than 4 of 4 with
//     two.  Shapes whose tiles fill the card (training, the encoders,
//     prefill; phi-3-vision's heads at 512 tokens, whose 256 tiles of 83 KB
//     blocks would not all be resident split in two) do not split: they run
//     flash_wgmma_kernel<D, false>, the body without the cluster.
//   * At D = 192 (nemotron-4-340b's 96:8 heads) the calls that do not split
//     take FlashAttention-3's shape (flash_wgmma_ws_kernel): a block of three
//     warpgroups owns 128 query rows.  The last, its registers handed down
//     by setmaxnreg (24 a thread), is the producer: one thread issues Q once
//     and the K/V tiles into a two-stage ring with full and empty mbarriers.
//     The two consumer warpgroups (240 registers a thread; O alone is 96)
//     each run the tile step above on 64 of the rows, bit for bit the
//     one-warpgroup body's, so a K/V tile is loaded once for 128 rows and the
//     next one's copy runs under this one's products.  Q 48 KB and the ring
//     96 KB: one block an SM.  The one-warpgroup body there had one K/V
//     stage (two held a block to one an SM, 121 KB; one let three blocks
//     overlap one another's copies) and read every key tile once per 64 rows.
// f32 (flash_kernel) keeps the CUDA-core body: TF32 or bf16 products
// cannot hold the f32 parity band of 2e-5.  Each of its 128 threads holds a
// 4 x 8 patch of the 64 x 64 score tile and a 4 x (D/8) patch of the output
// in registers, over f32 shared rows padded to D + 1 floats; rows of 8
// threads reduce the row max and sum with warp shuffles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;
constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kLanes = 8;                  // threads sharing one row group
constexpr int kRows = kBQ / (kThreads / kLanes);   // 4 query rows per thread
constexpr int kCols = kBK / kLanes;                // 8 keys per thread per tile
constexpr int kLdp = kBK + 1;
constexpr int kMaxSplits = 8;              // the portable cluster size

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
             T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
             int causal, float scale) {
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
    if (lse != nullptr && tc == 0)
      lse[((long long)b * Hq + h) * Sq + q0 + row] = m[i] + logf(l[i]);
  }
}


constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
                          (size_t)kBQ * kLdp);
}

// ---------------------------------------------------------------------------
// bf16: one warpgroup on wgmma, K/V by TMA
// ---------------------------------------------------------------------------

// K/V tiles in flight in the one-warpgroup body: two, the next tile's copy
// under this tile's products; one at D = 192, where only the split instance
// runs it (the unsplit calls take flash_wgmma_ws_kernel's ring), whose two
// stages would hold a block to one per SM (121 KB), where one stage (73 KB)
// lets three blocks overlap one another's loads instead.  Both measured in
// turns on the unsplit body (H100 80GB HBM3, 700 W, chip_smoke.py's kernels
// phase): one stage at D = 192 took 23% off the device time; one stage below
// 192 adds 12-15% at D = 96 and 128, 1-2% at 64.
__host__ __device__ constexpr int kv_stages(int D) { return D > 128 ? 1 : 2; }

// Q, the K and V tiles, their mbarriers, and 1 KB to align the boxes to the
// 1024 bytes the 128-byte swizzle repeats over.
constexpr size_t wgmma_smem_bytes(int D) {
  return 1024 + (size_t)(1 + 2 * kv_stages(D)) * tile_bytes(D) + 8 * (1 + kv_stages(D));
}

// The split combine's receive buffers, after the mbarriers: for each of the
// `splits` source blocks, rows_per_rank O rows of D f32 (padded by 8 floats,
// so that the fragment's float2 stores of 4 rows land on distinct banks)
// and their (m, l).  A block owns rows_per_rank of the query tile's rows.
// The buffers are sized for a full 64-row tile whatever Sq, so that the
// shared memory of a launch, and the residency count the plan reads on
// every call's host path, depend on (D, splits) alone: a few cached entries.
__host__ __device__ constexpr int partial_ld(int D) { return D + 8; }
__host__ __device__ constexpr int rows_per_rank(int Sq, int splits) {
  return ((Sq < kBQ ? Sq : kBQ) + splits - 1) / splits;
}
__host__ __device__ constexpr size_t recv_bytes(int D, int splits) {
  return 16 + (size_t)splits * rows_per_rank(kBQ, splits) * (sizeof(float) * partial_ld(D) + 8);
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(map) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The split combine, on chip.  Block r of the cluster owns the query tile's
// rows [r R, r R + R) (R = rows_per_rank).  Each block stores its O rows
// (f32, not yet divided by l) and each row's (m, l) straight from its
// registers into the owning block's receive buffer, in its own slot, through
// distributed shared memory; after one cluster barrier each block combines
// its rows from its own shared memory: the slots in rank order (so the sums
// are the same on every call), each rescaled by 2^(m_s - M), divided by L,
// written in bf16 with, where asked, the row's LSE (M + log2 L) ln 2.  A
// block that read no key pushed m = NEG_INF, l = 0, O = 0: weight 0.  No
// block reads another's memory after the barrier, so none waits on a second
// one before it exits; the barrier the kernel arrived at on entry, waited
// for here, makes sure every block of the cluster runs before any stores
// into it.
template <int D, int kDP>
__device__ __forceinline__ void combine_split(const float (&o)[kDP / 2], const float (&m)[2],
                                              const float (&l)[2], unsigned char* recv,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ lse, int b, int h, int q0,
                                              int nq, int Sq, int Hq, int splits, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int ld = partial_ld(D);
  const int rpr = rows_per_rank(Sq, splits);
  float* recv_o = reinterpret_cast<float*>(recv);                        // [splits][rpr][ld]
  float2* recv_ml = reinterpret_cast<float2*>(recv_o + splits * rpr * ld);   // [splits][rpr]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  cluster_wait();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nq) continue;
    const int owner = row / rpr, slot = rank * rpr + row - owner * rpr;
    float* dst = cluster.map_shared_rank(recv_o + slot * ld, owner);
#pragma unroll
    for (int i = 2 * r; i < kDP / 2; i += 4) {     // the fragment's values of this row
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      if (col < D) *reinterpret_cast<float2*>(dst + col) = make_float2(o[i], o[i + 1]);
    }
    if ((lane & 3) == 0) *cluster.map_shared_rank(recv_ml + slot, owner) = make_float2(m[r], l[r]);
  }
  cluster.sync();
  constexpr int kUnits = D / 4;            // 4-column units of a row
  const int row0 = rank * rpr;
  const int units = max(0, min(rpr, nq - row0)) * kUnits;
  const long long qrow = (long long)Hq * D;
  for (int u = tid; u < units; u += kThreads) {
    const int lr = u / kUnits, col = 4 * (u - lr * kUnits);
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, recv_ml[s * rpr + lr].x);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float2 ml = recv_ml[s * rpr + lr];
      const float w = fast_exp2(ml.x - M);
      const float4 v = *reinterpret_cast<const float4*>(recv_o + (s * rpr + lr) * ld + col);
      L = fmaf(w, ml.y, L);
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    const float inv = 1.f / L;
    const int row = row0 + lr;
    *reinterpret_cast<uint2*>(out + ((long long)b * Sq + q0 + row) * qrow + (long long)h * D +
                              col) =
        make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
    if (lse != nullptr && col == 0)
      lse[((long long)b * Hq + h) * Sq + q0 + row] = (M + log2f(L)) * kLn2;
  }
}

// One 64-key tile for one warpgroup's 64 query rows (q0 ..), Q, K and V
// 64-row tiles in shared memory, in three steps: qk_issue starts S = Q.K^T
// on wgmma; softmax_tile masks the scores where the tile needs it and runs
// the online softmax on the accumulator fragment (m in log2 units of the
// scaled scores, l this thread's columns), leaving P in s and O rescaled;
// pv_issue starts O += P.V.  Thread (warp w, lane l) holds rows r0 = 16 w +
// l / 4 and r0 + 8; lim0 is the last key row r0 sees.

// S = Q.K^T: K-major boxes; a k16 step is 32 bytes along a 128-byte row
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[32], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {    // the zero columns past D add nothing
    const uint32_t step = (kk / 4) * kAtom + (kk % 4) * 32;
    wgmma_ss_n64(s, gmma_desc(q_addr + step, 16, 1024), gmma_desc(k_addr + step, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

template <int kDP>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[kDP / 2], float (&m)[2],
                                             float (&l)[2], int t0, int q0, int lim0, int off,
                                             int Skv, int causal, float scale_log2, int lane) {
  // the mask and the row max act on raw scores; the scale (positive)
  // enters once, in the exponent's multiply-add
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
}

// O += P.V: P's k16 step kk is score columns 16 kk .. 16 kk + 15, which the
// accumulator fragment holds as the A fragment wants them; V's k16 step is
// 16 key rows, two 1024-byte swizzle atoms
template <int kDP>
__device__ __forceinline__ void pv_issue(float (&o)[kDP / 2], const float (&s)[32],
                                         uint32_t v_addr) {
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
}

// The three in series, each product waited for.
template <int D, int kDP>
__device__ __forceinline__ void wgmma_tile(float (&o)[kDP / 2], float (&m)[2], float (&l)[2],
                                           uint32_t q_addr, uint32_t k_addr, uint32_t v_addr,
                                           int t0, int q0, int lim0, int off, int Skv,
                                           int causal, float scale_log2, int lane) {
  float s[32];
  qk_issue<D>(s, q_addr, k_addr);
  wgmma_wait_all();
  fence_regs(s);
  softmax_tile<kDP>(s, o, m, l, t0, q0, lim0, off, Skv, causal, scale_log2, lane);
  pv_issue<kDP>(o, s, v_addr);
  wgmma_wait_all();
  fence_regs(o);
}

// A warpgroup's 64 rows from q0 (those below nq), once its l sums its row
// over the fragment's four lanes: each row's LSE where asked, then O / l in
// bf16 at the columns below D.
template <int D, int kDP>
__device__ __forceinline__ void store_rows(const float (&o)[kDP / 2], const float (&m)[2],
                                           float (&l)[2], __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ lse, int b, int h, int q0, int nq,
                                           int Sq, int Hq, int r0, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // m is in log2 units of the scaled scores: LSE = (m + log2 l) ln 2
    const int row = r0 + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < nq)
      lse[((long long)b * Hq + h) * Sq + q0 + row] = (m[r] + log2f(l[r])) * kLn2;
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

// Fragment of a wgmma m64nN f32 accumulator: thread (warp w, lane l) holds
// d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
// kSplit: the block is one of a cluster that shares the query tile's key
// tiles (the cluster spans grid x, splits blocks to a query tile).
template <int D, bool kSplit>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int causal,
                   float scale_log2) {
  constexpr int kBoxes = boxes(D);         // 64-column boxes across the head dim
  constexpr int kDP = 64 * kBoxes;         // head dim padded to the boxes
  constexpr int kTile = tile_bytes(D);
  constexpr int kStages = kv_stages(D);
  int splits = 1, rank = 0;
  if constexpr (kSplit) {
    // a split block streams a few tiles: fetch the maps' descriptors early
    if (threadIdx.x == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
    }
    cluster_arrive_relaxed();            // waited for before the combine's stores
    splits = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int q0 = (kSplit ? blockIdx.x / splits : blockIdx.x) * kBQ;
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
  // this block's key tiles [jlo, jlo + ntiles_b): all of them, or its
  // rank's contiguous share (none where the cluster has more blocks than tiles)
  const int jlo = kSplit ? ntiles * rank / splits : 0;
  const int ntiles_b = kSplit ? ntiles * (rank + 1) / splits - jlo : ntiles;

  auto load_kv = [&](int j) {             // the block's j-th tile, tile jlo + j
    const int st = j % kStages;
    uint64_t* bar = &bars[1 + st];
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(k_s + st * kTile + x * kAtom, &kmap, bar, 64 * x, hk, (jlo + j) * kBK, b);
      tma_load(v_s + st * kTile + x * kAtom, &vmap, bar, 64 * x, hk, (jlo + j) * kBK, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], kTile);
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) tma_load(q_s + x * kAtom, &qmap, &bars[0], 64 * x, h, q0, b);
    if (ntiles_b > 0) load_kv(0);
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

  for (int j = 0; j < ntiles_b; ++j) {
    const int st = j % kStages;
    if constexpr (kStages > 1) {         // its stage was freed by tile j - 1
      if (tid == 0 && j + 1 < ntiles_b) load_kv(j + 1);
    }
    mbar_wait(&bars[1 + st], (j / kStages) & 1);
    wgmma_tile<D, kDP>(o, m, l, q_addr, smem_u32(k_s + st * kTile), smem_u32(v_s + st * kTile),
                       (jlo + j) * kBK, q0, lim0, off, Skv, causal, scale_log2, lane);
    __syncthreads();                       // every warp is done with stage st
    if constexpr (kStages == 1) {
      if (tid == 0 && j + 1 < ntiles_b) load_kv(j + 1);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kSplit) {
    // the combine's buffers: after the mbarriers, 16-byte aligned
    unsigned char* recv = smem_raw + ((smem_u32(bars + 1 + kStages) + 15) / 16 * 16 -
                                      smem_u32(smem_raw));
    combine_split<D, kDP>(o, m, l, recv, out, lse, b, h, q0, nq, Sq, Hq, splits, rank);
    return;
  }
  store_rows<D, kDP>(o, m, l, out, lse, b, h, q0, nq, Sq, Hq, r0, lane);
}

// ---------------------------------------------------------------------------
// bf16 at D = 192: two consumer warpgroups on a 128-row query tile
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kConsumers = 2;              // 64 query rows each
constexpr int kWsThreads = (kConsumers + 1) * kWG;   // and the producer warpgroup
constexpr int kWsStages = 2;               // K/V tiles in the ring
constexpr int kProducerRegs = 24;          // 128 * 24 + 256 * 240 <= 65,536
constexpr int kConsumerRegs = 240;

// Q's two buffers of two 64-row tiles, the K and V rings, the mbarriers
// (q_full[2], q_empty[2], k_full, v_full [stage], k_empty and v_empty
// [stage][consumer]), and 1 KB to align the boxes: 193 KB at D = 192.
constexpr int kQBufs = 2;
constexpr size_t ws_smem_bytes(int D) {
  return 1024 + (size_t)(kQBufs * kConsumers + 2 * kWsStages) * tile_bytes(D) +
         8 * (2 * kQBufs + 2 * kWsStages + 2 * kWsStages * kConsumers);
}

// The work items of the persistent body: 128 query rows of one (batch,
// query head), numbered with the row tiles nearest the end first (under
// causal masking they read the most keys).  Block k of P takes item
// r P + k in even rounds r and r P + P - 1 - k in odd ones, so that a block
// given one of the heaviest items of a round gets one of the lightest of
// the next.
struct WsItem {
  int qt, h, b;
};
__device__ __forceinline__ int ws_item_index(int r, int P, int k) {
  return r * P + (r & 1 ? P - 1 - k : k);
}
__device__ __forceinline__ WsItem ws_item(int i, int qtiles, int Hq, int B) {
  const int per = Hq * B;
  const int r = i % per;
  return {(qtiles - 1 - i / per) * kConsumers * kBQ, r % Hq, r / Hq};
}

// The key tiles consumer c reads in an item: those below the causal limit
// of its last row (q0 = qt + 64 c), as the one-warpgroup body's block for
// those rows reads them; none without a row below Sq.
__device__ __forceinline__ int ws_tiles(int qt, int c, int Sq, int Skv, int causal) {
  const int q0 = qt + c * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int kend = causal ? min(Skv, q0 + nq + Skv - Sq) : Skv;
  return nq > 0 ? (kend + kBK - 1) / kBK : 0;
}

// FlashAttention-3's shape, persistent: one block of three warpgroups an
// SM walks work items of 128 query rows (ws_item).  The last warpgroup, its
// registers handed down by setmaxnreg, is the producer: one thread issues
// each item's Q into one of two buffers and its K and V tiles of 64 keys
// into two-stage rings, K and V apart, each with full and empty mbarriers,
// so the next item's Q and first tiles load under this item's last steps
// and its stores.  Each consumer warpgroup, its registers raised, owns 64
// of an item's rows and runs the one-warpgroup body's tile step on them,
// freeing a K tile once its S is done and a V tile once its P.V is: the
// same operations on the same values, so its rows are that body's bits.
// Both read the same tiles, so a K/V tile is loaded once for 128 rows.  A
// consumer stops at the causal limit of its own last row, as that body's
// block does, and frees a stage through its own empty barriers (the
// producer waits on a consumer's only for the tiles it read); it still
// waits for every tile of the item to land, so that no full barrier runs
// two phases ahead of it.  Two variants were tried on an H100 and dropped,
// each slower at nemotron's shapes: S of the next tile issued before this
// tile's softmax, and the two consumers taking turns to issue products
// (FA3's intra- and inter-warpgroup overlap).
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_wgmma_ws_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int B, int Sq, int Skv, int Hq, int Hkv,
                      int causal, float scale_log2) {
  constexpr int kBoxes = boxes(D);
  constexpr int kDP = 64 * kBoxes;
  constexpr int kTile = tile_bytes(D);
  const int qtiles = (Sq + kConsumers * kBQ - 1) / (kConsumers * kBQ);
  const int n_items = qtiles * Hq * B;
  const int P = gridDim.x;
  const int G = Hq / Hkv;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                         // [kQBufs][kConsumers][kBoxes][64][64]
  unsigned char* k_s = q_s + kQBufs * kConsumers * kTile;   // [kWsStages][kBoxes][64][64]
  unsigned char* v_s = k_s + kWsStages * kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kWsStages * kTile);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* k_full = q_empty + kQBufs;
  uint64_t* v_full = k_full + kWsStages;
  uint64_t* k_empty = v_full + kWsStages;            // [kWsStages][kConsumers]
  uint64_t* v_empty = k_empty + kWsStages * kConsumers;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers * kWG);
    }
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      for (int c = 0; c < kConsumers; ++c) {
        mbar_init(&k_empty[s * kConsumers + c], kWG);
        mbar_init(&v_empty[s * kConsumers + c], kWG);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform to the compiler (a shuffle from lane 0), so that each
  // warpgroup's branch, and its setmaxnreg, is seen to be taken whole
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  if (wg == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % kWG != 0) return;
    // per stage: the consumers that read its tiles (a bit each), and the
    // tiles each has read from it, whose last release to wait for
    unsigned users[kWsStages] = {};
    int reads[kWsStages][kConsumers] = {};
    auto wait_free = [&](uint64_t* empty, int st) {
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
        if (users[st] >> c & 1) mbar_wait(&empty[st * kConsumers + c], (reads[st][c] - 1) & 1);
    };
    int g = 0;                               // the rings' tiles so far
    for (int r = 0, n = 0; r * P < n_items; ++r) {
      const int i = ws_item_index(r, P, blockIdx.x);
      if (i >= n_items) continue;
      const WsItem it = ws_item(i, qtiles, Hq, B);
      const int hk = it.h / G;
      const int nt0 = ws_tiles(it.qt, 0, Sq, Skv, causal);
      const int nt1 = ws_tiles(it.qt, 1, Sq, Skv, causal);
      const int qb = n % kQBufs;
      if (n >= kQBufs) mbar_wait(&q_empty[qb], (n / kQBufs - 1) & 1);
      ++n;
      // rows past Sq, a whole tile of them too, read TMA's zero fill
      mbar_expect_tx(&q_full[qb], kConsumers * kTile);
      for (int c = 0; c < kConsumers; ++c) {
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(q_s + (qb * kConsumers + c) * kTile + x * kAtom, &qmap, &q_full[qb],
                   64 * x, it.h, it.qt + c * kBQ, it.b);
      }
      for (int j = 0; j < max(nt0, nt1); ++j, ++g) {
        const int st = g % kWsStages;
        wait_free(k_empty, st);
        mbar_expect_tx(&k_full[st], kTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(k_s + st * kTile + x * kAtom, &kmap, &k_full[st], 64 * x, hk, j * kBK, it.b);
        wait_free(v_empty, st);
        mbar_expect_tx(&v_full[st], kTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(v_s + st * kTile + x * kAtom, &vmap, &v_full[st], 64 * x, hk, j * kBK, it.b);
        users[st] = (j < nt0 ? 1u : 0u) | (j < nt1 ? 2u : 0u);
#pragma unroll
        for (int c = 0; c < kConsumers; ++c) reads[st][c] += users[st] >> c & 1;
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg;
  const int tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int off = Skv - Sq;
  auto wait_full = [&](uint64_t* full, int gt) {
    mbar_wait(&full[gt % kWsStages], (gt / kWsStages) & 1);
  };
  int g = 0;                                 // the rings' tiles before this item
  for (int r = 0, n = 0; r * P < n_items; ++r) {
    const int i = ws_item_index(r, P, blockIdx.x);
    if (i >= n_items) continue;
    const WsItem it = ws_item(i, qtiles, Hq, B);
    const int q0 = it.qt + c * kBQ;
    const int ntiles = max(ws_tiles(it.qt, 0, Sq, Skv, causal),
                           ws_tiles(it.qt, 1, Sq, Skv, causal));
    const int nt = ws_tiles(it.qt, c, Sq, Skv, causal);
    const int qb = n % kQBufs;
    float o[kDP / 2];
#pragma unroll
    for (int k = 0; k < kDP / 2; ++k) o[k] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows r0 and r0 + 8, log2 units
    const int lim0 = q0 + r0 + off;        // last key row r0 sees; row r0 + 8 sees 8 more
    const uint32_t q_addr = smem_u32(q_s + (qb * kConsumers + c) * kTile);
    mbar_wait(&q_full[qb], (n / kQBufs) & 1);
    ++n;
    for (int j = 0; j < nt; ++j) {
      const int gj = g + j, st = gj % kWsStages;
      float s[32];
      wait_full(k_full, gj);
      qk_issue<D>(s, q_addr, smem_u32(k_s + st * kTile));
      wgmma_wait_all();
      fence_regs(s);
      mbar_arrive(&k_empty[st * kConsumers + c]);
      softmax_tile<kDP>(s, o, m, l, j * kBK, q0, lim0, off, Skv, causal, scale_log2, lane);
      wait_full(v_full, gj);
      pv_issue<kDP>(o, s, smem_u32(v_s + st * kTile));
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&v_empty[st * kConsumers + c]);
    }
    // the tiles past this consumer's causal limit land all the same
    for (int j = nt; j < ntiles; ++j) {
      wait_full(k_full, g + j);
      wait_full(v_full, g + j);
    }
    g += ntiles;
    mbar_arrive(&q_empty[qb]);             // done with this item's Q
    if (nt == 0) continue;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    }
    store_rows<D, kDP>(o, m, l, out, lse, it.b, it.h, q0, min(kBQ, Sq - q0), Sq, Hq, r0, lane);
  }
}

// Blocks of the bf16 body's cluster for one query tile, from the shapes
// alone: the fewest, at most 8, for which the blocks cover the SMs twice,
// as long as every cluster of the launch is resident at once and each block
// keeps at least two key tiles of the full key range; then the fewest that
// give the same longest range (ceil(tiles / splits)).  1 where the query
// tiles cover the SMs twice, or where two blocks a tile would not all be
// resident (phi-3-vision's heads at 512 tokens: 256 tiles of 83 KB blocks).
template <int D>
int flash_splits(int B, int Sq, int Skv, int Hq) {
  const long long tiles = (long long)((Sq + kBQ - 1) / kBQ) * Hq * B;
  const int nt = (Skv + kBK - 1) / kBK;
  const long long target = 2LL * sm_count();
  const void* kernel = (const void*)flash_wgmma_kernel<D, true>;
  int splits = 1;
  while (splits < kMaxSplits && tiles * splits < target && nt / (splits + 1) >= 2 &&
         resident_clusters(kernel, kThreads, splits + 1,
                           wgmma_smem_bytes(D) + recv_bytes(D, splits + 1)) >= tiles)
    ++splits;
  while (splits > 1 && (nt + splits - 2) / (splits - 1) == (nt + splits - 1) / splits) --splits;
  return splits;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                         cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(enc, &qmap, q, B, Sq, Hq, D) || !encode_map(enc, &kmap, k, B, Skv, Hkv, D) ||
      !encode_map(enc, &vmap, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem_bytes(D);
  const int splits = flash_splits<D>(B, Sq, Skv, Hq);
  const unsigned qt = (unsigned)((Sq + kBQ - 1) / kBQ);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if constexpr (D == 192) {
    if (splits == 1) {
      const size_t ws_smem = ws_smem_bytes(D);
      cudaError_t e = cudaFuncSetAttribute(flash_wgmma_ws_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)ws_smem);
      if (e != cudaSuccess) return e;
      // one block an SM (its registers), at most one an item
      const int items = ((Sq + kConsumers * kBQ - 1) / (kConsumers * kBQ)) * Hq * B;
      const int blocks = items < sm_count() ? items : sm_count();
      flash_wgmma_ws_kernel<D><<<blocks, kWsThreads, ws_smem, stream>>>(
          qmap, kmap, vmap, o, lse, B, Sq, Skv, Hq, Hkv, causal, scale * kLog2e);
      return cudaGetLastError();
    }
  } else {
    if (splits == 1) {
      cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<D, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
      dim3 grid(qt, (unsigned)Hq, (unsigned)B);
      flash_wgmma_kernel<D, false><<<grid, kThreads, smem, stream>>>(
          qmap, kmap, vmap, o, lse, Sq, Skv, Hq, Hkv, causal, scale * kLog2e);
      return cudaGetLastError();
    }
  }
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, int, int, int,
                 int, int, float) = flash_wgmma_kernel<D, true>;
  const size_t split_smem = smem + recv_bytes(D, splits);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)split_smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(qt * (unsigned)splits, (unsigned)Hq, (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = split_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, qmap, kmap, vmap, o, lse, Sq, Skv, Hq, Hkv, causal,
                         scale * kLog2e);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
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
      static_cast<float*>(out), lse, Sq, Skv, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* out,
                         float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                         float scale, cudaStream_t s) {
  if (dtype == 0) return launch<D>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the cluster that shares a query tile's key tiles (1: no split)
// for a call at these shapes: bf16 (dtype 1) splits where its query tiles
// leave the SMs short, f32 (dtype 0) never.
extern "C" int repro_flash_attention_splits(int dtype, int B, int Sq, int Skv, int Hq, int D) {
  if (dtype != 1) return 1;
  switch (D) {
    case 16: return flash_splits<16>(B, Sq, Skv, Hq);
    case 32: return flash_splits<32>(B, Sq, Skv, Hq);
    case 64: return flash_splits<64>(B, Sq, Skv, Hq);
    case 96: return flash_splits<96>(B, Sq, Skv, Hq);
    case 128: return flash_splits<128>(B, Sq, Skv, Hq);
    case 192: return flash_splits<192>(B, Sq, Skv, Hq);
    default: return 1;
  }
}

// dtype: 0 = float32 (flash_kernel), 1 = bfloat16 (flash_wgmma_kernel).
// q/out [B,Sq,Hq,D], k/v [B,Skv,Hkv,D], contiguous and 16-byte aligned; D in
// {16, 32, 64, 96, 128, 192}; Hq % Hkv == 0; a causal call needs Sq <= Skv
// (every query row sees a key).  lse, where not null, receives [B,Hq,Sq]
// f32, each query row's m + log l in natural units (what the backward,
// flash_attention_bwd.cu, recomputes P from); the serving path passes null.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, float* lse, int B, int Sq, int Skv, int Hq,
                                     int Hkv, int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD_CASE(DD) \
  case DD: return launch_dtype<DD>(dtype, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, scale, s);
  switch (D) {
    REPRO_FWD_CASE(16)
    REPRO_FWD_CASE(32)
    REPRO_FWD_CASE(64)
    REPRO_FWD_CASE(96)
    REPRO_FWD_CASE(128)
    REPRO_FWD_CASE(192)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FWD_CASE
}
