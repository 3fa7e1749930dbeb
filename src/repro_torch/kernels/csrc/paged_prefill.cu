// paged_prefill_attention — a prefill chunk attending over pool pages on Hopper.
//
// Replaces the TPU kernel `paged_prefill_attention` of
// src/repro/kernels/paged_prefill.py.  A chunk of C new queries per sequence,
// q [B, C, Hq, D], query i of sequence b at absolute position
// q_starts[b] + i, attends over the K/V pages [N, bs, Hkv, D] that sequence b
// reads through its block-table row (logical block j in page
// block_tables[b, j]).  The chunk's own K/V are already in the pages.  Slot j
// is visible to query i iff j <= q_starts[b] + i and j < q_starts[b] +
// q_lens[b]; rows past q_lens[b] are don't-care (computed all the same, over
// the chunk's valid slots).  Online softmax with f32 m / l / acc, scale
// D^-0.5, the finite NEG_INF = -0.7 * FLT_MAX of the reference, division by l
// at the end, output in q's type.  Query head h*G + g reads KV head h.  No
// window, meta or ALiBi term, as in the TPU kernel.
//
// The Pallas grid walks (B, Hkv, logical block) in order, one page a step,
// with the state of all C*G query rows of a KV head's group in VMEM scratch.
// Hopper blocks run in no order, so here one block owns (tile of 64 of the
// C*G rows, KV head, sequence) and loops over the keys itself, as
// flash_attention.cu does.  Row r of the tile is (chunk row r / G, group
// member r % G), so the G query heads of a KV head share every K/V tile.  A
// key tile is 64 slots (8 pages at the serving page size of 8), each row's
// page looked up in the table (base + page * page_stride + slot * Hkv * D +
// h * D).  The page stride
// is a parameter, so the pages may be one layer's strided view of the pool
// [N, L, bs, Hkv, D]: nothing is copied.  The loop stops at the causal limit
// of the tile's last row, min(q_start + q_len, q_start + its query + 1), so
// it reads the pages up to ceil((q_start + q_len) / bs) at most and never a
// table entry or slot past them (a freed page keeps whatever it held).
//
// What bounds it on the H100: the work is 4 * Hq * D flops per visible
// (query, slot) pair against the pages read and q / out moved once: with
// G = 1 in bf16, fewer than C flops per byte of K/V, so at the chunk-set
// shape (C = 64, D = 64) the bytes bound it, far below the 295 at which the
// tensor cores would.  Reaching the bytes' bound needs the products off the
// CUDA cores and the page loads off the critical path.
//
// bf16 (paged_prefill_wgmma_kernel): the block is one warpgroup, and the
// body is flash_attention.cu's wgmma body with its loads made for pages.
//   * Loads: 16-byte cp.async by every thread, no TMA.  A 64-slot key tile
//     spans 64 / bs pages anywhere in the pool (for any bs, not only one
//     that divides 64), and the 64 query rows (chunk row, group member) are
//     not one box when 64 is not a multiple of G.  Each thread copies one
//     16-byte column chunk of four rows into the 128-byte swizzle
//     (hopper.cuh), Q once and the K/V tiles into a ring of three stages;
//     its rows' page offsets for the tile after next are read from the table
//     while the ring fills, so no table read sits between two copies.  A key
//     at or past the loop's limit, a row past the tile's rows and a column
//     past D are written as zeros (cp.async with a source size of 0), never
//     left stale: P = 0 times a NaN in shared memory is NaN inside wgmma.
//     D = 96 fills two boxes, its last 32 columns zeros; D = 192 three.
//     No table entry or page past that limit is read.  Each thread fences
//     its copies to the async proxy after they land, before the barrier that
//     hands the tile to wgmma.
//   * S = Q.K^T on wgmma m64n64k16, Q and K K-major; softmax on the
//     accumulator fragment (mask only on the tiles that cross a row's causal
//     limit or the chunk's end, ex2.approx with the scale folded in); O +=
//     P.V with P converted to bf16 in registers as the A fragment and V read
//     MN-major from its swizzled tile, N the padded head dim (64, 128 or
//     192; D = 96 computes its 32 zero columns and stores none).
// f32 (paged_prefill_kernel) keeps the CUDA-core body: TF32 or bf16 products
// cannot hold the f32 parity band of 2e-5.  Each of its 128 threads holds a
// 4 x 8 patch of the score tile and a 4 x D/8 patch of the output, over f32
// shared rows padded to D + 1 floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kBQ = 64;                    // query rows (chunk row, group member) per block
constexpr int kBK = 64;                    // slots per key tile
constexpr int kLanes = 8;                  // threads sharing one row group
constexpr int kRows = kBQ / (kThreads / kLanes);   // 4 query rows per thread
constexpr int kCols = kBK / kLanes;                // 8 keys per thread per tile
constexpr int kLdp = kBK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Copies rows [0, n) of D elements, row j starting at src(j), into f32 shared
// rows of stride ld, 16 bytes per thread per step; rows [n, fill) are zeroed.
template <typename T, int D, typename Src>
__device__ __forceinline__ void stage_rows(Src src, int n, int fill, float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < fill * kPerRow; i += kThreads) {
    const int j = i / kPerRow, c = i - j * kPerRow;
    float* d = dst + j * ld + c * kVec;
    if (j < n) {
      const uint4 u = *reinterpret_cast<const uint4*>(src(j) + c * kVec);
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
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ tables,
                     const int* __restrict__ q_starts, const int* __restrict__ q_lens,
                     T* __restrict__ out, int C, int max_blocks, int bs, long long page_stride,
                     int Hq, int Hkv, float scale) {
  constexpr int kDCols = D / kLanes;       // output dims per thread
  constexpr int ld = D + 1;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;                // KV head
  const int b = blockIdx.z;                // sequence
  const int nr = min(kBQ, C * G - r0);
  const int tid = threadIdx.x;
  const int tr = tid / kLanes;             // row group: rows tr*kRows ..
  const int tc = tid % kLanes;             // keys tc + 8*j, dims tc + 8*j

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kBQ][D+1]
  float* k_s = q_s + kBQ * ld;             // [kBK][D+1]
  float* v_s = k_s + kBK * ld;             // [kBK][D+1]
  float* p_s = v_s + kBK * ld;             // [kBQ][kBK+1]

  const int start = q_starts[b];
  // slots any row of this sequence may see: [0, end)
  const int end = min(start + q_lens[b], max_blocks * bs);
  const long long qrow = (long long)Hq * D;    // elements between consecutive chunk rows
  const T* qb = q + (long long)b * C * qrow + (long long)h * G * D;
  T* ob = out + (long long)b * C * qrow + (long long)h * G * D;
  stage_rows<T, D>([=](int j) {
    const int r = r0 + j;
    return qb + (long long)(r / G) * qrow + (long long)(r % G) * D;
  }, nr, kBQ, q_s, ld);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  // slots past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them
  const int kend = min(end, start + (r0 + nr - 1) / G + 1);
  const long long slot_stride = (long long)Hkv * D;
  const int* table = tables + (long long)b * max_blocks;
  const T* kb = k + (long long)h * D;
  const T* vb = v + (long long)h * D;
  auto slot_off = [=](int p) -> long long {
    return (long long)table[p / bs] * page_stride + (long long)(p % bs) * slot_stride;
  };

  for (int t0 = 0; t0 < kend; t0 += kBK) {
    const int n = min(kBK, kend - t0);
    __syncthreads();                       // the last tile's P.V reads are done
    stage_rows<T, D>([=](int j) { return kb + slot_off(t0 + j); }, n, n, k_s, ld);
    stage_rows<T, D>([=](int j) { return vb + slot_off(t0 + j); }, n, n, v_s, ld);
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
      const int qpos = start + (r0 + row) / G;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = tc + kLanes * j;
        const int slot = t0 + key;
        const bool ok = key < n && slot <= qpos && slot < end;
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
    if (row >= nr) continue;
    const int r = r0 + row;
    T* o = ob + (long long)(r / G) * qrow + (long long)(r % G) * D;
    // l == 0 only when the sequence shows no slot at all (q_start + q_len == 0)
#pragma unroll
    for (int c = 0; c < kDCols; ++c)
      o[tc + kLanes * c] = from_float<T>(l[i] > 0.f ? acc[i][c] / l[i] : 0.f);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
                          (size_t)kBQ * kLdp);
}

// ---------------------------------------------------------------------------
// bf16: one warpgroup on wgmma, K/V pages by cp.async
// ---------------------------------------------------------------------------

constexpr int kStages = 3;                 // K/V tiles in the ring

// Q, kStages K and V tiles, and 1 KB to align the tiles to the 1024 bytes the
// 128-byte swizzle repeats over.
constexpr size_t wgmma_smem_bytes(int D) {
  return 1024 + (size_t)(1 + 2 * kStages) * tile_bytes(D);
}

// Fragment of a wgmma m64nN f32 accumulator: thread (warp w, lane l) holds
// d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l & 3) + (i & 1).
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int* __restrict__ tables,
                           const int* __restrict__ q_starts, const int* __restrict__ q_lens,
                           __nv_bfloat16* __restrict__ out, int C, int max_blocks, int bs,
                           long long page_stride, int Hq, int Hkv, float scale_log2) {
  constexpr int kBoxes = boxes(D);         // 64-column boxes across the head dim
  constexpr int kDP = 64 * kBoxes;         // head dim padded to the boxes
  constexpr int kTile = tile_bytes(D);
  constexpr int kCopyRows = kBK / (kThreads / 8);   // rows a thread copies per tile: 4
  const int G = Hq / Hkv;
  const int r0 = blockIdx.x * kBQ;         // first query row (chunk row, member) of the tile
  const int h = blockIdx.y;                // KV head
  const int b = blockIdx.z;                // sequence
  const int nr = min(kBQ, C * G - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;               // [kBoxes][64][64]
  unsigned char* kv_s = q_s + kTile;       // [kStages][K, V][kBoxes][64][64]

  const int start = q_starts[b];
  // slots any row of this sequence may see: [0, end)
  const int end = min(start + q_lens[b], max_blocks * bs);
  // slots past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them, nor their table entries
  const int kend = max(0, min(end, start + (r0 + nr - 1) / G + 1));
  const int ntiles = (kend + kBK - 1) / kBK;

  // Thread tid copies 16-byte chunk cc of rows rr + 16 i of every box; as
  // 16 i is a multiple of 8, each of its rows puts the chunk at cc ^ (rr & 7).
  const int cc = tid % 8, rr = tid / 8;
  const int swz = rr * 128 + ((cc ^ (rr & 7)) * 16);
  auto dst = [&](unsigned char* tile, int i, int x) { return tile + x * kAtom + i * 2048 + swz; };

  const long long qrow = (long long)Hq * D;    // elements between consecutive chunk rows
  const __nv_bfloat16* qb = q + (long long)b * C * qrow + (long long)h * G * D;
#pragma unroll
  for (int i = 0; i < kCopyRows; ++i) {
    const int j = rr + 16 * i, r = r0 + j;
    const __nv_bfloat16* src = qb + (long long)(r / G) * qrow + (long long)(r % G) * D;
#pragma unroll
    for (int x = 0; x < kBoxes; ++x) {
      const int col = 64 * x + 8 * cc;
      const bool ok = j < nr && col < D;
      cp_async16_zfill(dst(q_s, i, x), ok ? src + col : qb, ok ? 16 : 0);
    }
  }

  const long long krow = (long long)Hkv * D;   // elements between consecutive slots
  const int* table = tables + (long long)b * max_blocks;
  const __nv_bfloat16* kb = k + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)h * D;
  // the element offsets of this thread's rows of tile t in the pages, -1 at
  // or past kend (whose table entries are not read)
  long long off[kCopyRows];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < kCopyRows; ++i) {
      const int p = t * kBK + rr + 16 * i;
      const int page = p / bs;
      off[i] = p < kend ? (long long)table[page] * page_stride + (long long)(p - page * bs) * krow
                        : -1;
    }
  };
  auto issue = [&](int t) {
    unsigned char* ks = kv_s + (t % kStages) * 2 * kTile;
#pragma unroll
    for (int i = 0; i < kCopyRows; ++i) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        const int col = 64 * x + 8 * cc;
        const bool ok = off[i] >= 0 && col < D;
        cp_async16_zfill(dst(ks, i, x), ok ? kb + off[i] + col : kb, ok ? 16 : 0);
        cp_async16_zfill(dst(ks + kTile, i, x), ok ? vb + off[i] + col : vb, ok ? 16 : 0);
      }
    }
  };
  // Q goes out with tile 0, then the ring fills; each group is committed
  // even when empty, so that group j is tile j's
  fetch(0);
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
    fetch(t + 1);
  }

  float o[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows w0 and w0 + 8, log2 units
  const int w0 = warp * 16 + lane / 4;
  // the last slot each of the thread's two rows sees; the tile's first row
  // sees the fewest, and the limits grow with the row
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lim[r] = min(start + (r0 + w0 + 8 * r) / G, end - 1);
  const int lim_lo = min(start + r0 / G, end - 1);
  const uint32_t q_addr = smem_u32(q_s);

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j (and Q) landed; every warp is done with tile j - 1
    if (j + kStages - 1 < ntiles) issue(j + kStages - 1);   // into tile j - 1's stage
    cp_async_commit();
    fetch(j + kStages);
    const unsigned char* ks = kv_s + (j % kStages) * 2 * kTile;

    // S = Q.K^T: K-major boxes; a k16 step is 32 bytes along a 128-byte row
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(ks);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {    // the zero columns past D add nothing
      const uint32_t step = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(s, gmma_desc(q_addr + step, 16, 1024), gmma_desc(k_addr + step, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the mask and the row max act on raw scores; the scale (positive)
    // enters once, in the exponent's multiply-add.  Slots past a row's
    // limit, the zero-filled ones past kend among them, are masked.
    const int t0 = j * kBK;
    if (t0 + kBK - 1 > lim_lo) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key > lim[(i >> 1) & 1]) s[i] = kNegInf;
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
    const uint32_t v_addr = smem_u32(ks + kTile);
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
  }
  cp_async_wait<0>();                      // Q's copy, where no tile was walked

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // l == 0 only when the sequence shows no slot at all (q_start + q_len == 0)
    l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  __nv_bfloat16* ob = out + (long long)b * C * qrow + (long long)h * G * D;
#pragma unroll
  for (int i = 0; i < kDP / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = w0 + 8 * r;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (col < D && row < nr) {
      const int R = r0 + row;
      __nv_bfloat16* dst_o = ob + (long long)(R / G) * qrow + (long long)(R % G) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst_o) =
          __floats2bfloat162_rn(o[i] * l[r], o[i + 1] * l[r]);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const int* tables,
                         const int* q_starts, const int* q_lens, void* out, int B, int C,
                         int max_blocks, int bs, long long page_stride, int Hq, int Hkv,
                         float scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(D);
  const cudaError_t e = cudaFuncSetAttribute(paged_prefill_wgmma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  const int rows = C * (Hq / Hkv);
  dim3 grid((unsigned)((rows + kBQ - 1) / kBQ), (unsigned)Hkv, (unsigned)B);
  paged_prefill_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), tables, q_starts, q_lens,
      static_cast<__nv_bfloat16*>(out), C, max_blocks, bs, page_stride, Hq, Hkv,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* q_starts, const int* q_lens, void* out, int B, int C,
                   int max_blocks, int bs, long long page_stride, int Hq, int Hkv, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = C * (Hq / Hkv);
  dim3 grid((unsigned)((rows + kBQ - 1) / kBQ), (unsigned)Hkv, (unsigned)B);
  paged_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      q_starts, q_lens, static_cast<T*>(out), C, max_blocks, bs, page_stride, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v,
                         const int* tables, const int* qs, const int* ql, void* out, int B,
                         int C, int max_blocks, int bs, long long ps, int Hq, int Hkv,
                         float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, tables, qs, ql, out, B, C, max_blocks, bs, ps, Hq, Hkv,
                            scale, s);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, tables, qs, ql, out, B, C, max_blocks, bs, ps, Hq, Hkv,
                           scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared memory (bytes) one block needs at dtype code `dtype` and head dim D.
extern "C" long long repro_paged_prefill_smem(int dtype, int D) {
  return (long long)(dtype == 1 ? wgmma_smem_bytes(D) : smem_bytes(D));
}

// dtype: 0 = float32 (paged_prefill_kernel), 1 = bfloat16
// (paged_prefill_wgmma_kernel).  q/out [B,C,Hq,D] contiguous; k/v pages
// [N,bs,Hkv,D] whose (bs, Hkv, D) are dense and whose pages lie page_stride
// elements apart (the same for k and v); block_tables device int32
// [B,max_blocks] contiguous, every entry of a sequence's first
// ceil(min(q_starts[b] + q_lens[b], max_blocks * bs) / bs) a valid page id
// (the kernels read no other entry); q_starts, q_lens device int32 [B],
// non-negative.  D in {16, 32, 64, 96, 128, 192}; Hq % Hkv == 0; base
// pointers and strides 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int repro_paged_prefill_attention(int dtype, const void* q, const void* k_pages,
                                             const void* v_pages, const int* block_tables,
                                             const int* q_starts, const int* q_lens, void* out,
                                             int B, int C, int max_blocks, int bs,
                                             long long page_stride, int Hq, int Hkv, int D,
                                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define REPRO_LAUNCH(DIM)                                                                     \
  launch_dtype<DIM>(dtype, q, k_pages, v_pages, block_tables, q_starts, q_lens, out, B, C,     \
                    max_blocks, bs, page_stride, Hq, Hkv, scale, s)
    case 16: return REPRO_LAUNCH(16);
    case 32: return REPRO_LAUNCH(32);
    case 64: return REPRO_LAUNCH(64);
    case 96: return REPRO_LAUNCH(96);
    case 128: return REPRO_LAUNCH(128);
    case 192: return REPRO_LAUNCH(192);
#undef REPRO_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
