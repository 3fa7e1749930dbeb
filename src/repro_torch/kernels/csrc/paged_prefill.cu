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
// key tile is 64 slots, 8 pages of 8 slots, each row's page looked up in the
// table (base + page * page_stride + slot * Hkv * D + h * D).  The page stride
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
// tensor cores would.  This first version computes in f32 on the
// CUDA cores, as flash_attention.cu does (each thread a 4 x 8 patch of the
// score tile and a 4 x D/8 patch of the output, shared rows padded to D + 1
// floats), and reaches neither bound.  wgmma, TMA-fed tiles and pipelining
// are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* tables,
                     const int* qs, const int* ql, void* out, int B, int C, int max_blocks,
                     int bs, long long ps, int Hq, int Hkv, int D, float scale,
                     cudaStream_t s) {
  switch (D) {
#define REPRO_LAUNCH(DIM) \
  launch<T, DIM>(q, k, v, tables, qs, ql, out, B, C, max_blocks, bs, ps, Hq, Hkv, scale, s)
    case 16: return REPRO_LAUNCH(16);
    case 32: return REPRO_LAUNCH(32);
    case 64: return REPRO_LAUNCH(64);
    case 128: return REPRO_LAUNCH(128);
#undef REPRO_LAUNCH
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) one block needs at head dim D.
extern "C" long long repro_paged_prefill_smem(int D) { return (long long)smem_bytes(D); }

// dtype: 0 = float32, 1 = bfloat16.  q/out [B,C,Hq,D] contiguous; k/v pages
// [N,bs,Hkv,D] whose (bs, Hkv, D) are dense and whose pages lie page_stride
// elements apart (the same for k and v); block_tables device int32
// [B,max_blocks] contiguous, every entry of a sequence's first
// ceil(min(q_starts[b] + q_lens[b], max_blocks * bs) / bs) a valid page id;
// q_starts, q_lens device int32 [B], non-negative.  D in {16, 32, 64, 128};
// Hq % Hkv == 0; base pointers and strides 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_paged_prefill_attention(int dtype, const void* q, const void* k_pages,
                                             const void* v_pages, const int* block_tables,
                                             const int* q_starts, const int* q_lens, void* out,
                                             int B, int C, int max_blocks, int bs,
                                             long long page_stride, int Hq, int Hkv, int D,
                                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k_pages, v_pages, block_tables, q_starts, q_lens, out, B, C,
                           max_blocks, bs, page_stride, Hq, Hkv, D, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k_pages, v_pages, block_tables, q_starts, q_lens, out,
                                   B, C, max_blocks, bs, page_stride, Hq, Hkv, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
