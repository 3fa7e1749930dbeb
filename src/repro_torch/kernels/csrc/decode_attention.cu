// batched_decode_attention and decode_attention — one-query decode attention
// on Hopper, two entry points over one kernel template.
//
// batched_decode_attention replaces the TPU kernel of that name in
// src/repro/kernels/decode_attention.py: one new query per sequence for B
// sequences over dense per-sequence K/V [B, S, Hkv, D], each sequence masked
// to its own live length lengths[b] (the new token included), with an
// optional per-sequence sliding-window start win_starts[b], `num_meta`
// always-visible sink slots, and optional ALiBi slopes [Hq] (bias
// -slope * max(len-1-j, 0)).  Online softmax with f32 m / l / acc, scale
// D^-0.5, and the finite NEG_INF = -0.7 * FLT_MAX of the reference.  Query
// head h*G+g reads KV head h.  Probabilities stay in f32 for P·V, as in the
// Pallas kernel.
//
// What bounds it on the H100: bytes.  Each K/V element is read once and used
// for 2*G flops (G = Hq/Hkv query heads of its group), far below the 295
// flop/byte at which bf16 compute becomes the limit; the least time is the
// visible K/V bytes over 3.35 TB/s.  The design follows from that:
//   * one block per (KV head, sequence) keeps the G query rows in shared
//     memory and streams that head's K/V exactly once, in tiles of 64 keys,
//     with 16-byte loads of contiguous D-element rows;
//   * the key loop stops at lengths[b] and skips tiles that lie wholly
//     outside the window (before the start and past the meta sinks), so the
//     bytes read track each sequence's visible keys, not the padded S;
//   * nothing is assumed about powers of two (G = 1 at gpt2 width, Hq = 25):
//     threads stride over (row, key) and (row, dim) pairs.
//
// decode_attention replaces the TPU kernel `decode_attention` of the same
// file: q [B, Hq, D] over k/v [B, S, Hkv, D] with ONE validity vector [S]
// shared by every sequence (the microbatch decode of the run() path, and a
// sliding window with meta sinks is not a prefix of it).  It is the same
// kernel with kValidVec = true: validity comes from the device vector, no
// length, window or ALiBi term.  The key loop runs to S; a tile whose 64
// validity flags are all zero is skipped (one __syncthreads_or), which adds
// exactly what the TPU kernel adds for it once a valid key exists: nothing.
// A row with no valid key at all, which the run() path never produces, comes
// out as zeros here (the TPU kernel returns an average over its zero-padded
// keys there).  Bound by bytes like the batched entry: the visible K/V bytes.
//
// paged_decode_attention replaces the TPU kernel `paged_decode_attention` of
// the same file: q [B, Hq, D] over K/V pages [N, bs, Hkv, D] that sequence b
// reads through its block-table row (logical block j of the sequence lives in
// page block_tables[b, j]), masked to lengths[b] live tokens.  No window, meta
// or ALiBi term, as in the TPU kernel.  It is the batched entry's kernel with
// one change, the address of key p: page block_tables[b, p / bs], slot p % bs,
// at base + page * page_stride + slot * Hkv * D + h * D.  The page stride is a
// parameter, so the pages may be one layer's strided view of the pool
// [N, L, bs, Hkv, D] and nothing is copied.  A key tile of 64 spans several
// pages (8 of 8 slots), each row looked up on its own, so a small page does not
// shrink the tile.  The loop walks keys [0, lengths[b]) only: a table entry
// past a sequence's ceil(len / bs) pages, and a slot past its length, are never
// read (a freed page keeps whatever it held).  Bound by bytes like the batched
// entry: the live K/V bytes.
//
// A later PR adds wgmma for P·V and split-K when B*Hkv blocks underfill the
// 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kTileK = 64;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copies keys t0 .. t0+n-1 (D elements each, key p at src + key_off(p)) into
// f32 shared memory rows of stride ldk, 16 bytes per thread per step.
template <typename T, typename KeyOff>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, KeyOff key_off, int t0,
                                           int n, int D, float* dst, int ldk) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int j = i / per_row, c = i - j * per_row;
    const uint4 u = *reinterpret_cast<const uint4*>(src + key_off(t0 + j) + c * kVec);
    const T* e = reinterpret_cast<const T*>(&u);
    float* d = dst + j * ldk + c * kVec;
#pragma unroll
    for (int x = 0; x < kVec; ++x) d[x] = to_float(e[x]);
  }
}

// The body of all three entries.  kPaged: k/v are pages read through tables
// [B, S / bs] with page stride page_stride (elements); S is then the tables'
// capacity in slots.
template <typename T, bool kValidVec, bool kPaged>
__device__ __forceinline__ void decode_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, const int* __restrict__ win_starts,
    const float* __restrict__ slopes, const bool* __restrict__ valid,
    const int* __restrict__ tables, int bs, long long page_stride, T* __restrict__ out, int S,
    int Hq, int Hkv, int D, int num_meta, float scale) {
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // sequence
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int ldk = D + 1;  // padded rows: column reads hit distinct banks

  extern __shared__ float smem[];
  float* k_s = smem;                    // [kTileK][D+1]
  float* v_s = k_s + kTileK * ldk;      // [kTileK][D+1]
  float* q_s = v_s + kTileK * ldk;      // [G][D]
  float* acc_s = q_s + G * D;           // [G][D]
  float* p_s = acc_s + G * D;           // [G][kTileK]
  float* m_s = p_s + G * kTileK;        // [G]
  float* l_s = m_s + G;                 // [G]
  float* alpha_s = l_s + G;             // [G]

  const int len = kValidVec ? S : min(lengths[b], S);
  const int ws = (!kValidVec && win_starts) ? max(win_starts[b], 0) : 0;

  const T* qb = q + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const long long row = (long long)Hkv * D;  // elements between consecutive keys
  const long long seq = kPaged ? 0 : (long long)b * S * row;
  const T* kb = k + seq + (long long)h * D;
  const T* vb = v + seq + (long long)h * D;
  const int* table = kPaged ? tables + (long long)b * (S / bs) : nullptr;
  auto key_off = [=](int p) -> long long {
    if (kPaged) return (long long)table[p / bs] * page_stride + (long long)(p % bs) * row;
    return (long long)p * row;
  };

  for (int t0 = 0; t0 < len; t0 += kTileK) {
    const int t1 = min(t0 + kTileK, len);
    if (kValidVec) {
      // no valid key in this tile: it adds exactly nothing once one exists
      if (!__syncthreads_or(tid < t1 - t0 && valid[t0 + tid])) continue;
    } else if (t0 >= num_meta && t1 <= ws) {
      // every key of this tile is past the meta sinks and before the window
      // start: all masked, so it adds exactly nothing once a visible key exists
      continue;
    }
    const int n = t1 - t0;
    stage_tile(kb, key_off, t0, n, D, k_s, ldk);
    stage_tile(vb, key_off, t0, n, D, v_s, ldk);
    __syncthreads();

    for (int i = tid; i < G * kTileK; i += kThreads) {
      const int g = i / kTileK, j = i - g * kTileK;
      float s = kNegInf;
      if (j < n) {
        const int pos = t0 + j;
        const float* kr = k_s + j * ldk;
        const float* qr = q_s + g * D;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (kValidVec) {
          if (!valid[pos]) s = kNegInf;
        } else {
          if (slopes != nullptr) s -= slopes[h * G + g] * (float)max(len - 1 - pos, 0);
          if (!(pos >= ws || pos < num_meta)) s = kNegInf;
        }
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kTileK;
      float mx = kNegInf;
      for (int j = lane; j < kTileK; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTileK; j += 32) {
        const float p = j < n ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float* pr = p_s + g * kTileK;
      float a = 0.f;
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * ldk + d], a);
      acc_s[i] = acc_s[i] * alpha_s[g] + a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * Hq + (long long)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    // l == 0 only when every tile was skipped: a row with no valid key
    ob[i] = from_float<T>(kValidVec && l == 0.f ? 0.f : acc_s[i] / l);
  }
}

#define REPRO_DECODE_PARAMS                                                                 \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,                \
      const int *__restrict__ lengths, const int *__restrict__ win_starts,                  \
      const float *__restrict__ slopes, const bool *__restrict__ valid,                     \
      const int *__restrict__ tables, int bs, long long page_stride, T *__restrict__ out,   \
      int S, int Hq, int Hkv, int D, int num_meta, float scale
#define REPRO_DECODE_ARGS \
  q, k, v, lengths, win_starts, slopes, valid, tables, bs, page_stride, out, S, Hq, Hkv, D, \
      num_meta, scale

// batched_decode_attention (kValidVec false) and decode_attention (true)
template <typename T, bool kValidVec>
__global__ void __launch_bounds__(kThreads) batched_decode_kernel(REPRO_DECODE_PARAMS) {
  decode_body<T, kValidVec, false>(REPRO_DECODE_ARGS);
}

// paged_decode_attention: a kernel of its own name, so that profiles tell it apart
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(REPRO_DECODE_PARAMS) {
  decode_body<T, false, true>(REPRO_DECODE_ARGS);
}

template <typename T, bool kValidVec, bool kPaged = false>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   const int* win_starts, const float* slopes, const bool* valid, void* out,
                   int B, int S, int Hq, int Hkv, int D, int num_meta, float scale,
                   cudaStream_t stream, const int* tables = nullptr, int bs = 1,
                   long long page_stride = 0) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)2 * kTileK * (D + 1) + (size_t)2 * G * D +
                                       (size_t)G * kTileK + (size_t)3 * G);
  auto kernel = kPaged ? paged_decode_kernel<T> : batched_decode_kernel<T, kValidVec>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)Hkv, (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      win_starts, slopes, valid, tables, bs, page_stride, static_cast<T*>(out), S, Hq, Hkv,
      D, num_meta, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block needs; the wrapper refuses shapes above the
// 227 KB a block may use.
extern "C" long long repro_batched_decode_smem(int Hq, int Hkv, int D) {
  const long long G = Hq / Hkv;
  return (long long)sizeof(float) * (2LL * kTileK * (D + 1) + 2 * G * D + G * kTileK + 3 * G);
}

// dtype: 0 = float32, 1 = bfloat16.  q [B,Hq,D], k/v [B,S,Hkv,D], out [B,Hq,D]
// contiguous; lengths (and win_starts when non-null) device int32 [B]; slopes
// device float32 [Hq] or null.  Returns cudaGetLastError() after the launch.
extern "C" int repro_batched_decode_attention(int dtype, const void* q, const void* k,
                                              const void* v, const int* lengths,
                                              const int* win_starts, const float* slopes,
                                              void* out, int B, int S, int Hq, int Hkv,
                                              int D, int num_meta, float scale,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(q, k, v, lengths, win_starts, slopes, nullptr, out, B, S, Hq,
                                Hkv, D, num_meta, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, lengths, win_starts, slopes, nullptr, out, B,
                                        S, Hq, Hkv, D, num_meta, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// decode_attention: dtype as above; q/out [B,Hq,D], k/v [B,S,Hkv,D]
// contiguous; valid a device bool [S] shared by every sequence.  Shared
// memory as repro_batched_decode_smem.  Returns cudaGetLastError().
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                      const bool* valid, void* out, int B, int S, int Hq,
                                      int Hkv, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(q, k, v, nullptr, nullptr, nullptr, valid, out, B, S, Hq, Hkv,
                               D, 0, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k, v, nullptr, nullptr, nullptr, valid, out, B, S,
                                       Hq, Hkv, D, 0, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// paged_decode_attention: dtype as above; q/out [B,Hq,D] contiguous; k/v
// pages [N,bs,Hkv,D] whose (bs, Hkv, D) are dense and whose pages lie
// page_stride elements apart (the same for k and v); block_tables device
// int32 [B,max_blocks] contiguous, every entry of a sequence's first
// ceil(lengths[b] / bs) a valid page id; lengths device int32 [B], each >= 1
// and at most max_blocks * bs.  Shared memory as repro_batched_decode_smem.
// Returns cudaGetLastError().
extern "C" int repro_paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                            const void* v_pages, const int* block_tables,
                                            const int* lengths, void* out, int B,
                                            int max_blocks, int bs, long long page_stride,
                                            int Hq, int Hkv, int D, float scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = max_blocks * bs;
  if (dtype == 0)
    return launch<float, false, true>(q, k_pages, v_pages, lengths, nullptr, nullptr, nullptr,
                                      out, B, S, Hq, Hkv, D, 0, scale, s, block_tables, bs,
                                      page_stride);
  if (dtype == 1)
    return launch<__nv_bfloat16, false, true>(q, k_pages, v_pages, lengths, nullptr, nullptr,
                                              nullptr, out, B, S, Hq, Hkv, D, 0, scale, s,
                                              block_tables, bs, page_stride);
  return static_cast<int>(cudaErrorInvalidValue);
}
