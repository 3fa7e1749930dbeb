// batched_decode_attention, decode_attention and paged_decode_attention —
// one-query decode attention on Hopper, in two kernel bodies.
//
// All three replace the TPU kernels of those names in
// src/repro/kernels/decode_attention.py and compute what they compute:
// online softmax with f32 m / l / acc, scale D^-0.5, the finite
// NEG_INF = -0.7 * FLT_MAX of the reference, query head h*G+g reading KV
// head h.  A row with no valid key gives the uniform average of V over its
// S slots, as the Pallas kernels and the plain versions do (their scores
// are all NEG_INF, so every slot weighs the same).
//
// What bounds them on the H100: bytes.  Each K/V element is read once and
// used for 2*G flops (one multiply-add per query head of its group), that
// is G flops per byte in bf16, with G <= 5 on every live path (gpt2 1,
// Hymba 5).  The bf16 tensor cores need 295 flops per byte before they, and
// not the memory, set the pace, and even the CUDA cores' f32 rate (67
// TFLOP/s, 20 flops per byte at 3.35 TB/s) is four times what G = 5 asks.
// So no tensor core: the least time is the visible K/V bytes over
// 3.35 TB/s, and the designs are about keeping enough bytes in flight.
//
// decode_attention (validity vector [S] shared by the batch: the run()
// path's microbatch decode and Hymba's ring) and paged_decode_attention
// (K/V pages [N,bs,Hkv,D] read through block tables to lengths[b]: the
// fused decode pass of run_continuous) run the split body:
//   * Split-K across a thread-block cluster.  One (KV head, sequence) holds
//     far too few bytes for one block to keep the memory busy, and B*Hkv
//     blocks leave the 132 SMs short (100 at mb_serve's decode, 20 at
//     Hymba's).  A cluster of `splits` blocks (at most 8, the portable size)
//     shares the key range, cut in whole 64-key tiles of the capacity S: the
//     fewest splits for which the blocks cover the SMs twice, chosen on the
//     host from S alone (no read of lengths).  A block past the length
//     contributes (m = NEG_INF, l = 0, acc = 0).
//   * The combine stays on chip, in one launch with no workspace: each warp
//     keeps its own online softmax, the warps merge in shared memory, and
//     after cluster.sync() each block reads every block's (m, l) and its
//     share of acc[G,D] through map_shared_rank in one round of loads,
//     rescales, and writes q's dtype.
//   * Tiles stay in their stored type in a ring of up to 3 stages filled by
//     16-byte cp.async, so the next tiles' loads are in flight while this one
//     is scored.  Paged keys take their page from block_tables[b, p / bs];
//     only keys below the length are read.  For a validity vector one load
//     of 64 flags a lane marks which of 32 tiles hold a valid key; a tile
//     with none is neither loaded nor scored.
//   * Scores: two lanes split each key's row (one shuffle), Q in shared
//     memory as f32, K rows stored with their 16-byte chunks swizzled so the
//     two lanes of 4 keys hit distinct banks; no serial D loop.  P.V: lanes
//     own (key group, 16-byte chunk) accumulators for every query row of the
//     block, folded across key groups once at the end.  A block takes all G
//     rows of its group (instances for 1, 5 and 8 rows; G above 8 in blocks
//     of 8 rows).
// At the live shapes each block walks 1-8 tiles, so the fixed costs (the
// first loads, the two cluster barriers, the combine) weigh as much as the
// streaming; chip_smoke.py's kernels phase times both bodies.
//
// batched_decode_attention (dense per-sequence K/V [B,S,Hkv,D], lengths,
// optional window starts, meta sinks and ALiBi slopes: the gather route of
// stages with a windowed or ALiBi layer) keeps the first body: one block
// per (KV head, sequence) staging f32 tiles of 64 keys, skipping tiles that
// lie wholly outside the window.  It runs on that route alone.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 64;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kMaxStages = 3;
constexpr size_t kMaxSmem = 232448; // bytes of shared memory one block may use

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

// The sum of dimension d of V over the slots [p0, p1) of one (KV head,
// sequence), key p at vb + key_off(p): what a row with no valid key averages.
// A cold path, kept out of line.
template <typename T, typename KeyOff>
__device__ __noinline__ float slot_sum(const T* __restrict__ vb, KeyOff key_off, int p0, int p1,
                                       int d) {
  float s = 0.f;
  for (int p = p0; p < p1; ++p) s += to_float(vb[key_off(p) + d]);
  return s;
}

// ---------------------------------------------------------------------------
// batched_decode_attention: one block per (KV head, sequence)
// ---------------------------------------------------------------------------

// Copies keys t0 .. t0+n-1 of a row stride `row` into f32 shared memory rows
// of stride ldk, 16 bytes per thread per step.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, long long row, int t0,
                                           int n, int D, float* dst, int ldk) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int j = i / per_row, c = i - j * per_row;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (t0 + j) * row + c * kVec);
    const T* e = reinterpret_cast<const T*>(&u);
    float* d = dst + j * ldk + c * kVec;
#pragma unroll
    for (int x = 0; x < kVec; ++x) d[x] = to_float(e[x]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) batched_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, const int* __restrict__ win_starts,
    const float* __restrict__ slopes, T* __restrict__ out, int S, int Hq, int Hkv, int D,
    int num_meta, float scale) {
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // sequence
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  const int len = max(0, min(lengths[b], S));
  const int ws = win_starts ? max(win_starts[b], 0) : 0;
  if (len == 0) {
    // no valid key: the uniform average of V over the S slots, taken before
    // the loop (where the hot path keeps its registers)
    const long long row = (long long)Hkv * D;
    const T* vb = v + (long long)b * S * row + (long long)h * D;
    T* ob = out + ((long long)b * Hq + (long long)h * G) * D;
    for (int i = tid; i < G * D; i += kThreads)
      ob[i] = from_float<T>(slot_sum(vb, [=](int p) { return p * row; }, 0, S, i % D) / (float)S);
    return;
  }

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
  const T* kb = k + (long long)b * S * row + (long long)h * D;
  const T* vb = v + (long long)b * S * row + (long long)h * D;

  for (int t0 = 0; t0 < len; t0 += kTileK) {
    const int t1 = min(t0 + kTileK, len);
    if (t0 >= num_meta && t1 <= ws) {
      // every key of this tile is past the meta sinks and before the window
      // start: all masked, so it adds exactly nothing once a visible key exists
      continue;
    }
    const int n = t1 - t0;
    stage_tile(kb, row, t0, n, D, k_s, ldk);
    stage_tile(vb, row, t0, n, D, v_s, ldk);
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
        if (slopes != nullptr) s -= slopes[h * G + g] * (float)max(len - 1 - pos, 0);
        if (!(pos >= ws || pos < num_meta)) s = kNegInf;
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
  for (int i = tid; i < G * D; i += kThreads) ob[i] = from_float<T>(acc_s[i] / l_s[i / D]);
}

size_t batched_smem(int G, int D) {
  return sizeof(float) * ((size_t)2 * kTileK * (D + 1) + (size_t)2 * G * D +
                          (size_t)G * kTileK + (size_t)3 * G);
}

// ---------------------------------------------------------------------------
// decode_attention and paged_decode_attention: split-K over a cluster
// ---------------------------------------------------------------------------

struct SplitArgs {
  const void* q;           // [B, Hq, D]
  const void* k;           // dense [B, S, Hkv, D], or pages [N, bs, Hkv, D]
  const void* v;
  const bool* valid;       // decode_attention: [S]
  const int* lengths;      // paged: [B]
  const int* tables;       // paged: [B, max_blocks]
  void* out;               // [B, Hq, D]
  long long page_stride;   // paged: elements between pages
  int bs, bs_log2;         // paged: page size, and its log2 (-1 if not a power of 2)
  int max_blocks;          // paged
  int S, Hq, Hkv, D;       // S: the dense length, or max_blocks * bs
  int stages;              // ring stages, 1..kMaxStages
  float scale;
};

constexpr int kWarpKeys = kTileK / kWarps;   // the keys of a tile one warp scores

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most `pending` (0 or 1) committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one 16-byte chunk (4 f32 or 8 bf16) as f32, into f[0..]; by value and
// bit operations, so that the chunk stays one 16-byte load
template <typename T>
__device__ __forceinline__ void unpack(const uint4 u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {  // bf16 is the high half of an f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* f) {
  unpack<T>(*reinterpret_cast<const uint4*>(p), f);
}

// The split body: one block of a cluster of `splits` walks whole 64-key tiles
// [tlo, thi) of one (KV head, sequence) for query rows g0 .. g0+kG-1 of the
// head's group.  Each warp keeps its own online softmax over its 16 keys of
// every tile: two lanes score a key (half of its row each, one shuffle),
// and for P.V `lpk` lanes share a key's V row, one 16-byte chunk each (two
// for f32 rows past 128).  The warps merge in shared memory, then the blocks
// of the cluster through distributed shared memory.
template <typename T, bool kPaged, int kG>
__device__ __forceinline__ void split_body(const SplitArgs& a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();   // the cluster spans grid x
  const int r = (int)cluster.block_rank();
  const int D = a.D, S = a.S, G = a.Hq / a.Hkv;
  const int n_gb = (G + kG - 1) / kG;             // query-row blocks of a group
  const int h = blockIdx.y / n_gb;                 // KV head
  const int g0 = (blockIdx.y - h * n_gb) * kG;     // first query row of this block
  const int GB = min(kG, G - g0);
  const int b = blockIdx.z;                        // sequence
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCpl = sizeof(T) == 4 ? 2 : 1;     // chunks a lane holds in P.V (D <= 256)
  const int nchunk = D / kVec;                     // 16-byte chunks in a key row
  int lpk = 1, lpk_log2 = 0;                       // lanes per key row in loads and P.V
  while (lpk < nchunk && lpk < 32) lpk <<= 1, ++lpk_log2;
  const int kpp = 32 >> lpk_log2;                  // keys of a warp per P.V pass
  const int passes = (kWarpKeys + kpp - 1) / kpp;
  const int lk = lane & (lpk - 1), kg = lane >> lpk_log2;
  // K rows are stored with chunk c at c ^ (j & sw), so that the scores' two
  // lanes per key read distinct banks across the 4 keys of a quarter-warp
  const int sw = (nchunk & (nchunk - 1)) == 0 ? min(nchunk, 8) - 1 : 0;
  const int half = (nchunk + 1) >> 1;              // chunks a scoring lane takes

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);        // [stages][K, V][kTileK][D]
  float* q_s = reinterpret_cast<float*>(smem_raw + (size_t)a.stages * 2 * kTileK * D *
                                                       sizeof(T));   // [kG][D]
  float* p_w = q_s + kG * D;                       // [kWarps][kG][16]
  float* acc_w = p_w + kWarps * kG * kWarpKeys;    // [kWarps][kG][D]
  float2* ml_w = reinterpret_cast<float2*>(acc_w + kWarps * kG * D);   // [kWarps][kG]: m, l
  float* acc_s = reinterpret_cast<float*>(ml_w + kWarps * kG);  // [kG][D]: the block's partial
  float2* ml_s = reinterpret_cast<float2*>(acc_s + kG * D);     // [kG]: its m, l
  int* tile_s = reinterpret_cast<int*>(ml_s + kG);              // [kMaxStages]

  // this block's keys: whole tiles [tlo, thi) of the capacity, cut at kend
  const int nt = (S + kTileK - 1) / kTileK;
  const int tlo = nt * r / splits, thi = nt * (r + 1) / splits;
  const int kend = kPaged ? max(0, min(a.lengths[b], S)) : S;

  const long long row = (long long)a.Hkv * D;  // elements between consecutive keys
  const long long seq = kPaged ? 0 : (long long)b * S * row;
  const T* kb = static_cast<const T*>(a.k) + seq + (long long)h * D;
  const T* vb = static_cast<const T*>(a.v) + seq + (long long)h * D;
  const int* table = kPaged ? a.tables + (long long)b * a.max_blocks : nullptr;
  const int bs = a.bs, bs_log2 = a.bs_log2;
  const long long page_stride = a.page_stride;
  auto key_off = [=](int p) -> long long {
    if constexpr (kPaged) {
      const int page = bs_log2 >= 0 ? p >> bs_log2 : p / bs;
      return (long long)table[page] * page_stride + (long long)(p - page * bs) * row;
    } else {
      return (long long)p * row;
    }
  };
  const bool* valid = a.valid;
  // Validity: bit i of live_mask says whether tile mask_base + i holds a
  // valid key; lane i reads that tile's 64 flags, 32 tiles at a time.
  unsigned live_mask = 0;
  int mask_base = thi;
  auto load_mask = [&](int t) {
    mask_base = t;
    const int p0 = (t + lane) * kTileK;
    bool any = false;
    if (t + lane < thi) {
      if (p0 + kTileK <= S && (reinterpret_cast<uintptr_t>(valid + p0) & 15) == 0) {
#pragma unroll
        for (int i = 0; i < kTileK / 16; ++i) {
          const uint4 u = reinterpret_cast<const uint4*>(valid + p0)[i];
          any |= (u.x | u.y | u.z | u.w) != 0;
        }
      } else {
        for (int p = p0; p < min(p0 + kTileK, S); ++p) any |= valid[p];
      }
    }
    live_mask = __ballot_sync(0xffffffffu, any);
  };
  // The first tile at or after t that holds a key this block reads, thi if
  // none.  Every warp computes the same answer, so it is block-uniform.
  auto next_tile = [&](int t) -> int {
    if constexpr (kPaged) {
      return (t < thi && t * kTileK < kend) ? t : thi;
    } else {
      while (t < thi) {
        if (t < mask_base || t >= mask_base + 32) load_mask(t);
        const unsigned bits = live_mask >> (t - mask_base);
        if (bits) return t + __ffs(bits) - 1;
        t = mask_base + 32;
      }
      return thi;
    }
  };
  // Loads tile t into ring slot `slot` (16-byte cp.async, keys below kend;
  // lpk threads a row) and records it there; thi records that none follows.
  auto issue = [&](int t, int slot) {
    if (tid == 0) tile_s[slot] = t;
    if (t >= thi) return;
    T* ks = ring + (size_t)slot * 2 * kTileK * D;
    T* vs = ks + kTileK * D;
    const int t0 = t * kTileK, n = min(kTileK, kend - t0);
#pragma unroll 4
    for (int j = tid >> lpk_log2; j < n; j += kThreads >> lpk_log2) {
      const long long off = key_off(t0 + j);
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = lk + cc * lpk;
        if (c < nchunk) {
          cp_async16(ks + j * D + (c ^ (j & sw)) * kVec, kb + off + c * kVec);
          cp_async16(vs + j * D + c * kVec, vb + off + c * kVec);
        }
      }
    }
  };

  // the block's query rows go out first, then the ring's first tiles; the
  // rows reach shared memory in f32 (rows past the group zero), published
  // by the loop's first barrier
  constexpr int kQ = 8 * 256 / kVec / kThreads;   // 16-byte chunks of q a thread loads
  const uint4* qb = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.q) + ((long long)b * a.Hq + (long long)h * G + g0) * D);
  const int qn = GB * D / kVec;
  uint4 qv[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (tid + i * kThreads < qn) qv[i] = qb[tid + i * kThreads];
  int iss = next_tile(tlo);
  for (int s = 0; s < a.stages - 1; ++s) {
    issue(iss, s);
    if (iss < thi) iss = next_tile(iss + 1);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (tid + i * kThreads < qn) unpack<T>(qv[i], q_s + (tid + i * kThreads) * kVec);
  for (int i = GB * D + tid; i < kG * D; i += kThreads) q_s[i] = 0.f;
  float acc[kG][kCpl * kVec], m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < kCpl * kVec; ++x) acc[g][x] = 0.f;
  }

  float* pw = p_w + warp * kG * kWarpKeys;
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const int hf = lane & 1, kl = lane >> 1;         // scoring: key kl of the warp, half hf
  for (int slot = 0, islot = a.stages - 1;;) {
    if (a.stages > 1) cp_async_wait(a.stages - 2);
    __syncthreads();  // this slot's tile landed; every warp is done with the last one
    issue(iss, islot);  // into the last tile's slot
    if (iss < thi) iss = next_tile(iss + 1);
    cp_async_commit();
    if (a.stages == 1) {
      cp_async_wait(0);
      __syncthreads();
    }
    const int use = tile_s[slot];
    if (use >= thi) break;
    const T* ks = ring + (size_t)slot * 2 * kTileK * D;
    const T* vs = ks + kTileK * D;
    const int t0 = use * kTileK, n = min(kTileK, kend - t0);

    // the score of key kl on lanes 2kl and 2kl+1, NEG_INF where masked or
    // past the tile
    const int j = warp * kWarpKeys + kl;
    const bool live = j < n;
    const bool ok = live && (kPaged || valid[t0 + j]);
    float sc[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) sc[g] = 0.f;
    if (live) {
      const int c1 = min(nchunk, (hf + 1) * half);
#pragma unroll 4
      for (int c = hf * half; c < c1; ++c) {
        float kf[kVec];
        load_chunk(ks + j * D + (c ^ (j & sw)) * kVec, kf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
#pragma unroll
          for (int x = 0; x < kVec; x += 4) {
            const float4 qv = q4[(g * D + c * kVec + x) >> 2];
            sc[g] = fmaf(qv.x, kf[x], sc[g]);
            sc[g] = fmaf(qv.y, kf[x + 1], sc[g]);
            sc[g] = fmaf(qv.z, kf[x + 2], sc[g]);
            sc[g] = fmaf(qv.w, kf[x + 3], sc[g]);
          }
        }
      }
    }

    // online softmax over the warp's 16 keys: lanes of one parity hold each
    // key once, so 4 shuffle levels reduce over the keys
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float dot = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 1);
      const float s = ok ? dot * a.scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      // a masked key weighs exactly nothing, as exp(NEG_INF - m) does
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int x = 0; x < kCpl * kVec; ++x) acc[g][x] *= alpha;
      if (hf == 0) pw[g * kWarpKeys + kl] = p;
    }
    __syncwarp();

    // P.V: this lane's chunks of its keys' V rows
#pragma unroll 4
    for (int ps = 0; ps < passes; ++ps) {
      const int kv = ps * kpp + kg, jv = warp * kWarpKeys + kv;
      if (kv < kWarpKeys && jv < n) {
        float vf[kCpl * kVec];
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = lk + cc * lpk;
          if (c < nchunk) {
            load_chunk(vs + jv * D + c * kVec, &vf[cc * kVec]);
          } else {
#pragma unroll
            for (int x = 0; x < kVec; ++x) vf[cc * kVec + x] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float p = pw[g * kWarpKeys + kv];
#pragma unroll
          for (int x = 0; x < kCpl * kVec; ++x) acc[g][x] = fmaf(p, vf[x], acc[g][x]);
        }
      }
    }
    slot = slot + 1 == a.stages ? 0 : slot + 1;
    islot = islot + 1 == a.stages ? 0 : islot + 1;
  }
  cp_async_wait(0);

  // the warps' partials: fold the key groups of each chunk, then store
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int x = 0; x < kCpl * kVec; ++x) acc[g][x] += __shfl_xor_sync(0xffffffffu, acc[g][x], o);
    }
  }
  if (kg == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = lk + cc * lpk;
        if (c < nchunk) {
#pragma unroll
          for (int x = 0; x < kVec; ++x)
            acc_w[(warp * kG + g) * D + c * kVec + x] = acc[g][cc * kVec + x];
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) ml_w[warp * kG + g] = make_float2(m[g], l[g]);
  }
  __syncthreads();
  // the block's partial: each element merged over the warps by the usual
  // rescaling, relative to the block's max
  for (int e = tid; e < GB * D; e += kThreads) {
    const int g = e / D;
    float2 ml[kWarps];
    float M = kNegInf, L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ml[w] = ml_w[w * kG + g];
      M = fmaxf(M, ml[w].x);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ml[w].x - M);
      L = fmaf(wt, ml[w].y, L);
      o = fmaf(wt, acc_w[w * kG * D + e], o);
    }
    acc_s[e] = o;
    if (e == g * D) ml_s[g] = make_float2(M, L);
  }
  cluster.sync();

  // One round of reads from every block of the cluster: row g's (m, l) and
  // element e's acc; returns L and leaves the weights exp(m_r - M) in w.
  float w[kMaxSplits], av[kMaxSplits];
  auto gather = [&](int g, int e, bool has_e) -> float {
    float2 ml[kMaxSplits];
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < splits) {
        ml[rr] = *cluster.map_shared_rank(ml_s + g, rr);
        av[rr] = has_e ? *cluster.map_shared_rank(acc_s + e, rr) : 0.f;
        M = fmaxf(M, ml[rr].x);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kMaxSplits; ++rr) {
      if (rr < splits) {
        w[rr] = expf(ml[rr].x - M);
        L = fmaf(w[rr], ml[rr].y, L);
      }
    }
    return L;
  };
  // this block writes its share [e0, e1) of the block's GB*D outputs
  T* ob = static_cast<T*>(a.out) + ((long long)b * a.Hq + (long long)h * G + g0) * D;
  const int e0 = GB * D * r / splits, e1 = GB * D * (r + 1) / splits;
  const int e_first = e0 + tid;
  const bool mine = e_first < e1;
  // L is 0 only where no block saw a valid key, which holds for every row
  // alike, so every thread takes the same branch
  const float L0 = gather(mine ? e_first / D : 0, e_first, mine);
  if (L0 > 0.f) {
    for (int e = e_first; e < e1; e += kThreads) {
      const float L = e == e_first ? L0 : gather(e / D, e, true);
      float o = 0.f;
#pragma unroll
      for (int rr = 0; rr < kMaxSplits; ++rr)
        if (rr < splits) o = fmaf(w[rr], av[rr], o);
      ob[e] = from_float<T>(o / L);
    }
  } else {
    // no valid key in the row: the uniform average of V over all S slots,
    // each block summing the slots of its tiles (through the tables for
    // pages); what another block may still read of acc_s here is not used
    const int p1 = min(thi * kTileK, S);
    for (int d = tid; d < D; d += kThreads) {
      float sum = 0.f;
      for (int p = tlo * kTileK; p < p1; ++p) sum += to_float(vb[key_off(p) + d]);
      acc_s[d] = sum;
    }
    cluster.sync();
    for (int e = e_first; e < e1; e += kThreads) {
      float sum = 0.f;
      for (int rr = 0; rr < splits; ++rr) sum += *cluster.map_shared_rank(acc_s + e % D, rr);
      ob[e] = from_float<T>(sum / (float)S);
    }
  }
  // keep this block's shared memory alive until the cluster has read it
  cluster.sync();
}

// decode_attention: a name of its own, so that profiles tell it apart
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads) valid_decode_split_kernel(SplitArgs a) {
  split_body<T, false, kG>(a);
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(SplitArgs a) {
  split_body<T, true, kG>(a);
}

// query rows one block takes: the whole group for gpt2 (G 1) and Hymba (G 5),
// which also serves G 2-4; 8 rows otherwise, a group above 8 in blocks of 8
int rows_per_block(int G) { return G == 1 ? 1 : G <= 5 ? 5 : 8; }

size_t split_smem(size_t es, int D, int stages, int kG) {
  return (size_t)stages * 2 * kTileK * D * es +
         sizeof(float) * ((size_t)kG * D + (size_t)kWarps * kG * kWarpKeys +
                          (size_t)kWarps * kG * D + (size_t)2 * kWarps * kG + (size_t)kG * D +
                          (size_t)2 * kG) +
         sizeof(int) * kMaxStages;
}

struct SplitPlan {
  int splits, stages;
  size_t smem;
};

// SMs of the current device, read once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (counts[dev] <= 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 132;
  return counts[dev];
}

// The launch shape of the split body, from the capacity S alone.
SplitPlan plan_split(size_t es, int B, int S, int Hq, int Hkv, int D) {
  const int sms = sm_count();
  const int G = Hq / Hkv, kG = rows_per_block(G);
  const long long blocks = (long long)B * Hkv * ((G + kG - 1) / kG);
  const int nt = (S + kTileK - 1) / kTileK;
  // the fewest splits for which the blocks cover the SMs twice
  int splits = 1;
  while (splits < kMaxSplits && blocks * splits < 2LL * sms) ++splits;
  splits = splits < nt ? splits : nt;
  int stages = kMaxStages;
  while (stages > 1 && split_smem(es, D, stages, kG) > kMaxSmem) --stages;
  return {splits, stages, split_smem(es, D, stages, kG)};
}

template <typename T, bool kPaged, int kG>
cudaError_t launch_split_rows(const SplitArgs& a, const SplitPlan& p, int B,
                              cudaStream_t stream) {
  void (*kernel)(SplitArgs) =
      kPaged ? paged_decode_split_kernel<T, kG> : valid_decode_split_kernel<T, kG>;
  // once per kernel and device: allow the most shared memory a block may use
  static bool allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!allowed[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return e;
    allowed[dev & 63] = true;
  }
  const int G = a.Hq / a.Hkv;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.splits, (unsigned)(a.Hkv * ((G + kG - 1) / kG)), (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool kPaged>
cudaError_t launch_split(SplitArgs a, int B, cudaStream_t stream) {
  const SplitPlan p = plan_split(sizeof(T), B, a.S, a.Hq, a.Hkv, a.D);
  a.stages = p.stages;
  switch (rows_per_block(a.Hq / a.Hkv)) {
    case 1: return launch_split_rows<T, kPaged, 1>(a, p, B, stream);
    case 5: return launch_split_rows<T, kPaged, 5>(a, p, B, stream);
    default: return launch_split_rows<T, kPaged, 8>(a, p, B, stream);
  }
}

template <typename T>
cudaError_t launch_batched(const void* q, const void* k, const void* v, const int* lengths,
                           const int* win_starts, const float* slopes, void* out, int B,
                           int S, int Hq, int Hkv, int D, int num_meta, float scale,
                           cudaStream_t stream) {
  const size_t smem = batched_smem(Hq / Hkv, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  batched_decode_kernel<T><<<dim3((unsigned)Hkv, (unsigned)B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      win_starts, slopes, static_cast<T*>(out), S, Hq, Hkv, D, num_meta, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one batched_decode_attention block needs; the wrapper
// refuses shapes above the 227 KB a block may use.
extern "C" long long repro_batched_decode_smem(int Hq, int Hkv, int D) {
  return (long long)batched_smem(Hq / Hkv, D);
}

// The split body's launch shape for decode_attention (S the cache length) and
// paged_decode_attention (S = max_blocks * bs): writes the cluster size and
// the ring's stages, returns the shared memory (bytes) one block needs.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" long long repro_decode_split_plan(int dtype, int B, int S, int Hq, int Hkv, int D,
                                             int* splits, int* stages) {
  const SplitPlan p = plan_split(dtype == 0 ? 4 : 2, B, S, Hq, Hkv, D);
  *splits = p.splits;
  *stages = p.stages;
  return (long long)p.smem;
}

// dtype: 0 = float32, 1 = bfloat16.  q [B,Hq,D], k/v [B,S,Hkv,D], out [B,Hq,D]
// contiguous; lengths (and win_starts when non-null) device int32 [B], each
// length in [0, S] (a row at 0 gets the average of V over the S slots);
// slopes device float32 [Hq] or null.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_batched_decode_attention(int dtype, const void* q, const void* k,
                                              const void* v, const int* lengths,
                                              const int* win_starts, const float* slopes,
                                              void* out, int B, int S, int Hq, int Hkv,
                                              int D, int num_meta, float scale,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_batched<float>(q, k, v, lengths, win_starts, slopes, out, B, S, Hq, Hkv, D,
                                 num_meta, scale, s);
  if (dtype == 1)
    return launch_batched<__nv_bfloat16>(q, k, v, lengths, win_starts, slopes, out, B, S, Hq,
                                         Hkv, D, num_meta, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// decode_attention: dtype as above; q/out [B,Hq,D], k/v [B,S,Hkv,D]
// contiguous; valid a device bool [S] shared by every sequence (a row with
// no valid key gets the average of V over the S slots).  One cluster launch;
// shared memory as repro_decode_split_plan.  Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                      const bool* valid, void* out, int B, int S, int Hq,
                                      int Hkv, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SplitArgs a = {q, k, v, valid, nullptr, nullptr, out, 0, 1, 0, 0, S, Hq, Hkv, D, 1, scale};
  if (dtype == 0) return launch_split<float, false>(a, B, s);
  if (dtype == 1) return launch_split<__nv_bfloat16, false>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// paged_decode_attention: dtype as above; q/out [B,Hq,D] contiguous; k/v
// pages [N,bs,Hkv,D] whose (bs, Hkv, D) are dense and whose pages lie
// page_stride elements apart (the same for k and v); block_tables device
// int32 [B,max_blocks] contiguous, every entry a valid page id; lengths
// device int32 [B], each in [0, max_blocks * bs].  A row reads the entries
// of its first ceil(lengths[b] / bs) pages only; a row at length 0 reads
// every entry and gets the average of V over its max_blocks * bs slots.
// One cluster launch; shared memory as repro_decode_split_plan.  Returns
// the launch's error, or cudaGetLastError() after it.
extern "C" int repro_paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                            const void* v_pages, const int* block_tables,
                                            const int* lengths, void* out, int B,
                                            int max_blocks, int bs, long long page_stride,
                                            int Hq, int Hkv, int D, float scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  if ((1 << bs_log2) != bs) bs_log2 = -1;
  SplitArgs a = {q,       k_pages,    v_pages,         nullptr, lengths, block_tables,
                 out,     page_stride, bs,             bs_log2, max_blocks,
                 max_blocks * bs,      Hq,              Hkv,     D,       1,
                 scale};
  if (dtype == 0) return launch_split<float, true>(a, B, s);
  if (dtype == 1) return launch_split<__nv_bfloat16, true>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
