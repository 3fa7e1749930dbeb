// batched_decode_attention, decode_attention and paged_decode_attention —
// one-query decode attention on Hopper, in one kernel body.
//
// All three replace the TPU kernels of those names in
// src/repro/kernels/decode_attention.py and compute what they compute:
// online softmax with f32 m / l / acc, scale D^-0.5, the finite
// NEG_INF = -0.7 * FLT_MAX of the reference, query head h*G+g reading KV
// head h.  A row with no valid key gives the sum of V over its S slots
// divided by the caller's `no_key_div`, as the Pallas kernels do: their
// scores are all NEG_INF, so every slot of their walk weighs the same, and
// over a dense cache that walk pads S with zero rows to a multiple of
// min(512, S) (the wrappers pass the padded length; pages are not padded).
//
// What bounds them on the H100: bytes.  Each K/V element is read once and
// used for 2*G flops (one multiply-add per query head of its group), that
// is G flops per byte in bf16, with G <= 5 on every live path (gpt2 1,
// Hymba 5).  The bf16 tensor cores need 295 flops per byte before they, and
// not the memory, set the pace, and even the CUDA cores' f32 rate (67
// TFLOP/s, 20 flops per byte at 3.35 TB/s) is four times what G = 5 asks.
// So no tensor core: the least time is the visible K/V bytes over
// 3.35 TB/s, and the design is about keeping enough bytes in flight.
//
// One split body, in three modes of finding its keys: a validity vector [S]
// shared by the batch (decode_attention: the run() path's microbatch decode
// and Hymba's ring), K/V pages [N,bs,Hkv,D] read through block tables to
// lengths[b] (paged_decode_attention: the fused decode pass of
// run_continuous), and a dense cache [B,S,Hkv,D] masked per sequence to
// lengths[b] with optional window starts, meta sinks and ALiBi slopes
// (batched_decode_attention: the gather route of stages with a windowed or
// ALiBi layer).
//   * Split-K across a thread-block cluster.  One (KV head, sequence) holds
//     far too few bytes for one block to keep the memory busy, and B*Hkv
//     blocks leave the 132 SMs short (100 at mb_serve's decode, 20 at
//     Hymba's).  A cluster of `splits` blocks (at most 8, the portable size)
//     shares the key range in whole 64-key tiles: the fewest splits for
//     which the blocks cover the SMs twice, chosen on the host from S alone
//     (no read of lengths).  The validity and paged modes cut the capacity's
//     tiles into equal ranges; the ragged mode cuts the sequence's live
//     tiles (its meta tiles, then the tiles from its window start to its
//     length), which each block forms from two int loads, so that a short
//     window or length still spreads over the cluster.  A block with no key
//     to read contributes (m = NEG_INF, l = 0, acc = 0).
//   * The combine stays on chip, in one launch with no workspace: each warp
//     keeps its own online softmax, the warps merge in shared memory, and
//     after cluster.sync() each block reads every block's (m, l) and its
//     share of acc[G,D] through map_shared_rank in one round of loads,
//     rescales, and writes q's dtype.  Asked for it, decode_attention also
//     writes each row's log-sum-exp M + log L (f32) from the same reads, so
//     that partials over slices of one cache combine; a row with no valid
//     key gets NEG_INF there, which weighs 0 in such a combine.
//   * Tiles stay in their stored type in a ring of up to 3 stages filled by
//     16-byte cp.async, so the next tiles' loads are in flight while this one
//     is scored.  Fewer stages where only that keeps every cluster of the
//     launch resident at once (the runtime's occupancy count): phi-3-vision's
//     D = 96 cache is 128 clusters of 3 blocks, which 76 KB blocks (3
//     stages) leave in two waves and 51 KB blocks (2) run in one.  Paged
//     keys take their page from block_tables[b, p / bs]; only keys below
//     the length are read.  For a validity vector one load
//     of 64 flags a lane marks which of 32 tiles hold a valid key; a tile
//     with none is neither loaded nor scored.  The ragged mode masks per slot
//     only on a tile that holds the window start; its ALiBi slopes sit in
//     registers and bias the f32 score before the mask, as the reference.
//   * Scores: two lanes split each key's row (one shuffle), Q in shared
//     memory as f32, K rows stored with their 16-byte chunks swizzled so the
//     two lanes of 4 keys hit distinct banks (k_swizzle: an XOR inside
//     aligned groups of chunks, so it works for rows of 12 or 24 chunks
//     too); no serial D loop.  P.V: lanes own (key group, 16-byte chunks)
//     accumulators for every query row of the block, folded across key
//     groups once at the end.  A power of two of lanes shares a row
//     (lane_plan), each taking up to 3 chunks where that leaves fewer lanes
//     idle than one chunk a lane: D = 96 in bf16 is 12 chunks, 4 lanes of 3
//     (16 lanes of one left 4 of them idle in every load and P.V pass, and
//     a warp took 2 keys a pass instead of 8); D = 192 is 24 chunks, 8 lanes
//     of 3.  Rows of a power of two of chunks keep one chunk a lane (two for
//     f32 rows past 128).  A block takes all G rows of its group (instances
//     for 1, 5 and 8 rows; G above 8 in blocks of 8 rows), and for the wider
//     lane plans a bf16 instance that holds 3 chunks a lane (none at 8 rows,
//     whose accumulators would spill: there D = 192 keeps 32 lanes of one
//     chunk, 8 of them idle; none for the f32 parity body).
// At the live shapes each block walks 1-8 tiles, so the fixed costs (the
// first loads, the two cluster barriers, the combine) weigh as much as the
// streaming; chip_smoke.py's kernels phase times every mode.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// the split body: split-K over a cluster
// ---------------------------------------------------------------------------

// How the split body finds its keys: a validity vector shared by the batch
// (decode_attention), pages through block tables to a length
// (paged_decode_attention), a dense cache to a length with an optional
// window, meta sinks and ALiBi (batched_decode_attention).
enum class Mode { kValid, kPaged, kRagged };

struct SplitArgs {
  const void* q;           // [B, Hq, D]
  const void* k;           // dense [B, S, Hkv, D], or pages [N, bs, Hkv, D]
  const void* v;
  const bool* valid;       // kValid: [S]
  const int* lengths;      // kPaged, kRagged: [B]
  const int* tables;       // kPaged: [B, max_blocks]
  const int* win_starts;   // kRagged: [B] or null
  const float* slopes;     // kRagged: [Hq] or null
  void* out;               // [B, Hq, D]
  float* lse;              // kValid: [B, Hq] f32, each row's log-sum-exp, or null
  long long page_stride;   // kPaged: elements between pages
  int bs, bs_log2;         // kPaged: page size, and its log2 (-1 if not a power of 2)
  int max_blocks;          // kPaged
  int S, Hq, Hkv, D;       // S: the dense length, or max_blocks * bs
  int num_meta;            // kRagged: slots below it stay visible outside the window
  int no_key_div;          // a row with no valid key: sum of V over S slots / this
  int stages;              // ring stages, 1..kMaxStages
  float scale;
};

constexpr int kWarpKeys = kTileK / kWarps;   // the keys of a tile one warp scores

// waits until at most `pending` (0 or 1) committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
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

// How a key row's nchunk 16-byte chunks map to lanes in the loads and P.V:
// 2^lpk_log2 lanes share a row (a power of two, so that a warp takes whole
// rows), each taking cpl chunks c = lane + i * 2^lpk_log2.  The plan with the
// fewest idle lanes among those of at most max_cpl chunks a lane, then the
// fewest chunks a lane.  For a power of two that is one chunk a lane (two
// for f32 rows past 128); D = 96 in bf16 (12 chunks) takes 4 lanes of 3
// chunks, where 16 lanes of one chunk would leave 4 idle.
struct LanePlan {
  int lpk_log2, cpl;
};
__host__ __device__ inline LanePlan lane_plan(int nchunk, int max_cpl) {
  LanePlan best = {5, (nchunk + 31) / 32};
  int idle = 32 * best.cpl - nchunk;
  for (int l2 = 4; l2 >= 0; --l2) {
    const int lpk = 1 << l2, cpl = (nchunk + lpk - 1) / lpk;
    if (cpl <= max_cpl && lpk * cpl - nchunk < idle) {
      best = {l2, cpl};
      idle = lpk * cpl - nchunk;
    }
  }
  return best;
}

// K rows are stored with chunk c of key j at c ^ ((j >> shift) & mask), so
// that the scores' two lanes of each of the 4 keys of a quarter-warp (chunk
// i of the row's first half, chunk i of its second) read distinct banks:
// XOR by j's low bits where the row spans a multiple of 8 chunks (or a power
// of two below), by bit 1 of j where it spans 4 past a multiple of 8 (D = 96
// in bf16: the 4 keys' rows start on 64-byte offsets 0, 64, 0, 64); none
// otherwise.  The XOR stays inside an aligned group of mask + 1 chunks, so
// inside the row.
struct Swizzle {
  int shift, mask;
};
__device__ __forceinline__ Swizzle k_swizzle(int nchunk) {
  if ((nchunk & (nchunk - 1)) == 0 || nchunk % 8 == 0) return {0, min(nchunk, 8) - 1};
  if (nchunk % 8 == 4) return {1, 1};
  return {0, 0};
}

// Chunks a lane holds in P.V: one 16-byte chunk for bf16 and two for f32
// (rows up to 256), or, in bf16, kWideCpl where a plan with more chunks a
// lane leaves fewer lanes idle (lane_plan).  bf16 with 8 query rows a block
// has no wide instance (8 rows x 3 chunks x 8 floats of accumulators would
// spill), nor has f32, the parity body, whose instances would only lengthen
// the build.
template <typename T>
constexpr int kBaseCpl = sizeof(T) == 4 ? 2 : 1;
constexpr int kWideCpl = 3;
template <typename T>
constexpr bool has_wide(int kG) { return sizeof(T) == 2 && kG != 8; }

// The split body: one block of a cluster of `splits` walks its share of the
// whole 64-key tiles of one (KV head, sequence) for query rows g0 .. g0+kG-1
// of the head's group.  Each warp keeps its own online softmax over its 16
// keys of every tile: two lanes score a key (half of its row each, one
// shuffle), and for P.V 2^lpk_log2 lanes share a key's V row, up to kCpl
// 16-byte chunks each (lane_plan).  The warps merge in shared memory, then
// the blocks of the cluster through distributed shared memory.
template <typename T, Mode kMode, int kG, int kCpl>
__device__ __forceinline__ void split_body(const SplitArgs& a) {
  constexpr bool kPaged = kMode == Mode::kPaged;
  constexpr bool kRagged = kMode == Mode::kRagged;
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
  const int nchunk = D / kVec;                     // 16-byte chunks in a key row
  const int lpk_log2 = lane_plan(nchunk, kCpl).lpk_log2;
  const int lpk = 1 << lpk_log2;                   // lanes per key row in loads and P.V
  const int kpp = 32 >> lpk_log2;                  // keys of a warp per P.V pass
  const int passes = (kWarpKeys + kpp - 1) / kpp;
  const int lk = lane & (lpk - 1), kg = lane >> lpk_log2;
  const Swizzle swz = k_swizzle(nchunk);
  auto k_at = [=](int j, int c) {                  // where K chunk c of key j is stored
    return c ^ ((j >> swz.shift) & swz.mask);
  };
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

  // keys below kend are read; the capacity has nt tiles
  const int nt = (S + kTileK - 1) / kTileK;
  const int kend = kMode == Mode::kValid ? S : max(0, min(a.lengths[b], S));
  // The tiles this sequence needs, n_live of them: the capacity's, or for
  // kRagged the meta tiles [0, mt) then the window's tiles [wt, ceil(kend/64))
  // past them.  This block takes the indices [ilo, ihi) of them; index i is
  // tile tile_at(i).
  int ws = 0, mt = 0, wt = 0, n_live = nt;
  if constexpr (kRagged) {
    ws = a.win_starts ? max(a.win_starts[b], 0) : 0;
    mt = (min(a.num_meta, kend) + kTileK - 1) / kTileK;
    wt = max(ws / kTileK, mt);
    n_live = mt + max(0, (kend + kTileK - 1) / kTileK - wt);
  }
  const int ilo = n_live * r / splits, ihi = n_live * (r + 1) / splits;
  auto tile_at = [=](int i) { return kRagged && i >= mt ? wt + i - mt : i; };

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
  int mask_base = ihi;
  auto load_mask = [&](int t) {
    mask_base = t;
    const int p0 = (t + lane) * kTileK;
    bool any = false;
    if (t + lane < ihi) {
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
  // The first index at or after i whose tile holds a key this block reads,
  // ihi if none.  Every warp computes the same answer, so it is block-uniform.
  auto next_tile = [&](int i) -> int {
    if constexpr (kPaged) {
      return (i < ihi && i * kTileK < kend) ? i : ihi;
    } else if constexpr (kRagged) {
      return i < ihi ? i : ihi;    // every live tile holds keys below kend
    } else {
      while (i < ihi) {
        if (i < mask_base || i >= mask_base + 32) load_mask(i);
        const unsigned bits = live_mask >> (i - mask_base);
        if (bits) return i + __ffs(bits) - 1;
        i = mask_base + 32;
      }
      return ihi;
    }
  };
  // Loads the tile of index i into ring slot `slot` (16-byte cp.async, keys
  // below kend; lpk threads a row) and records i there; ihi records that
  // none follows.
  auto issue = [&](int i, int slot) {
    if (tid == 0) tile_s[slot] = i;
    if (i >= ihi) return;
    T* ks = ring + (size_t)slot * 2 * kTileK * D;
    T* vs = ks + kTileK * D;
    const int t0 = tile_at(i) * kTileK, n = min(kTileK, kend - t0);
#pragma unroll 4
    for (int j = tid >> lpk_log2; j < n; j += kThreads >> lpk_log2) {
      const long long off = key_off(t0 + j);
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = lk + cc * lpk;
        if (c < nchunk) {
          cp_async16(ks + j * D + k_at(j, c) * kVec, kb + off + c * kVec);
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
  int iss = next_tile(ilo);
  for (int s = 0; s < a.stages - 1; ++s) {
    issue(iss, s);
    if (iss < ihi) iss = next_tile(iss + 1);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (tid + i * kThreads < qn) unpack<T>(qv[i], q_s + (tid + i * kThreads) * kVec);
  for (int i = GB * D + tid; i < kG * D; i += kThreads) q_s[i] = 0.f;
  float acc[kG][kCpl * kVec], m[kG], l[kG], sl[kG];
  const bool alibi = kRagged && a.slopes != nullptr;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    sl[g] = alibi && g < GB ? a.slopes[h * G + g0 + g] : 0.f;
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
    if (iss < ihi) iss = next_tile(iss + 1);
    cp_async_commit();
    if (a.stages == 1) {
      cp_async_wait(0);
      __syncthreads();
    }
    const int use = tile_s[slot];
    if (use >= ihi) break;
    const T* ks = ring + (size_t)slot * 2 * kTileK * D;
    const T* vs = ks + kTileK * D;
    const int t0 = tile_at(use) * kTileK, n = min(kTileK, kend - t0);

    // the score of key kl on lanes 2kl and 2kl+1, NEG_INF where masked or
    // past the tile; a ragged key below the window start is masked unless it
    // is a meta sink, which only a tile below ws and past num_meta can hold
    const int j = warp * kWarpKeys + kl;
    const int pos = t0 + j;
    const bool live = j < n;
    bool ok = live;
    if constexpr (kMode == Mode::kValid) ok = live && valid[pos];
    if constexpr (kRagged) {
      if (t0 < ws && t0 + kTileK > a.num_meta) ok = live && (pos >= ws || pos < a.num_meta);
    }
    // ALiBi: the query sits at kend - 1
    const float dist = (float)max(kend - 1 - pos, 0);
    float sc[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) sc[g] = 0.f;
    if (live) {
      const int c1 = min(nchunk, (hf + 1) * half);
#pragma unroll 4
      for (int c = hf * half; c < c1; ++c) {
        float kf[kVec];
        load_chunk(ks + j * D + k_at(j, c) * kVec, kf);
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
      const float s = ok ? (alibi ? dot * a.scale - sl[g] * dist : dot * a.scale) : kNegInf;
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
  float M = kNegInf;   // the row's max over the blocks, left by gather
  auto gather = [&](int g, int e, bool has_e) -> float {
    float2 ml[kMaxSplits];
    float L = 0.f;
    M = kNegInf;
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
  // the rows' log-sum-exps, written by the thread that holds a row's first element
  float* lse_b = a.lse ? a.lse + (long long)b * a.Hq + (long long)h * G + g0 : nullptr;
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
      if (lse_b && e % D == 0) lse_b[e / D] = M + logf(L);
    }
  } else {
    // no valid key in the row: the sum of V over all S slots over
    // no_key_div, each block summing the slots of its share of the
    // capacity's tiles (through the tables for pages); what another block
    // may still read of acc_s here is not used
    const int p0 = nt * r / splits * kTileK, p1 = min(nt * (r + 1) / splits * kTileK, S);
    for (int d = tid; d < D; d += kThreads) {
      float sum = 0.f;
      for (int p = p0; p < p1; ++p) sum += to_float(vb[key_off(p) + d]);
      acc_s[d] = sum;
    }
    cluster.sync();
    for (int e = e_first; e < e1; e += kThreads) {
      float sum = 0.f;
      for (int rr = 0; rr < splits; ++rr) sum += *cluster.map_shared_rank(acc_s + e % D, rr);
      ob[e] = from_float<T>(sum / (float)a.no_key_div);
      if (lse_b && e % D == 0) lse_b[e / D] = kNegInf;
    }
  }
  // keep this block's shared memory alive until the cluster has read it
  cluster.sync();
}

// one name for each mode, so that profiles tell them apart
template <typename T, int kG, int kCpl>
__global__ void __launch_bounds__(kThreads) valid_decode_split_kernel(SplitArgs a) {
  split_body<T, Mode::kValid, kG, kCpl>(a);
}

template <typename T, int kG, int kCpl>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(SplitArgs a) {
  split_body<T, Mode::kPaged, kG, kCpl>(a);
}

template <typename T, int kG, int kCpl>
__global__ void __launch_bounds__(kThreads) batched_decode_split_kernel(SplitArgs a) {
  split_body<T, Mode::kRagged, kG, kCpl>(a);
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

// The launch shape of the split body, from the capacity S and the shapes
// alone (no read of lengths or validity).  `kernel` is the valid-mode
// instance of the call's rows and lane plan: its occupancy stands for the
// three modes', so that one plan serves the launch and repro_decode_split_plan.
SplitPlan plan_split(size_t es, int B, int S, int Hq, int Hkv, int D, int kG,
                     const void* kernel) {
  const int sms = sm_count();
  const int G = Hq / Hkv;
  const long long clusters = (long long)B * Hkv * ((G + kG - 1) / kG);
  const int nt = (S + kTileK - 1) / kTileK;
  // the fewest splits for which the blocks cover the SMs twice
  int splits = 1;
  while (splits < kMaxSplits && clusters * splits < 2LL * sms) ++splits;
  splits = splits < nt ? splits : nt;
  // the most ring stages that fit a block, unless fewer let every cluster
  // of the launch be resident at once where the most do not (phi-3-vision's
  // D = 96 cache: 128 clusters of 3 blocks of 76 KB at 3 stages, of 51 KB at 2)
  int fit = kMaxStages;
  while (fit > 1 && split_smem(es, D, fit, kG) > kMaxSmem) --fit;
  auto resident = [&](int st) {
    return resident_clusters(kernel, kThreads, splits, split_smem(es, D, st, kG)) >= clusters;
  };
  int stages = fit;
  while (stages > 1 && !resident(stages)) --stages;
  if (!resident(stages)) stages = fit;
  return {splits, stages, split_smem(es, D, stages, kG)};
}

template <typename T, Mode kMode, int kG, int kCpl>
cudaError_t launch_split_kernel(const SplitArgs& a, const SplitPlan& p, int B,
                                cudaStream_t stream) {
  void (*kernel)(SplitArgs) = valid_decode_split_kernel<T, kG, kCpl>;
  if constexpr (kMode == Mode::kPaged) kernel = paged_decode_split_kernel<T, kG, kCpl>;
  if constexpr (kMode == Mode::kRagged) kernel = batched_decode_split_kernel<T, kG, kCpl>;
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

// Chunks a lane holds for these rows and head dim: the wide instance's where
// its lane plan takes more chunks a lane than the base one can hold.
template <typename T, int kG>
int cpl_for(int D) {
  if constexpr (has_wide<T>(kG)) {
    if (lane_plan(D / (16 / (int)sizeof(T)), kWideCpl).cpl > kBaseCpl<T>) return kWideCpl;
  }
  return kBaseCpl<T>;
}

template <typename T, int kG>
SplitPlan plan_rows(int B, int S, int Hq, int Hkv, int D) {
  const void* kernel = (const void*)valid_decode_split_kernel<T, kG, kBaseCpl<T>>;
  if constexpr (has_wide<T>(kG)) {
    if (cpl_for<T, kG>(D) == kWideCpl)
      kernel = (const void*)valid_decode_split_kernel<T, kG, kWideCpl>;
  }
  return plan_split(sizeof(T), B, S, Hq, Hkv, D, kG, kernel);
}

template <typename T, Mode kMode, int kG>
cudaError_t launch_split_rows(SplitArgs a, int B, cudaStream_t stream) {
  const SplitPlan p = plan_rows<T, kG>(B, a.S, a.Hq, a.Hkv, a.D);
  a.stages = p.stages;
  if constexpr (has_wide<T>(kG)) {
    if (cpl_for<T, kG>(a.D) == kWideCpl)
      return launch_split_kernel<T, kMode, kG, kWideCpl>(a, p, B, stream);
  }
  return launch_split_kernel<T, kMode, kG, kBaseCpl<T>>(a, p, B, stream);
}

template <typename T, Mode kMode>
cudaError_t launch_split(const SplitArgs& a, int B, cudaStream_t stream) {
  switch (rows_per_block(a.Hq / a.Hkv)) {
    case 1: return launch_split_rows<T, kMode, 1>(a, B, stream);
    case 5: return launch_split_rows<T, kMode, 5>(a, B, stream);
    default: return launch_split_rows<T, kMode, 8>(a, B, stream);
  }
}

template <typename T>
SplitPlan plan_dtype(int B, int S, int Hq, int Hkv, int D) {
  switch (rows_per_block(Hq / Hkv)) {
    case 1: return plan_rows<T, 1>(B, S, Hq, Hkv, D);
    case 5: return plan_rows<T, 5>(B, S, Hq, Hkv, D);
    default: return plan_rows<T, 8>(B, S, Hq, Hkv, D);
  }
}

template <Mode kMode>
int launch_dtype(int dtype, const SplitArgs& a, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_split<float, kMode>(a, B, s);
  if (dtype == 1) return launch_split<__nv_bfloat16, kMode>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The split body's launch shape for decode_attention (S the cache length) and
// paged_decode_attention (S = max_blocks * bs): writes the cluster size and
// the ring's stages, returns the shared memory (bytes) one block needs.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" long long repro_decode_split_plan(int dtype, int B, int S, int Hq, int Hkv, int D,
                                             int* splits, int* stages) {
  const SplitPlan p = dtype == 0 ? plan_dtype<float>(B, S, Hq, Hkv, D)
                                 : plan_dtype<__nv_bfloat16>(B, S, Hq, Hkv, D);
  *splits = p.splits;
  *stages = p.stages;
  return (long long)p.smem;
}

// batched_decode_attention: dtype 0 = float32, 1 = bfloat16.  q [B,Hq,D],
// k/v [B,S,Hkv,D], out [B,Hq,D] contiguous; lengths (and win_starts when
// non-null) device int32 [B], each length in [0, S]; slot p of sequence b is
// valid iff p < lengths[b] and (p >= win_starts[b] or p < num_meta); slopes
// device float32 [Hq] or null (bias -slope * max(lengths[b] - 1 - p, 0)
// before the mask).  A row with no valid key gets the sum of V over its S
// slots divided by no_key_div.  One cluster launch; shared memory as
// repro_decode_split_plan.  Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int repro_batched_decode_attention(int dtype, const void* q, const void* k,
                                              const void* v, const int* lengths,
                                              const int* win_starts, const float* slopes,
                                              void* out, int B, int S, int Hq, int Hkv,
                                              int D, int num_meta, float scale, int no_key_div,
                                              void* stream) {
  SplitArgs a = {};
  a.q = q, a.k = k, a.v = v, a.lengths = lengths, a.win_starts = win_starts;
  a.slopes = slopes, a.out = out, a.S = S, a.Hq = Hq, a.Hkv = Hkv, a.D = D;
  a.num_meta = num_meta, a.no_key_div = no_key_div, a.scale = scale;
  return launch_dtype<Mode::kRagged>(dtype, a, B, stream);
}

// decode_attention: dtype as above; q/out [B,Hq,D], k/v [B,S,Hkv,D]
// contiguous; valid a device bool [S] shared by every sequence (a row with
// no valid key gets the sum of V over the S slots divided by no_key_div);
// lse a device f32 [B,Hq] for each row's log-sum-exp of its scaled scores
// over its valid keys (NEG_INF where it has none), or null for none.
// One cluster launch; shared memory as repro_decode_split_plan.  Returns the
// launch's error, or cudaGetLastError() after it.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                      const bool* valid, void* out, float* lse, int B, int S,
                                      int Hq, int Hkv, int D, float scale, int no_key_div,
                                      void* stream) {
  SplitArgs a = {};
  a.q = q, a.k = k, a.v = v, a.valid = valid, a.out = out, a.lse = lse;
  a.S = S, a.Hq = Hq, a.Hkv = Hkv, a.D = D, a.no_key_div = no_key_div, a.scale = scale;
  return launch_dtype<Mode::kValid>(dtype, a, B, stream);
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
  int bs_log2 = 0;
  while ((1 << bs_log2) < bs) ++bs_log2;
  if ((1 << bs_log2) != bs) bs_log2 = -1;
  SplitArgs a = {};
  a.q = q, a.k = k_pages, a.v = v_pages, a.lengths = lengths, a.tables = block_tables;
  a.out = out, a.page_stride = page_stride, a.bs = bs, a.bs_log2 = bs_log2;
  a.max_blocks = max_blocks, a.S = max_blocks * bs, a.Hq = Hq, a.Hkv = Hkv, a.D = D;
  a.no_key_div = max_blocks * bs, a.scale = scale;
  return launch_dtype<Mode::kPaged>(dtype, a, B, stream);
}
