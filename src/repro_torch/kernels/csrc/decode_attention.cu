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
// is G flops per byte in bf16, far below the 295 flops per byte past which
// the bf16 tensor cores, and not the memory, set the pace: the least time is
// the visible K/V bytes over 3.35 TB/s, and the design is about keeping
// enough bytes in flight.  Small groups (gpt2, phi-3-vision and seamless G
// 1, internlm2 2, Hymba and smollm 5) score on the CUDA cores, whose f32
// rate (67 TFLOP/s, 20 flops per byte) is four times what G = 5 asks.
// Larger ones do not leave the warps that room: at nemotron-4-340b's G = 12
// and D = 192 one warp's 16 keys of a tile take 36,864 multiply-adds for
// Q.K^T alone, 1,152 FMAs a lane, each with a shared-memory read of Q, where
// 24 mma.sync m16n8k16 do them.  So bf16 groups of 6 or more (yi-34b 7,
// qwen3-moe-30b-a3b 8, nemotron 12) run on the tensor cores, the whole group
// one M = 16 tile, which reads each (KV head, sequence)'s K/V once and frees
// the warps to keep bytes in flight.  f32, the parity body held at 2e-5,
// stays on the CUDA cores.
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
//     for 1 and 5 rows, and in f32 8 rows, G above 8 in blocks of 8), and
//     for the wider lane plans a bf16 instance that holds 3 chunks a lane
//     (none for the f32 parity body).
//   * bf16 groups of 6 or more: the tensor-core instance
//     (*_decode_mma_kernel<kDP>, kDP the head dim padded to 64, 128, 192 or
//     256), 16 query rows a block (a group above 16 in blocks of 16), the
//     rows the M tile of mma.sync m16n8k16.  Q sits in registers as bf16 A
//     fragments; each warp takes 16 keys of a tile, S = Q.K^T with K's B
//     fragments by ldmatrix from ring rows padded to round16(D) + 8 elements
//     (zeros past D for the last k16 step, rows an odd multiple of 16 bytes
//     apart for ldmatrix's banks); the masks, the ALiBi bias and the online
//     softmax act on the f32 accumulator fragment (each row's max and sum over
//     the fragment's 4 lanes); P in bf16 registers is the A fragment of
//     O += P.V, V's B fragments by ldmatrix.trans, O an f32 fragment of D / 2
//     registers a thread.  The warps merge as above, their partials in the
//     ring, which is idle by then.  A partial last tile's V rows past the
//     keys are zero-filled: the tensor cores multiply all 64.  Its launch
//     shape (plan_mma): two ring stages, and of the cluster sizes whose
//     clusters are all resident at once, the one that gives a block the
//     fewest tiles, the smallest such: nemotron's [2,544,96:8,192] takes 16
//     clusters of 5 blocks, yi-34b's [8,2048,56:8,128] 64 clusters of 3.
//     A sweep of sizes and stages on an H100 found the CUDA-core rule
//     (the fewest splits that cover the SMs twice, then the most stages
//     that keep the launch resident) slower at both: 8 blocks of 2 stages
//     and 5 of one stage.
// At the live shapes each block walks 1-8 tiles, so the fixed costs (the
// first loads, the two cluster barriers, the combine) weigh as much as the
// streaming; chip_smoke.py's kernels phase times every mode.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"
#include "ssd_mma.cuh"

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
// lane leaves fewer lanes idle (lane_plan).  f32, the parity body, has no
// wide instance: its instances would only lengthen the build.
template <typename T>
constexpr int kBaseCpl = sizeof(T) == 4 ? 2 : 1;
constexpr int kWideCpl = 3;
template <typename T>
constexpr bool has_wide() { return sizeof(T) == 2; }

// The tensor-core instance: bf16 groups of kMmaMinG query rows or more, in
// blocks of kMmaRows, the M tile of mma.sync m16n8k16.  Its head dim is
// padded to kDP (64, 128, 192 or 256) for the register arrays, and its ring
// rows to mma_pitch(D) elements: round16(D), so that Q.K^T's k16 steps read
// zeros past D, plus 8, so that rows an odd multiple of 16 bytes apart put
// ldmatrix's 8 row reads on 8 distinct bank groups.
constexpr int kMmaRows = 16;
constexpr int kMmaMinG = 6;
__host__ __device__ inline int mma_pitch(int D) { return (D + 15) / 16 * 16 + 8; }
__host__ __device__ inline int mma_dp(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256;
}

// The split body: one block of a cluster of `splits` walks its share of the
// whole 64-key tiles of one (KV head, sequence) for query rows g0 .. g0+kG-1
// of the head's group.  Each warp keeps its own online softmax over its 16
// keys of every tile.  On the CUDA cores (kDP = 0): two lanes score a key
// (half of its row each, one shuffle), and for P.V 2^lpk_log2 lanes share a
// key's V row, up to kCpl 16-byte chunks each (lane_plan).  On the tensor
// cores (kDP > 0: bf16, kMmaRows rows, the head dim padded to kDP): the rows
// are the M tile of mma.sync m16n8k16 (rows past the group zero, never
// stored), Q in registers as A fragments, S = Q.K^T over the warp's 16 keys
// with K's B fragments by ldmatrix, the softmax on the f32 accumulator
// fragment, and O += P.V with P in bf16 registers and V by ldmatrix.trans,
// O an f32 fragment (kDP / 2 registers a thread).  The warps merge in shared
// memory, then the blocks of the cluster through distributed shared memory.
template <typename T, Mode kMode, int kG, int kCpl, int kDP = 0>
__device__ __forceinline__ void split_body(const SplitArgs& a) {
  constexpr bool kPaged = kMode == Mode::kPaged;
  constexpr bool kRagged = kMode == Mode::kRagged;
  constexpr bool kMma = kDP > 0;
  static_assert(!kMma || (sizeof(T) == 2 && kG == kMmaRows), "the tensor-core instance");
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
  const Swizzle swz = kMma ? Swizzle{0, 0} : k_swizzle(nchunk);
  auto k_at = [=](int j, int c) {                  // where K chunk c of key j is stored
    return c ^ ((j >> swz.shift) & swz.mask);
  };
  const int half = (nchunk + 1) >> 1;              // chunks a scoring lane takes
  const int pitch = kMma ? mma_pitch(D) : D;       // elements between a tile's key rows

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);        // [stages][K, V][kTileK][pitch]
  unsigned char* past_ring = smem_raw + (size_t)a.stages * 2 * kTileK * pitch * sizeof(T);
  float* q_s = reinterpret_cast<float*>(past_ring);   // [kG][D]; none on the tensor cores
  float* p_w = q_s + (kMma ? 0 : kG * D);             // [kWarps][kG][16]; none there either
  // [kWarps][kG][D]: the warps' partials; on the tensor cores in the ring,
  // which no warp reads once the walk is done
  float* acc_w = kMma ? reinterpret_cast<float*>(smem_raw) : p_w + kWarps * kG * kWarpKeys;
  float2* ml_w = reinterpret_cast<float2*>(acc_w + kWarps * kG * D);   // [kWarps][kG]: m, l
  float* acc_s = kMma ? reinterpret_cast<float*>(past_ring)             // [kG][D]: the block's
                      : reinterpret_cast<float*>(ml_w + kWarps * kG);   // partial
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
  // none follows.  The tensor cores multiply all 64 rows of V, so there the
  // rows past kend are filled with zeros: a stale or never-written row may
  // hold a NaN, which even a probability of 0 would carry into O.
  auto issue = [&](int i, int slot) {
    if (tid == 0) tile_s[slot] = i;
    if (i >= ihi) return;
    T* ks = ring + (size_t)slot * 2 * kTileK * pitch;
    T* vs = ks + kTileK * pitch;
    const int t0 = tile_at(i) * kTileK, n = min(kTileK, kend - t0);
#pragma unroll 4
    for (int j = tid >> lpk_log2; j < n; j += kThreads >> lpk_log2) {
      const long long off = key_off(t0 + j);
#pragma unroll
      for (int cc = 0; cc < kCpl; ++cc) {
        const int c = lk + cc * lpk;
        if (c < nchunk) {
          cp_async16(ks + j * pitch + k_at(j, c) * kVec, kb + off + c * kVec);
          cp_async16(vs + j * pitch + c * kVec, vb + off + c * kVec);
        }
      }
    }
    if constexpr (kMma) {
      for (int j = n + (tid >> lpk_log2); j < kTileK; j += kThreads >> lpk_log2) {
#pragma unroll
        for (int cc = 0; cc < kCpl; ++cc) {
          const int c = lk + cc * lpk;
          if (c < nchunk) cp_async16_zfill(vs + j * pitch + c * kVec, vb, 0);
        }
      }
    }
  };

  // the block's query rows go out first, then the ring's first tiles; on the
  // CUDA cores the rows reach shared memory in f32 (rows past the group
  // zero), published by the loop's first barrier
  constexpr int kQ = 8 * 256 / kVec / kThreads;   // 16-byte chunks of q a thread loads
  const T* q_rows =
      static_cast<const T*>(a.q) + ((long long)b * a.Hq + (long long)h * G + g0) * D;
  const uint4* qb = reinterpret_cast<const uint4*>(q_rows);
  const int qn = GB * D / kVec;
  uint4 qv[kMma ? 1 : kQ];
  if constexpr (!kMma) {
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      if (tid + i * kThreads < qn) qv[i] = qb[tid + i * kThreads];
  }
  int iss = next_tile(ilo);
  for (int s = 0; s < a.stages - 1; ++s) {
    issue(iss, s);
    if (iss < ihi) iss = next_tile(iss + 1);
    cp_async_commit();
  }
  // CUDA cores: acc[g][.] this lane's chunks of row g; tensor cores: the A
  // fragments of Q (qa[kk], columns 16 kk ..) and the O fragment (o[i],
  // columns 8 i ..), rows lane / 4 and lane / 4 + 8, whose m, l and slopes
  // are m[0..1], l[0..1], sl[0..1]
  constexpr int kRowsHeld = kMma ? 2 : kG;
  float acc[kMma ? 1 : kG][kMma ? 1 : kCpl * kVec], m[kRowsHeld], l[kRowsHeld], sl[kRowsHeld];
  uint32_t qa[kMma ? kDP / 16 : 1][4];
  float o[kMma ? kDP / 8 : 1][4];
  const bool alibi = kRagged && a.slopes != nullptr;
  const int fr = lane >> 2, fc = 2 * (lane & 3);   // a fragment's row and column
  if constexpr (kMma) {
    // K's columns [D, round16(D)) are never loaded: zeros, once
    if (D % 16)
      for (int j = tid; j < a.stages * 2 * kTileK; j += kThreads)
        *reinterpret_cast<uint4*>(ring + (size_t)j * pitch + D) = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = fr + 8 * (i & 1), col = 16 * kk + fc + 8 * (i >> 1);
        qa[kk][i] = g < GB && col < D
                        ? *reinterpret_cast<const uint32_t*>(q_rows + (long long)g * D + col)
                        : 0u;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int g = fr + 8 * rr;
      sl[rr] = alibi && g < GB ? a.slopes[h * G + g0 + g] : 0.f;
      m[rr] = kNegInf;
      l[rr] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kDP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      if (tid + i * kThreads < qn) unpack<T>(qv[i], q_s + (tid + i * kThreads) * kVec);
    for (int i = GB * D + tid; i < kG * D; i += kThreads) q_s[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      sl[g] = alibi && g < GB ? a.slopes[h * G + g0 + g] : 0.f;
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int x = 0; x < kCpl * kVec; ++x) acc[g][x] = 0.f;
    }
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
    const T* ks = ring + (size_t)slot * 2 * kTileK * pitch;
    const T* vs = ks + kTileK * pitch;
    const int t0 = tile_at(use) * kTileK, n = min(kTileK, kend - t0);

    if constexpr (kMma) {
      // S = Q.K^T over the warp's 16 keys, two n8 tiles a k16 step: lane l
      // gives ldmatrix the row of key l % 8 (+ 8 for l >= 16) at the step's
      // chunk (l / 8) % 2, so that its four 8 x 8 matrices are the B
      // fragments of keys 0-7 and 8-15
      const int k_row = warp * kWarpKeys + (lane & 7) + ((lane >> 4) << 3);
      const uint32_t k_lane = smem_u32(ks + k_row * pitch + ((lane >> 3) & 1) * 8);
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        if (kk * 16 < D) {
          uint32_t kf[4];
          ssd::ldsm_x4(kf, k_lane + kk * 32);
          ssd::mma_bf16(s[0], qa[kk], kf[0], kf[1]);
          ssd::mma_bf16(s[1], qa[kk], kf[2], kf[3]);
        }
      }
      // s[nt][e] is row fr + 8 (e / 2) against key 8 nt + fc + e % 2 of the
      // warp's 16: the masks, the ALiBi bias and the online softmax of the
      // CUDA-core body below, each row's max and sum over the fragment's 4 lanes
      bool ok[2][2];
      float dist[2][2];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = warp * kWarpKeys + 8 * nn + fc + c;
          const int pos = t0 + j;
          const bool live = j < n;
          bool k_ok = live;
          if constexpr (kMode == Mode::kValid) k_ok = live && valid[pos];
          if constexpr (kRagged) {
            if (t0 < ws && t0 + kTileK > a.num_meta)
              k_ok = live && (pos >= ws || pos < a.num_meta);
          }
          ok[nn][c] = k_ok;
          dist[nn][c] = (float)max(kend - 1 - pos, 0);
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1, c = e & 1;
          const float dot = s[nn][e];
          s[nn][e] = ok[nn][c] ? (alibi ? dot * a.scale - sl[rr] * dist[nn][c] : dot * a.scale)
                               : kNegInf;
          mx[rr] = fmaxf(mx[rr], s[nn][e]);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        alpha[rr] = expf(m[rr] - m_new);
        m[rr] = m_new;
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key weighs exactly nothing, as exp(NEG_INF - m) does
          const float p = ok[nn][e & 1] ? expf(s[nn][e] - m[e >> 1]) : 0.f;
          s[nn][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];   // this lane's keys
#pragma unroll
      for (int i = 0; i < kDP / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
      }
      // O += P.V: the two n8 tiles of P, in bf16, are the A fragment of one
      // k16 step over the warp's keys; lane l gives ldmatrix.trans the row of
      // key l % 8 (+ 8 for (l / 8) odd) at chunk l / 16 of each 16 columns,
      // so that its matrices are the B fragments of columns 0-7 and 8-15
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const int v_row = warp * kWarpKeys + (lane & 7) + (((lane >> 3) & 1) << 3);
      const uint32_t v_lane = smem_u32(vs + v_row * pitch + (lane >> 4) * 8);
#pragma unroll
      for (int dd = 0; dd < kDP / 16; ++dd) {
        if (dd * 16 < D) {
          uint32_t vf[4];
          ssd::ldsm_x4_trans(vf, v_lane + dd * 32);
          ssd::mma_bf16(o[2 * dd], pa, vf[0], vf[1]);
          if (dd * 16 + 8 < D) ssd::mma_bf16(o[2 * dd + 1], pa, vf[2], vf[3]);
        }
      }
    } else {
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
    }
    slot = slot + 1 == a.stages ? 0 : slot + 1;
    islot = islot + 1 == a.stages ? 0 : islot + 1;
  }
  cp_async_wait(0);

  if constexpr (kMma) {
    // the warps' partials: each row's l summed over the fragment's 4 lanes,
    // then O and (m, l) stored into the ring (every warp left the loop after
    // the barrier that follows its last read of a tile, and no copy into the
    // ring is in flight: the last issue() found no tile to load)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
#pragma unroll
    for (int i = 0; i < kDP / 8; ++i) {
      const int col = 8 * i + fc;
      if (col < D) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(acc_w + (warp * kG + fr + 8 * rr) * D + col) =
              make_float2(o[i][2 * rr], o[i][2 * rr + 1]);
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) ml_w[warp * kG + fr + 8 * rr] = make_float2(m[rr], l[rr]);
    }
  } else {
    // the warps' partials: fold the key groups of each chunk, then store
    for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int x = 0; x < kCpl * kVec; ++x)
          acc[g][x] += __shfl_xor_sync(0xffffffffu, acc[g][x], o);
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

// the tensor-core instance, by mode and padded head dim, under names of its own
template <int kDP>
__global__ void __launch_bounds__(kThreads) valid_decode_mma_kernel(SplitArgs a) {
  split_body<__nv_bfloat16, Mode::kValid, kMmaRows, kWideCpl, kDP>(a);
}

template <int kDP>
__global__ void __launch_bounds__(kThreads) paged_decode_mma_kernel(SplitArgs a) {
  split_body<__nv_bfloat16, Mode::kPaged, kMmaRows, kWideCpl, kDP>(a);
}

template <int kDP>
__global__ void __launch_bounds__(kThreads) batched_decode_mma_kernel(SplitArgs a) {
  split_body<__nv_bfloat16, Mode::kRagged, kMmaRows, kWideCpl, kDP>(a);
}

// Query rows one block takes, by (dtype, G) alone.  bf16 groups of kMmaMinG
// or more take the tensor-core instance, 16 rows a block: yi-34b (56:8
// heads, G 7), qwen3-moe-30b-a3b (32:4, G 8) and nemotron-4-340b (96:8, G
// 12) in one block a group.  Below that the whole group takes one block on
// the CUDA cores: gpt2, phi-3-vision and seamless (G 1), internlm2 (G 2),
// Hymba and smollm (G 5), which also serves G 3-4; f32 keeps 8 rows a block
// above 5, a group above 8 in blocks of 8.
bool use_mma(size_t es, int G) { return es == 2 && G >= kMmaMinG; }
int rows_per_block(size_t es, int G) {
  return use_mma(es, G) ? kMmaRows : G == 1 ? 1 : G <= 5 ? 5 : 8;
}

size_t split_smem(size_t es, int D, int stages, int kG) {
  return (size_t)stages * 2 * kTileK * D * es +
         sizeof(float) * ((size_t)kG * D + (size_t)kWarps * kG * kWarpKeys +
                          (size_t)kWarps * kG * D + (size_t)2 * kWarps * kG + (size_t)kG * D +
                          (size_t)2 * kG) +
         sizeof(int) * kMaxStages;
}

// The tensor-core instance's: the ring of padded bf16 rows (which the warps'
// partials reuse: 4 x 16 x D f32 and their (m, l) fit in one stage), the
// block's partial and its (m, l), the ring's tile indices.
size_t mma_smem(int D, int stages) {
  return (size_t)stages * 2 * kTileK * mma_pitch(D) * 2 +
         sizeof(float) * ((size_t)kMmaRows * D + 2 * (size_t)kMmaRows) + sizeof(int) * kMaxStages;
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

template <typename T, Mode kMode, int kG, int kCpl, int kDP = 0>
cudaError_t launch_split_kernel(const SplitArgs& a, const SplitPlan& p, int B,
                                cudaStream_t stream) {
  void (*kernel)(SplitArgs) = nullptr;
  if constexpr (kDP > 0) {
    if constexpr (kMode == Mode::kValid) kernel = valid_decode_mma_kernel<kDP>;
    if constexpr (kMode == Mode::kPaged) kernel = paged_decode_mma_kernel<kDP>;
    if constexpr (kMode == Mode::kRagged) kernel = batched_decode_mma_kernel<kDP>;
  } else {
    if constexpr (kMode == Mode::kValid) kernel = valid_decode_split_kernel<T, kG, kCpl>;
    if constexpr (kMode == Mode::kPaged) kernel = paged_decode_split_kernel<T, kG, kCpl>;
    if constexpr (kMode == Mode::kRagged) kernel = batched_decode_split_kernel<T, kG, kCpl>;
  }
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
  if constexpr (has_wide<T>()) {
    if (lane_plan(D / (16 / (int)sizeof(T)), kWideCpl).cpl > kBaseCpl<T>) return kWideCpl;
  }
  return kBaseCpl<T>;
}

template <typename T, int kG>
SplitPlan plan_rows(int B, int S, int Hq, int Hkv, int D) {
  const void* kernel = (const void*)valid_decode_split_kernel<T, kG, kBaseCpl<T>>;
  if constexpr (has_wide<T>()) {
    if (cpl_for<T, kG>(D) == kWideCpl)
      kernel = (const void*)valid_decode_split_kernel<T, kG, kWideCpl>;
  }
  return plan_split(sizeof(T), B, S, Hq, Hkv, D, kG, kernel);
}

// The tensor-core instance's launch shape: two ring stages, and of the
// cluster sizes whose clusters the device holds all at once (the runtime's
// occupancy count), the one that gives a block the fewest tiles of the
// capacity, the smallest such; one cluster of one where none is resident.
template <int kDP>
SplitPlan plan_mma(int B, int S, int Hq, int Hkv, int D) {
  const long long clusters = (long long)B * Hkv * ((Hq / Hkv + kMmaRows - 1) / kMmaRows);
  const int nt = (S + kTileK - 1) / kTileK;
  const int stages = 2;
  const size_t smem = mma_smem(D, stages);
  int splits = 1, longest = nt;
  for (int s = 1; s <= kMaxSplits && s <= nt; ++s) {
    const int l = (nt + s - 1) / s;
    const void* kernel = (const void*)valid_decode_mma_kernel<kDP>;
    if (l < longest && resident_clusters(kernel, kThreads, s, smem) >= clusters) {
      splits = s;
      longest = l;
    }
  }
  return {splits, stages, smem};
}

template <typename T, Mode kMode, int kG>
cudaError_t launch_split_rows(SplitArgs a, int B, cudaStream_t stream) {
  const SplitPlan p = plan_rows<T, kG>(B, a.S, a.Hq, a.Hkv, a.D);
  a.stages = p.stages;
  if constexpr (has_wide<T>()) {
    if (cpl_for<T, kG>(a.D) == kWideCpl)
      return launch_split_kernel<T, kMode, kG, kWideCpl>(a, p, B, stream);
  }
  return launch_split_kernel<T, kMode, kG, kBaseCpl<T>>(a, p, B, stream);
}

template <Mode kMode, int kDP>
cudaError_t launch_mma(SplitArgs a, int B, cudaStream_t stream) {
  const SplitPlan p = plan_mma<kDP>(B, a.S, a.Hq, a.Hkv, a.D);
  a.stages = p.stages;
  return launch_split_kernel<__nv_bfloat16, kMode, kMmaRows, kWideCpl, kDP>(a, p, B, stream);
}

template <typename T, Mode kMode>
cudaError_t launch_split(const SplitArgs& a, int B, cudaStream_t stream) {
  const int rows = rows_per_block(sizeof(T), a.Hq / a.Hkv);
  if (rows == 1) return launch_split_rows<T, kMode, 1>(a, B, stream);
  if (rows == 5) return launch_split_rows<T, kMode, 5>(a, B, stream);
  if constexpr (sizeof(T) == 2) {          // rows == kMmaRows
    switch (mma_dp(a.D)) {
      case 64: return launch_mma<kMode, 64>(a, B, stream);
      case 128: return launch_mma<kMode, 128>(a, B, stream);
      case 192: return launch_mma<kMode, 192>(a, B, stream);
      default: return launch_mma<kMode, 256>(a, B, stream);
    }
  } else {
    return launch_split_rows<T, kMode, 8>(a, B, stream);
  }
}

template <typename T>
SplitPlan plan_dtype(int B, int S, int Hq, int Hkv, int D) {
  const int rows = rows_per_block(sizeof(T), Hq / Hkv);
  if (rows == 1) return plan_rows<T, 1>(B, S, Hq, Hkv, D);
  if (rows == 5) return plan_rows<T, 5>(B, S, Hq, Hkv, D);
  if constexpr (sizeof(T) == 2) {
    switch (mma_dp(D)) {
      case 64: return plan_mma<64>(B, S, Hq, Hkv, D);
      case 128: return plan_mma<128>(B, S, Hq, Hkv, D);
      case 192: return plan_mma<192>(B, S, Hq, Hkv, D);
      default: return plan_mma<256>(B, S, Hq, Hkv, D);
    }
  } else {
    return plan_rows<T, 8>(B, S, Hq, Hkv, D);
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
