// flash_attention_bwd — the gradient of whole-prompt attention on Hopper.
//
// The TPU package has no counterpart: its training step differentiates
// XLA's attention (`backend="xla"`, src/repro/models/registry.py:15), and
// none of its Pallas kernels has a custom_vjp.  The port trains through its
// forward kernel (flash_attention.cu), so that kernel's output needs a
// gradient that is a kernel too.  This is FlashAttention's backward:
//
//   P     = exp(S * scale - LSE)        S = Q.K^T, LSE from the forward
//   Delta = rowsum(dO o O)
//   dV    = P^T . dO
//   dS    = P o (dO.V^T - Delta)
//   dK    = scale * dS^T . Q
//   dQ    = scale * dS . K
//
// with the forward's masking: causal with the offset of a query block at
// the end of the keys (query i sees keys j <= i + (Skv - Sq)) or full.  A
// masked pair has P = 0 exactly, as the forward's NEG_INF = -0.7 * FLT_MAX
// gives after exp.  Everything accumulates in f32; dq/dk/dv are stored in
// the inputs' type (float32 or bfloat16).
//
// Three launches on one stream, none with atomics, so the result is
// deterministic (every sum runs in one fixed order):
//   * delta_kernel: Delta [B, Hq, Sq] f32, a few lanes a row.
//   * dkdv: a block owns (batch row, KV head, a tile of keys), holds K and
//     V in shared memory and dK, dV in registers, and walks the G = Hq / Hkv
//     query heads of its KV head and every query tile that sees its keys
//     (from the causal start on).  Summing the G heads inside the block is
//     what lets GQA go without atomics.
//   * dq: a block owns (batch row, query head, a run of query rows) and
//     walks the key tiles up to the run's causal limit, recomputing S and
//     dO.V^T: seven products where the bound counts five, the price of a
//     dQ without atomics.
//
// What bounds it on the H100: 5 products of 2 * pairs * D flops each over
// q, k, v, o, dO read and dq, dk, dv written once; at smollm's [8, 2048,
// 15:5, 64] causal that is some 150 flops a byte, so the tensor cores
// (989 TFLOP/s, wgmma only) bound it.  What holds this body from it: the
// seven products, wgmma m64n64 tiles fed from shared memory (A and B both
// read there for S and dP), and the exp and mask work between products,
// which the two compute warpgroups of a block overlap only with each
// other.
//
// bf16 at D <= 128 (dkdv_wgmma_kernel, dq_wgmma_kernel), FlashAttention-3's
// backward without its atomic dQ: a block is three warpgroups, two that
// compute on wgmma and one that loads.
//   * The producer warpgroup gives its registers to the other two
//     (setmaxnreg 24 / 240; dK and dV at D = 128 take 128 of them).  One
//     warp of it keeps a ring of Q/dO tiles (K/V tiles in dq) of 64 rows
//     in flight by TMA, 3 to 6 stages with a full and an empty mbarrier
//     each; in dkdv its lanes copy each query tile's LSE and Delta beside
//     it by cp.async, which arrives on the same full barrier.  The compute
//     warpgroups wait on barriers only: no __syncthreads in the loop, no
//     cp.async wait.
//   * dkdv: a block owns 64 keys and both compute warpgroups hold all of
//     them; the block's (query head, query tile) items alternate between
//     the two, each summing its own dK and dV, and at the end they add the
//     other's half through shared memory (two sums in a fixed order).
//     Splitting the items, not the keys, keeps a block's causal work
//     spread over both warpgroups and gives qwen3-moe's short grid (16 key
//     tiles x 4 heads x 4 rows) twice the blocks.  S^T = K.Q^T and
//     dP^T = V.dO^T run with the keys on wgmma's M side (all four tiles
//     K-major from the 128-byte swizzle), so that
//     P^T = exp2(S^T scale log2e - LSE log2e) and dS^T = P^T o (dP^T - Delta)
//     come out in the accumulator registers in the layout of wgmma's A
//     fragment: they are packed to bf16 in registers (as FA2/FA3 round
//     them) and dV += P^T.dO, dK += dS^T.Q run as register-A wgmma with dO
//     and Q MN-major (the descriptor's transpose bit).  P and dS never
//     touch shared memory.
//   * dq: each compute warpgroup holds 64 query rows, so a block of 128
//     reads each K/V tile once; S = Q.K^T and dP = dO.V^T from shared
//     memory, dS in registers, dQ += dS.K as register-A wgmma with K
//     MN-major; one scaled store at the end.
//   * Heaviest tiles first: under causal masking key tile 0 sees every
//     query tile and the last query run sees every key, so both grids
//     launch those first and the light ones fill the tail.
// bf16 at D = 192 (dkdv_mma_kernel, dq_mma_kernel) keeps the mma.sync
// m16n8k16 body of eight warps: a wgmma warpgroup of 64 keys would hold
// dK and dV in 96 + 96 f32 registers a thread beside S^T and dP^T, past the
// 240 a compute thread gets.  No config trains at D = 192 (nemotron-4-340b
// serves only).  P and dS go through padded bf16 tiles and ldmatrix.trans;
// tiles arrive by cp.async with zero fill past Sq and Skv.
// f32 (dkdv_kernel, dq_kernel) keeps the CUDA cores, which hold the f32
// band: a 16 x 16 thread grid, each thread a 4 x 4 patch of a 64 x 64
// score tile or 4 rows by D / 16 columns of an output tile, over f32
// shared rows padded to D + 1 floats; at D = 192 its shared memory is
// 231,424 bytes, one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                    // query rows per tile
constexpr int kBK = 64;                    // keys per tile
constexpr int kGrid = 16;                  // threads along each side of a tile
constexpr int kPer = kBQ / kGrid;          // rows (and columns) per thread: 4
constexpr int kLdp = kBK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Copies rows [0, n) of D floats (row stride `row` elements) into shared
// rows of stride D + 1, 16 bytes per thread per step; rows [n, kBQ) are
// zeroed.
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, long long row, int n,
                                           float* dst) {
  constexpr int kPerRow = D / 4;
  constexpr int ld = D + 1;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int j = i / kPerRow, c = i - j * kPerRow;
    float* d = dst + j * ld + c * 4;
    const float4 u = j < n ? *reinterpret_cast<const float4*>(src + (long long)j * row + c * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    d[0] = u.x;
    d[1] = u.y;
    d[2] = u.z;
    d[3] = u.w;
  }
}

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d].  Rows [B, Sq, Hq]
// lie D elements apart, so kL neighbouring lanes read one row in 16-byte
// chunks, a warp 512 contiguous bytes, and sum it by a fixed shuffle tree.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int Sq, int Hq) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kC = D / kVec;             // 16-byte chunks a row
  constexpr int kL = kC <= 2 ? 2 : kC <= 4 ? 4 : kC <= 8 ? 8 : kC <= 16 ? 16 : 32;
  const long long r = (long long)blockIdx.x * (kThreads / kL) + threadIdx.x / kL;
  const int lane = threadIdx.x % kL;
  const bool in = r < (long long)B * Sq * Hq;
  float s = 0.f;
  if (in) {
    const uint4* a = reinterpret_cast<const uint4*>(o + r * D);
    const uint4* g = reinterpret_cast<const uint4*>(dout + r * D);
#pragma unroll
    for (int c = lane; c < kC; c += kL) {
      const uint4 x = a[c], y = g[c];
      const T* xe = reinterpret_cast<const T*>(&x);
      const T* ye = reinterpret_cast<const T*>(&y);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s = fmaf(to_float(xe[e]), to_float(ye[e]), s);
    }
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (in && lane == 0) {
    // r walks [B, Sq, Hq] as the tensors do
    const int h = (int)(r % Hq);
    const long long bi = r / Hq;           // b * Sq + i
    const int i = (int)(bi % Sq);
    const int b = (int)(bi / Sq);
    delta[((long long)b * Hq + h) * Sq + i] = s;
  }
}

// The 64 x 64 tile of P and dS for query rows q0 + tr + 16 i and keys
// k0 + tc + 16 j, from f32 Q, dO, K, V rows in shared memory and each
// row's LSE and Delta.
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* q_s, const float* do_s,
                                          const float* k_s, const float* v_s,
                                          const float* lse_s, const float* dl_s, int q0,
                                          int k0, int Sq, int Skv, int off, int causal,
                                          float scale, int tr, int tc, float p[kPer][kPer],
                                          float ds[kPer][kPer]) {
  constexpr int ld = D + 1;
  float dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) p[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kPer], gv[kPer], kv[kPer], vv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qv[i] = q_s[(tr + kGrid * i) * ld + d];
      gv[i] = do_s[(tr + kGrid * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      kv[j] = k_s[(tc + kGrid * j) * ld + d];
      vv[j] = v_s[(tc + kGrid * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qr = tr + kGrid * i;
    const int qpos = q0 + qr;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int key = k0 + tc + kGrid * j;
      const bool ok = qpos < Sq && key < Skv && (!causal || key <= qpos + off);
      const float pij = ok ? expf(fmaf(p[i][j], scale, -lse_s[qr])) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - dl_s[qr]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kBQ * (D + 1) + 2 * (size_t)kBQ * kLdp + 2 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Sq,
            int Skv, int Hq, int Hkv, int causal, float scale) {
  constexpr int ld = D + 1;
  constexpr int kCols = D / kGrid;         // output columns per thread
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int nk = min(kBK, Skv - k0);
  const int tid = threadIdx.x;
  const int tr = tid / kGrid, tc = tid % kGrid;

  extern __shared__ float smem[];
  float* k_s = smem;                       // [kBK][D+1]
  float* v_s = k_s + kBK * ld;
  float* q_s = v_s + kBK * ld;             // [kBQ][D+1]
  float* do_s = q_s + kBQ * ld;
  float* p_s = do_s + kBQ * ld;            // [kBQ][kBK+1]
  float* ds_s = p_s + kBQ * kLdp;
  float* lse_s = ds_s + kBQ * kLdp;        // [kBQ]
  float* dl_s = lse_s + kBQ;

  const long long qrow = (long long)Hq * D;    // elements between consecutive tokens
  const long long krow = (long long)Hkv * D;
  const long long kbase = ((long long)b * Skv + k0) * krow + (long long)hk * D;
  stage_rows<D>(k + kbase, krow, nk, k_s);
  stage_rows<D>(v + kbase, krow, nk, v_s);

  float acc_k[kPer][kCols], acc_v[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int off = Skv - Sq;
  // the first query row that sees key k0: every earlier tile is masked
  const int qfirst = causal ? max(0, k0 - off) : 0;
  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const float* lse_h = lse + ((long long)b * Hq + h) * Sq;
    const float* dl_h = delta + ((long long)b * Hq + h) * Sq;
    for (int q0 = (qfirst / kBQ) * kBQ; q0 < Sq; q0 += kBQ) {
      const int nq = min(kBQ, Sq - q0);
      __syncthreads();                     // the last tile's reads are done
      const long long qbase = ((long long)b * Sq + q0) * qrow + (long long)h * D;
      stage_rows<D>(q + qbase, qrow, nq, q_s);
      stage_rows<D>(dout + qbase, qrow, nq, do_s);
      if (tid < kBQ) {
        lse_s[tid] = tid < nq ? lse_h[q0 + tid] : 0.f;
        dl_s[tid] = tid < nq ? dl_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float p[kPer][kPer], ds[kPer][kPer];
      p_ds_tile<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, q0, k0, Sq, Skv, off, causal, scale,
                   tr, tc, p, ds);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          p_s[(tr + kGrid * i) * kLdp + tc + kGrid * j] = p[i][j];
          ds_s[(tr + kGrid * i) * kLdp + tc + kGrid * j] = ds[i][j];
        }
      __syncthreads();

      // dV[key][d] += P[r][key] dO[r][d]; dK[key][d] += dS[r][key] Q[r][d]
      // for keys tr + 16 i and columns tc + 16 c; rows past nq are zero
      for (int r = 0; r < nq; ++r) {
        float pr[kPer], dsr[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pr[i] = p_s[r * kLdp + tr + kGrid * i];
          dsr[i] = ds_s[r * kLdp + tr + kGrid * i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float g = do_s[r * ld + tc + kGrid * c];
          const float x = q_s[r * ld + tc + kGrid * c];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            acc_v[i][c] = fmaf(pr[i], g, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsr[i], x, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int key = tr + kGrid * i;
    if (key >= nk) continue;
    const long long at = ((long long)b * Skv + k0 + key) * krow + (long long)hk * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + tc + kGrid * c] = acc_k[i][c] * scale;
      dv[at + tc + kGrid * c] = acc_v[i][c];
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kBQ * (D + 1) + (size_t)kBQ * kLdp + 2 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Sq, int Skv, int Hq,
          int Hkv, int causal, float scale) {
  constexpr int ld = D + 1;
  constexpr int kCols = D / kGrid;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x;
  const int tr = tid / kGrid, tc = tid % kGrid;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kBQ][D+1]
  float* do_s = q_s + kBQ * ld;
  float* k_s = do_s + kBQ * ld;            // [kBK][D+1]
  float* v_s = k_s + kBK * ld;
  float* ds_s = v_s + kBK * ld;            // [kBQ][kBK+1]
  float* lse_s = ds_s + kBQ * kLdp;        // [kBQ]
  float* dl_s = lse_s + kBQ;

  const long long qrow = (long long)Hq * D;
  const long long krow = (long long)Hkv * D;
  const long long qbase = ((long long)b * Sq + q0) * qrow + (long long)h * D;
  stage_rows<D>(q + qbase, qrow, nq, q_s);
  stage_rows<D>(dout + qbase, qrow, nq, do_s);
  if (tid < kBQ) {
    const long long at = ((long long)b * Hq + h) * Sq + q0 + tid;
    lse_s[tid] = tid < nq ? lse[at] : 0.f;
    dl_s[tid] = tid < nq ? delta[at] : 0.f;
  }

  float acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int off = Skv - Sq;
  // keys past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them
  const int kend = causal ? min(Skv, q0 + nq + off) : Skv;
  const float* kb = k + (long long)b * Skv * krow + (long long)hk * D;
  const float* vb = v + (long long)b * Skv * krow + (long long)hk * D;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, Skv - k0);
    __syncthreads();                       // the last tile's reads are done
    stage_rows<D>(kb + (long long)k0 * krow, krow, nk, k_s);
    stage_rows<D>(vb + (long long)k0 * krow, krow, nk, v_s);
    __syncthreads();

    float p[kPer][kPer], ds[kPer][kPer];
    p_ds_tile<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, q0, k0, Sq, Skv, off, causal, scale, tr,
                 tc, p, ds);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) ds_s[(tr + kGrid * i) * kLdp + tc + kGrid * j] = ds[i][j];
    __syncthreads();

    // dQ[r][d] += dS[r][key] K[key][d] for rows tr + 16 i, columns tc + 16 c
    const int nkey = min(kBK, kend - k0);
    for (int key = 0; key < nkey; ++key) {
      float dsr[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsr[i] = ds_s[(tr + kGrid * i) * kLdp + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = k_s[key * ld + tc + kGrid * c];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][c] = fmaf(dsr[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = tr + kGrid * i;
    if (row >= nq) continue;
    const long long at = qbase + (long long)row * qrow;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[at + tc + kGrid * c] = acc[i][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 192: the five products on mma.sync m16n8k16 (f32 sums)
// ---------------------------------------------------------------------------

constexpr int kLdb = kBK + 8;              // P and dS rows: 64 bf16 + 16 bytes of pad

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ldmatrix addresses (bytes, shared window) of this lane for the fragments
// of mma m16n8k16 (g = lane / 4, t = lane % 4: A holds rows g and g + 8 of
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B rows 2t, 2t + 1 and 2t + 8,
// 2t + 9 of column g; C rows g and g + 8 of columns 2t, 2t + 1):
//   A from a [m][k] tile: a_rows; from a [k][m] tile, with .trans: a_cols;
//   B for two n-tiles from an [n][k] tile: b_rows; from a [k][n] tile,
//   with .trans: b_cols.  Registers 0, 1 are then B of the first n-tile,
//   2, 3 of the second.
__device__ __forceinline__ uint32_t a_rows(const __nv_bfloat16* t, int ld, int lane) {
  return smem_u32(t + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4));
}
__device__ __forceinline__ uint32_t a_cols(const __nv_bfloat16* t, int ld, int lane) {
  return smem_u32(t + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1));
}
__device__ __forceinline__ uint32_t b_rows(const __nv_bfloat16* t, int ld, int lane) {
  return a_cols(t, ld, lane);
}
__device__ __forceinline__ uint32_t b_cols(const __nv_bfloat16* t, int ld, int lane) {
  return a_rows(t, ld, lane);
}

// Copies rows [0, n) of D bf16 (row stride `row` elements) into shared rows
// of stride D + 8 with cp.async, rows [n, 64) zero-filled; the caller
// commits and waits.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src, long long row,
                                           int n, __nv_bfloat16* dst) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int j = i / kPerRow, c = i - j * kPerRow;
    cp_async16_zfill(dst + j * (D + 8) + c * 8, src + (long long)min(j, n - 1) * row + c * 8,
                     j < n ? 16 : 0);
  }
}

// This warp's 16 query rows (from mq) by 32 keys (from nk0) of P and dS, in
// the C fragment's layout ([n-tile][c]), from bf16 Q, dO, K, V tiles.
template <int D>
__device__ __forceinline__ void p_ds_mma(const __nv_bfloat16* q_s, const __nv_bfloat16* do_s,
                                         const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
                                         const float* lse_s, const float* dl_s, int q0, int k0,
                                         int Sq, int Skv, int off, int causal, float scale,
                                         int mq, int nk0, float (&p)[4][4],
                                         float (&ds)[4][4]) {
  constexpr int ld = D + 8;
  const int lane = threadIdx.x % 32;
  float dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
  const uint32_t qa = a_rows(q_s + mq * ld, ld, lane);
  const uint32_t ga = a_rows(do_s + mq * ld, ld, lane);
  const uint32_t kb = b_rows(k_s + nk0 * ld, ld, lane);
  const uint32_t vb = b_rows(v_s + nk0 * ld, ld, lane);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4], g[4], b[4];
    ldsm_x4(a, qa + 2 * kk);
    ldsm_x4(g, ga + 2 * kk);
#pragma unroll
    for (int nt = 0; nt < 4; nt += 2) {
      ldsm_x4(b, kb + 2 * (nt * 8 * ld + kk));
      mma_bf16(p[nt], a, b[0], b[1]);
      mma_bf16(p[nt + 1], a, b[2], b[3]);
      ldsm_x4(b, vb + 2 * (nt * 8 * ld + kk));
      mma_bf16(dp[nt], g, b[0], b[1]);
      mma_bf16(dp[nt + 1], g, b[2], b[3]);
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qr = mq + g + 8 * (e >> 1);
      const int qpos = q0 + qr;
      const int key = k0 + nk0 + 8 * nt + 2 * t + (e & 1);
      const bool ok = qpos < Sq && key < Skv && (!causal || key <= qpos + off);
      const float pij = ok ? expf(fmaf(p[nt][e], scale, -lse_s[qr])) : 0.f;
      p[nt][e] = pij;
      ds[nt][e] = pij * (dp[nt][e] - dl_s[qr]);
    }
}

// Stores this warp's fragment of a [64][64] f32 tile as bf16 rows [q][key].
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const float (&x)[4][4], int mq,
                                           int nk0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = nk0 + 8 * nt + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + (mq + g) * kLdb + col) = pack_bf16(x[nt][0], x[nt][1]);
    *reinterpret_cast<uint32_t*>(dst + (mq + g + 8) * kLdb + col) =
        pack_bf16(x[nt][2], x[nt][3]);
  }
}

template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  return 2 * (4 * (size_t)kBQ * (D + 8) + 2 * (size_t)kBQ * kLdb) + 4 * 2 * kBQ;
}

// Eight warps: in the P / dS products warp w takes query rows 16 (w % 4)
// and keys 32 (w / 4); in the dV / dK products warps 0-3 take dV and 4-7 dK,
// 16 keys each, over the whole head dim.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                int Hq, int Hkv, int causal, float scale) {
  constexpr int ld = D + 8;
  constexpr int kNT = D / 8;               // n-tiles of the head dim
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int nk = min(kBK, Skv - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mq = (warp & 3) * 16, nk0 = (warp >> 2) * 32;
  const bool is_dk = warp >= 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBK][D+8]
  __nv_bfloat16* v_s = k_s + kBK * ld;
  __nv_bfloat16* q_s = v_s + kBK * ld;                               // [kBQ][D+8]
  __nv_bfloat16* do_s = q_s + kBQ * ld;
  __nv_bfloat16* p_s = do_s + kBQ * ld;                              // [kBQ][kLdb]
  __nv_bfloat16* ds_s = p_s + kBQ * kLdb;
  float* lse_s = reinterpret_cast<float*>(ds_s + kBQ * kLdb);        // [kBQ]
  float* dl_s = lse_s + kBQ;

  const long long qrow = (long long)Hq * D;
  const long long krow = (long long)Hkv * D;
  const long long kbase = ((long long)b * Skv + k0) * krow + (long long)hk * D;
  stage_bf16<D>(k + kbase, krow, nk, k_s);
  stage_bf16<D>(v + kbase, krow, nk, v_s);

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // dV += P^T dO, dK += dS^T Q: A from the [q][key] tile, B from [q][d]
  const uint32_t xa = a_cols((is_dk ? ds_s : p_s) + mq, kLdb, lane);
  const uint32_t yb = b_cols(is_dk ? q_s : do_s, ld, lane);

  const int off = Skv - Sq;
  const int qfirst = causal ? max(0, k0 - off) : 0;   // the first row that sees key k0
  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const float* lse_h = lse + ((long long)b * Hq + h) * Sq;
    const float* dl_h = delta + ((long long)b * Hq + h) * Sq;
    for (int q0 = (qfirst / kBQ) * kBQ; q0 < Sq; q0 += kBQ) {
      const int nq = min(kBQ, Sq - q0);
      __syncthreads();                     // the last tile's reads are done
      const long long qbase = ((long long)b * Sq + q0) * qrow + (long long)h * D;
      stage_bf16<D>(q + qbase, qrow, nq, q_s);
      stage_bf16<D>(dout + qbase, qrow, nq, do_s);
      cp_async_commit();
      if (threadIdx.x < kBQ) {
        lse_s[threadIdx.x] = threadIdx.x < nq ? lse_h[q0 + threadIdx.x] : 0.f;
        dl_s[threadIdx.x] = threadIdx.x < nq ? dl_h[q0 + threadIdx.x] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float p[4][4], ds[4][4];
      p_ds_mma<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, q0, k0, Sq, Skv, off, causal, scale, mq,
                  nk0, p, ds);
      store_tile(p_s, p, mq, nk0);
      store_tile(ds_s, ds, mq, nk0);
      __syncthreads();

      for (int r0 = 0; r0 < nq; r0 += 16) {   // rows past nq hold P = dS = 0
        uint32_t a[4];
        ldsm_x4_trans(a, xa + 2 * r0 * kLdb);
#pragma unroll
        for (int nt = 0; nt < kNT; nt += 2) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, yb + 2 * (r0 * ld + nt * 8));
          mma_bf16(acc[nt], a, bb[0], bb[1]);
          mma_bf16(acc[nt + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  __nv_bfloat16* out = is_dk ? dk : dv;
  const float s = is_dk ? scale : 1.f;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = mq + g + 8 * half;
    if (key >= nk) continue;
    __nv_bfloat16* row = out + ((long long)b * Skv + k0 + key) * krow + (long long)hk * D;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * half] * s, acc[nt][2 * half + 1] * s);
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  return 2 * (4 * (size_t)kBQ * (D + 8) + (size_t)kBQ * kLdb) + 4 * 2 * kBQ;
}

// Eight warps: the P / dS products as in dkdv_mma_kernel; in dQ += dS K
// warp w takes query rows 16 (w % 4) over the keys of its half, 32 (w / 4),
// and the two halves are summed in shared memory at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
              float scale) {
  constexpr int ld = D + 8;
  constexpr int kNT = D / 8;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kBQ, Sq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mq = (warp & 3) * 16, nk0 = (warp >> 2) * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBQ][D+8]
  __nv_bfloat16* do_s = q_s + kBQ * ld;
  __nv_bfloat16* k_s = do_s + kBQ * ld;                              // [kBK][D+8]
  __nv_bfloat16* v_s = k_s + kBK * ld;
  __nv_bfloat16* ds_s = v_s + kBK * ld;                              // [kBQ][kLdb]
  float* lse_s = reinterpret_cast<float*>(ds_s + kBQ * kLdb);        // [kBQ]
  float* dl_s = lse_s + kBQ;

  const long long qrow = (long long)Hq * D;
  const long long krow = (long long)Hkv * D;
  const long long qbase = ((long long)b * Sq + q0) * qrow + (long long)h * D;
  stage_bf16<D>(q + qbase, qrow, nq, q_s);
  stage_bf16<D>(dout + qbase, qrow, nq, do_s);
  if (threadIdx.x < kBQ) {
    const long long at = ((long long)b * Hq + h) * Sq + q0 + threadIdx.x;
    lse_s[threadIdx.x] = threadIdx.x < nq ? lse[at] : 0.f;
    dl_s[threadIdx.x] = threadIdx.x < nq ? delta[at] : 0.f;
  }

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // dQ += dS K: A from the [q][key] tile, B from [key][d]
  const uint32_t da = a_rows(ds_s + mq * kLdb, kLdb, lane);
  const uint32_t kb = b_cols(k_s, ld, lane);

  const int off = Skv - Sq;
  // keys past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them
  const int kend = causal ? min(Skv, q0 + nq + off) : Skv;
  const __nv_bfloat16* kbg = k + (long long)b * Skv * krow + (long long)hk * D;
  const __nv_bfloat16* vbg = v + (long long)b * Skv * krow + (long long)hk * D;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, Skv - k0);
    __syncthreads();                       // the last tile's reads are done
    stage_bf16<D>(kbg + (long long)k0 * krow, krow, nk, k_s);
    stage_bf16<D>(vbg + (long long)k0 * krow, krow, nk, v_s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float p[4][4], ds[4][4];
    p_ds_mma<D>(q_s, do_s, k_s, v_s, lse_s, dl_s, q0, k0, Sq, Skv, off, causal, scale, mq,
                nk0, p, ds);
    store_tile(ds_s, ds, mq, nk0);
    __syncthreads();

#pragma unroll
    for (int kk = nk0; kk < nk0 + 32; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, da + 2 * kk);
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, kb + 2 * (kk * ld + nt * 8));
        mma_bf16(acc[nt], a, bb[0], bb[1]);
        mma_bf16(acc[nt + 1], a, bb[2], bb[3]);
      }
    }
  }

  // the two key halves: warps 4-7 hand theirs to warps 0-3 through the
  // K / V tiles' shared memory (256 (D + 8) bytes >= 64 D floats)
  __syncthreads();
  float* red = reinterpret_cast<float*>(k_s);
  if (warp >= 4) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(((warp & 3) * kNT + nt) * 4 + e) * 32 + lane] = acc[nt][e];
  }
  __syncthreads();
  if (warp >= 4) return;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = mq + g + 8 * half;
    if (row >= nq) continue;
    __nv_bfloat16* dst = dq + qbase + (long long)row * qrow;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* r = red + ((warp * kNT + nt) * 4 + 2 * half) * 32 + lane;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt + 2 * t) = __floats2bfloat162_rn(
          (acc[nt][2 * half] + r[0]) * scale, (acc[nt][2 * half + 1] + r[32]) * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D <= 128: two wgmma warpgroups fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kW = 2;                      // compute warpgroups, 64 rows each
constexpr int kWThreads = (kW + 1) * kWG;  // and the producer warpgroup
constexpr int kWRows = 64 * kW;            // query rows a dq block
constexpr int kProducerRegs = 24;          // 128 * 24 + 256 * 240 <= 65,536
constexpr int kConsumerRegs = 240;

// Tiles of 64 rows in flight, beside the block's own: Q/dO tiles in dkdv
// (6 at D <= 64, 4 at D = 96 and 128: 166 KB), K/V tiles in dq (4 and 3).
__host__ __device__ constexpr int dkdv_stages(int D) { return D > 64 ? 4 : 6; }
__host__ __device__ constexpr int dq_stages(int D) { return D > 64 ? 3 : 4; }

constexpr size_t dkdv_wgmma_smem_bytes(int D) {
  return 1024 + (size_t)(2 + 2 * dkdv_stages(D)) * tile_bytes(D) +
         2 * 64 * sizeof(float) * dkdv_stages(D) + 8 * (1 + 2 * dkdv_stages(D));
}
constexpr size_t dq_wgmma_smem_bytes(int D) {
  return 1024 + (size_t)(2 * kW + 2 * dq_stages(D)) * tile_bytes(D) +
         8 * (1 + 2 * dq_stages(D));
}

// The fragment of a wgmma m64nN f32 accumulator: thread (warp w, lane l) of
// a warpgroup holds d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l & 3) + (i & 1).  Columns 16 kk .. 16 kk + 15 are
// d[8 kk .. 8 kk + 8), the A fragment of k16 step kk.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[32], int kk) {
  a[0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// x (+)= A.B^T over the head dim, A and B K-major 64-row tiles (a k16 step
// is 32 bytes along a 128-byte row; the zero columns past D add nothing).
template <int D>
__device__ __forceinline__ void gemm_ss(float (&x)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk / 4) * kAtom + (kk % 4) * 32;
    wgmma_ss_n64(x, gmma_desc(a + step, 16, 1024), gmma_desc(b + step, 16, 1024), kk > 0);
  }
}

// acc += X.Y over 64 rows: X from registers (the accumulator fragment of a
// 64 x 64 tile), Y a 64-row tile read MN-major; its k16 step is 16 rows,
// two 1024-byte swizzle atoms.
template <int DP>
__device__ __forceinline__ void gemm_rs(float (&acc)[DP / 2], const float (&x)[32],
                                        uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a_frag(a, x, kk);
    wgmma_rs<DP>(acc, a, gmma_desc(y + kk * 2048, kAtom, 1024));
  }
}

// Stores this thread's rows r0 and r0 + 8 (those below `rows`) of a
// warpgroup's m64 accumulator, times s, as bf16 at columns below D into dst
// (row 0 of the tile); `row` is the elements between consecutive rows.
template <int D, int DP>
__device__ __forceinline__ void store_frag(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[DP / 2], float s, int r0,
                                           int rows, long long row, int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (r0 + 8 * rr >= rows) continue;
    __nv_bfloat16* p = dst + (long long)(r0 + 8 * rr) * row;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
      const int col = 8 * nn + 2 * (lane & 3);
      const int i = 4 * nn + 2 * rr;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(p + col) =
            __floats2bfloat162_rn(acc[i] * s, acc[i + 1] * s);
    }
  }
}

// dK, dV for 64 keys of one KV head, over its G query heads.  The block's
// items, (query head, query tile) pairs, alternate between the two compute
// warpgroups, each summing its own dK and dV; at the end they swap halves
// through shared memory and each stores one: a fixed order of two sums.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv, int Hq, int Hkv,
                  int causal, float scale, float scale_log2) {
  constexpr int kBoxes = boxes(D);
  constexpr int kDP = 64 * kBoxes;         // head dim padded to the boxes
  constexpr int kTile = tile_bytes(D);
  constexpr int kS = dkdv_stages(D);
  // key tile 0 first: under causal masking it sees every query tile
  const int k0 = (blockIdx.x / (Hkv * B)) * 64;
  const int hk = blockIdx.x % Hkv;
  const int b = (blockIdx.x / Hkv) % B;
  const int G = Hq / Hkv;
  const int off = Skv - Sq;
  // the query tiles that see key k0 (every earlier one is masked), per head
  const int qt0 = causal ? max(0, k0 - off) / 64 : 0;
  const int per_head = (Sq + 63) / 64 - qt0;
  const int n = G * per_head;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = base;                                    // one tile
  unsigned char* v_s = k_s + kTile;
  unsigned char* q_s = v_s + kTile;                             // [kS] ring
  unsigned char* g_s = q_s + kS * kTile;                        // [kS] ring, dO
  float* lse_s = reinterpret_cast<float*>(g_s + kS * kTile);    // [kS][64]
  float* dl_s = lse_s + kS * 64;                                // [kS][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + kS * 64); // K/V, full[kS], empty[kS]
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kS;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 33);             // the loading warp's lanes' copies, and TMA
      mbar_init(&empty[s], kWG);           // the threads of the warpgroup it went to
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform to the compiler (a shuffle from lane 0), so that each
  // warpgroup's branch, and its setmaxnreg, is seen to be taken whole
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int lane = threadIdx.x % 32;
  if (wg == kW) {
    // the producer warpgroup: its first warp loads, the others leave
    setmaxnreg_dec<kProducerRegs>();
    if (__shfl_sync(0xffffffffu, threadIdx.x % kWG / 32, 0) != 0) return;
    if (lane == 0) {
      mbar_expect_tx(&bars[0], 2 * kTile);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(k_s + x * kAtom, &kmap, &bars[0], 64 * x, hk, k0, b);
        tma_load(v_s + x * kAtom, &vmap, &bars[0], 64 * x, hk, k0, b);
      }
    }
    for (int j = 0; j < n; ++j) {
      const int st = j % kS;
      if (j >= kS) mbar_wait(&empty[st], (j / kS - 1) & 1);
      const int h = hk * G + j / per_head;
      const int q0 = (qt0 + j % per_head) * 64;
      const long long at = ((long long)b * Hq + h) * Sq;
#pragma unroll
      for (int r = lane; r < 64; r += 32) {   // rows past Sq: 0 (their P is masked)
        const int src = min(q0 + r, Sq - 1);
        const int bytes = q0 + r < Sq ? 4 : 0;
        cp_async4_zfill(lse_s + st * 64 + r, lse + at + src, bytes);
        cp_async4_zfill(dl_s + st * 64 + r, delta + at + src, bytes);
      }
      cp_async_mbar_arrive(&full[st]);
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * kTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(q_s + st * kTile + x * kAtom, &qmap, &full[st], 64 * x, h, q0, b);
          tma_load(g_s + st * kTile + x * kAtom, &gmap, &full[st], 64 * x, h, q0, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWG;
    const int warp = tid / 32;
    const int r0 = warp * 16 + lane / 4;   // key rows r0 and r0 + 8
    const int c0 = 2 * (lane & 3);         // query columns c0 + 8 nn (+ 1)
    const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
    float dk_acc[kDP / 2], dv_acc[kDP / 2];
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(&bars[0], 0);

    for (int j = wg; j < n; j += kW) {
      const int st = j % kS;
      const int q0 = (qt0 + j % per_head) * 64;
      mbar_wait(&full[st], (j / kS) & 1);
      const uint32_t q_addr = smem_u32(q_s + st * kTile);
      const uint32_t g_addr = smem_u32(g_s + st * kTile);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      // S^T = K.Q^T and dP^T = V.dO^T: keys on M, the tile's queries on N
      wgmma_fence();
      gemm_ss<D>(s, k_addr, q_addr);
      wgmma_commit();
      gemm_ss<D>(dp, v_addr, g_addr);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      const float* ls = lse_s + st * 64;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * nn + c0);
        const float lx = l.x * kLog2e, ly = l.y * kLog2e;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * nn + 2 * rr;
          s[i] = fast_exp2(fmaf(s[i], scale_log2, -lx));
          s[i + 1] = fast_exp2(fmaf(s[i + 1], scale_log2, -ly));
        }
      }
      if (q0 + 64 > Sq || k0 + 64 > Skv || (causal && q0 + off < k0 + 63)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + r0 + 8 * ((i >> 1) & 1);
          const int qr = q0 + 8 * (i >> 2) + c0 + (i & 1);
          if (qr >= Sq || key >= Skv || (causal && key > qr + off)) s[i] = 0.f;
        }
      }
      wgmma_wait_all();
      fence_regs(dp);
      const float* dl = dl_s + st * 64;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const float2 e = *reinterpret_cast<const float2*>(dl + 8 * nn + c0);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * nn + 2 * rr;
          dp[i] = s[i] * (dp[i] - e.x);
          dp[i + 1] = s[i + 1] * (dp[i + 1] - e.y);
        }
      }
      // dV += P^T.dO, dK += dS^T.Q: the tile's queries are the k dimension
      wgmma_fence();
      gemm_rs<kDP>(dv_acc, s, g_addr);
      gemm_rs<kDP>(dk_acc, dp, q_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[st]);             // this thread is done with stage st
    }

    // Once both warpgroups are past their last item the ring is idle (every
    // load into it has been waited for): warpgroup 0 hands over its dV,
    // warpgroup 1 its dK, in the fragment's order, and each adds the other's
    // half to its own and stores it.
    float* x_s = reinterpret_cast<float*>(q_s);                 // [2][kDP / 2][kWG]
    float* mine = x_s + wg * (kDP / 2 * kWG);
    const float* theirs = x_s + (1 - wg) * (kDP / 2 * kWG);
    asm volatile("bar.sync 1, %0;" ::"n"(kW * kWG) : "memory");   // the compute threads
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < kDP / 2; ++i) mine[i * kWG + tid] = dv_acc[i];
    } else {
#pragma unroll
      for (int i = 0; i < kDP / 2; ++i) mine[i * kWG + tid] = dk_acc[i];
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kW * kWG) : "memory");
    const long long krow = (long long)Hkv * D;
    const long long at = ((long long)b * Skv + k0) * krow + (long long)hk * D;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < kDP / 2; ++i) dk_acc[i] += theirs[i * kWG + tid];
      store_frag<D, kDP>(dk + at, dk_acc, scale, r0, Skv - k0, krow, lane);
    } else {
#pragma unroll
      for (int i = 0; i < kDP / 2; ++i) dv_acc[i] += theirs[i * kWG + tid];
      store_frag<D, kDP>(dv + at, dv_acc, 1.f, r0, Skv - k0, krow, lane);
    }
  }
}

// dQ for 64 kW query rows of one query head, over the keys they see.
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap gmap, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B, int Sq,
                int Skv, int Hq, int Hkv, int causal, float scale, float scale_log2) {
  constexpr int kBoxes = boxes(D);
  constexpr int kDP = 64 * kBoxes;
  constexpr int kTile = tile_bytes(D);
  constexpr int kS = dq_stages(D);
  // the last query run first: under causal masking it sees every key
  const int nqt = (Sq + kWRows - 1) / kWRows;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / (Hq * B))) * kWRows;
  const int h = blockIdx.x % Hq;
  const int b = (blockIdx.x / Hq) % B;
  const int hk = h / (Hq / Hkv);
  const int off = Skv - Sq;
  // keys past the causal limit of the run's last row are masked for all of it
  const int kend = causal ? min(Skv, min(q0 + kWRows, Sq) + off) : Skv;
  const int n = (kend + 63) / 64;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                                    // [kW] tiles
  unsigned char* g_s = q_s + kW * kTile;                        // [kW], dO
  unsigned char* k_s = g_s + kW * kTile;                        // [kS] ring
  unsigned char* v_s = k_s + kS * kTile;                        // [kS] ring
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kS * kTile);   // Q/dO, full, empty
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kS;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kW * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);   // as in dkdv
  const int lane = threadIdx.x % 32;
  if (wg == kW) {
    // the producer warpgroup: one thread loads, the others leave
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % kWG != 0) return;
    mbar_expect_tx(&bars[0], 2 * kW * kTile);
#pragma unroll
    for (int w = 0; w < kW; ++w)
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(q_s + w * kTile + x * kAtom, &qmap, &bars[0], 64 * x, h, q0 + 64 * w, b);
        tma_load(g_s + w * kTile + x * kAtom, &gmap, &bars[0], 64 * x, h, q0 + 64 * w, b);
      }
    for (int j = 0; j < n; ++j) {
      const int st = j % kS;
      if (j >= kS) mbar_wait(&empty[st], (j / kS - 1) & 1);
      mbar_expect_tx(&full[st], 2 * kTile);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(k_s + st * kTile + x * kAtom, &kmap, &full[st], 64 * x, hk, 64 * j, b);
        tma_load(v_s + st * kTile + x * kAtom, &vmap, &full[st], 64 * x, hk, 64 * j, b);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % kWG) / 32;
    const int q0w = q0 + 64 * wg;          // this warpgroup's query rows
    const int r0 = warp * 16 + lane / 4;   // its rows r0 and r0 + 8
    const int c0 = 2 * (lane & 3);         // its key columns c0 + 8 nn (+ 1)
    const int kend_w = q0w >= Sq ? 0 : causal ? min(Skv, min(q0w + 64, Sq) + off) : Skv;
    float lse2[2], dl[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {       // rows past Sq: 0 (their P is masked)
      const int row = q0w + r0 + 8 * rr;
      const long long at = ((long long)b * Hq + h) * Sq + row;
      lse2[rr] = row < Sq ? lse[at] * kLog2e : 0.f;
      dl[rr] = row < Sq ? delta[at] : 0.f;
    }
    const uint32_t q_addr = smem_u32(q_s + wg * kTile);
    const uint32_t g_addr = smem_u32(g_s + wg * kTile);
    float dq_acc[kDP / 2];
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(&bars[0], 0);

    for (int j = 0; j < n; ++j) {
      const int st = j % kS;
      const int t0 = 64 * j;
      mbar_wait(&full[st], (j / kS) & 1);
      if (t0 < kend_w) {
        const uint32_t k_addr = smem_u32(k_s + st * kTile);
        const uint32_t v_addr = smem_u32(v_s + st * kTile);
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        // S = Q.K^T and dP = dO.V^T: query rows on M, the tile's keys on N
        wgmma_fence();
        gemm_ss<D>(s, q_addr, k_addr);
        wgmma_commit();
        gemm_ss<D>(dp, g_addr, v_addr);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = fast_exp2(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
        if (t0 + 64 > Skv || q0w + 64 > Sq || (causal && t0 + 63 > q0w + off)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = t0 + 8 * (i >> 2) + c0 + (i & 1);
            const int row = q0w + r0 + 8 * ((i >> 1) & 1);
            if (key >= Skv || row >= Sq || (causal && key > row + off)) s[i] = 0.f;
          }
        }
        wgmma_wait_all();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
        // dQ += dS.K: the tile's keys are the k dimension
        wgmma_fence();
        gemm_rs<kDP>(dq_acc, dp, k_addr);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq_acc);
      }
      mbar_arrive(&empty[st]);
    }

    if (q0w < Sq) {
      const long long qrow = (long long)Hq * D;
      store_frag<D, kDP>(dq + ((long long)b * Sq + q0w) * qrow + (long long)h * D, dq_acc,
                         scale, r0, Sq - q0w, qrow, lane);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, void* dk, void* dv,
                         int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                         cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap, gmap;
  if (!encode_map(enc, &qmap, q, B, Sq, Hq, D) || !encode_map(enc, &gmap, dout, B, Sq, Hq, D) ||
      !encode_map(enc, &kmap, k, B, Skv, Hkv, D) || !encode_map(enc, &vmap, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  const long long n1 = (long long)((Skv + 63) / 64) * Hkv * B;
  const long long n2 = (long long)((Sq + kWRows - 1) / kWRows) * Hq * B;
  if (n1 >= (1ll << 31) || n2 >= (1ll << 31)) return cudaErrorInvalidConfiguration;
  auto* bq = static_cast<__nv_bfloat16*>(dq);
  auto* bk = static_cast<__nv_bfloat16*>(dk);
  auto* bv = static_cast<__nv_bfloat16*>(dv);
  const float sl2 = scale * kLog2e;
  cudaError_t e = cudaFuncSetAttribute(dkdv_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)dkdv_wgmma_smem_bytes(D));
  if (e != cudaSuccess) return e;
  dkdv_wgmma_kernel<D><<<(unsigned)n1, kWThreads, dkdv_wgmma_smem_bytes(D), stream>>>(
      qmap, kmap, vmap, gmap, lse, delta, bk, bv, B, Sq, Skv, Hq, Hkv, causal, scale, sl2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dq_wgmma_smem_bytes(D));
  if (e != cudaSuccess) return e;
  dq_wgmma_kernel<D><<<(unsigned)n2, kWThreads, dq_wgmma_smem_bytes(D), stream>>>(
      qmap, kmap, vmap, gmap, lse, delta, bq, B, Sq, Skv, Hq, Hkv, causal, scale, sl2);
  return cudaGetLastError();
}

// The two tile kernels of the f32 body (CUDA cores) or of the bf16 one at
// D = 192 (mma.sync).  Both take (q, k, v, dout, lse, delta, out...,
// Sq, Skv, Hq, Hkv, causal, scale).
template <typename T, typename DkDv, typename Dq>
cudaError_t launch_tiles(DkDv dkdv, size_t s1, Dq dqk, size_t s2, const T* q, const T* k,
                         const T* v, const T* dout, const float* lse, const float* delta, T* dq,
                         T* dk, T* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                         float scale, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return e;
  dim3 g1((unsigned)((Skv + kBK - 1) / kBK), (unsigned)Hkv, (unsigned)B);
  dkdv<<<g1, kThreads, s1, stream>>>(q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv,
                                     causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return e;
  dim3 g2((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  dqk<<<g2, kThreads, s2, stream>>>(q, k, v, dout, lse, delta, dq, Sq, Skv, Hq, Hkv, causal,
                                    scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const long long rows = (long long)B * Sq * Hq;
  constexpr int kC = D * (int)sizeof(T) / 16;
  constexpr int kL = kC <= 2 ? 2 : kC <= 4 ? 4 : kC <= 8 ? 8 : kC <= 16 ? 16 : 32;
  const unsigned dblocks = (unsigned)((rows + kThreads / kL - 1) / (kThreads / kL));
  delta_kernel<T, D><<<dblocks, kThreads, 0, stream>>>(static_cast<const T*>(o), gt, delta, B,
                                                         Sq, Hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if constexpr (std::is_same<T, float>::value)
    return launch_tiles(dkdv_kernel<D>, dkdv_smem_bytes<D>(), dq_kernel<D>,
                        dq_smem_bytes<D>(), qt, kt, vt, gt, lse, delta, dqt, dkt, dvt, B, Sq,
                        Skv, Hq, Hkv, causal, scale, stream);
  else if constexpr (D <= 128)
    return launch_wgmma<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                           scale, stream);
  else
    return launch_tiles(dkdv_mma_kernel<D>, dkdv_mma_smem_bytes<D>(), dq_mma_kernel<D>,
                        dq_mma_smem_bytes<D>(), qt, kt, vt, gt, lse, delta, dqt, dkt, dvt, B,
                        Sq, Skv, Hq, Hkv, causal, scale, stream);
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                         float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                            causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                    Hkv, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o/dout/dq [B,Sq,Hq,D], k/v/dk/dv
// [B,Skv,Hkv,D], contiguous and 16-byte aligned; lse [B,Hq,Sq] f32 from the
// forward; delta [B,Hq,Sq] f32 scratch.  D in {16, 32, 64, 96, 128, 192};
// Hq % Hkv == 0; a causal call needs Sq <= Skv.  Returns cudaGetLastError()
// after the last launch.
extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         const float* lse, float* delta, void* dq, void* dk,
                                         void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                                         int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_CASE(DD)                                                                  \
  case DD:                                                                                  \
    return launch_dtype<DD>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, \
                            Hkv, causal, scale, s);
  switch (D) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(96)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(192)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_CASE
}
