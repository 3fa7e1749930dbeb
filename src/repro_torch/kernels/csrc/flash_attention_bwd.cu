// flash_attention_bwd — the gradient of whole-prompt attention on Hopper.
//
// The TPU package has no counterpart: its training step differentiates
// XLA's attention (`backend="xla"`, src/repro/models/registry.py:15), and
// none of its Pallas kernels has a custom_vjp.  The port trains through its
// forward kernel (flash_attention.cu), so that kernel's output needs a
// gradient that is a kernel too.  This is FlashAttention-2's backward:
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
// deterministic:
//   * delta_kernel: Delta [B, Hq, Sq] f32, one warp a row.
//   * dkdv: one block of 256 threads owns (batch row, KV head, tile of 64
//     keys), holds K and V in shared memory and dK, dV in registers, and
//     walks the G = Hq / Hkv query heads of its KV head and every query
//     tile that sees its keys (from the causal start on).  Summing the G
//     heads inside the block is what lets GQA go without atomics.
//   * dq: one block owns (batch row, query head, tile of 64 query rows) and
//     walks the key tiles up to the tile's causal limit, recomputing S and
//     dO.V^T (two products more than FA2 with atomic dQ).
//
// What bounds it on the H100: 5 products of 2 * pairs * D flops each over
// q, k, v, o, dO read and dq, dk, dv written once; at smollm's [8, 2048,
// 15:5, 64] causal that is some 150 flops a byte, so the tensor cores
// (989 TFLOP/s) bound it.
//
// bf16 (dkdv_mma_kernel, dq_mma_kernel): eight warps run the products on
// mma.sync m16n8k16 (bf16 in, f32 sums) with ldmatrix from bf16 tiles whose
// rows are padded by 16 bytes, so that the eight rows of an ldmatrix hit
// distinct banks; the transposed operands (P^T, dS^T, and dO, Q, K as the
// reduced dimension's rows) come through ldmatrix.trans from the same
// tiles.  P and dS are rounded to bf16 for their products, as FA2 does;
// tiles arrive by cp.async with zero fill past Sq and Skv.
// f32 (dkdv_kernel, dq_kernel) keeps the CUDA cores, which hold the f32
// band: a 16 x 16 thread grid, each thread a 4 x 4 patch of a 64 x 64
// score tile or 4 rows by D / 16 columns of an output tile, over f32
// shared rows padded to D + 1 floats; at D = 192 its shared memory is
// 231,424 bytes, one block an SM.  Neither body uses wgmma or TMA yet
// (ROADMAP.md, queue B).

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

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int Sq, int Hq, int D) {
  const long long r = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= (long long)B * Sq * Hq) return;
  // r walks [B, Sq, Hq] as the tensors do
  const T* a = o + r * D;
  const T* g = dout + r * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_float(a[d]), to_float(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
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
// bf16: the five products on the tensor cores (mma.sync m16n8k16, f32 sums)
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

// The two tile kernels of one body: the f32 one on the CUDA cores, the
// bf16 one on mma.sync.  Both take (q, k, v, dout, lse, delta, out...,
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
  const unsigned dblocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  delta_kernel<T><<<dblocks, kThreads, 0, stream>>>(static_cast<const T*>(o), gt, delta, B,
                                                      Sq, Hq, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if constexpr (std::is_same<T, float>::value)
    return launch_tiles(dkdv_kernel<D>, dkdv_smem_bytes<D>(), dq_kernel<D>,
                        dq_smem_bytes<D>(), qt, kt, vt, gt, lse, delta, dqt, dkt, dvt, B, Sq,
                        Skv, Hq, Hkv, causal, scale, stream);
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
