// ssd_scan — the chunked Mamba-2 SSD (state-space duality) scan on Hopper.
//
// Replaces the TPU kernel `ssd_scan` of src/repro/kernels/ssd_scan.py.  With
// x [B, S, nh, hd], dt [B, S, nh] (post-softplus, f32), a_neg [nh] (f32),
// B and C [B, S, G, N] and an optional initial state h0 [B, nh, hd, N] (f32),
// it walks the chunks of Q tokens of each (batch row, head) in order and,
// per chunk, with cum the inclusive cumulative sum of dt * a within the chunk:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra-chunk)
//        + exp(cum_i) (C_i . h^T)                                    (incoming state)
//   h   <- h exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// and writes y [B, S, nh, hd] in x's type and the final state h [B, nh, hd, N]
// in f32.  Head h reads group h / (nh / G), as jnp.repeat does.
//
// The Pallas grid is (B, chunks) with the chunks sequential and the state of
// every head in VMEM scratch.  Hopper blocks run in no order, so here one
// block walks the chunks of its (batch row, heads) itself, keeping the state
// on chip from the first chunk to the last: no chunk state goes to device
// memory.
//
// Masking.  Scores with j > i are never used: the exponent there is
// positive and would overflow (the Pallas kernel writes -1e30 before its exp
// for the same reason).  A ragged last chunk is masked, not padded in
// memory: only its n valid rows are read and written, and cum stays flat
// past them, which is what the reference's zero padding gives (dt = 0 leaves
// h unchanged).
//
// What bounds it on the H100: per chunk about Q^2 N / 2 multiply-adds for
// C.B^T per group and Q^2 hd / 2 + 2 Q hd N per head, against x, B, C, dt
// read once and y written once: some 120 flops per byte at the mamba2-780m
// serving shape (x [8,512,48,64], B/C [8,512,1,128], Q 128), below the
// tensor cores' 295 a byte, so the bytes bound it.  In practice the chain
// from chunk to chunk does: a chunk's state update must finish before the
// next chunk's read-out.
//
// bf16 (ssd_mma_kernel): a block owns a batch row and HPB heads of one
// group: 2 heads and 16 warps where the group has an even number of heads
// and B * nh / 2 blocks still cover the SMs (mamba2's 8 x 48), else 1 head
// and 8 warps, two blocks an SM.  Per chunk:
//   * C.B^T once for the group: its lower-triangle 16 x 16 tiles spread
//     over every warp and wait in shared memory in fragment order.
//   * y: an item is (head, 16 chunk rows, 64 or 32 columns), the heaviest
//     rows first.  C.h^T for the incoming state, then the group's C.B^T
//     tiles decayed for the head on the fragment (exp(cum_i - cum_j) dt_j;
//     off the diagonal as exp(cum_i - cum_i0) exp(cum_i0 - cum_j), both at
//     most 1), which is already the A fragment of (scores).(x).
//   * the state update (w x)^T.B, in tiles of 16 x 64 over every warp.
// All products run on mma.sync m16n8k16 bf16 -> f32 with ldmatrix from bf16
// tiles in shared memory.  No f32 operand is rounded to one bf16: the
// scores, w_j x_j and the state are each split into bf16 hi + lo and take
// two mmas (relative error near 2^-16).  The state lives in shared memory as
// that pair, 4 bytes an element like f32: the read-out takes the pair as it
// is; the update adds in f32 and splits again.  x, dt, B and C come in by
// cp.async (x, B and C as bf16, half the f32 tiles' bytes), rows padded by
// 16 bytes so ldmatrix hits distinct banks, short dims zero-padded to the
// MMA tile; the next chunk's dt is in flight during this chunk, its C
// during the state update, its x and B after it.  At mamba2's shape the
// block takes 212 KB of shared memory, so one runs per SM.
// f32 (ssd_kernel) keeps the CUDA-core body: TF32 or bf16 products
// cannot hold the f32 parity band of 2e-4.  One block per (batch row, head);
// each of the 256 threads holds a 4 x 4 patch of each product's output over
// f32 shared rows padded by one float; x, B and h stay for the whole chunk
// while C and the score rows go in tiles of 64 (195 KB at mamba2's shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;                    // chunk rows per tile of C and scores
constexpr int kTR = 4;                     // output rows per thread patch
constexpr int kTC = 4;                     // output columns per thread patch
constexpr int kMaxChunk = 256;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Offsets (in floats) of the shared arrays; each row padded by one float.
struct Layout {
  int ldh, ldx, ldb, ldp;
  int h, x, b, c, p, cum, w, total;
};

__host__ __device__ inline Layout make_layout(int hd, int N, int Q) {
  Layout L;
  const int qt = Q < kQT ? Q : kQT;
  L.ldh = N + 1;
  L.ldx = hd + 1;
  L.ldb = N + 1;
  L.ldp = Q + 1;
  L.h = 0;                                 // state      [hd][N]
  L.x = L.h + hd * L.ldh;                  // x chunk    [Q][hd]
  L.b = L.x + Q * L.ldx;                   // B chunk    [Q][N]
  L.c = L.b + Q * L.ldb;                   // C row tile [qt][N]
  L.p = L.c + qt * L.ldb;                  // scores     [qt][Q]
  L.cum = L.p + qt * L.ldp;                // cumsum of dt*a [Q]
  L.w = L.cum + Q;                         // dt, then the state weights [Q]
  L.total = L.w + Q;
  return L;
}

// One thread's patch of an R x C product: rows r0 + i*nrt, columns c0 + j*nct
// (strided, so that neighbouring threads take neighbouring columns), clamped
// into range so that every read stays inside its array; callers drop the
// clamped rows and columns when they write.
struct Patch {
  int r[kTR], c[kTC];
  bool rok[kTR], cok[kTC];
};

__device__ __forceinline__ Patch make_patch(int tile, int R, int C) {
  const int nrt = (R + kTR - 1) / kTR, nct = (C + kTC - 1) / kTC;
  const int rt = tile / nct, ct = tile - rt * nct;
  Patch P;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rt + i * nrt;
    P.rok[i] = r < R;
    P.r[i] = P.rok[i] ? r : R - 1;
  }
#pragma unroll
  for (int j = 0; j < kTC; ++j) {
    const int c = ct + j * nct;
    P.cok[j] = c < C;
    P.c[j] = P.cok[j] ? c : C - 1;
  }
  return P;
}

__device__ __forceinline__ int n_tiles(int R, int C) {
  return ((R + kTR - 1) / kTR) * ((C + kTC - 1) / kTC);
}

// acc[i][j] += sum_{k < K} A(r_i, k) B(k, c_j), A(r, k) = a[r*ars + k*aks],
// B(k, c) = bm[k*bks + c*bcs], all in shared memory.
__device__ __forceinline__ void mma_patch(float (&acc)[kTR][kTC], const Patch& P,
                                          const float* a, int ars, int aks,
                                          const float* bm, int bks, int bcs, int K) {
  for (int k = 0; k < K; ++k) {
    float av[kTR], bv[kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i) av[i] = a[P.r[i] * ars + k * aks];
#pragma unroll
    for (int j = 0; j < kTC; ++j) bv[j] = bm[k * bks + P.c[j] * bcs];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTR][kTC]) {
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
}

// rows [0, n) of `width` elements, `stride` elements apart in global memory,
// into f32 shared rows of stride ld
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long stride, int n,
                                          int width, float* dst, int ld) {
  for (int e = threadIdx.x; e < n * width; e += kThreads) {
    const int j = e / width, d = e - j * width;
    dst[j * ld + d] = to_float(src[(long long)j * stride + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_neg, const T* __restrict__ bmat,
           const T* __restrict__ cmat, const float* __restrict__ h0, T* __restrict__ y,
           float* __restrict__ hout, int S, int nh, int hd, int G, int N, int Q) {
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = h / (nh / G);
  const int tid = threadIdx.x;
  const Layout L = make_layout(hd, N, Q);
  extern __shared__ float smem[];
  float* h_s = smem + L.h;
  float* x_s = smem + L.x;
  float* b_s = smem + L.b;
  float* c_s = smem + L.c;
  float* p_s = smem + L.p;
  float* cum_s = smem + L.cum;
  float* w_s = smem + L.w;
  const float a = a_neg[h];

  const float* h0b = h0 ? h0 + ((long long)bi * nh + h) * hd * N : nullptr;
  for (int e = tid; e < hd * N; e += kThreads) {
    const int d = e / N, k = e - d * N;
    h_s[d * L.ldh + k] = h0b ? h0b[e] : 0.f;
  }

  const long long xrow = (long long)nh * hd;   // elements between consecutive tokens
  const long long brow = (long long)G * N;
  for (int t0 = 0; t0 < S; t0 += Q) {
    const int n = min(Q, S - t0);
    const long long tok = (long long)bi * S + t0;
    __syncthreads();                       // the last chunk's state update is done
    load_rows<T>(x + tok * xrow + (long long)h * hd, xrow, n, hd, x_s, L.ldx);
    load_rows<T>(bmat + tok * brow + (long long)g * N, brow, n, N, b_s, L.ldb);
    for (int j = tid; j < Q; j += kThreads) w_s[j] = j < n ? dt[(tok + j) * nh + h] : 0.f;
    __syncthreads();
    if (tid < 32) {                        // inclusive cumsum of dt * a by one warp
      const int per = (Q + 31) / 32, j0 = tid * per;
      float tot = 0.f;
      for (int k = 0; k < per; ++k)
        if (j0 + k < Q) tot += w_s[j0 + k] * a;
      float incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float run = incl - tot;
      for (int k = 0; k < per; ++k)
        if (j0 + k < Q) {
          run += w_s[j0 + k] * a;
          cum_s[j0 + k] = run;
        }
    }
    __syncthreads();

    for (int i0 = 0; i0 < n; i0 += kQT) {
      const int R = min(kQT, n - i0);
      const int jmax = i0 + R;             // rows j > i0 + R - 1 are masked for every row
      load_rows<T>(cmat + (tok + i0) * brow + (long long)g * N, brow, R, N, c_s, L.ldb);
      __syncthreads();
      // scores p[r][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
      for (int tile = tid; tile < n_tiles(R, jmax); tile += kThreads) {
        const Patch P = make_patch(tile, R, jmax);
        float acc[kTR][kTC];
        zero(acc);
        mma_patch(acc, P, c_s, L.ldb, 1, b_s, 1, L.ldb, N);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int i = i0 + P.r[ii];
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int j = P.c[jj];
            p_s[P.r[ii] * L.ldp + j] =
                j <= i ? acc[ii][jj] * expf(cum_s[i] - cum_s[j]) * w_s[j] : 0.f;
          }
        }
      }
      __syncthreads();
      // y[r][d] = sum_j p[r][j] x[j][d] + exp(cum_i) sum_k C[r][k] h[d][k]
      for (int tile = tid; tile < n_tiles(R, hd); tile += kThreads) {
        const Patch P = make_patch(tile, R, hd);
        float diag[kTR][kTC], off[kTR][kTC];
        zero(diag);
        zero(off);
        mma_patch(diag, P, p_s, L.ldp, 1, x_s, L.ldx, 1, jmax);
        mma_patch(off, P, c_s, L.ldb, 1, h_s, 1, L.ldh, N);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int i = i0 + P.r[ii];
          const float decay = expf(cum_s[i]);
          T* yr = y + (tok + i) * xrow + (long long)h * hd;
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj)
            if (P.cok[jj]) yr[P.c[jj]] = from_float<T>(diag[ii][jj] + decay * off[ii][jj]);
        }
      }
      __syncthreads();                     // c_s and p_s are free for the next tile
    }

    // h <- h exp(cum_last) + sum_j (exp(cum_last - cum_j) dt_j x_j) (x) B_j
    const float last = cum_s[n - 1];
    for (int e = tid; e < n * hd; e += kThreads) {
      const int j = e / hd, d = e - j * hd;
      x_s[j * L.ldx + d] *= expf(last - cum_s[j]) * w_s[j];
    }
    __syncthreads();
    const float chunk_decay = expf(last);
    for (int tile = tid; tile < n_tiles(hd, N); tile += kThreads) {
      const Patch P = make_patch(tile, hd, N);
      float acc[kTR][kTC];
      zero(acc);
      mma_patch(acc, P, x_s, 1, L.ldx, b_s, L.ldb, 1, n);
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        if (!P.rok[ii]) continue;
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          if (!P.cok[jj]) continue;
          float* hv = h_s + P.r[ii] * L.ldh + P.c[jj];
          *hv = *hv * chunk_decay + acc[ii][jj];
        }
      }
    }
  }
  __syncthreads();
  float* ho = hout + ((long long)bi * nh + h) * hd * N;
  for (int e = tid; e < hd * N; e += kThreads) {
    const int d = e / N, k = e - d * N;
    ho[e] = h_s[d * L.ldh + k];
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTerms = 2;                  // bf16 terms an f32 operand is split into

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Offsets (in bytes) of the bf16 body's shared arrays.  Rows of the bf16
// tiles are padded by 8 elements, so that ldmatrix spreads over the banks.
struct MmaLayout {
  int qp, hp, np;                          // Q, hd, N rounded up to 16
  int ldx, ldb;                            // row strides in elements
  int ntile;                               // lower-triangle 16 x 16 tiles of C.B^T
  int h, x, b, c, cb, dt, cum, w, last, total;
};

__host__ __device__ inline MmaLayout make_mma_layout(int hd, int N, int Q, int hpb) {
  MmaLayout L;
  L.qp = round16(Q);
  L.hp = round16(hd);
  L.np = round16(N);
  L.ldx = L.hp + 8;
  L.ldb = L.np + 8;
  L.h = 0;                                           // state terms [kTerms][hpb][hp][ldb]
  L.x = L.h + kTerms * 2 * hpb * L.hp * L.ldb;       // bf16 x     [hpb][qp][ldx]
  L.b = L.x + 2 * hpb * L.qp * L.ldx;                // bf16 B     [qp][ldb]
  L.c = L.b + 2 * L.qp * L.ldb;                      // bf16 C     [qp][ldb]
  L.ntile = (L.qp / 16) * (L.qp / 16 + 1) / 2;
  L.cb = L.c + 2 * L.qp * L.ldb;                     // f32 C.B^T tiles [ntile][32 lanes][8]
  L.dt = L.cb + 4 * 256 * L.ntile;                   // f32 dt, 0 past the chunk [2][hpb][qp]
  L.cum = L.dt + 2 * 4 * hpb * L.qp;                 // f32 cumsum of dt*a [hpb][qp]
  L.w = L.cum + 4 * hpb * L.qp;                      // f32 state weights [hpb][qp]
  L.last = L.w + 4 * hpb * L.qp;                     // f32 cum of the last row [hpb]
  L.total = L.last + 4 * hpb;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a, b) as kTerms bf16 pairs whose sum is (a, b) to about 2^(-8 kTerms - 1):
// each term takes the rounding error of the last.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    t[k] = bits(h);
    a -= hf.x;
    b -= hf.y;
  }
}

// Rows [0, rows) x columns [0, width) of a global bf16 matrix whose rows are
// `stride` elements apart, into the shared tile dst [qp][ld] (ld elements a
// row), zeros past them up to qp rows and `wp` columns, by the block's first
// `nthreads` threads.  16-byte cp.async where every row is 16-byte aligned
// (`vec`), else plain loads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long stride, int rows, int width, int qp,
                                          int wp, bool vec, int nthreads) {
  if (vec) {
    const int per = wp / 8;
    for (int e = threadIdx.x; e < qp * per; e += nthreads) {
      const int r = e / per, c = (e - r * per) * 8;
      const bool ok = r < rows && c < width;
      const __nv_bfloat16* s = ok ? src + r * stride + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_u32(dst + r * ld + c)),
                   "l"(s), "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < qp * wp; e += nthreads) {
      const int r = e / wp, c = e - r * wp;
      dst[r * ld + c] = r < rows && c < width ? src[r * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// dt [rows, hpb] (rows nh floats apart) into dst [hpb][qp], zeros past `rows`.
__device__ __forceinline__ void load_dt(float* dst, int qp, const float* src, int nh, int rows,
                                        int hpb, int nthreads) {
  for (int e = threadIdx.x; e < hpb * qp; e += nthreads) {
    const int hh = e / qp, j = e - hh * qp;
    const bool ok = j < rows;
    const float* s = ok ? src + (long long)j * nh + hh : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst + e)),
                 "l"(s), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// The f32 value of a state element held as kTerms bf16 terms `term` apart.
__device__ __forceinline__ float sum_terms(const __nv_bfloat16* q, int term) {
  float v = 0.f;
#pragma unroll
  for (int t = 0; t < kTerms; ++t) v += __bfloat162float(q[t * term]);
  return v;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits for every committed group but the newest.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Fragments of mma m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8, columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3); B holds
// rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g; C holds rows g
// (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
template <int HPB, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
ssd_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_neg, const __nv_bfloat16* __restrict__ bmat,
               const __nv_bfloat16* __restrict__ cmat, const float* __restrict__ h0,
               __nv_bfloat16* __restrict__ y, float* __restrict__ hout, int S, int nh, int hd,
               int G, int N, int Q, int vec) {
  const int hb = blockIdx.x * HPB;         // the block's first head
  const int bi = blockIdx.y;
  const int g = hb / (nh / G);             // every head of the block is in group g
  constexpr int kThreadsB = WARPS * 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const MmaLayout L = make_mma_layout(hd, N, Q, HPB);
  const int qp = L.qp, ldx = L.ldx, ldb = L.ldb;
  const int term = HPB * L.hp * ldb;       // elements between the state's three terms
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.h);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.x);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.b);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.c);
  float* cb_s = reinterpret_cast<float*>(smem_raw + L.cb);
  float* dt_s = reinterpret_cast<float*>(smem_raw + L.dt);
  float* cum_s = reinterpret_cast<float*>(smem_raw + L.cum);
  float* w_s = reinterpret_cast<float*>(smem_raw + L.w);
  float* last_s = reinterpret_cast<float*>(smem_raw + L.last);

  for (int e = tid; e < HPB * L.hp * (L.np / 2); e += kThreadsB) {
    const int hh = e / (L.hp * (L.np / 2)), r = e - hh * L.hp * (L.np / 2);
    const int d = r / (L.np / 2), k = 2 * (r - d * (L.np / 2));
    const float* src = h0 + (((long long)bi * nh + hb + hh) * hd + d) * N + k;
    const bool ok = h0 && d < hd;
    uint32_t* p = reinterpret_cast<uint32_t*>(h_s + (hh * L.hp + d) * ldb + k);
    uint32_t v[kTerms];
    split_bf16(ok && k < N ? src[0] : 0.f, ok && k + 1 < N ? src[1] : 0.f, v);
#pragma unroll
    for (int t = 0; t < kTerms; ++t) p[t * (term / 2)] = v[t];
  }

  const long long xrow = (long long)nh * hd;   // elements between consecutive tokens
  const long long brow = (long long)G * N;
  const int nchunks = (S + Q - 1) / Q;
  auto load_x = [&](int c) {
    const long long tok = (long long)bi * S + (long long)c * Q;
    for (int hh = 0; hh < HPB; ++hh)
      load_tile(x_s + hh * qp * ldx, ldx, x + tok * xrow + (long long)(hb + hh) * hd, xrow,
                min(Q, S - c * Q), hd, qp, L.hp, vec, kThreadsB);
  };
  auto load_dt_c = [&](int c) {            // into the buffer of chunk c's parity
    const long long tok = (long long)bi * S + (long long)c * Q;
    load_dt(dt_s + (c & 1) * HPB * qp, qp, dt + tok * nh + hb, nh, min(Q, S - c * Q), HPB,
            kThreadsB);
  };
  auto load_bc = [&](int c, __nv_bfloat16* dst, const __nv_bfloat16* src) {
    const long long tok = (long long)bi * S + (long long)c * Q;
    load_tile(dst, ldb, src + tok * brow + (long long)g * N, brow, min(Q, S - c * Q), N, qp,
              L.np, vec, kThreadsB);
  };
  load_x(0);
  load_dt_c(0);
  load_bc(0, b_s, bmat);
  load_bc(0, c_s, cmat);
  cp_async_commit();

  for (int c = 0; c < nchunks; ++c) {
    const int n = min(Q, S - c * Q);
    const long long tok = (long long)bi * S + (long long)c * Q;
    if (c + 1 < nchunks) load_dt_c(c + 1);   // its buffer was last read by chunk c - 1
    cp_async_commit();
    cp_async_wait_but_newest();              // this chunk's x, dt, B and C have landed
    __syncthreads();
    const float* dtc = dt_s + (c & 1) * HPB * qp;

    if (warp < HPB) {                      // cum and the state weights: a warp a head
      const int hh = warp;
      const float a = a_neg[hb + hh];
      const float* dtv = dtc + hh * qp;
      float* cum = cum_s + hh * qp;
      const int per = (qp + 31) / 32, j0 = lane * per;
      float tot = 0.f;
      for (int k = 0; k < per && j0 + k < qp; ++k) tot += dtv[j0 + k] * a;
      float incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float run = incl - tot;
      for (int k = 0; k < per && j0 + k < qp; ++k) {
        run += dtv[j0 + k] * a;
        cum[j0 + k] = run;
      }
      __syncwarp();
      const float last = cum[n - 1];
      for (int k = 0; k < per && j0 + k < qp; ++k)
        w_s[hh * qp + j0 + k] = expf(last - cum[j0 + k]) * dtv[j0 + k];
      if (lane == 0) last_s[hh] = last;
    }

    // C.B^T once for the group: the lower-triangle tiles (row block rb,
    // column block cb <= rb) spread over every warp, each kept in shared
    // memory in its fragment's order
    const int nrb = (n + 15) / 16;
    for (int t = warp; t < nrb * (nrb + 1) / 2; t += WARPS) {
      int rb = 0;
      while ((rb + 1) * (rb + 2) / 2 <= t) ++rb;
      const int cb = t - rb * (rb + 1) / 2;
      const uint32_t c_addr = smem_u32(c_s + (rb * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldb +
                                       8 * (lane >> 4));
      const uint32_t b_addr = smem_u32(b_s + (cb * 16 + (lane & 7) + 8 * (lane >> 4)) * ldb +
                                       8 * ((lane >> 3) & 1));
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < L.np; k0 += 16) {
        uint32_t ca[4], bb[4];
        ldsm_x4(ca, c_addr + 2 * k0);
        ldsm_x4(bb, b_addr + 2 * k0);
        mma_bf16(sc[0], ca, bb[0], bb[1]);
        mma_bf16(sc[1], ca, bb[2], bb[3]);
      }
      float4* dst = reinterpret_cast<float4*>(cb_s + (t * 32 + lane) * 8);
      dst[0] = make_float4(sc[0][0], sc[0][1], sc[0][2], sc[0][3]);
      dst[1] = make_float4(sc[1][0], sc[1][1], sc[1][2], sc[1][3]);
    }
    __syncthreads();

    // y: an item is (head, 16 chunk rows, 64 columns), or 32 columns where
    // that leaves warps idle; every warp takes items, the heaviest rows first
    const int wcols = nrb * ((L.hp + 63) / 64) * HPB >= WARPS ? 64 : 32;
    const int ncb = (L.hp + wcols - 1) / wcols;
    const int nitems = HPB * nrb * ncb;
    for (int it = warp; it < nitems; it += WARPS) {
      const int rb = nrb - 1 - it / (HPB * ncb), rem = it % (HPB * ncb);
      const int hh = rem / ncb, c0 = rem % ncb * wcols;
      const int cend = min(L.hp, c0 + wcols);
      const int i0 = rb * 16, ia = i0 + gr, ib = ia + 8;
      const float* cum = cum_s + hh * qp;
      const float* dtv = dtc + hh * qp;
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

      // the incoming state: exp(cum_i) C_i . h^T over the state's bf16 terms
      const uint32_t c_addr =
          smem_u32(c_s + (i0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldb + 8 * (lane >> 4));
      const uint32_t h_addr = smem_u32(
          h_s + (hh * L.hp + c0 + (lane & 7) + 8 * (lane >> 4)) * ldb + 8 * ((lane >> 3) & 1));
      for (int k0 = 0; k0 < L.np; k0 += 16) {
        uint32_t ca[4];
        ldsm_x4(ca, c_addr + 2 * k0);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (c0 + nt * 8 >= cend) break;
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            uint32_t bh[4];
            ldsm_x4(bh, h_addr + 2 * (nt * 8 * ldb + k0 + t * term));
            mma_bf16(acc[nt], ca, bh[0], bh[1]);
            mma_bf16(acc[nt + 1], ca, bh[2], bh[3]);
          }
        }
      }
      {
        const float ea = expf(cum[ia]), eb = expf(cum[ib]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }

      // within the chunk: the group's C.B^T tiles decayed for this head on
      // the fragment (split into bf16 terms), times x; column blocks past the
      // row block are all j > i
      const float ea = expf(cum[ia] - cum[i0]), eb = expf(cum[ib] - cum[i0]);
      const uint32_t x_addr =
          smem_u32(x_s + hh * qp * ldx + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldx + c0 +
                   8 * (lane >> 4));
      for (int cb = 0; cb <= rb; ++cb) {
        const int j0 = cb * 16;
        const float4* src =
            reinterpret_cast<const float4*>(cb_s + ((rb * (rb + 1) / 2 + cb) * 32 + lane) * 8);
        const float4 s0 = src[0], s1 = src[1];
        const float sc[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
        float p[2][4];
        if (cb < rb) {
          // every j < i0 <= i: exp(cum_i - cum_j) = exp(cum_i - cum_i0)
          // exp(cum_i0 - cum_j), both factors at most 1, the second shared by
          // the two rows: four exponentials, not eight
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + 8 * t + 2 * tc + e;
              const float fj = expf(cum[i0] - cum[j]) * dtv[j];
              p[t][e] = sc[t][e] * ea * fj;
              p[t][e + 2] = sc[t][e + 2] * eb * fj;
            }
        } else {
          // the diagonal block, branch-free so the exponentials overlap: for
          // j > i the exponent (positive there) is clamped to 0 and the score
          // dropped
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ia : ib;
              const int j = j0 + 8 * t + 2 * tc + (e & 1);
              const float f = expf(fminf(cum[i] - cum[j], 0.f));
              p[t][e] = j <= i ? sc[t][e] * f * dtv[j] : 0.f;
            }
        }
        uint32_t pt[kTerms][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t v[kTerms];
          split_bf16(p[q / 2][2 * (q % 2)], p[q / 2][2 * (q % 2) + 1], v);
#pragma unroll
          for (int t = 0; t < kTerms; ++t) pt[t][q] = v[t];
        }
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (c0 + nt * 8 >= cend) break;
          uint32_t xb[4];
          ldsm_x4_trans(xb, x_addr + 2 * (j0 * ldx + nt * 8));
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            mma_bf16(acc[nt], pt[t], xb[0], xb[1]);
            mma_bf16(acc[nt + 1], pt[t], xb[2], xb[3]);
          }
        }
      }

#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r ? ib : ia, col = c0 + nt * 8 + 2 * tc;
          if (i >= n || col >= hd || c0 + nt * 8 >= cend) continue;
          __nv_bfloat16* dst = y + (tok + i) * xrow + (long long)(hb + hh) * hd + col;
          const float v0 = acc[nt][2 * r], v1 = acc[nt][2 * r + 1];
          if ((hd & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16(v0);
            if (col + 1 < hd) dst[1] = __float2bfloat16(v1);
          }
        }
    }
    __syncthreads();                       // C and the state are read
    if (c + 1 < nchunks) load_bc(c + 1, c_s, cmat);

    // h <- h exp(cum_last) + (w x)^T . B, w x split into bf16 terms; a warp
    // takes tiles of 16 rows (hd) by 64 columns (N)
    {
      const int ndt = L.hp / 16, nnb = (L.np + 63) / 64;
      for (int tt = warp; tt < HPB * ndt * nnb; tt += WARPS) {
        const int hh = tt / (ndt * nnb), rem = tt - hh * ndt * nnb;
        const int d0 = rem / nnb * 16, n0 = rem % nnb * 64;
        const float decay = expf(last_s[hh]);
        const float* w = w_s + hh * qp;
        // this thread's state elements: rows d0 + g and d0 + g + 8
        __nv_bfloat16* ha = h_s + (hh * L.hp + d0 + gr) * ldb + n0 + 2 * tc;
        const int r8 = 8 * ldb;
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (n0 + nt * 8 >= L.np) break;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 v = make_float2(0.f, 0.f);
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(ha + nt * 8 + r * r8 + t * term));
              v.x += f.x;
              v.y += f.y;
            }
            acc[nt][2 * r] = v.x * decay;
            acc[nt][2 * r + 1] = v.y * decay;
          }
        }
        const uint32_t x_addr =
            smem_u32(x_s + hh * qp * ldx + ((lane & 7) + 8 * (lane >> 4)) * ldx + d0 +
                     8 * ((lane >> 3) & 1));
        const uint32_t b_addr =
            smem_u32(b_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldb + n0 + 8 * (lane >> 4));
        for (int j0 = 0; j0 < n; j0 += 16) {
          uint32_t xa[4], at[kTerms][4];
          ldsm_x4_trans(xa, x_addr + 2 * j0 * ldx);
          const float wa0 = w[j0 + 2 * tc], wa1 = w[j0 + 2 * tc + 1];
          const float wb0 = w[j0 + 8 + 2 * tc], wb1 = w[j0 + 9 + 2 * tc];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v = unpack_bf16(xa[q]);
            uint32_t u[kTerms];
            split_bf16(v.x * (q < 2 ? wa0 : wb0), v.y * (q < 2 ? wa1 : wb1), u);
#pragma unroll
            for (int t = 0; t < kTerms; ++t) at[t][q] = u[t];
          }
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            if (n0 + nt * 8 >= L.np) break;
            uint32_t bb[4];
            ldsm_x4_trans(bb, b_addr + 2 * (j0 * ldb + nt * 8));
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
              mma_bf16(acc[nt], at[t], bb[0], bb[1]);
              mma_bf16(acc[nt + 1], at[t], bb[2], bb[3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (n0 + nt * 8 >= L.np) break;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t v[kTerms];
            split_bf16(acc[nt][2 * r], acc[nt][2 * r + 1], v);
            uint32_t* q = reinterpret_cast<uint32_t*>(ha + nt * 8 + r * r8);
#pragma unroll
            for (int t = 0; t < kTerms; ++t) q[t * (term / 2)] = v[t];
          }
        }
      }
    }
    __syncthreads();                       // x and B are free: the next chunk's come in now
    if (c + 1 < nchunks) {
      load_x(c + 1);
      load_bc(c + 1, b_s, bmat);
    }
    cp_async_commit();
  }

  for (int e = tid; e < HPB * hd * N; e += kThreadsB) {
    const int hh = e / (hd * N), r = e - hh * hd * N;
    const int d = r / N, k = r - d * N;
    const __nv_bfloat16* q = h_s + (hh * L.hp + d) * ldb + k;
    hout[((long long)bi * nh + hb) * hd * N + e] =
        sum_terms(q, term);
  }
}

constexpr int kMaxSmem = 232448;           // bytes of shared memory one block may use (H100)

template <int HPB, int WARPS>
cudaError_t launch_mma(const void* x, const float* dt, const float* a_neg, const void* bmat,
                       const void* cmat, const float* h0, void* y, float* hout, int B, int S,
                       int nh, int hd, int G, int N, int Q, cudaStream_t stream) {
  const int smem = make_mma_layout(hd, N, Q, HPB).total;
  cudaError_t e = cudaFuncSetAttribute(ssd_mma_kernel<HPB, WARPS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // 16-byte copies need every row of x, B and C to start on 16 bytes
  const int vec = hd % 8 == 0 && N % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bmat) |
                    reinterpret_cast<uintptr_t>(cmat)) & 15) == 0;
  dim3 grid((unsigned)(nh / HPB), (unsigned)B);
  ssd_mma_kernel<HPB, WARPS><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a_neg, static_cast<const __nv_bfloat16*>(bmat),
      static_cast<const __nv_bfloat16*>(cmat), h0, static_cast<__nv_bfloat16*>(y), hout, S, nh,
      hd, G, N, Q, vec);
  return cudaGetLastError();
}

// Two heads of a group a block where the group has an even number of heads,
// the B * nh / 2 blocks still cover the SMs and their shared memory fits; else one.
cudaError_t launch_bf16(const void* x, const float* dt, const float* a_neg, const void* bmat,
                        const void* cmat, const float* h0, void* y, float* hout, int B, int S,
                        int nh, int hd, int G, int N, int Q, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if ((nh / G) % 2 == 0 && (long long)B * nh / 2 >= sms &&
      make_mma_layout(hd, N, Q, 2).total <= kMaxSmem)
    return launch_mma<2, 16>(x, dt, a_neg, bmat, cmat, h0, y, hout, B, S, nh, hd, G, N, Q, s);
  return launch_mma<1, 8>(x, dt, a_neg, bmat, cmat, h0, y, hout, B, S, nh, hd, G, N, Q, s);
}

cudaError_t launch_f32(const void* x, const float* dt, const float* a_neg, const void* bmat,
                       const void* cmat, const float* h0, void* y, float* hout, int B, int S,
                       int nh, int hd, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)make_layout(hd, N, Q).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)nh, (unsigned)B);
  ssd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, a_neg, static_cast<const float*>(bmat),
      static_cast<const float*>(cmat), h0, static_cast<float*>(y), hout, S, nh, hd, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block needs at dtype code `dtype`, head dim hd,
// state N and chunk Q: for bf16, the least (one head a block).
extern "C" long long repro_ssd_scan_smem(int dtype, int hd, int N, int Q) {
  if (dtype == 1) return make_mma_layout(hd, N, Q, 1).total;
  return (long long)sizeof(float) * make_layout(hd, N, Q).total;
}

// dtype: 0 = float32 (ssd_kernel), 1 = bfloat16 (ssd_mma_kernel), of x, B, C
// and y.  x/y [B,S,nh,hd], dt [B,S,nh] f32, a_neg [nh] f32, B/C [B,S,G,N],
// h0 (or null) and hout [B,nh,hd,N] f32, all contiguous; nh % G == 0;
// 1 <= Q <= 256.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt, const void* a_neg,
                              const void* bmat, const void* cmat, const void* h0, void* y,
                              void* hout, int B, int S, int nh, int hd, int G, int N, int Q,
                              void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd <= 0 || G <= 0 || N <= 0 || nh % G || Q <= 0 ||
      Q > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_neg);
  const float* h0f = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hout);
  if (dtype == 0) return launch_f32(x, dtf, af, bmat, cmat, h0f, y, ho, B, S, nh, hd, G, N, Q, s);
  if (dtype == 1)
    return launch_bf16(x, dtf, af, bmat, cmat, h0f, y, ho, B, S, nh, hd, G, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
