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
// in f32.  Head h reads group h / (nh / G), as jnp.repeat does.  All
// arithmetic is f32.
//
// The Pallas grid is (B, chunks) with the chunks sequential and the state of
// every head in VMEM scratch.  Hopper blocks run in no order, so here one
// block owns a (batch row, head) and loops over the chunks itself, keeping
// its state h [hd][N] in shared memory from the first chunk to the last.
//
// Shared memory.  At hd 64, N 128 and Q 128, f32 tiles of x, B, C, the Q x Q
// score matrix and h would take 256 KB, more than the 227 KB a block may
// have.  The block keeps x, B and h for the whole chunk and walks the
// chunk's rows in tiles of 64: C and the score rows of one tile at a time.
// That is 195 KB at the mamba2-780m shape, which needs the opt-in to large
// dynamic shared memory (cudaFuncSetAttribute).  Rows are padded by one
// float so that column-wise reads hit distinct banks.
//
// Masking.  Scores with j > i are never evaluated: the exponent there is
// positive and would overflow (the Pallas kernel writes -1e30 before its exp
// for the same reason).  A ragged last chunk is masked, not padded: only its
// n valid rows are read and written, and cum stays flat past them, which is
// what the reference's zero padding gives (dt = 0 leaves h unchanged).
//
// What bounds it on the H100: per chunk and head about Q^2 N / 2 + Q^2 hd / 2
// + 2 Q hd N multiply-adds against x, B, C, dt read once and y written once:
// some 30 flops per byte at the mamba2 serving shape, so the tensor cores'
// 989 TFLOP/s would leave it bound by bytes.  This first version computes in
// f32 on the CUDA cores: each of the 256 threads holds a 4 x 4 patch of each
// product's output, so one shared-memory read feeds two FMAs; C.B^T is
// recomputed per head rather than shared across a group's heads.  wgmma with
// TMA-fed tiles and a chunk-parallel state pass are left for later.

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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a_neg, const void* bmat,
                   const void* cmat, const float* h0, void* y, float* hout, int B, int S,
                   int nh, int hd, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)make_layout(hd, N, Q).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)nh, (unsigned)B);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_neg, static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), h0, static_cast<T*>(y), hout, S, nh, hd, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block needs at head dim hd, state N, chunk Q.
extern "C" long long repro_ssd_scan_smem(int hd, int N, int Q) {
  return (long long)sizeof(float) * make_layout(hd, N, Q).total;
}

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  x/y [B,S,nh,hd],
// dt [B,S,nh] f32, a_neg [nh] f32, B/C [B,S,G,N], h0 (or null) and hout
// [B,nh,hd,N] f32, all contiguous; nh % G == 0; 1 <= Q <= 256.  Returns
// cudaGetLastError() after the launch.
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
  if (dtype == 0)
    return launch<float>(x, dtf, af, bmat, cmat, h0f, y, ho, B, S, nh, hd, G, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, bmat, cmat, h0f, y, ho, B, S, nh, hd, G, N, Q,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
