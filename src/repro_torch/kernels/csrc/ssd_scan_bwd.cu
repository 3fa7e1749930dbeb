// ssd_scan_bwd — the gradient of the chunked Mamba-2 SSD scan on Hopper.
//
// The TPU package has no counterpart: its training step differentiates XLA's
// `ssd_chunked` (src/repro/models/ssm.py:97), and its Pallas `ssd_scan`
// (src/repro/kernels/ssd_scan.py:65) has no custom_vjp.  The port trains
// through its forward kernel (ssd_scan.cu), so that kernel's output needs a
// gradient that is a kernel too.  Per chunk, with cum the inclusive cumsum
// of dt * a within it, L_ij = exp(cum_i - cum_j) for i >= j, h_in the state
// entering the chunk and h_out the one leaving it, the forward computes
//   y_i   = sum_{j<=i} (C_i . B_j) L_ij dt_j x_j + exp(cum_i) C_i . h_in^T
//   h_out = exp(cum_last) h_in + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// and, from dy and dh_out (dh_final for the last chunk, zero when None),
// this file computes, with G_ij = L_ij dt_j (dy_i . x_j):
//   dh_in = exp(cum_last) dh_out + sum_i exp(cum_i) dy_i (x) C_i
//   dC_i  = sum_{j<=i} G_ij B_j + exp(cum_i) dy_i . h_in
//   dB_j  = sum_{i>=j} G_ij C_i + exp(cum_last - cum_j) dt_j x_j . dh_out
//   dxn_j = sum_{i>=j} (C_i . B_j) L_ij dy_i + exp(cum_last - cum_j) dh_out . B_j
//   dx_j  = dt_j dxn_j,  ddt_j = x_j . dxn_j + a dda_j,  da = sum dt_j dda_j
// where dda is the reverse cumsum within the chunk of
//   dcum_i = C_i . dC_i - B_i . dB_i  (per head)  + <dh_out, h_out> at the last row:
// the d/dcum share of every exp term (L_ij, exp(cum_i), exp(cum_last - cum_j),
// exp(cum_last)) collapses into those dot products.  dB and dC sum the heads
// of a group, da every token of every row.  (kernels/ref.py ssd_scan_bwd_ref
// is the same algebra in tensor code; the CPU tests hold it to autograd.)
//
// The states entering each chunk come from the forward, which writes them
// when asked ([B, nc, nh, hd, N] f32: 201 MB a layer at mamba2-780m's
// training shape; with remat one layer's copy is live).  The forward holds
// each one on chip anyway, so writing it costs 0.06 ms of bytes; recomputing
// them here would take a serial pass of its own over x, B and dt with the
// whole state update, the forward's critical chain.
//
// Three launches on one stream, no atomics, every sum in a fixed order, so
// two calls give the same bits:
//   * ssd_bwd_state_kernel, a block per (batch row, head): the reverse state
//     pass, serial over the chunks like the forward.  It writes dh_out of
//     every chunk, <dh_out, h_out> per chunk and dh0.
//   * ssd_bwd_chunk_kernel, a block per (chunk, group, slice of the group's
//     heads, batch row), walking its heads in order: everything else.  Pass
//     A takes rows i (sums over j <= i: dC, C . dC), pass BC rows j (sums
//     over i >= j: dB, B . dB, dx, ddt's direct part), then a warp takes the
//     reverse cumsum and writes ddt and the head's share of da.  A slice's
//     heads add their dB and dC into its own f32 slab; the rows of a chunk
//     belong to one block per slice, so each slab element is read and
//     written by one thread, in head order.  Slices (up to kTargetBlocks
//     blocks) give the card work where B * chunks * G is small: mamba2-780m
//     has G = 1 and 48 heads (8 x 16 x 3 slices of 16 heads), hymba-1.5b
//     50 (4 x 17 x 4 of 13).
//   * ssd_bwd_reduce_kernel: dB, dC = the slabs summed in slice order, in
//     x's type; da = the (row, chunk) shares summed in order.
//
// Masking.  Only pairs i >= j are formed, so no exponent is positive
// (exp(cum_i - cum_j), exp(cum_i), exp(cum_last - cum_j) are all at most
// 1) and no decay is a ratio of two exps.  A ragged last chunk reads and
// writes its n valid rows only; cum stays flat past them, as the forward
// has it, and its last row is n - 1.
//
// What bounds it on the H100: per (head, chunk) some 8 products of Q^2 hd,
// Q^2 N or Q hd N multiply-adds, about 90 GFLOP at mamba2-780m's training
// shape (x [8,2048,48,64], N 128, Q 128), 0.092 ms at the bf16 peak,
// against 0.325 GB that the gradient must move (x, dy and dx; B, C, dB and
// dC; dt and ddt), 0.097 ms: bound by bytes on paper, the operations close
// behind.  The chunk states this design reads are not counted: a backward
// that recomputed them would not move them.  This first version runs every
// product on the CUDA cores
// in f32 (operands read from shared memory in their own type, bf16 or
// f32), 4 x 4 outputs a thread, so the CUDA cores' 67 TFLOP/s and the
// shared-memory loads (two for every four multiply-adds) bound it in
// practice: the tensor cores (mma.sync or wgmma on bf16 splits, as the
// forward does) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_patch.cuh"

namespace {

using namespace ssd;

// 16 warps a block: one block fits an SM's shared memory at mamba2-780m's
// shape, and twice the forward's 8 warps hide more of the shared-memory
// latency of the patch products (a third less time there; 2% more at
// hymba-1.5b's N 16, whose narrow tiles leave threads idle)
constexpr int kThreads = 512;
constexpr int kMaxChunk = 256;
constexpr int kMaxSmem = 232448;           // bytes of shared memory one block may use (H100)
constexpr int kTargetBlocks = 264;         // two blocks an SM of the H100's 132

__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// (a) the reverse state pass
// ---------------------------------------------------------------------------

// Offsets (in floats) of kernel (a)'s shared arrays; rows padded by one float.
struct StateLayout {
  int ldh, ldy, ldc;
  int dh, ys, cs, dt, cum, red, total;
};

__host__ __device__ inline StateLayout make_state_layout(int hd, int N, int Q) {
  StateLayout L;
  L.ldh = N + 1;
  L.ldy = hd + 1;
  L.ldc = N + 1;
  L.dh = 0;                                // dh          [hd][N]
  L.ys = L.dh + hd * L.ldh;                // exp(cum) dy [Q][hd]
  L.cs = L.ys + Q * L.ldy;                 // C           [Q][N]
  L.dt = L.cs + Q * L.ldc;                 // dt          [Q]
  L.cum = L.dt + Q;                        // cum         [Q]
  L.red = L.cum + Q;                       // block sum   [warps]
  L.total = L.red + kThreads / 32;
  return L;
}

// The sum of v over the block, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                         // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                     const float* __restrict__ a_neg, const T* __restrict__ cmat,
                     const float* __restrict__ hstates, const float* __restrict__ hfinal,
                     const float* __restrict__ dhfinal, float* __restrict__ dhout,
                     float* __restrict__ dlast, float* __restrict__ dh0, int S, int nh, int hd,
                     int G, int N, int Q) {
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (nh / G);
  const int tid = threadIdx.x;
  const int nc = (S + Q - 1) / Q;
  const StateLayout L = make_state_layout(hd, N, Q);
  extern __shared__ float smem[];
  float* dh_s = smem + L.dh;
  float* ys_s = smem + L.ys;
  float* cs_s = smem + L.cs;
  float* dt_s = smem + L.dt;
  float* cum_s = smem + L.cum;
  float* red_s = smem + L.red;
  const float a = a_neg[h];
  const long long hdn = (long long)hd * N;

  const float* dhf = dhfinal ? dhfinal + ((long long)bi * nh + h) * hdn : nullptr;
  for (int e = tid; e < hd * N; e += kThreads) {
    const int d = e / N, k = e - d * N;
    dh_s[d * L.ldh + k] = dhf ? dhf[e] : 0.f;
  }
  const long long xrow = (long long)nh * hd, crow = (long long)G * N;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * Q, n = min(Q, S - t0);
    const long long tok = (long long)bi * S + t0;
    const long long at = ((long long)bi * nc + c) * nh + h;   // (row, chunk, head)
    __syncthreads();                       // the last update of dh is done
    // dh_out of chunk c, and <dh_out, h_out> (h_out: the next chunk's h_in)
    const float* ho = c + 1 < nc ? hstates + (at + nh) * hdn
                                 : hfinal + ((long long)bi * nh + h) * hdn;
    float part = 0.f;
    for (int e = tid; e < hd * N; e += kThreads) {
      const int d = e / N, k = e - d * N;
      const float v = dh_s[d * L.ldh + k];
      dhout[at * hdn + e] = v;
      part = fmaf(v, ho[e], part);
    }
    const float dot = block_sum(part, red_s);
    if (tid == 0) dlast[at] = dot;
    for (int j = tid; j < Q; j += kThreads) dt_s[j] = j < n ? dt[(tok + j) * nh + h] : 0.f;
    load_rows(cmat + tok * crow + (long long)g * N, crow, n, N, cs_s, L.ldc);
    __syncthreads();
    if (tid < 32) warp_cumsum(dt_s, a, cum_s, Q, tid);
    __syncthreads();
    for (int e = tid; e < n * hd; e += kThreads) {
      const int j = e / hd, d = e - j * hd;
      ys_s[j * L.ldy + d] = to_float(dy[(tok + j) * xrow + (long long)h * hd + d]) *
                            expf(cum_s[j]);
    }
    __syncthreads();
    // dh <- exp(cum_last) dh + (exp(cum) dy)^T . C
    const float decay = expf(cum_s[n - 1]);
    for (int tile = tid; tile < n_tiles(hd, N); tile += kThreads) {
      const Patch P = make_patch(tile, hd, N);
      float acc[kTR][kTC];
      zero(acc);
      mma_patch(acc, P, ys_s, 1, L.ldy, cs_s, L.ldc, 1, n);
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        if (!P.rok[ii]) continue;
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          if (!P.cok[jj]) continue;
          float* v = dh_s + P.r[ii] * L.ldh + P.c[jj];
          *v = *v * decay + acc[ii][jj];
        }
      }
    }
  }
  if (dh0) {
    __syncthreads();
    float* o = dh0 + ((long long)bi * nh + h) * hdn;
    for (int e = tid; e < hd * N; e += kThreads) {
      const int d = e / N, k = e - d * N;
      o[e] = dh_s[d * L.ldh + k];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the chunk-parallel pass
// ---------------------------------------------------------------------------

// Offsets (in bytes) of kernel (b)'s shared arrays.  Rows are padded by one
// element.  Regions change roles between the passes:
//   r1 [Q][hd]  x (A)      dy (BC)     in T
//   r2 [Q][N]   B (A)      C (BC)      in T
//   r3 [hd][N]  h_in (A)   dh_out (BC) f32
//   r4 [tr][hd] dy rows    x rows      in T
//   r5 [tr][N]  C rows     B rows      in T
//   r6 [tr][Q]  G, then G^T and (C.B^T o L)^T tiles, f32
//   part [tr][ceil(max(N, hd) / 4)]: a row's dot products by column group
struct ChunkLayout {
  int ldx, ldn, ldh, ldq, tr, npart;
  size_t r1, r2, r3, r4, r5, r6, part, dt, cum, dcum, ddtd, total;
};

__host__ __device__ inline ChunkLayout make_chunk_layout(int hd, int N, int Q, int es, int tr) {
  ChunkLayout L;
  L.ldx = hd + 1;
  L.ldn = N + 1;
  L.ldh = N + 1;
  L.ldq = Q + 1;
  L.tr = tr;
  L.npart = ((N > hd ? N : hd) + kTC - 1) / kTC;
  L.r1 = 0;
  L.r2 = align16(L.r1 + (size_t)es * Q * L.ldx);
  L.r3 = align16(L.r2 + (size_t)es * Q * L.ldn);
  L.r4 = align16(L.r3 + 4ull * hd * L.ldh);
  L.r5 = align16(L.r4 + (size_t)es * tr * L.ldx);
  L.r6 = align16(L.r5 + (size_t)es * tr * L.ldn);
  L.part = align16(L.r6 + 4ull * tr * L.ldq);
  L.dt = align16(L.part + 4ull * tr * L.npart);
  L.cum = L.dt + 4ull * Q;
  L.dcum = L.cum + 4ull * Q;
  L.ddtd = L.dcum + 4ull * Q;
  L.total = L.ddtd + 4ull * Q;
  return L;
}

// The largest row tile (64, 32 or 16) whose layout fits; 0 if none does.
__host__ __device__ inline int chunk_tile(int hd, int N, int Q, int es) {
  for (int tr = 64; tr >= 16; tr /= 2)
    if (make_chunk_layout(hd, N, Q, es, tr).total <= (size_t)kMaxSmem) return tr;
  return 0;
}

// Per row r < R of a tile: the sum of its patches' dot products, in column
// group order.
__device__ __forceinline__ float row_dot(const float* part, int npart, int r, int C) {
  float s = 0.f;
  for (int ct = 0; ct < (C + kTC - 1) / kTC; ++ct) s += part[r * npart + ct];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_neg, const T* __restrict__ bmat,
                     const T* __restrict__ cmat, const T* __restrict__ dy,
                     const float* __restrict__ hstates, const float* __restrict__ dhout,
                     const float* __restrict__ dlast, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dbslab,
                     float* __restrict__ dcslab, float* __restrict__ dapart, int S, int nh,
                     int hd, int G, int N, int Q, int slices, int tr) {
  const int c = blockIdx.x, bi = blockIdx.z;
  const int g = blockIdx.y / slices, sl = blockIdx.y % slices;
  const int rep = nh / G, per = (rep + slices - 1) / slices;
  const int h_lo = g * rep + sl * per, h_hi = min(h_lo + per, (g + 1) * rep);
  const int nc = (S + Q - 1) / Q;
  const int t0 = c * Q, n = min(Q, S - t0);
  const long long tok = (long long)bi * S + t0;
  const int tid = threadIdx.x, lane = tid % 32;
  const ChunkLayout L = make_chunk_layout(hd, N, Q, sizeof(T), tr);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* r1 = reinterpret_cast<T*>(smem_raw + L.r1);
  T* r2 = reinterpret_cast<T*>(smem_raw + L.r2);
  float* r3 = reinterpret_cast<float*>(smem_raw + L.r3);
  T* r4 = reinterpret_cast<T*>(smem_raw + L.r4);
  T* r5 = reinterpret_cast<T*>(smem_raw + L.r5);
  float* r6 = reinterpret_cast<float*>(smem_raw + L.r6);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  float* dt_s = reinterpret_cast<float*>(smem_raw + L.dt);
  float* cum = reinterpret_cast<float*>(smem_raw + L.cum);
  float* dcum = reinterpret_cast<float*>(smem_raw + L.dcum);
  float* ddtd = reinterpret_cast<float*>(smem_raw + L.ddtd);
  const int ldx = L.ldx, ldn = L.ldn, ldh = L.ldh, ldq = L.ldq, np = L.npart;
  const long long xrow = (long long)nh * hd, brow = (long long)G * N;
  const long long hdn = (long long)hd * N;
  const long long slab = (long long)gridDim.z * S * G * N;   // elements of one slab
  float* dbs = dbslab + sl * slab;
  float* dcs = dcslab + sl * slab;
  const T* bg = bmat + tok * brow + (long long)g * N;
  const T* cg = cmat + tok * brow + (long long)g * N;

  for (int h = h_lo; h < h_hi; ++h) {
    const bool first = h == h_lo;
    const float a = a_neg[h];
    const long long at = ((long long)bi * nc + c) * nh + h;
    const T* xh = x + tok * xrow + (long long)h * hd;
    const T* dyh = dy + tok * xrow + (long long)h * hd;
    __syncthreads();                       // the last head is done with every array
    for (int j = tid; j < Q; j += kThreads) {
      dt_s[j] = j < n ? dt[(tok + j) * nh + h] : 0.f;
      dcum[j] = 0.f;
    }
    load_rows(xh, xrow, n, hd, r1, ldx);
    load_rows(bg, brow, n, N, r2, ldn);
    load_rows(hstates + at * hdn, (long long)N, hd, N, r3, ldh);
    __syncthreads();
    if (tid < 32) warp_cumsum(dt_s, a, cum, Q, lane);
    __syncthreads();
    const float cl = cum[n - 1];

    // pass A: row tiles of i, every j <= i
    for (int i0 = 0; i0 < n; i0 += tr) {
      const int R = min(tr, n - i0), jmax = i0 + R;
      load_rows(dyh + (long long)i0 * xrow, xrow, R, hd, r4, ldx);
      load_rows(cg + (long long)i0 * brow, brow, R, N, r5, ldn);
      __syncthreads();
      // G_ij = L_ij dt_j (dy_i . x_j) for j <= i, else 0
      for (int tile = tid; tile < n_tiles(R, jmax); tile += kThreads) {
        const Patch P = make_patch(tile, R, jmax);
        float acc[kTR][kTC];
        zero(acc);
        mma_patch(acc, P, r4, ldx, 1, r1, 1, ldx, hd);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int i = i0 + P.r[ii];
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int j = P.c[jj];
            r6[P.r[ii] * ldq + j] = j <= i ? acc[ii][jj] * expf(cum[i] - cum[j]) * dt_s[j] : 0.f;
          }
        }
      }
      __syncthreads();
      // dC_i = G . B + exp(cum_i) dy_i . h_in, into the slab; C_i . dC_i
      for (int tile = tid; tile < n_tiles(R, N); tile += kThreads) {
        const Patch P = make_patch(tile, R, N);
        float intra[kTR][kTC], state[kTR][kTC];
        zero(intra);
        zero(state);
        mma_patch(intra, P, r6, ldq, 1, r2, ldn, 1, jmax);
        mma_patch(state, P, r4, ldx, 1, r3, ldh, 1, hd);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int r = P.r[ii];
          const float e = expf(cum[i0 + r]);
          float dot = 0.f;
          float* o = dcs + ((tok + i0 + r) * G + g) * N;
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int k = P.c[jj];
            const float v = intra[ii][jj] + e * state[ii][jj];
            dot = fmaf(v, to_float(r5[r * ldn + k]), dot);
            o[k] = first ? v : o[k] + v;
          }
          part[r * np + P.ct] = dot;
        }
      }
      __syncthreads();
      for (int r = tid; r < R; r += kThreads) dcum[i0 + r] += row_dot(part, np, r, N);
    }

    // pass BC: row tiles of j, every i >= j
    __syncthreads();
    load_rows(dyh, xrow, n, hd, r1, ldx);
    load_rows(cg, brow, n, N, r2, ldn);
    load_rows(dhout + at * hdn, (long long)N, hd, N, r3, ldh);
    for (int j0 = 0; j0 < n; j0 += tr) {
      const int R = min(tr, n - j0), W = n - j0;
      load_rows(xh + (long long)j0 * xrow, xrow, R, hd, r4, ldx);
      load_rows(bg + (long long)j0 * brow, brow, R, N, r5, ldn);
      __syncthreads();
      // G^T: row j, column i - j0: L_ij dt_j (x_j . dy_i) for i >= j
      for (int tile = tid; tile < n_tiles(R, W); tile += kThreads) {
        const Patch P = make_patch(tile, R, W);
        float acc[kTR][kTC];
        zero(acc);
        mma_patch(acc, P, r4, ldx, 1, r1 + j0 * ldx, 1, ldx, hd);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int j = j0 + P.r[ii];
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int i = j0 + P.c[jj];
            r6[P.r[ii] * ldq + P.c[jj]] =
                i >= j ? acc[ii][jj] * expf(cum[i] - cum[j]) * dt_s[j] : 0.f;
          }
        }
      }
      __syncthreads();
      // dB_j = G^T . C + exp(cl - cum_j) dt_j x_j . dh_out, into the slab; B_j . dB_j
      for (int tile = tid; tile < n_tiles(R, N); tile += kThreads) {
        const Patch P = make_patch(tile, R, N);
        float intra[kTR][kTC], state[kTR][kTC];
        zero(intra);
        zero(state);
        mma_patch(intra, P, r6, ldq, 1, r2 + j0 * ldn, ldn, 1, W);
        mma_patch(state, P, r4, ldx, 1, r3, ldh, 1, hd);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int r = P.r[ii], j = j0 + r;
          const float e = expf(cl - cum[j]) * dt_s[j];
          float dot = 0.f;
          float* o = dbs + ((tok + j) * G + g) * N;
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int k = P.c[jj];
            const float v = intra[ii][jj] + e * state[ii][jj];
            dot = fmaf(v, to_float(r5[r * ldn + k]), dot);
            o[k] = first ? v : o[k] + v;
          }
          part[r * np + P.ct] = dot;
        }
      }
      __syncthreads();
      for (int r = tid; r < R; r += kThreads) dcum[j0 + r] -= row_dot(part, np, r, N);
      // (C.B^T o L)^T: row j, column i - j0: (B_j . C_i) L_ij for i >= j
      for (int tile = tid; tile < n_tiles(R, W); tile += kThreads) {
        const Patch P = make_patch(tile, R, W);
        float acc[kTR][kTC];
        zero(acc);
        mma_patch(acc, P, r5, ldn, 1, r2 + j0 * ldn, 1, ldn, N);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int j = j0 + P.r[ii];
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int i = j0 + P.c[jj];
            r6[P.r[ii] * ldq + P.c[jj]] = i >= j ? acc[ii][jj] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      // dxn_j = (C.B^T o L)^T . dy + exp(cl - cum_j) B_j . dh_out^T; dx = dt dxn,
      // and x_j . dxn_j
      for (int tile = tid; tile < n_tiles(R, hd); tile += kThreads) {
        const Patch P = make_patch(tile, R, hd);
        float intra[kTR][kTC], state[kTR][kTC];
        zero(intra);
        zero(state);
        mma_patch(intra, P, r6, ldq, 1, r1 + j0 * ldx, ldx, 1, W);
        mma_patch(state, P, r5, ldn, 1, r3, 1, ldh, N);
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          if (!P.rok[ii]) continue;
          const int r = P.r[ii], j = j0 + r;
          const float e = expf(cl - cum[j]);
          float dot = 0.f;
          T* o = dx + (tok + j) * xrow + (long long)h * hd;
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if (!P.cok[jj]) continue;
            const int d = P.c[jj];
            const float v = intra[ii][jj] + e * state[ii][jj];
            dot = fmaf(v, to_float(r4[r * ldx + d]), dot);
            o[d] = from_float<T>(dt_s[j] * v);
          }
          part[r * np + P.ct] = dot;
        }
      }
      __syncthreads();
      for (int r = tid; r < R; r += kThreads) ddtd[j0 + r] = row_dot(part, np, r, hd);
      __syncthreads();                     // part, r4 and r5 are free for the next tile
    }

    // dda = the reverse cumsum of dcum (with <dh_out, h_out> at the last
    // row); ddt = x . dxn + a dda; the head's share of da = sum dt dda
    if (tid < 32) {
      if (lane == 0) dcum[n - 1] += dlast[at];
      __syncwarp();
      const int per_l = (n + 31) / 32, j0 = lane * per_l;
      float tot = 0.f;
      for (int k = 0; k < per_l; ++k)
        if (j0 + k < n) tot += dcum[j0 + k];
      float incl = tot;                    // the sum over lanes >= this one
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      float run = incl - tot, da = 0.f;
      for (int k = per_l - 1; k >= 0; --k) {
        const int j = j0 + k;
        if (j >= n) continue;
        run += dcum[j];
        ddt[(tok + j) * nh + h] = ddtd[j] + a * run;
        da = fmaf(dt_s[j], run, da);
      }
      for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0) dapart[at] = da;
    }
  }
}

// ---------------------------------------------------------------------------
// (c) the sums over slices and over (row, chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dbslab, const float* __restrict__ dcslab,
                      const float* __restrict__ dapart, T* __restrict__ dbmat,
                      T* __restrict__ dcmat, float* __restrict__ da, long long elems,
                      int slices, int rows, int nh) {
  if (blockIdx.x == gridDim.x - 1) {       // da: one thread a head, over (row, chunk)
    for (int h = threadIdx.x; h < nh; h += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += dapart[(long long)r * nh + h];
      da[h] = s;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  float sb = 0.f, sc = 0.f;
  for (int s = 0; s < slices; ++s) {
    sb += dbslab[s * elems + e];
    sc += dcslab[s * elems + e];
  }
  dbmat[e] = from_float<T>(sb);
  dcmat[e] = from_float<T>(sc);
}

template <typename T>
cudaError_t launch(const void* dy, const float* dt, const float* a_neg, const void* x,
                   const void* bmat, const void* cmat, const float* hstates,
                   const float* hfinal, const float* dhfinal, float* dhout, float* dlast,
                   float* dbslab, float* dcslab, float* dapart, void* dx, float* ddt, float* da,
                   void* dbmat, void* dcmat, float* dh0, int B, int S, int nh, int hd, int G,
                   int N, int Q, int slices, cudaStream_t stream) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bmat);
  const T* ct = static_cast<const T*>(cmat);
  const int nc = (S + Q - 1) / Q;
  const int smem_a = sizeof(float) * make_state_layout(hd, N, Q).total;
  const int tr = chunk_tile(hd, N, Q, sizeof(T));
  if (smem_a > kMaxSmem || tr == 0) return cudaErrorInvalidValue;
  const int smem_b = (int)make_chunk_layout(hd, N, Q, sizeof(T), tr).total;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (e != cudaSuccess) return e;
  ssd_bwd_state_kernel<T><<<dim3(nh, B), kThreads, smem_a, stream>>>(
      dyt, dt, a_neg, ct, hstates, hfinal, dhfinal, dhout, dlast, dh0, S, nh, hd, G, N, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<T><<<dim3(nc, G * slices, B), kThreads, smem_b, stream>>>(
      xt, dt, a_neg, bt, ct, dyt, hstates, dhout, dlast, static_cast<T*>(dx), ddt, dbslab,
      dcslab, dapart, S, nh, hd, G, N, Q, slices, tr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long elems = (long long)B * S * G * N;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((elems + kThreads - 1) / kThreads + 1), kThreads, 0,
                             stream>>>(dbslab, dcslab, dapart, static_cast<T*>(dbmat),
                                       static_cast<T*>(dcmat), da, elems, slices, B * nc, nh);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) the larger of the two big kernels needs at dtype code
// `dtype` (0 float32, 1 bfloat16), head dim hd, state N and chunk Q; -1 if no
// row tile fits.
extern "C" long long repro_ssd_scan_bwd_smem(int dtype, int hd, int N, int Q) {
  const int es = dtype == 1 ? 2 : 4;
  const int tr = chunk_tile(hd, N, Q, es);
  if (tr == 0) return -1;
  const long long a = (long long)sizeof(float) * make_state_layout(hd, N, Q).total;
  const long long b = (long long)make_chunk_layout(hd, N, Q, es, tr).total;
  return a > b ? a : b;
}

// Slices of a group's heads for the chunk pass: enough (row, chunk, group,
// slice) blocks to give the card kTargetBlocks, none of them empty.
extern "C" int repro_ssd_scan_bwd_slices(int B, int S, int nh, int G, int Q) {
  const long long base = (long long)B * ((S + Q - 1) / Q) * G;
  const int rep = nh / G;
  long long want = (kTargetBlocks + base - 1) / base;
  if (want > rep) want = rep;
  if (want < 1) want = 1;
  const int per = (int)((rep + want - 1) / want);
  return (rep + per - 1) / per;
}

// dtype: 0 = float32, 1 = bfloat16, of x, B, C, dy, dx, dB and dC; the rest
// f32.  dy/x/dx [B,S,nh,hd]; dt/ddt [B,S,nh]; a_neg/da [nh]; B/C/dB/dC
// [B,S,G,N]; hstates and dhout [B,nc,nh,hd,N] (nc = ceil(S/Q)); hfinal,
// dhfinal (or null) and dh0 (or null) [B,nh,hd,N]; dlast and dapart
// [B,nc,nh]; dbslab and dcslab [slices,B,S,G,N] scratch.  All contiguous;
// nh % G == 0; 1 <= Q <= 256; slices from repro_ssd_scan_bwd_slices.
// Returns cudaGetLastError() after the last launch.
extern "C" int repro_ssd_scan_bwd(int dtype, const void* dy, const void* dhfinal, const void* x,
                                  const void* dt, const void* a_neg, const void* bmat,
                                  const void* cmat, const void* hstates, const void* hfinal,
                                  void* dhout, void* dlast, void* dbslab, void* dcslab,
                                  void* dapart, void* dx, void* ddt, void* da, void* dbmat,
                                  void* dcmat, void* dh0, int B, int S, int nh, int hd, int G,
                                  int N, int Q, int slices, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd <= 0 || G <= 0 || N <= 0 || nh % G || Q <= 0 ||
      Q > kMaxChunk || slices != repro_ssd_scan_bwd_slices(B, S, nh, G, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a_neg);
  const float* f_hs = static_cast<const float*>(hstates);
  const float* f_hf = static_cast<const float*>(hfinal);
  const float* f_dhf = static_cast<const float*>(dhfinal);
  float* f[] = {static_cast<float*>(dhout), static_cast<float*>(dlast),
                static_cast<float*>(dbslab), static_cast<float*>(dcslab),
                static_cast<float*>(dapart), static_cast<float*>(ddt), static_cast<float*>(da),
                static_cast<float*>(dh0)};
  if (dtype == 0)
    return launch<float>(dy, f_dt, f_a, x, bmat, cmat, f_hs, f_hf, f_dhf, f[0], f[1], f[2], f[3],
                         f[4], dx, f[5], f[6], dbmat, dcmat, f[7], B, S, nh, hd, G, N, Q,
                         slices, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dy, f_dt, f_a, x, bmat, cmat, f_hs, f_hf, f_dhf, f[0], f[1],
                                 f[2], f[3], f[4], dx, f[5], f[6], dbmat, dcmat, f[7], B, S, nh,
                                 hd, G, N, Q, slices, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
