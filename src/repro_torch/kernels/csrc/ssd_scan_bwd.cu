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
// Two bodies, picked by the dtype alone; each runs its launches on one
// stream, no atomics, every sum in a fixed order, so two calls give the
// same bits.  Both keep dB and dC per slice of a group's heads: a block
// walks its slice's heads in order into its own f32 slab, and the slices
// (up to kTargetBlocks blocks) give the card work where B * chunks * G is
// small: mamba2-780m has G = 1 and 48 heads (8 x 16 x 3 slices of 16),
// hymba-1.5b 50 (4 x 17 x 4 of 13).  ssd_bwd_reduce_kernel then writes dB,
// dC = the slabs summed in slice order, in x's type, and da = the (row,
// chunk) shares summed in order.
//
// bf16: the tensor cores.  Four launches:
//   * ssd_bwd_dc_mma_kernel, a block per (chunk, group, slice, batch row),
//     B and C in shared memory for the walk, per head x, dy and h_in: pass
//     A (rows i: dC, C . dC, dcum's share) and the chunk's local state
//     gradient sum_i exp(cum_i) dy_i (x) C_i, chunk-parallel.
//   * ssd_bwd_scan_kernel, a block per (head, batch row): the reverse state
//     pass as additions only, elementwise over [hd, N]:
//     dh_out(c) = exp(cum_last(c + 1)) dh_out(c + 1) + local(c + 1), from
//     dh_final; it writes dh_out in place of the locals, <dh_out, h_out> per
//     chunk and dh0.
//   * ssd_bwd_dx_mma_kernel, the dc kernel's grid, per head x, dy and dh_out:
//     pass BC (rows j: dB, B . dB, dx = dt dxn, x . dxn), then a warp takes
//     the reverse cumsum and writes ddt and the head's share of da.
//   * ssd_bwd_reduce_kernel.
// Every product runs on mma.sync m16n8k16 bf16 -> f32 with ldmatrix
// (ssd_mma.cuh): 16 warps a block deal units of 16 rows by 64 columns of N
// (32 of hd for dx), the heaviest first in snake order so each warp's
// triangle of blocks evens out.  No f32 operand is rounded to one bf16: G,
// the decayed scores C.B^T o L, exp(cum) dy, h_in and dh_out are split into
// bf16 hi + lo and take two products (relative error near 2^-16); G and the
// scores go from the accumulator straight into A fragments.  C.B^T is
// recomputed per head, exact in bf16 with f32 sums (a stored f32 copy would
// not fit beside the running slab).  The decays come from per-head tables
// (exp(cum_i - cum_j) = ehead[i] eblk[ib][jb] etail[j], each factor at most
// 1), exps only on the diagonal blocks.  dcum's two row dots come from the
// f32 accumulators before any rounding, summed over a quad by shuffles and
// over column splits in order; a slice's dB or dC sums in shared memory.
// At mamba2's shape a block takes 215 KB of shared memory: one an SM.
//
// f32: the CUDA cores (TF32 or bf16 splits cannot hold the f32 band of
// 2e-4, as in the forward).  Three launches, 512 threads a block, every
// product a 4 x 4 patch a thread from shared memory (ssd_patch.cuh):
//   * ssd_bwd_state_kernel, a block per (batch row, head): the reverse state
//     pass, serial over the chunks like the forward.  It writes dh_out of
//     every chunk, <dh_out, h_out> per chunk and dh0.
//   * ssd_bwd_chunk_kernel, a block per (chunk, group, slice, batch row),
//     walking its heads in order: everything else.  Pass A takes rows i
//     (sums over j <= i: dC, C . dC), pass BC rows j (sums over i >= j: dB,
//     B . dB, dx, ddt's direct part), then a warp takes the reverse cumsum
//     and writes ddt and the head's share of da; each slab element is read
//     and written by one thread, in head order.
//   * ssd_bwd_reduce_kernel.
//
// Masking.  The f32 body forms only pairs i >= j, so no exponent is
// positive and no decay is a ratio of two exps.  The bf16 body's tiles
// also compute j > i entries: it clamps their exponents to 0 and drops
// them by a select after the product, never by multiplying an exp.  A
// ragged last chunk reads and writes its n valid rows only (the bf16 tiles
// zero-fill the rest in shared memory); cum stays flat past them, as the
// forward has it, and its last row is n - 1.
//
// What bounds it on the H100: per (head, chunk) some 8 products of Q^2 hd,
// Q^2 N or Q hd N multiply-adds, about 90 GFLOP at mamba2-780m's training
// shape (x [8,2048,48,64], N 128, Q 128), 0.092 ms at the bf16 peak,
// against 0.325 GB that the gradient must move (x, dy and dx; B, C, dB and
// dC; dt and ddt), 0.097 ms: bound by bytes on paper, the operations close
// behind.  The chunk states this design reads are not counted: a backward
// that recomputed them would not move them.  In practice the bf16 body
// does about twice those operations (the hi + lo splits, C.B^T per head, G
// in both passes) on mma.sync, whose peak is about half of wgmma's, and
// moves some 1.2 GB of chunk states (h_in read, the locals written, read
// and overwritten by dh_out, dh_out read); a block's per-head loads do not
// overlap its products.  The f32 body is bound by the CUDA cores' 67
// TFLOP/s and the shared-memory loads of its patches (two for every four
// multiply-adds).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ssd_mma.cuh"
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

// The sum of v over a block of NT threads, in a fixed order; every thread
// gets it.
template <int NT = kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                         // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
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


// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpsM = 16;                // warps of the two chunk kernels
constexpr int kThreadsM = kWarpsM * 32;
constexpr int kThreadsScan = 256;          // threads of the state scan
constexpr int kScanVec = 8;                // float4s a scan thread keeps in flight

// Offsets (in bytes) of the shared arrays of ssd_bwd_dc_mma_kernel and
// ssd_bwd_dx_mma_kernel, one layout for both.  bf16 rows are padded by 8
// elements so that ldmatrix spreads over the banks, short dims zero-padded
// to the MMA tile.  The f32 state is held as kTerms bf16 terms, `term`
// elements apart.
struct BwdLayout {
  int qp, hp, np;                          // Q, hd, N rounded up to 16
  int ldx, ldb, ldr;                       // row strides in elements
  int cs, csx;                             // column splits of N (64 wide) and hd (32 wide)
  int term;
  size_t b, c, x, dy, st, run, part, partx, dt, cum, ex, ehead, etail, eblk, dcum, ddtd, total;
};

__host__ __device__ inline BwdLayout make_bwd_layout(int hd, int N, int Q) {
  BwdLayout L;
  L.qp = round16(Q);
  L.hp = round16(hd);
  L.np = round16(N);
  L.ldx = L.hp + 8;
  L.ldb = L.np + 8;
  L.ldr = L.np + 8;
  L.cs = (L.np + 63) / 64;
  L.csx = (L.hp + 31) / 32;
  L.term = L.hp * L.ldb;
  L.b = 0;                                           // bf16 B [qp][ldb], the whole walk
  L.c = L.b + 2ull * L.qp * L.ldb;                   // bf16 C [qp][ldb], the whole walk
  L.x = L.c + 2ull * L.qp * L.ldb;                   // bf16 x [qp][ldx], per head
  L.dy = L.x + 2ull * L.qp * L.ldx;                  // bf16 dy [qp][ldx], per head
  L.st = L.dy + 2ull * L.qp * L.ldx;                 // h_in or dh_out [kTerms][hp][ldb]
  L.run = L.st + 2ull * kTerms * L.hp * L.ldb;       // f32 dC or dB of the slice [qp][ldr]
  L.part = L.run + 4ull * L.qp * L.ldr;              // f32 row dots with C or B [cs][qp]
  L.partx = L.part + 4ull * L.cs * L.qp;             // f32 row dots with x [csx][qp]
  L.dt = L.partx + 4ull * L.csx * L.qp;              // f32 dt, 0 past the chunk [qp]
  L.cum = L.dt + 4ull * L.qp;                        // f32 cumsum of dt*a [qp]
  L.ex = L.cum + 4ull * L.qp;                        // exp(cum) or exp(cum_last - cum)
  L.ehead = L.ex + 4ull * L.qp;                      // exp(cum_k - cum at k's block start)
  L.etail = L.ehead + 4ull * L.qp;                   // exp(cum at k's block end - cum_k)
  L.eblk = L.etail + 4ull * L.qp;                    // exp(cum_i0 - cum at jb's end) [16][16]
  L.dcum = L.eblk + 4ull * 256;                      // f32 dcum [qp]
  L.ddtd = L.dcum + 4ull * L.qp;                     // f32 x . dxn [qp]
  L.total = L.ddtd + 4ull * L.qp;
  return L;
}

// An f32 state [hd][N] (global, contiguous) into the shared terms
// st[kTerms][hp][ldb], zeros past hd and N; a thread keeps kStateVec pairs
// of loads in flight before it splits and stores them.
constexpr int kStateVec = 8;

__device__ __forceinline__ void load_state(__nv_bfloat16* st, const BwdLayout& L,
                                           const float* __restrict__ src, int hd, int N) {
  const int pairs = L.np / 2, total = L.hp * pairs;
  for (int base = threadIdx.x; base < total; base += blockDim.x * kStateVec) {
    float2 v[kStateVec];
#pragma unroll
    for (int u = 0; u < kStateVec; ++u) {
      const int e = base + u * blockDim.x;
      const int d = e / pairs, k = 2 * (e - d * pairs);
      v[u] = make_float2(0.f, 0.f);
      if (e < total && d < hd && k < N) {
        const float* p = src + (long long)d * N + k;
        if ((N & 1) == 0) {
          v[u] = *reinterpret_cast<const float2*>(p);
        } else {
          v[u].x = p[0];
          if (k + 1 < N) v[u].y = p[1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStateVec; ++u) {
      const int e = base + u * blockDim.x;
      if (e >= total) break;
      const int d = e / pairs, k = 2 * (e - d * pairs);
      uint32_t t[kTerms];
      split_bf16(v[u].x, v[u].y, t);
      uint32_t* q = reinterpret_cast<uint32_t*>(st + d * L.ldb + k);
#pragma unroll
      for (int i = 0; i < kTerms; ++i) q[i * (L.term / 2)] = t[i];
    }
  }
}

// The decay tables of a head, by one warp once cum is written: for 16-row
// blocks ib > jb, exp(cum_i - cum_j) = ehead[i] eblk[ib][jb] etail[j], each
// factor at most 1 (the exponents run from a later row to an earlier one),
// so no factor overflows and no decay is a ratio of two exps.
__device__ __forceinline__ void decay_tables(const float* cum, float* ehead, float* etail,
                                             float* eblk, int qp, int nrb, int lane) {
  for (int k = lane; k < qp; k += 32) {
    ehead[k] = expf(cum[k] - cum[k & ~15]);
    etail[k] = expf(cum[k | 15] - cum[k]);
  }
  for (int e = lane; e < nrb * nrb; e += 32) {
    const int ib = e / nrb, jb = e - ib * nrb;
    if (ib > jb) eblk[ib * 16 + jb] = expf(cum[ib * 16] - cum[jb * 16 + 15]);
  }
}

// The decayed 16 x 16 block p = sc * exp(cum_i - cum_j) (* dt_j) for i >= j,
// else 0, of a block whose rows are r0 + {g, g + 8} and columns c0 + 8 nt +
// 2t + {0, 1}; `rows_are_i` says which of the two is i.  Off the diagonal
// from the tables; on it the positive exponents of j > i are clamped to 0
// and the entries dropped by a select.  `dtj` multiplies by dt_j (G), or
// not (the scores).
__device__ __forceinline__ void decay_block(float (&p)[2][4], const float (&sc)[2][4],
                                            const float* cum, const float* dt,
                                            const float* ehead, const float* etail,
                                            const float* eblk, int r0, int c0, bool rows_are_i,
                                            bool dtj, int gr, int tc) {
  if (r0 == c0) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + gr + (e < 2 ? 0 : 8), cc = c0 + 8 * t + 2 * tc + (e & 1);
        const int i = rows_are_i ? r : cc, j = rows_are_i ? cc : r;
        const float f = expf(fminf(cum[i] - cum[j], 0.f)) * (dtj ? dt[j] : 1.f);
        p[t][e] = i >= j ? sc[t][e] * f : 0.f;
      }
    return;
  }
  // eblk[ib][jb]: rows are block ib or jb, columns the other
  const float eb = rows_are_i ? eblk[r0 + c0 / 16] : eblk[c0 + r0 / 16];
  float fr[2], fc[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gr + 8 * h;
    fr[h] = (rows_are_i ? ehead[r] : etail[r] * (dtj ? dt[r] : 1.f)) * eb;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c0 + 8 * t + 2 * tc + e;
      fc[t][e] = rows_are_i ? etail[cc] * (dtj ? dt[cc] : 1.f) : ehead[cc];
    }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[t][e] = sc[t][e] * fr[e >> 1] * fc[t][e & 1];
}

// p as the A fragments of its kTerms bf16 terms.
__device__ __forceinline__ void split_frag(const float (&p)[2][4], uint32_t (&pt)[kTerms][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v[kTerms];
    split_bf16(p[q / 2][2 * (q % 2)], p[q / 2][2 * (q % 2) + 1], v);
#pragma unroll
    for (int t = 0; t < kTerms; ++t) pt[t][q] = v[t];
  }
}

// The 16 x 16 block of A_rows . B_rows^T, K = kp: A rows r0 of `a`, B rows
// c0 of `b`, both bf16 [rows][ld] in shared memory.
__device__ __forceinline__ void block_abt(float (&sc)[2][4], const __nv_bfloat16* a, int lda,
                                          int r0, const __nv_bfloat16* b, int ldb_, int c0,
                                          int kp, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
  const uint32_t a_addr =
      smem_u32(a + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4));
  const uint32_t b_addr =
      smem_u32(b + (c0 + (lane & 7) + 8 * (lane >> 4)) * ldb_ + 8 * ((lane >> 3) & 1));
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t af[4], bf[4];
    ldsm_x4(af, a_addr + 2 * k0);
    ldsm_x4(bf, b_addr + 2 * k0);
    mma_bf16(sc[0], af, bf[0], bf[1]);
    mma_bf16(sc[1], af, bf[2], bf[3]);
  }
}

// acc[nt] += A_rows . S over the state's terms, K = kp, for the n8 tiles nt
// < ncol / 8: A rows r0 of `a` [rows][lda] bf16; S the state terms, read as
// [k][n] (trans: S[d][k'] with k = d) or as [n][k] (!trans: k = k').
template <bool TRANS>
__device__ __forceinline__ void rows_times_state(float (&acc)[8][4], const __nv_bfloat16* a,
                                                 int lda, int r0, const __nv_bfloat16* st,
                                                 int ldb_, int term, int n0, int ncol, int kp,
                                                 int lane) {
  const uint32_t a_addr =
      smem_u32(a + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 8 * (lane >> 4));
  const uint32_t s_addr =
      TRANS ? smem_u32(st + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldb_ + n0 + 8 * (lane >> 4))
            : smem_u32(st + (n0 + (lane & 7) + 8 * (lane >> 4)) * ldb_ + 8 * ((lane >> 3) & 1));
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a_addr + 2 * k0);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      if (nt * 8 >= ncol) break;
      const int off = TRANS ? k0 * ldb_ + nt * 8 : nt * 8 * ldb_ + k0;
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        uint32_t bf[4];
        if (TRANS)
          ldsm_x4_trans(bf, s_addr + 2 * (off + t * term));
        else
          ldsm_x4(bf, s_addr + 2 * (off + t * term));
        mma_bf16(acc[nt], af, bf[0], bf[1]);
        mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc[nt] += P . M for the n8 tiles nt < ncol / 8, P the A fragments'
// terms over rows k0 .. k0 + 15 of M, M bf16 [k][n] in shared memory from
// column n0.
__device__ __forceinline__ void frag_times_rows(float (&acc)[8][4],
                                                const uint32_t (&pt)[kTerms][4],
                                                const __nv_bfloat16* m, int ldm, int k0, int n0,
                                                int ncol, int lane) {
  const uint32_t addr =
      smem_u32(m + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldm + n0 + 8 * (lane >> 4));
#pragma unroll
  for (int nt = 0; nt < 8; nt += 2) {
    if (nt * 8 >= ncol) break;
    uint32_t bf[4];
    ldsm_x4_trans(bf, addr + 2 * nt * 8);
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      mma_bf16(acc[nt], pt[t], bf[0], bf[1]);
      mma_bf16(acc[nt + 1], pt[t], bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ void zero8(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// The `f`-th unit in a warp's deal: units sorted heaviest first, dealt over
// the warps in snake order (0..W-1, W-1..0, ...), so that each warp's sum
// of costs evens out.  -1 when the warp has no `k`-th unit.
__device__ __forceinline__ int dealt(int k, int warp, int units) {
  const int f = k * kWarpsM + ((k & 1) ? kWarpsM - 1 - warp : warp);
  return f < units ? f : -1;
}

// acc's rows r0 + {g, g + 8} dotted with rows of `m` (bf16 [rows][ldm]) over
// the columns n0 + 8 nt + 2t + {0, 1} this thread holds, summed over the
// quad in a fixed order; every lane of the quad gets the two sums.
__device__ __forceinline__ float2 row_dots(const float (&acc)[8][4], const __nv_bfloat16* m,
                                           int ldm, int r0, int n0, int ncol, int gr, int tc) {
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= ncol) break;
    const int col = n0 + nt * 8 + 2 * tc;
    const float2 va = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(m + (r0 + gr) * ldm + col));
    const float2 vb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(m + (r0 + gr + 8) * ldm + col));
    da = fmaf(acc[nt][0], va.x, da);
    da = fmaf(acc[nt][1], va.y, da);
    db = fmaf(acc[nt][2], vb.x, db);
    db = fmaf(acc[nt][3], vb.y, db);
  }
  da += __shfl_xor_sync(0xffffffffu, da, 1);
  db += __shfl_xor_sync(0xffffffffu, db, 1);
  da += __shfl_xor_sync(0xffffffffu, da, 2);
  db += __shfl_xor_sync(0xffffffffu, db, 2);
  return make_float2(da, db);
}

// run[r][c] (=, on the slice's first head, else +=) acc, rows r0 + {g, g + 8}.
__device__ __forceinline__ void add_to_run(float* run, int ldr, const float (&acc)[8][4],
                                           int r0, int n0, int ncol, bool first, int gr,
                                           int tc) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= ncol) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* q = reinterpret_cast<float2*>(run + (r0 + gr + 8 * h) * ldr + n0 + nt * 8 + 2 * tc);
      const float2 v = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      if (first) {
        *q = v;
      } else {
        float2 o = *q;
        o.x += v.x;
        o.y += v.y;
        *q = o;
      }
    }
  }
}

// Pass A and the local state gradients, a block per (chunk, group, slice of
// the group's heads, batch row), walking its heads in order.  Per head:
//   dC_i = exp(cum_i) dy_i . h_in + sum_{j<=i} G_ij B_j, G_ij = L_ij dt_j (dy_i . x_j):
//     units of (16 rows i, 64 columns of N); C_i . dC_i by column split into
//     `part`, their sum (dcum's pass-A share) into ddt, which pass BC reads
//     and overwrites; dC added into the slice's running sum in `run`;
//   local = sum_i exp(cum_i) dy_i (x) C_i [hd, N], into dhout, which the
//     scan turns into dh_out in place; cum_last into dlast.
__global__ void __launch_bounds__(kThreadsM, 1)
ssd_bwd_dc_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_neg, const __nv_bfloat16* __restrict__ bmat,
                      const __nv_bfloat16* __restrict__ cmat,
                      const __nv_bfloat16* __restrict__ dy, const float* __restrict__ hstates,
                      float* __restrict__ local, float* __restrict__ clast,
                      float* __restrict__ dcum_a, float* __restrict__ dcslab, int S, int nh,
                      int hd, int G, int N, int Q, int slices, int vec) {
  const int c = blockIdx.x, bi = blockIdx.z;
  const int g = blockIdx.y / slices, sl = blockIdx.y % slices;
  const int rep = nh / G, per = (rep + slices - 1) / slices;
  const int h_lo = g * rep + sl * per, h_hi = min(h_lo + per, (g + 1) * rep);
  const int nc = (S + Q - 1) / Q;
  const int t0 = c * Q, n = min(Q, S - t0);
  const long long tok = (long long)bi * S + t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const BwdLayout L = make_bwd_layout(hd, N, Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.b);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.c);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.x);
  __nv_bfloat16* dy_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.dy);
  __nv_bfloat16* st_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.st);
  float* run = reinterpret_cast<float*>(smem_raw + L.run);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  float* dt_s = reinterpret_cast<float*>(smem_raw + L.dt);
  float* cum = reinterpret_cast<float*>(smem_raw + L.cum);
  float* ex = reinterpret_cast<float*>(smem_raw + L.ex);
  float* ehead = reinterpret_cast<float*>(smem_raw + L.ehead);
  float* etail = reinterpret_cast<float*>(smem_raw + L.etail);
  float* eblk = reinterpret_cast<float*>(smem_raw + L.eblk);
  const int qp = L.qp, ldx = L.ldx, ldb = L.ldb;
  const long long xrow = (long long)nh * hd, brow = (long long)G * N;
  const long long hdn = (long long)hd * N;
  const int nrb = (n + 15) / 16;           // row blocks that hold valid rows

  load_tile(b_s, ldb, bmat + tok * brow + (long long)g * N, brow, n, N, qp, L.np, vec,
            kThreadsM);
  load_tile(c_s, ldb, cmat + tok * brow + (long long)g * N, brow, n, N, qp, L.np, vec,
            kThreadsM);
  for (int h = h_lo; h < h_hi; ++h) {
    const bool first = h == h_lo;
    const long long at = ((long long)bi * nc + c) * nh + h;
    __syncthreads();                       // the last head is done with every array
    load_tile(x_s, ldx, x + tok * xrow + (long long)h * hd, xrow, n, hd, qp, L.hp, vec,
              kThreadsM);
    load_tile(dy_s, ldx, dy + tok * xrow + (long long)h * hd, xrow, n, hd, qp, L.hp, vec,
              kThreadsM);
    cp_async_commit();
    for (int j = tid; j < qp; j += kThreadsM) dt_s[j] = j < n ? dt[(tok + j) * nh + h] : 0.f;
    load_state(st_s, L, hstates + at * hdn, hd, N);
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) {
      warp_cumsum(dt_s, a_neg[h], cum, qp, lane);
      __syncwarp();
      for (int j = lane; j < qp; j += 32) ex[j] = expf(cum[j]);
      if (lane == 0) clast[at] = cum[n - 1];
      decay_tables(cum, ehead, etail, eblk, qp, nrb, lane);
    }
    __syncthreads();

    // dC units: the heaviest (last) row blocks first
    for (int k = 0;; ++k) {
      const int f = dealt(k, warp, nrb * L.cs);
      if (f < 0) break;
      const int rb = nrb - 1 - f / L.cs, sp = f % L.cs;
      const int i0 = rb * 16, n0 = sp * 64, ncol = min(64, L.np - n0);
      float acc[8][4];
      zero8(acc);
      rows_times_state<true>(acc, dy_s, ldx, i0, st_s, ldb, L.term, n0, ncol, L.hp, lane);
      const float ea = ex[i0 + gr], eb = ex[i0 + gr + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= ea;
        acc[nt][1] *= ea;
        acc[nt][2] *= eb;
        acc[nt][3] *= eb;
      }
      for (int jb = 0; jb <= rb; ++jb) {
        float sc[2][4], p[2][4];
        uint32_t pt[kTerms][4];
        block_abt(sc, dy_s, ldx, i0, x_s, ldx, jb * 16, L.hp, lane);
        decay_block(p, sc, cum, dt_s, ehead, etail, eblk, i0, jb * 16, true, true, gr, tc);
        split_frag(p, pt);
        frag_times_rows(acc, pt, b_s, ldb, jb * 16, n0, ncol, lane);
      }
      const float2 dot = row_dots(acc, c_s, ldb, i0, n0, ncol, gr, tc);
      if (tc == 0) {
        part[sp * qp + i0 + gr] = dot.x;
        part[sp * qp + i0 + gr + 8] = dot.y;
      }
      add_to_run(run, L.ldr, acc, i0, n0, ncol, first, gr, tc);
    }

    // local units: (16 rows of hd) x (64 columns of N), K over the chunk's
    // rows, from the last warp down (those with the lightest dC units)
    for (int u = kWarpsM - 1 - warp; u < (L.hp / 16) * L.cs; u += kWarpsM) {
      const int m0 = u / L.cs * 16, n0 = u % L.cs * 64, ncol = min(64, L.np - n0);
      float acc[8][4];
      zero8(acc);
      const uint32_t a_addr =
          smem_u32(dy_s + ((lane & 7) + 8 * (lane >> 4)) * ldx + m0 + 8 * ((lane >> 3) & 1));
      for (int k0 = 0; k0 < nrb * 16; k0 += 16) {
        uint32_t xa[4], at4[kTerms][4];
        ldsm_x4_trans(xa, a_addr + 2 * k0 * ldx);
        const float wa0 = ex[k0 + 2 * tc], wa1 = ex[k0 + 2 * tc + 1];
        const float wb0 = ex[k0 + 8 + 2 * tc], wb1 = ex[k0 + 9 + 2 * tc];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = unpack_bf16(xa[q]);
          uint32_t w[kTerms];
          split_bf16(v.x * (q < 2 ? wa0 : wb0), v.y * (q < 2 ? wa1 : wb1), w);
#pragma unroll
          for (int t = 0; t < kTerms; ++t) at4[t][q] = w[t];
        }
        frag_times_rows(acc, at4, c_s, ldb, k0, n0, ncol, lane);
      }
      float* o = local + at * hdn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= ncol) break;
        const int col = n0 + nt * 8 + 2 * tc;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = m0 + gr + 8 * hh;
          if (d >= hd || col >= N) continue;
          float* q = o + (long long)d * N + col;
          if ((N & 1) == 0) {
            *reinterpret_cast<float2*>(q) = make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
          } else {
            q[0] = acc[nt][2 * hh];
            if (col + 1 < N) q[1] = acc[nt][2 * hh + 1];
          }
        }
      }
    }
    __syncthreads();
    // dcum's pass-A share: the column splits' dots, in split order
    for (int i = tid; i < n; i += kThreadsM) {
      float s = 0.f;
      for (int sp = 0; sp < L.cs; ++sp) s += part[sp * qp + i];
      dcum_a[(tok + i) * nh + h] = s;
    }
  }
  __syncthreads();
  float* o = dcslab + (long long)sl * gridDim.z * S * G * N;
  for (int e = tid; e < n * N; e += kThreadsM) {
    const int i = e / N, k = e - i * N;
    o[((tok + i) * G + g) * N + k] = run[i * L.ldr + k];
  }
}

// The reverse state pass, a block per (head, batch row), elementwise over
// [hd, N]: dhout holds each chunk's local gradient (from the dc kernel) and
// dlast its cum_last; walking the chunks from the last, each chunk's entry
// is replaced by dh_out, dlast by <dh_out, h_out> (a fixed-order block sum),
// and dh <- exp(cum_last) dh + local.  dh0 gets the state leaving chunk 0.
// Past the barrier after dh's first store, a thread owns the same elements
// throughout, so the walk needs no other barrier on dh; that first store
// goes element by element, the walk's float4s are owned by other threads.
__global__ void __launch_bounds__(kThreadsScan)
ssd_bwd_scan_kernel(const float* __restrict__ hstates, const float* __restrict__ hfinal,
                    const float* __restrict__ dhfinal, float* __restrict__ dhout,
                    float* __restrict__ dlast, float* __restrict__ dh0, int nc, int nh,
                    int hdn) {
  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  extern __shared__ float dh_s[];          // dh [hdn], then the block sum's [warps]
  float* red = dh_s + hdn;
  const long long hb = (long long)bi * nh + h;
  const float* dhf = dhfinal ? dhfinal + hb * hdn : nullptr;
  for (int e = tid; e < hdn; e += kThreadsScan) dh_s[e] = dhf ? dhf[e] : 0.f;
  __syncthreads();
  const bool v4 = (hdn & 3) == 0;
  for (int c = nc - 1; c >= 0; --c) {
    const long long at = ((long long)bi * nc + c) * nh + h;
    const float decay = expf(dlast[at]);
    const float* ho = c + 1 < nc ? hstates + (at + nh) * hdn : hfinal + hb * hdn;
    float* buf = dhout + at * hdn;
    float part = 0.f;
    if (v4) {
      const float4* ho4 = reinterpret_cast<const float4*>(ho);
      float4* buf4 = reinterpret_cast<float4*>(buf);
      float4* dh4 = reinterpret_cast<float4*>(dh_s);
      const int n4 = hdn / 4;
      for (int base = tid; base < n4; base += kThreadsScan * kScanVec) {
        float4 v[kScanVec], o[kScanVec];
#pragma unroll
        for (int u = 0; u < kScanVec; ++u) {
          const int e = base + u * kThreadsScan;
          if (e < n4) {
            v[u] = buf4[e];
            o[u] = ho4[e];
          }
        }
#pragma unroll
        for (int u = 0; u < kScanVec; ++u) {
          const int e = base + u * kThreadsScan;
          if (e >= n4) break;
          const float4 d = dh4[e];
          buf4[e] = d;
          part = fmaf(d.x, o[u].x, part);
          part = fmaf(d.y, o[u].y, part);
          part = fmaf(d.z, o[u].z, part);
          part = fmaf(d.w, o[u].w, part);
          dh4[e] = make_float4(d.x * decay + v[u].x, d.y * decay + v[u].y,
                               d.z * decay + v[u].z, d.w * decay + v[u].w);
        }
      }
    } else {
      for (int e = tid; e < hdn; e += kThreadsScan) {
        const float v = buf[e], d = dh_s[e];
        buf[e] = d;
        part = fmaf(d, ho[e], part);
        dh_s[e] = d * decay + v;
      }
    }
    const float dot = block_sum<kThreadsScan>(part, red);
    if (tid == 0) dlast[at] = dot;
  }
  if (dh0) {
    float* o = dh0 + hb * hdn;
    for (int e = tid; e < hdn; e += kThreadsScan) o[e] = dh_s[e];
  }
}

// Pass BC and the per-head finish, the dc kernel's grid.  Per head:
//   dB_j = exp(cl - cum_j) dt_j x_j . dh_out + sum_{i>=j} G_ij C_i: units of
//     (16 rows j, 64 columns of N); B_j . dB_j by column split; dB added
//     into the slice's running sum;
//   dxn_j = exp(cl - cum_j) B_j . dh_out^T + sum_{i>=j} (C_i . B_j) L_ij dy_i:
//     units of (16 rows j, 32 columns of hd), C.B^T recomputed exactly per
//     head on the tensor cores (bf16 operands, f32 sums); dx = dt dxn, and
//     x_j . dxn_j by column split;
//   then one warp: dcum = pass A's share - B . dB, plus <dh_out, h_out> at
//     the last row; its reverse cumsum dda; ddt = x . dxn + a dda, and the
//     head's share of da.
__global__ void __launch_bounds__(kThreadsM, 1)
ssd_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_neg, const __nv_bfloat16* __restrict__ bmat,
                      const __nv_bfloat16* __restrict__ cmat,
                      const __nv_bfloat16* __restrict__ dy, const float* __restrict__ dhout,
                      const float* __restrict__ dlast, __nv_bfloat16* __restrict__ dx,
                      float* __restrict__ ddt, float* __restrict__ dbslab,
                      float* __restrict__ dapart, int S, int nh, int hd, int G, int N, int Q,
                      int slices, int vec) {
  const int c = blockIdx.x, bi = blockIdx.z;
  const int g = blockIdx.y / slices, sl = blockIdx.y % slices;
  const int rep = nh / G, per = (rep + slices - 1) / slices;
  const int h_lo = g * rep + sl * per, h_hi = min(h_lo + per, (g + 1) * rep);
  const int nc = (S + Q - 1) / Q;
  const int t0 = c * Q, n = min(Q, S - t0);
  const long long tok = (long long)bi * S + t0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane / 4, tc = lane % 4;
  const BwdLayout L = make_bwd_layout(hd, N, Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.b);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.c);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.x);
  __nv_bfloat16* dy_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.dy);
  __nv_bfloat16* st_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.st);
  float* run = reinterpret_cast<float*>(smem_raw + L.run);
  float* part = reinterpret_cast<float*>(smem_raw + L.part);
  float* partx = reinterpret_cast<float*>(smem_raw + L.partx);
  float* dt_s = reinterpret_cast<float*>(smem_raw + L.dt);
  float* cum = reinterpret_cast<float*>(smem_raw + L.cum);
  float* ex = reinterpret_cast<float*>(smem_raw + L.ex);
  float* ehead = reinterpret_cast<float*>(smem_raw + L.ehead);
  float* etail = reinterpret_cast<float*>(smem_raw + L.etail);
  float* eblk = reinterpret_cast<float*>(smem_raw + L.eblk);
  float* dcum = reinterpret_cast<float*>(smem_raw + L.dcum);
  float* ddtd = reinterpret_cast<float*>(smem_raw + L.ddtd);
  const int qp = L.qp, ldx = L.ldx, ldb = L.ldb;
  const long long xrow = (long long)nh * hd, brow = (long long)G * N;
  const long long hdn = (long long)hd * N;
  const int nrb = (n + 15) / 16;

  load_tile(b_s, ldb, bmat + tok * brow + (long long)g * N, brow, n, N, qp, L.np, vec,
            kThreadsM);
  load_tile(c_s, ldb, cmat + tok * brow + (long long)g * N, brow, n, N, qp, L.np, vec,
            kThreadsM);
  for (int h = h_lo; h < h_hi; ++h) {
    const bool first = h == h_lo;
    const float a = a_neg[h];
    const long long at = ((long long)bi * nc + c) * nh + h;
    __syncthreads();                       // the last head is done with every array
    load_tile(x_s, ldx, x + tok * xrow + (long long)h * hd, xrow, n, hd, qp, L.hp, vec,
              kThreadsM);
    load_tile(dy_s, ldx, dy + tok * xrow + (long long)h * hd, xrow, n, hd, qp, L.hp, vec,
              kThreadsM);
    cp_async_commit();
    for (int j = tid; j < qp; j += kThreadsM) {
      dt_s[j] = j < n ? dt[(tok + j) * nh + h] : 0.f;
      dcum[j] = j < n ? ddt[(tok + j) * nh + h] : 0.f;
    }
    load_state(st_s, L, dhout + at * hdn, hd, N);
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) {
      warp_cumsum(dt_s, a, cum, qp, lane);
      __syncwarp();
      const float cl = cum[n - 1];
      for (int j = lane; j < qp; j += 32) ex[j] = expf(cl - cum[j]);
      decay_tables(cum, ehead, etail, eblk, qp, nrb, lane);
    }
    __syncthreads();

    // dB units: the heaviest (first) row blocks first
    for (int k = 0;; ++k) {
      const int f = dealt(k, warp, nrb * L.cs);
      if (f < 0) break;
      const int rb = f / L.cs, sp = f % L.cs;
      const int j0 = rb * 16, n0 = sp * 64, ncol = min(64, L.np - n0);
      float acc[8][4];
      zero8(acc);
      rows_times_state<true>(acc, x_s, ldx, j0, st_s, ldb, L.term, n0, ncol, L.hp, lane);
      const float fa = ex[j0 + gr] * dt_s[j0 + gr], fb = ex[j0 + gr + 8] * dt_s[j0 + gr + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= fa;
        acc[nt][1] *= fa;
        acc[nt][2] *= fb;
        acc[nt][3] *= fb;
      }
      for (int ib = rb; ib < nrb; ++ib) {
        float sc[2][4], p[2][4];
        uint32_t pt[kTerms][4];
        block_abt(sc, x_s, ldx, j0, dy_s, ldx, ib * 16, L.hp, lane);
        decay_block(p, sc, cum, dt_s, ehead, etail, eblk, j0, ib * 16, false, true, gr, tc);
        split_frag(p, pt);
        frag_times_rows(acc, pt, c_s, ldb, ib * 16, n0, ncol, lane);
      }
      const float2 dot = row_dots(acc, b_s, ldb, j0, n0, ncol, gr, tc);
      if (tc == 0) {
        part[sp * qp + j0 + gr] = dot.x;
        part[sp * qp + j0 + gr + 8] = dot.y;
      }
      add_to_run(run, L.ldr, acc, j0, n0, ncol, first, gr, tc);
    }

    // dxn units, dealt from the last warp down: the heaviest dB units went
    // to the first
    for (int k = 0;; ++k) {
      const int f = dealt(k, kWarpsM - 1 - warp, nrb * L.csx);
      if (f < 0) break;
      const int rb = f / L.csx, sp = f % L.csx;
      const int j0 = rb * 16, d0 = sp * 32, ncol = min(32, L.hp - d0);
      float acc[8][4];
      zero8(acc);
      rows_times_state<false>(acc, b_s, ldb, j0, st_s, ldb, L.term, d0, ncol, L.np, lane);
      const float fa = ex[j0 + gr], fb = ex[j0 + gr + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= fa;
        acc[nt][1] *= fa;
        acc[nt][2] *= fb;
        acc[nt][3] *= fb;
      }
      for (int ib = rb; ib < nrb; ++ib) {
        float sc[2][4], p[2][4];
        uint32_t pt[kTerms][4];
        block_abt(sc, b_s, ldb, j0, c_s, ldb, ib * 16, L.np, lane);
        decay_block(p, sc, cum, dt_s, ehead, etail, eblk, j0, ib * 16, false, false, gr, tc);
        split_frag(p, pt);
        frag_times_rows(acc, pt, dy_s, ldx, ib * 16, d0, ncol, lane);
      }
      const float2 dot = row_dots(acc, x_s, ldx, j0, d0, ncol, gr, tc);
      if (tc == 0) {
        partx[sp * qp + j0 + gr] = dot.x;
        partx[sp * qp + j0 + gr + 8] = dot.y;
      }
      // dx = dt dxn
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= ncol) break;
        const int col = d0 + nt * 8 + 2 * tc;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = j0 + gr + 8 * hh;
          if (j >= n || col >= hd) continue;
          const float w = dt_s[j];
          __nv_bfloat16* o = dx + (tok + j) * xrow + (long long)h * hd + col;
          if ((hd & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(w * acc[nt][2 * hh], w * acc[nt][2 * hh + 1]);
          } else {
            o[0] = __float2bfloat16(w * acc[nt][2 * hh]);
            if (col + 1 < hd) o[1] = __float2bfloat16(w * acc[nt][2 * hh + 1]);
          }
        }
      }
    }
    __syncthreads();

    // dda = the reverse cumsum of dcum (with <dh_out, h_out> at the last
    // row); ddt = x . dxn + a dda; the head's share of da = sum dt dda
    if (warp == 0) {
      for (int j = lane; j < n; j += 32) {
        float s = dcum[j], d = 0.f;
        for (int sp = 0; sp < L.cs; ++sp) s -= part[sp * qp + j];
        for (int sp = 0; sp < L.csx; ++sp) d += partx[sp * qp + j];
        dcum[j] = s;
        ddtd[j] = d;
      }
      __syncwarp();
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
      float run_ = incl - tot, da = 0.f;
      for (int k = per_l - 1; k >= 0; --k) {
        const int j = j0 + k;
        if (j >= n) continue;
        run_ += dcum[j];
        ddt[(tok + j) * nh + h] = ddtd[j] + a * run_;
        da = fmaf(dt_s[j], run_, da);
      }
      for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0) dapart[at] = da;
    }
  }
  __syncthreads();
  float* o = dbslab + (long long)sl * gridDim.z * S * G * N;
  for (int e = tid; e < n * N; e += kThreadsM) {
    const int j = e / N, k = e - j * N;
    o[((tok + j) * G + g) * N + k] = run[j * L.ldr + k];
  }
}

// The smem the scan needs: dh and the block sum's partials.
__host__ __device__ inline size_t scan_smem(int hd, int N) {
  return sizeof(float) * ((size_t)hd * N + kThreadsScan / 32);
}

cudaError_t launch_mma(const void* dy, const float* dt, const float* a_neg, const void* x,
                       const void* bmat, const void* cmat, const float* hstates,
                       const float* hfinal, const float* dhfinal, float* dhout, float* dlast,
                       float* dbslab, float* dcslab, float* dapart, void* dx, float* ddt,
                       float* da, void* dbmat, void* dcmat, float* dh0, int B, int S, int nh,
                       int hd, int G, int N, int Q, int slices, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int nc = (S + Q - 1) / Q;
  const size_t smem = make_bwd_layout(hd, N, Q).total, smem_s = scan_smem(hd, N);
  if (smem > (size_t)kMaxSmem || smem_s > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_dc_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_dx_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_s);
  if (e != cudaSuccess) return e;
  // 16-byte copies need every row of x, dy, B and C to start on 16 bytes
  const int vec = hd % 8 == 0 && N % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                    reinterpret_cast<uintptr_t>(bmat) | reinterpret_cast<uintptr_t>(cmat)) &
                   15) == 0;
  const dim3 grid((unsigned)nc, (unsigned)(G * slices), (unsigned)B);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* dyt = static_cast<const bf16*>(dy);
  const bf16* bt = static_cast<const bf16*>(bmat);
  const bf16* ct = static_cast<const bf16*>(cmat);
  ssd_bwd_dc_mma_kernel<<<grid, kThreadsM, smem, stream>>>(
      xt, dt, a_neg, bt, ct, dyt, hstates, dhout, dlast, ddt, dcslab, S, nh, hd, G, N, Q,
      slices, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_scan_kernel<<<dim3(nh, B), kThreadsScan, smem_s, stream>>>(
      hstates, hfinal, dhfinal, dhout, dlast, dh0, nc, nh, hd * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_dx_mma_kernel<<<grid, kThreadsM, smem, stream>>>(
      xt, dt, a_neg, bt, ct, dyt, dhout, dlast, static_cast<bf16*>(dx), ddt, dbslab, dapart, S,
      nh, hd, G, N, Q, slices, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long elems = (long long)B * S * G * N;
  ssd_bwd_reduce_kernel<bf16><<<(unsigned)((elems + kThreads - 1) / kThreads + 1), kThreads,
                                0, stream>>>(dbslab, dcslab, dapart, static_cast<bf16*>(dbmat),
                                             static_cast<bf16*>(dcmat), da, elems, slices,
                                             B * nc, nh);
  return cudaGetLastError();
}
}  // namespace

// Shared memory (bytes) the body's largest block needs at dtype code `dtype`
// (0 float32, 1 bfloat16), head dim hd, state N and chunk Q; for float32, -1
// if no row tile fits.
extern "C" long long repro_ssd_scan_bwd_smem(int dtype, int hd, int N, int Q) {
  if (dtype == 1) {
    const long long a = (long long)make_bwd_layout(hd, N, Q).total;
    const long long b = (long long)scan_smem(hd, N);
    return a > b ? a : b;
  }
  const int tr = chunk_tile(hd, N, Q, 4);
  if (tr == 0) return -1;
  const long long a = (long long)sizeof(float) * make_state_layout(hd, N, Q).total;
  const long long b = (long long)make_chunk_layout(hd, N, Q, 4, tr).total;
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

// dtype: 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor-core
// body), of x, B, C, dy, dx, dB and dC; the rest
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
    return launch_mma(dy, f_dt, f_a, x, bmat, cmat, f_hs, f_hf, f_dhf, f[0], f[1], f[2], f[3],
                      f[4], dx, f[5], f[6], dbmat, dcmat, f[7], B, S, nh, hd, G, N, Q, slices,
                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}
