// ssd_patch.cuh — the CUDA-core tile products shared by the SSD scan's f32
// forward body (ssd_scan.cu) and its backward (ssd_scan_bwd.cu).
//
// A block's threads compute an R x C product by patches: a thread holds
// kTR x kTC outputs, rows r0 + i*nrt and columns c0 + j*nct
// (strided, so that neighbouring threads take neighbouring columns), and
// reads both operands from shared memory, in float32 or bfloat16, with any
// row and column strides.  Every sum runs over k in order, so a product is
// deterministic.
#pragma once

#include <cuda_bf16.h>

namespace ssd {

constexpr int kTR = 4;                     // output rows per thread patch
constexpr int kTC = 4;                     // output columns per thread patch

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

// One thread's patch of an R x C product, clamped into range so that every
// read stays inside its array; callers drop the clamped rows and columns
// (rok, cok false) when they write.  `ct` is the patch's column group, in
// [0, (C + kTC - 1) / kTC): a row's patches have distinct ones.
struct Patch {
  int r[kTR], c[kTC];
  bool rok[kTR], cok[kTC];
  int ct;
};

__device__ __forceinline__ Patch make_patch(int tile, int R, int C) {
  const int nrt = (R + kTR - 1) / kTR, nct = (C + kTC - 1) / kTC;
  const int rt = tile / nct, ct = tile - rt * nct;
  Patch P;
  P.ct = ct;
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
template <typename TA, typename TB>
__device__ __forceinline__ void mma_patch(float (&acc)[kTR][kTC], const Patch& P, const TA* a,
                                          int ars, int aks, const TB* bm, int bks, int bcs,
                                          int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[kTR], bv[kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i) av[i] = to_float(a[P.r[i] * ars + k * aks]);
#pragma unroll
    for (int j = 0; j < kTC; ++j) bv[j] = to_float(bm[k * bks + P.c[j] * bcs]);
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
// into shared rows of stride ld, converted to TD
template <typename TS, typename TD>
__device__ __forceinline__ void load_rows(const TS* __restrict__ src, long long stride, int n,
                                          int width, TD* dst, int ld) {
  for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
    const int j = e / width, d = e - j * width;
    dst[j * ld + d] = from_float<TD>(to_float(src[(long long)j * stride + d]));
  }
}

// The inclusive cumsum of v[j] * a over j < Q into cum[0, Q), by one warp
// (lane `lane`); the order of the sums is fixed.
__device__ __forceinline__ void warp_cumsum(const float* v, float a, float* cum, int Q,
                                            int lane) {
  const int per = (Q + 31) / 32, j0 = lane * per;
  float tot = 0.f;
  for (int k = 0; k < per; ++k)
    if (j0 + k < Q) tot += v[j0 + k] * a;
  float incl = tot;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float run = incl - tot;
  for (int k = 0; k < per; ++k)
    if (j0 + k < Q) {
      run += v[j0 + k] * a;
      cum[j0 + k] = run;
    }
}

}  // namespace ssd
