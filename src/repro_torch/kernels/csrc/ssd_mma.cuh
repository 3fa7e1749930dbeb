// ssd_mma.cuh — the tensor-core pieces shared by the SSD scan's bf16 bodies,
// forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu): mma.sync m16n8k16
// bf16 -> f32, ldmatrix, the split of f32 values into bf16 terms, and the
// cp.async tile loads.  The decode body's tensor-core instance
// (decode_attention.cu) takes the mma and ldmatrix pieces.
//
// Fragments of mma m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8, columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3); B holds
// rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g; C holds rows g
// (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.  So two n8 tiles of an f32
// accumulator, split into bf16 pairs, are the A fragment of the next product
// over those 16 columns.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ssd {

constexpr int kTerms = 2;                  // bf16 terms an f32 operand is split into

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits for every committed group but the newest.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace ssd
