// flash_attention — whole-prompt prefill attention on Hopper.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py: q [B, Sq, Hq, D] against k/v
// [B, Skv, Hkv, D], causal with the offset of a query block that sits at the
// end of the keys (query i sees keys j <= i + (Skv - Sq)) or, with
// causal = 0, every key.  Online softmax with f32 m / l / acc, scale D^-0.5,
// the finite NEG_INF = -0.7 * FLT_MAX of the reference, division by l at the
// end, output in q's type.  Query head h reads KV head h / G (G = Hq / Hkv).
//
// The Pallas grid walks (B, Hq, query block, key block) in order and carries
// m / l / acc across the key blocks in VMEM scratch.  Hopper blocks run in no
// order, so here one block owns (batch, query head, tile of 64 query rows)
// and loops over the key tiles itself, carrying the softmax state in
// registers.  The loop stops at the causal limit of the tile's last row
// (qpos_max + Skv - Sq), so a causal prompt reads about half the keys; the
// ragged tails of Sq and Skv are masked inside the block instead of padded.
//
// What bounds it on the H100: the work is 4 * B * Hq * Sq * Skv * D flops (half
// that when causal) against q, k, v and out read or written once.  At head
// dim 64 in bf16 that is about S / 4 flops per byte for a causal prompt of S
// tokens, so the bytes over 3.35 TB/s bound it below some 1,200 tokens and
// the tensor cores' 989 TFLOP/s above.  This first version reaches neither:
// it computes in f32 on the CUDA cores, not on the tensor cores:
//   * each of the 128 threads holds a 4 x 8 patch of the 64 x 64 score tile
//     and a 4 x (D/8) patch of the output in registers, so each shared-memory
//     read feeds several FMAs;
//   * shared rows are padded to D + 1 floats, so the column-wise reads of
//     the score and P.V loops hit distinct banks;
//   * rows of 8 threads reduce the row max and sum with warp shuffles.
// Moving Q.K^T and P.V onto wgmma with TMA-fed, pipelined tiles is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;
constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 64;                    // keys per tile
constexpr int kLanes = 8;                  // threads sharing one row group
constexpr int kRows = kBQ / (kThreads / kLanes);   // 4 query rows per thread
constexpr int kCols = kBK / kLanes;                // 8 keys per thread per tile
constexpr int kLdp = kBK + 1;

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

// Copies rows [0, n) of D elements (row stride `row` elements) into f32
// shared rows of stride ld, 16 bytes per thread per step; rows [n, fill) are
// zeroed.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long row, int n,
                                           int fill, float* dst, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < fill * kPerRow; i += kThreads) {
    const int j = i / kPerRow, c = i - j * kPerRow;
    float* d = dst + j * ld + c * kVec;
    if (j < n) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + (long long)j * row + c * kVec);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = to_float(e[x]);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = 0.f;
    }
  }
}

__device__ __forceinline__ float group_max(float x) {
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal, float scale) {
  constexpr int kDCols = D / kLanes;       // output dims per thread
  constexpr int ld = D + 1;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x;
  const int tr = tid / kLanes;             // row group: rows tr*kRows ..
  const int tc = tid % kLanes;             // keys tc + 8*j, dims tc + 8*j

  extern __shared__ float smem[];
  float* q_s = smem;                       // [kBQ][D+1]
  float* k_s = q_s + kBQ * ld;             // [kBK][D+1]
  float* v_s = k_s + kBK * ld;             // [kBK][D+1]
  float* p_s = v_s + kBK * ld;             // [kBQ][kBK+1]

  const long long qrow = (long long)Hq * D;    // elements between consecutive tokens
  const long long krow = (long long)Hkv * D;
  stage_rows<T, D>(q + ((long long)b * Sq + q0) * qrow + (long long)h * D, qrow, nq, kBQ,
                   q_s, ld);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  const int off = Skv - Sq;
  // keys past the causal limit of the tile's last row are masked for every
  // row of the tile: the loop never reads them
  const int kend = causal ? min(Skv, q0 + nq + off) : Skv;
  const T* kb = k + (long long)b * Skv * krow + (long long)hk * D;
  const T* vb = v + (long long)b * Skv * krow + (long long)hk * D;

  for (int t0 = 0; t0 < kend; t0 += kBK) {
    const int n = min(kBK, kend - t0);
    __syncthreads();                       // the last tile's P.V reads are done
    stage_rows<T, D>(kb + (long long)t0 * krow, krow, n, n, k_s, ld);
    stage_rows<T, D>(vb + (long long)t0 * krow, krow, n, n, v_s, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(tr * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tc + kLanes * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = tr * kRows + i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = tc + kLanes * j;
        const bool ok = key < n && (!causal || t0 + key <= qpos + off);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = tc + kLanes * j;
        const float p = key < n ? expf(s[i][j] - m_new) : 0.f;
        p_s[row * kLdp + key] = p;
        sum += p;
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(tr * kRows + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const float vv = v_s[j * ld + tc + kLanes * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = tr * kRows + i;
    if (row >= nq) continue;
    T* o = out + ((long long)b * Sq + q0 + row) * qrow + (long long)h * D;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) o[tc + kLanes * c] = from_float<T>(acc[i][c] / l[i]);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
                          (size_t)kBQ * kLdp);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                     int Skv, int Hq, int Hkv, int D, int causal, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) one block needs at head dim D.
extern "C" long long repro_flash_attention_smem(int D) { return (long long)smem_bytes(D); }

// dtype: 0 = float32, 1 = bfloat16.  q/out [B,Sq,Hq,D], k/v [B,Skv,Hkv,D],
// contiguous and 16-byte aligned; D in {16, 32, 64, 128}; Hq % Hkv == 0; a
// causal call needs Sq <= Skv (every query row sees a key).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Sq, int Skv, int Hq, int Hkv,
                                     int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
