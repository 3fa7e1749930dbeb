// kv_pack / kv_pack_ragged — DejaVuLib "buffered copies" (paper §4.1) on Hopper.
//
// Replaces the TPU kernels `kv_pack` and `kv_pack_ragged` of
// src/repro/kernels/kv_pack.py (one Pallas grid step per (layer, batch row,
// token block)).  Here one kernel serves both: destination row (l, b) is the
// token window cache[l, b, s_b : s_b + W], where s_b = starts[b] (ragged) or
// the broadcast scalar t0 (starts == nullptr).
//
// What bounds it on the H100: bytes.  It does no arithmetic; the least time is
// (bytes read + bytes written) / 3.35 TB/s.  The design follows from that:
//   * each (l, b) window is W*H*D elements that are contiguous in both the
//     source (the S, H, D dims are dense) and the destination, so the copy is
//     a flat run of 16-byte vectors per window, every thread moving one
//     vector per step and neighbouring threads touching neighbouring addresses;
//   * the vector width (16, 8, 4 or 2 bytes) is the largest that divides the
//     pointers, the window and the layer/batch strides, chosen by the wrapper;
//   * the layer and batch strides are arguments, so a row view of a larger
//     cache (the per-sequence chunk write-back) is copied without staging.
//   * the per-row starts travel by value in the kernel's parameters (what
//     scalar prefetch did on the TPU), so a launch needs no host-to-device
//     copy of them; the wrapper has already checked alignment and bounds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxRows = 512;          // 2 KB of the kernel's 4 KB of parameters
struct RowStarts {
  int v[kMaxRows];
};

template <typename Vec>
__global__ void kv_pack_kernel(const char* __restrict__ src, char* __restrict__ dst,
                               const RowStarts starts, int B, long long src_stride_l,
                               long long src_stride_b, long long row_bytes,
                               long long win_vecs) {
  const int b = blockIdx.y;
  const int l = blockIdx.z;
  const long long start = starts.v[b];
  const Vec* s = reinterpret_cast<const Vec*>(
      src + l * src_stride_l + b * src_stride_b + start * row_bytes);
  Vec* d = reinterpret_cast<Vec*>(dst + ((long long)l * B + b) * win_vecs * sizeof(Vec));
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < win_vecs;
       i += (long long)gridDim.x * blockDim.x) {
    d[i] = s[i];
  }
}

template <typename Vec>
cudaError_t launch(const void* src, void* dst, const RowStarts& starts, int L, int B,
                   long long src_stride_l, long long src_stride_b, long long row_bytes,
                   int W, cudaStream_t stream) {
  const long long win_vecs = (long long)W * row_bytes / (long long)sizeof(Vec);
  const int threads = 256;
  long long bx = (win_vecs + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)B, (unsigned)L);
  kv_pack_kernel<Vec><<<grid, threads, 0, stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), starts, B, src_stride_l,
      src_stride_b, row_bytes, win_vecs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_kv_pack_max_rows() { return kMaxRows; }

// All strides and row_bytes (H*D*element size) are in bytes.  starts is a
// HOST int32 [B] (B <= kMaxRows) or null, and then every row starts at t0.
// dst is a dense [L, B, W, H, D].  Returns cudaGetLastError() after the launch.
extern "C" int repro_kv_pack(const void* src, void* dst, const int* starts, int t0,
                             int L, int B, long long src_stride_l,
                             long long src_stride_b, long long row_bytes, int W,
                             int vec_bytes, void* stream) {
  if (B < 1 || B > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  RowStarts rs;
  for (int b = 0; b < B; ++b) rs.v[b] = starts ? starts[b] : t0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(src, dst, rs, L, B, src_stride_l, src_stride_b, row_bytes, W, s);
    case 8: return launch<uint2>(src, dst, rs, L, B, src_stride_l, src_stride_b, row_bytes, W, s);
    case 4: return launch<unsigned int>(src, dst, rs, L, B, src_stride_l, src_stride_b, row_bytes, W, s);
    case 2: return launch<unsigned short>(src, dst, rs, L, B, src_stride_l, src_stride_b, row_bytes, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
