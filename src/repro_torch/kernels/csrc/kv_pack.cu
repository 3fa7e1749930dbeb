// kv_pack / kv_pack_ragged / kv_unpack — DejaVuLib "buffered copies" (paper
// §4.1) on Hopper.
//
// Replaces the TPU kernels `kv_pack`, `kv_pack_ragged` and `kv_unpack` of
// src/repro/kernels/kv_pack.py (one Pallas grid step per (layer, batch row,
// token block)).  Here one kernel serves all three: buffer row (l, b) is the
// token window cache[l, b, s_b : s_b + W], where s_b = starts[b] (ragged) or
// the broadcast scalar t0 (starts == nullptr).  The pack entries copy the
// window out of the cache into the dense buffer; kv_unpack copies the buffer
// back into the window, in place (the TPU kernel aliases the cache).
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

// kToCache = false: buffer <- cache window (pack); true: cache window <- buffer.
template <typename Vec, bool kToCache>
__global__ void window_copy_kernel(char* __restrict__ cache, char* __restrict__ buf,
                                   const RowStarts starts, int B, long long stride_l,
                                   long long stride_b, long long row_bytes,
                                   long long win_vecs) {
  const int b = blockIdx.y;
  const int l = blockIdx.z;
  const long long start = starts.v[b];
  Vec* c = reinterpret_cast<Vec*>(cache + l * stride_l + b * stride_b + start * row_bytes);
  Vec* w = reinterpret_cast<Vec*>(buf + ((long long)l * B + b) * win_vecs * sizeof(Vec));
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < win_vecs;
       i += (long long)gridDim.x * blockDim.x) {
    if (kToCache)
      c[i] = w[i];
    else
      w[i] = c[i];
  }
}

template <typename Vec, bool kToCache>
cudaError_t launch(void* cache, void* buf, const RowStarts& starts, int L, int B,
                   long long stride_l, long long stride_b, long long row_bytes, int W,
                   cudaStream_t stream) {
  const long long win_vecs = (long long)W * row_bytes / (long long)sizeof(Vec);
  const int threads = 256;
  long long bx = (win_vecs + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)B, (unsigned)L);
  window_copy_kernel<Vec, kToCache><<<grid, threads, 0, stream>>>(
      static_cast<char*>(cache), static_cast<char*>(buf), starts, B, stride_l, stride_b,
      row_bytes, win_vecs);
  return cudaGetLastError();
}

template <bool kToCache>
cudaError_t launch_vec(void* cache, void* buf, const RowStarts& rs, int L, int B,
                       long long stride_l, long long stride_b, long long row_bytes, int W,
                       int vec_bytes, cudaStream_t s) {
  switch (vec_bytes) {
    case 16: return launch<uint4, kToCache>(cache, buf, rs, L, B, stride_l, stride_b, row_bytes, W, s);
    case 8: return launch<uint2, kToCache>(cache, buf, rs, L, B, stride_l, stride_b, row_bytes, W, s);
    case 4: return launch<unsigned int, kToCache>(cache, buf, rs, L, B, stride_l, stride_b, row_bytes, W, s);
    case 2: return launch<unsigned short, kToCache>(cache, buf, rs, L, B, stride_l, stride_b, row_bytes, W, s);
    default: return cudaErrorInvalidValue;
  }
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
  return launch_vec<false>(const_cast<void*>(src), dst, rs, L, B, src_stride_l, src_stride_b,
                           row_bytes, W, vec_bytes, static_cast<cudaStream_t>(stream));
}

// The inverse copy: buf, a dense [L, B, W, H, D], into cache[:, :, t0:t0+W]
// in place.  Strides and row_bytes as for repro_kv_pack.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_kv_unpack(void* cache, const void* buf, int t0, int L, int B,
                               long long stride_l, long long stride_b, long long row_bytes,
                               int W, int vec_bytes, void* stream) {
  if (B < 1 || B > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  RowStarts rs;
  for (int b = 0; b < B; ++b) rs.v[b] = t0;
  return launch_vec<true>(cache, const_cast<void*>(buf), rs, L, B, stride_l, stride_b,
                          row_bytes, W, vec_bytes, static_cast<cudaStream_t>(stream));
}
