// embed_bag: weighted bags of table rows, in float32.
//
// Replaces the Pallas kernel src/repro/kernels/embed_bag/kernel.py:
// _embed_bag_kernel. It computes
//
//   out[b, :] = sum over l = 0 .. L-1 of w[b, l] * table[idx[b, l], :]
//
// for table [N, D] f32, idx [B, L] int32, w [B, L] f32. Index semantics
// are the reference gather's: -N <= idx < 0 reads row idx + N, and any
// other index outside [0, N) contributes NaN (so the bag's row is NaN
// whatever its weight). The kernel never reads outside the table. The TPU
// version pads B to its block of 128 bags; that is a tiling artefact and
// is dropped here.
//
// Layout: one warp per bag, four bags per CTA. The lanes run over the D
// columns, as float4 when D % 4 == 0 (each 256-byte row at D = 64 is then
// one coalesced read of 16 lanes), else as floats. Each lane sums its
// columns over l in order 0 .. L-1; every lane reads the same idx and w,
// so those loads broadcast. Row offsets are int64: idx * D reaches 6.7e8
// at the widths of the MIND config.
//
// What bounds it: memory. Per bag slot it reads a 4*D-byte row at random
// plus 8 bytes of idx and w, and does D multiply-adds; at D = 64 that is
// 0.5 operations per byte, far below the card's balance point.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

template <typename V>
__device__ __forceinline__ void fma_row(V& acc, float wl, const V& x);

template <>
__device__ __forceinline__ void fma_row<float>(float& acc, float wl,
                                               const float& x) {
  acc += wl * x;
}

template <>
__device__ __forceinline__ void fma_row<float4>(float4& acc, float wl,
                                                const float4& x) {
  acc.x += wl * x.x;
  acc.y += wl * x.y;
  acc.z += wl * x.z;
  acc.w += wl * x.w;
}

template <typename V>
__device__ __forceinline__ V nan_row();

template <>
__device__ __forceinline__ float nan_row<float>() {
  return __int_as_float(0x7fc00000);
}

template <>
__device__ __forceinline__ float4 nan_row<float4>() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

// V is float or float4; `cols` counts V columns of a row (D or D / 4).
template <typename V>
__global__ void embed_bag_kernel(const V* __restrict__ table,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ w,
                                 V* __restrict__ out, long long n, int cols,
                                 int batch, int bag) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= batch) return;
  const int* idx_b = idx + b * bag;
  const float* w_b = w + b * bag;
  for (int j = lane; j < cols; j += 32) {
    V acc{};
#pragma unroll 4
    for (int l = 0; l < bag; ++l) {
      long long i = idx_b[l];
      if (i < 0) i += n;
      const V x = (i >= 0 && i < n) ? table[i * cols + j] : nan_row<V>();
      fma_row(acc, w_b[l], x);
    }
    out[b * cols + j] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int embed_bag_launch(const float* table, const int* idx,
                                const float* w, float* out, long long n,
                                int d, int batch, int bag, void* stream) {
  if (batch == 0 || d == 0) return 0;
  const unsigned int grid = (batch + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    embed_bag_kernel<float4><<<grid, kWarps * 32, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx, w,
        reinterpret_cast<float4*>(out), n, d / 4, batch, bag);
  } else {
    embed_bag_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        table, idx, w, out, n, d, batch, bag);
  }
  return static_cast<int>(cudaGetLastError());
}
