// A variant of kernel D (src/repro_torch/csrc/embed_bag.cu) for
// tools/probe_embed_bag.py --variants, and for nothing else: the same
// geometry, slot order and sums, but each lane's 16-byte row pieces go
// through a cp.async ring in shared memory, kStages steps of kUnroll rows
// in flight, each step issued kStages - 1 steps before its FMAs, where
// the kernel loads one step into registers and adds it before it issues
// the next. float4 rows only (vec = 4); the C interface is the kernel's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;
constexpr int kStages = 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 a) {
  return make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y), fmaf(w, x.z, a.z),
                     fmaf(w, x.w, a.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int m) {
  return make_float4(__shfl_xor_sync(kFull, v.x, m),
                     __shfl_xor_sync(kFull, v.y, m),
                     __shfl_xor_sync(kFull, v.z, m),
                     __shfl_xor_sync(kFull, v.w, m));
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

__global__ void __launch_bounds__(256)
    embed_bag_ring_kernel(const float4* __restrict__ table,
                          const int* __restrict__ idx,
                          const float* __restrict__ w,
                          float4* __restrict__ out, long long n, int cols,
                          int batch, int bag, int lanes, int groups,
                          int warps, int bags, int per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nwarps = blockDim.x >> 5;
  float4* ring = reinterpret_cast<float4*>(smem);  // [warp][stage][u][lane]
  float4* part = ring + nwarps * kStages * kUnroll * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* mine = ring + warp * kStages * kUnroll * 32 + lane;
  const int g = lane / lanes;
  const int c = lane - g * lanes;
  const int k = warp / warps;
  const int wb = warp - k * warps;
  const long long b = static_cast<long long>(blockIdx.x) * bags + k;
  const bool live = b < batch;
  const int lo = min(wb * per_warp, bag);
  const int hi = min(lo + per_warp, bag);
  const int* idx_b = idx + b * bag;
  const float* w_b = w + b * bag;
  const float q = __int_as_float(0x7fc00000);
  for (int j0 = 0; j0 < cols; j0 += lanes) {
    const int j = j0 + c;
    const bool col = live && j < cols;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const int cnt = min(32, hi - c0);
      int my_i = 0;
      float my_w = 0.f;
      if (live && lane < cnt) {
        my_i = idx_b[c0 + lane];
        my_w = w_b[c0 + lane];
      }
      const int per_step = groups * kUnroll;
      const int steps = (cnt + per_step - 1) / per_step;
      for (int st = 0; st < steps + kStages - 1; ++st) {
        if (st < steps) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int t = st * per_step + u * groups + g;
            long long r = __shfl_sync(kFull, my_i, t & 31);
            if (r < 0) r += n;
            if (col && t < cnt && r >= 0 && r < n)
              cp_async16(mine + ((st % kStages) * kUnroll + u) * 32,
                         table + r * cols + j);
          }
        }
        cp_commit();
        const int use = st - (kStages - 1);
        if (use >= 0) {
          cp_wait_oldest();
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int t = use * per_step + u * groups + g;
            long long r = __shfl_sync(kFull, my_i, t & 31);
            const float wu = __shfl_sync(kFull, my_w, t & 31);
            if (r < 0) r += n;
            if (col && t < cnt) {
              const float4 x =
                  (r >= 0 && r < n)
                      ? mine[((use % kStages) * kUnroll + u) * 32]
                      : make_float4(q, q, q, q);
              acc = fma4(wu, x, acc);
            }
          }
        }
      }
    }
    for (int m = lanes; m < 32; m <<= 1) acc = add4(acc, shfl_xor4(acc, m));
    if (warps == 1) {
      if (col && g == 0) out[b * cols + j] = acc;
    } else {
      if (g == 0) part[(k * warps + wb) * lanes + c] = acc;
      __syncthreads();
      if (col && g == 0 && wb == 0) {
        float4 s = part[k * warps * lanes + c];
        for (int p = 1; p < warps; ++p)
          s = add4(s, part[(k * warps + p) * lanes + c]);
        out[b * cols + j] = s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int embed_bag_launch(const float* table, const int* idx,
                                const float* w, float* out, long long n,
                                int d, int batch, int bag, int vec, int lanes,
                                int groups, int warps, int bags, int per_warp,
                                void* stream) {
  if (batch == 0 || d == 0) return 0;
  const int threads = 32 * warps * bags;
  if (vec != 4 || d % 4 != 0 || lanes * groups != 32 || threads > 256 ||
      static_cast<long long>(warps) * per_warp < bag)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(threads / 32) * kStages * kUnroll * 32 * 16 +
      (warps > 1 ? static_cast<size_t>(warps) * bags * lanes * 16 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        embed_bag_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned int grid = (batch + bags - 1) / bags;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  embed_bag_ring_kernel<<<grid, threads, smem, s>>>(
      reinterpret_cast<const float4*>(table), idx, w,
      reinterpret_cast<float4*>(out), n, d / 4, batch, bag, lanes, groups,
      warps, bags, per_warp);
  return static_cast<int>(cudaGetLastError());
}
