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
// What bounds it: memory. Per bag slot it reads a 4*D-byte row at random
// plus 8 bytes of idx and w, and does D multiply-adds; at D = 64 that is
// 0.5 operations per byte, far below the card's balance point. So what
// matters is how many row reads are in flight: at about 1 us of latency,
// 3.35 TB/s needs some 25 KB in flight on each SM.
//
// Layout. The launch geometry comes from the wrapper
// (kernels/embed_bag/kernel.py:embed_bag_geometry); this file does not
// re-derive it.
// - Columns go as float4 when D % 4 == 0 and the pointers are 16-byte
//   aligned (vec = 4), else as floats. A group of `lanes` lanes (the
//   power of two that covers the D / vec columns, at most 32) reads one
//   row; wider rows take several column tiles. A warp holds
//   groups = 32 / lanes slot groups, so every lane works at any D: at
//   D = 64 the two half-warps read two slots at once.
// - A bag's L slots are split over `warps` warps of one CTA, `per_warp`
//   slots each, when B alone cannot fill the card (B = 512: 5 warps a
//   bag, so a lane asks for its 5 rows in two steps); at large B one
//   warp takes a bag. `bags` bags share a CTA.
// - Each warp loads its slots' idx and w once, coalesced (lane k reads
//   slot k of a chunk of 32), and passes them to the lane groups by
//   __shfl_sync: no global load of idx sits between two row loads.
// - A lane issues its row loads of a step (kUnroll = 4 of them) into
//   registers before its FMAs. Measured at the MIND widths
//   (tools/probe_embed_bag.py --variants, one H100): 2, 6 or 8 loads a
//   step land within 6 % of 4 at both shapes (the float4 build of 8
//   spills at 64 registers); a cp.async ring in shared memory
//   (tools/probe_embed_bag_ring.cu, 2-4 stages, each step issued before
//   the last one's FMAs) took 4.7-6.3 us at B = 512 against 3.0, and
//   286-290 us at B = 65,536 against 244, under every geometry tried.
//   Each lane reads each row once, so the ring only adds a
//   shared-memory store and load per row. TMA bulk copies of single
//   256-byte rows would add an mbarrier round a row on top and were not
//   tried. So the rows go to registers.
// - Deterministic: each lane sums its slots in a fixed order, the slot
//   groups of a warp are combined by an xor butterfly of shuffles, the
//   warps of a bag through shared memory, added in warp order by one
//   warp. No atomics: two calls on one input give the same bits.
// Row offsets are int64: idx * D reaches 6.7e8 at the MIND widths.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;        // row loads a lane issues before its FMAs
constexpr int kMaxThreads = 256;  // a CTA's threads, at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float zero_row(float) { return 0.f; }
__device__ __forceinline__ float4 zero_row(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float nan_row(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ float4 nan_row(float4) {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

__device__ __forceinline__ float fma_row(float w, float x, float acc) {
  return fmaf(w, x, acc);
}
__device__ __forceinline__ float4 fma_row(float w, float4 x, float4 acc) {
  return make_float4(fmaf(w, x.x, acc.x), fmaf(w, x.y, acc.y),
                     fmaf(w, x.z, acc.z), fmaf(w, x.w, acc.w));
}

__device__ __forceinline__ float add_row(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add_row(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float shfl_xor_row(float v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}
__device__ __forceinline__ float4 shfl_xor_row(float4 v, int m) {
  return make_float4(__shfl_xor_sync(kFull, v.x, m),
                     __shfl_xor_sync(kFull, v.y, m),
                     __shfl_xor_sync(kFull, v.z, m),
                     __shfl_xor_sync(kFull, v.w, m));
}

// V is float or float4; `cols` counts V columns of a row (D / vec). The
// block is 32 * warps * bags threads; its warp i serves bag i / warps of
// the CTA, slots [lo, hi) of it with lo = (i % warps) * per_warp.
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
    embed_bag_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ w, V* __restrict__ out,
                     long long n, int cols, int batch, int bag, int lanes,
                     int groups, int warps, int bags, int per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* part = reinterpret_cast<V*>(smem);  // [bags][warps][lanes]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / lanes;      // this lane's slot group
  const int c = lane - g * lanes;  // its column within a tile
  const int k = warp / warps;      // its bag within the CTA
  const int wb = warp - k * warps; // its warp within the bag
  const long long b = static_cast<long long>(blockIdx.x) * bags + k;
  const bool live = b < batch;
  const int lo = min(wb * per_warp, bag);
  const int hi = min(lo + per_warp, bag);
  const int* idx_b = idx + b * bag;
  const float* w_b = w + b * bag;
  // Every loop bound below is the same across a warp (and the column
  // loop across the CTA), so the shuffles and barriers see every lane.
  for (int j0 = 0; j0 < cols; j0 += lanes) {
    const int j = j0 + c;
    const bool col = live && j < cols;
    V acc = zero_row(V{});
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const int cnt = min(32, hi - c0);
      int my_i = 0;
      float my_w = 0.f;
      if (live && lane < cnt) {
        my_i = idx_b[c0 + lane];
        my_w = w_b[c0 + lane];
      }
      for (int t0 = 0; t0 < cnt; t0 += groups * kUnroll) {
        V x[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * groups + g;  // slot c0 + t of the bag
          const int raw = __shfl_sync(kFull, my_i, t & 31);
          const float wu = __shfl_sync(kFull, my_w, t & 31);
          long long r = raw;
          if (r < 0) r += n;
          const bool use = col && t < cnt;
          x[u] = zero_row(V{});
          wt[u] = use ? wu : 0.f;
          if (use) x[u] = (r >= 0 && r < n) ? table[r * cols + j]
                                            : nan_row(V{});
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = fma_row(wt[u], x[u], acc);
      }
    }
    for (int m = lanes; m < 32; m <<= 1) acc = add_row(acc,
                                                       shfl_xor_row(acc, m));
    if (warps == 1) {
      if (col && g == 0) out[b * cols + j] = acc;
    } else {
      if (g == 0) part[(k * warps + wb) * lanes + c] = acc;
      __syncthreads();
      if (col && g == 0 && wb == 0) {
        V s = part[k * warps * lanes + c];
        for (int q = 1; q < warps; ++q)
          s = add_row(s, part[(k * warps + q) * lanes + c]);
        out[b * cols + j] = s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Launches on `stream` with the wrapper's geometry; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for a geometry the kernel cannot run.
extern "C" int embed_bag_launch(const float* table, const int* idx,
                                const float* w, float* out, long long n,
                                int d, int batch, int bag, int vec, int lanes,
                                int groups, int warps, int bags, int per_warp,
                                void* stream) {
  if (batch == 0 || d == 0) return 0;
  const int threads = 32 * warps * bags;
  if ((vec != 1 && vec != 4) || d % vec != 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || lanes * groups != 32 || warps < 1 ||
      bags < 1 || threads > kMaxThreads || per_warp < 1 ||
      static_cast<long long>(warps) * per_warp < bag)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned int grid = (batch + bags - 1) / bags;
  const size_t smem =
      warps > 1 ? static_cast<size_t>(warps) * bags * lanes * vec * 4 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    embed_bag_kernel<float4><<<grid, threads, smem, s>>>(
        reinterpret_cast<const float4*>(table), idx, w,
        reinterpret_cast<float4*>(out), n, d / 4, batch, bag, lanes, groups,
        warps, bags, per_warp);
  } else {
    embed_bag_kernel<float><<<grid, threads, smem, s>>>(
        table, idx, w, out, n, d, batch, bag, lanes, groups, warps, bags,
        per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}
