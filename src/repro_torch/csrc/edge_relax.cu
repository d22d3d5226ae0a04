// edge_relax: the legacy relaxation sweep of one key plane, with edge
// validity baked into the tiles at prepare time.
//
// Replaces the Pallas kernel src/repro/kernels/edge_relax/kernel.py:
// _relax_kernel (and its row fold _reduce_rows). With INF32 = 2^29 it
// computes
//
//   out[v] = min over tile slots e with dst v and valid_t[e] != 0 of
//            sat(keys[src[e]] + step)
//
// and INF32 where no slot reaches v. sat is the reference's: the int32
// sum wraps, a negative result becomes INF32, then it is clamped at
// INF32. There is no weight and no hub bit.
//
// Layout: one CTA per tile row of the flattened [S * NR] rows. The CTA
// fills a [block_v] tile in shared memory with INF32, scatter-mins the
// candidates of its valid slots into it with atomicMin, then atomicMins
// the tile into out[(shard * nb + rowblk) * block_v + i]. The wrapper
// fills `out` with INF32 first, so the rows of a chunked block fold with
// no second pass; min does not depend on order, so the result is
// deterministic.
//
// The sum is taken in int64, where it cannot overflow (signed int32
// overflow is undefined here). Its low 32 bits, read as int32, are the
// reference's wrapped sum: a key near 2^31 - 1 wraps negative and
// saturates to INF32 exactly as it does there.
//
// What bounds it: memory. Per slot it reads 12 bytes of tile (src, local
// dst, valid) and gathers a 4-byte key; there is no arithmetic to speak
// of. This first version is simple and right.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf32 = 1 << 29;
constexpr int kThreads = 256;

__global__ void edge_relax_kernel(
    const int* __restrict__ keys, const int* __restrict__ src_t,
    const int* __restrict__ dstloc_t, const int* __restrict__ valid_t,
    const int* __restrict__ rowblk_t, int* __restrict__ out, int n,
    int rows_per_shard, int be, int block_v, int nb, int step) {
  extern __shared__ int tile[];
  const long long row = blockIdx.x;  // in [0, S * NR)
  const long long shard = row / rows_per_shard;
  const long long base =
      (shard * nb + rowblk_t[row]) * static_cast<long long>(block_v);

  for (int i = threadIdx.x; i < block_v; i += blockDim.x) tile[i] = kInf32;
  __syncthreads();

  const long long off = row * be;
  for (int e = threadIdx.x; e < be; e += blockDim.x) {
    if (!valid_t[off + e]) continue;
    const long long sum =
        static_cast<long long>(keys[src_t[off + e]]) + step;
    const int wrapped =
        static_cast<int>(static_cast<uint32_t>(static_cast<uint64_t>(sum)));
    const int cand = (wrapped < 0 || wrapped > kInf32) ? kInf32 : wrapped;
    atomicMin(&tile[dstloc_t[off + e]], cand);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < block_v; i += blockDim.x) {
    const long long v = base + i;
    if (v < n && tile[i] < kInf32) atomicMin(&out[v], tile[i]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Tiles are [rows / rows_per_shard, rows_per_shard, be]; `out` [n] must
// hold INF32 on entry.
extern "C" int edge_relax_launch(const int* keys, const int* src_t,
                                 const int* dstloc_t, const int* valid_t,
                                 const int* rowblk_t, int* out, int n,
                                 int rows, int rows_per_shard, int be,
                                 int block_v, int nb, int step,
                                 void* stream) {
  if (rows == 0) return 0;
  edge_relax_kernel<<<static_cast<unsigned int>(rows), kThreads,
                      block_v * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(
      keys, src_t, dstloc_t, valid_t, rowblk_t, out, n, rows_per_shard, be,
      block_v, nb, step);
  return static_cast<int>(cudaGetLastError());
}
