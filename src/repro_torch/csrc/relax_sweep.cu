// relax_sweep: one BatchHL relaxation wave over all P landmark (or query)
// planes, on the destination-block tiling of the edge slots.
//
// Replaces the Pallas kernel src/repro/kernels/edge_relax/kernel.py:
// _relax_sweep_kernel (and its row fold _reduce_rows). It computes
//
//   out[p, v] = min over tile slots e with dst v and mask[p or 0, perm[e]]
//               of clear_if_hub(p, v, min(keys[p, src[e]] + step*w[perm[e]], inf))
//
// and `inf` where no slot reaches v. The order of operations is the
// reference's: saturate, then clear the hub bit, then mask. A saturated
// key whose hub bit is cleared lands below `inf` (INF_KEY2 & ~1 < INF_KEY2),
// and callers see that value, so it is kept.
//
// Layout: one CTA per (tile row, plane), planes fastest, so the P CTAs of
// one row run close together and share the row's tile indices in L2. The
// CTA reads its row's slots (src, local dst, slot permutation, occupancy),
// gathers w[perm] and mask[perm] itself, and scatter-mins candidates into
// a [block_v] tile in shared memory with atomicMin. Then it atomicMins
// the tile into out[p, block]; the wrapper fills `out` with `inf` first,
// so the rows of a chunked block need no separate fold. Min does not
// depend on order: the result is deterministic.
//
// The sum is taken in int64: keys reach 2^30+3 (INF_KEY4) and step*w
// reaches 2^30 (w = INF_D), and signed int32 overflow is undefined here.
// For operands in [0, 2^31) min(sum, inf) equals the reference's
// wrap-then-map-negative-to-inf.
//
// What bounds it: memory. Per slot it reads 16 bytes of tile indices plus
// a random 4-byte key gather and the w/mask gathers; there is no
// arithmetic to speak of. This first version is simple and right: the
// tiles are re-read once per plane (from L2 when the planes' CTAs of a
// row overlap in time).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void relax_sweep_kernel(
    const int* __restrict__ keys, const uint8_t* __restrict__ hub,
    const int* __restrict__ src_t, const int* __restrict__ dstloc_t,
    const int* __restrict__ perm_t, const int* __restrict__ slot_t,
    const int* __restrict__ rowblk_t, const uint8_t* __restrict__ mask,
    int mask_per_plane, const int* __restrict__ w, int* __restrict__ out,
    int planes, int n, long long e2, int rows_per_shard, int be,
    int block_v, int nb, int step, int inf, int clear) {
  extern __shared__ int tile[];
  const long long bid = blockIdx.x;
  const int p = static_cast<int>(bid % planes);
  const long long row = bid / planes;  // in [0, S * NR)
  const long long shard = row / rows_per_shard;
  const long long base =
      (shard * nb + rowblk_t[row]) * static_cast<long long>(block_v);

  for (int i = threadIdx.x; i < block_v; i += blockDim.x) tile[i] = inf;
  __syncthreads();

  const int* keys_p = keys + static_cast<long long>(p) * n;
  const uint8_t* mask_p =
      mask + (mask_per_plane ? static_cast<long long>(p) * e2 : 0);
  const uint8_t* hub_p =
      hub ? hub + static_cast<long long>(p) * n : nullptr;
  const long long off = row * be;
  for (int e = threadIdx.x; e < be; e += blockDim.x) {
    if (!slot_t[off + e]) continue;
    const int perm = perm_t[off + e];
    if (!mask_p[perm]) continue;
    const int dl = dstloc_t[off + e];
    const long long sum = static_cast<long long>(keys_p[src_t[off + e]]) +
                          static_cast<long long>(step) * w[perm];
    int cand = sum < inf ? static_cast<int>(sum) : inf;
    if (hub_p != nullptr) {
      const long long v = base + dl;
      if (v < n && hub_p[v]) cand &= ~clear;
    }
    atomicMin(&tile[dl], cand);
  }
  __syncthreads();

  int* out_p = out + static_cast<long long>(p) * n;
  for (int i = threadIdx.x; i < block_v; i += blockDim.x) {
    const long long v = base + i;
    if (v < n && tile[i] < inf) atomicMin(&out_p[v], tile[i]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `hub` may be null (no hub clear); `mask` is [P, E2] when mask_per_plane
// is nonzero, else [E2]. `out` [P, n] must hold `inf` on entry.
extern "C" int relax_sweep_launch(
    const int* keys, const uint8_t* hub, const int* src_t,
    const int* dstloc_t, const int* perm_t, const int* slot_t,
    const int* rowblk_t, const uint8_t* mask, int mask_per_plane,
    const int* w, int* out, int planes, int n, long long e2, int shards,
    int rows_per_shard, int be, int block_v, int nb, int step, int inf,
    int clear, void* stream) {
  const long long grid =
      static_cast<long long>(planes) * shards * rows_per_shard;
  if (grid == 0) return 0;
  relax_sweep_kernel<<<static_cast<unsigned int>(grid), kThreads,
                       block_v * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(
      keys, hub, src_t, dstloc_t, perm_t, slot_t, rowblk_t, mask,
      mask_per_plane, w, out, planes, n, e2, rows_per_shard, be, block_v,
      nb, step, inf, clear);
  return static_cast<int>(cudaGetLastError());
}
