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
// The sum is taken in int64, where it cannot overflow (signed int32
// overflow is undefined here). Its low 32 bits, read as int32, are the
// reference's wrapped sum: a key near 2^31 - 1 wraps negative and
// saturates to INF32 exactly as it does there.
//
// What bounds it: memory. Per tile slot it needs valid_t (4 bytes), and
// per valid slot its src and local dst (8 bytes) and one 4-byte key
// gather; there is no arithmetic to speak of. The first version kept one
// 4-byte load per thread in flight along the chain valid -> src -> key ->
// shared atomicMin, had the wrapper fill all of `out` with INF32, and
// atomicMin'ed every tile into it.
//
// This design:
// - One CTA per tile row of the flattened [S * NR] rows, in one of two
//   modes that the wrapper picks from block_v (kernel.py:
//   edge_relax_mode). Tiled mode (block_v <= 232,448 / 4 = 58,112, the
//   dynamic shared memory a CTA may opt in to with cudaFuncSetAttribute):
//   the CTA keeps its block's [block_v] tile of running mins there. Wide
//   mode (any wider block_v): no tile; fill_inf_kernel fills all of `out`
//   with INF32 over the whole grid, and each candidate below INF32 is
//   atomicMin'ed straight into `out` in device memory. A saturated
//   candidate and a missing one both read INF32, so skipping the former
//   changes nothing.
// - Each thread takes kQuads quads of 4 slots per step: where BE % 4 == 0
//   one 16-byte load of valid_t each, and 16-byte loads of src_t and
//   dstloc_t only for quads with a valid slot (padding comes in whole
//   quads at the row's end); other BE take the same slots with 4-byte
//   loads. All loads and key gathers of the step are issued before the
//   first shared atomicMin.
// - The fold of a block's rows in the tiled mode, as kernel A does it: a
//   block with one tile row stores its tile plainly, INF32 included, so
//   `out` needs no fill; the rows of a block chunked over several rows
//   atomicMin into a region that fill_chunked_kernel filled with INF32
//   first. min does not depend on order, so the result is deterministic
//   in both modes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf32 = 1 << 29;
constexpr int kThreads = 256;
constexpr int kQuads = 2;               // quads of slots a thread loads per step
constexpr int kSpan = 4 * kThreads;     // slots one quad of every thread covers

struct RowInfo {
  long long base;  // global vertex of the block's first slot
  bool chunked;    // the block spans several rows (consecutive in a shard)
  bool first;      // this is the block's first row
};

__device__ __forceinline__ RowInfo row_info(const int* rowblk_t,
                                            long long row,
                                            int rows_per_shard, int nb,
                                            int block_v) {
  const long long shard = row / rows_per_shard;
  const int local = static_cast<int>(row - shard * rows_per_shard);
  const int* rb = rowblk_t + shard * rows_per_shard;
  const int blk = rb[local];
  const bool prev = local > 0 && rb[local - 1] == blk;
  const bool next = local + 1 < rows_per_shard && rb[local + 1] == blk;
  return {(shard * nb + blk) * static_cast<long long>(block_v),
          prev || next, !prev};
}

// Fill with INF32 the vertices of every block that spans several rows
// (its first row's CTA does it); other CTAs exit at once.
__global__ void fill_chunked_kernel(int* __restrict__ out,
                                    const int* __restrict__ rowblk_t, int n,
                                    int rows_per_shard, int block_v, int nb) {
  const RowInfo r =
      row_info(rowblk_t, blockIdx.x, rows_per_shard, nb, block_v);
  if (!r.chunked || !r.first) return;
  for (int i = threadIdx.x; i < block_v; i += blockDim.x) {
    const long long v = r.base + i;
    if (v < n) out[v] = kInf32;
  }
}

// Wide mode: fill all n entries of `out` with INF32, grid-stride.
__global__ void fill_inf_kernel(int* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = kInf32;
}

// Slots of quad step e0 that this thread takes: with kVec the four
// consecutive slots e0 + 4 * tid + k (one 16-byte load), else the four
// slots e0 + k * kThreads + tid. Slots past `be` read as 0.
template <bool kVec>
__device__ __forceinline__ int4 load_quad(const int* row, int e0, int be) {
  if (kVec) {
    const int e = e0 + 4 * threadIdx.x;
    return e < be ? *reinterpret_cast<const int4*>(row + e)
                  : make_int4(0, 0, 0, 0);
  }
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = e0 + k * kThreads + threadIdx.x;
    v[k] = e < be ? row[e] : 0;
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int lane_of(const int4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// kWide: the wide mode, which folds into `out` (filled with INF32 first)
// in place of the shared tile.
template <bool kVec, bool kWide>
__global__ void __launch_bounds__(kThreads) edge_relax_kernel(
    const int* __restrict__ keys, const int* __restrict__ src_t,
    const int* __restrict__ dstloc_t, const int* __restrict__ valid_t,
    const int* __restrict__ rowblk_t, int* __restrict__ out, int n,
    int rows_per_shard, int be, int block_v, int nb, int step) {
  extern __shared__ int tile[];
  const long long row = blockIdx.x;  // in [0, S * NR)
  const RowInfo r = row_info(rowblk_t, row, rows_per_shard, nb, block_v);

  if constexpr (!kWide) {
    for (int i = threadIdx.x; i < block_v; i += kThreads) tile[i] = kInf32;
    __syncthreads();
  }

  const long long off = row * be;
  const int* v_row = valid_t + off;
  const int* s_row = src_t + off;
  const int* d_row = dstloc_t + off;
  for (int e0 = 0; e0 < be; e0 += kQuads * kSpan) {
    int4 vq[kQuads], sq[kQuads], dq[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      vq[q] = load_quad<kVec>(v_row, e0 + q * kSpan, be);
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      sq[q] = dq[q] = make_int4(0, 0, 0, 0);
      if (vq[q].x | vq[q].y | vq[q].z | vq[q].w) {
        sq[q] = load_quad<kVec>(s_row, e0 + q * kSpan, be);
        dq[q] = load_quad<kVec>(d_row, e0 + q * kSpan, be);
      }
    }
    int key[kQuads][4];
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        key[q][k] = lane_of(vq[q], k) ? keys[lane_of(sq[q], k)] : 0;
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!lane_of(vq[q], k)) continue;
        const long long sum = static_cast<long long>(key[q][k]) + step;
        const int wrapped = static_cast<int>(
            static_cast<uint32_t>(static_cast<uint64_t>(sum)));
        const int cand =
            (wrapped < 0 || wrapped > kInf32) ? kInf32 : wrapped;
        if constexpr (kWide) {
          if (cand < kInf32)
            atomicMin(&out[r.base + lane_of(dq[q], k)], cand);
        } else {
          atomicMin(&tile[lane_of(dq[q], k)], cand);
        }
      }
  }
  if constexpr (!kWide) {
    __syncthreads();

    for (int i = threadIdx.x; i < block_v; i += kThreads) {
      const long long v = r.base + i;
      if (v >= n) break;
      if (!r.chunked)
        out[v] = tile[i];
      else if (tile[i] < kInf32)
        atomicMin(&out[v], tile[i]);
    }
  }
}

template <bool kVec, bool kWide>
int launch_sweep(const int* keys, const int* src_t, const int* dstloc_t,
                 const int* valid_t, const int* rowblk_t, int* out, int n,
                 int rows, int rows_per_shard, int be, int block_v, int nb,
                 int step, cudaStream_t s) {
  const int smem = kWide ? 0 : block_v * static_cast<int>(sizeof(int));
  if (cudaError_t err = cudaFuncSetAttribute(
          edge_relax_kernel<kVec, kWide>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(err);
  edge_relax_kernel<kVec, kWide><<<static_cast<unsigned int>(rows), kThreads,
                                   smem, s>>>(keys, src_t, dstloc_t, valid_t,
                                              rowblk_t, out, n,
                                              rows_per_shard, be, block_v,
                                              nb, step);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide>
int launch_mode(const int* keys, const int* src_t, const int* dstloc_t,
                const int* valid_t, const int* rowblk_t, int* out, int n,
                int rows, int rows_per_shard, int be, int block_v, int nb,
                int step, cudaStream_t s) {
  const bool vec =
      be % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src_t) |
        reinterpret_cast<uintptr_t>(dstloc_t) |
        reinterpret_cast<uintptr_t>(valid_t)) &
       15) == 0;
  return vec ? launch_sweep<true, kWide>(keys, src_t, dstloc_t, valid_t,
                                         rowblk_t, out, n, rows,
                                         rows_per_shard, be, block_v, nb,
                                         step, s)
             : launch_sweep<false, kWide>(keys, src_t, dstloc_t, valid_t,
                                          rowblk_t, out, n, rows,
                                          rows_per_shard, be, block_v, nb,
                                          step, s);
}

}  // namespace

// Launches the INF32 fill (of chunked blocks in the tiled mode, of all of
// `out` in the wide mode) and the sweep on `stream`; returns the first
// CUDA error (0 on success). Tiles are [rows / rows_per_shard,
// rows_per_shard, be]; every vertex of `out` [n] is written, so it needs
// no fill on entry. `wide`: the mode (kernel.py: edge_relax_mode); the
// tiled mode takes block_v * 4 bytes of dynamic shared memory per CTA (at
// most 232,448), the wide mode none.
extern "C" int edge_relax_launch(const int* keys, const int* src_t,
                                 const int* dstloc_t, const int* valid_t,
                                 const int* rowblk_t, int* out, int n,
                                 int rows, int rows_per_shard, int be,
                                 int block_v, int nb, int step, int wide,
                                 void* stream) {
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    const int need = (n + kThreads - 1) / kThreads;
    fill_inf_kernel<<<need < (1 << 16) ? need : (1 << 16), kThreads, 0, s>>>(
        out, n);
  } else {
    fill_chunked_kernel<<<static_cast<unsigned int>(rows), kThreads, 0, s>>>(
        out, rowblk_t, n, rows_per_shard, block_v, nb);
  }
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return wide ? launch_mode<true>(keys, src_t, dstloc_t, valid_t, rowblk_t,
                                  out, n, rows, rows_per_shard, be, block_v,
                                  nb, step, s)
              : launch_mode<false>(keys, src_t, dstloc_t, valid_t, rowblk_t,
                                   out, n, rows, rows_per_shard, be, block_v,
                                   nb, step, s);
}
