// relax_sweep: one BatchHL relaxation wave over all P landmark (or query)
// planes, on the destination-block tiling of the edge slots.
//
// Replaces the Pallas kernel src/repro/kernels/edge_relax/kernel.py:
// _relax_sweep_kernel (and its row fold _reduce_rows). It computes
//
//   out[p, v] = min over tile slots e with dst v, slot_t[e] != 0 and
//               mask[p or 0, perm[e]]
//               of clear_if_hub(p, v, min(keys[p, src[e]] + step*w[perm[e]], inf))
//
// and `inf` where no slot reaches v. The order of operations is the
// reference's: saturate, then clear the hub bit, then mask. A saturated
// key whose hub bit is cleared lands below `inf` (INF_KEY2 & ~1 < INF_KEY2),
// and callers see that value, so it is kept.
//
// What bounds it: bytes. Per live slot the function needs its 16 bytes of
// tile indices, the w and mask of its edge, and one key of each plane at
// its source; there is no arithmetic to speak of. At the main path's
// shapes (P = 32, n = 2^20, 11.8 M tile slots) that is ~575 MB, 0.17 ms at
// 3.35 TB/s. The first version ran one CTA per (tile row, plane): it read
// every row's index streams and w/mask gathers P times, and each key
// gather was a 4-byte read from one plane that cost a 32-byte sector.
//
// This design:
// - One CTA per (tile row, plane group) walks its row once for G <= 32
//   planes. G is chosen by the wrapper (kernel.py: plane_group) so that
//   the CTA's [block_v, W] int32 tile (W = 2^ceil(log2 G)) fits in
//   dynamic shared memory (up to 227 KB, opted in with
//   cudaFuncSetAttribute); P need not be a multiple of G. The index
//   streams and the w/mask gathers are read once per row and group, not
//   once per plane.
// - Keys are read vertex-major: the launcher first copies keys [P, n]
//   into keys_t [groups, n, kw] (transpose_kernel; for P = 32 that is the
//   [n, 32] transpose), kw = max(4, W) columns, so the planes of one
//   slot's source are one 128-byte line for G = 32. A lane takes four
//   planes of a slot with one 16-byte load, so a warp works on 128 / kw
//   slots at a time and spends a quarter of the instructions per slot
//   that a lane per plane would (those instructions, not the gathers,
//   bounded the lane-per-plane form on the card). Groups narrower than
//   four planes read padded columns that no lane uses. The hub bits of
//   the row's destination block are packed into one word per vertex in
//   shared memory. A per-plane mask [P, E2] is first packed into words
//   [groups, E2] (pack_mask_kernel), so a lane tests its planes' bits of
//   one word.
// - The row's src/dstloc/perm/slot streams are staged into shared memory
//   in double-buffered chunks with cp.async: the next chunk's copies are
//   in flight while the current chunk's keys are gathered. Each lane
//   issues the gathers of kUnroll slots before it uses any of them.
// - The fold is order-free, in one of two modes that the wrapper picks
//   from block_v (kernel.py: sweep_mode; the threshold is
//   SWEEP_MAX_BLOCK_V = 28032, the widest block whose one-plane tile and
//   hub words fit the CTA's shared memory).
//   Tiled mode (block_v <= 28032): candidates are atomicMin'ed into the
//   shared tile, its columns XOR-swizzled by the vertex so that the
//   write-out reads it without bank conflicts. A block with one tile row
//   then stores its planes' runs with plain coalesced stores (no `inf`
//   fill of `out` beforehand); the rows of a block chunked over several
//   rows atomicMin into an `out` region that fill_chunked_kernel filled
//   with `inf` first.
//   Wide mode (block_v > 28032, up to any width): no tile. fill_inf_kernel
//   fills all of `out` with `inf` over the whole grid, the hub bits are
//   packed once per call into words [groups, n] (pack_mask_kernel on hub
//   [P, n]), and each candidate that lands below `inf` after its hub
//   clear is atomicMin'ed straight into `out` in device memory. A
//   candidate still at `inf` changes nothing there and is skipped; one
//   that saturated into a hub reads INF_KEY2 & ~1 and is kept, as in the
//   tiled mode's chunked fold. A candidate at or above what `out` holds
//   (read from L2 first) is skipped too: `out` only falls, so that is
//   exact, and it took the key2 wave at block_v 2^20 from 9.26 to 6.16
//   ms (tools/probe_wide.py). The CTA's shared memory is then the staged
//   chunks alone, so the group is min(P, 32) planes at any block_v, and
//   vertex offsets are counted in 64 bits.
//   One CTA per row, not per block, in both modes, so a hub block split
//   over many rows runs as many CTAs.
//
// The sum is taken in int64: keys reach 2^30+3 (INF_KEY4) and step*w
// reaches 2^30 (w = INF_D), and signed int32 overflow is undefined here.
// For operands in [0, 2^31) min(sum, inf) equals the reference's
// wrap-then-map-negative-to-inf.
//
// Not done yet: each live slot still gathers a 128-byte key line at
// random (~1 GB a wave on the main path, against the 134 MB of keys the
// bound counts); no TMA or warp specialisation (cp.async from every
// thread); the transpose and the mask pack are passes of their own over
// device memory; no persistent CTAs. In the wide mode the planes of one
// candidate's vertex lie in P different lines of the plane-major `out`,
// so each of its atomics is a sector of its own: the fold takes most of
// the wave (tools/probe_wide.py: 0.73 ms without it, 2.2 ms with the
// atomics on a vertex-major layout, whose transpose back is not built).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // slots per staged chunk (kernel.py: SWEEP_CHUNK)
constexpr int kStreams = 4;  // src, dstloc, perm, slot
constexpr int kUnroll = 4;   // slots whose gathers a lane keeps in flight

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row's four index streams (src, dstloc, perm, slot), from its first
// slot.
struct Streams {
  const int* s[kStreams];
  __device__ __forceinline__ const int* operator[](int i) const {
    // Selects, not an indexed load: the array stays in registers.
    return i == 0 ? s[0] : i == 1 ? s[1] : i == 2 ? s[2] : s[3];
  }
};

// Copy slots [lo, lo + len) of the row's streams into `dst`
// ([kStreams][kChunk] ints) and commit them as one cp.async group. `vec`:
// 16-byte copies (every stream's row start 16-byte aligned, len % 4 == 0).
__device__ __forceinline__ void stage_chunk(int* dst, const Streams& rows,
                                            int lo, int len, bool vec) {
  if (vec) {
    const int quads = len >> 2;
    for (int i = threadIdx.x; i < kStreams * quads; i += kThreads) {
      const int s = i / quads, q = (i - s * quads) << 2;
      cp_async16(dst + s * kChunk + q, rows[s] + lo + q);
    }
  } else {
    for (int i = threadIdx.x; i < kStreams * len; i += kThreads) {
      const int s = i / len, q = i - s * len;
      cp_async4(dst + s * kChunk + q, rows[s] + lo + q);
    }
  }
  cp_async_commit();
}

// Where row `row` (of the flattened [S * NR] rows) writes: the global
// vertex of its block's first slot, and whether its block spans several
// rows (rows of one block are consecutive within a shard) and it is the
// first of them.
struct RowInfo {
  long long base;
  bool chunked;
  bool first;
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

// keys [P, n] -> keys_t [groups, n, kw]: the planes of each group
// vertex-major, padded to kw = max(4, 2^ceil(log2 group)) columns (the
// padding is never used as a key). Through a padded 32 x 32 tile whose
// rows are the groups' padded columns ("virtual planes" q = grp * kw + c).
__global__ void transpose_kernel(const int* __restrict__ keys,
                                 int* __restrict__ keys_t, int planes,
                                 int group, int kw_log2, int groups, int n) {
  __shared__ int t[32][33];
  const long long v0 = static_cast<long long>(blockIdx.x) * 32;
  const int q0 = blockIdx.y * 32;
  const int kw = 1 << kw_log2, vplanes = groups << kw_log2;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int q = q0 + dy, grp = q >> kw_log2, c = q & (kw - 1);
    const int p = grp * group + c;
    const long long v = v0 + threadIdx.x;
    t[dy][threadIdx.x] =
        q < vplanes && c < group && p < planes && v < n
            ? keys[static_cast<long long>(p) * n + v]
            : 0;
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const long long v = v0 + dy;
    const int q = q0 + threadIdx.x, grp = q >> kw_log2, c = q & (kw - 1);
    if (q < vplanes && v < n)
      keys_t[(static_cast<long long>(grp) * n + v) * kw + c] =
          t[threadIdx.x][dy];
  }
}

// mask [P, E2] bool -> words [groups, E2]: bit g of word (grp, e) is
// mask[grp * group + g, e]. Each thread packs four edges; `vec`: read
// them as one 4-byte word per plane and store one 16-byte word (E2 % 4 ==
// 0 and both arrays aligned), else byte by byte.
__global__ void pack_mask_kernel(const uint8_t* __restrict__ mask,
                                 uint32_t* __restrict__ words, int planes,
                                 int group, long long e2, int vec) {
  const long long e =
      4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= e2) return;
  const int g0 = blockIdx.y * group;
  const int gcur = min(group, planes - g0);
  uint32_t bits[4] = {0, 0, 0, 0};
  for (int g = 0; g < gcur; ++g) {
    const uint8_t* row = mask + static_cast<long long>(g0 + g) * e2 + e;
    if (vec) {
      const uchar4 m = *reinterpret_cast<const uchar4*>(row);
      bits[0] |= static_cast<uint32_t>(m.x != 0) << g;
      bits[1] |= static_cast<uint32_t>(m.y != 0) << g;
      bits[2] |= static_cast<uint32_t>(m.z != 0) << g;
      bits[3] |= static_cast<uint32_t>(m.w != 0) << g;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (e + q < e2) bits[q] |= static_cast<uint32_t>(row[q] != 0) << g;
    }
  }
  uint32_t* out = words + static_cast<long long>(blockIdx.y) * e2 + e;
  if (vec) {
    *reinterpret_cast<uint4*>(out) =
        make_uint4(bits[0], bits[1], bits[2], bits[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (e + q < e2) out[q] = bits[q];
  }
}

// Fill with `inf` the group's planes of every block that spans several
// rows (its first row's CTA does it); other CTAs exit at once.
__global__ void fill_chunked_kernel(int* __restrict__ out,
                                    const int* __restrict__ rowblk_t,
                                    int planes, int group, int groups,
                                    int n, int rows_per_shard, int block_v,
                                    int nb, int inf) {
  const long long bid = blockIdx.x;
  const int grp = static_cast<int>(bid % groups);
  const RowInfo r =
      row_info(rowblk_t, bid / groups, rows_per_shard, nb, block_v);
  if (!r.chunked || !r.first) return;
  const int g0 = grp * group;
  const int gcur = min(group, planes - g0);
  for (int idx = threadIdx.x; idx < gcur * block_v; idx += blockDim.x) {
    const int g = idx / block_v, i = idx - g * block_v;
    const long long v = r.base + i;
    if (v < n) out[static_cast<long long>(g0 + g) * n + v] = inf;
  }
}

// Wide mode: fill all `count` entries of `out` with `inf`, grid-stride.
__global__ void fill_inf_kernel(int* __restrict__ out, long long count,
                                int inf) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += stride)
    out[i] = inf;
}

// One CTA per (tile row, plane group); lane (sub, li) works on planes
// g0 + 4 li .. g0 + 4 li + 3 of the warp's sub-th slot of each step. The
// tile has gs = 2^gs_log2 columns, the key copy kw = max(4, gs). kWide:
// the wide mode, which has no tile and reads the hub bits from
// hub_words [groups, n] (null without a hub) in place of `hub`.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) relax_sweep_kernel(
    const int* __restrict__ keys_t, const uint8_t* __restrict__ hub,
    const uint32_t* __restrict__ hub_words,
    const int* __restrict__ src_t, const int* __restrict__ dstloc_t,
    const int* __restrict__ perm_t, const int* __restrict__ slot_t,
    const int* __restrict__ rowblk_t, const uint8_t* __restrict__ mask,
    const uint32_t* __restrict__ mask_words, const int* __restrict__ w,
    int* __restrict__ out, int planes, int group, int gs_log2, int groups,
    int n, long long e2, int rows_per_shard, int be, int block_v, int nb,
    int step, int inf, int clear, int vec) {
  const int gs = 1 << gs_log2, gmask = gs - 1, kw = max(4, gs);
  extern __shared__ __align__(16) int smem[];
  int* stage = smem;                             // [2][kStreams][kChunk]
  int* tile = smem + 2 * kStreams * kChunk;      // [block_v][gs], tiled
  uint32_t* hubw =                               // [block_v], tiled
      reinterpret_cast<uint32_t*>(tile + (kWide ? 0 : block_v * gs));

  const long long bid = blockIdx.x;
  const int grp = static_cast<int>(bid % groups);
  const long long row = bid / groups;
  const RowInfo r = row_info(rowblk_t, row, rows_per_shard, nb, block_v);
  const int g0 = grp * group;
  const int gcur = min(group, planes - g0);

  const long long off = row * be;
  const Streams streams = {
      {src_t + off, dstloc_t + off, perm_t + off, slot_t + off}};
  const int nchunks = (be + kChunk - 1) / kChunk;
  if (nchunks > 0) stage_chunk(stage, streams, 0, min(be, kChunk), vec);

  if constexpr (!kWide) {
    const int cells = block_v * gs;
    const int4 inf4 = make_int4(inf, inf, inf, inf);
    for (int i = threadIdx.x; i < cells / 4; i += kThreads)
      reinterpret_cast<int4*>(tile)[i] = inf4;
    for (int i = (cells & ~3) + threadIdx.x; i < cells; i += kThreads)
      tile[i] = inf;
    for (int i = threadIdx.x; i < block_v; i += kThreads) {
      uint32_t bits = 0;
      const long long v = r.base + i;
      if (hub != nullptr && v < n)
        for (int g = 0; g < gcur; ++g)
          bits |= static_cast<uint32_t>(
                      hub[static_cast<long long>(g0 + g) * n + v] != 0)
                  << g;
      hubw[i] = bits;
    }
  }

  const int lanes_per_slot = kw / 4;  // 1 .. 8
  const int per_warp = 32 / lanes_per_slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / lanes_per_slot;
  const int c0 = (lane - sub * lanes_per_slot) * 4;  // first plane in group
  // The lane's planes that exist, one bit each (bit k: plane c0 + k); a
  // group narrower than four planes leaves the high bits clear, so its
  // lanes never touch a tile column past gs.
  const uint32_t mine =
      ((gcur >= 32 ? 0xffffffffu : (1u << gcur) - 1) >> c0) & 0xfu;
  const int step_slots = per_warp * (kThreads / 32);
  const int* keys_g = keys_t + static_cast<long long>(grp) * n * kw + c0;
  const uint32_t* words_g =
      mask_words != nullptr ? mask_words + grp * e2 : nullptr;
  // Wide mode: the group's hub words and its lane's first plane of `out`.
  const uint32_t* hubs_g =
      kWide && hub_words != nullptr
          ? hub_words + static_cast<long long>(grp) * n
          : nullptr;
  int* out_g = out + static_cast<long long>(g0 + c0) * n;

  for (int k = 0; k < nchunks; ++k) {
    const int lo = k * kChunk;
    const int len = min(kChunk, be - lo);
    if (k + 1 < nchunks) {
      stage_chunk(stage + ((k + 1) & 1) * kStreams * kChunk, streams,
                  lo + kChunk, min(kChunk, be - lo - kChunk), vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* c_src = stage + (k & 1) * kStreams * kChunk;
    const int* c_dl = c_src + kChunk;
    const int* c_perm = c_dl + kChunk;
    const int* c_slot = c_perm + kChunk;
    if (mine != 0) {
      for (int j0 = warp * per_warp + sub; j0 < len;
           j0 += kUnroll * step_slots) {
        int wv[kUnroll];
        int4 key[kUnroll];
        uint32_t live[kUnroll];
        // The mask, weight and keys of kUnroll slots: every gather of the
        // step in flight at once. Masked-off planes' keys are read too.
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * step_slots;
          live[u] = 0;
          wv[u] = 0;
          key[u] = make_int4(0, 0, 0, 0);
          if (j < len && c_slot[j] != 0) {
            const int perm = c_perm[j];
            live[u] = words_g != nullptr ? (words_g[perm] >> c0) & mine
                                         : (mask[perm] != 0 ? mine : 0u);
            wv[u] = w[perm];
            key[u] = *reinterpret_cast<const int4*>(
                keys_g + static_cast<long long>(c_src[j]) * kw);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (live[u] == 0) continue;
          const int dl = c_dl[j0 + u * step_slots];
          const long long sw = static_cast<long long>(step) * wv[u];
          const int k4[4] = {key[u].x, key[u].y, key[u].z, key[u].w};
          if constexpr (kWide) {
            // Saturate, clear the hub bit, then fold what lies below inf
            // and below what `out` holds: `out` only falls during the
            // sweep, so any value read from it bounds its final min.
            const long long v = r.base + dl;
            const uint32_t hubs = hubs_g != nullptr ? hubs_g[v] >> c0 : 0u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (!((live[u] >> q) & 1)) continue;
              const long long sum = k4[q] + sw;
              int cand = sum < inf ? static_cast<int>(sum) : inf;
              if ((hubs >> q) & 1) cand &= ~clear;
              int* o = out_g + static_cast<long long>(q) * n + v;
              if (cand < inf && cand < __ldcg(o)) atomicMin(o, cand);
            }
          } else {
            const uint32_t hubs = hubw[dl] >> c0;
            int* cell = tile + dl * gs;
            const int swz = dl & gmask;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (!((live[u] >> q) & 1)) continue;
              const long long sum = k4[q] + sw;
              int cand = sum < inf ? static_cast<int>(sum) : inf;
              if ((hubs >> q) & 1) cand &= ~clear;
              atomicMin(cell + ((c0 + q) ^ swz), cand);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if constexpr (!kWide) {
    __syncthreads();  // the tile is complete (also when the row is empty)

    for (int idx = threadIdx.x; idx < gcur * block_v; idx += kThreads) {
      const int gg = idx / block_v, i = idx - gg * block_v;
      const long long v = r.base + i;
      if (v >= n) continue;
      const int val = tile[i * gs + (gg ^ (i & gmask))];
      int* o = out + static_cast<long long>(g0 + gg) * n + v;
      if (!r.chunked)
        *o = val;
      else if (val < inf)
        atomicMin(o, val);
    }
  }
}

// The tiled mode's shared memory: opt in to `smem_bytes` of it and
// prefer the largest carveout. (The wide mode's 8 KB need neither, and
// leave the rest of the SM's 256 KB to L1.)
int set_tiled_attributes(int smem_bytes) {
  if (cudaError_t err = cudaFuncSetAttribute(
          relax_sweep_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes))
    return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      relax_sweep_kernel<false>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
}

}  // namespace

// Launches the sweep's kernels on `stream`: the key transpose, the
// per-plane mask pack (when mask_per_plane), then in the tiled mode the
// `inf` fill of chunked blocks, in the wide mode the hub pack (when there
// is a hub) and the `inf` fill of all of `out`, and the sweep. Returns
// the first CUDA error (0 on success).
//
// keys [P, n]; keys_t [groups, n, max(4, 2^ceil(log2 group))] scratch;
// hub [P, n] or null; tiles [S * NR, be]; rowblk_t [S * NR]; mask [P, E2]
// when mask_per_plane, else [E2]; mask_words [groups, E2] scratch when
// mask_per_plane; hub_words [groups, n] scratch in the wide mode with a
// hub; w [E2]; out [P, n], written in full. `group` planes per CTA (the
// last group may hold fewer); `smem_bytes` the sweep CTA's dynamic shared
// memory; `wide` the mode (kernel.py: sweep_mode).
extern "C" int relax_sweep_launch(
    const int* keys, const uint8_t* hub, const int* src_t,
    const int* dstloc_t, const int* perm_t, const int* slot_t,
    const int* rowblk_t, const uint8_t* mask, int mask_per_plane,
    const int* w, int* out, int* keys_t, uint32_t* mask_words,
    uint32_t* hub_words, int planes, int group, int smem_bytes, int wide,
    int n, long long e2, int shards, int rows_per_shard, int be,
    int block_v, int nb, int step, int inf, int clear, void* stream) {
  if (planes == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (planes + group - 1) / group;
  int gs_log2 = 0;
  while ((1 << gs_log2) < group) ++gs_log2;
  const int kw_log2 = max(2, gs_log2);

  const dim3 tgrid((n + 31) / 32, ((groups << kw_log2) + 31) / 32);
  transpose_kernel<<<tgrid, dim3(32, 8), 0, s>>>(keys, keys_t, planes, group,
                                                 kw_log2, groups, n);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  // Bits [P, len] bool -> words [groups, len], one bit per plane.
  auto pack = [&](const uint8_t* bits, uint32_t* words, long long len) {
    const long long quads = (len + 3) / 4;
    const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                    groups);
    const bool vec = len % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(bits) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(words) % 16 == 0;
    pack_mask_kernel<<<grid, kThreads, 0, s>>>(bits, words, planes, group,
                                               len, vec);
    return static_cast<int>(cudaGetLastError());
  };
  if (mask_per_plane && e2 > 0)
    if (int err = pack(mask, mask_words, e2)) return err;
  const long long grid =
      static_cast<long long>(shards) * rows_per_shard * groups;
  if (wide) {
    if (hub != nullptr)
      if (int err = pack(hub, hub_words, n)) return err;
    const long long count = static_cast<long long>(planes) * n;
    const long long need = (count + kThreads - 1) / kThreads;
    const long long blocks = need < (1 << 16) ? need : (1 << 16);
    fill_inf_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        out, count, inf);
  } else {
    fill_chunked_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        out, rowblk_t, planes, group, groups, n, rows_per_shard, block_v,
        nb, inf);
  }
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  const bool vec =
      be % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src_t) |
        reinterpret_cast<uintptr_t>(dstloc_t) |
        reinterpret_cast<uintptr_t>(perm_t) |
        reinterpret_cast<uintptr_t>(slot_t)) &
       15) == 0;
  if (!wide)
    if (int err = set_tiled_attributes(smem_bytes)) return err;
  const auto kernel =
      wide ? relax_sweep_kernel<true> : relax_sweep_kernel<false>;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem_bytes, s>>>(
      keys_t, hub, wide && hub != nullptr ? hub_words : nullptr, src_t,
      dstloc_t, perm_t, slot_t, rowblk_t, mask,
      mask_per_plane ? mask_words : nullptr, w, out, planes, group, gs_log2,
      groups, n, e2, rows_per_shard, be, block_v, nb, step, inf, clear, vec);
  return static_cast<int>(cudaGetLastError());
}
