// seed_match: the slot side of BatchHL's seed weights
// (graphs/coo.py: resolve_seed_weights).
//
// For the pre-update graph's slots src, dst, w (int32 [E2]), valid (bool
// [E2]) and a batch's U row keys, sorted ascending (int64 [U], repeats
// allowed), it computes into acc (int32 [U], zeroed by the wrapper)
//
//   acc[p] = max(0, max{ w[e] : valid[e], key(src[e], dst[e]) == keys[p] })
//
// at the first sorted position p of each key; every other entry stays 0.
// The key is kernel.py: slot_key, the signed int64 lo * 2^32 + hi of the
// undirected pair (lo, hi) = (min, max) or of the exact arc (src, dst).
//
// Replaces no Pallas kernel: the reference does this match in jnp
// (src/repro/graphs/coo.py: resolve_seed_weights, one [U, E2] compare that
// XLA fuses). The port's first version was torch ops over every slot: the
// key, a searchsorted, a match mask, then scatter_reduce(amax) of every
// slot into U + 1 bins, the unmatched all into bin U, so 2^24 atomics
// serialised on one address to serve at most 2U matches (12.95 ms a batch
// at 2^24 slots on an H100).
//
// What bounds it: the key needs src and dst of every slot, 8 bytes; valid
// and w are read only for the slots whose key is among the rows' (at most
// a few a row), so the bytes are 8 a slot, 0.040 ms at 2^24 slots at
// 3.35 TB/s. The lookups come next: a binary search alone, ceil(log2 U)
// 8-byte reads a slot from shared memory (10 at U = 1024), took 0.32 ms
// at 2^24 slots on an H100, eight times the bytes, its reads serialised
// on shared memory's banks. The atomics, at most a few a row, are noise.
//
// This design:
// - A thread takes four consecutive slots a step of a grid-stride loop:
//   src and dst as one 16-byte load each, streaming (read once; 134 MB at
//   2^24 slots, more than L2 holds). A tail of E2 % 4 slots, or every
//   slot where src or dst is not 16-byte aligned, goes one at a time.
// - Each CTA first builds a filter in shared memory: one bit of 2^18 (32
//   KB) set for each row key, at a multiplicative hash of the key. A slot
//   whose bit is clear is no row's, after one 4-byte read; at U = 1024 the
//   bits are 0.4 % of the filter, so the search runs for a few slots in a
//   thousand (and for the group of four a slot shares). With it the pass
//   took 0.055 ms at 2^24 slots and 0.10 ms at 2^25 on an H100.
// - The U sorted keys are staged in shared memory beside the filter when
//   they fit (kernel.py: seed_match_geometry, up to
//   SEED_MATCH_MAX_SHARED_KEYS, opting in past 48 KB); past that they are
//   searched in device memory, where they sit in L2.
// - The key is computed in registers, and its lower bound found by a
//   branch-free binary search whose ceil(log2 U) steps depend on U alone;
//   the four searches of a thread interleave, four independent lookups in
//   flight a step.
// - Only a slot whose key is there reads its valid byte and, if live, its
//   weight, and does one atomicMax into its key's own bin. A maximum of
//   integers: the result is the same bits in any order of the atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTwo32 = 1LL << 32;
constexpr int kFilterBits = 18;
constexpr int kFilterWords = (1 << kFilterBits) / 32;

template <bool kArc>
__device__ __forceinline__ long long slot_key(int a, int b) {
  const long long lo = kArc ? a : min(a, b);
  const long long hi = kArc ? b : max(a, b);
  return lo * kTwo32 + hi;
}

__device__ __forceinline__ unsigned filter_bit(long long key) {
  return static_cast<unsigned>(
      (static_cast<unsigned long long>(key) * 0x9E3779B97F4A7C15ull) >>
      (64 - kFilterBits));
}

__device__ __forceinline__ bool maybe_there(const uint32_t* filter,
                                            long long key) {
  const unsigned b = filter_bit(key);
  return (filter[b >> 5] >> (b & 31)) & 1u;
}

// The lower bound of each key[j] in keys[0, u), u >= 1: the first position
// whose key is >= key[j], or u. The answer lies in [p, p + n] throughout.
template <int K>
__device__ __forceinline__ void lower_bounds(const long long* keys, int u,
                                             const long long (&key)[K],
                                             int (&p)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = 0;
  for (int n = u; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int j = 0; j < K; ++j)
      p[j] = keys[p[j] + half] < key[j] ? p[j] + half : p[j];
    n -= half;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] += keys[p[j]] < key[j];
}

// Slot e, of key `key` and lower bound p: fold its weight into bin p if
// the key is there and the slot is live.
__device__ __forceinline__ void fold(const long long* keys, int u,
                                     long long key, int p, long long e,
                                     const uint8_t* __restrict__ valid,
                                     const int* __restrict__ w,
                                     int* __restrict__ acc) {
  if (p < u && keys[p] == key && valid[e]) atomicMax(acc + p, w[e]);
}

template <bool kArc, bool kShared>
__global__ void __launch_bounds__(kThreads, 4) seed_match_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const uint8_t* __restrict__ valid, const int* __restrict__ w,
    long long e2, int vec, const long long* __restrict__ keys_g, int u,
    int* __restrict__ acc) {
  // [kFilterWords] filter words, then [u] keys when kShared.
  extern __shared__ __align__(16) uint32_t filter[];
  long long* keys_sh = reinterpret_cast<long long*>(filter + kFilterWords);
  for (int i = threadIdx.x; i < kFilterWords; i += kThreads) filter[i] = 0;
  if (kShared)
    for (int i = threadIdx.x; i < u; i += kThreads) keys_sh[i] = keys_g[i];
  __syncthreads();
  for (int i = threadIdx.x; i < u; i += kThreads) {
    const unsigned b = filter_bit(keys_g[i]);
    atomicOr(filter + (b >> 5), 1u << (b & 31));
  }
  __syncthreads();
  const long long* keys = kShared ? keys_sh : keys_g;

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long quads = vec ? e2 / 4 : 0;
  for (long long q = first; q < quads; q += stride) {
    const int4 s = __ldcs(reinterpret_cast<const int4*>(src) + q);
    const int4 d = __ldcs(reinterpret_cast<const int4*>(dst) + q);
    const long long key[4] = {slot_key<kArc>(s.x, d.x),
                              slot_key<kArc>(s.y, d.y),
                              slot_key<kArc>(s.z, d.z),
                              slot_key<kArc>(s.w, d.w)};
    if (!(maybe_there(filter, key[0]) | maybe_there(filter, key[1]) |
          maybe_there(filter, key[2]) | maybe_there(filter, key[3])))
      continue;
    int p[4];
    lower_bounds<4>(keys, u, key, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) fold(keys, u, key[j], p[j], 4 * q + j, valid,
                                     w, acc);
  }
  for (long long e = 4 * quads + first; e < e2; e += stride) {
    const long long key[1] = {slot_key<kArc>(src[e], dst[e])};
    if (!maybe_there(filter, key[0])) continue;
    int p[1];
    lower_bounds<1>(keys, u, key, p);
    fold(keys, u, key[0], p[0], e, valid, w, acc);
  }
}

template <bool kArc, bool kShared>
int launch(const int* src, const int* dst, const uint8_t* valid, const int* w,
           long long e2, int vec, const long long* keys, int u, int blocks,
           int smem_bytes, int* acc, cudaStream_t stream) {
  auto* kernel = seed_match_kernel<kArc, kShared>;
  if (smem_bytes > 48 * 1024)
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes))
      return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem_bytes, stream>>>(src, dst, valid, w, e2,
                                                    vec, keys, u, acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a key kind other than 0 (the undirected pair)
// and 1 (the arc), or for u < 1. `vec`: src and dst are 16-byte aligned;
// `shared_keys`, `blocks` and `smem_bytes` (the filter's 32 KB, and the
// keys' 8 * u bytes when shared_keys) come from kernel.py:
// seed_match_geometry.
extern "C" int seed_match_launch(const int* src, const int* dst,
                                 const uint8_t* valid, const int* w,
                                 long long e2, int vec, const long long* keys,
                                 int u, int arc, int shared_keys, int blocks,
                                 int smem_bytes, int* acc, void* stream) {
  if (u < 1 || (arc != 0 && arc != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* go = arc ? (shared_keys ? launch<true, true> : launch<true, false>)
                 : (shared_keys ? launch<false, true> : launch<false, false>);
  return go(src, dst, valid, w, e2, vec, keys, u, blocks, smem_bytes, acc,
            st);
}
