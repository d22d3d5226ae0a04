// minplus: the Eq.-3 landmark upper bound of a query batch.
//
// Replaces the Pallas kernel src/repro/kernels/minplus/kernel.py:
// _minplus_kernel. It computes, with INF32 = 2^29,
//
//   out[b] = min_j min(min(INF32, min_i S[b,i] + H[i,j]) + T[b,j], INF32)
//
// for S [B,P], H [P,R], T [B,R] int32; P = R is the full bound, P < R a
// slice of highway rows. It clamps where the reference does: the inner
// min starts at INF32, and each sum with T is clamped before the min over
// j. Precondition, as in the reference: every input value is <= INF32,
// so no sum leaves int32. The TPU version pads P and R to 128 lanes; that
// is an artefact of its vector width and is dropped here.
//
// What bounds it: B*P*R add-min pairs against (B*(P+R) + P*R + B) * 4
// bytes; at the main path's B <= 1024, P = R = 32 either is a fraction of
// a microsecond, so the launch itself is the floor. The first version ran
// one thread per query row: P*R dependent steps in one thread, S re-read
// from global memory at every step with a row stride across the warp, and
// at B = 32 a single warp on a single SM.
//
// This design:
// - One warp per query row, `warps` rows per CTA (kernel.py:
//   minplus_geometry), so B = 32 runs as 8 CTAs on 8 SMs.
// - Lane l owns the columns j = j0 + 32c + l (c < COLS) of a column tile
//   of 32*COLS columns and keeps their running inner min in registers.
//   R wider than one tile runs tile after tile.
// - H is streamed through shared memory in chunks of `chunk_rows` rows of
//   the column tile (at most 32 KB), so any [P, R] fits. Lanes read row i
//   at consecutive columns: no bank conflicts.
// - The warp loads 32 entries of S[b, :] at a time, coalesced, and hands
//   each to every lane with __shfl_sync.
// - The epilogue adds T[b, j], clamps, and takes the warp's min with
//   __reduce_min_sync.
#include <cuda_runtime.h>

namespace {

constexpr int kInf32 = 1 << 29;
constexpr unsigned kFull = 0xffffffffu;

template <int COLS>
__global__ void __launch_bounds__(256) minplus_kernel(
    const int* __restrict__ s, const int* __restrict__ h,
    const int* __restrict__ t, int* __restrict__ out, int batch, int p, int r,
    int chunk_rows) {
  constexpr int kTile = 32 * COLS;
  extern __shared__ int h_sh[];  // [chunk_rows][kTile]
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  const bool active = b < batch;  // uniform over the warp
  const int* s_b = s + b * p;
  const int* t_b = t + b * r;
  int best = kInf32;

  for (int j0 = 0; j0 < r; j0 += kTile) {
    const int cols = min(kTile, r - j0);
    int mid[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) mid[c] = kInf32;
    for (int i0 = 0; i0 < p; i0 += chunk_rows) {
      const int rows = min(chunk_rows, p - i0);
      __syncthreads();  // the previous chunk is consumed
      for (int idx = threadIdx.x; idx < rows * kTile; idx += blockDim.x) {
        const int ii = idx / kTile, jj = idx - ii * kTile;
        h_sh[idx] = jj < cols
                        ? h[static_cast<long long>(i0 + ii) * r + j0 + jj]
                        : kInf32;
      }
      __syncthreads();
      if (!active) continue;
      for (int k0 = 0; k0 < rows; k0 += 32) {
        const int s_lane = k0 + lane < rows ? s_b[i0 + k0 + lane] : 0;
        const int kn = min(32, rows - k0);
        const int* hrow = h_sh + k0 * kTile + lane;
#pragma unroll 8
        for (int k = 0; k < kn; ++k) {
          const int sv = __shfl_sync(kFull, s_lane, k);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            mid[c] = min(mid[c], sv + hrow[k * kTile + 32 * c]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int j = 32 * c + lane;
        if (j < cols) best = min(best, min(mid[c] + t_b[j0 + j], kInf32));
      }
    }
  }
  if (active) {
    best = __reduce_min_sync(kFull, best);
    if (lane == 0) out[b] = best;
  }
}

template <int COLS>
int launch(const int* s, const int* h, const int* t, int* out, int batch,
           int p, int r, int warps, int chunk_rows, cudaStream_t stream) {
  const int blocks = (batch + warps - 1) / warps;
  const size_t smem = static_cast<size_t>(chunk_rows) * 32 * COLS * sizeof(int);
  minplus_kernel<COLS><<<blocks, 32 * warps, smem, stream>>>(
      s, h, t, out, batch, p, r, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel was not built for.
// `warps` rows per CTA, `cols` columns per lane (1, 2, 4 or 8) and
// `chunk_rows` H rows per staged chunk come from kernel.py:
// minplus_geometry.
extern "C" int minplus_launch(const int* s, const int* h, const int* t,
                              int* out, int batch, int p, int r, int warps,
                              int cols, int chunk_rows, void* stream) {
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 1: return launch<1>(s, h, t, out, batch, p, r, warps, chunk_rows, st);
    case 2: return launch<2>(s, h, t, out, batch, p, r, warps, chunk_rows, st);
    case 4: return launch<4>(s, h, t, out, batch, p, r, warps, chunk_rows, st);
    case 8: return launch<8>(s, h, t, out, batch, p, r, warps, chunk_rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
