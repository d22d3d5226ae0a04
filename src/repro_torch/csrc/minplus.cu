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
// One thread per query row; H (4 KB at R = 32) sits in shared memory and
// every thread reads it in the same order, so its reads broadcast. What
// bounds it: B*P*R add-min pairs against (B*(P+R) + P*R + B) * 4 bytes;
// at the main path's B <= 1024 either is microseconds, so the launch
// itself dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kInf32 = 1 << 29;
constexpr int kThreads = 128;

__global__ void minplus_kernel(const int* __restrict__ s,
                               const int* __restrict__ h,
                               const int* __restrict__ t,
                               int* __restrict__ out, int batch, int p,
                               int r) {
  extern __shared__ int h_sh[];
  for (int i = threadIdx.x; i < p * r; i += blockDim.x) h_sh[i] = h[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int* s_b = s + static_cast<long long>(b) * p;
  const int* t_b = t + static_cast<long long>(b) * r;
  int best = kInf32;
  for (int j = 0; j < r; ++j) {
    int mid = kInf32;
    for (int i = 0; i < p; ++i) mid = min(mid, s_b[i] + h_sh[i * r + j]);
    best = min(best, min(mid + t_b[j], kInf32));
  }
  out[b] = best;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int minplus_launch(const int* s, const int* h, const int* t,
                              int* out, int batch, int p, int r,
                              void* stream) {
  if (batch == 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  minplus_kernel<<<blocks, kThreads, p * r * sizeof(int),
                   static_cast<cudaStream_t>(stream)>>>(s, h, t, out, batch,
                                                        p, r);
  return static_cast<int>(cudaGetLastError());
}
