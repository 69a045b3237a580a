// Level-0 segment counts of the bitplane coder, for Hopper (sm_90a).
//
// Replaces the TPU kernel ebcc_tpu/ops/pallas_kernels.py::level0_counts
// (_level0_kernel).  For every (frame b, stripe j, plane p) it counts
//   sig    = #{par >= p & msb <= p}   (significance bits)
//   sign   = #{msb == p}              (sign bits)
//   refine = #{msb > p}               (refinement bits)
// where par is the level-1 quadtree max (smax[1]) of each coefficient.
//
// What bounds it here: memory.  One pass reads msb (int32 [B, hp, wp]) and
// smax[1] (int32 [B, hp/2, wp/2]) once; nothing else leaves the SMs.  The
// TPU kernel compared the full-resolution msb and an upsampled parent
// plane against every plane (3P full-tile reductions per stripe).  Here:
//   * smax[1] is read at quarter resolution, never upsampled;
//   * each block builds shared-memory histograms of msb and of smax[1]
//     over its share of one stripe (P + 1 bins, value -1 included; values
//     above P - 1 are never <= a plane and are not binned), with
//     warp-aggregated shared atomics (__match_any_sync: one atomic per
//     distinct value per warp), then adds them into a global
//     [B, J, 2, P+1] histogram with one atomic per bin;
//   * a second, tiny kernel turns the histograms into the 3P counts by the
//     prefix-sum identities of ebcc_tpu/ops/bitplane.py segment_counts:
//     sig = Cm(p) - 4 Cs1(p-1), sign = Cm(p) - Cm(p-1), refine = N_j - Cm(p)
//     (C = cumulative count; every smax[1] cell's 4 children lie in one
//     stripe because the stripe heights are even).
// Output int32 [B, J, P, 3], planes ascending, like the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a multiple of 32: every warp is full
constexpr int kSplits = 8;     // blocks per stripe (B*J*8 blocks in all)

// Add the values p[lo, hi) into the shared histogram h (bin v + 1 for
// value v in [-1, P-1]).  The trip count is uniform over the block so
// that every lane of every warp reaches __match_any_sync.
__device__ void bin_range(const int32_t* p, int64_t lo, int64_t hi,
                          int* h, int P) {
  const int64_t iters = (hi - lo + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31;
  for (int64_t it = 0; it < iters; ++it) {
    const int64_t i = lo + it * kThreads + threadIdx.x;
    int bin = P + 1;  // not binned
    if (i < hi) {
      const int v = p[i];
      if (v <= P - 1) bin = v + 1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (lane == __ffs(peers) - 1 && bin <= P)
      atomicAdd(&h[bin], __popc(peers));
  }
}

__global__ void level0_hist(const int32_t* __restrict__ msb,
                            const int32_t* __restrict__ smax1, int hp,
                            int wp, int P, int J, int32_t* hist) {
  extern __shared__ int sh[];  // [2][P + 1]
  const int nb = P + 1;
  for (int i = threadIdx.x; i < 2 * nb; i += kThreads) sh[i] = 0;
  __syncthreads();
  const int s = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int hs = hp / J;  // stripe rows at level 0

  const int64_t n0 = (int64_t)hs * wp;
  const int32_t* m = msb + ((int64_t)b * hp + (int64_t)j * hs) * wp;
  bin_range(m, n0 * s / kSplits, n0 * (s + 1) / kSplits, sh, P);

  const int hs1 = hs / 2, w1 = wp / 2;
  const int64_t n1 = (int64_t)hs1 * w1;
  const int32_t* q =
      smax1 + ((int64_t)b * (hp / 2) + (int64_t)j * hs1) * w1;
  bin_range(q, n1 * s / kSplits, n1 * (s + 1) / kSplits, sh + nb, P);
  __syncthreads();

  int32_t* g = hist + ((int64_t)b * J + j) * 2 * nb;
  for (int i = threadIdx.x; i < 2 * nb; i += kThreads)
    if (sh[i]) atomicAdd(&g[i], sh[i]);
}

__global__ void level0_finalize(const int32_t* __restrict__ hist, int P,
                                int64_t nj, int32_t* out) {
  const int bj = blockIdx.x;
  const int32_t* hm = hist + (int64_t)bj * 2 * (P + 1);  // msb
  const int32_t* hs = hm + P + 1;                         // smax[1]
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int64_t cm_pm1 = 0, cs_pm1 = 0;  // #{v <= p - 1}: bins 0..p
    for (int k = 0; k <= p; ++k) {
      cm_pm1 += hm[k];
      cs_pm1 += hs[k];
    }
    const int64_t cm_p = cm_pm1 + hm[p + 1];  // #{msb <= p}
    int32_t* o = out + ((int64_t)bj * P + p) * 3;
    o[0] = (int32_t)(cm_p - 4 * cs_pm1);
    o[1] = (int32_t)(cm_p - cm_pm1);
    o[2] = (int32_t)(nj - cm_p);
  }
}

}  // namespace

extern "C" {

// msb int32 [B, hp, wp]; smax1 int32 [B, hp/2, wp/2]; hist int32
// [B, J, 2, P+1] scratch (zeroed here); out int32 [B, J, P, 3].
// Requires hp % J == 0 and (hp / 2) % J == 0.  Returns cudaGetLastError().
int ebcc_level0_counts(int device, const int32_t* msb, const int32_t* smax1,
                       int B, int hp, int wp, int P, int J, int32_t* hist,
                       int32_t* out, cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t hist_bytes = (size_t)B * J * 2 * (P + 1) * sizeof(int32_t);
  e = cudaMemsetAsync(hist, 0, hist_bytes, stream);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(kSplits, J, B);
  level0_hist<<<grid, kThreads, 2 * (P + 1) * sizeof(int), stream>>>(
      msb, smax1, hp, wp, P, J, hist);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  level0_finalize<<<B * J, 32, 0, stream>>>(hist, P,
                                            (int64_t)(hp / J) * wp, out);
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
