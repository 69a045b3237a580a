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
// smax[1] (int32 [B, hp/2, wp/2]) once; nothing else leaves the SMs but
// the [B, J, P, 3] counts.  The TPU kernel compared the full-resolution
// msb and an upsampled parent plane against every plane (3P full-tile
// reductions per stripe).  Here smax[1] is read at quarter resolution,
// never upsampled, and each value is binned once:
//   * one launch.  A stripe (b, j) is one thread block cluster of kCluster
//     CTAs.  Its msb rows and its smax[1] rows are each one contiguous
//     range; each CTA takes a kCluster-th of each range's 16-byte body
//     (int4 loads, kUnroll in flight a thread, streaming: read once), CTA
//     0 also the at most 3 + 3 values of the scalar head and tail, so any
//     width and any 4-byte alignment is taken.
//   * no atomics and no match.any.  Every thread owns a column of a
//     shared-memory histogram (P + 1 bins: value v <= P - 1 in bin
//     max(v, -1) + 1; values above P - 1 are never <= a plane and are not
//     binned) of 16-bit counters, so a bin is a plain shared
//     read-add-write.  Bin k of thread (warp w, lane l) is half w & 1 of
//     the 32-bit word k * 128 + (w >> 1) * 32 + l: warps 2m and 2m + 1
//     share their words, and the 32 lanes of a warp fall in 32 distinct
//     banks whatever their values.
//   * rounds.  Between two flushes a thread bins at most kRoundTrips *
//     kUnroll int4 loads and one scalar, so no 16-bit counter wraps: a
//     flush adds each bin's column sum into the CTA's int totals (a warp
//     per bin: one 16-byte read a lane, shuffles) and zeroes the columns.
//     A stripe of any length is taken; the codec layers' stripes take one
//     round a range.  msb and then smax[1] are binned into the same
//     columns, each flushed into its own totals.
//   * cluster.sync(), and CTA 0 reads the kCluster totals through
//     distributed shared memory (map_shared_rank), turns them into the 3P
//     counts by the prefix-sum identities of
//     ebcc_tpu/ops/bitplane.py segment_counts
//       sig = Cm(p) - 4 Cs1(p-1), sign = Cm(p) - Cm(p-1),
//       refine = N_j - Cm(p)
//     (C = cumulative count; every smax[1] cell's 4 children lie in one
//     stripe because the stripe heights are even) and writes them; a
//     second cluster.sync() keeps the peers' shared memory alive until
//     then.  No global scratch, no memset, no second kernel: the wrapper
//     allocates only the output.
//   Why clusters of 4 CTAs of 256 threads: on the H100 at most 124
// clusters of 8 such CTAs are resident at once (a cluster lives in one
// GPC), fewer than the B * J = 128 stripes of a codec batch, so a second
// wave ran the last 4; clusters of 4 fit 248.  16-bit counters in one set
// of columns keep a CTA at 11.9 KB at P = 22, so 8 CTAs of 256 threads
// share an SM.
// Output int32 [B, J, P, 3], planes ascending, like the TPU kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a bin's columns: 32 16-byte words
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;    // CTAs per stripe (B*J*kCluster CTAs in all)
constexpr int kUnroll = 4;     // int4 loads in flight a thread
constexpr int kRoundTrips = 4000;  // loop trips a thread makes a round
static_assert(kRoundTrips * kUnroll * 4 + 1 <= 0xffff,
              "a round must not wrap a 16-bit counter");

// Count value v in this thread's column `col` (bin k at col[k * kThreads]).
__device__ __forceinline__ void count(uint16_t* col, int v, int P) {
  if (v <= P - 1) col[(v < -1 ? 0 : v + 1) * kThreads] += 1;
}

// Add each bin's column sum into tot[0, nb) and zero the columns.
__device__ void flush(int4* cols, int* tot, int nb) {
  __syncthreads();  // every thread's counts are in the columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < nb; k += kWarps) {
    int4* c = cols + k * kThreads / 8 + lane;  // 8 counters of bin k
    const int4 q = *c;
    *c = make_int4(0, 0, 0, 0);
    const unsigned w[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                           (unsigned)q.w};
    int s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) s += (int)((w[i] & 0xffffu) + (w[i] >> 16));
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) tot[k] += s;
  }
  __syncthreads();  // the columns are zero again
}

// Bin this CTA's share of the n values at p (4-byte aligned) into tot[0,
// nb) through the columns: a kCluster-th of the 16-byte body, and on CTA
// 0 the scalar head (up to the first 16-byte boundary) and tail.
__device__ void bin_range(const int32_t* __restrict__ p, int64_t n,
                          int rank, int4* cols, uint16_t* col, int* tot,
                          int P) {
  const int64_t skip = (4 - (((uintptr_t)p >> 2) & 3)) & 3;
  const int64_t head = skip < n ? skip : n;
  const int64_t n4 = (n - head) / 4;
  const int64_t tail = head + 4 * n4;  // first value of the tail
  if (rank == 0) {
    const int t = threadIdx.x;
    if (t < head)
      count(col, p[t], P);
    else if (t - head < n - tail)
      count(col, p[tail + t - head], P);
  }
  const int4* body = reinterpret_cast<const int4*>(p + head);
  const int64_t lo = n4 * rank / kCluster, hi = n4 * (rank + 1) / kCluster;
  constexpr int64_t kStep = kUnroll * kThreads;
  int64_t r = lo;
  do {  // rounds: the same trip count on every thread of the CTA
    const int64_t e =
        hi - r < kRoundTrips * kStep ? hi : r + kRoundTrips * kStep;
    for (int64_t i = r + threadIdx.x; i < e; i += kStep) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = i + u * kThreads;
        v[u] = k < e ? __ldcs(body + k)
                     : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count(col, v[u].x, P);
        count(col, v[u].y, P);
        count(col, v[u].z, P);
        count(col, v[u].w, P);
      }
    }
    flush(cols, tot, P + 1);
    r = e;
  } while (r < hi);
}

// grid (kCluster, J, B), clusters of kCluster along x: one cluster per
// stripe (b, j).  Dynamic shared memory: [P + 1][kThreads] 16-bit
// columns, then [2][P + 1] int totals of this CTA (msb, smax[1]).
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
level0_stripe(const int32_t* __restrict__ msb,
              const int32_t* __restrict__ smax1, int hp, int wp, int P,
              int J, int32_t* __restrict__ out) {
  extern __shared__ int4 sh[];
  const int nb = P + 1;
  int* tot = reinterpret_cast<int*>(sh + nb * kThreads / 8);
  for (int i = threadIdx.x; i < nb * kThreads / 8; i += kThreads)
    sh[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < 2 * nb; i += kThreads) tot[i] = 0;
  // this thread's column: half (warp & 1) of word (warp >> 1) * 32 + lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* col = reinterpret_cast<uint16_t*>(sh) + (warp >> 1) * 64 +
                  2 * lane + (warp & 1);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j = blockIdx.y, b = blockIdx.z;
  // a stripe's rows at level 0 (hs) and level 1 (hs1)
  const int hs = hp / J, hs1 = hs / 2, w1 = wp / 2;
  const int64_t n0 = (int64_t)hs * wp;
  __syncthreads();  // columns and totals zero
  bin_range(msb + ((int64_t)b * hp + (int64_t)j * hs) * wp, n0, rank, sh,
            col, tot, P);
  bin_range(smax1 + ((int64_t)b * (hp / 2) + (int64_t)j * hs1) * w1,
            (int64_t)hs1 * w1, rank, sh, col, tot + nb, P);
  cluster.sync();  // every CTA's totals written, visible to the cluster
  if (rank == 0) {
    int* sum = reinterpret_cast<int*>(sh);  // the columns are free
    for (int k = threadIdx.x; k < 2 * nb; k += kThreads) {
      int s = 0;
      for (int r = 0; r < kCluster; ++r)
        s += cluster.map_shared_rank(tot, r)[k];
      sum[k] = s;
    }
    __syncthreads();
    const int* hm = sum;       // msb
    const int* hq = sum + nb;  // smax[1]
    for (int p = threadIdx.x; p < P; p += kThreads) {
      int64_t cm_pm1 = 0, cs_pm1 = 0;  // #{v <= p - 1}: bins 0..p
      for (int k = 0; k <= p; ++k) {
        cm_pm1 += hm[k];
        cs_pm1 += hq[k];
      }
      const int64_t cm_p = cm_pm1 + hm[p + 1];  // #{msb <= p}
      int32_t* o = out + (((int64_t)b * J + j) * P + p) * 3;
      o[0] = (int32_t)(cm_p - 4 * cs_pm1);
      o[1] = (int32_t)(cm_p - cm_pm1);
      o[2] = (int32_t)(n0 - cm_p);
    }
  }
  cluster.sync();  // the peers' shared memory lives until CTA 0 has read it
}

}  // namespace

extern "C" {

// msb int32 [B, hp, wp]; smax1 int32 [B, hp/2, wp/2]; out int32
// [B, J, P, 3].  Requires hp % J == 0 and (hp / 2) % J == 0.  One launch,
// no scratch.  Returns cudaGetLastError().
int ebcc_level0_counts(int device, const int32_t* msb, const int32_t* smax1,
                       int B, int hp, int wp, int P, int J, int32_t* out,
                       cudaStream_t stream) {
  if (B < 1 || B > 65535 || J < 1 || J > 65535 || P < 1 || hp < 2 ||
      wp < 2 || hp % J || (hp / 2) % J)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int smem = (P + 1) * (kThreads * (int)sizeof(uint16_t) +
                              2 * (int)sizeof(int));
  level0_stripe<<<dim3(kCluster, J, B), kThreads, smem, stream>>>(
      msb, smax1, hp, wp, P, J, out);
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
