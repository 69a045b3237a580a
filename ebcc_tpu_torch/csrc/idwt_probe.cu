// Probes of the inverse DWT's data-movement primitives on a batch of f32
// frames [B, H, W] (H and W even), for Hopper (sm_90a).
//
// Replaces the TPU lowering probes of scripts/pallas_idwt_probe.py
// (k0 :87, k1 :90, k2 :97, k3 :104) and scripts/pallas_idwt_probe2.py
// (q1 :78), which timed one primitive each on a 768x1472 frame in VMEM.
// Each kernel here keeps its probe's primitive as its data path, so its
// time is the card's figure for that primitive:
//   probe_elementwise      k0  x * 1.0001 + 0.5 as one fma, float4 loads
//   probe_row_interleave   k1  rows 2i / 2i+1 read as two views at a
//                              stride of two rows (the column pass's
//                              access pattern), +1 on even rows, -1 on odd
//   probe_row_pairs        q1  the (H/2, 2, W) form: one thread reads and
//                              writes both rows of a pair
//   probe_lane_interleave  k2  the stride-2 lane split in registers, the
//                              data movement of lifting.cuh's vector row
//                              run without its lifting
//   probe_transpose        k3  the transpose sandwich through the TPU
//                              kernel's VMEM (WP, HP) scratch, with the
//                              scratch in shared memory
//
// What bounds them here: memory traffic.  Each reads its input once and
// writes its output once, in one launch, with a few operations per
// element at most: at [16, 768, 1472], 145 MB, or 0.0432 ms at 3.35 TB/s.
//
// k1 (even = x[0::2, :]; odd = x[1::2, :]; out[0::2] = even + 1,
// out[1::2] = odd - 1).  A thread takes one float4 at column quad c of
// row pair p from each view, the even one at row 2p and the odd one at
// row 2p + 1 of the flat [B * H, W] stack, issues both 16-byte loads
// before their first use, adds +1 / -1 and writes both with 16-byte
// stores.  A warp takes 32 neighbouring quads of one pair, so each of its
// accesses covers 512 contiguous bytes of one row; the 8 warps of a block
// take 8 pairs, and the grid strides over the pairs of the whole batch in
// one launch (x: column quads; y: pair groups).  No shared memory, no
// division, no workspace.  W % 4 == 2 (odd rows then start 8 bytes off a
// 16-byte boundary) or a misaligned tensor takes the scalar form of the
// same walk, in the same kernel.
//
// k2 (even = x[:, 0::2]; odd = x[:, 1::2]; out = interleave(even + 1,
// odd - 1)).  W is even, so a column's parity is its flat index's parity
// and no pair straddles a row: the kernel walks the batch as one flat
// stream of runs of 4 pairs.  A thread loads a run as two float4,
// (e0 o0 e1 o1) (e2 o2 e3 o3), renames them into a float4 of evens and one
// of odds, adds +1 / -1 and interleaves them back into two float4 stores.
// The two float4 of a run lie a block's width apart, so that each warp
// access covers 512 contiguous bytes, as k0's does (adjacent float4 would
// halve every access's sectors between two instructions).
// No shared memory, no sync, no division: runs are walked by a grid
// stride, so any even W is taken (W % 4 == 2 included).  Where x or out is
// not 16-byte aligned (a tensor at an odd storage offset) the same runs
// take scalar loads and stores, in the same kernel.
//
// k3 (scratch = x^T; out = (scratch * 1.0001)^T).  A block owns a 64x64
// tile of one frame, in two 16 KB shared tiles: A, the input (the TPU's
// i_ref in VMEM), and B, the scratch.  It loads A with 16-byte coalesced
// loads (four per thread, all issued before the first use); transposes A
// into B by 4x4 blocks, four float4 reads of A turned into four float4
// writes of B in registers; reads B back by columns, again by 4x4 blocks,
// with another thread mapping (the block a thread wrote is read by the
// thread of the transposed index); multiplies by 1.0001f (a plain
// multiply) and stores with 16-byte coalesced writes.  One HBM read and
// one HBM write per element, two syncs, one launch.

//   Bank conflicts: every shared access is 16 bytes, and a quarter-warp's
// eight must fall into eight distinct 16-byte bank groups.  A row walk
// (eight groups of one row) does; a column walk of 4x4 blocks (eight
// rows four apart, one group) would hit one group eight times.  So a
// tile's float4 group g of row r is stored at g ^ ((r >> 2) & 7): both
// walks then see eight distinct groups, and no padding breaks the 16-byte
// alignment.
//   Bytes in flight: 32 KB of static shared memory and 256 threads a
// block let 7 blocks share an SM (by shared memory; 8 by threads), each
// with 16 KB of loads in flight while its neighbours transpose and store.
// A persistent block per SM fed by a TMA ring would need a second path
// anyway for W % 4 == 2 (a tensor map needs a 16-byte row stride), so the
// tile grid is the simpler way to the same bytes in flight.
//   Ragged edges: tiles past H or W are masked per float4 (vector form:
// W % 4 == 0 and x, out 16-byte aligned) or per element (scalar form, in
// the same kernel: W % 4 == 2 or a misaligned tensor); shared memory and
// the 4x4 transposes are the same in both forms.//
// k1, k2 and k3 read each element once and write it once, so their
// 16-byte accesses are streaming ones (__ldcs / __stcs, evict first in
// L2).
//
// k0's arithmetic is __fmaf_rn: the JAX kernel's multiply-add contracts
// to one fma, and -fmad=false would otherwise keep the two apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lifting.cuh"

namespace {

constexpr float kScale = 1.0001f;
constexpr int kLine = 256;      // threads per block of the 1-D kernels
constexpr int64_t kMaxGrid = 1 << 20;  // blocks of a grid-stride launch
constexpr int64_t kMaxGridY = 65535;   // the grid's y extent
constexpr int kWarps = kThreads / 32;  // warps of a kThreads block
constexpr int kTile = 64;       // transpose tile side (floats)
constexpr int kQuads = kTile / 4;  // float4 groups along a tile row
static_assert(kQuads * kQuads == kThreads,
              "a transpose block has a thread per 4x4 block of its tile");

__global__ void probe_elementwise(const float4* __restrict__ x,
                                  float4* __restrict__ out, int64_t n4) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += step) {
    float4 v = x[i];
    v.x = __fmaf_rn(v.x, kScale, 0.5f);
    v.y = __fmaf_rn(v.y, kScale, 0.5f);
    v.z = __fmaf_rn(v.z, kScale, 0.5f);
    v.w = __fmaf_rn(v.w, kScale, 0.5f);
    out[i] = v;
  }
}

// grid (column blocks, H / 2, B): one thread per (row pair, column)
__global__ void probe_row_pairs(const float* __restrict__ x,
                                float* __restrict__ out, int H, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  const int64_t k = (int64_t)blockIdx.z * H * W +
                    (int64_t)(2 * blockIdx.y) * W + c;
  const float even = x[k], odd = x[k + W];
  out[k] = even + 1.0f;
  out[k + W] = odd - 1.0f;
}

// the 4 floats of a row at p of which `valid` lie in the frame (zeros
// past them); kVec: valid <= 0 or >= 4 and p 16-byte aligned, a streaming
// 16-byte load (read once)
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ p,
                                            int valid) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kVec) {
    if (valid > 0) v = __ldcs(reinterpret_cast<const float4*>(p));
  } else {
    if (valid > 0) v.x = p[0];
    if (valid > 1) v.y = p[1];
    if (valid > 2) v.z = p[2];
    if (valid > 3) v.w = p[3];
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store_quad(float* __restrict__ p, float4 v,
                                           int valid) {
  if (kVec) {
    if (valid > 0) __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    if (valid > 0) p[0] = v.x;
    if (valid > 1) p[1] = v.y;
    if (valid > 2) p[2] = v.z;
    if (valid > 3) p[3] = v.w;
  }
}

// grid (ceil(W4 / 32), row pair groups): warp w of block (bx, by) takes
// column quads bx * 32 + lane of row pairs by * kWarps + w, stepping by
// gridDim.y * kWarps pairs.  Pair p of the batch (frame p / (H/2), pair
// p % (H/2)) is row p of the two views x[:, 0::2] and x[:, 1::2], which
// start at x and x + W with a pitch of 2W: row 2p and row 2p + 1 of the
// flat [B * H, W] stack, since H is even.  W4 = ceil(W / 4) quads a row,
// of which the last holds W - 4 c valid floats.
template <bool kVec>
__device__ __forceinline__ void row_pair_quads(const float* __restrict__ x,
                                               float* __restrict__ out,
                                               int64_t pairs, int W, int w4) {
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  if (c >= w4) return;
  const int valid = W - 4 * c;
  const int64_t step = (int64_t)gridDim.y * kWarps;
  for (int64_t p = (int64_t)blockIdx.y * kWarps + (threadIdx.x >> 5);
       p < pairs; p += step) {
    const int64_t k = 2 * p * W + 4 * c;
    const float* even = x + k;      // x[:, 0::2] at row p
    const float* odd = x + k + W;   // x[:, 1::2] at row p
    float4 e = load_quad<kVec>(even, valid);
    float4 o = load_quad<kVec>(odd, valid);
    e.x += 1.0f; e.y += 1.0f; e.z += 1.0f; e.w += 1.0f;
    o.x -= 1.0f; o.y -= 1.0f; o.z -= 1.0f; o.w -= 1.0f;
    store_quad<kVec>(out + k, e, valid);
    store_quad<kVec>(out + k + W, o, valid);
  }
}

// vec: W % 4 == 0 and x, out 16-byte aligned
__global__ void __launch_bounds__(kThreads)
probe_row_interleave(const float* __restrict__ x, float* __restrict__ out,
                     int64_t pairs, int W, int vec) {
  const int w4 = (W + 3) / 4;
  if (vec)
    row_pair_quads<true>(x, out, pairs, W, w4);
  else
    row_pair_quads<false>(x, out, pairs, W, w4);
}

// grid-stride over chunks of 2 kThreads float4 of the flat stream of n4
// float4: thread t's run is float4 t and t + kThreads of a chunk (4 pairs;
// a warp's access covers 512 contiguous bytes); the last run may hold 2
template <bool kVec>
__device__ __forceinline__ void lane_runs(const float* __restrict__ x,
                                          float* __restrict__ out,
                                          int64_t n4) {
  const int64_t step = (int64_t)gridDim.x * 2 * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * 2 * kThreads + threadIdx.x; j < n4;
       j += step) {
    const int n = j + kThreads < n4 ? 8 : 4;  // floats in the run
    const float4 lo = load_quad<kVec>(x + 4 * j, 4);
    const float4 hi = load_quad<kVec>(x + 4 * (j + kThreads), n - 4);
    // x[0::2] and x[1::2]: a rename of registers
    float4 even = make_float4(lo.x, lo.z, hi.x, hi.z);
    float4 odd = make_float4(lo.y, lo.w, hi.y, hi.w);
    even.x += 1.0f; even.y += 1.0f; even.z += 1.0f; even.w += 1.0f;
    odd.x -= 1.0f; odd.y -= 1.0f; odd.z -= 1.0f; odd.w -= 1.0f;
    store_quad<kVec>(out + 4 * j, make_float4(even.x, odd.x, even.y, odd.y),
                     4);
    store_quad<kVec>(out + 4 * (j + kThreads),
                     make_float4(even.z, odd.z, even.w, odd.w), n - 4);
  }
}

// vec: x and out 16-byte aligned
__global__ void __launch_bounds__(kThreads)
probe_lane_interleave(const float* __restrict__ x, float* __restrict__ out,
                      int64_t n4, int vec) {
  if (vec)
    lane_runs<true>(x, out, n4);
  else
    lane_runs<false>(x, out, n4);
}

// the float4 slot of group g (4 floats) of row r in a kTile x kTile
// shared tile, g XOR-swizzled by bits 2-4 of r (see the note above)
__device__ __forceinline__ int quad(int r, int g) {
  return r * kQuads + (g ^ ((r >> 2) & 7));
}

// v[k].j <-> v[j].k: a 4x4 block transposed in registers
__device__ __forceinline__ void transpose4(float4 (&v)[4]) {
  const float4 t[4] = {v[0], v[1], v[2], v[3]};
  v[0] = make_float4(t[0].x, t[1].x, t[2].x, t[3].x);
  v[1] = make_float4(t[0].y, t[1].y, t[2].y, t[3].y);
  v[2] = make_float4(t[0].z, t[1].z, t[2].z, t[3].z);
  v[3] = make_float4(t[0].w, t[1].w, t[2].w, t[3].w);
}

// out = (x^T * kScale)^T on the kTile x kTile tile (blockIdx.y,
// blockIdx.x) of frame blockIdx.z, through a (the tile) and b (the
// scratch), each kTile x kQuads float4 in shared memory
template <bool kVec>
__device__ __forceinline__ void transpose_sandwich(
    const float* __restrict__ x, float* __restrict__ out, int H, int W,
    float4* a, float4* b) {
  const int hi = threadIdx.x / kQuads, lo = threadIdx.x % kQuads;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int64_t frame = (int64_t)blockIdx.z * H * W;
  // a = the tile: rows hi + kQuads * k at group lo, the four loads first
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + hi + kQuads * k;
    v[k] = load_quad<kVec>(x + frame + (int64_t)r * W + c0 + 4 * lo,
                           r < H ? W - c0 - 4 * lo : 0);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a[quad(hi + kQuads * k, lo)] = v[k];
  __syncthreads();
  // b = a^T: block (lo, hi) of a, rows 4 lo .. 4 lo + 3 at group hi,
  // becomes block (hi, lo) of b
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = a[quad(4 * lo + k, hi)];
  transpose4(v);
#pragma unroll
  for (int k = 0; k < 4; ++k) b[quad(4 * hi + k, lo)] = v[k];
  __syncthreads();
  // out = (b * kScale)^T: block (lo, hi) of b, read by columns into
  // registers, becomes out's rows 4 hi .. 4 hi + 3 at group lo
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = b[quad(4 * lo + k, hi)];
    v[k].x *= kScale; v[k].y *= kScale; v[k].z *= kScale; v[k].w *= kScale;
  }
  transpose4(v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + 4 * hi + k;
    store_quad<kVec>(out + frame + (int64_t)r * W + c0 + 4 * lo, v[k],
                     r < H ? W - c0 - 4 * lo : 0);
  }
}

// grid (W / kTile, H / kTile, B) rounded up, block kThreads; vec: W % 4
// == 0 and x, out 16-byte aligned
__global__ void __launch_bounds__(kThreads)
probe_transpose(const float* __restrict__ x, float* __restrict__ out, int H,
                int W, int vec) {
  __shared__ float4 a[kTile * kQuads], b[kTile * kQuads];
  if (vec)
    transpose_sandwich<true>(x, out, H, W, a, b);
  else
    transpose_sandwich<false>(x, out, H, W, a, b);
}

int64_t blocks(int64_t n, int per) { return (n + per - 1) / per; }

cudaError_t check_shape(int device, int B, int H, int W) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || B > 65535 ||
      H > 65535)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// Every entry: x, out f32 [B, H, W], H and W even, B and H <= 65535;
// launches on `stream` and returns cudaGetLastError().

// out = fma(x, 1.0001f, 0.5f); x and out 16-byte aligned
int ebcc_probe_elementwise(int device, const float* x, float* out, int B,
                           int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  if (((uintptr_t)x | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int64_t n4 = (int64_t)B * H * W / 4;
  probe_elementwise<<<(unsigned)blocks(n4, kLine), kLine, 0, stream>>>(
      (const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}

// out[:, r] = x[:, r] + 1 on even rows r, - 1 on odd rows
int ebcc_probe_row_interleave(int device, const float* x, float* out, int B,
                              int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  const int64_t pairs = (int64_t)B * H / 2;
  const int64_t groups = blocks(pairs, kWarps);
  probe_row_interleave<<<dim3((unsigned)blocks((W + 3) / 4, 32),
                              (unsigned)(groups < kMaxGridY ? groups
                                                            : kMaxGridY)),
                         kThreads, 0, stream>>>(
      x, out, pairs, W, W % 4 == 0 && aligned16(x) && aligned16(out));
  return (int)cudaGetLastError();
}

// the same function as ebcc_probe_row_interleave, by row pairs
int ebcc_probe_row_pairs(int device, const float* x, float* out, int B,
                         int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  probe_row_pairs<<<dim3((unsigned)blocks(W, kLine), H / 2, B), kLine, 0,
                    stream>>>(x, out, H, W);
  return (int)cudaGetLastError();
}

// out[..., c] = x[..., c] + 1 on even columns c, - 1 on odd columns
int ebcc_probe_lane_interleave(int device, const float* x, float* out,
                               int B, int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  const int64_t n4 = (int64_t)B * H * W / 4;
  const int64_t grid = blocks(n4, 2 * kThreads);
  probe_lane_interleave<<<(unsigned)(grid < kMaxGrid ? grid : kMaxGrid),
                          kThreads, 0, stream>>>(
      x, out, n4, aligned16(x) && aligned16(out));
  return (int)cudaGetLastError();
}

// out = ((x transposed) * 1.0001f) transposed, one launch, the scratch in
// shared memory
int ebcc_probe_transpose(int device, const float* x, float* out, int B,
                         int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  probe_transpose<<<dim3((unsigned)blocks(W, kTile),
                         (unsigned)blocks(H, kTile), B),
                    kThreads, 0, stream>>>(
      x, out, H, W, W % 4 == 0 && aligned16(x) && aligned16(out));
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
