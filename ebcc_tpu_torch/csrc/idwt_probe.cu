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
//   probe_lane_interleave  k2  a row shuffle without lifting: whole rows
//                              staged in shared memory as [even | odd]
//                              halves, +-1, interleaved on a scalar store
//                              with a division and modulo per element
//   probe_transpose        k3  x -> a global [B, W, H] workspace (the TPU
//                              kernel's VMEM (WP, HP) scratch) -> x * 1.0001,
//                              two tiled shared-memory transposes
//
// What bounds them here: memory traffic; each reads its input once and
// writes its output once (k3 also writes and reads the workspace), a few
// operations per element at most.  They are simple first versions.
//
// k0's arithmetic is __fmaf_rn: the JAX kernel's multiply-add contracts
// to one fma, and -fmad=false would otherwise keep the two apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lifting.cuh"

namespace {

constexpr float kScale = 1.0001f;
constexpr int kLine = 256;      // threads per block of the 1-D kernels
constexpr int kTile = 32;       // transpose tile side
constexpr int kTileRows = 8;    // thread rows of a transpose block

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

// grid (column blocks, H, B): one thread per output element of row r
__global__ void probe_row_interleave(const float* __restrict__ x,
                                     float* __restrict__ out, int H, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;
  const int64_t frame = (int64_t)blockIdx.z * H * W;
  // x[0::2, :] and x[1::2, :]: views of H/2 rows at a pitch of two rows
  const float* half = x + frame + (r & 1) * W;
  const float v = half[(int64_t)(r >> 1) * (2 * W) + c];
  out[frame + (int64_t)r * W + c] = (r & 1) ? v - 1.0f : v + 1.0f;
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

// grid (row blocks, B): a block stages rows [r0, r0 + rows) of one frame
__global__ void probe_lane_interleave(const float* __restrict__ x,
                                      float* __restrict__ out, int H, int W,
                                      int rows) {
  extern __shared__ float sm[];  // [rows][W], each row as [even | odd]
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, H - r0);
  const int n2 = W / 2;
  const int64_t off = (int64_t)blockIdx.y * H * W + (int64_t)r0 * W;
  for (int k = threadIdx.x; k < nr * W; k += kThreads) {
    const int rr = k / W, c = k - rr * W;
    sm[rr * W + (c & 1) * n2 + (c >> 1)] = x[off + k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nr * n2; k += kThreads) {
    float* s = sm + (k / n2) * W;
    const int i = k % n2;
    s[i] = s[i] + 1.0f;
    s[n2 + i] = s[n2 + i] - 1.0f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nr * W; k += kThreads) {
    const int rr = k / W, c = k - rr * W;
    const float* s = sm + rr * W;
    out[off + k] = (c & 1) ? s[n2 + (c >> 1)] : s[c >> 1];
  }
}

// out[b][c][r] = in[b][r][c] (times kScale when kMul) for in [B, R, C];
// grid (C / kTile, R / kTile, B), block (kTile, kTileRows)
template <bool kMul>
__device__ __forceinline__ void transpose_tile(const float* __restrict__ in,
                                               float* __restrict__ out,
                                               int R, int C) {
  __shared__ float tile[kTile][kTile + 1];
  const int64_t frame = (int64_t)blockIdx.z * R * C;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kTileRows)
    if (r0 + j < R && c0 + tx < C)
      tile[j][tx] = in[frame + (int64_t)(r0 + j) * C + c0 + tx];
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += kTileRows)
    if (c0 + j < C && r0 + tx < R) {
      const float v = tile[tx][j];
      out[frame + (int64_t)(c0 + j) * R + r0 + tx] = kMul ? v * kScale : v;
    }
}

__global__ void probe_transpose_in(const float* __restrict__ x,
                                   float* __restrict__ work, int H, int W) {
  transpose_tile<false>(x, work, H, W);
}

__global__ void probe_transpose_out(const float* __restrict__ work,
                                    float* __restrict__ out, int H, int W) {
  transpose_tile<true>(work, out, W, H);
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
  probe_row_interleave<<<dim3((unsigned)blocks(W, kLine), H, B), kLine, 0,
                         stream>>>(x, out, H, W);
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

// out[..., c] = x[..., c] + 1 on even columns c, - 1 on odd columns;
// W <= 24576 (one row in lifting.cuh's kRowSmem)
int ebcc_probe_lane_interleave(int device, const float* x, float* out,
                               int B, int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  const int rows = min(64, kRowSmem / (W * (int)sizeof(float)));
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const int bytes = rows * W * (int)sizeof(float);
  cudaFuncSetAttribute(probe_lane_interleave,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  probe_lane_interleave<<<dim3((unsigned)blocks(H, rows), B), kThreads,
                          bytes, stream>>>(x, out, H, W, rows);
  return (int)cudaGetLastError();
}

// work f32 [B, W, H] = x transposed; out = (work * 1.0001f) transposed
int ebcc_probe_transpose(int device, const float* x, float* out, float* work,
                         int B, int H, int W, cudaStream_t stream) {
  cudaError_t e = check_shape(device, B, H, W);
  if (e != cudaSuccess) return (int)e;
  if ((W + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kTileRows);
  probe_transpose_in<<<dim3((unsigned)blocks(W, kTile),
                            (unsigned)blocks(H, kTile), B),
                       block, 0, stream>>>(x, work, H, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  probe_transpose_out<<<dim3((unsigned)blocks(H, kTile),
                             (unsigned)blocks(W, kTile), B),
                        block, 0, stream>>>(work, out, H, W);
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
