// Multi-level inverse CDF 9/7 DWT of a batch of f32 frames (Mallat
// layout), for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/pallas_idwt_probe.py (k4: one 2-D
// inverse level, k5: the 5-level inverse; run() at :122) and
// scripts/pallas_idwt_probe2.py (q2: one level, q3: the 5-level inverse in
// place; run() at :106), which held a 768x1472 frame in VMEM.  Here it is
// the inverse transform of every reconstruction on a CUDA device: the
// encode's base reconstruction and both layers of every decode
// (codec/pipeline.py _base_recon / _resid_recon).
//
// What bounds it here: memory traffic.  A frame does not fit in one
// block's shared memory, so each level runs the column and row lifting
// passes of lifting.cuh over the output buffer: idwt_lift_cols reads each
// coefficient that is new at its level from x (the top-left quadrant of
// every level but the deepest from out, where the level below left it)
// and writes out; idwt_lift_rows lifts rows of out in place.  No copy of
// x comes first, so out == x runs in place with no other change.  About 2
// x 8 bytes per sample of each level's region: 386 MB for [16, 768, 1472]
// at 5 levels, against the 145 MB of one read and one write of the
// frames.  levels == 0 is a copy (idwt_copy) unless out == x.  Measured
// by chip_smoke.py on an H100 80GB HBM3 at 700 W ([16, 768, 1472] L=5,
// profiler): idwt_lift_cols 1827-1830 GB/s, idwt_lift_rows 2568-2576
// GB/s; 0.201-0.202 ms a call, where copying x first and lifting in place
// took 0.564-0.565 ms.
//
// Arithmetic is the native decoder's (ebcc_cpu_decoder.cc:36-117), as
// lifting.cuh says: __fmaf_rn at its fma sites, a multiply by the f32
// reciprocal of XI, and -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lifting.cuh"

namespace {

// column-pass loader: x, or out for the top-left quadrant above the
// deepest level (x and out may be one buffer)
struct ReadLoad {
  const float* x;    // this frame
  const float* out;  // this frame
  int wp, c, n2;
  bool quad;

  static constexpr bool kCooks = false;

  __device__ __forceinline__ int raw(int r) const {
    return __float_as_int((quad && r < n2 ? out : x)[(int64_t)r * wp + c]);
  }

  __device__ __forceinline__ float cook(int, int bits) const {
    return __int_as_float(bits);
  }
};

__global__ void __launch_bounds__(kColStrip * kColRows)
idwt_lift_cols(const float* x, float* out, int hp, int wp, int hh, int ww,
               int deepest) {
  const int64_t off = (int64_t)blockIdx.y * hp * wp;
  const int c = blockIdx.x * kColStrip + threadIdx.x;
  ReadLoad load{x + off, out + off, wp, c, hh / 2,
                c < ww / 2 && !deepest};
  lift_cols_block(load, out + off, wp, hh, ww, hh);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
idwt_lift_rows(float* out, int hp, int wp, int hh, int ww) {
  float* f = out + (int64_t)blockIdx.y * hp * wp;
  StoreRun store{f, wp, ww / 2};
  lift_rows_block<kVec>(f, wp, ww, hh, ww / 2, store);
}

__global__ void idwt_copy(const float* __restrict__ x,
                          float* __restrict__ out, int64_t n) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * blockDim.x)
    out[k] = x[k];
}

uint64_t smem_cols = 0, smem_rows[2] = {0, 0};

}  // namespace

extern "C" {

// x, out f32 [B, hp, wp] (out may equal x: then it runs in place); levels
// 0..8, every level's hh x ww region even and >= 4 on both sides, hp <=
// 1816, wp <= 24576.  Returns the first launch error.
int ebcc_idwt(int device, const float* x, float* out, int B, int hp, int wp,
              int levels, cudaStream_t stream) {
  if (levels < 0 || levels > 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (levels == 0) {
    if (out != x)
      idwt_copy<<<4 * 132, 256, 0, stream>>>(x, out, (int64_t)B * hp * wp);
    return (int)cudaGetLastError();
  }
  if ((e = allow_smem(idwt_lift_cols, kMaxSmem, smem_cols)) != cudaSuccess ||
      (e = allow_smem(idwt_lift_rows<false>, kRowSmem, smem_rows[0])) !=
          cudaSuccess ||
      (e = allow_smem(idwt_lift_rows<true>, kRowSmem, smem_rows[1])) !=
          cudaSuccess)
    return (int)e;
  for (int i = levels - 1; i >= 0; --i) {
    const int hh = hp >> i, ww = wp >> i;
    const int col_bytes = hh * kColStrip * (int)sizeof(float);
    if (col_bytes > kMaxSmem || ww > kRowSmem / (int)sizeof(float))
      return (int)cudaErrorInvalidValue;
    idwt_lift_cols<<<dim3((ww + kColStrip - 1) / kColStrip, B),
                     dim3(kColStrip, kColRows), col_bytes, stream>>>(
        x, out, hp, wp, hh, ww, i == levels - 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int rows = row_block_rows(ww);
    const dim3 grid((hh + rows - 1) / rows, B), block(kThreads / rows, rows);
    const int row_bytes = rows * ww * (int)sizeof(float);
    if (row_vec(ww, wp, out))
      idwt_lift_rows<true><<<grid, block, row_bytes, stream>>>(out, hp, wp,
                                                               hh, ww);
    else
      idwt_lift_rows<false><<<grid, block, row_bytes, stream>>>(out, hp, wp,
                                                                hh, ww);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
