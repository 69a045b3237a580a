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
// block's shared memory, so the input is copied into the output buffer
// and each level runs the column and row lifting passes of lifting.cuh
// (idwt_lift_cols, idwt_lift_rows) in place on it: about 2 x 8 bytes per
// sample of each level's region, 386 MB for [16, 768, 1472] at 5 levels,
// against the 145 MB of one read and one write of the frames.
//
// Arithmetic is the native decoder's (ebcc_cpu_decoder.cc:36-117), as
// lifting.cuh says: __fmaf_rn at its fma sites, a multiply by the f32
// reciprocal of XI, and -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lifting.cuh"

namespace {

__global__ void idwt_lift_cols(float* __restrict__ work, int hp, int wp,
                               int hh, int ww) {
  lift_cols_block(work, hp, wp, hh, ww);
}

__global__ void idwt_lift_rows(float* __restrict__ work, int hp, int wp,
                               int hh, int ww, int rows) {
  lift_rows_block(work, hp, wp, hh, ww, rows);
}

}  // namespace

extern "C" {

// x, out f32 [B, hp, wp] (out may equal x: then it runs in place); levels
// 0..8, every level's hh x ww region even and >= 4 on both sides, hp <=
// 1816, wp <= 24576.  Returns cudaGetLastError().
int ebcc_idwt(int device, const float* x, float* out, int B, int hp, int wp,
              int levels, cudaStream_t stream) {
  if (levels < 0 || levels > 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (out != x) {
    e = cudaMemcpyAsync(out, x, (size_t)B * hp * wp * sizeof(float),
                        cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
  }
  if ((e = inverse_levels(idwt_lift_cols, idwt_lift_rows, out, B, hp, wp,
                          levels, stream)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
