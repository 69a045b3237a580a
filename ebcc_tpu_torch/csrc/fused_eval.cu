// Candidate evaluation of the error-bounded truncation searches, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ebcc_tpu/ops/pallas_eval.py::eval_stats
// (_build_call's kernel, scalar-target and per-point target-field
// variants): per frame, reconstruct
// the integer coefficients at one candidate — (plane b, js sig / jr refine
// chunks) or (plane b, per-stripe drop mask) — midpoint-dequantise, divide
// by the subband weight, run the levels-deep inverse CDF 9/7 transform,
// apply the base or residual tail and reduce |ref - out| - tgt over the
// valid h x w region to (max excess, violation count).  tgt is the frame's
// scalar target, or the point's entry of a [B, hp, wp] target field
// (POINTWISE_MAX_ERROR).
//
// What bounds it here: memory traffic.  The TPU kernel kept the whole
// 768x1472 f32 frame (4.5 MB) in VMEM; one block here has at most 227 KB
// of shared memory, so the frame lives in a per-batch f32 workspace
// [B, hp, wp] in device memory (reused across evaluations) and the
// evaluation runs as passes over it:
//   1. compose: one thread per coefficient, ci -> workspace;
//   2. per level L-1..0: the column and row lifting passes of
//      lifting.cuh (eval_lift_cols, eval_lift_rows), in place on the
//      workspace;
//   3. tail + reduce over rows < h, cols < w: block reduction, then one
//      atomic per block and frame (float max through the order-preserving
//      int mapping, integer count).
// About 9 frame-sized f32 passes per evaluation against the TPU design's
// 2-3 (663 MB per base evaluation at B=16: 0.2 ms at 3.35 TB/s).  On an
// H100 (700 W) one such evaluation takes 0.87 ms: compose and the row pass
// reach ~0.55 TB/s, held back by per-element index arithmetic and block
// synchronisation more than by bytes.  Fusing compose into the first
// column pass and the tail into the last row pass is the next step.
//
// Arithmetic is the native codec's, site by site (ebcc_cpu_decoder.cc:
// 36-117, 313-330): the lifting steps as lifting.cuh says, the unscale is
// fma(y, RECIP * (hi - lo), lo), and the weight division is a true IEEE
// division.  Build with -fmad=false so nvcc contracts nothing else.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lifting.cuh"

namespace {

constexpr float RECIP_U16 = (float)(1.0 / 65535.0);
constexpr float RECIP_RS = (float)(1.0 / 255.0);

constexpr int kMaxSubbands = 3 * 8 + 1;  // MAX_LEVELS = 8

struct Peaks {
  float v[kMaxSubbands];
};

// order-preserving map float -> int32 (and its inverse, the same map)
__device__ __forceinline__ int float_key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// subband id of coefficient (r, c) in the Mallat layout
// (ebcc_tpu/ops/weights.py subband_map)
__device__ __forceinline__ int subband(int r, int c, int hp, int wp,
                                       int levels) {
  int sid = 0;
  for (int i = 0; i < levels; ++i) {
    const int hh = hp >> i, ww = wp >> i;
    const bool top = r < hh / 2, bot = r >= hh / 2 && r < hh;
    const bool left = c < ww / 2, right = c >= ww / 2 && c < ww;
    if (top && right) sid = 3 * i + 1;
    else if (bot && left) sid = 3 * i + 2;
    else if (bot && right) sid = 3 * i + 3;
  }
  return sid;
}

// 1. compose: rec(candidate) / weight -> work; also resets the stats
__global__ void compose(const int32_t* __restrict__ ci,
                        const int32_t* __restrict__ iparams, Peaks peaks,
                        int hp, int wp, int levels, int nchunks, int masked,
                        float* __restrict__ work, int32_t* stats) {
  const int fb = blockIdx.y;
  const int64_t n = (int64_t)hp * wp;
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k == 0) {
    stats[2 * fb] = float_key(-INFINITY);
    stats[2 * fb + 1] = 0;
  }
  if (k >= n) return;
  const int r = (int)(k / wp), c = (int)(k % wp);
  const int32_t* ip = iparams + 4 * fb;
  const int b = ip[0];
  const int chunk = (int)(((int64_t)r * nchunks) / hp);
  const int v = ci[(int64_t)fb * n + k];
  const int mag = v < 0 ? -v : v;
  int q, d;
  bool visible;
  if (masked) {
    d = b + ((ip[3] >> chunk) & 1);
    q = mag >> d;
    visible = q > 0;
    q <<= d;
  } else {
    const int msb = mag ? 31 - __clz(mag) : -1;
    const bool old = msb > b, nw = msb == b;
    visible = old || (nw && chunk < ip[1]);
    d = (old && chunk >= ip[2]) ? b + 1 : b;
    q = (mag >> d) << d;
  }
  const float half = (ldexpf(1.0f, d) - 1.0f) * 0.5f;
  float rec = visible ? (float)q + half : 0.0f;
  if (v < 0) rec = -rec;
  work[(int64_t)fb * n + k] = rec / peaks.v[subband(r, c, hp, wp, levels)];
}

// 2. the lifting passes of lifting.cuh
__global__ void eval_lift_cols(float* __restrict__ work, int hp, int wp,
                               int hh, int ww) {
  lift_cols_block(work, hp, wp, hh, ww);
}

__global__ void eval_lift_rows(float* __restrict__ work, int hp, int wp,
                               int hh, int ww, int rows) {
  lift_rows_block(work, hp, wp, hh, ww, rows);
}

// 3. tail + reduce over the valid h x w region of each frame
__global__ void tail_reduce(const float* __restrict__ work,
                            const float* __restrict__ ref,
                            const float* __restrict__ base_rec,
                            const float* __restrict__ tgt_field,
                            const float* __restrict__ fparams, int hp,
                            int wp, int h, int w, int resid,
                            int32_t* stats) {
  const int fb = blockIdx.y;
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float* fp = fparams + 4 * fb;
  const float dc = fp[0], lo = fp[1], hi = fp[2];
  float mx = -INFINITY;
  int cnt = 0;
  if (k < (int64_t)h * w) {
    const int r = (int)(k / w), c = (int)(k % w);
    const int64_t off = (int64_t)fb * hp * wp + (int64_t)r * wp + c;
    float y = work[off] + dc;
    float out;
    if (resid) {
      y = fminf(fmaxf(y, 0.0f), 255.0f);
      out = base_rec[off] + __fmaf_rn(y, RECIP_RS * (hi - lo), lo);
    } else {
      y = fminf(fmaxf(y, 0.0f), 65535.0f);
      out = __fmaf_rn(y, RECIP_U16 * (hi - lo), lo);
    }
    const float tgt = tgt_field ? tgt_field[off] : fp[3];
    const float err = fabsf(ref[off] - out) - tgt;
    mx = err;
    cnt = err > 0.0f;
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  __shared__ float wmax[kThreads / 32];
  __shared__ int wcnt[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wmax[warp] = mx;
    wcnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      mx = fmaxf(mx, wmax[i]);
      cnt += wcnt[i];
    }
    atomicMax(&stats[2 * fb], float_key(mx));
    if (cnt) atomicAdd(&stats[2 * fb + 1], cnt);
  }
}

}  // namespace

extern "C" {

// ci int32 [B, hp, wp]; ref, base_rec (resid only, else NULL) and
// tgt_field (per-point targets, else NULL) f32 [B, hp, wp]; iparams int32
// [B, 4] = (b, js, jr, dropmask); fparams f32 [B, 4] = (dc, lo, hi, tgt;
// tgt unread when tgt_field is given); peaks: host array of 3 * levels + 1 subband
// weights; work f32 [B, hp, wp] scratch; stats int32 [B, 2] = (float key
// of the max excess, violation count).  kind: 0 base, 1 resid; mode: 0
// trunc, 1 masked.  Returns cudaGetLastError().
int ebcc_fused_eval(int device, const int32_t* ci, const float* ref,
                    const float* base_rec, const float* tgt_field,
                    const int32_t* iparams,
                    const float* fparams, const float* peaks, int B, int hp,
                    int wp, int levels, int nchunks, int h, int w, int kind,
                    int mode, float* work, int32_t* stats,
                    cudaStream_t stream) {
  if (levels < 0 || levels > 8 || h > hp || w > wp)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Peaks pk{};
  for (int i = 0; i < 3 * levels + 1; ++i) pk.v[i] = peaks[i];
  const int64_t n = (int64_t)hp * wp;
  compose<<<dim3((unsigned)((n + kThreads - 1) / kThreads), B), kThreads, 0,
            stream>>>(ci, iparams, pk, hp, wp, levels, nchunks, mode == 1,
                      work, stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = inverse_levels(eval_lift_cols, eval_lift_rows, work, B, hp, wp,
                          levels, stream)) != cudaSuccess)
    return (int)e;
  const int64_t nv = (int64_t)h * w;
  tail_reduce<<<dim3((unsigned)((nv + kThreads - 1) / kThreads), B),
                kThreads, 0, stream>>>(work, ref, base_rec, tgt_field, fparams,
                                       hp, wp, h, w, kind == 1, stats);
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
