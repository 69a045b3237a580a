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
// [B, hp, wp] in device memory (reused across evaluations, 72 MB at B=16:
// above the 50 MB L2) and one evaluation is 2L passes over it, per level
// L-1..0 of the lifting.cuh passes:
//   eval_lift_cols: composes every coefficient that is new at the level
//       on load, from ci (the candidate's dequantisation divided by the
//       weight of its quadrant, passed per level as four scalars; the
//       chunk id advances once per chunk of rows), takes the top-left
//       quadrant from the workspace, lifts the columns and writes the
//       workspace (at level 0 only rows < h); the deepest level's also
//       resets the stats;
//   eval_lift_rows (levels L-1..1): lifts rows in place;
//   eval_rows_tail (level 0, rows < h): lifts each row and feeds it
//       straight to the tail (+ dc, clamp, unscale, + base_rec for resid,
//       |ref - out| - tgt over cols < w): a block reduction, then one
//       atomic per block and frame (float max through the order-preserving
//       int mapping, integer count).  Level 0 writes no workspace.
// levels == 0 is eval_reset then eval_compose_tail (compose, tail and
// reduce in one pass).  This design replaced a separate compose pass and
// tail pass and a row pass with a division and modulo per element and six
// block syncs: 663 MB moved per base evaluation at B=16 before, about 370
// MB now (column passes ~190 MB, rows of levels 1-4 ~48 MB, level 0 row +
// tail ~135 MB: workspace rows < h and ref).  Measured by chip_smoke.py on
// an H100 80GB HBM3 at 700 W (one base evaluation at B=16, profiler):
// eval_lift_cols 1088-1090 GB/s, eval_lift_rows 2495-2515 GB/s,
// eval_rows_tail 2220-2222 GB/s; 0.301-0.306 ms a call, where the
// previous design took 0.884-0.900 ms on the same card.  The column pass
// is the slowest: its compose adds integer work and an IEEE division per
// coefficient (idwt's column pass, without it, runs at ~1830 GB/s).
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

// order-preserving map float -> int32 (and its inverse, the same map)
__device__ __forceinline__ int float_key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// The candidate of one frame (iparams row: b, js, jr, dropmask) and the
// per-row quantities that depend on the row's chunk, advanced row by row:
// rows must come in increasing order.
struct Candidate {
  int b, js, jr, dropmask, hp, nchunks;
  bool masked;
  int chunk, next;  // chunk of the current row; first row of the next one
  int d_row;        // masked: the row's plane shift
  bool sig, refine_up;  // trunc: new coefficients visible; old ones at b+1

  __device__ __forceinline__ Candidate(const int32_t* ip, int hp_,
                                       int nchunks_, bool masked_)
      : b(ip[0]), js(ip[1]), jr(ip[2]), dropmask(ip[3]), hp(hp_),
        nchunks(max(nchunks_, 1)), masked(masked_), chunk(-1), next(0) {}

  // chunk(r) = r * nchunks / hp, found by stepping over chunk boundaries
  __device__ __forceinline__ void row(int r) {
    while (r >= next) {
      ++chunk;
      next = ((chunk + 1) * hp + nchunks - 1) / nchunks;
      d_row = b + ((dropmask >> chunk) & 1);
      sig = chunk < js;
      refine_up = chunk >= jr;
    }
  }

  // midpoint reconstruction of integer coefficient v on the current row
  __device__ __forceinline__ float rec(int v) const {
    const int mag = v < 0 ? -v : v;
    int q, d;
    bool visible;
    if (masked) {
      d = d_row;
      q = mag >> d;
      visible = q > 0;
      q <<= d;
    } else {
      const int msb = mag ? 31 - __clz(mag) : -1;
      const bool old = msb > b, nw = msb == b;
      visible = old || (nw && sig);
      d = (old && refine_up) ? b + 1 : b;
      q = (mag >> d) << d;
    }
    // 2^d exactly (0 <= d < 128)
    const float half = (__int_as_float((127 + d) << 23) - 1.0f) * 0.5f;
    float r = visible ? (float)q + half : 0.0f;
    return v < 0 ? -r : r;
  }
};

// column-pass loader: the top-left quadrant from the workspace above the
// deepest level, every other coefficient composed from ci / its weight
struct ComposeLoad {
  const int32_t* ci;   // this frame
  const float* work;   // this frame
  Candidate cand;
  int wp, c, n2;
  bool quad;           // column in the left half, and not the deepest level
  float wt_top, wt_bot;

  static constexpr bool kCooks = true;

  __device__ __forceinline__ int raw(int r) const {
    const int32_t* p = quad && r < n2 ? reinterpret_cast<const int32_t*>(work)
                                      : ci;
    return p[(int64_t)r * wp + c];
  }

  __device__ __forceinline__ float cook(int r, int bits) {
    if (quad && r < n2) return __int_as_float(bits);
    cand.row(r);
    return cand.rec(bits) / (r < n2 ? wt_top : wt_bot);
  }
};

// level i's column pass; wt = the level's (tl, tr, bl, br) weights, tl
// read only at the deepest level
__global__ void __launch_bounds__(kColStrip * kColRows)
eval_lift_cols(const int32_t* __restrict__ ci,
               const int32_t* __restrict__ iparams, float* work,
               int32_t* __restrict__ stats, int hp, int wp, int hh, int ww,
               int hstore, int nchunks, int masked, int deepest, float wt_tl,
               float wt_tr, float wt_bl, float wt_br) {
  const int fb = blockIdx.y;
  const int64_t n = (int64_t)hp * wp;
  if (deepest && blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    stats[2 * fb] = float_key(-INFINITY);
    stats[2 * fb + 1] = 0;
  }
  const int c = blockIdx.x * kColStrip + threadIdx.x;
  const bool right = c >= ww / 2;
  ComposeLoad load{ci + fb * n, work + fb * n,
                   Candidate(iparams + 4 * fb, hp, nchunks, masked != 0),
                   wp, c, hh / 2, !right && !deepest,
                   right ? wt_tr : wt_tl, right ? wt_br : wt_bl};
  lift_cols_block(load, work + fb * n, wp, hh, ww, hstore);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
eval_lift_rows(float* work, int hp, int wp, int hh, int ww) {
  float* f = work + (int64_t)blockIdx.y * hp * wp;
  StoreRun out{f, wp, ww / 2};
  lift_rows_block<kVec>(f, wp, ww, hh, ww / 2, out);
}

// the reconstruction tail and error of one frame, summed into (mx, cnt)
struct Tail {
  const float* ref;        // this frame
  const float* base_rec;   // this frame, resid only (else null)
  const float* tgt_field;  // this frame, or null: the scalar tgt
  float dc, lo, scale, top, tgt;
  int wp, w;
  float mx = -INFINITY;
  int cnt = 0;

  __device__ __forceinline__ Tail(const float* ref_, const float* base_rec_,
                                  const float* tgt_field_, const float* fp,
                                  bool resid, int wp_, int w_)
      : ref(ref_), base_rec(base_rec_), tgt_field(tgt_field_), dc(fp[0]),
        lo(fp[1]), scale((resid ? RECIP_RS : RECIP_U16) * (fp[2] - fp[1])),
        top(resid ? 255.0f : 65535.0f), tgt(fp[3]), wp(wp_), w(w_) {}

  // v: the inverse transform at (r, c), with its ref, base_rec and tgt
  __device__ __forceinline__ void point(float v, float rf, float br,
                                        float tg) {
    const float y = fminf(fmaxf(v + dc, 0.0f), top);
    const float out = base_rec ? br + __fmaf_rn(y, scale, lo)
                               : __fmaf_rn(y, scale, lo);
    const float err = fabsf(rf - out) - tg;
    mx = fmaxf(mx, err);
    cnt += err > 0.0f;
  }

  // row-pass epilogue: the run's 2 * kRun samples at cols [2 i0, 2 i0 + 8)
  template <bool kVec>
  __device__ __forceinline__ void run(int row, int i0,
                                      const float (&o)[2 * kRun]) {
    const int c0 = 2 * i0;
    const int64_t off = (int64_t)row * wp + c0;
    if (kVec && c0 + 2 * kRun <= w) {
      float rf[2 * kRun], br[2 * kRun], tg[2 * kRun];
      load8(ref + off, rf);
      if (base_rec) load8(base_rec + off, br);
      if (tgt_field) load8(tgt_field + off, tg);
#pragma unroll
      for (int k = 0; k < 2 * kRun; ++k)
        point(o[k], rf[k], base_rec ? br[k] : 0.0f,
              tgt_field ? tg[k] : tgt);
    } else {
#pragma unroll
      for (int k = 0; k < 2 * kRun; ++k)
        if (c0 + k < w)
          point(o[k], ref[off + k], base_rec ? base_rec[off + k] : 0.0f,
                tgt_field ? tgt_field[off + k] : tgt);
    }
  }

  static __device__ __forceinline__ void load8(const float* p,
                                               float (&v)[2 * kRun]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }

  // block reduction of (mx, cnt) and one atomic per block into frame
  // fb's stats
  __device__ __forceinline__ void reduce(int32_t* stats, int fb) {
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      cnt += __shfl_xor_sync(kFull, cnt, o);
    }
    __shared__ float wmax[kThreads / 32];
    __shared__ int wcnt[kThreads / 32];
    const int t = threadIdx.y * blockDim.x + threadIdx.x;
    const int nw = blockDim.x * blockDim.y / 32;
    if ((t & 31) == 0) {
      wmax[t >> 5] = mx;
      wcnt[t >> 5] = cnt;
    }
    __syncthreads();
    if (t == 0) {
      for (int i = 1; i < nw; ++i) {
        mx = fmaxf(mx, wmax[i]);
        cnt += wcnt[i];
      }
      atomicMax(&stats[2 * fb], float_key(mx));
      if (cnt) atomicAdd(&stats[2 * fb + 1], cnt);
    }
  }
};

// level 0's row pass over rows < h, fused with the tail and the reduction
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
eval_rows_tail(const float* __restrict__ work, const float* __restrict__ ref,
               const float* __restrict__ base_rec,
               const float* __restrict__ tgt_field,
               const float* __restrict__ fparams, int hp, int wp, int h,
               int w, int32_t* __restrict__ stats) {
  const int fb = blockIdx.y;
  const int64_t off = (int64_t)fb * hp * wp;
  Tail tail(ref + off, base_rec ? base_rec + off : nullptr,
            tgt_field ? tgt_field + off : nullptr, fparams + 4 * fb,
            base_rec != nullptr, wp, w);
  lift_rows_block<kVec>(work + off, wp, wp, h, (w + 1) / 2, tail);
  tail.reduce(stats, fb);
}

// levels == 0: reset the stats, then compose + tail + reduce in one pass
// (block (kThreads) over a kThreads-column tile of one row < h)
__global__ void eval_reset(int32_t* stats, int B) {
  const int fb = blockIdx.x * blockDim.x + threadIdx.x;
  if (fb < B) {
    stats[2 * fb] = float_key(-INFINITY);
    stats[2 * fb + 1] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
eval_compose_tail(const int32_t* __restrict__ ci,
                  const float* __restrict__ ref,
                  const float* __restrict__ base_rec,
                  const float* __restrict__ tgt_field,
                  const int32_t* __restrict__ iparams,
                  const float* __restrict__ fparams, int hp, int wp, int w,
                  int nchunks, int masked, float wt,
                  int32_t* __restrict__ stats) {
  const int fb = blockIdx.z, r = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int64_t off = (int64_t)fb * hp * wp;
  Tail tail(ref + off, base_rec ? base_rec + off : nullptr,
            tgt_field ? tgt_field + off : nullptr, fparams + 4 * fb,
            base_rec != nullptr, wp, w);
  if (c < w) {
    Candidate cand(iparams + 4 * fb, hp, nchunks, masked != 0);
    cand.row(r);
    const int64_t k = (int64_t)r * wp + c;
    tail.point(cand.rec(ci[off + k]) / wt, tail.ref[k],
               tail.base_rec ? tail.base_rec[k] : 0.0f,
               tail.tgt_field ? tail.tgt_field[k] : tail.tgt);
  }
  tail.reduce(stats, fb);
}

uint64_t smem_cols = 0, smem_rows[2] = {0, 0}, smem_tail[2] = {0, 0};

}  // namespace

extern "C" {

// ci int32 [B, hp, wp]; ref, base_rec (resid only, else NULL) and
// tgt_field (per-point targets, else NULL) f32 [B, hp, wp]; iparams int32
// [B, 4] = (b, js, jr, dropmask); fparams f32 [B, 4] = (dc, lo, hi, tgt;
// tgt unread when tgt_field is given); weights: host array f32
// [max(levels, 1)][4], the (top-left, top-right, bottom-left,
// bottom-right) weights of the coefficients new at each level
// (ops/fused_eval.py level_weights); work f32 [B, hp, wp] scratch; stats
// int32 [B, 2] = (float key of the max excess, violation count).  kind: 0
// base, 1 resid; mode: 0 trunc, 1 masked.  Returns the first launch error.
int ebcc_fused_eval(int device, const int32_t* ci, const float* ref,
                    const float* base_rec, const float* tgt_field,
                    const int32_t* iparams,
                    const float* fparams, const float* weights, int B, int hp,
                    int wp, int levels, int nchunks, int h, int w, int kind,
                    int mode, float* work, int32_t* stats,
                    cudaStream_t stream) {
  if (levels < 0 || levels > 8 || h > hp || w > wp || h < 1 || w < 1 ||
      (kind == 1) != (base_rec != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int masked = mode == 1;
  if (levels == 0) {
    eval_reset<<<(B + 255) / 256, 256, 0, stream>>>(stats, B);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    eval_compose_tail<<<dim3((w + kThreads - 1) / kThreads, h, B), kThreads,
                        0, stream>>>(ci, ref, base_rec, tgt_field, iparams,
                                     fparams, hp, wp, w, nchunks, masked,
                                     weights[0], stats);
    return (int)cudaGetLastError();
  }
  if ((e = allow_smem(eval_lift_cols, kMaxSmem, smem_cols)) != cudaSuccess ||
      (e = allow_smem(eval_lift_rows<false>, kRowSmem, smem_rows[0])) !=
          cudaSuccess ||
      (e = allow_smem(eval_lift_rows<true>, kRowSmem, smem_rows[1])) !=
          cudaSuccess ||
      (e = allow_smem(eval_rows_tail<false>, kRowSmem, smem_tail[0])) !=
          cudaSuccess ||
      (e = allow_smem(eval_rows_tail<true>, kRowSmem, smem_tail[1])) !=
          cudaSuccess)
    return (int)e;
  const bool tail_vec = row_vec(wp, wp, work) && aligned16(ref) &&
                        (!base_rec || aligned16(base_rec)) &&
                        (!tgt_field || aligned16(tgt_field));
  for (int i = levels - 1; i >= 0; --i) {
    const int hh = hp >> i, ww = wp >> i;
    const int col_bytes = hh * kColStrip * (int)sizeof(float);
    if (col_bytes > kMaxSmem || ww > kRowSmem / (int)sizeof(float))
      return (int)cudaErrorInvalidValue;
    const float* wt = weights + 4 * i;
    eval_lift_cols<<<dim3((ww + kColStrip - 1) / kColStrip, B),
                     dim3(kColStrip, kColRows), col_bytes, stream>>>(
        ci, iparams, work, stats, hp, wp, hh, ww, i == 0 ? h : hh, nchunks,
        masked, i == levels - 1, wt[0], wt[1], wt[2], wt[3]);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int rows = row_block_rows(ww);
    const dim3 block(kThreads / rows, rows);
    const int row_bytes = rows * ww * (int)sizeof(float);
    if (i > 0) {
      const dim3 grid((hh + rows - 1) / rows, B);
      if (row_vec(ww, wp, work))
        eval_lift_rows<true><<<grid, block, row_bytes, stream>>>(
            work, hp, wp, hh, ww);
      else
        eval_lift_rows<false><<<grid, block, row_bytes, stream>>>(
            work, hp, wp, hh, ww);
    } else {
      const dim3 grid((h + rows - 1) / rows, B);
      if (tail_vec)
        eval_rows_tail<true><<<grid, block, row_bytes, stream>>>(
            work, ref, base_rec, tgt_field, fparams, hp, wp, h, w, stats);
      else
        eval_rows_tail<false><<<grid, block, row_bytes, stream>>>(
            work, ref, base_rec, tgt_field, fparams, hp, wp, h, w, stats);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
