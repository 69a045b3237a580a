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
// of shared memory, so the frame lives in a per-batch f32 workspace in
// device memory (reused across evaluations, 45 MB at B=8: [B, hp, wp] for
// the even levels and [B, hp/2, wp/2] for the odd ones) and one
// evaluation is 2L passes over it, per level L-1..0 of the lifting.cuh
// passes:
//   eval_lift_cols: composes every coefficient that is new at the level
//       once, from ci (the candidate's dequantisation divided by the
//       weight of its quadrant, passed per level as four scalars; the
//       chunk id advances once per chunk of rows), takes the top-left
//       quadrant from the level below's buffer, lifts the columns and
//       writes its own level's buffer (at level 0 only rows < h); the
//       deepest level's also resets the stats;
//   eval_lift_rows (levels L-1..1): lifts rows in place;
//   eval_rows_tail (level 0, rows < h): lifts each row and feeds it
//       straight to the tail (+ dc, clamp, unscale, + base_rec for resid,
//       |ref - out| - tgt over cols < w): a block reduction, then one
//       atomic per block and frame (float max through the order-preserving
//       int mapping, integer count).  Level 0 writes no workspace.
// levels == 0 is eval_reset then eval_compose_tail (compose, tail and
// reduce in one pass).  About 370 MB move per base evaluation at B=16
// (column passes ~190 MB, rows of levels 1-4 ~48 MB, level 0 row + tail
// ~135 MB: workspace rows < h and ref).
//
// The column pass is the banded design of lifting.cuh: a persistent grid
// of four 256-thread CTAs an SM walks (frame, strip, band) items whose
// tile ops/fused_eval.py col_plan chooses per level from (hh, ww, hstore,
// B) and the card's SM count, loads each item's window with cp.async while
// it composes and lifts the item before, composes each new coefficient
// once in shared memory and lifts each column's pairs in registers.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (one base
// evaluation, 768x1472 at 5 levels): the column passes take 0.0548 ms at
// B=8 (1717 GB/s; level 0 2427 GB/s) and 0.0894 ms at B=16 (2106 GB/s).
// The design they replaced, one block per full-height strip of 16
// columns (five synchronised lifting steps, no overlap between loading,
// composing and lifting; 1.39 waves at level 0 at B=8), ran at 1081-1090
// GB/s at B=16 and about 900 at B=8.  What bounds the pass now is the
// compose's instructions, above all the IEEE division (a branch to its
// slow path follows each, so divisions do not overlap): without the
// compose the same pass runs at 2.3-3.1 TB/s.
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

  // start the walk at row r, from any row: the chunk before chunk(r) and
  // its end (at most r), then one step of row(); later rows must come in
  // increasing order again
  __device__ __forceinline__ void seek(int r) {
    chunk = r * nchunks / hp - 1;
    next = ((chunk + 1) * hp + nchunks - 1) / nchunks;
    row(r);
  }

  // midpoint reconstruction of integer coefficient v on the current row
  __device__ __forceinline__ float rec(int v) const {
    return rec(v, d_row, sig, refine_up);
  }

  // the same on a row whose d_row, sig and refine_up are given
  __device__ __forceinline__ float rec(int v, int drow, bool sg,
                                       bool rup) const {
    const int mag = v < 0 ? -v : v;
    int q, d;
    bool visible;
    if (masked) {
      d = drow;
      q = mag >> d;
      visible = q > 0;
      q <<= d;
    } else {
      const int msb = mag ? 31 - __clz(mag) : -1;
      const bool old = msb > b, nw = msb == b;
      visible = old || (nw && sg);
      d = (old && rup) ? b + 1 : b;
      q = (mag >> d) << d;
    }
    // 2^d exactly (0 <= d < 128)
    const float half = (__int_as_float((127 + d) << 23) - 1.0f) * 0.5f;
    float r = visible ? (float)q + half : 0.0f;
    return v < 0 ? -r : r;
  }
};

// The column pass's compose of one coefficient: Candidate::rec(v, drow,
// sg, rup) / wt, with the same bits, in fewer instructions.  For
// 0 <= b <= 30 (shift) the msb tests are shifts (msb > b iff mag >> b >
// 1, msb == b iff mag >> b == 1), half comes from the two values d can
// take (b, b + 1), and no zero enters the division: a zero's quotient is
// the zero itself, and x / wt = -(-x / wt) in round to nearest.
template <bool kMasked>
struct BandRec {
  int b;
  bool shift;
  float half_b, half_b1;  // (2^d - 1) / 2 at d = b and d = b + 1

  static __device__ __forceinline__ BandRec of(const Candidate& c) {
    return BandRec{c.b, 0 <= c.b && c.b <= 30,
                   (__int_as_float((127 + c.b) << 23) - 1.0f) * 0.5f,
                   (__int_as_float((128 + c.b) << 23) - 1.0f) * 0.5f};
  }

  __device__ __forceinline__ float div(const Candidate& c, int v, int drow,
                                       bool sg, bool rup, float wt) const {
    if (!shift) return c.rec(v, drow, sg, rup) / wt;
    const int mag = v < 0 ? -v : v;
    int q;
    bool visible, up;
    if (kMasked) {
      up = drow != b;
      q = mag >> drow;
      visible = q > 0;
      q <<= drow;
    } else {
      const unsigned t = (unsigned)mag >> b;
      const bool old = t > 1u;
      visible = old || (t == 1u && sg);
      up = old && rup;
      const int d = b + up;
      q = (mag >> d) << d;
    }
    const float a = visible ? (float)q + (up ? half_b1 : half_b) : 1.0f;
    const float x = visible ? a / wt : 0.0f;
    return v < 0 ? -x : x;
  }
};

// A level's column-pass tile (ops/fused_eval.py col_plan): strips of
// kStrip columns (the kernel's template argument, 32 or 64), bands of
// `band` (s, d) pairs (a multiple of kRun), nstrips x nbands items a
// frame, item it = (frame * nbands + band index) * nstrips + strip index.
struct ColTile {
  int band, nstrips, nbands;
};

// rows of a thread's compose run taken together
constexpr int kUnroll = 4;

// One item: frame fb, pairs [p0, p0 + nb) (rows [2 p0, 2 (p0 + nb)) of
// the output), columns [c0, c0 + strip).
struct ColItem {
  int fb, p0, nb, c0;
};

// Level i's column pass (kMasked: chunk-mask candidates, else prefix
// ones).  A persistent grid walks the items; each CTA keeps two stages of
// shared memory, each an item's window and candidate: s rows [p0 - 1,
// p0 + nb + 2) at stage rows [0, nb + 3) and d rows [p0 - 2, p0 + nb + 2)
// at stage rows [band + 3, band + nb + 7), clamped into the level
// (kColHalo pairs of halo).  Per item: wait for its copies, start the next
// item's copies into the other stage, compose the new coefficients in
// place (the raw ci bits reconstructed as Candidate::rec does, then a true
// division by the quadrant's weight: BandRec; the top-left quadrant above
// the deepest level is the level below's output, read from quad, and left
// as it is), sync, and lift: each thread takes kRun pairs of one column at
// a time, its window from the stage, and writes the rows < hstore it owns
// to dst.  The deepest level's first CTA also resets the stats.
template <bool kVec, int kStrip, bool kMasked>
__global__ void __launch_bounds__(kColThreads, kColCtasPerSm)
eval_lift_cols(const int32_t* __restrict__ ci,
               const int32_t* __restrict__ iparams, const float* quad,
               float* dst, int32_t* __restrict__ stats, int B, int hp,
               int wp, int qstride, int64_t qframe, int dstride,
               int64_t dframe, int hh, int ww, int hstore, int nchunks,
               int deepest, ColTile t, float wt_tl, float wt_tr,
               float wt_bl, float wt_br) {
  extern __shared__ __align__(16) float col_sm[];  // the two stages
  constexpr int lg = kStrip == 32 ? 5 : 6;
  constexpr int tys = kColThreads / kStrip;  // thread rows
  static_assert(kStrip == 1 << lg, "a strip is 32 or 64 columns");
  const int tid = threadIdx.x;
  const int tx = tid & (kStrip - 1), ty = tid >> lg;
  const int n2 = hh / 2, half = ww / 2, npairs = (hstore + 1) / 2;
  const int items = B * t.nbands * t.nstrips;
  const int srows = t.band + 2 * kColHalo - 1;  // a stage's s rows
  // a stage: the window, then the item's candidate (iparams row)
  const int window = (2 * t.band + 4 * kColHalo - 1) * kStrip;  // floats
  const int stage = window + 4;
  if (deepest && blockIdx.x == 0)
    for (int fb = tid; fb < B; fb += kColThreads) {
      stats[2 * fb] = float_key(-INFINITY);
      stats[2 * fb + 1] = 0;
    }

  auto item = [&](int it) {
    const int rest = it / t.nstrips, bi = rest % t.nbands;
    const int p0 = bi * t.band;
    return ColItem{rest / t.nbands, p0, min(t.band, npairs - p0),
                   (it - rest * t.nstrips) * kStrip};
  };

  // the copies of item m's window and candidate into stage buf, one
  // commit group
  auto load = [&](const ColItem& m, float* buf) {
    const int32_t* cf = ci + (int64_t)m.fb * hp * wp;
    if (tid < 4) cp_async4(buf + window + tid, iparams + 4 * m.fb + tid);
    const int ns = m.nb + 2 * kColHalo - 1, nrows = 2 * m.nb + 4 * kColHalo - 1;
    // window row j, column c: its coefficient's bits
    auto src = [&](int j, int c) -> const void* {
      if (j >= ns)
        return cf + (int64_t)(n2 + clamp_pair(m.p0 - kColHalo + j - ns, n2)) *
                        wp + c;
      const int r = clamp_pair(m.p0 - kColHalo + 1 + j, n2);
      if (!deepest && c < half)
        return quad + (int64_t)m.fb * qframe + (int64_t)r * qstride + c;
      return cf + (int64_t)r * wp + c;
    };
    auto slot = [&](int j, int c) {
      return buf + (j < ns ? j : srows + j - ns) * kStrip + (c - m.c0);
    };
    if (kVec) {
      const int lv = lg - 2;  // 16-byte vectors a row: strip / 4
      for (int v = tid; v < nrows << lv; v += kColThreads) {
        const int j = v >> lv, c = m.c0 + ((v & ((1 << lv) - 1)) << 2);
        if (c >= ww) continue;
        if (j < ns && !deepest && c < half && c + 4 > half) {
          for (int e = 0; e < 4; ++e)  // astride the quadrant's edge
            cp_async4(slot(j, c + e), src(j, c + e));
        } else {
          cp_async16(slot(j, c), src(j, c));
        }
      }
    } else {
      for (int v = tid; v < nrows << lg; v += kColThreads) {
        const int j = v >> lg, c = m.c0 + (v & (kStrip - 1));
        if (c < ww) cp_async4(slot(j, c), src(j, c));
      }
    }
    cp_async_commit();
  };

  // this thread's share of item m's new coefficients, in place in buf:
  // column c0 + tx, a run of consecutive window rows of s, then of d
  auto compose = [&](const ColItem& m, float* buf) {
    const int c = m.c0 + tx;
    if (c >= ww) return;
    const bool right = c >= half;
    Candidate cand(reinterpret_cast<const int32_t*>(buf + window), hp,
                   nchunks, kMasked);
    const auto br = BandRec<kMasked>::of(cand);
    // rows k0.. in groups of kUnroll: the walk first, then the group's
    // independent reconstructions and divisions
    auto run = [&](float* col, int n, int lo, int r0, float wt) {
      const int per = (n + tys - 1) / tys, k0 = ty * per;
      const int k1 = min(n, k0 + per);
      if (k0 >= k1) return;
      cand.seek(r0 + clamp_pair(lo + k0, n2));
      int k = k0;
      for (; k + kUnroll <= k1; k += kUnroll) {
        int bits[kUnroll], drow[kUnroll];
        bool sg[kUnroll], rup[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          bits[u] = __float_as_int(col[(k + u) * kStrip]);
        if (r0 + clamp_pair(lo + k + kUnroll - 1, n2) < cand.next) {
          // the group's rows all lie in the current row's chunk
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            drow[u] = cand.d_row;
            sg[u] = cand.sig;
            rup[u] = cand.refine_up;
          }
        } else {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            cand.row(r0 + clamp_pair(lo + k + u, n2));
            drow[u] = cand.d_row;
            sg[u] = cand.sig;
            rup[u] = cand.refine_up;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          col[(k + u) * kStrip] =
              br.div(cand, bits[u], drow[u], sg[u], rup[u], wt);
      }
      for (; k < k1; ++k) {
        cand.row(r0 + clamp_pair(lo + k, n2));
        float* p = col + k * kStrip;
        *p = br.div(cand, __float_as_int(*p), cand.d_row, cand.sig,
                    cand.refine_up, wt);
      }
    };
    if (right || deepest)
      run(buf + tx, m.nb + 2 * kColHalo - 1, m.p0 - kColHalo + 1, 0,
          right ? wt_tr : wt_tl);
    run(buf + srows * kStrip + tx, m.nb + 2 * kColHalo, m.p0 - kColHalo, n2,
        right ? wt_br : wt_bl);
  };

  // this thread's runs of kRun pairs of item m, lifted and stored
  auto lift = [&](const ColItem& m, const float* buf) {
    const int c = m.c0 + tx;
    if (c >= ww) return;
    const float* s = buf + tx;
    const float* d = buf + srows * kStrip + tx;
    float* g = dst + (int64_t)m.fb * dframe + c;
    for (int k0 = ty * kRun; k0 < m.nb; k0 += tys * kRun) {
      float sw[kRun + 3], dw[kRun + 4], o[2 * kRun];
#pragma unroll
      for (int k = 0; k < kRun + 3; ++k) sw[k] = s[(k0 + k) * kStrip];
#pragma unroll
      for (int k = 0; k < kRun + 4; ++k) dw[k] = d[(k0 + k) * kStrip];
      const int i0 = m.p0 + k0;
      lift_run(sw, dw, i0, n2, o);
      float* gr = g + (int64_t)(2 * i0) * dstride;
      if (k0 + kRun <= m.nb && 2 * (i0 + kRun) <= hstore) {
#pragma unroll
        for (int j = 0; j < 2 * kRun; ++j) gr[j * dstride] = o[j];
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if (k0 + j < m.nb) {  // then 2 (i0 + j) < hstore
            gr[2 * j * dstride] = o[2 * j];
            if (2 * (i0 + j) + 1 < hstore)
              gr[(2 * j + 1) * dstride] = o[2 * j + 1];
          }
      }
    }
  };

  int it = blockIdx.x;
  if (it < items) load(item(it), col_sm);
  for (int k = 0; it < items; ++k, it += gridDim.x) {
    const ColItem m = item(it);
    float* cur = col_sm + (k & 1) * stage;
    cp_async_wait_all();
    // item it's window is in; every thread is past the item before, so
    // the other stage is free
    __syncthreads();
    if (it + (int)gridDim.x < items)
      load(item(it + gridDim.x), col_sm + (~k & 1) * stage);
    compose(m, cur);
    __syncthreads();
    lift(m, cur);
  }
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

uint64_t smem_cols[8] = {}, smem_rows[2] = {0, 0}, smem_tail[2] = {0, 0};

// the column pass's instantiations, by (vector form, 64-column strips,
// masked)
using ColKernel = decltype(&eval_lift_cols<true, 32, false>);
const ColKernel kColKernels[8] = {
    eval_lift_cols<false, 32, false>, eval_lift_cols<false, 32, true>,
    eval_lift_cols<false, 64, false>, eval_lift_cols<false, 64, true>,
    eval_lift_cols<true, 32, false>,  eval_lift_cols<true, 32, true>,
    eval_lift_cols<true, 64, false>,  eval_lift_cols<true, 64, true>};

// a plan's tile, checked against the level (ops/fused_eval.py col_plan);
// its shared memory (both stages) in *smem
bool tile_ok(const int32_t* p, int B, int hh, int ww, int hstore,
             int* smem) {
  const int strip = p[0], band = p[1], halo = p[2], nstrips = p[3],
            nbands = p[4], grid = p[5];
  const int npairs = (hstore + 1) / 2;
  if ((strip != 32 && strip != 64) || band < kRun || band % kRun ||
      halo != kColHalo || nstrips != (ww + strip - 1) / strip ||
      nbands != (npairs + band - 1) / band || grid < 1 ||
      (int64_t)grid > (int64_t)B * nstrips * nbands)
    return false;
  *smem = 2 * ((2 * band + 4 * kColHalo - 1) * strip + 4) *
          (int)sizeof(float);
  return *smem <= kMaxSmem;
}

}  // namespace

extern "C" {

// ci int32 [B, hp, wp]; ref, base_rec (resid only, else NULL) and
// tgt_field (per-point targets, else NULL) f32 [B, hp, wp]; iparams int32
// [B, 4] = (b, js, jr, dropmask); fparams f32 [B, 4] = (dc, lo, hi, tgt;
// tgt unread when tgt_field is given); weights: host array f32
// [max(levels, 1)][4], the (top-left, top-right, bottom-left,
// bottom-right) weights of the coefficients new at each level
// (ops/fused_eval.py level_weights); plan: host array int32
// [max(levels, 1)][6], each level's column-pass tile (strip, band, halo,
// nstrips, nbands, grid; ops/fused_eval.py col_plan); work f32 scratch of
// B * hp * wp + B * (hp / 2) * (wp / 2): the even levels lift in the
// first part as [B, hp, wp] frames, the odd levels in the second as
// [B, hp / 2, wp / 2] (a band pass never reads the buffer it writes);
// stats int32 [B, 2] = (float key of the max excess, violation count).
// kind: 0 base, 1 resid; mode: 0 trunc, 1 masked.  Returns the first
// launch error.
int ebcc_fused_eval(int device, const int32_t* ci, const float* ref,
                    const float* base_rec, const float* tgt_field,
                    const int32_t* iparams, const float* fparams,
                    const float* weights, const int32_t* plan, int B,
                    int hp, int wp, int levels, int nchunks, int h, int w,
                    int kind, int mode, float* work, int32_t* stats,
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
  for (int k = 0; k < 8; ++k)
    if ((e = allow_smem(kColKernels[k], kMaxSmem, smem_cols[k])) !=
        cudaSuccess)
      return (int)e;
  if ((e = allow_smem(eval_lift_rows<false>, kRowSmem, smem_rows[0])) !=
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
  // level i's buffer: its base, row stride and frame stride
  float* const bufs[2] = {work, work + (int64_t)B * hp * wp};
  const int strides[2] = {wp, wp / 2}, heights[2] = {hp, hp / 2};
  for (int i = levels - 1; i >= 0; --i) {
    const int hh = hp >> i, ww = wp >> i, hstore = i == 0 ? h : hh;
    const int* p = plan + 6 * i;
    int col_smem;
    if (!tile_ok(p, B, hh, ww, hstore, &col_smem) ||
        ww > kRowSmem / (int)sizeof(float))
      return (int)cudaErrorInvalidValue;
    const int o = i & 1, q = o ^ 1;
    const bool deepest = i == levels - 1;
    const float* quad = deepest ? nullptr : bufs[q];
    const bool col_vec = ww % 4 == 0 && wp % 4 == 0 && aligned16(ci) &&
                         (deepest || (strides[q] % 4 == 0 &&
                                      aligned16(quad)));
    const ColTile tile{p[1], p[3], p[4]};
    const float* wt = weights + 4 * i;
    const ColKernel cols =
        kColKernels[4 * col_vec + 2 * (p[0] == 64) + masked];
    cols<<<p[5], kColThreads, col_smem, stream>>>(
        ci, iparams, quad, bufs[o], stats, B, hp, wp, strides[q],
        (int64_t)heights[q] * strides[q], strides[o],
        (int64_t)heights[o] * strides[o], hh, ww, hstore, nchunks, deepest,
        tile, wt[0], wt[1], wt[2], wt[3]);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int rows = row_block_rows(ww);
    const dim3 block(kThreads / rows, rows);
    const int row_bytes = rows * ww * (int)sizeof(float);
    if (i > 0) {
      const dim3 grid((hh + rows - 1) / rows, B);
      if (row_vec(ww, strides[o], bufs[o]))
        eval_lift_rows<true><<<grid, block, row_bytes, stream>>>(
            bufs[o], heights[o], strides[o], hh, ww);
      else
        eval_lift_rows<false><<<grid, block, row_bytes, stream>>>(
            bufs[o], heights[o], strides[o], hh, ww);
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
