// Inverse CDF 9/7 lifting passes on a batch of f32 frames in device
// memory, for Hopper (sm_90a).  Shared by fused_eval.cu (the inverse
// transform inside each candidate evaluation) and idwt.cu (the standalone
// multi-level inverse DWT of every reconstruction).
//
// One 2-D synthesis level of the top-left hh x ww region of every
// [hp, wp] frame is a column pass then a row pass (dwt.h:218-224).  Two
// column designs live here:
//   lift_cols_block (idwt.cu's column pass): a block lifts a strip of
//                    kColStrip columns of the full height hh in shared
//                    memory (hh <= 1816), in five block-wide steps.  It
//                    takes each coefficient from a loader (raw 32-bit
//                    loads first): the top-left quadrant of every level
//                    but the deepest is what the level below left in the
//                    destination; every other coefficient is new at this
//                    level and the loader reads it, so each is produced
//                    exactly once, on load.
//   bands (fused_eval.cu's eval_lift_cols, which composes every new
//                    coefficient from the candidate): a persistent grid of
//                    kColThreads-thread CTAs walks (frame, strip, band)
//                    items, a strip 32 or 64 columns (128 or 256 bytes of a
//                    row) and a band a run of (s, d) pairs with a halo of
//                    kColHalo pairs on each side, recomputed.  An item's
//                    window is loaded with 16-byte cp.async copies
//                    (cp_async16) into one of two stages while the item
//                    before it is composed and lifted; each thread then
//                    lifts kRun pairs of one column in registers
//                    (lift_run, as the row pass does), so no sync falls
//                    between the lifting steps.  A band writes rows other
//                    bands read, so its output goes to another buffer than
//                    the quadrant it reads.  On an H100 80GB HBM3 at 700 W
//                    (chip_smoke.py, one base evaluation at 768x1472, L5)
//                    it moves 1717 GB/s at B=8 and 2106 GB/s at B=16,
//                    where the strip design moved about 900 and 1081-1090.
//   lift_rows_block: a block stages a few whole rows in shared memory
//                    (ww <= 24576) with one sync; then each thread lifts
//                    runs of kRun (s, d) pairs in registers from a window
//                    with a two-pair halo on each side (recomputed, so no
//                    sync between the lifting steps), and hands the kRun
//                    interleaved output pairs to an epilogue: a store, or
//                    fused_eval's tail.  In the vector form (n2 % 4 == 0,
//                    16-byte aligned rows) a run is one float4 of s and
//                    one of d, its halo comes from the neighbouring lanes
//                    by shuffle, and the interleaved store is two float4.
// Neither pass divides per element: rows and runs are walked by strides.
// Each including source wraps them in __global__ kernels of its own names
// (fused_eval.cu: eval_lift_cols / eval_lift_rows / eval_rows_tail,
// idwt.cu: idwt_lift_cols / idwt_lift_rows), so a profile tells the two
// libraries' passes apart.
//
// Arithmetic is the native codec's, site by site (ebcc_cpu_decoder.cc:
// 36-117): each lifting step is __fmaf_rn of the float32 sum and division
// by XI is a multiply by its f32 reciprocal; the boundary rules are the
// reference's (the GAMMA step's right neighbour mirrors to n2 - 2, the
// ALPHA step's clamps to n2 - 1).  Build with -fmad=false so nvcc
// contracts nothing else.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float ALPHA = -1.586134342f;
constexpr float BETA = -0.05298011854f;
constexpr float GAMMA = 0.8829110762f;
constexpr float DELTA = 0.44355068522f;
constexpr float XI = 1.149604398f;
constexpr float RECIP_XI = (float)(1.0 / (double)XI);

// columns per column-pass block (64 B of a row: two full sectors) and its
// thread rows; the strip of a 768-row level 0 takes 48 KB of shared
// memory, so 4 blocks share an SM and overlap their load and lift phases
constexpr int kColStrip = 16;
constexpr int kColRows = 16;
constexpr int kThreads = 256;
constexpr int kRowSmem = 96 * 1024;      // row pass: rows per block fill this
constexpr int kMaxSmem = 227 * 1024;     // opt-in limit of one block (H100)
constexpr int kRun = 4;                  // (s, d) pairs a row-pass thread lifts
constexpr unsigned kFull = 0xffffffffu;
// band column pass: threads of a CTA, CTAs resident on an SM, and (s, d)
// pairs of halo on each side of a band: lift_run's window reaches one s
// and two d pairs before its first pair and two of each past its last
// (ops/fused_eval.py COL_*)
constexpr int kColThreads = 256;
constexpr int kColCtasPerSm = 4;
constexpr int kColHalo = 2;

// ---------------------------------------------------------------------------
// column pass

// Inverse lifting along the columns of the top-left hh x ww region of one
// frame: block (kColStrip, kColRows) owns columns [c0, c0 + kColStrip).
// For row r of this thread's column c < ww, load.raw(r) is one 32-bit
// load and nothing else, so the first loop keeps many loads in flight;
// where Load::kCooks, load.cook(r, bits) then turns the bits into the
// coefficient, in shared memory, by the thread that loaded them (else the
// bits are the f32 coefficient).  Rows [0, hstore) of the result go to dst
// (the frame's base).
template <class Load>
__device__ __forceinline__ void lift_cols_block(Load& load, float* dst,
                                                int wp, int hh, int ww,
                                                int hstore) {
  extern __shared__ float sm[];  // [hh][kColStrip]
  int* smi = reinterpret_cast<int*>(sm);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kColStrip + tx;
#pragma unroll 8
  for (int r = ty; r < hh; r += kColRows)
    smi[r * kColStrip + tx] = c < ww ? load.raw(r) : 0;
  if (Load::kCooks && c < ww)
    for (int r = ty; r < hh; r += kColRows)
      sm[r * kColStrip + tx] = load.cook(r, smi[r * kColStrip + tx]);
  __syncthreads();
  const int n2 = hh / 2;
  float* s = sm;                       // rows [0, n2)
  float* d = sm + n2 * kColStrip;      // rows [n2, hh)
#define S(i) s[(i) * kColStrip + tx]
#define D(i) d[(i) * kColStrip + tx]
  for (int i = ty; i < n2; i += kColRows) {
    S(i) = S(i) * RECIP_XI;
    D(i) = D(i) * XI;
  }
  __syncthreads();
  for (int i = ty; i < n2; i += kColRows)
    S(i) = __fmaf_rn(-DELTA, D(i) + D(i == 0 ? 1 : i - 1), S(i));
  __syncthreads();
  for (int i = ty; i < n2; i += kColRows)
    D(i) = __fmaf_rn(-GAMMA, S(i) + S(i + 1 < n2 ? i + 1 : n2 - 2), D(i));
  __syncthreads();
  for (int i = ty; i < n2; i += kColRows)
    S(i) = __fmaf_rn(-BETA, D(i) + D(i == 0 ? 1 : i - 1), S(i));
  __syncthreads();
  for (int i = ty; i < n2; i += kColRows)
    D(i) = __fmaf_rn(-ALPHA, S(i) + S(i + 1 < n2 ? i + 1 : n2 - 1), D(i));
  __syncthreads();
  if (c < ww)
    for (int r = ty; r < hstore; r += kColRows)
      dst[(int64_t)r * wp + c] = (r & 1) ? D(r >> 1) : S(r >> 1);
#undef S
#undef D
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory (the band column pass's stages)

// 16 bytes (both addresses 16-byte aligned), cached in L2 only
__device__ __forceinline__ void cp_async16(float* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// 4 bytes
__device__ __forceinline__ void cp_async4(float* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// close the group of copies this thread issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until every copy this thread issued has landed (its own only: a
// __syncthreads after it makes the whole block's copies visible)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// row pass

// rows per row-pass block at width ww: 8, halved until they fit kRowSmem;
// the block is (kThreads / rows, rows) threads
__host__ inline int row_block_rows(int ww) {
  int rows = 8;
  while (rows > 1 && rows * ww * (int)sizeof(float) > kRowSmem) rows >>= 1;
  return rows;
}

__device__ __forceinline__ int clamp_pair(int i, int n2) {
  return min(max(i, 0), n2 - 1);
}

// One run: the kRun output pairs [i0, i0 + kRun) of a row of n2 pairs from
// the window sw[k] = s[i0 + k - 1] (k < kRun + 3) and dw[k] = d[i0 + k - 2]
// (k < kRun + 4) of the row's [s | d] halves.  Entries past the row are
// don't-cares: an output pair < n2 never depends on them, because each
// step takes the boundary rule where the reference does.  Writes
// o[2j] = even sample, o[2j + 1] = odd sample of pair i0 + j.
__device__ __forceinline__ void lift_run(float (&sw)[kRun + 3],
                                         float (&dw)[kRun + 4], int i0,
                                         int n2, float (&o)[2 * kRun]) {
#pragma unroll
  for (int k = 0; k < kRun + 3; ++k) sw[k] = sw[k] * RECIP_XI;
#pragma unroll
  for (int k = 0; k < kRun + 4; ++k) dw[k] = dw[k] * XI;
  // s at pair i0 + k - 1: d[i - 1] reflects to d[1] at i == 0
#pragma unroll
  for (int k = 0; k < kRun + 3; ++k) {
    float prev = dw[k];
    if (k == 1 && i0 == 0) prev = dw[3];
    sw[k] = __fmaf_rn(-DELTA, dw[k + 1] + prev, sw[k]);
  }
  // d at pair i0 + k - 2: s[i + 1] mirrors to s[n2 - 2] at i == n2 - 1
#pragma unroll
  for (int k = 1; k < kRun + 3; ++k) {
    float next = sw[k];
    if (k >= 2 && i0 + k - 1 >= n2) next = sw[k >= 2 ? k - 2 : 0];
    dw[k] = __fmaf_rn(-GAMMA, sw[k - 1] + next, dw[k]);
  }
  // s at pair i0 + k - 1: d[i - 1] reflects to d[1] at i == 0
#pragma unroll
  for (int k = 1; k < kRun + 2; ++k) {
    float prev = dw[k];
    if (k == 1 && i0 == 0) prev = dw[3];
    sw[k] = __fmaf_rn(-BETA, dw[k + 1] + prev, sw[k]);
  }
  // d at pair i0 + k - 2: s[i + 1] clamps to s[n2 - 1] at i == n2 - 1
#pragma unroll
  for (int k = 2; k < kRun + 2; ++k) {
    const float next = i0 + k - 1 < n2 ? sw[k] : sw[k - 1];
    dw[k] = __fmaf_rn(-ALPHA, sw[k - 1] + next, dw[k]);
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    o[2 * j] = sw[j + 1];
    o[2 * j + 1] = dw[j + 2];
  }
}

// Inverse lifting along rows: block (kThreads / rows, rows) owns rows
// [r0, r0 + rows) of one frame (src: the frame's base), of which rows
// < nrows are lifted; each lifted row's pairs [0, npairs) go to
// out(row, i0, o) one run at a time (i0 a multiple of kRun; o as lift_run
// writes it; pairs past n2 are the epilogue's to skip).  kVec: n2 % 4 ==
// 0, wp % 4 == 0 and src 16-byte aligned.
template <bool kVec, class Out>
__device__ __forceinline__ void lift_rows_block(const float* src, int wp,
                                                int ww, int nrows,
                                                int npairs, Out& out) {
  extern __shared__ float sm[];  // [rows][ww]
  const int tx = threadIdx.x, ty = threadIdx.y, tw = blockDim.x;
  const int row = blockIdx.x * blockDim.y + ty;
  const int n2 = ww / 2;
  float* s = sm + ty * ww;
  const float* d = s + n2;
  const bool live = row < nrows;  // uniform across each warp (tw >= 32)
  if (live) {
    const float* g = src + (int64_t)row * wp;
    if (kVec) {
      for (int k = tx; k < ww / 4; k += tw)
        reinterpret_cast<float4*>(s)[k] =
            reinterpret_cast<const float4*>(g)[k];
    } else {
      for (int k = tx; k < ww; k += tw) s[k] = g[k];
    }
  }
  __syncthreads();
  if (!live) return;
  const int lane = tx & 31;
  for (int base = 0; base < npairs; base += kRun * tw) {
    const int i0 = base + kRun * tx;
    float sw[kRun + 3], dw[kRun + 4];
    if (kVec) {
      // own pairs as float4; the halo from the neighbouring lanes, and
      // from shared memory at the warp's two ends
      const int ic = min(i0, n2 - kRun);
      const float4 sv = *reinterpret_cast<const float4*>(s + ic);
      const float4 dv = *reinterpret_cast<const float4*>(d + ic);
      sw[1] = sv.x; sw[2] = sv.y; sw[3] = sv.z; sw[4] = sv.w;
      dw[2] = dv.x; dw[3] = dv.y; dw[4] = dv.z; dw[5] = dv.w;
      sw[0] = __shfl_up_sync(kFull, sv.w, 1);
      dw[0] = __shfl_up_sync(kFull, dv.z, 1);
      dw[1] = __shfl_up_sync(kFull, dv.w, 1);
      sw[5] = __shfl_down_sync(kFull, sv.x, 1);
      sw[6] = __shfl_down_sync(kFull, sv.y, 1);
      dw[6] = __shfl_down_sync(kFull, dv.x, 1);
      dw[7] = __shfl_down_sync(kFull, dv.y, 1);
      if (lane == 0) {
        sw[0] = s[clamp_pair(i0 - 1, n2)];
        dw[0] = d[clamp_pair(i0 - 2, n2)];
        dw[1] = d[clamp_pair(i0 - 1, n2)];
      } else if (lane == 31) {
        sw[5] = s[clamp_pair(i0 + kRun, n2)];
        sw[6] = s[clamp_pair(i0 + kRun + 1, n2)];
        dw[6] = d[clamp_pair(i0 + kRun, n2)];
        dw[7] = d[clamp_pair(i0 + kRun + 1, n2)];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRun + 3; ++k) sw[k] = s[clamp_pair(i0 + k - 1, n2)];
#pragma unroll
      for (int k = 0; k < kRun + 4; ++k) dw[k] = d[clamp_pair(i0 + k - 2, n2)];
    }
    float o[2 * kRun];
    lift_run(sw, dw, i0, n2, o);
    out.template run<kVec>(row, i0, o);
  }
}

// row-pass epilogue of a level above the last: the interleaved pairs back
// into the row, in place (dst: the frame's base)
struct StoreRun {
  float* dst;
  int wp, n2;
  template <bool kVec>
  __device__ __forceinline__ void run(int row, int i0,
                                      const float (&o)[2 * kRun]) const {
    float* g = dst + (int64_t)row * wp + 2 * i0;
    if (kVec) {
      if (i0 < n2) {
        reinterpret_cast<float4*>(g)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(g)[1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (i0 + j < n2) {
          g[2 * j] = o[2 * j];
          g[2 * j + 1] = o[2 * j + 1];
        }
    }
  }
};

// ---------------------------------------------------------------------------
// launch setup

// Opt a kernel into `bytes` of dynamic shared memory (the most any of its
// launches takes: kMaxSmem for a column pass, kRowSmem for a row pass,
// which also has static shared memory), once per device; the attribute
// only raises the ceiling, a launch's own size still sets its occupancy.
template <class Kernel>
cudaError_t allow_smem(Kernel* fn, int bytes, uint64_t& done) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

__host__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// the vector form of the row pass at width ww (see lift_rows_block)
__host__ inline bool row_vec(int ww, int wp, const void* p) {
  return (ww / 2) % 4 == 0 && wp % 4 == 0 && aligned16(p);
}

}  // namespace
