// Inverse CDF 9/7 lifting passes on a batch of f32 frames in device
// memory, for Hopper (sm_90a).  Shared by fused_eval.cu (the inverse
// transform inside each candidate evaluation) and idwt.cu (the standalone
// multi-level inverse DWT of every reconstruction).
//
// One 2-D synthesis level of the top-left hh x ww region of every
// [hp, wp] frame is a column pass then a row pass (dwt.h:218-224):
//   lift_cols_block: a block lifts a strip of kColStrip columns of the
//                    full height hh in shared memory (hh <= 1816);
//   lift_rows_block: a block lifts a few whole rows in shared memory
//                    (ww <= 24576).
// They are the bodies of the passes; each including source wraps them in
// __global__ kernels of its own names (fused_eval.cu: eval_lift_cols /
// eval_lift_rows, idwt.cu: idwt_lift_cols / idwt_lift_rows), so a profile
// tells the two libraries' passes apart, and hands those to
// inverse_levels.
//
// Arithmetic is the native codec's, site by site (ebcc_cpu_decoder.cc:
// 36-117): each lifting step is __fmaf_rn of the float32 sum and division
// by XI is a multiply by its f32 reciprocal.  Build with -fmad=false so
// nvcc contracts nothing else.

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

constexpr int kColStrip = 32;            // columns per column-pass block
constexpr int kColRows = 8;              // thread rows per column-pass block
constexpr int kThreads = 256;
constexpr int kRowSmem = 96 * 1024;      // row pass: rows per block fill this
constexpr int kMaxSmem = 227 * 1024;     // opt-in limit of one block (H100)

// inverse lifting along columns of the top-left hh x ww region: block
// (kColStrip, kColRows) owns columns [c0, c0 + kColStrip) of one frame
__device__ __forceinline__ void lift_cols_block(float* __restrict__ work,
                                                int hp, int wp, int hh,
                                                int ww) {
  extern __shared__ float sm[];  // [hh][kColStrip]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kColStrip + tx;
  float* x = work + (int64_t)blockIdx.y * hp * wp;
  for (int r = ty; r < hh; r += kColRows)
    sm[r * kColStrip + tx] = c < ww ? x[(int64_t)r * wp + c] : 0.0f;
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
    for (int r = ty; r < hh; r += kColRows)
      x[(int64_t)r * wp + c] = (r & 1) ? D(r >> 1) : S(r >> 1);
#undef S
#undef D
}

// inverse lifting along rows: a block owns rows [r0, r0 + rows) of the
// top-left hh x ww region of one frame
__device__ __forceinline__ void lift_rows_block(float* __restrict__ work,
                                                int hp, int wp, int hh,
                                                int ww, int rows) {
  extern __shared__ float sm[];  // [rows][ww]
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, hh - r0);
  float* x = work + (int64_t)blockIdx.y * hp * wp + (int64_t)r0 * wp;
  for (int k = threadIdx.x; k < nr * ww; k += kThreads) {
    const int rr = k / ww, c = k - rr * ww;
    sm[k] = x[(int64_t)rr * wp + c];
  }
  __syncthreads();
  const int n2 = ww / 2;
  const int m = nr * n2;
#define ROW(k) float* s = sm + ((k) / n2) * ww; float* d = s + n2; \
               const int i = (k) % n2;
  for (int k = threadIdx.x; k < m; k += kThreads) {
    ROW(k)
    s[i] = s[i] * RECIP_XI;
    d[i] = d[i] * XI;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m; k += kThreads) {
    ROW(k)
    s[i] = __fmaf_rn(-DELTA, d[i] + d[i == 0 ? 1 : i - 1], s[i]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m; k += kThreads) {
    ROW(k)
    d[i] = __fmaf_rn(-GAMMA, s[i] + s[i + 1 < n2 ? i + 1 : n2 - 2], d[i]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m; k += kThreads) {
    ROW(k)
    s[i] = __fmaf_rn(-BETA, d[i] + d[i == 0 ? 1 : i - 1], s[i]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < m; k += kThreads) {
    ROW(k)
    d[i] = __fmaf_rn(-ALPHA, s[i] + s[i + 1 < n2 ? i + 1 : n2 - 1], d[i]);
  }
  __syncthreads();
#undef ROW
  for (int k = threadIdx.x; k < nr * ww; k += kThreads) {
    const int rr = k / ww, c = k - rr * ww;
    const float* s = sm + rr * ww;
    x[(int64_t)rr * wp + c] = (c & 1) ? s[n2 + (c >> 1)] : s[c >> 1];
  }
}

// the __global__ wrappers of lift_cols_block and lift_rows_block
using LiftCols = void (*)(float*, int, int, int, int);
using LiftRows = void (*)(float*, int, int, int, int, int);

// the inverse levels L-1..0 of B frames [hp, wp] in place on `stream`:
// per level a column pass and a row pass.  Returns the first launch error.
cudaError_t inverse_levels(LiftCols lift_cols, LiftRows lift_rows,
                           float* work, int B, int hp, int wp, int levels,
                           cudaStream_t stream) {
  cudaError_t e;
  for (int i = levels - 1; i >= 0; --i) {
    const int hh = hp >> i, ww = wp >> i;
    const int col_bytes = hh * kColStrip * (int)sizeof(float);
    const int rows = min(64, kRowSmem / (ww * (int)sizeof(float)));
    if (col_bytes > kMaxSmem || rows < 1) return cudaErrorInvalidValue;
    cudaFuncSetAttribute(lift_cols,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         col_bytes);
    lift_cols<<<dim3((ww + kColStrip - 1) / kColStrip, B),
                dim3(kColStrip, kColRows), col_bytes, stream>>>(
        work, hp, wp, hh, ww);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int row_bytes = rows * ww * (int)sizeof(float);
    cudaFuncSetAttribute(lift_rows,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         row_bytes);
    lift_rows<<<dim3((hh + rows - 1) / rows, B), kThreads, row_bytes,
                stream>>>(work, hp, wp, hh, ww, rows);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
