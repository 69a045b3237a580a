// Bitplane stream packer, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package packs its streams with the
// native host coder (native/ebcc_coder.cc), as bit-serial packing suits
// the TPU badly.  On the card it is ballots and popcounts, and packing
// there keeps every coefficient plane on the device: only the packed
// prefix of each stream crosses to the host.
//
// Output: a zero-filled uint8 arena [B, cap] whose first ceil(bits / 8)
// bytes, for any bits <= trunc[f], are native's coder_encode_batch arena
// byte for byte.  The stream (native/ebcc_coder.cc:1-8, MSB-first) per
// bitplane b from high to low:
//   group levels G..1, row-major: emit par_ok & smax[k] <= b, bit
//     smax[k] == b (par_ok: max_step >= b at level G, else the parent's
//     smax[k + 1] >= b);
//   per stripe j: significance (emit smax[1] at (r/2, c/2) >= b &
//     msb <= b, bit msb == b), then signs (emit msb == b, bit neg);
//   per stripe j: refinement (emit msb > b, bit (mag >> b) & 1).
// Stripe j holds rows [ceil(j H / J), ceil((j + 1) H / J)).
//
// Why it parallelises: the stream is embedded, and within a pass which
// cells emit depends only on the closed-form analysis, not on what earlier
// passes emitted.  The per-(plane, segment) bit counts the truncation
// search already has (segment_counts, K2) give each segment's start by an
// exclusive sum, so every (frame, plane, segment) is packed at once.
//
// What bounds it here: the walk.  A CTA per (frame, plane, segment) walks
// its segment's cells in row-major order, 4 x 256 a round: a warp ballot
// of the emitting cells, each emitting lane's slot a popcount below it,
// the warp's bits compacted MSB-first with __reduce_or_sync; one shared
// exclusive scan of the 32 warp counts of the round gives each warp its
// stream offset (a running offset carries across rounds).  A warp's bits
// are contiguous in the stream, so it changes at most two 32-bit words,
// written with atomicOr; each bit is written once, so the result does not
// depend on the order.  A CTA whose segment starts at or past trunc[f]
// returns at once, and a walk stops at trunc[f], so only the coded top
// planes do work.  Reads are int32 coefficients (msb, sign and magnitude
// from one load) and the smax pyramid the analysis already holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // cells a thread takes a round
static_assert(kUnroll * kWarps == 32, "one lane a warp count in the scan");
constexpr int kMaxLevels = 16;
constexpr unsigned kFull = 0xffffffffu;

// smax[k] int32 [B, H >> k, W >> k] for k = 1..G (index 0 unused): a
// kernel parameter, so a CUDA graph captures the pointers by value
struct Pyramid {
  const int32_t* smax[kMaxLevels + 1];
};

__device__ __forceinline__ int msb_of(int32_t v) {
  const uint32_t m = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  return 31 - __clz(m);  // __clz(0) == 32: -1 for a zero
}

// OR `count` bits of v (first bit at its MSB) into the MSB-first stream of
// 32-bit words at stream bit `pos`, dropping bits at or past `limit`.
// Stream bit p is bit 7 - (p & 7) of byte p >> 3: a word is stored with
// its bytes swapped.
__device__ __forceinline__ void put_bits(uint32_t* words, int64_t pos,
                                         uint32_t v, int count,
                                         int64_t limit) {
  if (pos >= limit || count == 0) return;
  const int64_t room = limit - pos;
  if (room < count) v &= ~(kFull >> (int)room);
  const int64_t q = pos >> 5;
  const int sh = (int)(pos & 31);
  const uint32_t w0 = v >> sh;
  const uint32_t w1 = sh ? v << (32 - sh) : 0u;
  if (w0) atomicOr(words + q, __byte_perm(w0, 0, 0x0123));
  if (w1) atomicOr(words + q + 1, __byte_perm(w1, 0, 0x0123));
}

// grid (S, P, B): segment s of plane row q (plane b = P - 1 - q) of frame
// f.  counts int64 [B, P, S]; out uint8 [B, cap_bytes] zero-filled,
// cap_bytes a multiple of 4.
__global__ void __launch_bounds__(kThreads)
pack_segments(const int32_t* __restrict__ coef, Pyramid pyr,
              const int32_t* __restrict__ max_step,
              const int64_t* __restrict__ counts,
              const int64_t* __restrict__ trunc, int H, int W, int G, int P,
              int J, uint8_t* __restrict__ out, int64_t cap_bytes) {
  const int S = G + 3 * J;
  const int s = blockIdx.x, q = blockIdx.y, f = blockIdx.z;
  const int b = P - 1 - q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int64_t red[kWarps];
  __shared__ int cnt[2][32];

  // the segment's start: the bits of every earlier (plane, segment)
  const int64_t* row = counts + (int64_t)f * P * S;
  const int e = q * S + s;
  int64_t acc = 0;
  for (int i = tid; i < e; i += kThreads) acc += row[i];
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  int64_t start = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) start += red[w];
  const int64_t n = row[e];
  int64_t limit = trunc[f];
  if (limit > cap_bytes * 8) limit = cap_bytes * 8;
  if (n <= 0 || start >= limit) return;
  const int64_t end = start + n < limit ? start + n : limit;
  uint32_t* words = reinterpret_cast<uint32_t*>(out + (int64_t)f * cap_bytes);

  // the segment's cells: a row-major grid of `width` columns at `cells`
  int kind;  // 0 group level, 1 significance, 2 sign, 3 refinement
  int k = 0, width, r0 = 0;
  uint32_t ncell;
  const int32_t* cells;
  const int32_t* parent = nullptr;  // smax one level up
  bool top_ok = false;              // level G: max_step >= b
  if (s < G) {
    kind = 0;
    k = G - s;
    const int hk = H >> k;
    width = W >> k;
    ncell = (uint32_t)hk * (uint32_t)width;
    cells = pyr.smax[k] + (int64_t)f * hk * width;
    if (k == G)
      top_ok = max_step[f] >= b;
    else
      parent = pyr.smax[k + 1] + (int64_t)f * (hk >> 1) * (width >> 1);
  } else {
    const int t = s - G;
    int j;
    if (t < 2 * J) {
      j = t >> 1;
      kind = 1 + (t & 1);
    } else {
      j = t - 2 * J;
      kind = 3;
    }
    r0 = (j * H + J - 1) / J;
    const int r1 = ((j + 1) * H + J - 1) / J;
    width = W;
    ncell = (uint32_t)(r1 - r0) * (uint32_t)W;
    cells = coef + ((int64_t)f * H + r0) * W;
    if (kind == 1) parent = pyr.smax[1] + (int64_t)f * (H >> 1) * (W >> 1);
  }
  const int pw = width >> 1;  // the parent grid's width

  int64_t off = start;
  int buf = 0;
  for (uint32_t base = 0; base < ncell && off < end;
       base += kThreads * kUnroll) {
    uint32_t emit[kUnroll], ones[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = base + u * kThreads + tid;
      bool em = false, bit = false;
      if (i < ncell) {
        const int32_t v = __ldg(cells + i);
        if (kind == 0) {
          bool par = top_ok;
          if (parent) {
            const uint32_t r = i / (uint32_t)width, c = i - r * width;
            par = __ldg(parent + (r >> 1) * pw + (c >> 1)) >= b;
          }
          em = par && v <= b;
          bit = v == b;
        } else {
          const int m = msb_of(v);
          if (kind == 1) {
            const uint32_t r = i / (uint32_t)width, c = i - r * width;
            const uint32_t pr = (r0 + r) >> 1;
            em = m <= b && __ldg(parent + pr * pw + (c >> 1)) >= b;
            bit = m == b;
          } else if (kind == 2) {
            em = m == b;
            bit = v < 0;
          } else {
            em = m > b;
            const uint32_t mag = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
            bit = (mag >> b) & 1u;
          }
        }
      }
      emit[u] = __ballot_sync(kFull, em);
      ones[u] = __ballot_sync(kFull, em && bit);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        cnt[buf][u * kWarps + warp] = __popc(emit[u]);
    }
    __syncthreads();
    // warp counts in stream order (round u, warp w) -> exclusive offsets
    const int c = cnt[buf][lane];
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int excl = incl - c;
    const uint32_t below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int nb = __popc(emit[u]);
      const int pre = __shfl_sync(kFull, excl, u * kWarps + warp);
      if (nb == 0) continue;  // warp-uniform
      const int slot = __popc(emit[u] & below);
      const uint32_t mine =
          (ones[u] >> lane) & 1u ? 0x80000000u >> slot : 0u;
      const uint32_t v = __reduce_or_sync(kFull, mine);
      if (lane == 0) put_bits(words, off + pre, v, nb, end);
    }
    off += total;
    buf ^= 1;
  }
}

}  // namespace

extern "C" {

// coef int32 [B, H, W]; smax_ptrs: G host-side device pointers, smax[k]
// int32 [B, H >> k, W >> k] for k = 1..G; max_step int32 [B]; counts
// int64 [B, P, G + 3J]; trunc int64 [B]; out uint8 [B, cap_bytes],
// zero-filled by the caller, cap_bytes a multiple of 4.  One launch, no
// scratch.  Returns cudaGetLastError().
int ebcc_pack_streams(int device, const int32_t* coef,
                      const int64_t* smax_ptrs, const int32_t* max_step,
                      const int64_t* counts, const int64_t* trunc, int B,
                      int H, int W, int G, int P, int J, uint8_t* out,
                      int64_t cap_bytes, cudaStream_t stream) {
  if (B < 1 || B > 65535 || G < 1 || G > kMaxLevels || P < 1 ||
      P > 31 || J < 1 || H < 2 || W < 2 || (H >> G) < 1 || (W >> G) < 1 ||
      H % (1 << G) || W % (1 << G) || (int64_t)H * W >= (1ll << 31) ||
      cap_bytes < 4 || cap_bytes % 4 || G + 3 * J > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Pyramid pyr = {};
  for (int k = 1; k <= G; ++k)
    pyr.smax[k] = reinterpret_cast<const int32_t*>(smax_ptrs[k - 1]);
  pack_segments<<<dim3(G + 3 * J, P, B), kThreads, 0, stream>>>(
      coef, pyr, max_step, counts, trunc, H, W, G, P, J, out, cap_bytes);
  return (int)cudaGetLastError();
}

const char* ebcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
