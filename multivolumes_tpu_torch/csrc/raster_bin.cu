// The binned-raster eval kernel (B6).
//
// Replaces the Pallas kernel of tools/raster_bin_microbench.py (the
// pallas_call at line 172, kernel body at lines 138-164): the eval
// primitive of a per-tile binning rasterizer, measured by
// multivolumes_tpu_torch/tools/raster_bin_microbench.py against the
// scatter-min raster it would replace.
//
// What it computes (ops/raster_bin.py has the full statement). Chunk i
// holds 128 triangle candidates for one 8 x 128 pixel tile. Per
// candidate, rows 0-8 of coef[:, i * 128 + cand] are three affine
// functions of the pixel centre (barycentrics c1, c2, depth z) and row 9
// is the triangle id. A candidate covers a pixel when
// min(c1, c2, 1 - c1 - c2) >= 0 and 0 <= z <= 1, and then offers
// (clip(z * 32767, 0, 32767) << 17) | tid, else 0x7FFFFFFF. The output
// is the signed minimum over the candidates and over every chunk that
// maps to the same tile.
//
// What bounds it on the card: operations, some 25 per (pixel, candidate)
// pair (three affines of two multiplies and two adds, the inside test,
// the quantise-and-pack, the minimum) over 600 x 1024 x 128 pairs in the
// microbench, against 40 bytes of coefficients per candidate read once
// and 4 bytes written per pixel. Most are adds, compares and selects,
// which run at one a lane a clock (the f32 peak counts an FMA as two).
// A thread that holds 4 pixels of one column and reads each candidate's
// 10 coefficients as scalars runs about 28 instructions a pair.
//
// Design. A CTA per chunk (and per kCtaRows rows of its tile): kSplit
// groups of threads, each folding its share of the candidates, each
// thread holding kPx columns (neighbouring threads neighbouring columns)
// x kPy rows of pixels and their minima in registers; the groups' minima
// meet in shared memory. The CTA stages the chunk's coefficients in
// shared memory as [candidate][12] (the triangle id converted to an int
// once), so a thread reads a candidate with three broadcast loads. Per
// candidate a thread forms the kPx products xg * cx and the kPy products
// yg * cy of each affine once and shares them over its pixels; per pair
// it is then two adds per affine. Three identities take the rest out of
// the per-pair work, each exact for every input:
//   * c0 = (1 - c1) - c2 >= 0 is tested as (1 - c1) >= c2. Where c1 >= 0
//     and c2 >= 0 hold (both tests are part of the cover test), a
//     difference of two floats rounds to a negative value exactly when
//     it is negative (gradual underflow: a non-zero difference is at
//     least the least subnormal), and the infinite cases fail both forms.
//   * Where the pair covers the pixel, 0 <= z <= 1, so z * 32767 lies in
//     [0, 32767] and both clamps are identities. __fadd_rz(v, 2^23) holds
//     2^23 + trunc(v) exactly (the ulp there is 1), and shifting its bits
//     left by 17 drops the exponent: the result is trunc(v) << 17, with
//     the same wrap into the sign bit. One full-rate add in place of two
//     min / max and a conversion on the slow pipe. A pair that does not
//     cover the pixel offers 0x7FFFFFFF either way.
//   * Where every triangle id of the chunk lies in [0, 2^17) (decided
//     once per CTA), the shifted depth and the id share no bit, so
//     (zq << 17) | tid is one multiply-add.
// tests/test_torch_raster_bin.py holds the first two identities in numpy.
// One atomicMin per pixel folds the chunk into the output, which the
// wrapper pre-fills with 0x7FFFFFFF. The TPU kernel's `first` flag and
// its revisited output block exist because its grid runs in order on one
// core; here the CTAs run in any order and the minimum is associative, so
// the atomics give the same result.
//
// Numerics. The inside test is a sign test at triangle edges, so each
// affine is written with the round-to-nearest intrinsics, which nvcc
// never contracts into an FMA, in the plain version's order
// (xg * cx + yg * cy + ck, left to right). The shift of the 15-bit depth
// by 17 wraps into the sign bit for z >= 0.5, as the Pallas kernel's
// int32 shift does.

#include <cuda_runtime.h>

namespace {

constexpr int kCand = 128;
constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kRows = 10;                 // coefficient rows read
constexpr int kSlot = 12;                 // floats a staged candidate takes
constexpr int kPx = 4;                    // columns a thread holds
constexpr int kPy = 4;                    // rows a thread holds
constexpr int kCtaRows = 4;               // tile rows a CTA covers
constexpr int kSplit = 2;                 // thread groups a candidate list
                                          // is split over
constexpr int kColThreads = kTileW / kPx;
constexpr int kGroupThreads = kColThreads * (kCtaRows / kPy);
constexpr int kThreads = kGroupThreads * kSplit;
constexpr int kGroupCand = kCand / kSplit;  // candidates a group folds
constexpr int kEmpty = 0x7FFFFFFF;
static_assert(kTileH % kCtaRows == 0 && kCtaRows % kPy == 0, "row split");

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Fold the chunk's candidates into the thread's kPy x kPx minima. With
// kNarrow (every triangle id of the chunk in [0, 2^17)) the depth bits and
// the id do not overlap, so (zq << 17) | tid is one multiply-add.
template <bool kNarrow>
__device__ __forceinline__ void eval_candidates(const float4* __restrict__ s4,
                                                const float* xg,
                                                const float* yg,
                                                int (*best)[kPx]) {
#pragma unroll 4
  for (int c = 0; c < kGroupCand; ++c) {
    // a0 a1 a2 b0 | b1 b2 z0 z1 | z2 tid - -
    const float4 p = s4[c * 3], q = s4[c * 3 + 1], s = s4[c * 3 + 2];
    const unsigned tid = (unsigned)__float_as_int(s.y);
    float xa[kPx], xb[kPx], xz[kPx], ya[kPy], yb[kPy], yz[kPy];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      xa[j] = mul(xg[j], p.x);
      xb[j] = mul(xg[j], p.w);
      xz[j] = mul(xg[j], q.z);
    }
#pragma unroll
    for (int j = 0; j < kPy; ++j) {
      ya[j] = mul(yg[j], p.y);
      yb[j] = mul(yg[j], q.x);
      yz[j] = mul(yg[j], q.w);
    }
#pragma unroll
    for (int a = 0; a < kPy; ++a) {
#pragma unroll
      for (int b = 0; b < kPx; ++b) {
        const float c1 = add(add(xa[b], ya[a]), p.z);
        const float c2 = add(add(xb[b], yb[a]), q.y);
        const float z = add(add(xz[b], yz[a]), s.x);
        const bool ok = c1 >= 0.0f && c2 >= 0.0f &&
                        __fsub_rn(1.0f, c1) >= c2 && z >= 0.0f && z <= 1.0f;
        const unsigned zq =
            __float_as_uint(__fadd_rz(mul(z, 32767.0f), 8388608.0f));
        const int word =
            (int)(kNarrow ? zq * 131072u + tid : (zq << 17) | tid);
        best[a][b] = ok ? min(best[a][b], word) : best[a][b];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
raster_bin_eval_kernel(const int* __restrict__ tile_of_chunk,
                       const float* __restrict__ x0,
                       const float* __restrict__ y0,
                       const float* __restrict__ coef, int* __restrict__ out,
                       int n_tiles, int coef_stride) {
  __shared__ __align__(16) float sc[kCand * kSlot];
  const int i = blockIdx.x;
  const int tile = tile_of_chunk[i];
  if (tile < 0 || tile >= n_tiles) return;  // never write outside `out`
  const float* ci = coef + (size_t)i * kCand;
  bool narrow = true;
  for (int k = threadIdx.x; k < kRows * kCand; k += kThreads) {
    const int r = k / kCand, c = k - r * kCand;
    float v = ci[(size_t)r * coef_stride + c];
    if (r == kRows - 1) {
      const int tid = (int)v;
      narrow = narrow && (unsigned)tid < (1u << 17);
      v = __int_as_float(tid);
    }
    sc[c * kSlot + r] = v;
  }
  narrow = __syncthreads_and(narrow);

  // the thread's group (its share of the candidates) and pixels
  const int g = threadIdx.x / kGroupThreads, gt = threadIdx.x % kGroupThreads;
  const int cx = gt % kColThreads;
  const int ry = blockIdx.y * kCtaRows + gt / kColThreads * kPy;
  float xg[kPx], yg[kPy];
#pragma unroll
  for (int j = 0; j < kPx; ++j)
    xg[j] = add(add((float)(cx + j * kColThreads), x0[i]), 0.5f);
#pragma unroll
  for (int j = 0; j < kPy; ++j)
    yg[j] = add(add((float)(ry + j), y0[i]), 0.5f);
  int best[kPy][kPx];
#pragma unroll
  for (int a = 0; a < kPy; ++a)
#pragma unroll
    for (int b = 0; b < kPx; ++b) best[a][b] = kEmpty;

  const float4* s4 = reinterpret_cast<const float4*>(sc) + g * kGroupCand * 3;
  if (narrow)
    eval_candidates<true>(s4, xg, yg, best);
  else
    eval_candidates<false>(s4, xg, yg, best);
  if (kSplit > 1) {
    // the other groups' minima, folded by the first group
    __shared__ int red[kSplit][kPy][kPx][kGroupThreads];
#pragma unroll
    for (int a = 0; a < kPy; ++a)
#pragma unroll
      for (int b = 0; b < kPx; ++b) red[g][a][b][gt] = best[a][b];
    __syncthreads();
    if (g > 0) return;
    for (int o = 1; o < kSplit; ++o)
#pragma unroll
      for (int a = 0; a < kPy; ++a)
#pragma unroll
        for (int b = 0; b < kPx; ++b)
          best[a][b] = min(best[a][b], red[o][a][b][gt]);
  }
#pragma unroll
  for (int a = 0; a < kPy; ++a)
#pragma unroll
    for (int b = 0; b < kPx; ++b)
      if (best[a][b] != kEmpty)
        atomicMin(&out[(tile * kTileH + ry + a) * kTileW + cx +
                       b * kColThreads],
                  best[a][b]);
}

}  // namespace

// tile_of_chunk (chunks,) i32; x0, y0 (chunks,) f32; coef (>= 10,
// coef_stride) f32 with coef_stride = chunks * 128; out (n_tiles * 8, 128)
// i32, pre-filled with 0x7FFFFFFF.
extern "C" int mv_raster_bin_eval(const void* tile_of_chunk, const void* x0,
                                  const void* y0, const void* coef, void* out,
                                  int n_chunks, int n_tiles, int coef_stride,
                                  void* stream) {
  if (n_chunks <= 0) return (int)cudaSuccess;
  if (n_tiles <= 0 || coef_stride < n_chunks * kCand
      || (long long)n_tiles * kTileH * kTileW >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_chunks, kTileH / kCtaRows);
  raster_bin_eval_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tile_of_chunk, (const float*)x0, (const float*)y0,
      (const float*)coef, (int*)out, n_tiles, coef_stride);
  return (int)cudaGetLastError();
}
