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
// Design. One CTA per chunk, 256 threads, four pixels each (the same
// column in rows ty, ty + 2, ty + 4, ty + 6, so neighbouring threads hold
// neighbouring columns). The chunk's 10 x 128 coefficients are staged in
// shared memory once; every thread then walks the 128 candidates with
// broadcast reads (all threads read the same address: no bank conflict)
// and keeps its four minima in registers. One atomicMin per pixel folds
// the chunk into the output, which the wrapper pre-fills with
// 0x7FFFFFFF. The TPU kernel's `first` flag and its revisited output
// block exist because its grid runs in order on one core; here the CTAs
// run in any order and the minimum is associative, so the atomics give
// the same result.
//
// What bounds it on the card: operations. Each (pixel, candidate) pair
// costs about 25 float and integer operations (three affines of two
// multiplies and two adds, the inside test, the quantise-and-pack, the
// minimum), against 40 bytes of coefficients per candidate read once per
// chunk and 4 bytes written per pixel.
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
constexpr int kThreads = 256;
constexpr int kRows = 10;                       // coefficient rows read
constexpr int kPix = kTileH * kTileW / kThreads;  // pixels per thread
constexpr int kEmpty = 0x7FFFFFFF;

__device__ __forceinline__ float affine(float xg, float yg, float cx,
                                        float cy, float ck) {
  return __fadd_rn(__fadd_rn(__fmul_rn(xg, cx), __fmul_rn(yg, cy)), ck);
}

__global__ void __launch_bounds__(kThreads)
raster_bin_eval_kernel(const int* __restrict__ tile_of_chunk,
                       const float* __restrict__ x0,
                       const float* __restrict__ y0,
                       const float* __restrict__ coef, int* __restrict__ out,
                       int n_tiles, int coef_stride) {
  __shared__ float sc[kRows][kCand];
  const int i = blockIdx.x;
  for (int k = threadIdx.x; k < kRows * kCand; k += kThreads)
    sc[k / kCand][k % kCand] =
        coef[(size_t)(k / kCand) * coef_stride + (size_t)i * kCand
             + k % kCand];
  __syncthreads();
  const int tile = tile_of_chunk[i];
  if (tile < 0 || tile >= n_tiles) return;  // never write outside `out`

  const int x = threadIdx.x % kTileW;
  const int ty = threadIdx.x / kTileW;  // 0 or 1
  const float xg = __fadd_rn(__fadd_rn((float)x, x0[i]), 0.5f);
  float yg[kPix];
  int best[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    yg[j] = __fadd_rn(__fadd_rn((float)(ty + 2 * j), y0[i]), 0.5f);
    best[j] = kEmpty;
  }

  for (int c = 0; c < kCand; ++c) {
    const float a0 = sc[0][c], a1 = sc[1][c], a2 = sc[2][c];
    const float b0 = sc[3][c], b1 = sc[4][c], b2 = sc[5][c];
    const float z0 = sc[6][c], z1 = sc[7][c], z2 = sc[8][c];
    const int tid = (int)sc[9][c];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float c1 = affine(xg, yg[j], a0, a1, a2);
      const float c2 = affine(xg, yg[j], b0, b1, b2);
      const float z = affine(xg, yg[j], z0, z1, z2);
      const float c0 = __fsub_rn(__fsub_rn(1.0f, c1), c2);
      const bool ok = c1 >= 0.0f && c2 >= 0.0f && c0 >= 0.0f &&
                      z >= 0.0f && z <= 1.0f;
      const int zq =
          (int)fminf(fmaxf(__fmul_rn(z, 32767.0f), 0.0f), 32767.0f);
      const int word = (int)(((unsigned)zq << 17) | (unsigned)tid);
      best[j] = min(best[j], ok ? word : kEmpty);
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j)
    if (best[j] != kEmpty)
      atomicMin(&out[((size_t)tile * kTileH + ty + 2 * j) * kTileW + x],
                best[j]);
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
  if (n_tiles <= 0 || coef_stride < n_chunks * kCand)
    return (int)cudaErrorInvalidValue;
  raster_bin_eval_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tile_of_chunk, (const float*)x0, (const float*)y0,
      (const float*)coef, (int*)out, n_tiles, coef_stride);
  return (int)cudaGetLastError();
}
