// The fused temporal-AA resolve (B5) and its row-band form (B5').
//
// Replaces multivolumes_tpu/ops/pallas/taa_kernel.py::taa_resolve (the
// band kernel `_taa_band_kernel` through `_resolve_bands`) and, as
// mv_taa_resolve_band, ::taa_resolve_sharded. Semantics twin:
// multivolumes_tpu/render/taa.py::_temporal_aa_jnp, a port of
// CSTemporalAA.hlsl:254-336. Per pixel:
//   1. Reinhard in YCoCg of the current colour and its 8 neighbours
//      (edge clamp; cross weight 0.5, diagonal 0.25);
//   2. mean and variance of the 9 taps -> variance AABB (gamma 1 or 16);
//   3. history clamp into the box, anti-flicker blend, history count in
//      channel 3 (at most 15), NaN guard;
//   4. optionally the display image |x * 1.05 / (x + 0.7)|^1.25.
//
// Layout: planar f32, cur/hist/out (4, H, W), blur (H, W), img (3, H, W).
//
// What bounds it on the card: device memory, 52 bytes per pixel (64 with
// the display image): 53 MB at 1280 x 800, 16 us at 3.35 TB/s (20 us).
// A thread per pixel that tone-maps its 8 neighbours itself runs about
// 850 instructions a pixel (10 tone maps with an IEEE division each, 36
// scalar loads with their clamped index arithmetic), some 27 us of
// instruction dispatch at that size: more than the bytes take.
//
// Design. A CTA resolves kTileW x kTileH tiles of pixels, one thread a
// pixel. For each tile it stages the tile and its one-texel halo of `cur`
// in shared memory, tone-mapped once per texel as (y, co, cg, alpha
// flag), 16 bytes a texel (5.4 KB for 34 x 10). Each pixel then reads
// its 9 taps from shared memory in the plain version's order (the
// centre, the cross, the diagonal), so the accumulation is the same
// sequence of roundings and the output equals the plain version. The
// tone map runs (34 x 10) / 256 + 1 (the history) = 2.3 times a pixel
// instead of 10, and `cur` is read 5.3 times a pixel instead of 36.
// The grid is as many CTAs as the card holds at once, each walking the
// tiles with the grid's stride, and the loads of a CTA's next tile (its
// share of the staged texels, its pixel's history and blur) are started
// into registers before it resolves the current one, so the memory is
// busy while the SMs compute. min and max are single NaN-propagating
// instructions. Offsets are 32-bit (the entry points refuse a frame of
// 2^31 floats or more). The TPU kernel's padding to 16-row bands and 128
// lanes and its three row-shifted copies of the frame (Pallas blocks
// cannot overlap) are not needed here.
//
// Band form (kernel<true>): the sharded frame step resolves one band of
// pixel rows per device of the mesh's "rows" axis. `cur` is then the band
// with one halo row above and below, (4, hb + 2, W): a tile's staged row
// sy is row y0 + sy of it, with no clamp in y (the halo of the first
// and last band is the replicated edge row, so the image edge clamps as
// in B5; rows past the band's end, staged for a tile that overhangs it,
// are clamped to its last halo row and read by no pixel). hist, blur and
// out hold the band's hb rows. Everything else is the same per-pixel
// code, so the bands equal B5 on the whole image bit for bit.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics, which nvcc never contracts into an FMA, in the order of the
// plain PyTorch version (ops/taa.py). The variance m2/9 - mu^2 cancels on
// flat regions (the sky), where a contracted FMA would move sigma by
// ~1e-4 and the gamma-16 box by ~1.6e-3. The divisions by 9 and 15 are
// multiplications by the reciprocal, as in the Pallas kernel and as
// PyTorch computes a tensor divided by a scalar on the card. A scalar
// divided by a tensor (1 / x, 4 / x, 0.25 / x, `pdiv`), which PyTorch
// forms as x.reciprocal() * scalar, is an IEEE division here: the same
// value, since a power of two scales a rounded result exactly (short of
// a subnormal 1 / x), and by measurement no slower. min, max and clamp
// propagate NaN like torch.minimum / jnp.minimum, so the NaN guard sees
// what the plain version sees.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr float kHistoryMax = 15.0f;
constexpr float kAlphaBound = 1.0f;
constexpr int kTileW = 32;             // a tile's pixels, one thread each
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kStageW = kTileW + 2;    // the tile with its halo
constexpr int kStageH = kTileH + 2;
constexpr int kStageIters = (kStageW * kStageH + kThreads - 1) / kThreads;
// CTAs an SM must hold (the register bound; 1: no bound)
constexpr int kMinCtas = 1;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// num / x for a scalar num (1, 4 or 0.25): the value PyTorch forms as
// x.reciprocal() * num (a power of two scales a rounded result exactly)
__device__ __forceinline__ float pdiv(float num, float x) {
  return div(num, x);
}

// NaN-propagating min / max / clamp, one instruction each (fminf and
// fmaxf drop a NaN operand; min.NaN returns the canonical NaN; which zero
// a +0 / -0 tie gives is the hardware's, equal values either way)
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nclamp(float v, float lo, float hi) {
  return nmin(nmax(v, lo), hi);
}

struct YCoCg {
  float y, co, cg;
};

// Invertible Reinhard in YCoCg (TM, CSTemporalAA.hlsl:106-114)
__device__ __forceinline__ YCoCg tm(float r, float g, float b) {
  float y = add(add(r, mul(2.0f, g)), b);
  float co = sub(mul(2.0f, r), mul(2.0f, b));
  float cg = sub(add(-r, mul(2.0f, g)), b);
  float inv = pdiv(1.0f, add(4.0f, y));
  return {mul(y, inv), mul(co, inv), mul(cg, inv)};
}

// Inverse (ITM, CSTemporalAA.hlsl:119-128) -> rgb
__device__ __forceinline__ float3 itm(float y, float co, float cg) {
  float s = pdiv(4.0f, sub(1.0f, y));
  y = mul(mul(y, s), 0.25f);
  co = mul(mul(co, s), 0.25f);
  cg = mul(mul(cg, s), 0.25f);
  return make_float3(sub(add(y, co), cg), add(y, cg), sub(sub(y, co), cg));
}

__device__ __forceinline__ float display_map(float x) {
  x = div(mul(x, 1.05f), add(x, 0.7f));
  return powf(fabsf(x), 1.25f);
}

// One staged texel of `cur`: its tone-mapped colour and alpha flag
__device__ __forceinline__ float4 staged_tap(float r, float g, float b,
                                             float a) {
  const YCoCg t = tm(r, g, b);
  return make_float4(t.y, t.co, t.cg, a < kAlphaBound ? 0.0f : 1.0f);
}

// A pixel's history (its four channels) and blur, loaded before the
// staging
struct HistTexel {
  float h0, h1, h2, h3, blur;
};

// The resolve of the pixel whose staged texel is taps[sy][sx] -> the new
// history's 4 channels in o, and with `display` the display image's 3 in im
__device__ __forceinline__ void resolve_pixel(const float4 (*taps)[kStageW],
                                              int sy, int sx,
                                              const HistTexel& hv,
                                              bool display, float o[4],
                                              float im[3]) {
  const float cur_blur = hv.blur;
  float history_blur = nmax(sub(1.0f, hv.h3), cur_blur);
  const float hist_w = add(mul(hv.h3, kHistoryMax), 1.0f);

  const float4 c = taps[sy][sx];
  const float cur_a = c.w;  // 0 where alpha < kAlphaBound
  const float gamma =
      (history_blur > 0.0f || cur_a == 0.0f) ? 1.0f : 16.0f;

  // NeighborMinMax (CSTemporalAA.hlsl:166-236)
  float m1[3] = {c.x, c.y, c.z};
  float m2[3] = {mul(c.x, c.x), mul(c.y, c.y), mul(c.z, c.z)};
  float filt[3] = {c.x, c.y, c.z};
  float filt_a = cur_a;
  const int kDx[8] = {-1, 1, 0, 0, -1, 1, 1, -1};
  const int kDy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float wt = t < 4 ? 0.5f : 0.25f;
    const float4 n = taps[sy + kDy[t]][sx + kDx[t]];
    const float nv[3] = {n.x, n.y, n.z};
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      filt[ci] = add(filt[ci], mul(nv[ci], wt));
      m1[ci] = add(m1[ci], nv[ci]);
      m2[ci] = add(m2[ci], mul(nv[ci], nv[ci]));
    }
    filt_a = add(filt_a, mul(n.w, wt));
  }
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) filt[ci] = mul(filt[ci], 0.25f);
  filt_a = mul(filt_a, 0.25f);

  const float inv9 = 1.0f / 9.0f;
  float mu[3], sigma[3], n_min[3], n_max[3];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    mu[ci] = mul(m1[ci], inv9);
    sigma[ci] = sqrtf(fabsf(sub(mul(m2[ci], inv9), mul(mu[ci], mu[ci]))));
    n_min[ci] = nmin(sub(mu[ci], mul(gamma, sigma[ci])), filt[ci]);
    n_max[ci] = nmax(add(mu[ci], mul(gamma, sigma[ci])), filt[ci]);
  }
  const float n_min_w = sub(mu[0], sigma[0]);
  const float n_max_w = add(mu[0], sigma[0]);

  const float cur_history_blur = nclamp(cur_blur, 0.0f, 1.0f);
  history_blur = nclamp(history_blur, 0.0f, 1.0f);

  const YCoCg ht = tm(hv.h0, hv.h1, hv.h2);
  float hist_tm[3] = {nclamp(ht.y, n_min[0], n_max[0]),
                      nclamp(ht.co, n_min[1], n_max[1]),
                      nclamp(ht.cg, n_min[2], n_max[2])};
  const float contrast = sub(n_max_w, n_min_w);

  float add_alias = add(mul(history_blur, 0.5f), 0.25f);
  add_alias = nclamp(
      add(add_alias, pdiv(1.0f, add(1.0f, mul(contrast, 128.0f)))), 0.0f,
      1.0f);
  const float cur_tm[3] = {c.x, c.y, c.z};
#pragma unroll
  for (int ci = 0; ci < 3; ++ci)
    filt[ci] = add(filt[ci], mul(sub(cur_tm[ci], filt[ci]), add_alias));

  const float lum_hist = hist_tm[0];
  const float dist_to_clamp =
      nmin(fabsf(sub(n_min_w, lum_hist)), fabsf(sub(n_max_w, lum_hist)));
  const float history_amt =
      nmin(add(pdiv(1.0f, hist_w), mul(history_blur, 0.125f)), 1.0f);
  float blend = pdiv(
      0.25f,
      add(8.0f, mul(sub(add(dist_to_clamp, contrast), 8.0f), history_amt)));
  blend = nmin(blend, 0.25f);
  blend = filt_a > 0.0f ? blend : 1.0f;

  float mixed[3];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci)
    mixed[ci] = add(hist_tm[ci], mul(sub(filt[ci], hist_tm[ci]), blend));
  float3 rgb = itm(mixed[0], mixed[1], mixed[2]);
  if (isnan(rgb.x) || isnan(rgb.y) || isnan(rgb.z))
    rgb = itm(filt[0], filt[1], filt[2]);

  o[0] = rgb.x;
  o[1] = rgb.y;
  o[2] = rgb.z;
  o[3] = nmin(mul(hist_w, 1.0f / kHistoryMax), sub(1.0f, cur_history_blur));
  if (display) {
    im[0] = display_map(rgb.x);
    im[1] = display_map(rgb.y);
    im[2] = display_map(rgb.z);
  }
}

// One tile's loads of a thread: its share of the staged texels of `cur`
// (rgba) and its pixel's history and blur
struct TileLoads {
  float4 raw[kStageIters];
  HistTexel hv;
};

// Start the loads of tile `tile` (of tiles_x a row) into l
template <bool kBand>
__device__ __forceinline__ void load_tile(const float* __restrict__ cur,
                                          const float* __restrict__ hist,
                                          const float* __restrict__ blur,
                                          int tile, int tiles_x, int h, int w,
                                          TileLoads& l) {
  const int plane = h * w;
  // the current frame: h rows, or the band's h rows inside h + 2
  const int cplane = kBand ? plane + 2 * w : plane;
  const int x0 = tile % tiles_x * kTileW, y0 = tile / tiles_x * kTileH;
  const int t = threadIdx.y * kTileW + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kStageIters; ++k) {
    const int i = t + k * kThreads;
    if (kStageIters * kThreads == kStageW * kStageH
        || i < kStageW * kStageH) {
      const int sy = i / kStageW, sx = i - sy * kStageW;
      const int xx = min(max(x0 - 1 + sx, 0), w - 1);
      const int yy = kBand ? min(y0 + sy, h + 1)
                           : min(max(y0 - 1 + sy, 0), h - 1);
      const int q = yy * w + xx;
      l.raw[k] = make_float4(cur[q], cur[cplane + q], cur[2 * cplane + q],
                             cur[3 * cplane + q]);
    }
  }
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x < w && y < h) {
    const int p = y * w + x;
    l.hv = {hist[p], hist[plane + p], hist[2 * plane + p],
            hist[3 * plane + p], blur[p]};
  }
}

template <bool kBand>
__global__ void __launch_bounds__(kThreads, kMinCtas)
taa_resolve_kernel(const float* __restrict__ cur,
                   const float* __restrict__ hist,
                   const float* __restrict__ blur, float* __restrict__ out,
                   float* __restrict__ img, int h, int w) {
  __shared__ float4 taps[kStageH][kStageW];
  const int plane = h * w;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int n_tiles = tiles_x * ((h + kTileH - 1) / kTileH);
  const int t = threadIdx.y * kTileW + threadIdx.x;
  TileLoads next = {};
  load_tile<kBand>(cur, hist, blur, blockIdx.x, tiles_x, h, w, next);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the tile's texels, tone-mapped into shared memory as they arrive
#pragma unroll
    for (int k = 0; k < kStageIters; ++k) {
      const int i = t + k * kThreads;
      if (kStageIters * kThreads == kStageW * kStageH
          || i < kStageW * kStageH) {
        const float4 v = next.raw[k];
        taps[i / kStageW][i % kStageW] = staged_tap(v.x, v.y, v.z, v.w);
      }
    }
    const HistTexel hv = next.hv;
    __syncthreads();
    // the next tile's loads fly while this one is resolved
    if (tile + gridDim.x < n_tiles)
      load_tile<kBand>(cur, hist, blur, tile + gridDim.x, tiles_x, h, w,
                       next);
    const int x = tile % tiles_x * kTileW + threadIdx.x;
    const int y = tile / tiles_x * kTileH + threadIdx.y;
    if (x < w && y < h) {
      float o[4], im[3];
      resolve_pixel(taps, threadIdx.y + 1, threadIdx.x + 1, hv,
                    img != nullptr, o, im);
      const int p = y * w + x;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) out[ch * plane + p] = o[ch];
      if (img != nullptr) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) img[ch * plane + p] = im[ch];
      }
    }
    __syncthreads();  // every tap read before the next tile's staging
  }
}

// CTAs of kernel<kBand> the card holds at once (asked once)
template <bool kBand>
int resident_ctas() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, taa_resolve_kernel<kBand>, kThreads, 0);
    n = std::max(sms * per_sm, 1);
  }
  return n;
}

// The grid: every CTA the card holds at once, each walking the tiles
// with a stride of the grid (no more CTAs than tiles)
template <bool kBand>
int grid_for(int h, int w) {
  const int n_tiles =
      ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  return std::min(n_tiles, resident_ctas<kBand>());
}

// 32-bit offsets: the planes of one call must hold fewer than 2^31 floats
bool fits_int(int h, int w) { return 4ll * h * w < (1ll << 31); }

}  // namespace

extern "C" int mv_taa_resolve(const void* cur, const void* hist,
                              const void* blur, void* out, void* img, int h,
                              int w, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  if (!fits_int(h, w)) return (int)cudaErrorInvalidValue;
  dim3 block(kTileW, kTileH);
  taa_resolve_kernel<false><<<grid_for<false>(h, w), block, 0,
                              (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)hist, (const float*)blur, (float*)out,
      (float*)img, h, w);
  return (int)cudaGetLastError();
}

// cur_halo (4, hb + 2, W): the band with its halo rows; hist, out
// (4, hb, W); blur (hb, W).
extern "C" int mv_taa_resolve_band(const void* cur_halo, const void* hist,
                                   const void* blur, void* out, int hb, int w,
                                   void* stream) {
  if (hb <= 0 || w <= 0) return (int)cudaSuccess;
  if (!fits_int(hb + 2, w)) return (int)cudaErrorInvalidValue;
  dim3 block(kTileW, kTileH);
  taa_resolve_kernel<true><<<grid_for<true>(hb, w), block, 0,
                             (cudaStream_t)stream>>>(
      (const float*)cur_halo, (const float*)hist, (const float*)blur,
      (float*)out, nullptr, hb, w);
  return (int)cudaGetLastError();
}
