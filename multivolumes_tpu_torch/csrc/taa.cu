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
// One thread per pixel on 32 x 8 blocks; the 9 taps are clamped-index
// loads that neighbouring threads share through L1. The TPU kernel's
// padding to 16-row bands and 128 lanes and its three row-shifted copies
// of the frame (Pallas blocks cannot overlap) are not needed here.
//
// Band form (kernel<true>): the sharded frame step resolves one band of
// pixel rows per device of the mesh's "rows" axis. `cur` is then the band
// with one halo row above and below, (4, hb + 2, W), and the row tap reads
// row y + 1 + dy of it with no clamp in y (the halo of the first and last
// band is the replicated edge row, so the image edge clamps as in B5);
// hist, blur and out hold the band's hb rows. Everything else is the same
// per-pixel code, so the bands equal B5 on the whole image bit for bit.
// The TPU version pads the rows to 16 x rows and builds three row-shifted
// copies of the frame; neither is needed here.
//
// What bounds it on the card: device memory, about 64 bytes per pixel
// (65 MB at 1280 x 800, some 20 us at 3.35 TB/s), against ~300 flops and
// 30 divisions per pixel.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics, which nvcc never contracts into an FMA, in the order of the
// plain PyTorch version (ops/taa.py). The variance m2/9 - mu^2 cancels on
// flat regions (the sky), where a contracted FMA would move sigma by
// ~1e-4 and the gamma-16 box by ~1.6e-3. The divisions by 9 and 15 are
// multiplications by the reciprocal, as in the Pallas kernel and as
// PyTorch computes a tensor divided by a scalar on the card. min, max and
// clamp propagate NaN like torch.minimum / jnp.minimum, so the NaN guard
// sees what the plain version sees.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kHistoryMax = 15.0f;
constexpr float kAlphaBound = 1.0f;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// NaN-propagating min / max / clamp (fminf and fmaxf drop a NaN operand)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
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
  float inv = div(1.0f, add(4.0f, y));
  return {mul(y, inv), mul(co, inv), mul(cg, inv)};
}

// Inverse (ITM, CSTemporalAA.hlsl:119-128) -> rgb
__device__ __forceinline__ float3 itm(float y, float co, float cg) {
  float s = div(4.0f, sub(1.0f, y));
  y = mul(mul(y, s), 0.25f);
  co = mul(mul(co, s), 0.25f);
  cg = mul(mul(cg, s), 0.25f);
  return make_float3(sub(add(y, co), cg), add(y, cg), sub(sub(y, co), cg));
}

__device__ __forceinline__ float display_map(float x) {
  x = div(mul(x, 1.05f), add(x, 0.7f));
  return powf(fabsf(x), 1.25f);
}

template <bool kBand>
__global__ void __launch_bounds__(kBlockX * kBlockY)
taa_resolve_kernel(const float* __restrict__ cur,
                   const float* __restrict__ hist,
                   const float* __restrict__ blur, float* __restrict__ out,
                   float* __restrict__ img, int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * w;
  const size_t p = (size_t)y * w + x;
  // the current frame: h rows, or the band's h rows inside h + 2
  const size_t cplane = kBand ? (size_t)(h + 2) * w : plane;
  const size_t pc = kBand ? p + w : p;

  const float cr = cur[pc], cg_ = cur[cplane + pc];
  const float cb = cur[2 * cplane + pc], ca = cur[3 * cplane + pc];
  const float h0 = hist[p], h1 = hist[plane + p], h2 = hist[2 * plane + p];
  const float h3 = hist[3 * plane + p];
  const float cur_blur = blur[p];

  float history_blur = nmax(sub(1.0f, h3), cur_blur);
  const float hist_w = add(mul(h3, kHistoryMax), 1.0f);

  const YCoCg c = tm(cr, cg_, cb);
  const float cur_a = ca < kAlphaBound ? 0.0f : 1.0f;
  const float gamma =
      (history_blur > 0.0f || ca < kAlphaBound) ? 1.0f : 16.0f;

  // NeighborMinMax (CSTemporalAA.hlsl:166-236)
  float m1[3] = {c.y, c.co, c.cg};
  float m2[3] = {mul(c.y, c.y), mul(c.co, c.co), mul(c.cg, c.cg)};
  float filt[3] = {c.y, c.co, c.cg};
  float filt_a = cur_a;
  const int kDx[8] = {-1, 1, 0, 0, -1, 1, 1, -1};
  const int kDy[8] = {0, 0, -1, 1, -1, -1, 1, 1};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float wt = t < 4 ? 0.5f : 0.25f;
    const int xx = min(max(x + kDx[t], 0), w - 1);
    const int yy = kBand ? y + 1 + kDy[t] : min(max(y + kDy[t], 0), h - 1);
    const size_t q = (size_t)yy * w + xx;
    const YCoCg n = tm(cur[q], cur[cplane + q], cur[2 * cplane + q]);
    const float na = cur[3 * cplane + q] < kAlphaBound ? 0.0f : 1.0f;
    const float nv[3] = {n.y, n.co, n.cg};
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      filt[ci] = add(filt[ci], mul(nv[ci], wt));
      m1[ci] = add(m1[ci], nv[ci]);
      m2[ci] = add(m2[ci], mul(nv[ci], nv[ci]));
    }
    filt_a = add(filt_a, mul(na, wt));
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

  const YCoCg ht = tm(h0, h1, h2);
  float hist_tm[3] = {nclamp(ht.y, n_min[0], n_max[0]),
                      nclamp(ht.co, n_min[1], n_max[1]),
                      nclamp(ht.cg, n_min[2], n_max[2])};
  const float contrast = sub(n_max_w, n_min_w);

  float add_alias = add(mul(history_blur, 0.5f), 0.25f);
  add_alias = nclamp(
      add(add_alias, div(1.0f, add(1.0f, mul(contrast, 128.0f)))), 0.0f,
      1.0f);
  const float cur_tm[3] = {c.y, c.co, c.cg};
#pragma unroll
  for (int ci = 0; ci < 3; ++ci)
    filt[ci] = add(filt[ci], mul(sub(cur_tm[ci], filt[ci]), add_alias));

  const float lum_hist = hist_tm[0];
  const float dist_to_clamp =
      nmin(fabsf(sub(n_min_w, lum_hist)), fabsf(sub(n_max_w, lum_hist)));
  const float history_amt =
      nmin(add(div(1.0f, hist_w), mul(history_blur, 0.125f)), 1.0f);
  float blend = div(
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

  const float meta =
      nmin(mul(hist_w, 1.0f / kHistoryMax), sub(1.0f, cur_history_blur));
  out[p] = rgb.x;
  out[plane + p] = rgb.y;
  out[2 * plane + p] = rgb.z;
  out[3 * plane + p] = meta;
  if (img != nullptr) {
    img[p] = display_map(rgb.x);
    img[plane + p] = display_map(rgb.y);
    img[2 * plane + p] = display_map(rgb.z);
  }
}

}  // namespace

extern "C" int mv_taa_resolve(const void* cur, const void* hist,
                              const void* blur, void* out, void* img, int h,
                              int w, void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  taa_resolve_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)hist, (const float*)blur, (float*)out,
      (float*)img, h, w);
  return (int)cudaGetLastError();
}

// cur_halo (4, hb + 2, W): the band with its halo rows; hist, out
// (4, hb, W); blur (hb, W).
extern "C" int mv_taa_resolve_band(const void* cur_halo, const void* hist,
                                   const void* blur, void* out, int hb, int w,
                                   void* stream) {
  dim3 block(kBlockX, kBlockY);
  dim3 grid((w + kBlockX - 1) / kBlockX, (hb + kBlockY - 1) / kBlockY);
  taa_resolve_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)cur_halo, (const float*)hist, (const float*)blur,
      (float*)out, nullptr, hb, w);
  return (int)cudaGetLastError();
}
