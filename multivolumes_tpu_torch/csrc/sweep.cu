// Plane-sweep cube-map march (B1).
//
// Replaces multivolumes_tpu/ops/pallas/sweep_kernel.py::sweep_batched_pallas
// (semantics twin: render/sweep.py::sweep_batched).
//
// What it computes: for every (volume, face) and every texel ray of the
// face's top-left n_eff x n_eff corner, a front-to-back march over the
// face-parallel planes k = 0..P-1 at depth w_k = clip(ew) + (k + 0.5)
// delta. Each sample is one trilinear linear-clamp fetch of the 4-channel
// density and of the 3-channel light map at the ray's plane crossing,
// composited with opacity correction:
//   A = (1 - 0.8 rho)^f,  scatter += C * L * T * (1 - A),  T *= A,
// counted only inside the ray's [s_in, s_end] and where rho > 0.01.
//
// Rounding: with bf16 stacks, the z-lerp, the interpolation weights and
// the u-pass result are rounded to bf16 exactly where the JAX twin (and
// the TPU kernel's bf16 operands) round them. The march is discontinuous
// in the density (a sample counts only where rho > 0.01), so a density
// one bf16 step off can flip a sample and move a texel by several
// percent: pure f32 lerps put 914 of 1.5M demo-frame texels outside the
// twin's tolerance (H100 run). The coordinates the weights come from are
// computed without contraction (`grid_coord`, `crossing`), so each weight
// rounds from the plain version's f32 value: contracted, they left 115
// rays of a 64-volume S = 128 frame beyond that tolerance (H100, 700 W;
// `tools/sweep_outliers.py --sharded`), none after. The six face
// orientations are not stored:
// each face addresses the plain channel-last stack through its variant
// permutation and flips (FACE_VARIANT, FACE_FLIPS in ops/sweep.py).
//
// What bounds it on the card: instructions, then texel fetches. One thread
// marches one ray, 16 x 16 rays a CTA; a sample read straight from the
// stacks is 16 dependent 8-byte gathers (8 for the density, 8 for the
// light), each texel fetched and z-lerped again by every neighbouring ray
// that taps it, and each ray repeats tent and clamp arithmetic that
// depends on its column or its row alone. The L1 and the 50 MB L2 serve
// the gathers well, so the time follows the instructions a sample costs
// (NVIDIA H100, 700 W: the demo frame's 8-volume S=128 launch takes 0.53
// ms with all of the below, 0.61 without the staging, 0.94 before).
// What the design does about it:
//   * What every ray of a face shares on a plane (ray parameter, slab
//     pairs, rounded z weights, the transparent-slab test, the staging
//     rectangles) is computed once per CTA, one plane a thread, into
//     shared memory before the march (`PlaneRec`).
//   * The tent taps are separable: the u taps depend on the ray's column,
//     the v taps on its row. Per block of kExitEvery planes the CTA fills
//     a table of 16 + 16 taps per plane and grid (`Tap`), two entries a
//     thread, and a sample reads four entries instead of evaluating two
//     clamps and four tents.
//   * The z-lerp runs on the stored texels: in bf16 as packed bf16
//     multiplies and adds (`zlerp`), six instructions a texel, with the
//     twin's rounding.
//   * The slab pair of a plane is staged in shared memory, z-lerped once.
//     The rays of a tile cross plane k inside a rectangle of the slab (the
//     crossing is affine in the texel index, so the tile's end rays bound
//     it: `tile_rect`, mirrored by ops/sweep.py:tile_rect for the CPU
//     tests). The CTA loads that rectangle of slabs z0 and z1 with
//     coalesced loads, z-lerps each texel once, and every ray takes its
//     2 x 2 taps from shared memory (u pass rounded, v pass in f32: no
//     rounding differs from the direct fetch).
//   * The staging of plane k + 1 overlaps the march of plane k: its global
//     loads start into registers before the taps of plane k and
//     written to the other half of a double buffer after them; one
//     __syncthreads a plane.
//   * The light map is staged the same way on its own grid, for a plane
//     whose predecessor but one had a live sample in the tile (the vote
//     rides on that __syncthreads; clouds are coherent along the march).
//     A live sample on a plane staged without its light reads the light
//     stack directly.
//   * A tile with a plane whose rectangle exceeds the buffers (the lower
//     LODs, where a ray step spans several texels and staging would load
//     more than it saves; an eye so close that the near planes fan out)
//     marches by the direct fetch of the stacks with no barrier per plane:
//     a path of this kernel, exact. A launch whose shapes can never stage
//     takes the instantiation without the buffers (`stages`), which is
//     what the demo frame's S=64 and S=32 launches run.
//   * The per-ray operands are read as the frame has them (s_in, s_end,
//     ray_len, active); the opacity exponent f_corr, the face constants
//     and the masks are computed here, in the plain version's operation
//     order with non-contracted operations.
//
// Skips, all exact except the early exit: a ray marches only the planes
// of its own [s_in, s_end] window; a slab pair whose density max (vol_zmax)
// is <= 0.01 cannot give a live sample; the light map is read only for
// live samples. The early exit is the TPU kernel's face-level test: a
// face stops once every one of its rays has T < 0.01 (a dead ray keeps
// T = 1, as there). Each face counts its rays that fell below 0.01 in
// `done` (device memory, one int per face, zero on entry); every CTA of
// the face reads the count every kExitEvery planes, where it fills its
// tap tables (the TPU kernel tests at its plane blocks, min(8, 8 P / n)
// planes; on the demo frame an interval of 32, or no vote at all, changes
// neither the result nor the time by more than 1%). A CTA-level test
// would cut rays the TPU kernel marches on, by up to 0.01 x the brightest
// tail sample.

#include "common.cuh"

namespace {

constexpr float kAbsorption = 0.8f;
constexpr float kZeroThreshold = 0.01f;
constexpr int kTile = 16;       // texels per CTA side
constexpr int kThreads = kTile * kTile;
constexpr int kExitEvery = 8;   // planes between early-exit votes
// staging buffers: rows of a power-of-two pitch, so that a thread finds
// its texel by shifts; 256 threads fill 8 (density) or 16 (light) rows a
// round
constexpr int kVolPitchLog2 = 5, kVolRounds = 3;     // 32 x 24 texels
constexpr int kLightPitchLog2 = 4, kLightRounds = 1; // 16 x 16 texels
constexpr int kVolRows = kVolRounds * (kThreads >> kVolPitchLog2);
constexpr int kLightRows = kLightRounds * (kThreads >> kLightPitchLog2);
constexpr int kVolTexels = kVolRows << kVolPitchLog2;
constexpr int kLightTexels = kLightRows << kLightPitchLog2;
constexpr float kRectPad = 1e-3f;  // see axis_span

// face -> stored variant and (z, v, u) mirrors (ops/sweep.py)
__constant__ int kFaceVariant[6] = {1, 1, 2, 2, 0, 0};
__constant__ float kFaceFlips[6][3] = {{0, 0, 1}, {1, 0, 0}, {0, 1, 0},
                                       {1, 0, 0}, {0, 0, 0}, {1, 0, 1}};

struct FaceIn {
  int src, lrow, run, var;
  float eu, ev, ew, ew_c, delta, inv_gz, n_eff, zf, vf, uf;
};

// a staged rectangle of a slab: rows y0 .. y0+h-1, columns x0 .. x0+w-1
// (h = 0: nothing staged)
struct Rect {
  int y0, x0, h, w;
};

// Element strides of the oriented axes (zo, yo, xo) of variant `var` in
// the plain (z, y, x) cube of side n (see sweep.orient_variants): texel
// (zo, yo, xo) is at zo * sz + yo * sy + xo * sx
struct Strides {
  int sz, sy, sx;
};
__device__ __forceinline__ Strides strides_of(int var, int n) {
  if (var == 1) return Strides{1, n, n * n};       // z <-> x
  if (var == 2) return Strides{n, n * n, 1};       // z <-> y
  return Strides{n * n, n, 1};
}

// Round to the storage type: identity for f32, round-to-nearest bf16 for
// bf16 stacks (see "Rounding" above).
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One texel (4 channels) as it is stored and staged: 16 bytes of f32 or 8
// bytes of bf16.
template <typename T> struct Texel;
template <> struct Texel<float> { using type = float4; };
template <> struct Texel<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}
// the two tent taps of clipped coordinate c in [0, n-1]: index of the
// first, weights max(0, 1 - |c - t|) of both (the second is 0 past n-1)
template <typename T>
__device__ __forceinline__ int tent(float c, int n, float* w0, float* w1) {
  int t0 = (int)floorf(c);
  *w0 = rnd<T>(fmaxf(1.0f - fabsf(c - (float)t0), 0.0f));
  *w1 = (t0 + 1 <= n - 1)
      ? rnd<T>(fmaxf(1.0f - fabsf(c - (float)(t0 + 1)), 0.0f)) : 0.0f;
  return t0;
}

// The z-lerp of one texel of slabs z0 (a) and z1 (b) in the storage type,
// rnd(rnd(a * om) + rnd(b * fzb)) per channel as the twin's `slab`. In
// bf16 these are the card's packed bf16 multiply and add, each rounding
// once (never fused): the product of two bf16 values is exact in f32 and
// their sum rounds to the same bf16 value from f32 as from the exact sum,
// so this equals the f32 arithmetic rounded at each step.
__device__ __forceinline__ float4 zlerp(float4 a, float4 b, float om,
                                        float fzb) {
  return make_float4(a.x * om + b.x * fzb, a.y * om + b.y * fzb,
                     a.z * om + b.z * fzb, a.w * om + b.w * fzb);
}
__device__ __forceinline__ uint2 zlerp(uint2 a, uint2 b, float om,
                                       float fzb) {
  const __nv_bfloat162 o2 = __float2bfloat162_rn(om);
  const __nv_bfloat162 f2 = __float2bfloat162_rn(fzb);
  auto lerp2 = [&](unsigned x, unsigned y) {
    const __nv_bfloat162 r = __hadd2_rn(
        __hmul2_rn(*reinterpret_cast<__nv_bfloat162*>(&x), o2),
        __hmul2_rn(*reinterpret_cast<__nv_bfloat162*>(&y), f2));
    return *reinterpret_cast<const unsigned*>(&r);
  };
  return make_uint2(lerp2(a.x, b.x), lerp2(a.y, b.y));
}

// The two tent taps of a ray on one lateral axis of a plane: first tap,
// step to the second (0 at the grid's edge), and their weights. A tap
// depends on the ray's column (u axis) or row (v axis) alone, so a tile
// computes 16 + 16 of them per plane and grid, not one pair per ray.
struct __align__(16) Tap {
  int t0, d1;
  float w0, w1;
};

// One sample of the oriented stack: z-lerp of slabs z0/z1 (weights om,
// fzb, rounded as the twin), then the u tent (rounded), then the v tent
// (f32), at the taps (ty, tx). The z-lerped texels come from the staged
// rectangle `r` of `buf` (rows of 1 << kPitchLog2 texels), which holds
// the taps of every ray of the tile (`axis_span`), or with r.h = 0 from
// the stack itself.
template <typename T, int kPitchLog2>
__device__ __forceinline__ float4 trilerp(
    const T* cube, Strides st, int z0, int z1, float om, float fzb, Tap ty,
    Tap tx, const typename Texel<T>::type* buf, Rect r) {
  using Tx = typename Texel<T>::type;
  const bool staged = r.h > 0;   // the same for every ray of the tile
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int y = ty.t0 + (rr ? ty.d1 : 0);
    const float wy = rr ? ty.w1 : ty.w0;
    float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int x = tx.t0 + (c ? tx.d1 : 0);
      const float wx = c ? tx.w1 : tx.w0;
      float4 t;
      if (staged) {
        t = widen(buf[((y - r.y0) << kPitchLog2) + (x - r.x0)]);
      } else {
        const T* p = cube + 4 * (y * st.sy + x * st.sx);
        t = widen(zlerp(*reinterpret_cast<const Tx*>(p + 4 * z0 * st.sz),
                        *reinterpret_cast<const Tx*>(p + 4 * z1 * st.sz), om,
                        fzb));
      }
      row.x += wx * t.x;
      row.y += wx * t.y;
      row.z += wx * t.z;
      row.w += wx * t.w;
    }
    acc.x += wy * rnd<T>(row.x);
    acc.y += wy * rnd<T>(row.y);
    acc.z += wy * rnd<T>(row.z);
    acc.w += wy * rnd<T>(row.w);
  }
  return acc;
}

// Where a sample lies: the plane depth, the ray's crossing and the grid
// coordinate are rounded after every operation, in the plain version's
// order, never contracted into a fused multiply-add. They feed weights
// rounded to bf16, and an ulp of the coordinate can move such a weight
// one bf16 step, which changes a composited sample by about 0.5% and
// can flip the density test (ROADMAP.md section C).
// grid coordinate (p * 0.5 + 0.5) * n - 0.5 of p in [-1, 1]
__device__ __forceinline__ float grid_coord(float p, int n) {
  return __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(p, 0.5f), 0.5f), (float)n),
                   0.5f);
}
// the crossing e + sk (g - e) of the ray through texel centre g
__device__ __forceinline__ float crossing(float e, float sk, float g) {
  return __fadd_rn(e, __fmul_rn(sk, __fsub_rn(g, e)));
}

// slab pair and weight of plane depth wk (sweep_batched's slab_block,
// including its clamp of z1 = z0 + 1 below the first slab)
__device__ __forceinline__ void slab_pair(float wk, int n, float zf, int* z0,
                                          int* z1, float* fz) {
  float zc = grid_coord(wk, n);
  zc = zc + zf * ((n - 1.0f) - 2.0f * zc);
  float fl = floorf(zc);
  *z0 = min(max((int)fl, 0), n - 1);
  *z1 = min(*z0 + 1, n - 1);
  *fz = mv::clampf(zc - fl, 0.0f, 1.0f);
}

__device__ __forceinline__ float lateral(float p, int n, float flip) {
  float c = mv::clampf(grid_coord(p, n), 0.0f, n - 1.0f);
  return c + flip * ((n - 1.0f) - 2.0f * c);
}

// texel centre of face column j (or, negated, of row i) in [-1, 1]
__device__ __forceinline__ float texel_u(int j, float n_eff) {
  return ((float)j + 0.5f) / n_eff * 2.0f - 1.0f;
}

// The taps of rays lo .. hi of one lateral axis on the plane at ray
// parameter sk span [*t_lo, *t_hi] of a grid of side n: the crossing
// e + sk (g - e) is monotone in the ray index and `lateral` clamps, then
// mirrors, so the end rays bound it. In f32 each of the half dozen
// operations on the way can break the order of two rays by an ulp of the
// coordinate (6e-5 at n = 1024); kRectPad covers that, so every ray's
// taps lie inside the span and no ray needs a test of its own (`stages`
// refuses larger grids).
__device__ __forceinline__ void axis_span(float e, float sk, float g_lo,
                                          float g_hi, int n, float flip,
                                          int* t_lo, int* t_hi) {
  const float a = lateral(crossing(e, sk, g_lo), n, flip);
  const float b = lateral(crossing(e, sk, g_hi), n, flip);
  *t_lo = max((int)floorf(fminf(a, b) - kRectPad), 0);
  *t_hi = min((int)floorf(fmaxf(a, b) + kRectPad) + 1, n - 1);
}

// The staging rectangle of the tile's rays (rows i_lo .. i_hi, columns
// j_lo .. j_hi of the face) on the plane at sk,
// on a grid of side n; h = 0 when the tile has no ray or the rectangle
// exceeds the buffer of max_h rows x max_w columns. Mirrored by
// ops/sweep.py:tile_rect.
__device__ __forceinline__ Rect tile_rect(const FaceIn& fc, float sk, int n,
                                          int i_lo, int i_hi, int j_lo,
                                          int j_hi, int max_h, int max_w) {
  Rect r = {0, 0, 0, 0};
  if (i_hi < i_lo || j_hi < j_lo) return r;
  int y_lo, y_hi, x_lo, x_hi;
  axis_span(fc.ev, sk, -texel_u(i_lo, fc.n_eff), -texel_u(i_hi, fc.n_eff), n,
            fc.vf, &y_lo, &y_hi);
  axis_span(fc.eu, sk, texel_u(j_lo, fc.n_eff), texel_u(j_hi, fc.n_eff), n,
            fc.uf, &x_lo, &x_hi);
  const int h = y_hi - y_lo + 1, w = x_hi - x_lo + 1;
  if (h > max_h || w > max_w) return r;
  r.y0 = y_lo; r.x0 = x_lo; r.h = h; r.w = w;
  return r;
}

// stage, first half: this thread's texels of rectangle r of slabs z0 and
// z1, from the stack into registers (thread t: column t % pitch of rows
// t / pitch + q * 256 / pitch)
template <typename T, int kRounds, int kPitchLog2>
__device__ __forceinline__ void stage_load(
    const T* cube, Strides st, int z0, int z1, Rect r, int tid,
    typename Texel<T>::type* a, typename Texel<T>::type* b) {
  using Tx = typename Texel<T>::type;
  const int tx = tid & ((1 << kPitchLog2) - 1), ty = tid >> kPitchLog2;
  if (tx >= r.w) return;
  const T* col = cube + 4 * ((r.y0 + ty) * st.sy + (r.x0 + tx) * st.sx);
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int y = ty + q * (kThreads >> kPitchLog2);
    if (y < r.h) {
      const T* p = col + 4 * q * (kThreads >> kPitchLog2) * st.sy;
      a[q] = *reinterpret_cast<const Tx*>(p + 4 * z0 * st.sz);
      b[q] = *reinterpret_cast<const Tx*>(p + 4 * z1 * st.sz);
    }
  }
}

// stage, second half: z-lerp the loaded texels and write them to buf
template <typename T, int kRounds, int kPitchLog2>
__device__ __forceinline__ void stage_store(
    const typename Texel<T>::type* a, const typename Texel<T>::type* b,
    float om, float fzb, Rect r, int tid, typename Texel<T>::type* buf) {
  const int tx = tid & ((1 << kPitchLog2) - 1), ty = tid >> kPitchLog2;
  if (tx >= r.w) return;
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int y = ty + q * (kThreads >> kPitchLog2);
    if (y < r.h) buf[(y << kPitchLog2) + tx] = zlerp(a[q], b[q], om, fzb);
  }
}

// What every ray of a face shares on plane k, computed once per CTA into
// shared memory before the march: ray parameter, the rounded z weights
// and slab pairs of the density and the light, whether the density slabs
// hold anything, and the tile's staging rectangles.
struct __align__(16) PlaneRec {
  float sk, om, fzb, oml;
  float flb;
  int z0, z1, l0;
  int l1, dense, pad0, pad1;
  Rect r;
  Rect lr;
};

// kStage = false compiles the staging out: the launch for shapes whose
// rectangles could never fit the buffers (see `stages`), with the
// registers and the shared memory of the direct march alone.
// (bf16 is held to the registers of four CTAs an SM, where it measured
// fastest; f32, which never stages, is left unbounded)
template <typename T, bool kStage>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 4 : 1)
sweep_kernel(
    const T* __restrict__ vol, const T* __restrict__ light,
    const float* __restrict__ zmax, const int* __restrict__ tex_g,
    const int* __restrict__ lrow_g, const unsigned char* __restrict__ run_g,
    const float* __restrict__ n_eff_g, const int* __restrict__ smp_g,
    const float* __restrict__ eye_g, const float* __restrict__ s_in_g,
    const float* __restrict__ s_end_g, const float* __restrict__ ray_len_g,
    const unsigned char* __restrict__ active_g, int* __restrict__ done,
    float* __restrict__ out, int S, int P, int n, int nl, float max_dist) {
  using Tx = typename Texel<T>::type;
  // two density buffers and two light buffers (this plane's, the next's)
  __shared__ __align__(16) Tx vbuf[kStage ? 2 : 1][kStage ? kVolTexels : 1];
  __shared__ __align__(16) Tx lbuf[kStage ? 2 : 1][kStage ? kLightTexels : 1];
  __shared__ int k_range[2];
  __shared__ int face_done;
  __shared__ int tile_stages;
  // the taps of the tile's columns and rows on the planes of one block:
  // [plane of the block][density, light][u, v][column or row]
  __shared__ Tap tab[kExitEvery][2][2][kTile];
  extern __shared__ __align__(16) unsigned char sweep_mem[];
  PlaneRec* recs = reinterpret_cast<PlaneRec*>(sweep_mem);   // P of them
  const int b = blockIdx.y;
  const int tiles_x = (S + kTile - 1) / kTile;
  const int j0 = (blockIdx.x % tiles_x) * kTile;
  const int i0 = (blockIdx.x / tiles_x) * kTile;
  const int j = j0 + threadIdx.x;   // u column
  const int i = i0 + threadIdx.y;   // v row
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const bool in_face = (i < S) && (j < S);

  // the face's constants, in the plain version's operation order
  const int vi = b / 6, f6 = b - vi * 6;
  FaceIn fc;
  fc.src = tex_g[vi];
  fc.lrow = lrow_g[vi];
  fc.run = run_g[b];
  fc.var = kFaceVariant[f6];
  fc.eu = eye_g[3 * b]; fc.ev = eye_g[3 * b + 1]; fc.ew = eye_g[3 * b + 2];
  fc.ew_c = mv::clampf(fc.ew, -1.0f, 1.0f);
  fc.delta = __fdiv_rn(__fsub_rn(1.0f, fc.ew_c), (float)P);
  fc.inv_gz = __fdiv_rn(1.0f, fmaxf(__fsub_rn(1.0f, fc.ew), 1e-6f));
  fc.n_eff = n_eff_g[vi];
  fc.zf = kFaceFlips[f6][0]; fc.vf = kFaceFlips[f6][1];
  fc.uf = kFaceFlips[f6][2];
  const float step_scale =
      __fdiv_rn(max_dist, fmaxf((float)smp_g[vi], 1.0f));

  const size_t ray = ((size_t)b * S + i) * S + j;
  const size_t plane = (size_t)S * S;
  float transm = 1.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;

  // this ray's plane window [k_lo, k_hi] from its [s_in, s_end]
  float s_in = 0.0f, s_end = -3.402823466e38f;
  int k_lo = P, k_hi = -1;
  if (in_face && fc.run) {
    s_in = s_in_g[ray];
    if (active_g[ray]) s_end = s_end_g[ray];
    if (fc.delta > 1e-20f) {
      float kl = (s_in / fc.inv_gz + fc.ew - fc.ew_c) / fc.delta - 0.5f;
      float kh = (s_end / fc.inv_gz + fc.ew - fc.ew_c) / fc.delta - 0.5f;
      kl = mv::clampf(kl, -1e9f, 1e9f);
      kh = mv::clampf(kh, -1e9f, 1e9f);
      k_lo = max((int)floorf(kl) - 1, 0);
      k_hi = min((int)ceilf(kh) + 1, P - 1);
    } else if (s_end >= s_in) {
      k_lo = 0;
      k_hi = P - 1;
    }
  }
  if (tid == 0) {
    k_range[0] = P;
    k_range[1] = -1;
    face_done = 0;
    tile_stages = kStage;
  }
  __syncthreads();
  if (k_lo <= k_hi) {
    atomicMin(&k_range[0], k_lo);
    atomicMax(&k_range[1], k_hi);
  }
  __syncthreads();
  const int kb_lo = k_range[0], kb_hi = k_range[1];

  // the tile's rays inside the face (a ray beyond the n_eff corner may be
  // marched too when the caller leaves it active, so it counts; in a
  // frame such rays are inactive and their tiles have no plane to march)
  const int i_hi = min(i0 + kTile - 1, S - 1);
  const int j_hi = min(j0 + kTile - 1, S - 1);
  // The planes of the tile's window, one per thread. The tile stages its
  // planes only if every dense plane's rectangles fit the buffers; else
  // it marches by the direct fetch alone, with no barrier per plane.
  for (int k = kb_lo + tid; k <= kb_hi; k += kThreads) {
    PlaneRec p;
    const float wk = __fadd_rn(fc.ew_c,
                               __fmul_rn((float)k + 0.5f, fc.delta));
    float fz, fl;
    p.sk = (wk - fc.ew) * fc.inv_gz;
    slab_pair(wk, n, fc.zf, &p.z0, &p.z1, &fz);
    slab_pair(wk, nl, fc.zf, &p.l0, &p.l1, &fl);
    p.fzb = rnd<T>(fz); p.om = rnd<T>(1.0f - p.fzb);
    p.flb = rnd<T>(fl); p.oml = rnd<T>(1.0f - p.flb);
    p.dense = 1;
    if (zmax != nullptr) {
      const float* zm = zmax + (size_t)(fc.src * 3 + fc.var) * n;
      p.dense = fmaxf(zm[p.z0], zm[p.z1]) > kZeroThreshold;
    }
    p.pad0 = p.pad1 = 0;
    p.r = Rect{0, 0, 0, 0};
    p.lr = p.r;
    if (kStage && p.dense) {
      p.r = tile_rect(fc, p.sk, n, i0, i_hi, j0, j_hi, kVolRows,
                      1 << kVolPitchLog2);
      p.lr = tile_rect(fc, p.sk, nl, i0, i_hi, j0, j_hi, kLightRows,
                       1 << kLightPitchLog2);
      if (p.r.h == 0 || p.lr.h == 0) tile_stages = 0;
    }
    recs[k] = p;
  }
  __syncthreads();
  const bool staging = kStage && tile_stages != 0;

  const T* vcube = vol + (size_t)fc.src * n * n * n * 4;
  const T* lcube = light + (size_t)fc.lrow * nl * nl * nl * 4;
  const Strides vst = strides_of(fc.var, n), lst = strides_of(fc.var, nl);
  const float f_corr = (k_lo <= k_hi)
      ? __fdiv_rn(__fmul_rn(__fmul_rn(fc.delta, fc.inv_gz), ray_len_g[ray]),
                  step_scale)
      : 0.0f;
  bool counted = false;  // this ray has reported T < 0.01 to `done`
  const Rect none = Rect{0, 0, 0, 0};

  Tx ra[kVolRounds], rb[kVolRounds], la[kLightRounds], lb[kLightRounds];
  // the light of a plane is staged when the plane before the last had a
  // live sample in the tile (clouds are coherent along the march); a live
  // sample on a plane staged without it reads the light stack directly
  bool any_prev = true, light_cur = false;
  if (staging && kb_lo <= kb_hi) {
    const PlaneRec p = recs[kb_lo];
    if (p.r.h > 0) {
      stage_load<T, kVolRounds, kVolPitchLog2>(vcube, vst, p.z0, p.z1, p.r,
                                               tid, ra, rb);
      stage_store<T, kVolRounds, kVolPitchLog2>(ra, rb, p.om, p.fzb, p.r, tid,
                                                vbuf[0]);
      stage_load<T, kLightRounds, kLightPitchLog2>(lcube, lst, p.l0, p.l1,
                                                   p.lr, tid, la, lb);
      stage_store<T, kLightRounds, kLightPitchLog2>(la, lb, p.oml, p.flb,
                                                    p.lr, tid, lbuf[0]);
      light_cur = true;
    }
    __syncthreads();
  }
  int slot = 0;

  for (int k = kb_lo; k <= kb_hi; ++k) {
    const int kk = (k - kb_lo) % kExitEvery;
    if (kk == 0) {
      // A block of kExitEvery planes begins: the face-level exit vote on
      // the blocks before it, and the block's tap tables, two entries a
      // thread. (With staging every thread has passed the last plane's
      // barrier; without, the barrier here ends the last block's reads.)
      if (k > kb_lo) {
        if (!staging) __syncthreads();
        if (tid == 0)
          face_done = *reinterpret_cast<volatile int*>(done + b) == S * S;
      }
      for (int e = tid; e < kExitEvery * 4 * kTile; e += kThreads) {
        const int k2 = k + e / (4 * kTile);
        if (k2 > kb_hi) break;
        const int g = (e / (2 * kTile)) & 1, ax = (e / kTile) & 1;
        const int idx = e & (kTile - 1);
        const int nn = g ? nl : n;
        const float eye = ax ? fc.ev : fc.eu;
        const float coord = ax ? -texel_u(i0 + idx, fc.n_eff)
                               : texel_u(j0 + idx, fc.n_eff);
        const float c = lateral(crossing(eye, recs[k2].sk, coord), nn,
                                ax ? fc.vf : fc.uf);
        Tap t;
        t.t0 = tent<T>(c, nn, &t.w0, &t.w1);
        t.d1 = min(t.t0 + 1, nn - 1) - t.t0;
        tab[e / (4 * kTile)][g][ax][idx] = t;
      }
      __syncthreads();
      if (face_done) break;
    }
    const PlaneRec cur = recs[k];
    // the next plane's slabs: loads started now, used after this plane
    const bool stage_next = staging && k < kb_hi && recs[k + 1].r.h > 0;
    const bool light_next = stage_next && any_prev;
    if (stage_next) {
      const PlaneRec& nx = recs[k + 1];
      stage_load<T, kVolRounds, kVolPitchLog2>(vcube, vst, nx.z0, nx.z1,
                                               nx.r, tid, ra, rb);
      if (light_next)
        stage_load<T, kLightRounds, kLightPitchLog2>(lcube, lst, nx.l0,
                                                     nx.l1, nx.lr, tid, la,
                                                     lb);
    }
    bool live = false;
    if (k >= k_lo && k <= k_hi && cur.dense && cur.sk >= s_in
        && cur.sk <= s_end) {
      const float4 c = trilerp<T, kVolPitchLog2>(
          vcube, vst, cur.z0, cur.z1, cur.om, cur.fzb,
          tab[kk][0][1][threadIdx.y], tab[kk][0][0][threadIdx.x],
          vbuf[kStage ? slot : 0], staging ? cur.r : none);
      const float rho = mv::clampf(c.w, 0.0f, 1.0f);
      live = rho > kZeroThreshold;
      if (live) {
        const float4 lt = trilerp<T, kLightPitchLog2>(
            lcube, lst, cur.l0, cur.l1, cur.oml, cur.flb,
            tab[kk][1][1][threadIdx.y], tab[kk][1][0][threadIdx.x],
            lbuf[kStage ? slot : 0], light_cur ? cur.lr : none);
        const float a_mult = exp2f(
            f_corr * log2f(fmaxf(1.0f - rho * kAbsorption, 1e-7f)));
        const float amt = transm * (1.0f - a_mult);
        sr += c.x * lt.x * amt;
        sg += c.y * lt.y * amt;
        sb += c.z * lt.z * amt;
        sa += amt;
        transm *= a_mult;
        if (transm < 0.01f && !counted) {
          counted = true;
          atomicAdd(done + b, 1);
        }
      }
    }
    if (staging) {
      if (stage_next) {
        const PlaneRec& nx = recs[k + 1];
        stage_store<T, kVolRounds, kVolPitchLog2>(
            ra, rb, nx.om, nx.fzb, nx.r, tid, vbuf[kStage ? slot ^ 1 : 0]);
        if (light_next)
          stage_store<T, kLightRounds, kLightPitchLog2>(
              la, lb, nx.oml, nx.flb, nx.lr, tid,
              lbuf[kStage ? slot ^ 1 : 0]);
      }
      // one barrier a plane: the next plane is staged, this plane's
      // buffers are free, and the tile knows whether it had a live sample
      any_prev = __syncthreads_or(live);
      light_cur = light_next;
    }
    slot ^= 1;
  }

  if (in_face) {
    float* o = out + (size_t)b * 4 * plane + (size_t)i * S + j;
    o[0] = sr;
    o[plane] = sg;
    o[2 * plane] = sb;
    o[3 * plane] = sa;
  }
}

// Whether a launch of faces of S x S rays on grids of side n (density) and
// nl (light) stages: a 16-ray tile at the full resolution spans 16 n / S
// texels and the second tap, which must fit the buffers' rows (a volume at
// a lower n_eff spans more and decides per tile). bf16 stacks only: in f32
// the staged bytes double and the direct fetch measured faster (NVIDIA
// H100, 700 W, the demo's 8 volumes at S = 128 as f32: 0.93 ms staged,
// 0.65 direct; in bf16 0.52 staged, 0.60 direct).
bool stages(int S, int n, int nl, bool is_bf16) {
  return is_bf16 && kTile * n + 2 * S <= kVolRows * S
      && kTile * nl + 2 * S <= kLightRows * S && n <= 1024 && nl <= 1024;
}

template <typename T, bool kStage>
cudaError_t launch(const void* vol, const void* light, const void* zmax,
                   const void* tex, const void* lrow, const void* run,
                   const void* n_eff, const void* smp, const void* eye,
                   const void* s_in, const void* s_end, const void* ray_len,
                   const void* active, void* done, void* out, int B, int S,
                   int P, int n, int nl, float max_dist,
                   cudaStream_t stream) {
  // The plane records are dynamic shared memory beside the static
  // buffers; together they may pass the 48 KB a kernel has without
  // opting in, so opt in once, up to the 512 planes the wrapper allows.
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<T, kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        512 * (int)sizeof(PlaneRec));
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  const int tiles = (S + kTile - 1) / kTile;
  dim3 grid(tiles * tiles, B);
  dim3 block(kTile, kTile);
  sweep_kernel<T, kStage>
      <<<grid, block, (size_t)P * sizeof(PlaneRec), stream>>>(
      (const T*)vol, (const T*)light, (const float*)zmax, (const int*)tex,
      (const int*)lrow, (const unsigned char*)run, (const float*)n_eff,
      (const int*)smp, (const float*)eye, (const float*)s_in,
      (const float*)s_end, (const float*)ray_len,
      (const unsigned char*)active, (int*)done, (float*)out, S, P, n, nl,
      max_dist);
  return cudaGetLastError();
}

template <typename T, bool kStage>
cudaError_t info(int planes, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, sweep_kernel<T, kStage>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  const size_t dyn = (size_t)planes * sizeof(PlaneRec);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sweep_kernel<T, kStage>, kThreads, dyn);
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + dyn);
  out[2] = per_sm;
  out[3] = kStage;
  out[4] = (int)fa.localSizeBytes;
  return err;
}

}  // namespace

// vol (N_src, n, n, n, 4), light (N_light, nl, nl, nl, 4) in the storage
// type (bf16 when is_bf16, else f32); zmax (N_src, 3, n) f32 or null;
// per volume (B / 6 of them): tex, lrow, smp i32, n_eff f32; per face: run
// u8 (B,), eye f32 (B, 3); per ray: s_in, s_end, ray_len f32 and active u8
// (B, S, S); done (B,) i32, zero on entry (consumed); out (B, 4, S, S)
// f32; max_dist: the numerator of the step scale (SharedConsts.MAX_DIST).
extern "C" int mv_sweep_march(const void* vol, const void* light,
                              const void* zmax, const void* tex,
                              const void* lrow, const void* run,
                              const void* n_eff, const void* smp,
                              const void* eye, const void* s_in,
                              const void* s_end, const void* ray_len,
                              const void* active, void* done, void* out,
                              int B, int S, int P, int n, int nl,
                              int is_bf16, float max_dist, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define MV_SWEEP_LAUNCH(T, K)                                               \
  launch<T, K>(vol, light, zmax, tex, lrow, run, n_eff, smp, eye, s_in,     \
               s_end, ray_len, active, done, out, B, S, P, n, nl, max_dist, \
               st)
  cudaError_t err;
  if (stages(S, n, nl, is_bf16))
    err = MV_SWEEP_LAUNCH(__nv_bfloat16, true);
  else
    err = is_bf16 ? MV_SWEEP_LAUNCH(__nv_bfloat16, false)
                  : MV_SWEEP_LAUNCH(float, false);
#undef MV_SWEEP_LAUNCH
  return (int)err;
}

// out[0..4] = registers per thread, shared memory per CTA (bytes, with the
// records of P planes), CTAs per SM, whether the launch stages (1) or
// marches by the direct fetch alone (0), local memory per thread (bytes:
// spills), of the launch of faces of S x S rays and P planes on grids of
// side n and nl in bf16 or f32
extern "C" int mv_sweep_info(int S, int P, int n, int nl, int is_bf16,
                             int* out) {
  cudaError_t err;
  if (stages(S, n, nl, is_bf16))
    err = info<__nv_bfloat16, true>(P, out);
  else
    err = is_bf16 ? info<__nv_bfloat16, false>(P, out)
                  : info<float, false>(P, out);
  return (int)err;
}

extern "C" const char* mv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
