// Deferred shade of the opaque mesh (B8).
//
// Replaces no TPU kernel: the JAX package leaves the shade to XLA, which
// fuses it into its jitted frame (`multivolumes_tpu/render/mesh.py:640`
// `_interp_planes`, `:889` `shade_base_pass`). Eager PyTorch dispatched it
// as about 590 small tensor operations a frame, and the frame is bound by
// the host's dispatch, so one entry point with two launches takes their
// place. Plain version: `render/mesh.py:_shader` (through `shade_plain`).
//
//   * `mesh_planes_kernel`, one thread a triangle: its screen-affine
//     interpolation planes (`_triangle_planes`): vertex 0's pixel position,
//     the values {pos/w (3), nrm/w (3), 1/w} there and their d/dx and
//     d/dy, a row of 23 floats padded to 24, so a row is six 16-byte
//     loads;
//   * `mesh_shade_kernel`, one thread an output pixel of a rectangle of
//     the screen: the winning triangle's planes at the pixel centre and
//     the perspective divide (`_interp_planes`), the world, shadow,
//     current and previous clip transforms (`_pt_soa`, `_vec_soa`), then
//     `shade_base_pass`: the 2 x 2 PCF compare, N, V and H, the SH
//     irradiance and radiance with Karis's env BRDF (or the hemispheric
//     ambient without a light probe), Fresnel, pow(no_h, 64) and the
//     velocity. It writes r, g, b, vx, vy and `valid`; an empty pixel
//     (id -1) gets 0 and false, as the plain version's mask gives.
//
// The rectangle: rows [row_base + r0, ... + rh) and columns [col_base +
// c0, ... + rw), where r0 (c0) is 0 or, given a window centre (a device
// scalar), the start of `render/mesh.py:window_index`: round half to even
// of c - win / 2, clamped into [0, extent - win], read on the device. The
// output is the rectangle (rh, rw) or, with `paste`, the full screen
// (H, W), 0 and false outside the rectangle. The per-frame constants
// (world @ shadow view-proj, the unit light direction, the light and
// ambient colours, the SH coefficients) are formed by each CTA in shared
// memory from the raw operands, never read on the host.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics, which nvcc never contracts into an FMA, in the plain
// version's order, each rounded where PyTorch rounds it (one ATen launch
// an operation): the light-clip z that the PCF compares with the shadow
// map, the floor of the tap origins, the clamps and the plane divide all
// round as there. A Python scalar enters as the f32 PyTorch converts it
// to (`(float)` of the double); 1 / x is `reciprocal` (`__frcp_rn`), a
// tensor over a tensor an IEEE division. `rsqrtf`, `exp2f` and `powf`
// stand where the plain version calls torch.rsqrt, torch.exp2 and
// torch.pow (ATen's CUDA kernels call the same functions). world @
// shadow view-proj, a cuBLAS product in the plain version, is a chain of
// FMAs in k order; the light direction's norm the sum of the three
// squares in order. min, max and clamp pass NaN on as PyTorch's.
//
// What bounds it on the card: device memory. A shaded pixel reads its id
// (8 bytes), a 96-byte plane row (92 of them used) and 4 shadow-map taps,
// about 120 bytes, and writes 21 (5 f32 and a bool): at 2560 x 1440, with
// every pixel shaded, 0.52 GB, 0.15 ms at 3.35 TB/s. An empty pixel reads
// its id and writes 21 bytes. The operations, about 400 f32 a shaded
// pixel, take a tenth of that at 67 TFLOP/s. Design: 32 x 8 threads a
// CTA, a row of 32 pixels a warp, so the id loads and the five field
// stores coalesce; the plane rows are gathered as float4 (neighbours
// mostly share a triangle, so most hit in L1); the shadow map (4 MB at
// 1024^2) stays in L2. A CTA with no covered pixel in the rectangle
// stores its zeros and returns before it sets up the constants.

#include "common.cuh"

namespace {

constexpr int kTx = 32, kTy = 8;   // a CTA's pixels: 32 columns x 8 rows
constexpr int kPlaneRow = 24;      // floats a triangle's plane row

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.minimum / clamp: NaN passes through
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ((a0 b0 + a1 b1) + a2 b2), each product and sum rounded
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// Python scalars of the plain version, as PyTorch converts them to f32
constexpr double kPi = 3.141592653589793;   // np.pi
// Karis's env BRDF at roughness 0.4: rough * c0 + c1, each step a double
constexpr double kRv0m = 0.4 * -1.0, kRv0 = kRv0m + 1.0;
constexpr double kRv1m = 0.4 * -0.0275, kRv1 = kRv1m + 0.0425;
constexpr double kRv2m = 0.4 * -0.572, kRv2 = kRv2m + 1.04;
constexpr double kRv3m = 0.4 * 0.022, kRv3 = kRv3m + -0.04;
constexpr double kRv0Sq = kRv0 * kRv0;
// SH irradiance (`sh.eval_irradiance_soa`) and basis constants
constexpr double kC1 = 0.429043, kC2 = 0.511664, kC3 = 0.247708;
constexpr double kC4 = 0.886227;
constexpr double kTwoC1 = 2.0 * kC1, kTwoC2 = 2.0 * kC2;
constexpr double kY0 = 0.28209479177387814, kY1 = 0.4886025119029199;
constexpr double kY4 = 1.0925484305920792, kY6 = 0.31539156525252005;
constexpr double kY8 = 0.5462742152960396;
constexpr double kSpecRef = 0.08, kOneMinusSpecRef = 1.0 - kSpecRef;

__device__ __forceinline__ float f(double x) { return (float)x; }

// the start of `window_index(c, win, extent)`
__device__ __forceinline__ int window_start(const float* c, int win,
                                            int extent) {
  const float s = tclamp(rintf(sub(*c, 0.5f * (float)win)), 0.0f,
                         (float)(extent - win));
  return isnan(s) ? 0 : (int)s;
}

struct PlaneArgs {
  const float* clip;          // (V, 4) jittered clip positions
  const float* verts;         // (V, vs): position (3), normal (3), ...
  const long long* idx;       // (T, 3)
  float* planes;              // (T, 24) out
  int T, vs;
  float width, height;
};

// `_triangle_planes`, one triangle a thread
__global__ void __launch_bounds__(256) mesh_planes_kernel(const PlaneArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.T) return;
  float p[3][9];   // per vertex: px, py, pos/w (3), nrm/w (3), 1/w
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long v = a.idx[(size_t)t * 3 + k];
    const float* c = a.clip + v * 4;
    const float* vt = a.verts + v * a.vs;
    const float w = tclamp_min(c[3], 1e-20f);
    p[k][0] = mul(add(mul(div(c[0], w), 0.5f), 0.5f), a.width);
    p[k][1] = mul(sub(0.5f, mul(div(c[1], w), 0.5f)), a.height);
    const float iw = __frcp_rn(w);
#pragma unroll
    for (int i = 0; i < 6; ++i) p[k][2 + i] = mul(vt[i], iw);
    p[k][8] = iw;
  }
  const float x0 = p[0][0], y0 = p[0][1];
  const float dx1 = sub(p[1][0], x0), dy1 = sub(p[1][1], y0);
  const float dx2 = sub(p[2][0], x0), dy2 = sub(p[2][1], y0);
  const float area = sub(mul(dx1, dy2), mul(dx2, dy1));
  const float inv_area = fabsf(area) > 1e-12f ? __frcp_rn(area) : 0.0f;
  float row[kPlaneRow];
  row[0] = x0;
  row[1] = y0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const float a0 = p[0][2 + i];
    const float e1 = sub(p[1][2 + i], a0), e2 = sub(p[2][2 + i], a0);
    row[2 + i] = a0;
    row[9 + i] = mul(sub(mul(e1, dy2), mul(e2, dy1)), inv_area);
    row[16 + i] = mul(sub(mul(e2, dx1), mul(e1, dx2)), inv_area);
  }
  row[23] = 0.0f;
  float4* out = reinterpret_cast<float4*>(a.planes + (size_t)t * kPlaneRow);
#pragma unroll
  for (int q = 0; q < kPlaneRow / 4; ++q)
    out[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                         row[4 * q + 3]);
}

struct ShadeArgs {
  const long long* tri;       // (th, tw) winning ids of screen rows
                              // [tri_row0, tri_row0 + th), -1 empty
  const float* planes;        // (T, 24)
  const float* world;         // (4, 4) each, row-vector convention
  const float* s_vp;
  const float* wvp;
  const float* prev_wvp;
  const float* eye;           // (3,)
  const float* light_pos;     // (>= 3,)
  const float* light_color;   // (4,) rgb + intensity
  const float* ambient;       // (4,) rgb + intensity
  const float* sh;            // (9, 3)
  const float* shadow;        // (sm_h, sm_w) light-view clip z
  const float* cy;            // window centre row / column, or null
  const float* cx;
  float* out;                 // (5, out_h, out_w): r, g, b, vx, vy
  unsigned char* valid;       // (out_h, out_w)
  int T, th, tw, tri_row0;
  int row_base, col_base, rh, rw, win, H, W;
  int out_h, out_w, paste, probe, sm_h, sm_w;
};

// the per-frame constants a CTA forms in shared memory
enum {
  kWorld = 0, kShadow = 16, kWvp = 32, kPrev = 48, kEye = 64, kLight = 67,
  kLcol = 70, kAmb = 73, kSh = 76, kConsts = 76 + 27
};

// `_shadow_map_compare`: the 2 x 2 PCF at light-clip (lsx, lsy, lsz)
__device__ __forceinline__ float pcf(const ShadeArgs& a, float lsx, float lsy,
                                     float lsz) {
  const float z = sub(lsz, f(0.0027));
  const int h = a.sm_h, w = a.sm_w;
  const float x = sub(mul(add(mul(lsx, 0.5f), 0.5f), (float)w), 0.5f);
  const float y =
      sub(mul(sub(1.0f, add(mul(lsy, 0.5f), 0.5f)), (float)h), 0.5f);
  // clamp before and after the cast, as the plain version (a NaN casts
  // to 0 on the card)
  const float fxl = tclamp(floorf(x), -1.0f, (float)w);
  const float fyl = tclamp(floorf(y), -1.0f, (float)h);
  const int x0 = min(max(isnan(fxl) ? 0 : (int)fxl, 0), w - 2);
  const int y0 = min(max(isnan(fyl) ? 0 : (int)fyl, 0), h - 2);
  const float fx = tclamp(sub(x, (float)x0), 0.0f, 1.0f);
  const float fy = tclamp(sub(y, (float)y0), 0.0f, 1.0f);
  const float* r0 = a.shadow + (size_t)y0 * w + x0;
  const float* r1 = r0 + w;
  const float l00 = z <= r0[0] ? 1.0f : 0.0f, l01 = z <= r0[1] ? 1.0f : 0.0f;
  const float l10 = z <= r1[0] ? 1.0f : 0.0f, l11 = z <= r1[1] ? 1.0f : 0.0f;
  const float gx = sub(1.0f, fx);
  const float c0 = add(mul(l00, gx), mul(l01, fx));
  const float c1 = add(mul(l10, gx), mul(l11, fx));
  return add(mul(c0, sub(1.0f, fy)), mul(c1, fy));
}

// `sh.eval_irradiance_soa`, one channel
__device__ __forceinline__ float irradiance(const float* L, int ch, float x,
                                            float y, float z) {
  const float l0 = L[ch], l1 = L[3 + ch], l2 = L[6 + ch], l3 = L[9 + ch];
  const float l4 = L[12 + ch], l5 = L[15 + ch], l6 = L[18 + ch];
  const float l7 = L[21 + ch], l8 = L[24 + ch];
  const float t8 = mul(mul(f(kC1), sub(mul(x, x), mul(y, y))), l8);
  const float t6 = mul(mul(f(kC3), sub(mul(mul(3.0f, z), z), 1.0f)), l6);
  const float t0 = mul(f(kC4), l0);
  const float q2 = mul(f(kTwoC1),
                       add(add(mul(mul(l4, x), y), mul(mul(l7, x), z)),
                           mul(mul(l5, y), z)));
  const float q1 = mul(f(kTwoC2), add(add(mul(l3, x), mul(l1, y)),
                                      mul(l2, z)));
  return tclamp_min(add(add(add(add(t8, t6), t0), q2), q1), 0.0f);
}

// `sh.eval_radiance_soa`: the band-limited radiance, three channels
__device__ __forceinline__ void radiance(const float* L, float x, float y,
                                         float z, float out[3]) {
  const float ys[9] = {
      f(kY0), mul(f(kY1), y), mul(f(kY1), z), mul(f(kY1), x),
      mul(mul(f(kY4), x), y), mul(mul(f(kY4), y), z),
      mul(f(kY6), sub(mul(mul(3.0f, z), z), 1.0f)), mul(mul(f(kY4), x), z),
      mul(f(kY8), sub(mul(x, x), mul(y, y)))};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = mul(ys[0], L[ch]);
#pragma unroll
    for (int k = 1; k < 9; ++k) acc = add(acc, mul(ys[k], L[3 * k + ch]));
    out[ch] = tclamp_min(acc, 0.0f);
  }
}

__device__ __forceinline__ void store(const ShadeArgs& a, size_t o,
                                      const float v[5], bool ok) {
  const size_t n = (size_t)a.out_h * a.out_w;
#pragma unroll
  for (int i = 0; i < 5; ++i) a.out[i * n + o] = v[i];
  a.valid[o] = ok;
}

__global__ void __launch_bounds__(kTx * kTy)
    mesh_shade_kernel(const ShadeArgs a) {
  __shared__ float c[kConsts];
  const int ox = blockIdx.x * kTx + threadIdx.x;
  const int oy = blockIdx.y * kTy + threadIdx.y;
  const int ry0 = a.row_base + (a.cy ? window_start(a.cy, a.win, a.H) : 0);
  const int rx0 = a.col_base + (a.cx ? window_start(a.cx, a.win, a.W) : 0);
  // the screen pixel of this output pixel, and whether the rectangle
  // holds it
  const int y = a.paste ? oy : ry0 + oy, x = a.paste ? ox : rx0 + ox;
  const bool in_out = ox < a.out_w && oy < a.out_h;
  const bool in_rect = y >= ry0 && y < ry0 + a.rh && x >= rx0 &&
                       x < rx0 + a.rw;
  const int ty = y - a.tri_row0;
  long long tri = -1;
  if (in_out && in_rect && ty >= 0 && ty < a.th && x >= 0 && x < a.tw)
    tri = a.tri[(size_t)ty * a.tw + x];
  const size_t o = (size_t)oy * a.out_w + ox;
  const float zero[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (!__syncthreads_or(tri >= 0)) {
    if (in_out) store(a, o, zero, false);
    return;
  }

  // the per-frame constants
  const int tid = threadIdx.y * kTx + threadIdx.x;
  if (tid < 16) {
    const int r = tid >> 2, col = tid & 3;
    c[kWorld + tid] = a.world[tid];
    c[kWvp + tid] = a.wvp[tid];
    c[kPrev + tid] = a.prev_wvp[tid];
    // (world @ s_vp)[r, col]
    float acc = mul(a.world[r * 4], a.s_vp[col]);
#pragma unroll
    for (int k = 1; k < 4; ++k)
      acc = fmaf(a.world[r * 4 + k], a.s_vp[k * 4 + col], acc);
    c[kShadow + tid] = acc;
  } else if (tid == 32) {
    const float lx = a.light_pos[0], ly = a.light_pos[1],
                lz = a.light_pos[2];
    const float n = __fsqrt_rn(dot3(lx, ly, lz, lx, ly, lz));
    c[kLight] = div(lx, n);
    c[kLight + 1] = div(ly, n);
    c[kLight + 2] = div(lz, n);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c[kEye + i] = a.eye[i];
      c[kLcol + i] = mul(a.light_color[i], a.light_color[3]);
      c[kAmb + i] = mul(a.ambient[i], a.ambient[3]);
    }
  } else if (tid >= 64 && tid < 64 + 27) {
    c[kSh + tid - 64] = a.sh[tid - 64];
  }
  __syncthreads();
  if (!in_out) return;
  if (tri < 0) {
    store(a, o, zero, false);
    return;
  }

  // `_interp_planes`
  const long long t = min(tri, (long long)a.T - 1);
  const float4* rp =
      reinterpret_cast<const float4*>(a.planes + (size_t)t * kPlaneRow);
  float row[kPlaneRow];
#pragma unroll
  for (int q = 0; q < kPlaneRow / 4; ++q) {
    const float4 v = __ldg(rp + q);
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
  const float dx = sub(add((float)x, 0.5f), row[0]);
  const float dy = sub(add((float)y, 0.5f), row[1]);
  float pv[7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
    pv[i] = add(add(row[2 + i], mul(row[9 + i], dx)), mul(row[16 + i], dy));
  const float inv_w = __frcp_rn(tclamp_min(pv[6], 1e-20f));
  const float px = mul(pv[0], inv_w), py = mul(pv[1], inv_w),
              pz = mul(pv[2], inv_w);
  const float qx = mul(pv[3], inv_w), qy = mul(pv[4], inv_w),
              qz = mul(pv[5], inv_w);

  // `_pt_soa` / `_vec_soa` of one matrix column
  auto pt = [&](int m, int col) {
    return add(add(add(mul(px, c[m + col]), mul(py, c[m + 4 + col])),
                   mul(pz, c[m + 8 + col])), c[m + 12 + col]);
  };
  const float wsx = pt(kWorld, 0), wsy = pt(kWorld, 1), wsz = pt(kWorld, 2);
  float n[3];
#pragma unroll
  for (int col = 0; col < 3; ++col)
    n[col] = add(add(mul(qx, c[kWorld + col]), mul(qy, c[kWorld + 4 + col])),
                 mul(qz, c[kWorld + 8 + col]));
  const float shadow = pcf(a, pt(kShadow, 0), pt(kShadow, 1),
                           pt(kShadow, 2));
  const float csx = pt(kWvp, 0), csy = pt(kWvp, 1);
  const float csw = tclamp_min(pt(kWvp, 3), 1e-20f);
  const float tsx = pt(kPrev, 0), tsy = pt(kPrev, 1);
  const float tsw = tclamp_min(pt(kPrev, 3), 1e-20f);

  // `shade_base_pass`
  const float ninv = rsqrtf(tclamp_min(dot3(n[0], n[1], n[2], n[0], n[1],
                                            n[2]), 1e-20f));
  const float nx = mul(n[0], ninv), ny = mul(n[1], ninv),
              nz = mul(n[2], ninv);
  const float vel_x = mul(sub(div(csx, csw), div(tsx, tsw)), 0.5f);
  const float vel_y = mul(sub(div(csy, csw), div(tsy, tsw)), -0.5f);
  const float l0 = c[kLight], l1 = c[kLight + 1], l2 = c[kLight + 2];
  const float no_l = tclamp(dot3(nx, ny, nz, l0, l1, l2), 0.0f, 1.0f);
  float vx = sub(c[kEye], wsx), vy = sub(c[kEye + 1], wsy),
        vz = sub(c[kEye + 2], wsz);
  const float vinv = rsqrtf(tclamp_min(dot3(vx, vy, vz, vx, vy, vz), 1e-20f));
  vx = mul(vx, vinv);
  vy = mul(vy, vinv);
  vz = mul(vz, vinv);
  const float vn = dot3(nx, ny, nz, vx, vy, vz);
  const float no_v = tclamp(vn, 0.0f, 1.0f);
  const float hx = add(vx, l0), hy = add(vy, l1), hz = add(vz, l2);
  const float hinv = rsqrtf(tclamp_min(dot3(hx, hy, hz, hx, hy, hz), 1e-20f));
  const float no_h = tclamp(mul(dot3(nx, ny, nz, hx, hy, hz), hinv), 0.0f,
                            1.0f);
  float amb[3], rad[3];
  if (a.probe) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      amb[ch] = irradiance(c + kSh, ch, nx, ny, nz);
    const float rx = sub(mul(mul(2.0f, vn), nx), vx);
    const float ry = sub(mul(mul(2.0f, vn), ny), vy);
    const float rz = sub(mul(mul(2.0f, vn), nz), vz);
    radiance(c + kSh, rx, ry, rz, rad);
    const float a004 = add(
        mul(tmin(f(kRv0Sq), exp2f(mul(f(-9.28), no_v))), f(kRv0)), f(kRv1));
    const float env = add(mul(f(0.04), add(mul(f(-1.04), a004), f(kRv2))),
                          add(mul(f(1.04), a004), f(kRv3)));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rad[ch] = mul(rad[ch], env);
  } else {
    const float scale = add(0.5f, mul(0.5f, add(mul(ny, 0.5f), 0.5f)));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      amb[ch] = mul(c[kAmb + ch], scale);
      rad[ch] = 0.0f;
    }
  }
  const float fresnel = powf(sub(1.0f, no_v), 5.0f);
  const float fres = add(mul(fresnel, f(kOneMinusSpecRef)), f(kSpecRef));
  const float spec = mul(powf(no_h, 64.0f), fres);
  const double brdf[3] = {1.0 / kPi, 0.6 / kPi, 0.2 / kPi};
  float v[5];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float d = f(brdf[ch]);
    v[ch] = add(add(mul(add(mul(d, no_l), spec), mul(c[kLcol + ch], shadow)),
                    mul(d, amb[ch])), rad[ch]);
  }
  v[3] = vel_x;
  v[4] = vel_y;
  store(a, o, v, true);
}

}  // namespace

// The deferred shade of one rectangle of the screen (see the top of the
// file). clip (V, 4) f32; verts (V, vs) f32; idx (T, 3) i64; planes (T,
// 24) f32 scratch; tri (th, tw) i64; the four matrices (4, 4) f32; eye
// (3,), light_pos (>= 3,), light_color (4,), ambient (4,), sh (9, 3),
// shadow (sm_h, sm_w) f32; cy, cx 0-d f32 or null; out (5, out_h, out_w)
// f32 and valid (out_h, out_w) u8, written whole. All contiguous.
extern "C" int mv_mesh_shade(
    const void* clip, const void* verts, const void* idx, void* planes,
    const void* tri, const void* world, const void* s_vp, const void* wvp,
    const void* prev_wvp, const void* eye, const void* light_pos,
    const void* light_color, const void* ambient, const void* sh,
    const void* shadow, const void* cy, const void* cx, void* out,
    void* valid, int T, int vs, int th, int tw, int tri_row0, int row_base,
    int col_base, int rh, int rw, int win, int H, int W, int out_h,
    int out_w, int paste, int probe, int sm_h, int sm_w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const PlaneArgs p{(const float*)clip, (const float*)verts,
                    (const long long*)idx, (float*)planes, T, vs, (float)W,
                    (float)H};
  mesh_planes_kernel<<<(T + 255) / 256, 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (out_h == 0 || out_w == 0) return 0;
  const ShadeArgs a{(const long long*)tri, (const float*)planes,
                    (const float*)world, (const float*)s_vp,
                    (const float*)wvp, (const float*)prev_wvp,
                    (const float*)eye, (const float*)light_pos,
                    (const float*)light_color, (const float*)ambient,
                    (const float*)sh, (const float*)shadow,
                    (const float*)cy, (const float*)cx, (float*)out,
                    (unsigned char*)valid, T, th, tw, tri_row0, row_base,
                    col_base, rh, rw, win, H, W, out_h, out_w, paste, probe,
                    sm_h, sm_w};
  const dim3 grid((out_w + kTx - 1) / kTx, (out_h + kTy - 1) / kTy);
  mesh_shade_kernel<<<grid, dim3(kTx, kTy), 0, st>>>(a);
  return (int)cudaGetLastError();
}
