// The light cohort update around B3 / B4: B10, the prologue (two
// launches), and B11, the epilogue.
//
// Replaces no TPU kernel: the JAX package computes this glue in XLA inside
// its jitted frame (`multivolumes_tpu/render/lightsweep.py`,
// `light_transmittance`, `_shadow_entry`, `_shade_light_fields`), fused
// by the compiler. Eager PyTorch dispatched it as about 350 small tensor
// operations a frame, and the frame is bound by the host's dispatch, so
// three launches take their place. Plain version: `render/lightsweep.py`
// (`light_transmittance`, `_shadow_entry`, `_shade_light_fields` and the
// frame's stores), which the wrappers in `ops/lightsweep_prep.py` keep for
// CPU tensors.
//
// B10a `light_prologue_kernel` (before B3), a CTA row per cohort volume:
//   * every CTA derives the shear geometry of all N volumes (the local
//     light direction, the slopes, the entry and exit planes) and reduces
//     the global lateral bounds lo_u .. span_v over them in shared memory;
//   * the cohort volume's du, dv, f_corr, flip flag and, with the mesh's
//     shadow map, dz_slice and soft;
//   * the cohort's density oriented sweep-major (the flip, the permute and
//     the contiguous copy of rho_light[tex]), B3's rho_o;
//   * with the shadow map, sm_vol and z_entry on the cohort's entry plane:
//     the 4-tap read of the map on the global (G, G) lateral grid, then
//     the entry plane's 2 x 2 resample taps, evaluated as the plain
//     version's two matrix products accumulate them (see Rounding);
//   * CTA (0, c) writes the cohort row of the table B10b reads; CTA (0, 0)
//     also each volume's light rank, counted (no argsort), its exit-plane
//     resample and its cohort slot.
// B10b `light_occlusion_kernel` (after B3, before B4), a thread per texel of
// t_ins (C, L, L): each texel takes its <= 2 x 2 taps of g_in, and each
// g_in texel is the product, over the volumes ahead of the cohort volume
// in light order, of fac = o + (1 - cover), o the 2 x 2 tent sample of
// that volume's s_out (the cohort's own from B3, the others' from the
// cache), zero outside its footprint. No (N, G, G) tensor is formed. It
// also stores B3's s_out rows into the footprint cache.
// B11 `light_epilogue_kernel` (after B4), a thread a voxel: reads B4's
// output at the un-flipped, un-permuted index, shades it (SH irradiance
// with AO, or the flat ambient, plus the light colour) and writes the f32
// light-map rows and the sweep stack's (L, L, L, 4) rows (fourth channel
// 0) in place.
//
// Rounding: where the plain version is elementwise (the geometry scalars,
// the taps and weights, cover, fac, the shadow-map read, the shade, both
// stores) every value is computed in its order of operations, each
// operation rounded on its own (`__fmul_rn`, `__fadd_rn`, IEEE division),
// never contracted. PyTorch's CUDA kernels divide by a host scalar as a
// product with its reciprocal (taken in double precision, then rounded:
// the wrapper passes them), and `scalar / tensor` is
// `tensor.reciprocal() * scalar`; both are done so here. `rsqrtf` stands
// where the plain version calls torch.rsqrt; min, max and clamp pass NaN
// on as PyTorch's. Where the plain version is a matrix product whose
// operands hold two non-zeros a row (o_big, t_ins, sm_vol, z_vol), the two
// terms are accumulated in ascending index order with one fused
// multiply-add, as a GEMM's main loop does. The library's order is not
// fixed (at a cohort of one it splits the 192-deep sums, so two taps that
// straddle a split round as two products), so those are held to a
// tolerance, and the product over the volumes ahead is taken in light
// order (the plain cumulative product's).
//
// What bounds it on the card: bytes. At C = 1 and L = 96 B10a moves the
// cohort's density twice (7 MB), B11 reads B4's output, density, AO and
// the normals and writes the two map rows (39 MB); B10b's taps read the
// footprint cache (2.4 MB at N = 64) from L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 1024;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / minimum / clamp: NaN passes through
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// where(|d| > eps, d, where(d >= 0, eps, -eps))
__device__ __forceinline__ float safe(float d) {
  return fabsf(d) > 1e-6f ? d : (d >= 0.0f ? 1e-6f : -1e-6f);
}

// torch.sign
__device__ __forceinline__ float tsign(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

// One volume's shear geometry, before the global bounds
struct Vol {
  float lu, lv, lw;          // unit local light direction on (u, v, w)
  float cu, cv, s;           // centre on u, v; scale
  float key;                 // -proj: the sort key of light order
  float sgn, w_in;
  float ru_in, rv_in, ru_out, rv_out;   // cu_ref_in .. cv_ref_out
};

struct Bounds {
  float lo_u, lo_v, span_u, span_v;
};

struct PrologueArgs {
  const float* rho;         // (N_src, L, L, L) density at the light grid
  const long long* tex;     // (N,) vol_tex_ids
  const long long* sub;     // (C,) the cohort
  const float* world;       // (N, 4, 4)
  const float* world_i;     // (N, 4, 4)
  const float* light_dir;   // (3,) unit, toward the light
  const float* shadow;      // (Hs, Ws) light-view clip depth, or null
  const float* vp;          // (4, 4) its view-proj
  float* rho_o;             // (C, L, L, L) sweep-major
  float* scal;              // (6, C): du, dv, f_corr, dz_slice, soft, flip
  float* entry;             // (2, C, L, L): sm_vol, z_entry
  float* table;             // see Table
  int N, C, L, axis, Hs, Ws, blocks;
  float dt_num;             // float(2.0 / L)
  float inv_step;           // float(1.0 / step_scale)
  float inv_l, inv_g;       // float(1.0 / L), float(1.0 / (2 L))
  float bias;               // float(shadow_bias)
};

// The table B10a leaves for B10b: per volume (su, sv, ou_o, ov_o, slot)
// in volume order, the volume of each light rank, and per cohort volume
// (su, ou, sv, ov, rank). Ints are stored as their float bits.
struct Table {
  float* t;
  int N, C;
  __device__ float* vol(int j) const { return t + 5 * j; }
  __device__ float* order() const { return t + 5 * N; }
  __device__ float* coh(int c) const { return t + 6 * N + 5 * c; }
};

__device__ Vol load_vol(const float* world, const float* world_i,
                        const float* ld, int axis, int i) {
  const float* wi = world_i + 16 * i;
  const float* w = world + 16 * i;
  const float l0 = ld[0], l1 = ld[1], l2 = ld[2];
  float lx = add(add(mul(l0, wi[0]), mul(l1, wi[4])), mul(l2, wi[8]));
  float ly = add(add(mul(l0, wi[1]), mul(l1, wi[5])), mul(l2, wi[9]));
  float lz = add(add(mul(l0, wi[2]), mul(l1, wi[6])), mul(l2, wi[10]));
  const float nrm = rsqrtf(
      tmax(add(add(mul(lx, lx), mul(ly, ly)), mul(lz, lz)), 1e-20f));
  lx = mul(lx, nrm);
  ly = mul(ly, nrm);
  lz = mul(lz, nrm);
  const float c0 = w[12], c1 = w[13], c2 = w[14];
  Vol v;
  v.s = w[0];
  v.key = -add(add(mul(c0, l0), mul(c1, l1)), mul(c2, l2));
  float cw;
  if (axis == 0) {         // sweep x; lateral (v=y, u=z)
    v.lu = lz; v.lv = ly; v.lw = lx; v.cu = c2; v.cv = c1; cw = c0;
  } else if (axis == 1) {  // sweep y; lateral (v=z, u=x)
    v.lu = lx; v.lv = lz; v.lw = ly; v.cu = c0; v.cv = c2; cw = c1;
  } else {                 // sweep z; lateral (v=y, u=x)
    v.lu = lx; v.lv = ly; v.lw = lz; v.cu = c0; v.cv = c1; cw = c2;
  }
  const float dw_safe = safe(-v.lw);
  const float slope_u = div(-v.lu, dw_safe);
  const float slope_v = div(-v.lv, dw_safe);
  v.sgn = tsign(dw_safe);
  v.w_in = sub(cw, mul(v.sgn, v.s));
  const float w_out = add(cw, mul(v.sgn, v.s));
  v.ru_in = sub(v.cu, mul(slope_u, v.w_in));
  v.rv_in = sub(v.cv, mul(slope_v, v.w_in));
  v.ru_out = sub(v.cu, mul(slope_u, w_out));
  v.rv_out = sub(v.cv, mul(slope_v, w_out));
  return v;
}

// (2.0 * scales / l): the slice pitch in world units (inv_l = 1 / l)
__device__ __forceinline__ float pitch(float s, float inv_l) {
  return mul(mul(2.0f, s), inv_l);
}

// su (u) or sv (v): ((2 s / l) * (g / span))
__device__ __forceinline__ float res_scale(float s, float inv_l, int L,
                                           float span) {
  const int G = 2 * L;
  return mul(pitch(s, inv_l), mul(div(1.0f, span), (float)G));
}

// ou / ov (entry, ref = ru_in) or ou_o / ov_o (exit, ref = ru_out):
// ((ref - s - lo) / span) * g - 0.5 + 0.5 * scale
__device__ __forceinline__ float res_offset(float ref, float s, float lo,
                                            float span, float scale, int L) {
  const int G = 2 * L;
  return add(sub(mul(div(sub(sub(ref, s), lo), span), (float)G), 0.5f),
             mul(0.5f, scale));
}

// The light rank: stable ascending order of the keys (NaN last)
__device__ __forceinline__ bool before(float kj, int j, float ki, int i) {
  const bool ni = isnan(ki), nj = isnan(kj);
  if (ni || nj) return nj ? (ni && j < i) : true;
  return kj < ki || (kj == ki && j < i);
}

__device__ int light_rank(const float* keys, int N, int i) {
  int r = 0;
  for (int j = 0; j < N; ++j) r += before(keys[j], j, keys[i], i);
  return r;
}

// Tent taps of one row of `_resample_matrix`: src = clamp(i * scale +
// offset, 0, n - 1), weights clamp(1 - |src - col|, 0) at floor(src) and
// the next column (absent past n - 1).
struct Taps {
  int i0;
  bool two;
  float w0, w1;
};

__device__ __forceinline__ float tent(float src, int col) {
  return fmaxf(sub(1.0f, fabsf(sub(src, (float)col))), 0.0f);
}

__device__ __forceinline__ Taps entry_taps(int i, float scale, float offset,
                                           int n) {
  const float src = tclamp(add(mul((float)i, scale), offset), 0.0f,
                           (float)(n - 1));
  Taps t;
  t.i0 = (int)floorf(src);
  t.two = t.i0 + 1 <= n - 1;
  t.w0 = tent(src, t.i0);
  t.w1 = t.two ? tent(src, t.i0 + 1) : 0.0f;
  return t;
}

// The same row evaluated as a sum of the two products, a GEMM's order:
// the first term rounded, the second fused into it.
__device__ __forceinline__ float dot2(const Taps& t, float x0, float x1) {
  const float acc = mul(t.w0, x0);
  return t.two ? __fmaf_rn(t.w1, x1, acc) : acc;
}

// The shadow map's bilinear read (clamped taps) + bias at global lateral
// texel (g, h), and the texel's light-space depth on the reference plane.
struct Grid {
  float lo_u, lo_v, span_u, span_v, inv_g;
  int axis;
  const float* m;
  const float* sm;
  int Hs, Ws;
  float bias;
};

__device__ __forceinline__ int cidx(float v, int n) {
  const long long k = (long long)tclamp(v, -1.0f, (float)n);
  return (int)min(max(k, 0LL), (long long)(n - 1));
}

__device__ void grid_sample(const Grid& q, int g, int h, float* smg,
                            float* z0g) {
  const float ar_h = mul(add((float)h, 0.5f), q.inv_g);
  const float ar_g = mul(add((float)g, 0.5f), q.inv_g);
  const float u_w = add(q.lo_u, mul(ar_h, q.span_u));
  const float v_w = add(q.lo_v, mul(ar_g, q.span_v));
  float px, py, pz;
  if (q.axis == 0) {
    px = 0.0f; py = v_w; pz = u_w;
  } else if (q.axis == 1) {
    px = u_w; py = 0.0f; pz = v_w;
  } else {
    px = u_w; py = v_w; pz = 0.0f;
  }
  const float* m = q.m;
  const float su = add(add(add(mul(px, m[0]), mul(py, m[4])), mul(pz, m[8])),
                       m[12]);
  const float sv = add(add(add(mul(px, m[1]), mul(py, m[5])), mul(pz, m[9])),
                       m[13]);
  *z0g = add(add(add(mul(px, m[2]), mul(py, m[6])), mul(pz, m[10])), m[14]);
  const float xs = sub(mul(add(mul(su, 0.5f), 0.5f), (float)q.Ws), 0.5f);
  const float ys = sub(mul(sub(1.0f, add(mul(sv, 0.5f), 0.5f)), (float)q.Hs),
                       0.5f);
  const float x0f = floorf(xs), y0f = floorf(ys);
  const float fx = sub(xs, x0f), fy = sub(ys, y0f);
  const int xa = cidx(x0f, q.Ws), xb = cidx(add(x0f, 1.0f), q.Ws);
  const int ya = cidx(y0f, q.Hs), yb = cidx(add(y0f, 1.0f), q.Hs);
  const float* rowa = q.sm + (size_t)ya * q.Ws;
  const float* rowb = q.sm + (size_t)yb * q.Ws;
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
  const float sm0 = add(mul(rowa[xa], gx), mul(rowa[xb], fx));
  const float sm1 = add(mul(rowb[xa], gx), mul(rowb[xb], fx));
  *smg = add(add(mul(sm0, gy), mul(sm1, fy)), q.bias);
}

__device__ void block_bounds(const PrologueArgs& a, float* keys,
                             Bounds* out) {
  __shared__ float red[4][kThreads / 32];
  float lo_u = INFINITY, lo_v = INFINITY, hi_u = -INFINITY, hi_v = -INFINITY;
  bool nan_u = false, nan_v = false;
  for (int i = threadIdx.x; i < a.N; i += blockDim.x) {
    const Vol v = load_vol(a.world, a.world_i, a.light_dir, a.axis, i);
    keys[i] = v.key;
    const float u0 = sub(v.ru_in, v.s), u1 = sub(v.ru_out, v.s);
    const float u2 = add(v.ru_in, v.s), u3 = add(v.ru_out, v.s);
    const float v0 = sub(v.rv_in, v.s), v1 = sub(v.rv_out, v.s);
    const float v2 = add(v.rv_in, v.s), v3 = add(v.rv_out, v.s);
    nan_u |= isnan(u0) || isnan(u1) || isnan(u2) || isnan(u3);
    nan_v |= isnan(v0) || isnan(v1) || isnan(v2) || isnan(v3);
    lo_u = fminf(lo_u, fminf(u0, u1));
    hi_u = fmaxf(hi_u, fmaxf(u2, u3));
    lo_v = fminf(lo_v, fminf(v0, v1));
    hi_v = fmaxf(hi_v, fmaxf(v2, v3));
  }
  // a NaN anywhere makes the plain reductions NaN
  if (nan_u) lo_u = hi_u = NAN;
  if (nan_v) lo_v = hi_v = NAN;
  for (int o = 16; o > 0; o >>= 1) {
    lo_u = tmin(lo_u, __shfl_xor_sync(0xffffffffu, lo_u, o));
    hi_u = tmax(hi_u, __shfl_xor_sync(0xffffffffu, hi_u, o));
    lo_v = tmin(lo_v, __shfl_xor_sync(0xffffffffu, lo_v, o));
    hi_v = tmax(hi_v, __shfl_xor_sync(0xffffffffu, hi_v, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = lo_u; red[1][warp] = hi_u;
    red[2][warp] = lo_v; red[3][warp] = hi_v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)blockDim.x / 32; ++w) {
      lo_u = tmin(lo_u, red[0][w]); hi_u = tmax(hi_u, red[1][w]);
      lo_v = tmin(lo_v, red[2][w]); hi_v = tmax(hi_v, red[3][w]);
    }
    out->lo_u = lo_u;
    out->lo_v = lo_v;
    out->span_u = tmax(sub(hi_u, lo_u), 1e-3f);
    out->span_v = tmax(sub(hi_v, lo_v), 1e-3f);
  }
}

// The cohort volume's operands, shared by a CTA row
struct Cohort {
  float su, ou, sv, ov;      // entry-plane resample
  float flip;
  float z_off;               // dzdw * w_in
  int tex;
};

__global__ void __launch_bounds__(kThreads)
light_prologue_kernel(PrologueArgs a) {
  __shared__ float keys[kMaxN];
  __shared__ Bounds bnd;
  __shared__ Cohort co;
  const int c = blockIdx.y;
  const int L = a.L, G = 2 * L;
  block_bounds(a, keys, &bnd);
  __syncthreads();
  const Table tab{a.table, a.N, a.C};
  if (threadIdx.x == 0) {
    const int i = (int)a.sub[c];
    const Vol v = load_vol(a.world, a.world_i, a.light_dir, a.axis, i);
    const float dwc = -v.lw;
    const float dw_abs = tmax(fabsf(dwc), 1e-6f);
    co.flip = dwc < 0.0f ? 1.0f : 0.0f;
    co.su = res_scale(v.s, a.inv_l, L, bnd.span_u);
    co.sv = res_scale(v.s, a.inv_l, L, bnd.span_v);
    co.ou = res_offset(v.ru_in, v.s, bnd.lo_u, bnd.span_u, co.su, L);
    co.ov = res_offset(v.rv_in, v.s, bnd.lo_v, bnd.span_v, co.sv, L);
    co.tex = (int)a.tex[i];
    float dz_slice = 0.0f, soft = 0.0f;
    co.z_off = 0.0f;
    if (a.shadow != nullptr) {
      const float* m = a.vp;
      const float d0 = -a.light_dir[0], d1 = -a.light_dir[1],
                  d2 = -a.light_dir[2];
      const float dz_dp = add(add(mul(d0, m[2]), mul(d1, m[6])),
                              mul(d2, m[10]));
      const float dir_w = a.axis == 0 ? d0 : (a.axis == 1 ? d1 : d2);
      const float dzdw = div(dz_dp, safe(dir_w));
      dz_slice = mul(mul(dzdw, v.sgn), pitch(v.s, a.inv_l));
      soft = tmax(fabsf(dz_slice), 1e-6f);
      co.z_off = mul(dzdw, v.w_in);
    }
    if (blockIdx.x == 0) {
      const int C = a.C;
      a.scal[c] = div(-v.lu, dw_abs);
      a.scal[C + c] = div(-v.lv, dw_abs);
      a.scal[2 * C + c] = mul(mul(div(1.0f, dw_abs), a.dt_num), a.inv_step);
      a.scal[3 * C + c] = dz_slice;
      a.scal[4 * C + c] = soft;
      a.scal[5 * C + c] = co.flip;
      float* t = tab.coh(c);
      t[0] = co.su; t[1] = co.ou; t[2] = co.sv; t[3] = co.ov;
      t[4] = __int_as_float(light_rank(keys, a.N, i));
    }
  }
  if (blockIdx.x == 0 && c == 0) {
    for (int j = threadIdx.x; j < a.N; j += blockDim.x) {
      const Vol v = load_vol(a.world, a.world_i, a.light_dir, a.axis, j);
      float* t = tab.vol(j);
      const float su = res_scale(v.s, a.inv_l, L, bnd.span_u);
      const float sv = res_scale(v.s, a.inv_l, L, bnd.span_v);
      t[0] = su;
      t[1] = sv;
      t[2] = res_offset(v.ru_out, v.s, bnd.lo_u, bnd.span_u, su, L);
      t[3] = res_offset(v.rv_out, v.s, bnd.lo_v, bnd.span_v, sv, L);
      int slot = -1;
      for (int k = 0; k < a.C; ++k)
        if (a.sub[k] == j) slot = k;
      t[4] = __int_as_float(slot);
      tab.order()[light_rank(keys, a.N, j)] = __int_as_float(j);
    }
  }
  __syncthreads();

  // the cohort's density, oriented sweep-major: out[k][v][u]
  const size_t vox = (size_t)L * L * L;
  const float* src = a.rho + (size_t)co.tex * vox;
  float* dst = a.rho_o + (size_t)c * vox;
  const bool flip = co.flip != 0.0f;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < vox;
       o += (size_t)a.blocks * blockDim.x) {
    const int u = (int)(o % L), v = (int)((o / L) % L), k = (int)(o / L / L);
    const int kk = flip ? L - 1 - k : k;
    size_t s;
    if (a.axis == 0) s = ((size_t)u * L + v) * L + kk;        // (z, y, x)
    else if (a.axis == 1) s = ((size_t)v * L + kk) * L + u;
    else s = ((size_t)kk * L + v) * L + u;
    dst[o] = src[s];
  }
  if (a.shadow == nullptr) return;

  // sm_vol and z_entry on the entry plane: mv_in @ X @ mu_in^T
  const Grid q{bnd.lo_u, bnd.lo_v, bnd.span_u, bnd.span_v, a.inv_g, a.axis,
               a.vp, a.shadow, a.Hs, a.Ws, a.bias};
  const size_t plane = (size_t)L * L;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < plane;
       o += (size_t)a.blocks * blockDim.x) {
    const int u = (int)(o % L), v = (int)(o / L);
    const Taps tv = entry_taps(v, co.sv, co.ov, G);
    const Taps tu = entry_taps(u, co.su, co.ou, G);
    float ts[2] = {0.0f, 0.0f}, tz[2] = {0.0f, 0.0f};
    for (int b = 0; b < (tu.two ? 2 : 1); ++b) {
      float s0, z0, s1 = 0.0f, z1 = 0.0f;
      grid_sample(q, tv.i0, tu.i0 + b, &s0, &z0);
      if (tv.two) grid_sample(q, tv.i0 + 1, tu.i0 + b, &s1, &z1);
      ts[b] = dot2(tv, s0, s1);
      tz[b] = dot2(tv, z0, z1);
    }
    const float sm_vol = dot2(tu, ts[0], ts[1]);
    const float z_vol = dot2(tu, tz[0], tz[1]);
    a.entry[(size_t)c * plane + o] = sm_vol;
    a.entry[((size_t)a.C + c) * plane + o] = add(z_vol, co.z_off);
  }
}

struct OcclusionArgs {
  const float* table;
  const long long* sub;     // (C,)
  const float* s_out_c;     // (C, L, L) B3's footprints
  float* sout_cache;        // (N, L, L) or null (then C = N)
  float* t_ins;             // (C, L, L)
  int N, C, L, blocks;
};

// A volume's exit-plane tent taps at global texel index gi: src = (gi -
// off) / scale, no clamp (zero weight outside the footprint); `sum` is
// the row's weight sum (cover's factor).
struct OutTaps {
  int i0;
  bool has0, has1;
  float w0, w1, sum;
};

__device__ __forceinline__ OutTaps out_taps(int gi, float off, float scale,
                                            int L) {
  OutTaps t;
  t.has0 = t.has1 = false;
  t.w0 = t.w1 = t.sum = 0.0f;
  t.i0 = 0;
  const float src = div(sub((float)gi, off), scale);
  if (!(src > -1.0f && src < (float)L)) return t;
  const int i0 = (int)floorf(src);
  t.i0 = i0;
  if (i0 >= 0) {
    t.w0 = tent(src, i0);
    t.has0 = true;
  }
  if (i0 + 1 <= L - 1) {
    t.w1 = tent(src, i0 + 1);
    t.has1 = true;
  }
  t.sum = add(t.w0, t.w1);
  return t;
}

// first present term rounded, the second fused into it
__device__ __forceinline__ float dot2o(const OutTaps& t, float x0, float x1) {
  if (!t.has0) return mul(t.w1, x1);
  const float acc = mul(t.w0, x0);
  return t.has1 ? __fmaf_rn(t.w1, x1, acc) : acc;
}

__global__ void __launch_bounds__(kThreads)
light_occlusion_kernel(OcclusionArgs a) {
  __shared__ float4 geo[kMaxN];     // su, sv, ou_o, ov_o in light order
  __shared__ const float* rows[kMaxN];
  const int c = blockIdx.y;
  const int L = a.L, G = 2 * L;
  const float* t = a.table;
  const float* coh = t + 6 * a.N + 5 * c;
  const int rank = __float_as_int(coh[4]);
  for (int r = threadIdx.x; r < rank; r += blockDim.x) {
    const int j = __float_as_int(t[5 * a.N + r]);
    const float* v = t + 5 * j;
    geo[r] = make_float4(v[0], v[1], v[2], v[3]);
    const int slot = __float_as_int(v[4]);
    rows[r] = slot >= 0 ? a.s_out_c + (size_t)slot * L * L
                        : a.sout_cache + (size_t)j * L * L;
  }
  __syncthreads();
  const float su_c = coh[0], ou_c = coh[1], sv_c = coh[2], ov_c = coh[3];
  const size_t plane = (size_t)L * L;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < plane;
       o += (size_t)a.blocks * blockDim.x) {
    const int u = (int)(o % L), v = (int)(o / L);
    const Taps ev = entry_taps(v, sv_c, ov_c, G);
    const Taps eu = entry_taps(u, su_c, ou_c, G);
    // g_in at (g0 + a, h0 + b), a, b in {0, 1}
    float gin[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
    const int na = ev.two ? 2 : 1, nb = eu.two ? 2 : 1;
    for (int r = 0; r < rank; ++r) {
      const float4 q = geo[r];
      OutTaps tg[2], th[2];
      for (int i = 0; i < na; ++i) tg[i] = out_taps(ev.i0 + i, q.w, q.y, L);
      for (int i = 0; i < nb; ++i) th[i] = out_taps(eu.i0 + i, q.z, q.x, L);
      const float* s = rows[r];
      for (int i = 0; i < na; ++i) {
        if (tg[i].sum == 0.0f) continue;
        for (int k = 0; k < nb; ++k) {
          if (th[k].sum == 0.0f) continue;
          // A[kk] = sum_l wv[l] s[l][kk], then o = sum_kk A[kk] wu[kk]
          const OutTaps& gv = tg[i];
          const OutTaps& hu = th[k];
          float A0 = 0.0f, A1 = 0.0f;
          const int k0 = hu.i0;
          if (hu.has0)
            A0 = dot2o(gv, gv.has0 ? s[gv.i0 * L + k0] : 0.0f,
                       gv.has1 ? s[(gv.i0 + 1) * L + k0] : 0.0f);
          if (hu.has1)
            A1 = dot2o(gv, gv.has0 ? s[gv.i0 * L + k0 + 1] : 0.0f,
                       gv.has1 ? s[(gv.i0 + 1) * L + k0 + 1] : 0.0f);
          const float ob = dot2o(hu, A0, A1);
          const float cover = tclamp(mul(gv.sum, hu.sum), 0.0f, 1.0f);
          gin[i][k] = mul(gin[i][k], add(ob, sub(1.0f, cover)));
        }
      }
    }
    float tt[2] = {0.0f, 0.0f};
    for (int b = 0; b < nb; ++b) tt[b] = dot2(ev, gin[0][b], gin[1][b]);
    a.t_ins[(size_t)c * plane + o] = dot2(eu, tt[0], tt[1]);
    if (a.sout_cache != nullptr)
      a.sout_cache[(size_t)a.sub[c] * plane + o] =
          a.s_out_c[(size_t)c * plane + o];
  }
}

struct EpilogueArgs {
  const float* fields;      // (C, L, L, L) B4's output, oriented
  const float* scal;        // (6, C): row 5 the flip flags
  const float* rho;         // (N_src, L, L, L)
  const float* ao;          // (N_src, L, L, L)
  const float* grad;        // (N_src, 3, L, L, L)
  const long long* tex;     // (N,) vol_tex_ids
  const long long* sub;     // (C,)
  const float* sh;          // (9, 3)
  const float* ambient;     // (4,)
  const float* light_color; // (4,)
  float* maps;              // (*, 3, L, L, L) f32
  const long long* map_rows;   // (C,) rows of maps, or null: row c
  void* sweep;              // (*, L, L, L, 4) bf16 or f32, or null
  const long long* sweep_rows; // (C,)
  int C, L, axis, probe, sweep_bf16, blocks;
};

// sh_lib.eval_irradiance at unit normal (x, y, z), channel ch, clamped
__device__ __forceinline__ float irradiance(const float* L9, int ch, float x,
                                            float y, float z) {
  const float c1 = (float)0.429043, c3 = (float)0.247708,
              c4 = (float)0.886227;
  const float c21 = (float)(2.0 * 0.429043), c22 = (float)(2.0 * 0.511664);
  const float* Lc = L9 + ch;   // L[k, ch] at Lc[3 k]
  const float t1 = mul(mul(c1, sub(mul(x, x), mul(y, y))), Lc[24]);
  const float t2 = mul(mul(c3, sub(mul(mul(3.0f, z), z), 1.0f)), Lc[18]);
  const float t3 = mul(c4, Lc[0]);
  const float t4 = mul(c21, add(add(mul(mul(Lc[12], x), y),
                                    mul(mul(Lc[21], x), z)),
                                mul(mul(Lc[15], y), z)));
  const float t5 = mul(c22, add(add(mul(Lc[9], x), mul(Lc[3], y)),
                                mul(Lc[6], z)));
  return tmax(add(add(add(add(t1, t2), t3), t4), t5), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
light_epilogue_kernel(EpilogueArgs a) {
  const int c = blockIdx.y;
  const int L = a.L;
  const size_t vox = (size_t)L * L * L;
  const bool flip = a.scal[5 * a.C + c] != 0.0f;
  const long long tex = a.tex[a.sub[c]];
  const float* fld = a.fields + (size_t)c * vox;
  const float* rho = a.rho + (size_t)tex * vox;
  const float* ao = a.ao + (size_t)tex * vox;
  const float* grad = a.grad + (size_t)tex * 3 * vox;
  const long long mrow = a.map_rows ? a.map_rows[c] : c;
  float* maps = a.maps + (size_t)mrow * 3 * vox;
  float lcol[3], amb_flat[3];
  for (int i = 0; i < 3; ++i) {
    lcol[i] = mul(a.light_color[i], a.light_color[3]);
    amb_flat[i] = mul(a.ambient[i], a.ambient[3]);
  }
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < vox;
       o += (size_t)a.blocks * blockDim.x) {
    // canonical (z, y, x) -> the oriented (k, v, u) B4 wrote
    const int x = (int)(o % L), y = (int)((o / L) % L), z = (int)(o / L / L);
    int k, v, u;
    if (a.axis == 0) { k = x; v = y; u = z; }
    else if (a.axis == 1) { k = y; v = z; u = x; }
    else { k = z; v = y; u = x; }
    if (flip) k = L - 1 - k;
    const float shadow = fld[((size_t)k * L + v) * L + u];
    float out[3];
    if (a.probe) {
      const bool dense = rho[o] >= 0.01f;
      const float w = ao[o];
      const float nx = grad[o], ny = grad[vox + o], nz = grad[2 * vox + o];
      for (int i = 0; i < 3; ++i) {
        const float amb = dense ? mul(w, irradiance(a.sh, i, nx, ny, nz))
                                : 0.0f;
        out[i] = add(mul(shadow, lcol[i]), amb);
      }
    } else {
      for (int i = 0; i < 3; ++i)
        out[i] = add(mul(shadow, lcol[i]), amb_flat[i]);
    }
    for (int i = 0; i < 3; ++i) maps[(size_t)i * vox + o] = out[i];
    if (a.sweep == nullptr) continue;
    const size_t srow = (size_t)a.sweep_rows[c] * vox + o;
    if (a.sweep_bf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(out[0], out[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(out[2], 0.0f);
      uint2 w;
      w.x = *reinterpret_cast<unsigned int*>(&lo);
      w.y = *reinterpret_cast<unsigned int*>(&hi);
      reinterpret_cast<uint2*>(a.sweep)[srow] = w;
    } else {
      reinterpret_cast<float4*>(a.sweep)[srow] =
          make_float4(out[0], out[1], out[2], 0.0f);
    }
  }
}

int blocks_for(size_t work, int rows) {
  // enough CTAs to fill the card once, split over the cohort's rows
  const size_t per = (work + kThreads - 1) / kThreads;
  const size_t cap = (size_t)max(1, 1056 / max(rows, 1));
  return (int)max((size_t)1, min(per, cap));
}

}  // namespace

extern "C" int mv_light_prologue(const void* rho, const void* tex,
                                 const void* sub, const void* world,
                                 const void* world_i, const void* light_dir,
                                 const void* shadow, const void* vp,
                                 void* rho_o, void* scal, void* entry,
                                 void* table, int N, int C, int L, int axis,
                                 int Hs, int Ws, float dt_num,
                                 float inv_step, float inv_l, float inv_g,
                                 float bias, void* stream) {
  if (C == 0) return 0;
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  PrologueArgs a{(const float*)rho, (const long long*)tex,
                 (const long long*)sub, (const float*)world,
                 (const float*)world_i, (const float*)light_dir,
                 (const float*)shadow, (const float*)vp, (float*)rho_o,
                 (float*)scal, (float*)entry, (float*)table, N, C, L, axis,
                 Hs, Ws, 0, dt_num, inv_step, inv_l, inv_g, bias};
  a.blocks = blocks_for((size_t)L * L * L, C);
  light_prologue_kernel<<<dim3(a.blocks, C), kThreads, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mv_light_occlusion(const void* table, const void* sub,
                                  const void* s_out_c, void* sout_cache,
                                  void* t_ins, int N, int C, int L,
                                  void* stream) {
  if (C == 0) return 0;
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  OcclusionArgs a{(const float*)table, (const long long*)sub,
                  (const float*)s_out_c, (float*)sout_cache, (float*)t_ins,
                  N, C, L, 0};
  a.blocks = blocks_for((size_t)L * L, C);
  light_occlusion_kernel<<<dim3(a.blocks, C), kThreads, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mv_light_epilogue(const void* fields, const void* scal,
                                 const void* rho, const void* ao,
                                 const void* grad, const void* tex,
                                 const void* sub, const void* sh,
                                 const void* ambient, const void* light_color,
                                 void* maps, const void* map_rows,
                                 void* sweep, const void* sweep_rows, int C,
                                 int L, int axis, int probe, int sweep_bf16,
                                 void* stream) {
  if (C == 0) return 0;
  EpilogueArgs a{(const float*)fields, (const float*)scal,
                 (const float*)rho, (const float*)ao, (const float*)grad,
                 (const long long*)tex, (const long long*)sub,
                 (const float*)sh, (const float*)ambient,
                 (const float*)light_color, (float*)maps,
                 (const long long*)map_rows, sweep,
                 (const long long*)sweep_rows, C, L, axis, probe,
                 sweep_bf16, 0};
  a.blocks = blocks_for((size_t)L * L * L, C);
  light_epilogue_kernel<<<dim3(a.blocks, C), kThreads, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
