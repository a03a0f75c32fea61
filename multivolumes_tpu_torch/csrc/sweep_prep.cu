// LOD-bucket prologue of the plane-sweep march (B7).
//
// Replaces no TPU kernel: the JAX package computes this in XLA inside its
// jitted frame (`multivolumes_tpu/render/sweep.py`, the bucket loop of
// `ray_march_view_sweep_lod`: `_occlusion_s_max`, `face_ray_params`),
// fused by the compiler. Eager PyTorch dispatched it as about 150 small
// tensor operations a LOD bucket, and the frame is bound by the host's
// dispatch, so one launch a bucket takes their place.
// Plain version: `render/sweep.py:bucket_prologue_plain`.
//
// What it computes, for every (volume, face) of one bucket of faces of
// S_b x S_b rays (one CTA each):
//   * with a scene depth map (the opaque mesh), the occlusion bound s_max
//     of the reference's GetClipPos + GetTMax (`_occlusion_s_max`) on a
//     coarse grid of S_b / F texels, F = 4 at S_b >= 64, 2 at S_b >= 32,
//     else 1; each tap reads the max of its P x P block of the depth map
//     (P = 4 or 2: the nested 2 x 2 max-pools, exact since a max is; 1
//     on a side the pools pass through). Then the edge-clamped 3 x 3 max
//     dilation of s_max (F > 1) and the nearest upsampling by F;
//   * the face's cube depth at [row, face, :S_b, :S_b]: for the tile
//     composite (`kSwap`) the sampled clip depth unprojected to view
//     distance and transposed where the face's Catmull-Smith flag is set,
//     for the warp and gather composites the clip depth as it is;
//   * B1's per-ray operands (`face_ray_params`): s_in, s_end (bounded by
//     s_max with a depth map), ray_len, and active, false beyond the
//     volume's n_eff corner.
//
// Rounding: every value is computed in the plain version's operation
// order, each operation rounded on its own (`__fmul_rn`, `__fadd_rn`,
// IEEE division and square root), never contracted into a fused
// multiply-add: the values feed thresholds and truncations (the depth
// tap's index, s_out > s_in, t_max >= FLT_MAX / 2), where an ulp can move
// a whole ray (as in B1, `csrc/sweep.cu`). `rsqrtf` stands where the plain
// version calls torch.rsqrt; min, max and clamp pass NaN on as PyTorch's.
//
// What bounds it on the card: nothing much. It reads a few bytes per face
// and the depth map's taps (L2-resident), and writes 17 or 21 bytes a ray;
// the S_b = 128 bucket of the demo writes 16 MB. The coarse grid (at most
// 32 x 32 texels at S_b = 128) sits in shared memory, so the dilation and
// the upsampling cost no traffic.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr float kFltMax = 3.402823466e38f;
// float(FLT_MAX * 0.5), the plain version's threshold for "no occluder"
constexpr float kHalfFltMax = 0x1.fffffep+126f;
// float(1.0 + 1e-6), the slack of the box test in ComputeRayOrigin
constexpr float kBoxSlack = 1.0f + 1e-6f;

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

// raymarch._safe: |d| > eps, else eps with d's sign (d >= 0 -> +eps)
__device__ __forceinline__ float safe(float d, float eps) {
  return fabsf(d) > eps ? d : (d >= 0.0f ? eps : -eps);
}

// (idx + 0.5) / n * 2 - 1: the face coordinate of texel centre idx
__device__ __forceinline__ float texel_coord(int idx, float n) {
  return sub(mul(div(add((float)idx, 0.5f), n), 2.0f), 1.0f);
}

// A 4 x 4 row-vector matrix of one volume, read through its strides
struct Mat {
  const float* p;
  int s1, s2;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[r * s1 + c * s2];
  }
};

struct Args {
  const long long* ids;      // (count,) the bucket's volumes
  const float* n_eff;        // (count,)
  const float* eye_faces;    // (N, 6, 3) (eu, ev, ew); face 4 is the eye
  const float* wvp;          // (N, 4, 4) strided
  const float* wvp_i;        // (N, 4, 4) strided
  const float* depth;        // (H, W) scene clip depth, or null
  const unsigned char* swap; // (count, 6) flags of the bucket's rows
  const long long* row_ids;  // (count,) cube-depth rows, or null: row0 + k
  float* cube_depth;         // (N, 6, S, S)
  float* params;             // (3, count, 6, Sb, Sb): s_in, s_end, ray_len
  unsigned char* active;     // (count, 6, Sb, Sb)
  int count, Sb, S, row0, W, P, hp, wp;
  int m0, m1, m2, mi0, mi1, mi2;   // element strides of wvp, wvp_i
  float zz, zd, zf;                // unproject_z: Z_NEAR Z_FAR, Z_NEAR -
                                   // Z_FAR, Z_FAR
};

// max of the P x P block (ty, tx) of the depth map: the pooled texel
__device__ __forceinline__ float pooled_depth(const Args& a, int ty, int tx) {
  const float* row = a.depth + (size_t)ty * a.P * a.W + (size_t)tx * a.P;
  float z = row[0];
  for (int dy = 0; dy < a.P; ++dy)
    for (int dx = 0; dx < a.P; ++dx) z = tmax(z, row[dy * a.W + dx]);
  return z;
}

// truncation toward zero of clamp(c * n, -1, n), kept in [0, n - 1]
__device__ __forceinline__ int depth_tap(float c, int n) {
  const int t = (int)tclamp(mul(c, (float)n), -1.0f, (float)n);
  return min(max(t, 0), n - 1);
}

// One coarse texel's occlusion bound in s and its sampled clip depth
// (`_occlusion_s_max`): the ray from the eye through the texel's centre
// (px, py) on face f, clipped to the unit box, projected 0.01 past its
// origin to take the depth tap, unprojected there (GetTMax), converted
// from the reference's t to the sweep's s.
__device__ __forceinline__ float occlusion(const Args& a, float px, float py,
                                           int f, float ex, float ey,
                                           float ez, Mat m, Mat mi,
                                           float* z_out) {
  // GetLocalPos
  float tx, ty, tz;
  switch (f) {
    case 0: tx = 1.0f; ty = py; tz = -px; break;
    case 1: tx = -1.0f; ty = py; tz = px; break;
    case 2: tx = px; ty = 1.0f; tz = -py; break;
    case 3: tx = px; ty = -1.0f; tz = py; break;
    case 4: tx = px; ty = py; tz = 1.0f; break;
    default: tx = -px; ty = py; tz = -1.0f; break;
  }
  const float dxu = sub(tx, ex), dyu = sub(ty, ey), dzu = sub(tz, ez);
  const float len2 = add(add(mul(dxu, dxu), mul(dyu, dyu)), mul(dzu, dzu));
  const float il = rsqrtf(tmax(len2, 1e-20f));
  const float d[3] = {mul(dxu, il), mul(dyu, il), mul(dzu, il)};
  const float e[3] = {ex, ey, ez};

  // ComputeRayOrigin
  const bool inside = fabsf(ex) <= 1.0f && fabsf(ey) <= 1.0f &&
                      fabsf(ez) <= 1.0f;
  float best = kFltMax;
  bool any_hit = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float sd = safe(d[i], 1e-12f);
    const float sgn = sd > 0.0f ? 1.0f : -1.0f;
    const float u = div(sub(-sgn, e[i]), sd);
    bool ok = u >= 0.0f && fabsf(d[i]) > 1e-12f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j != i) ok = ok && fabsf(add(mul(d[j], u), e[j])) <= kBoxSlack;
    if (ok && u < best) best = u;
    any_hit = any_hit || ok;
  }
  const float u = any_hit ? best : 0.0f;
  float o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = inside ? e[i] : tclamp(add(e[i], mul(d[i], u)), -1.0f, 1.0f);

  // GetClipPos 0.01 along the ray, and the depth tap
  const float pr[3] = {add(o[0], mul(0.01f, d[0])),
                       add(o[1], mul(0.01f, d[1])),
                       add(o[2], mul(0.01f, d[2]))};
  float h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    h[c] = add(add(add(mul(pr[0], m(0, c)), mul(pr[1], m(1, c))),
                   mul(pr[2], m(2, c))), m(3, c));
  const float hw = safe(h[3], 1e-20f);
  const float cx = div(h[0], hw), cy = div(h[1], hw);
  const float uu = add(mul(cx, 0.5f), 0.5f);
  const float vv = sub(1.0f, add(mul(cy, 0.5f), 0.5f));
  const float z = pooled_depth(a, depth_tap(vv, a.hp), depth_tap(uu, a.wp));
  *z_out = z;

  // GetTMax
  const float hw2 = safe(add(add(add(mul(cx, mi(0, 3)), mul(cy, mi(1, 3))),
                                 mul(z, mi(2, 3))), mi(3, 3)), 1e-20f);
  float t = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float up = div(add(add(add(mul(cx, mi(0, c)), mul(cy, mi(1, c))),
                                 mul(z, mi(2, c))), mi(3, c)), hw2);
    const float tc = div(sub(up, o[c]), safe(d[c], 1e-12f));
    t = c == 0 ? tc : tmax(t, tc);
  }
  const float t_max = z >= 1.0f ? kFltMax : t;

  // from t along the unit direction after the origin to s from the eye
  const float len = __fsqrt_rn(len2);
  const float t0x = sub(o[0], ex), t0y = sub(o[1], ey), t0z = sub(o[2], ez);
  const float t0 = __fsqrt_rn(
      add(add(mul(t0x, t0x), mul(t0y, t0y)), mul(t0z, t0z)));
  const float s_max = div(add(t0, tmin(t_max, kFltMax)), tmax(len, 1e-12f));
  return t_max >= kHalfFltMax ? kFltMax : s_max;
}

// One (volume, face) of the bucket: kDepth, with the depth map; kF, the
// coarse factor; kSwap, the tile composite's cube depth (unprojected,
// transposed where the face's flag is set); kIds, cube-depth rows given by
// `row_ids` (else row0 + the bucket index).
template <bool kDepth, int kF, bool kSwap, bool kIds>
__global__ void __launch_bounds__(kThreads)
    sweep_prologue_kernel(const Args a) {
  extern __shared__ float grid_mem[];
  const int k = blockIdx.x / 6, f = blockIdx.x - (blockIdx.x / 6) * 6;
  const long long v = a.ids[k];
  const float n_eff = a.n_eff[k];
  const float* ef = a.eye_faces + (v * 6 + f) * 3;
  const float eu = ef[0], ev = ef[1], ew = ef[2];
  const int Sb = a.Sb, sc = Sb / kF;
  // the coarse grid: s_max as computed, its clip depth, s_max dilated
  float* s_raw = grid_mem;
  float* z_c = grid_mem + sc * sc;
  float* s_dil = kF > 1 ? z_c + sc * sc : s_raw;

  if (kDepth) {
    const float* el = a.eye_faces + (v * 6 + 4) * 3;   // +Z frame: the eye
    const Mat m{a.wvp + v * a.m0, a.m1, a.m2};
    const Mat mi{a.wvp_i + v * a.mi0, a.mi1, a.mi2};
    const float nc = kF == 1 ? n_eff : mul(n_eff, 1.0f / kF);
    for (int t = threadIdx.x; t < sc * sc; t += blockDim.x) {
      const int cj = t / sc, ci = t - (t / sc) * sc;
      const float px = texel_coord(ci, nc), py = -texel_coord(cj, nc);
      s_raw[t] = occlusion(a, px, py, f, el[0], el[1], el[2], m, mi, &z_c[t]);
    }
    __syncthreads();
    if (kF > 1) {
      // the edge-clamped 3 x 3 max (`_dilate3_max`)
      for (int t = threadIdx.x; t < sc * sc; t += blockDim.x) {
        const int cj = t / sc, ci = t - (t / sc) * sc;
        float s = s_raw[t];
        for (int dj = -1; dj <= 1; ++dj) {
          const int r = min(max(cj + dj, 0), sc - 1);
          for (int di = -1; di <= 1; ++di)
            s = tmax(s, s_raw[r * sc + min(max(ci + di, 0), sc - 1)]);
        }
        s_dil[t] = s;
      }
      __syncthreads();
    }
  }

  const float gz = sub(1.0f, ew);
  const float gz_safe = safe(gz, 1e-12f);
  const float iz1 = div(sub(-1.0f, ew), gz_safe);
  const float iz2 = div(sub(1.0f, ew), gz_safe);
  const float iz = tmin(iz1, iz2), oz = tmax(iz1, iz2);
  const size_t plane = (size_t)Sb * Sb;
  const size_t face = (size_t)blockIdx.x * plane;
  const size_t params_n = (size_t)a.count * 6 * plane;
  const bool swapped = kSwap && a.swap[k * 6 + f];
  float* depth_out = nullptr;
  if (kDepth) {
    const long long row = kIds ? a.row_ids[k] : (long long)(a.row0 + k);
    depth_out = a.cube_depth + ((size_t)row * 6 + f) * a.S * a.S;
  }
  for (int t = threadIdx.x; t < Sb * Sb; t += blockDim.x) {
    const int i = t / Sb, j = t - (t / Sb) * Sb;   // row (v), column (u)
    // face_ray_params
    const float gx = sub(texel_coord(j, n_eff), eu);
    const float gy = sub(-texel_coord(i, n_eff), ev);
    const float gx_safe = safe(gx, 1e-12f), gy_safe = safe(gy, 1e-12f);
    const float ix1 = div(sub(-1.0f, eu), gx_safe);
    const float ix2 = div(sub(1.0f, eu), gx_safe);
    const float iy1 = div(sub(-1.0f, ev), gy_safe);
    const float iy2 = div(sub(1.0f, ev), gy_safe);
    const float s_in = tmax(tmax(tmin(ix1, ix2), tmin(iy1, iy2)),
                            tclamp(iz, 0.0f, INFINITY));
    const float s_out = tmin(tmin(tmax(ix1, ix2), tmax(iy1, iy2)), oz);
    const float ray_len = __fsqrt_rn(
        add(add(mul(gx, gx), mul(gy, gy)), mul(gz, gz)));
    float s_end = tclamp(s_out, -INFINITY, 1.0f);
    if (kDepth) s_end = tmin(s_end, s_dil[(i / kF) * sc + j / kF]);
    const bool act = s_out > s_in && (float)i < n_eff && (float)j < n_eff;
    a.params[face + t] = s_in;
    a.params[params_n + face + t] = s_end;
    a.params[2 * params_n + face + t] = ray_len;
    a.active[face + t] = act;
    if (kDepth) {
      const int si = swapped ? j : i, sj = swapped ? i : j;
      float z = z_c[(si / kF) * sc + sj / kF];
      // unproject_z: (Z_NEAR Z_FAR) / den, as reciprocal(den) * Z_NEAR Z_FAR
      if (kSwap) z = mul(__frcp_rn(add(mul(z, a.zd), a.zf)), a.zz);
      depth_out[(size_t)i * a.S + j] = z;
    }
  }
}

template <bool kDepth, int kF, bool kSwap, bool kIds>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int sc = a.Sb / kF;
  const size_t smem = kDepth ? (size_t)(kF > 1 ? 3 : 2) * sc * sc *
                                   sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_prologue_kernel<kDepth, kF, kSwap, kIds>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sweep_prologue_kernel<kDepth, kF, kSwap, kIds>
      <<<a.count * 6, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kF>
cudaError_t launch_depth(const Args& a, bool swap, cudaStream_t stream) {
  if (swap)
    return a.row_ids ? launch<true, kF, true, true>(a, stream)
                     : launch<true, kF, true, false>(a, stream);
  return a.row_ids ? launch<true, kF, false, true>(a, stream)
                   : launch<true, kF, false, false>(a, stream);
}

}  // namespace

// One LOD bucket of `count` volumes at Sb x Sb rays a face. ids (count,)
// i64; n_eff (count,) f32; eye_faces (N, 6, 3) f32; wvp, wvp_i (N, 4, 4)
// f32 with element strides m0..m2, mi0..mi2; depth (H, W) f32 or null (no
// depth bound, no cube depth); swap (count, 6) u8 or null (the cube depth
// unswapped, not unprojected); row_ids (count,) i64 or null (rows row0 +
// k); cube_depth (N, 6, S, S) f32; params (3, count, 6, Sb, Sb) f32 out;
// active (count, 6, Sb, Sb) u8 out. The depth map's taps read the max of
// its P x P blocks, hp x wp of them.
extern "C" int mv_sweep_prologue(const void* ids, const void* n_eff,
                                 const void* eye_faces, const void* wvp,
                                 const void* wvp_i, const void* depth,
                                 const void* swap, const void* row_ids,
                                 void* cube_depth, void* params,
                                 void* active, int count, int Sb, int S,
                                 int row0, int W, int P, int hp, int wp,
                                 int m0, int m1, int m2, int mi0, int mi1,
                                 int mi2, float zz, float zd, float zf,
                                 void* stream) {
  if (count == 0) return 0;
  const Args a{(const long long*)ids, (const float*)n_eff,
               (const float*)eye_faces, (const float*)wvp,
               (const float*)wvp_i, (const float*)depth,
               (const unsigned char*)swap, (const long long*)row_ids,
               (float*)cube_depth, (float*)params, (unsigned char*)active,
               count, Sb, S, row0, W, P, hp, wp, m0, m1, m2, mi0, mi1, mi2,
               zz, zd, zf};
  cudaStream_t st = (cudaStream_t)stream;
  if (depth == nullptr)
    return (int)launch<false, 1, false, false>(a, st);
  const bool sw = swap != nullptr;
  if (Sb >= 64) return (int)launch_depth<4>(a, sw, st);
  if (Sb >= 32) return (int)launch_depth<2>(a, sw, st);
  return (int)launch_depth<1>(a, sw, st);
}
