// Screen-tile OIT composite (B2), with and without the CubeCast depth
// weights.
//
// Replaces multivolumes_tpu/ops/pallas/composite_kernel.py::
// tile_composite_pallas: depth_sel=None (kernel<T, false>, no scene mesh)
// and depth_sel given (kernel<T, true>, `_make_kernel(with_depth=True)`).
//
// What it computes, per screen pixel: for each volume on its tile's list
// (render/tilecast.py::_tile_prep; list order = sorted-space volume id),
//   * the analytic ray / unit-box exit in the volume's local frame, the
//     exit face and the exit clip-z, tested against the scene depth;
//   * the exit face's colour by the Catmull-Smith two-pass projective
//     warp: rows v0 = floor(vt), v0 + 1 of the face image, where
//     vt = (pv.q)/(den.q) is the pixel's v; on each row r, the u-tent
//     taps at cu(r, x), the u where row r's isoline crosses the pixel's
//     column (not the pixel's own u: this is the two-pass result, not a
//     bilinear tap);
//   * a nearest-K (K <= 8) insert of (exit z, premultiplied rgba) that
//     keeps the earlier-listed volume on equal depth (strict <), as the
//     TPU kernel does;
// then the front-to-back under-blend to premultiplied RGBA, alpha capped
// at 0.9997 (`PSResolveOIT.hlsl:17-24`).
//
// Design. One thread per pixel, 32 x 8 pixels per CTA (a CTA never
// straddles a 64 x 128 list tile, so all its pixels share one list); the
// K layers live in registers. The TPU kernel's sweeps over the source
// axis, its one-hot MXU column hoist and its static row windows exist
// because a dynamic lane index is not a TPU primitive; here each tap is a
// direct load. The tile's exact two-pass taps are computed per pixel, so
// no u/v sweep range can clip a tap.
//
// What bounds it on the card: the per-(pixel, listed volume) work (about
// 150 flops, 11 IEEE divisions and up to 16 two-byte gathers from the 4
// channel planes), so the time tracks sum over tiles of pixels x list
// length. What the design does about it:
//   * the CTA copies its tile's list and, for each listed volume, the
//     21-float volume record and the six 9-float face records into shared
//     memory once (kChunk volumes at a time), so the per-pair loop reads
//     only shared memory (uniform or conflict-free) and the face texels;
//   * the registers are bounded so that 3 CTAs share an SM (the 40
//     floats of layer state stay in registers, a few others spill;
//     `[occupancy]` in chip_smoke.py prints the counts);
//   * every division stays an IEEE division, as in the plain version:
//     the hit test, the exit-face select and floor(vt), floor(cu) are
//     discontinuous, and a reciprocal's rounding would move pixels
//     across them (tools/kernel_variants.py times that variant); for the
//     same reason the exit's coordinates and clip-z are products and sums
//     rounded one by one in the plain version's order (no fused
//     multiply-add), so the hit, the exit face and the depth test are the
//     plain version's.
// A cache of the exit faces' rows in shared memory per tile (the TPU
// kernel's face scratch) is not built: the taps of a CTA's pixels are
// neighbours, and the L1 serves them.
//
// Depth variant (the frames with the opaque mesh, `PSCube.hlsli:51-108`).
// Whether a 64 x 128 list tile holds a mesh pixel (scene clip z in
// (0, 1)) is decided once per tile by a first small launch of the same
// entry point (mesh_tile_kernel: one CTA reads the tile's 8192 depths
// once and votes), into a flag per tile that every CTA of the tile reads.
// The gate is part of the result: at a face's edge the tent weights sum
// to less than 1, and the normalisation below would change the colour of
// tiles without a mesh. On a mesh tile each of the two warp rows also
// u-interpolates the cube depth (f32 plane, view distance, read only
// there) with the colour's tent weights, the row weight becomes
// wv * max(wd, 1e-6) with wd = max(1 - 0.5 |d_scene - d_row|, 0), and the
// four channels are normalised by the weight sum (floored at 1e-20). The
// extra cost is one f32 tap pair per row on mesh tiles and the vote; the
// no-mesh frames launch the plain instantiation and no vote.

#include "common.cuh"

namespace {

constexpr float kFltMax = 3.402823466e38f;
constexpr float kEps = 1e-12f;
constexpr float kBig = 1e30f;
constexpr int kMaxLayers = 8;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
// CTAs an SM must hold (the register bound: 80 registers, a few spilled),
// by measurement faster than 2 (106 registers unbounded) or 4 (PERF.md,
// tools/kernel_variants.py)
constexpr int kMinCtas = 3;
constexpr int kChunk = 32;          // listed volumes in shared memory at once
constexpr int kVolF = 21;           // floats of a volume record
constexpr int kRecF = kVolF + 6 * 9;  // + its six face records
constexpr float kZNear = 1.0f;
constexpr float kZFar = 1000.0f;

__device__ __forceinline__ float safe(float x) {
  return fabsf(x) > kEps ? x : (x >= 0.0f ? kEps : -kEps);
}

__device__ __forceinline__ float finite(float x) {
  return fabsf(x) < kBig ? x : 0.0f;  // NaN compares false -> 0
}

// a0 x + a1 y + a2, rounded as the plain version's (a0 x + a1 y) + a2
__device__ __forceinline__ float lin2_rn(float a0, float x, float a1,
                                         float y, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, x), __fmul_rn(a1, y)), a2);
}

// x v[0] + y v[1] + z v[2] + v[3], rounded as ((x v0 + y v1) + z v2) + v3
__device__ __forceinline__ float dot3_rn(float x, float y, float z,
                                         const float* v) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, v[0]),
                                       __fmul_rn(y, v[1])),
                             __fmul_rn(z, v[2])),
                   v[3]);
}

__device__ __forceinline__ void slab(float o, float d, float* t_lo,
                                     float* t_hi) {
  float ds = safe(d);
  float t1 = (-1.0f - o) / ds, t2 = (1.0f - o) / ds;
  *t_lo = fminf(t1, t2);
  *t_hi = fmaxf(t1, t2);
}

// u-tent taps of face row r at the isoline crossing of column x
struct RowTaps {
  const float* fq;
  int s, r, u0, u1;
  float w0, w1;
};

__device__ __forceinline__ RowTaps row_taps(int s, int r, float xg,
                                            const float* fq, float hi) {
  const float k0 = fq[3] - r * fq[6];
  const float k1 = fq[4] - r * fq[7];
  const float k2 = fq[5] - r * fq[8];
  const float y1 = -(k0 * xg + k2) / safe(k1);
  const float dq1 = fq[6] * xg + fq[7] * y1 + fq[8];
  const float cu = mv::clampf(finite((fq[0] * xg + fq[1] * y1 + fq[2])
                                     / safe(dq1)), 0.0f, hi);
  RowTaps t;
  t.fq = fq;
  t.s = s;
  t.r = r;
  t.u0 = (int)floorf(cu);
  t.u1 = min(t.u0 + 1, s - 1);
  t.w0 = fmaxf(1.0f - fabsf(cu - (float)t.u0), 0.0f);
  t.w1 = fmaxf(1.0f - fabsf(cu - (float)(t.u0 + 1)), 0.0f);
  return t;
}

// the four colour channels of row t.r (img: one face, (4, S, S))
template <typename T>
__device__ __forceinline__ float4 row_color(const T* img, const RowTaps& t) {
  const size_t pl = (size_t)t.s * t.s;
  const T* p = img + (size_t)t.r * t.s;
  return make_float4(
      mv::load1(p + t.u0) * t.w0 + mv::load1(p + t.u1) * t.w1,
      mv::load1(p + pl + t.u0) * t.w0 + mv::load1(p + pl + t.u1) * t.w1,
      mv::load1(p + 2 * pl + t.u0) * t.w0
          + mv::load1(p + 2 * pl + t.u1) * t.w1,
      mv::load1(p + 3 * pl + t.u0) * t.w0
          + mv::load1(p + 3 * pl + t.u1) * t.w1);
}

// the cube depth of row t.r (dimg: one face, (S, S) f32)
__device__ __forceinline__ float row_depth(const float* dimg,
                                           const RowTaps& t) {
  const float* p = dimg + (size_t)t.r * t.s;
  return p[t.u0] * t.w0 + p[t.u1] * t.w1;
}

// Does list tile blockIdx.x hold a mesh pixel (0 < z < 1)? One CTA per
// tile, 16-byte loads of its rows of the scene plane.
__global__ void mesh_tile_kernel(const float* __restrict__ scene,
                                 int* __restrict__ flags, int wp, int th,
                                 int tw, int tiles_x) {
  const int t = blockIdx.x;
  const int ty0 = (t / tiles_x) * th, tx0 = (t % tiles_x) * tw;
  const int q = tw / 4;
  int m = 0;
  for (int i = threadIdx.x; i < th * q; i += blockDim.x) {
    const int r = i / q;
    const float4 z = *reinterpret_cast<const float4*>(
        scene + (size_t)(ty0 + r) * wp + tx0 + 4 * (i - r * q));
    m |= (z.x > 0.0f && z.x < 1.0f) | (z.y > 0.0f && z.y < 1.0f)
       | (z.z > 0.0f && z.z < 1.0f) | (z.w > 0.0f && z.w < 1.0f);
  }
  m = __syncthreads_or(m);
  if (threadIdx.x == 0) flags[t] = m != 0;
}

template <typename T, bool kDepth>
__global__ void __launch_bounds__(kThreads, kMinCtas) tile_composite_kernel(
    const T* __restrict__ color, const float* __restrict__ depth,
    const int* __restrict__ tlist, const int* __restrict__ counts,
    const float* __restrict__ vol_flt, const float* __restrict__ face_flt,
    const float* __restrict__ scene, const int* __restrict__ mesh_flag,
    float* __restrict__ out, int n, int s, int hp, int wp, int th, int tw,
    int tiles_x, int k_layers, int width, int height, int tile_row0) {
  // the grid tiles (hp, wp) exactly (the entry point checks th % 8 == 0
  // and tw % 32 == 0), so every thread of a CTA reaches its barriers and
  // all its pixels lie in list tile t.
  // (hp, wp) may be a band of tile rows of a taller screen (the sharded
  // frame step): tlist, counts, scene, the flags and out are then the
  // band's slices and py is a row of the band; only the pixel's NDC y
  // takes the band's offset of tile_row0 tile rows.
  __shared__ float rec[kChunk * kRecF];
  __shared__ int rec_vid[kChunk];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int px = blockIdx.x * kBlockX + threadIdx.x;
  const int py = blockIdx.y * kBlockY + threadIdx.y;
  const int t = (blockIdx.y * kBlockY / th) * tiles_x
              + blockIdx.x * kBlockX / tw;
  const int count = counts[t];
  const int* list = tlist + (size_t)t * n;
  const bool mesh_tile = kDepth && mesh_flag[t] != 0;
  const float xg = ((float)px + 0.5f) / width * 2.0f - 1.0f;
  const float yg =
      -(((float)(py + tile_row0 * th) + 0.5f) / height * 2.0f - 1.0f);
  const float scene_z = scene[(size_t)py * wp + px];
  // scene view distance (`UnprojectZ`), rounded as the plain version
  const float d_scene = __fdiv_rn(
      kZNear * kZFar,
      __fadd_rn(__fmul_rn(scene_z, kZNear - kZFar), kZFar));

  float lz[kMaxLayers], lr[kMaxLayers], lg[kMaxLayers], lb[kMaxLayers],
      la[kMaxLayers];
#pragma unroll
  for (int k = 0; k < kMaxLayers; ++k) {
    lz[k] = kFltMax;
    lr[k] = lg[k] = lb[k] = la[k] = 0.0f;
  }

  for (int i0 = 0; i0 < count; i0 += kChunk) {
    const int m = min(kChunk, count - i0);
    __syncthreads();  // the previous chunk's records have been read
    for (int j = tid; j < m * kRecF; j += kThreads) {
      const int e = j / kRecF, f = j - e * kRecF;
      const int vid = list[i0 + e];
      rec[j] = f < kVolF ? vol_flt[(size_t)vid * kVolF + f]
                         : face_flt[(size_t)vid * 54 + (f - kVolF)];
    }
    if (tid < m) rec_vid[tid] = list[i0 + tid];
    __syncthreads();

    for (int e = 0; e < m; ++e) {
      const float* vf = rec + e * kRecF;
      // ray / box exit in the volume's local frame, uncontracted in the
      // plain version's operation order up to the exit clip-z: the hit
      // test, the exit-face select and the depth test are discontinuous,
      // and a fused product moves pixels across them (one volume's colour
      // gained or lost there)
      const float dlx = lin2_rn(vf[0], xg, vf[3], yg, vf[6]);
      const float dly = lin2_rn(vf[1], xg, vf[4], yg, vf[7]);
      const float dlz = lin2_rn(vf[2], xg, vf[5], yg, vf[8]);
      float ix, ox, iy, oy, iz, oz;
      slab(vf[9], dlx, &ix, &ox);
      slab(vf[10], dly, &iy, &oy);
      slab(vf[11], dlz, &iz, &oz);
      const float t_near = fmaxf(fmaxf(ix, iy), iz);
      const float t_far = fminf(fminf(ox, oy), oz);
      const bool hit = t_far > fmaxf(t_near, 0.0f);
      const float qx = __fadd_rn(vf[9], __fmul_rn(dlx, t_far));
      const float qy = __fadd_rn(vf[10], __fmul_rn(dly, t_far));
      const float qz = __fadd_rn(vf[11], __fmul_rn(dlz, t_far));
      const float ax = fabsf(qx), ay = fabsf(qy), az = fabsf(qz);
      const bool is_x = (ax >= ay) && (ax >= az);
      const bool is_y = !is_x && (ay >= az);
      const int face = is_x ? (qx >= 0.0f ? 0 : 1)
                            : (is_y ? (qy >= 0.0f ? 2 : 3)
                                    : (qz >= 0.0f ? 4 : 5));
      const float hz = dot3_rn(qx, qy, qz, vf + 12);
      const float hw = dot3_rn(qx, qy, qz, vf + 16);
      const float exit_z = hz / fmaxf(hw, 1e-20f);
      const bool valid = hit && (hw > 0.0f) && (exit_z <= scene_z) &&
                         (exit_z > 0.0f);
      if (!valid) continue;

      // Catmull-Smith two-pass warp of the exit face (rows v0, v0 + 1)
      const int vid = rec_vid[e];
      const float hi = vf[20] - 1.0f;
      const float* fq = vf + kVolF + face * 9;
      const float dq = fq[6] * xg + fq[7] * yg + fq[8];
      const float vt = mv::clampf(finite((fq[3] * xg + fq[4] * yg + fq[5])
                                         / safe(dq)), 0.0f, hi);
      const int v0 = (int)floorf(vt);
      const T* img = color + ((size_t)vid * 6 + face) * 4 * s * s;
      const float* dimg = kDepth ? depth + ((size_t)vid * 6 + face) * s * s
                                 : nullptr;
      float wv0 = fmaxf(1.0f - fabsf(vt - (float)v0), 0.0f);
      RowTaps taps = row_taps(s, v0, xg, fq, hi);
      float w_sum = 0.0f;
      if (kDepth && mesh_tile) {
        const float wd = fmaxf(
            1.0f - 0.5f * fabsf(d_scene - row_depth(dimg, taps)), 0.0f);
        wv0 = wv0 * fmaxf(wd, 1e-6f);
        w_sum = wv0;
      }
      float4 c = row_color(img, taps);
      float rr = c.x * wv0, gg = c.y * wv0, bb = c.z * wv0, aa = c.w * wv0;
      if ((float)(v0 + 1) <= hi) {
        float wv1 = fmaxf(1.0f - fabsf(vt - (float)(v0 + 1)), 0.0f);
        taps = row_taps(s, v0 + 1, xg, fq, hi);
        if (kDepth && mesh_tile) {
          const float wd = fmaxf(
              1.0f - 0.5f * fabsf(d_scene - row_depth(dimg, taps)), 0.0f);
          wv1 = wv1 * fmaxf(wd, 1e-6f);
          w_sum += wv1;
        }
        c = row_color(img, taps);
        rr += c.x * wv1;
        gg += c.y * wv1;
        bb += c.z * wv1;
        aa += c.w * wv1;
      }
      if (kDepth && mesh_tile) {
        const float inv = 1.0f / fmaxf(w_sum, 1e-20f);
        rr *= inv;
        gg *= inv;
        bb *= inv;
        aa *= inv;
      }
      aa = fminf(aa, 1.0f);  // `PSCube.hlsl:57` store-if semantics
      if (!(aa > 0.0f)) continue;

      // streaming nearest-K insert; ties keep the earlier-listed volume
      float zn = exit_z;
#pragma unroll
      for (int k = 0; k < kMaxLayers; ++k) {
        if (k < k_layers && zn < lz[k]) {
          float tz = lz[k], tr = lr[k], tg = lg[k], tb = lb[k], ta = la[k];
          lz[k] = zn; lr[k] = rr; lg[k] = gg; lb[k] = bb; la[k] = aa;
          zn = tz; rr = tr; gg = tg; bb = tb; aa = ta;
        }
      }
    }
  }

  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aa = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxLayers; ++k) {
    if (k < k_layers) {
      const float tr = 1.0f - aa;
      ar += lr[k] * tr;
      ag += lg[k] * tr;
      ab += lb[k] * tr;
      aa += la[k] * tr;
    }
  }
  const size_t plane = (size_t)hp * wp;
  const size_t o = (size_t)py * wp + px;
  out[o] = ar;
  out[plane + o] = ag;
  out[2 * plane + o] = ab;
  out[3 * plane + o] = fminf(aa, 0.9997f);
}

template <typename T, bool kDepth>
cudaError_t launch(const void* color, const void* depth, const void* tlist,
                   const void* counts, const void* vol_flt,
                   const void* face_flt, const void* scene, void* flags,
                   void* out, int n, int s, int hp, int wp, int th, int tw,
                   int tiles_x, int k_layers, int width, int height,
                   int tile_row0, cudaStream_t stream) {
  if (kDepth) {
    mesh_tile_kernel<<<(hp / th) * tiles_x, kThreads, 0, stream>>>(
        (const float*)scene, (int*)flags, wp, th, tw, tiles_x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 block(kBlockX, kBlockY);
  dim3 grid(wp / kBlockX, hp / kBlockY);
  tile_composite_kernel<T, kDepth><<<grid, block, 0, stream>>>(
      (const T*)color, (const float*)depth, (const int*)tlist,
      (const int*)counts, (const float*)vol_flt, (const float*)face_flt,
      (const float*)scene, (const int*)flags, (float*)out, n, s, hp, wp, th,
      tw, tiles_x, k_layers, width, height, tile_row0);
  return cudaGetLastError();
}

template <bool kDepth>
cudaError_t launch_typed(int is_bf16, const void* color, const void* depth,
                         const void* tlist, const void* counts,
                         const void* vol_flt, const void* face_flt,
                         const void* scene, void* flags, void* out, int n,
                         int s, int hp, int wp, int th, int tw, int tiles_x,
                         int k_layers, int width, int height, int tile_row0,
                         cudaStream_t st) {
  return is_bf16
      ? launch<__nv_bfloat16, kDepth>(color, depth, tlist, counts, vol_flt,
                                      face_flt, scene, flags, out, n, s, hp,
                                      wp, th, tw, tiles_x, k_layers, width,
                                      height, tile_row0, st)
      : launch<float, kDepth>(color, depth, tlist, counts, vol_flt,
                              face_flt, scene, flags, out, n, s, hp, wp, th,
                              tw, tiles_x, k_layers, width, height,
                              tile_row0, st);
}

template <typename K>
cudaError_t kernel_info(K kernel, int* out) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs; out[1] = per_sm; out[2] = kThreads;
  out[3] = (int)fa.sharedSizeBytes; out[4] = (int)fa.localSizeBytes;
  return cudaSuccess;
}

}  // namespace

// color (N, 6, 4, S, S) in the storage type (bf16 when is_bf16, else f32),
// pre-swapped; depth (N, 6, S, S) f32 view distance, swapped like color,
// or null for the plain warp; tlist (T, N) i32; counts (T,) i32; vol_flt
// (N, 21) f32; face_flt (N, 6, 9) f32; scene (Hp, Wp) f32 clip depth,
// 16-byte aligned; flags (T,) i32 scratch for the per-tile mesh vote
// (written and read only with depth); out (4, Hp, Wp). With tile_row0 >
// 0, (Hp, Wp) is a band of tile rows that starts tile_row0 tile rows down
// a screen of `height` pixel rows.
extern "C" int mv_tile_composite(const void* color, const void* depth,
                                 const void* tlist, const void* counts,
                                 const void* vol_flt, const void* face_flt,
                                 const void* scene, void* flags, void* out,
                                 int n, int s, int hp, int wp, int th, int tw,
                                 int tiles_x, int k_layers, int width,
                                 int height, int tile_row0, int is_bf16,
                                 void* stream) {
  if (k_layers < 1 || k_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (th % kBlockY != 0 || tw % kBlockX != 0) return (int)cudaErrorInvalidValue;
  if (hp % th != 0 || wp % tw != 0) return (int)cudaErrorInvalidValue;
  if (tile_row0 < 0) return (int)cudaErrorInvalidValue;
  if (depth && (flags == nullptr || ((uintptr_t)scene & 15) != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = depth
      ? launch_typed<true>(is_bf16, color, depth, tlist, counts, vol_flt,
                           face_flt, scene, flags, out, n, s, hp, wp, th, tw,
                           tiles_x, k_layers, width, height, tile_row0, st)
      : launch_typed<false>(is_bf16, color, depth, tlist, counts, vol_flt,
                            face_flt, scene, flags, out, n, s, hp, wp, th,
                            tw, tiles_x, k_layers, width, height, tile_row0,
                            st);
  return (int)err;
}

// out[0..4] = registers per thread, CTAs per SM, threads per CTA, static
// shared memory (bytes) and local (spill) memory per thread (bytes) of the
// composite kernel of that storage type and variant
extern "C" int mv_tile_composite_info(int is_bf16, int with_depth,
                                      int* out) {
  cudaError_t err;
  if (is_bf16)
    err = with_depth
        ? kernel_info(tile_composite_kernel<__nv_bfloat16, true>, out)
        : kernel_info(tile_composite_kernel<__nv_bfloat16, false>, out);
  else
    err = with_depth ? kernel_info(tile_composite_kernel<float, true>, out)
                     : kernel_info(tile_composite_kernel<float, false>, out);
  return (int)err;
}
