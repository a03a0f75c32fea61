// The mesh layer's z-buffer raster (B9).
//
// Replaces no TPU kernel: the JAX package leaves its scatter raster to
// XLA (`multivolumes_tpu/render/mesh.py:257` `rasterize`). Eager PyTorch
// dispatched it as about 470 small kernels a frame (the per-triangle
// table, each tier's coverage emit, the pack, the scatter-min, the dense
// pass and the decode), and the frame is bound by the host's dispatch, so
// two entry points with three launches take their place (four for ids
// past 2^17). Plain version: `render/mesh.py:rasterize_plain`.
//
//   * `raster_setup_kernel`, one thread a triangle: the clip-to-pixel
//     transform of its vertices and the row of the (T, 15) table `cols`
//     (padded to 16 floats), the by-edge sort key (-edge, 1 where the
//     triangle is culled or not drawable), and each CTA's bbox of the
//     drawable triangles for the dense window; its grid also covers the
//     z-buffer, which it fills with the empty word. The stable argsort of
//     the key stays with PyTorch, between the two entry points.
//   * `raster_emit_kernel`, one thread a coverage sample of a ranked
//     triangle: every (lo, count, kk) segment of `_emit_plan` in one
//     launch, the segment found from the sample's number. A sample that
//     passes the inside, viewport, drawable and depth tests (and lies in
//     the band) takes `atomicMin` of its word at its pixel; the plain
//     version sends every other sample to a drop slot. One extra CTA
//     reduces the CTAs' bboxes to the dense window's corner. With ids
//     past 2^17 a second launch takes, at each pixel, the least id among
//     the samples whose depth won there.
//   * `raster_resolve_kernel`, one thread an output pixel: the min of the
//     buffer's word and the dense triangles' words (read from shared
//     memory, inside the dense window where there is one), decoded into
//     depth (f32) and the triangle id (i64, -1 where empty).
//
// The z-buffer word is `(z15 << 17) | id` (ids below 2^17), or the 24-bit
// depth alone (a depth-only raster, or ids past 2^17); both fit 32 bits,
// the empty word 0xFFFFFFFF is above every drawn word, so the buffer is
// u32 (the plain version keeps them in int64 for want of u32 arithmetic
// in PyTorch). A minimum gives the same word in any order, so the result
// is the plain version's bit for bit, whatever order the atomics land in.
//
// Numerics: every operation is written with the round-to-nearest
// intrinsics, which nvcc never contracts into an FMA, in the plain
// version's order, each rounded where PyTorch rounds it (one ATen kernel
// an operation). A tensor over a host scalar is a product with the
// reciprocal, as PyTorch computes it on the card (the sample stride
// (xmax - xmin) / kk); 1 / x is an IEEE reciprocal; the int casts
// truncate toward zero (`cvt.rzi`, as ATen's casts); min, max and clamp
// pass NaN on as PyTorch's where a NaN could reach them.
//
// What bounds it on the card: at 2560 x 1440 on the near ladder, the
// dense pass (16 triangles a pixel, about 25 f32 operations each, 1.5
// GFLOP) and the output (depth and id, 12 bytes a pixel, plus the
// buffer's 4 written and read: 74 MB), about 0.02 ms either way; at
// 1280 x 800 with the 384 window, the buffer and the output (20 MB). The
// emits are 0.2-0.6 M samples, the table 70 k rows. Design: the dense
// rows' differences are formed once a CTA in shared memory; a CTA of the
// resolve that meets no pixel of the dense window skips the dense loop.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 16;            // floats a triangle's table row
constexpr int kMaxSegments = 32;
constexpr int kDenseChunk = 32;     // dense rows in shared memory at once
constexpr int kTx = 32, kTy = 8;    // a resolve CTA's pixels
constexpr unsigned kEmpty = 0xFFFFFFFFu;
constexpr int kTBits = 17;

enum Mode { kPacked = 0, kDepth = 1, kDepthIds = 2 };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.minimum / maximum / clamp: NaN passes through
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// the start of `window_index(c, win, extent)`
__device__ __forceinline__ int window_start(float c, int win, int extent) {
  const float s = tclamp(rintf(sub(c, 0.5f * (float)win)), 0.0f,
                         (float)(extent - win));
  return isnan(s) ? 0 : (int)s;
}

// the word of a drawn sample at depth z in [0, 1]: clamp(z * 2^24, 0,
// 2^24 - 1) cast, packed with the id or alone
__device__ __forceinline__ unsigned zq24(float z) {
  return (unsigned)(long long)fminf(fmaxf(mul(z, 16777216.0f), 0.0f),
                                    16777215.0f);
}
__device__ __forceinline__ unsigned word_of(unsigned zq, long long t,
                                            int mode) {
  return mode == kPacked ? (((zq >> 9) << kTBits) | (unsigned)t) : zq;
}

struct SetupArgs {
  const float* clip;          // (V, 4) clip positions
  const long long* idx;       // (T, 3)
  float* table;               // (T, 16) out
  float* key;                 // (T,) out, or null (no by-edge order)
  float* part;                // (ceil(T / 256), 4) out: CTA bboxes
  unsigned* buf;              // (n_px,) set to the empty word
  unsigned* ids;              // (n_px,) or null, the same
  int T, n_px;
  float cull, width, height;
};

// a vertex's pixel position and clip z (`rasterize_plain`'s px, py, pz)
// and its clip w
__device__ __forceinline__ void vertex(const SetupArgs& a, long long v,
                                       float& x, float& y, float& z,
                                       float& w) {
  const float4 c = __ldg(reinterpret_cast<const float4*>(a.clip) + v);
  w = c.w;
  const float cw = tclamp_min(fabsf(w), 1e-20f);
  const float sg = (float)((0.0f < w) - (w < 0.0f));
  const float nx = mul(div(c.x, cw), sg), ny = mul(div(c.y, cw), sg);
  z = mul(div(c.z, cw), sg);
  x = mul(add(mul(nx, 0.5f), 0.5f), a.width);
  y = mul(sub(0.5f, mul(ny, 0.5f)), a.height);
}

__global__ void __launch_bounds__(kThreads)
    raster_setup_kernel(const SetupArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n_px) {
    a.buf[i] = kEmpty;
    if (a.ids) a.ids[i] = kEmpty;
  }
  if ((long long)blockIdx.x * kThreads >= a.T) return;  // the whole CTA
  // the drawable triangles' bbox: where(ok, xmin, 1e9).min() etc.
  float bb[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  if (i < a.T) {
    float x[3], y[3], z[3], w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      vertex(a, a.idx[i * 3 + k], x[k], y[k], z[k], w[k]);
    bool ok = w[0] > 1e-6f && w[1] > 1e-6f && w[2] > 1e-6f;
    const float xmin = tmin(tmin(x[0], x[1]), x[2]);
    const float xmax = tmax(tmax(x[0], x[1]), x[2]);
    const float ymin = tmin(tmin(y[0], y[1]), y[2]);
    const float ymax = tmax(tmax(y[0], y[1]), y[2]);
    const float area = sub(mul(sub(x[1], x[0]), sub(y[2], y[0])),
                           mul(sub(x[2], x[0]), sub(y[1], y[0])));
    const bool big = fabsf(area) > 1e-12f;
    const float inv_area = big ? __frcp_rn(area) : 0.0f;
    ok = ok && big;
    if (a.cull != 0.0f) ok = ok && mul(area, a.cull) > 0.0f;
    const float row[kRow] = {x[0], y[0], z[0], x[1], y[1], z[1],
                             x[2], y[2], z[2], inv_area, ok ? 1.0f : 0.0f,
                             xmin, ymin, xmax, ymax, 0.0f};
    float4* out = reinterpret_cast<float4*>(a.table) + i * (kRow / 4);
#pragma unroll
    for (int q = 0; q < kRow / 4; ++q)
      out[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                           row[4 * q + 3]);
    if (a.key)
      a.key[i] = ok ? -tmax(sub(xmax, xmin), sub(ymax, ymin)) : 1.0f;
    bb[0] = ok ? xmin : 1e9f;
    bb[1] = ok ? ymin : 1e9f;
    bb[2] = ok ? xmax : -1e9f;
    bb[3] = ok ? ymax : -1e9f;
  }
  __shared__ float red[4][kThreads / 32];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = bb[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = k < 2 ? fminf(v, u) : fmaxf(v, u);
    }
    if ((threadIdx.x & 31) == 0) red[k][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    float v = red[k][0];
    for (int j = 1; j < kThreads / 32; ++j)
      v = k < 2 ? fminf(v, red[k][j]) : fmaxf(v, red[k][j]);
    a.part[blockIdx.x * 4 + k] = v;
  }
}

struct Segment {
  long long start;            // its first sample's number in the launch
  int lo, count, kk, by_rank; // ranks (or indices) [lo, lo + count)
};

struct EmitArgs {
  const float* table;         // (T, 16)
  const long long* order;     // (T,) by-edge order, or null
  unsigned* buf;              // (n_px,) z-buffer
  unsigned* ids;              // (n_px,) ids of the depth winners, or null
  const float* part;          // (n_part, 4) CTA bboxes
  int* corner;                // (2,) out: the dense window's x0, y0
  Segment seg[kMaxSegments];
  long long n_samples;
  int n_seg, n_part, W, H, row0, out_h, win, mode, id_pass;
};

// the dense window's corner from the CTA bboxes, one CTA
__device__ void window_corner(const EmitArgs& a) {
  __shared__ float red[4][kThreads / 32];
  float bb[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  for (int j = threadIdx.x; j < a.n_part; j += kThreads) {
    bb[0] = fminf(bb[0], a.part[j * 4]);
    bb[1] = fminf(bb[1], a.part[j * 4 + 1]);
    bb[2] = fmaxf(bb[2], a.part[j * 4 + 2]);
    bb[3] = fmaxf(bb[3], a.part[j * 4 + 3]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = bb[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = k < 2 ? fminf(v, u) : fmaxf(v, u);
    }
    if ((threadIdx.x & 31) == 0) red[k][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = red[k][0];
      for (int j = 1; j < kThreads / 32; ++j)
        v[k] = k < 2 ? fminf(v[k], red[k][j]) : fmaxf(v[k], red[k][j]);
    }
    a.corner[0] = window_start(mul(add(v[0], v[2]), 0.5f), a.win, a.W);
    a.corner[1] = window_start(mul(add(v[1], v[3]), 0.5f), a.win, a.H);
  }
}

__global__ void __launch_bounds__(kThreads)
    raster_emit_kernel(const EmitArgs a) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (a.win > 0 && blockIdx.x == gridDim.x - 1) {
    window_corner(a);
    return;
  }
  if (s >= a.n_samples) return;
  // the sample's segment (static indices only, so the table stays in
  // the parameter space)
  long long start = 0;
  int lo = 0, kk = 1, by_rank = 0;
#pragma unroll
  for (int g = 0; g < kMaxSegments; ++g) {
    if (g < a.n_seg && s >= a.seg[g].start) {
      start = a.seg[g].start;
      lo = a.seg[g].lo;
      kk = a.seg[g].kk;
      by_rank = a.seg[g].by_rank;
    }
  }
  const long long local = s - start;
  const int kk2 = kk * kk;
  const int n = (int)(local / kk2);
  const int q = (int)(local - (long long)n * kk2);
  const int iy = q / kk, ix = q - iy * kk;
  const long long t = by_rank ? a.order[lo + n] : (long long)(lo + n);
  const float4* rp = reinterpret_cast<const float4*>(a.table) + t * 4;
  const float4 r0 = __ldg(rp), r1 = __ldg(rp + 1), r2 = __ldg(rp + 2),
               r3 = __ldg(rp + 3);
  if (!(r2.z > 0.5f)) return;              // not drawable
  const float x0 = r0.x, y0 = r0.y, z0 = r0.z, x1 = r0.w;
  const float y1 = r1.x, z1 = r1.y, x2 = r1.z, y2 = r1.w;
  const float z2 = r2.x, inv = r2.y, xmin = r2.w;
  const float ymin = r3.x, xmax = r3.y, ymax = r3.z;
  // the stride: a tensor over the host scalar kk, times its reciprocal
  const float inv_kk = 1.0f / (float)kk;
  const float sx = tclamp_min(mul(sub(xmax, xmin), inv_kk), 1.0f);
  const float sy = tclamp_min(mul(sub(ymax, ymin), inv_kk), 1.0f);
  const float sxp = add(floorf(add(xmin, mul((float)ix, sx))), 0.5f);
  const float syp = add(floorf(add(ymin, mul((float)iy, sy))), 0.5f);
  const float b1 = mul(sub(mul(sub(sxp, x0), sub(y2, y0)),
                           mul(sub(x2, x0), sub(syp, y0))), inv);
  const float b2 = mul(sub(mul(sub(x1, x0), sub(syp, y0)),
                           mul(sub(sxp, x0), sub(y1, y0))), inv);
  const float b0 = sub(sub(1.0f, b1), b2);
  if (!(b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f)) return;
  const float z = add(add(mul(b0, z0), mul(b1, z1)), mul(b2, z2));
  if (!(z >= 0.0f && z <= 1.0f)) return;
  // truncation toward zero, as the plain version's int64 cast
  const long long xi = (long long)sxp, yi = (long long)syp;
  if (xi < 0 || xi >= a.W || yi < 0 || yi >= a.H) return;
  const long long yl = yi - a.row0;        // the band's own rows
  if (yl < 0 || yl >= a.out_h) return;
  const long long p = yl * a.W + xi;
  const unsigned zq = zq24(z);
  if (a.id_pass) {
    if (zq == a.buf[p]) atomicMin(a.ids + p, (unsigned)t);
  } else {
    atomicMin(a.buf + p, word_of(zq, t, a.mode));
  }
}

struct ResolveArgs {
  const unsigned* buf;        // (out_h, W)
  const unsigned* ids;        // (out_h, W), or null
  const float* table;         // (T, 16)
  const long long* order;     // (T,), or null
  const int* corner;          // (2,) the dense window's x0, y0, or null
  float* depth;               // (out_h, W) out
  long long* tri;             // (out_h, W) out
  int dense_n, W, out_h, row0, win, mode;
};

// a dense triangle in shared memory: x0, y0, y2 - y0, x2 - x0, x1 - x0,
// y1 - y0, 1 / area, z0, z1, z2, and its id (-1: not drawable)
struct Dense {
  float x0, y0, e20y, e20x, e10x, e10y, inv, z0, z1, z2;
  long long t;
};

__global__ void __launch_bounds__(kTx * kTy)
    raster_resolve_kernel(const ResolveArgs a) {
  __shared__ Dense d[kDenseChunk];
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  const bool in = x < a.W && y < a.out_h;
  const size_t o = (size_t)y * a.W + x;
  unsigned w = in ? a.buf[o] : kEmpty;
  bool dense = in && a.dense_n > 0;
  if (dense && a.win > 0) {
    const int cx = a.corner[0], cy = a.corner[1];
    dense = x >= cx && x < cx + a.win && y >= cy && y < cy + a.win;
  }
  if (__syncthreads_or(dense)) {
    const float xg = add((float)x, 0.5f);
    const float yg = add(add((float)y, (float)a.row0), 0.5f);
    const int tid = threadIdx.y * kTx + threadIdx.x;
    for (int c0 = 0; c0 < a.dense_n; c0 += kDenseChunk) {
      const int m = min(kDenseChunk, a.dense_n - c0);
      if (tid < m) {
        const long long t = a.order[c0 + tid];
        const float* r = a.table + t * kRow;
        Dense& e = d[tid];
        e.x0 = r[0];
        e.y0 = r[1];
        e.e20y = sub(r[7], r[1]);
        e.e20x = sub(r[6], r[0]);
        e.e10x = sub(r[3], r[0]);
        e.e10y = sub(r[4], r[1]);
        e.inv = r[9];
        e.z0 = r[2];
        e.z1 = r[5];
        e.z2 = r[8];
        e.t = r[10] > 0.5f ? t : -1;
      }
      __syncthreads();
      if (dense) {
        for (int j = 0; j < m; ++j) {
          const Dense& e = d[j];
          if (e.t < 0) continue;
          const float dx = sub(xg, e.x0), dy = sub(yg, e.y0);
          const float b1 = mul(sub(mul(dx, e.e20y), mul(e.e20x, dy)), e.inv);
          const float b2 = mul(sub(mul(e.e10x, dy), mul(dx, e.e10y)), e.inv);
          const float b0 = sub(sub(1.0f, b1), b2);
          if (!(b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f)) continue;
          const float z = add(add(mul(b0, e.z0), mul(b1, e.z1)),
                              mul(b2, e.z2));
          if (!(z >= 0.0f && z <= 1.0f)) continue;
          w = min(w, word_of(zq24(z), e.t, a.mode));
        }
      }
      __syncthreads();
    }
  }
  if (!in) return;
  if (a.mode == kPacked) {
    a.depth[o] = w == kEmpty ? 1.0f
                             : mul((float)(w >> kTBits), 1.0f / 32768.0f);
    a.tri[o] = w == kEmpty ? -1 : (long long)(w & ((1u << kTBits) - 1));
  } else {
    a.depth[o] = w == kEmpty ? 1.0f : mul((float)w, 1.0f / 16777216.0f);
    const unsigned id = a.ids ? a.ids[o] : kEmpty;
    a.tri[o] = id == kEmpty ? -1 : (long long)id;
  }
}

}  // namespace

// The per-triangle table, sort key and CTA bboxes; the z-buffer (and the
// id buffer, if any) filled with the empty word. clip (V, 4) f32, idx
// (T, 3) i64, table (T, 16) f32, key (T,) f32 or null, part
// (ceil(T / 256), 4) f32, buf and ids (n_px,) u32 (ids null but with ids
// past 2^17). cull is 0, 1 or -1. All contiguous.
extern "C" int mv_raster_setup(const void* clip, const void* idx,
                               void* table, void* key, void* part,
                               void* buf, void* ids, int T, int n_px,
                               int cull, int W, int H, void* stream) {
  const SetupArgs a{(const float*)clip, (const long long*)idx,
                    (float*)table, (float*)key, (float*)part,
                    (unsigned*)buf, (unsigned*)ids, T, n_px, (float)cull,
                    (float)W, (float)H};
  const long long n = T > n_px ? T : n_px;
  if (n == 0) return 0;
  raster_setup_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The emits, the dense window's corner, the id pass (mode 2) and the
// resolve. seg: a host array (n_seg, 5) of int64 (lo, count, kk, by_rank,
// start), read before this returns; order (T,) i64 or null; corner (2,)
// i32 scratch; depth (out_h, W) f32 and tri (out_h, W) i64, written
// whole. mode 0 packs ids, 1 is depth alone, 2 depth with an id pass (no
// dense pass). win > 0: the dense pass only in that square, centred on
// the drawable triangles' bbox.
extern "C" int mv_raster_draw(const void* table, const void* order,
                              void* buf, void* ids, const void* part,
                              int n_part, void* corner, const void* seg,
                              int n_seg, void* depth, void* tri,
                              int dense_n, int W, int H, int row0,
                              int out_h, int win, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_seg < 0 || n_seg > kMaxSegments) return (int)cudaErrorInvalidValue;
  EmitArgs e{};
  e.table = (const float*)table;
  e.order = (const long long*)order;
  e.buf = (unsigned*)buf;
  e.ids = (unsigned*)ids;
  e.part = (const float*)part;
  e.corner = (int*)corner;
  const long long* sg = (const long long*)seg;
  long long n_samples = 0;
  for (int g = 0; g < n_seg; ++g) {
    Segment& s = e.seg[g];
    s.lo = (int)sg[g * 5];
    s.count = (int)sg[g * 5 + 1];
    s.kk = (int)sg[g * 5 + 2];
    s.by_rank = (int)sg[g * 5 + 3];
    s.start = sg[g * 5 + 4];
    n_samples = s.start + (long long)s.count * s.kk * s.kk;
  }
  e.n_samples = n_samples;
  e.n_seg = n_seg;
  e.n_part = n_part;
  e.W = W;
  e.H = H;
  e.row0 = row0;
  e.out_h = out_h;
  e.win = dense_n > 0 ? win : 0;
  e.mode = mode;
  const long long emit_blocks = (n_samples + kThreads - 1) / kThreads;
  const long long blocks = emit_blocks + (e.win > 0 ? 1 : 0);
  if (blocks > 0) {
    raster_emit_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(e);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (mode == kDepthIds && emit_blocks > 0) {
    e.id_pass = 1;
    e.win = 0;
    raster_emit_kernel<<<(unsigned)emit_blocks, kThreads, 0, st>>>(e);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out_h == 0 || W == 0) return 0;
  const ResolveArgs r{(const unsigned*)buf,
                      mode == kDepthIds ? (const unsigned*)ids : nullptr,
                      (const float*)table, (const long long*)order,
                      (const int*)corner, (float*)depth, (long long*)tri,
                      dense_n, W, out_h, row0, dense_n > 0 ? win : 0, mode};
  const dim3 grid((W + kTx - 1) / kTx, (out_h + kTy - 1) / kTy);
  raster_resolve_kernel<<<grid, dim3(kTx, kTy), 0, st>>>(r);
  return (int)cudaGetLastError();
}
