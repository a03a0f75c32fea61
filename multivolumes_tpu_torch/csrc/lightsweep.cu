// Shear-warp light march: the self scan (B3, B3') and the advect-multiply (B4).
//
// Replaces multivolumes_tpu/ops/pallas/lightsweep_kernel.py:
//   light_self_scan_pallas (has_sm=False)  -> mv_light_self_scan
//   light_self_scan_pallas (has_sm=True)   -> mv_light_self_scan_sm
//   light_advect_mul_pallas                -> mv_light_advect_mul
//
// What it computes, per cohort volume c, over its L slices:
//   B3:  here_k = B(s),   s <- here_k * (1 - 0.8 rho_k)^f,   s_0 = 1
//   B4:  t <- B(t),       out_k = here_k * t,                 t_0 = t_in
// with the lateral shear B(x) = mv @ x @ mu^T. mv/mu are constant-shift
// linear-clamp resample matrices (lightsweep._interp_matrix_shift): row a
// of mv has at most two non-zeros, at floor(clip(a - dv)) and the next
// row. So B is applied here as a 2-tap separable lerp whose taps and
// weights are the same for every slice: O(L^2) per slice, where the TPU
// kernel's dense MXU products are O(L^3).
//
// What bounds it on the card: the chain of L dependent slices. Only
// s_{k+1} = B(s_k) * a_k is serial; the attenuation a_k = (1 - 0.8
// rho_k)^f depends on the density alone, and the traffic (rho in, here
// out, ~7 MB per volume at L = 96) is small except for a full refresh of
// many volumes. The self scan is built so that a slice of the chain is
// one band of shared-memory taps and one barrier:
//   * The carry plane is split over a thread-block cluster. Each CTA of
//     the cluster owns a band of ceil(L / cluster) full-width rows of s
//     (and of e), ping-ponged in its own shared memory; a tap on a row of
//     another band is read from its owner's shared memory
//     (cluster.map_shared_rank), so any shift works and no halo is copied.
//     One cluster barrier per slice (arrive after the band is written,
//     wait before the next slice's taps) covers the ping-pong swap and the
//     remote reads. The last band may be shorter, or empty.
//   * The density streams ahead of the scan: every thread copies the rho
//     of its own texels with cp.async into a ring of kRing slices, and
//     between a slice's barrier arrive and wait, off the chain, turns the
//     next slice's rho into a_k in place (the special-function work).
//     A thread reads back only what it copied itself, so the ring needs
//     no barrier of its own.
//   * here_k leaves through shared memory: the band is written to one of
//     kHere stages and one thread sends it with a bulk copy
//     (cp.async.bulk) after the slice's barrier. The chain's threads touch
//     only shared memory and registers. (Bulk copies need 16-byte rows:
//     where L % 4 != 0 the threads store to device memory directly.)
//   * The cluster size follows the cohort: the largest of 8, 4, 2, 1 whose
//     clusters all run at once with one CTA on an SM
//     (cudaOccupancyMaxActiveClusters, the SM count), whose CTA fits the
//     shared memory and whose bands keep kMinBandTexels texels (a barrier
//     between SMs costs about 0.5 us, more than a smaller band saves); 8
//     for the per-frame refresh of one volume of 96^3, 2 for a full
//     refresh of 64, 1 for a 20^3 test volume. Chosen from those numbers
//     before the launch; a launch that is refused is an error, never
//     retried.
// Measured (NVIDIA H100, 700 W, L = 96, device time): one volume 0.17 ms
// (0.20 with the shadow plane), 64 volumes 0.40 (0.53); the launch with an
// empty body, 96 cluster barriers, takes 0.066 ms at every cluster size,
// 0.69 us a barrier: the floor of the chain. One CTA per volume with the
// density read inside the chain took 0.56 (0.85) and 1.00 (1.28) ms.
//
// The advect-multiply (B4) is a third instantiation of the same banded
// scan (kMode = kAdvect): the carry starts from t_in's band instead of 1,
// the ring streams here_k instead of the density (no attenuation), and
// the chain's step is the shear alone, t <- B(t). The product out_k =
// here_k * t leaves the chain: each thread forms it between the slice's
// barrier arrive and wait from its own carry texels and its own ring
// copies, and stores it to device memory itself (measured: bulk copies
// from stages, published one slice later, were 1% slower). Measured
// (NVIDIA H100, 700 W, device time): one volume 0.14 ms, 8 volumes 0.14,
// 64 volumes 0.29; the chain floor is the scan's, 0.069. The earlier
// port, one CTA of 512 threads per volume with here_k read inside the
// chain, took 0.33 / 0.73 / 0.82.
//
// B3 with the mesh's shadow map (has_sm=True). The TPU kernel carries
// three planes, s, sm and z, and compares B(sm) - z_k per slice against
// a softness of one slice of light-space depth. Here the shadow term is
// carried as ONE plane, e_k = B^{k+1}(sm - z_entry) - (k + 1/2) dz (the
// same function: B is linear and its rows sum to 1), so
//   e <- B(e) - dz (dz/2 at k = 0),  lit = clip(e / soft + 1, 0, 1),
//   here_k = B(s) * lit,  s <- B(s) * (1 - 0.8 rho_k)^f.
// Why: soft is ~1e-4 at the demo scale, so lit amplifies any rounding of
// the compared planes ~1e4 times; carrying e keeps the compare out of a
// difference of two planes near 0.5, and the e lerp is written with
// __fmul_rn / __fadd_rn (never contracted into an FMA) in the plain
// version's order, so the kernel reproduces the plain version's lit to
// the bit. e is banded and ping-ponged like s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr float kAbsorption = 0.8f;
constexpr int kRing = 4;           // input slices in flight
constexpr int kHere = 3;           // self scan: output stages
constexpr int kMaxScanThreads = 512;
constexpr int kUnroll = 4;         // self scan: rows of a thread in flight
constexpr int kMinBandTexels = 1024;  // no band smaller than this

// Tap tables in shared memory: v0 (L int) | wv (L) | u0 (L int) | wu (L)
__device__ __forceinline__ void setup_taps(int l, float dv, float du,
                                           int* v0, float* wv, int* u0,
                                           float* wu) {
  for (int i = threadIdx.x; i < l; i += blockDim.x) {
    float sv = fminf(fmaxf((float)i - dv, 0.0f), (float)(l - 1));
    float fv = floorf(sv);
    v0[i] = (int)fv;
    wv[i] = sv - fv;
    float su = fminf(fmaxf((float)i - du, 0.0f), (float)(l - 1));
    float fu = floorf(su);
    u0[i] = (int)fu;
    wu[i] = su - fu;
  }
}

// The 2 x 2 tap lerp of B(x): t<row><column> are the four taps
__device__ __forceinline__ float tap_lerp(float t00, float t01, float t10,
                                          float t11, float fu, float fv) {
  float top = t00 * (1.0f - fu) + t01 * fu;
  float bot = t10 * (1.0f - fu) + t11 * fu;
  return top * (1.0f - fv) + bot * fv;
}

// The same with every operation rounded on its own, in the plain
// version's order (ops/lightsweep.py: bshift_lerp)
__device__ __forceinline__ float tap_lerp_rn(float t00, float t01, float t10,
                                             float t11, float fu, float fv) {
  float gu = __fsub_rn(1.0f, fu), gv = __fsub_rn(1.0f, fv);
  float top = __fadd_rn(__fmul_rn(t00, gu), __fmul_rn(t01, fu));
  float bot = __fadd_rn(__fmul_rn(t10, gu), __fmul_rn(t11, fu));
  return __fadd_rn(__fmul_rn(top, gv), __fmul_rn(bot, fv));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// writes to shared memory by this thread become visible to bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst), "r"(s), "r"(bytes)
      : "memory");
}
// all but the newest kPending bulk stores have read their shared memory
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float atten_of(float rho, float f) {
  return exp2f(f * log2f(fmaxf(1.0f - rho * kAbsorption, 1e-7f)));
}

// Turn this thread's texels of a ring slot from density into attenuation
// in place, kUnroll at a time (the special-function chains of the rows
// overlap)
__device__ __forceinline__ void to_atten(float* slot, int rr, int row_end,
                                         int rpp, int l, int d, float f) {
  for (int ar0 = rr; ar0 < row_end; ar0 += kUnroll * rpp) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ar0 + u * rpp < row_end) x[u] = slot[(ar0 + u * rpp) * l + d];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ar0 + u * rpp < row_end)
        slot[(ar0 + u * rpp) * l + d] = atten_of(x[u], f);
  }
}

// The three launches of the banded scan
enum : int { kScan = 0, kScanSm = 1, kAdvect = 2 };

// output stages of a launch (the advect-multiply stores directly)
__host__ __device__ constexpr int stages_of(int mode) {
  return mode == kAdvect ? 0 : kHere;
}

// B3 (kScan), B3' (kScanSm: the shadow plane e banded and ping-ponged
// beside s; e0, dz_slice and soft are unused without it) and B4
// (kAdvect: src is here, the carry starts from t_in, out is the product;
// f_corr and s_out are unused, and `bulk` is 0).
// Grid: `cluster` CTAs per volume, one cluster each; CTA `rank` owns rows
// [rank * band, min(L, (rank + 1) * band)). Thread t works on column
// t % L of rows t / L, t / L + rpp, ... of the band (rpp rows a pass), so
// its column taps stay in registers and kUnroll rows are in flight at
// once. kBody = false leaves only the per-slice barrier: the floor of the
// chain, for the measurement.
// Shared layout, in floats, with bl = band * L:
//   output stages (stages_of(kMode) * bl) | input ring (kRing * bl) | cur
//   | nxt [| ecur | enxt] (bl each) | v0 | wv | u0 | wu | per output row:
//   owner and offset of its two tap rows (L each)
template <int kMode, bool kBody>
__global__ void self_scan_kernel(const float* __restrict__ src,
                                 const float* __restrict__ du,
                                 const float* __restrict__ dv,
                                 const float* __restrict__ f_corr,
                                 const float* __restrict__ e0,
                                 const float* __restrict__ dz_slice,
                                 const float* __restrict__ soft,
                                 const float* __restrict__ t_in,
                                 float* __restrict__ out,
                                 float* __restrict__ s_out, int l, int band,
                                 int rpp, int bulk) {
  constexpr bool kSm = kMode == kScanSm;
  constexpr bool kAdv = kMode == kAdvect;
  extern __shared__ __align__(16) float scan_mem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int plane = l * l;
  const int bl = band * l;
  const int r_lo = min(rank * band, l), r_hi = min(r_lo + band, l);
  const int rows = r_hi - r_lo, n_tex = rows * l;
  constexpr int kPlanes = kSm ? 4 : 2;
  float* hst = scan_mem;
  float* ring = hst + stages_of(kMode) * bl;
  float* cur = ring + kRing * bl;
  float* nxt = cur + bl;
  float* ecur = nxt + bl;
  float* enxt = ecur + bl;
  float* tabs = cur + kPlanes * bl;
  int* v0 = reinterpret_cast<int*>(tabs);
  float* wv = tabs + l;
  int* u0 = reinterpret_cast<int*>(tabs + 2 * l);
  float* wu = tabs + 3 * l;
  int* own0 = reinterpret_cast<int*>(tabs + 4 * l);
  int* off0 = own0 + l;
  int* own1 = off0 + l;
  int* off1 = own1 + l;

  if constexpr (!kBody) {
    cluster.sync();
    for (int k = 0; k < l; ++k) {
      if (cs > 1) { cluster_arrive(); cluster_wait(); }
      else __syncthreads();
    }
    return;
  }

  // this thread's column and first row of the band; its texels are
  // (rr + p * rpp) * l + d for the passes p with rr + p * rpp < rows
  const int rr = tid / l, d = tid - rr * l;
  const int row_end = rr < rpp ? rows : 0;

  setup_taps(l, dv[c], du[c], v0, wv, u0, wu);
  __syncthreads();
  for (int a = tid; a < l; a += blockDim.x) {
    const int r0 = v0[a], r1 = min(r0 + 1, l - 1);
    own0[a] = r0 / band;
    off0[a] = (r0 - own0[a] * band) * l;
    own1[a] = r1 / band;
    off1[a] = (r1 - own1[a] * band) * l;
  }
  for (int ar = rr; ar < row_end; ar += rpp) {
    const int i = ar * l + d;
    cur[i] = kAdv ? t_in[(size_t)c * plane + r_lo * l + i] : 1.0f;
    if constexpr (kSm) ecur[i] = e0[(size_t)c * plane + r_lo * l + i];
  }
  const int c0 = u0[d], c1 = min(c0 + 1, l - 1);
  const float fu = wu[d];
  const float f = kAdv ? 0.0f : f_corr[c];
  const float dz = kSm ? dz_slice[c] : 0.0f, sf = kSm ? soft[c] : 1.0f;
  const size_t vol = (size_t)c * l * plane + (size_t)r_lo * l;
  const float* src_b = src + vol;     // this band of slice 0
  float* out_b = out + vol;

  // fill the ring: slices 0 .. kRing-1, one cp.async group each
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    if (s < l)
      for (int ar = rr; ar < row_end; ar += rpp)
        cp_async4(ring + s * bl + ar * l + d,
                  src_b + (size_t)s * plane + ar * l + d);
    cp_async_commit();
  }
  cp_async_wait<kRing - 1>();          // slice 0 is here
  if constexpr (!kAdv) to_atten(ring, rr, row_end, rpp, l, d, f);
  cluster.sync();   // tables, cur and ecur of every band are written

  for (int k = 0; k < l; ++k) {
    const float* a_k = ring + (k % kRing) * bl;
    float* hs = hst + (k % kHere) * bl;
    float* out_k = out_b + (size_t)k * plane;
    const float dzk = k == 0 ? 0.5f * dz : dz;
    // the chain: one band of taps on the carry of slice k - 1, kUnroll
    // rows at a time: all their (remote) reads first, then the arithmetic
    for (int ar0 = rr; ar0 < row_end; ar0 += kUnroll * rpp) {
      float s00[kUnroll], s01[kUnroll], s10[kUnroll], s11[kUnroll];
      float e00[kUnroll], e01[kUnroll], e10[kUnroll], e11[kUnroll];
      float fv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ar = ar0 + u * rpp;
        if (ar < row_end) {
          const int a = r_lo + ar;
          const int o0 = own0[a], o1 = own1[a], f0 = off0[a], f1 = off1[a];
          fv[u] = wv[a];
          // this CTA's own rows by their local address: the window onto
          // the cluster's shared memory is the slower way to them
          const float* row0 =
              (o0 == rank ? cur : cluster.map_shared_rank(cur, o0)) + f0;
          const float* row1 =
              (o1 == rank ? cur : cluster.map_shared_rank(cur, o1)) + f1;
          s00[u] = row0[c0]; s01[u] = row0[c1];
          s10[u] = row1[c0]; s11[u] = row1[c1];
          if constexpr (kSm) {
            const float* er0 =
                (o0 == rank ? ecur : cluster.map_shared_rank(ecur, o0)) + f0;
            const float* er1 =
                (o1 == rank ? ecur : cluster.map_shared_rank(ecur, o1)) + f1;
            e00[u] = er0[c0]; e01[u] = er0[c1];
            e10[u] = er1[c0]; e11[u] = er1[c1];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ar = ar0 + u * rpp;
        if (ar < row_end) {
          const int i = ar * l + d;
          const float sh = tap_lerp(s00[u], s01[u], s10[u], s11[u], fu,
                                    fv[u]);
          if constexpr (kAdv) {
            nxt[i] = sh;
          } else {
            float res = sh;
            if constexpr (kSm) {
              const float e = __fsub_rn(
                  tap_lerp_rn(e00[u], e01[u], e10[u], e11[u], fu, fv[u]),
                  dzk);
              enxt[i] = e;
              const float lit = fminf(
                  fmaxf(__fadd_rn(__fdiv_rn(e, sf), 1.0f), 0.0f), 1.0f);
              res = sh * lit;
            }
            if (bulk) hs[i] = res; else out_k[i] = res;
            nxt[i] = sh * a_k[i];
          }
        }
      }
    }
    if (bulk) {
      fence_async_shared();
      // the stage the next slice writes has been sent
      if (tid == 0) bulk_wait_read<kHere - 2>();
    }
    // a cluster of one CTA needs only the CTA's own, cheaper barrier
    if (cs > 1) cluster_arrive();
    // off the chain: the advect's product from this thread's own carry
    // texels and ring copies; then refill the ring slot just used, and
    // (the scan) turn the next slice's density into its attenuation
    if constexpr (kAdv)
      for (int ar = rr; ar < row_end; ar += rpp) {
        const int i = ar * l + d;
        out_k[i] = nxt[i] * a_k[i];
      }
    if (k + kRing < l)
      for (int ar = rr; ar < row_end; ar += rpp)
        cp_async4(ring + (k % kRing) * bl + ar * l + d,
                  src_b + (size_t)(k + kRing) * plane + ar * l + d);
    cp_async_commit();
    cp_async_wait<kRing - 1>();        // slice k + 1 is here
    if constexpr (!kAdv)
      if (k + 1 < l)
        to_atten(ring + ((k + 1) % kRing) * bl, rr, row_end, rpp, l, d, f);
    if (cs > 1) cluster_wait(); else __syncthreads();
    if (bulk && tid == 0 && n_tex > 0)
      bulk_store(out_k, hs, (unsigned)n_tex * sizeof(float));
    float* t = cur; cur = nxt; nxt = t;
    if constexpr (kSm) { t = ecur; ecur = enxt; enxt = t; }
  }
  if constexpr (!kAdv)
    for (int ar = rr; ar < row_end; ar += rpp)
      s_out[(size_t)c * plane + r_lo * l + ar * l + d] = cur[ar * l + d];
  if (bulk && tid == 0) bulk_wait_all();
}

// ---- host side -----------------------------------------------------------

// the launch shape of a banded scan, chosen from the cohort and the grid
struct ScanPlan {
  int cluster, band, rpp, threads, active_clusters;
  size_t smem;
};

size_t scan_smem_bytes(int l, int band, int mode) {
  const int planes = stages_of(mode) + kRing + (mode == kScanSm ? 4 : 2);
  return ((size_t)planes * band * l + 8 * l) * sizeof(float);
}

ScanPlan scan_shape(int cs, int l, int mode) {
  ScanPlan p{};
  p.cluster = cs;
  p.band = (l + cs - 1) / cs;
  p.smem = scan_smem_bytes(l, p.band, mode);
  // rows a pass: as many as kMaxScanThreads hold, evened over the passes
  const int fit = kMaxScanThreads / l > 0 ? kMaxScanThreads / l : 1;
  const int passes = (p.band + fit - 1) / fit;
  p.rpp = (p.band + passes - 1) / passes;
  p.threads = (p.rpp * l + 31) / 32 * 32;
  return p;
}

// opt in, once per kernel, to the device's largest dynamic shared memory
template <typename K>
cudaError_t allow_max_smem(K kernel, int* max_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(max_bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_bytes);
}

void scan_config(const ScanPlan& p, int c, cudaStream_t stream,
                 cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(c * p.cluster);
  cfg->blockDim = dim3(p.threads);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The plan of a cohort of c volumes of side l: the largest cluster of 8,
// 4, 2, 1 CTAs whose bands hold at least kMinBandTexels texels (below
// that the barrier between SMs costs more than the band saves), whose CTA
// fits the shared memory, and whose c clusters run at once with one CTA
// on an SM; if no size does, the smallest that fits. `force` > 0 takes
// that cluster size (the floor measurement). Decided from the occupancy
// numbers before the launch, cached per (c, l).
template <int kMode>
cudaError_t scan_plan(int c, int l, int force, ScanPlan* out) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, ScanPlan> cache;
  static int max_smem = 0, n_sm = 0;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err;
  if (max_smem == 0) {
    int dev = 0;
    err = allow_max_smem(self_scan_kernel<kMode, true>, &max_smem);
    if (err == cudaSuccess)
      err = allow_max_smem(self_scan_kernel<kMode, false>, &max_smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) { max_smem = 0; return err; }
  }
  auto hit = cache.find({c, l});
  if (force == 0 && hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  ScanPlan plan{};
  for (int cs = 8; cs >= 1; cs /= 2) {
    if (force > 0 && cs != force) continue;
    if (force == 0 && cs > 1 && l * l / cs < kMinBandTexels) continue;
    ScanPlan p = scan_shape(cs, l, kMode);
    if (p.smem > (size_t)max_smem) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    scan_config(p, c, nullptr, &cfg, &attr);
    err = cudaOccupancyMaxActiveClusters(&p.active_clusters,
                                         self_scan_kernel<kMode, true>, &cfg);
    if (err != cudaSuccess) return err;
    if (p.active_clusters < 1) continue;
    plan = p;
    if (c <= p.active_clusters && c * cs <= n_sm) break;
  }
  if (plan.cluster == 0) return cudaErrorInvalidConfiguration;
  if (force == 0) cache[{c, l}] = plan;
  *out = plan;
  return cudaSuccess;
}

template <int kMode, bool kBody>
cudaError_t launch_scan(const void* src, const void* du, const void* dv,
                        const void* f_corr, const void* e0,
                        const void* dz_slice, const void* soft,
                        const void* t_in, void* out, void* s_out, int c,
                        int l, int force, cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  ScanPlan p;
  cudaError_t err = scan_plan<kMode>(c, l, force, &p);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  scan_config(p, c, stream, &cfg, &attr);
  err = cudaLaunchKernelEx(
      &cfg, self_scan_kernel<kMode, kBody>, (const float*)src,
      (const float*)du, (const float*)dv, (const float*)f_corr,
      (const float*)e0, (const float*)dz_slice, (const float*)soft,
      (const float*)t_in, (float*)out, (float*)s_out, l, p.band, p.rpp,
      (int)(kMode != kAdvect && l % 4 == 0));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_floor(int c, int l, int cluster, cudaStream_t stream) {
  return launch_scan<kMode, false>(nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, c, l, cluster, stream);
}

template <int kMode>
cudaError_t scan_info(int c, int l, int* out) {
  ScanPlan p;
  cudaError_t err = scan_plan<kMode>(c, l, 0, &p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  int per_sm = 0;
  err = cudaFuncGetAttributes(&fa, self_scan_kernel<kMode, true>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, self_scan_kernel<kMode, true>, p.threads, p.smem);
  if (err != cudaSuccess) return err;
  out[0] = p.cluster; out[1] = p.band; out[2] = p.threads;
  out[3] = (int)p.smem; out[4] = fa.numRegs; out[5] = per_sm;
  out[6] = p.active_clusters; out[7] = (int)fa.sharedSizeBytes;
  return cudaSuccess;
}

}  // namespace

extern "C" int mv_light_self_scan(const void* rho, const void* du,
                                  const void* dv, const void* f_corr,
                                  void* here, void* s_out, int c, int l,
                                  void* stream) {
  return (int)launch_scan<kScan, true>(rho, du, dv, f_corr, nullptr,
                                       nullptr, nullptr, nullptr, here,
                                       s_out, c, l, 0, (cudaStream_t)stream);
}

extern "C" int mv_light_self_scan_sm(const void* rho, const void* du,
                                     const void* dv, const void* f_corr,
                                     const void* e0, const void* dz_slice,
                                     const void* soft, void* here,
                                     void* s_out, int c, int l,
                                     void* stream) {
  return (int)launch_scan<kScanSm, true>(rho, du, dv, f_corr, e0, dz_slice,
                                         soft, nullptr, here, s_out, c, l, 0,
                                         (cudaStream_t)stream);
}

extern "C" int mv_light_advect_mul(const void* here, const void* t_in,
                                   const void* du, const void* dv,
                                   void* out, int c, int l, void* stream) {
  return (int)launch_scan<kAdvect, true>(here, du, dv, nullptr, nullptr,
                                         nullptr, nullptr, t_in, out,
                                         nullptr, c, l, 0,
                                         (cudaStream_t)stream);
}

// The launch of (c, l) of `mode` (0 the self scan, 1 with the shadow map,
// 2 the advect-multiply) with an empty body: L cluster barriers and
// nothing else, the floor of the dependent chain (for the measurement).
// `cluster` > 0 takes that cluster size in place of the planned one.
extern "C" int mv_light_scan_floor(int c, int l, int mode, int cluster,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kScan: return (int)launch_floor<kScan>(c, l, cluster, st);
    case kScanSm: return (int)launch_floor<kScanSm>(c, l, cluster, st);
    case kAdvect: return (int)launch_floor<kAdvect>(c, l, cluster, st);
  }
  return (int)cudaErrorInvalidValue;
}

// out[0..7] = cluster size, rows per band, threads per CTA, dynamic shared
// memory per CTA (bytes), registers per thread, CTAs per SM, clusters that
// run at once, static shared memory (bytes) of the launch of (c, l) of
// `mode` (as mv_light_scan_floor)
extern "C" int mv_light_scan_info(int c, int l, int mode, int* out) {
  switch (mode) {
    case kScan: return (int)scan_info<kScan>(c, l, out);
    case kScanSm: return (int)scan_info<kScanSm>(c, l, out);
    case kAdvect: return (int)scan_info<kAdvect>(c, l, out);
  }
  return (int)cudaErrorInvalidValue;
}
