// Shear-warp light march: the self scan (B3) and the advect-multiply (B4).
//
// Replaces multivolumes_tpu/ops/pallas/lightsweep_kernel.py:
//   light_self_scan_pallas (has_sm=False)  -> mv_light_self_scan
//   light_self_scan_pallas (has_sm=True)   -> mv_light_self_scan_sm
//   light_advect_mul_pallas                -> mv_light_advect_mul
//
// What it computes, per cohort volume c (one CTA each), over its L slices:
//   B3:  here_k = B(s),   s <- here_k * (1 - 0.8 rho_k)^f,   s_0 = 1
//   B4:  t <- B(t),       out_k = here_k * t,                 t_0 = t_in
// with the lateral shear B(x) = mv @ x @ mu^T. mv/mu are constant-shift
// linear-clamp resample matrices (lightsweep._interp_matrix_shift): row a
// of mv has at most two non-zeros, at floor(clip(a - dv)) and the next
// row. So B is applied here as a 2-tap separable lerp whose taps and
// weights are the same for every slice: O(L^2) per slice, where the TPU
// kernel's dense MXU products are O(L^3).
//
// What bounds it on the card: the L dependent slices. Each slice reads
// the (L, L) carry (36 KB at L = 96) and writes one (L, L) output plane;
// the total traffic (~7 MB per volume at L = 96) is small, so the time is
// L x (one plane of FMAs + one __syncthreads) on a single SM per volume.
// The carry lives in shared memory, ping-ponged between two planes (72 KB
// at L = 96, opt-in dynamic shared memory above 48 KB); the per-row and
// per-column taps are computed once per volume into shared memory.
// A cohort of one volume (the per-frame refresh) uses one SM of 132:
// splitting a volume's plane over a cluster of CTAs is later work.
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
// the bit. Shared memory: s and e each ping-ponged, 4 planes = 144 KB at
// L = 96 (3 carries ping-ponged, as the TPU kernel's, would be 216 KB of
// the 227 KB a CTA may have). The extra cost per slice is one plane of
// lerps, kept in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAbsorption = 0.8f;
constexpr int kThreads = 512;

// Shared layout: cur (L*L) | nxt (L*L) | v0 (L int) | wv (L) | u0 (L int) | wu (L)
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

// B(x)[a, d] as the 2 x 2 tap lerp of x (row-major (L, L) in shared memory)
__device__ __forceinline__ float bshift_at(const float* x, int l, int a,
                                           int d, const int* v0,
                                           const float* wv, const int* u0,
                                           const float* wu) {
  int r0 = v0[a], c0 = u0[d];
  int r1 = min(r0 + 1, l - 1), c1 = min(c0 + 1, l - 1);
  float fv = wv[a], fu = wu[d];
  float top = x[r0 * l + c0] * (1.0f - fu) + x[r0 * l + c1] * fu;
  float bot = x[r1 * l + c0] * (1.0f - fu) + x[r1 * l + c1] * fu;
  return top * (1.0f - fv) + bot * fv;
}

// B(x)[a, d] like bshift_at, every operation rounded on its own, in the
// plain version's order (ops/lightsweep.py: bshift_lerp)
__device__ __forceinline__ float bshift_at_rn(const float* x, int l, int a,
                                              int d, const int* v0,
                                              const float* wv, const int* u0,
                                              const float* wu) {
  int r0 = v0[a], c0 = u0[d];
  int r1 = min(r0 + 1, l - 1), c1 = min(c0 + 1, l - 1);
  float fv = wv[a], fu = wu[d];
  float gu = __fsub_rn(1.0f, fu), gv = __fsub_rn(1.0f, fv);
  float top = __fadd_rn(__fmul_rn(x[r0 * l + c0], gu),
                        __fmul_rn(x[r0 * l + c1], fu));
  float bot = __fadd_rn(__fmul_rn(x[r1 * l + c0], gu),
                        __fmul_rn(x[r1 * l + c1], fu));
  return __fadd_rn(__fmul_rn(top, gv), __fmul_rn(bot, fv));
}

// B3 (kSm = false) and B3' (kSm = true, the shadow plane e ping-ponged
// beside s; e0, dz_slice and soft are unused without it)
template <bool kSm>
__global__ void self_scan_kernel(const float* __restrict__ rho,
                                 const float* __restrict__ du,
                                 const float* __restrict__ dv,
                                 const float* __restrict__ f_corr,
                                 const float* __restrict__ e0,
                                 const float* __restrict__ dz_slice,
                                 const float* __restrict__ soft,
                                 float* __restrict__ here,
                                 float* __restrict__ s_out, int l) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int plane = l * l;
  constexpr int kPlanes = kSm ? 4 : 2;
  float* cur = smem;
  float* nxt = smem + plane;
  float* ecur = smem + 2 * plane;
  float* enxt = smem + 3 * plane;
  int* v0 = reinterpret_cast<int*>(smem + kPlanes * plane);
  float* wv = smem + kPlanes * plane + l;
  int* u0 = reinterpret_cast<int*>(smem + kPlanes * plane + 2 * l);
  float* wu = smem + kPlanes * plane + 3 * l;

  setup_taps(l, dv[c], du[c], v0, wv, u0, wu);
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    cur[i] = 1.0f;
    if constexpr (kSm) ecur[i] = e0[(size_t)c * plane + i];
  }
  __syncthreads();

  const float f = f_corr[c];
  const float dz = kSm ? dz_slice[c] : 0.0f, sf = kSm ? soft[c] : 1.0f;
  const size_t vol = (size_t)c * l * plane;
  for (int k = 0; k < l; ++k) {
    const float* rho_k = rho + vol + (size_t)k * plane;
    float* here_k = here + vol + (size_t)k * plane;
    const float dzk = k == 0 ? 0.5f * dz : dz;
    for (int i = threadIdx.x; i < plane; i += blockDim.x) {
      int a = i / l, d = i - a * l;
      float sh = bshift_at(cur, l, a, d, v0, wv, u0, wu);
      if constexpr (kSm) {
        float e = __fsub_rn(bshift_at_rn(ecur, l, a, d, v0, wv, u0, wu), dzk);
        enxt[i] = e;
        float lit = fminf(fmaxf(__fadd_rn(__fdiv_rn(e, sf), 1.0f), 0.0f),
                          1.0f);
        here_k[i] = sh * lit;
      } else {
        here_k[i] = sh;
      }
      float atten = exp2f(f * log2f(fmaxf(1.0f - rho_k[i] * kAbsorption,
                                          1e-7f)));
      nxt[i] = sh * atten;
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
    if constexpr (kSm) { t = ecur; ecur = enxt; enxt = t; }
  }
  for (int i = threadIdx.x; i < plane; i += blockDim.x)
    s_out[(size_t)c * plane + i] = cur[i];
}

__global__ void advect_mul_kernel(const float* __restrict__ here,
                                  const float* __restrict__ t_in,
                                  const float* __restrict__ du,
                                  const float* __restrict__ dv,
                                  float* __restrict__ out, int l) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int plane = l * l;
  float* cur = smem;
  float* nxt = smem + plane;
  int* v0 = reinterpret_cast<int*>(smem + 2 * plane);
  float* wv = smem + 2 * plane + l;
  int* u0 = reinterpret_cast<int*>(smem + 2 * plane + 2 * l);
  float* wu = smem + 2 * plane + 3 * l;

  setup_taps(l, dv[c], du[c], v0, wv, u0, wu);
  for (int i = threadIdx.x; i < plane; i += blockDim.x)
    cur[i] = t_in[(size_t)c * plane + i];
  __syncthreads();

  const size_t vol = (size_t)c * l * plane;
  for (int k = 0; k < l; ++k) {
    const float* here_k = here + vol + (size_t)k * plane;
    float* out_k = out + vol + (size_t)k * plane;
    for (int i = threadIdx.x; i < plane; i += blockDim.x) {
      int a = i / l, d = i - a * l;
      float t = bshift_at(cur, l, a, d, v0, wv, u0, wu);
      nxt[i] = t;
      out_k[i] = here_k[i] * t;
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
}

// `planes` (L, L) f32 carries plus the four tap tables
size_t smem_bytes(int l, int planes = 2) {
  return (size_t)(planes * l * l + 4 * l) * sizeof(float);
}

template <typename K>
cudaError_t prepare(K kernel, int l, int planes = 2) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(l, planes));
}

}  // namespace

extern "C" int mv_light_self_scan(const void* rho, const void* du,
                                  const void* dv, const void* f_corr,
                                  void* here, void* s_out, int c, int l,
                                  void* stream) {
  cudaError_t err = prepare(self_scan_kernel<false>, l);
  if (err != cudaSuccess) return (int)err;
  self_scan_kernel<false><<<c, kThreads, smem_bytes(l),
                            (cudaStream_t)stream>>>(
      (const float*)rho, (const float*)du, (const float*)dv,
      (const float*)f_corr, nullptr, nullptr, nullptr, (float*)here,
      (float*)s_out, l);
  return (int)cudaGetLastError();
}

extern "C" int mv_light_self_scan_sm(const void* rho, const void* du,
                                     const void* dv, const void* f_corr,
                                     const void* e0, const void* dz_slice,
                                     const void* soft, void* here,
                                     void* s_out, int c, int l,
                                     void* stream) {
  cudaError_t err = prepare(self_scan_kernel<true>, l, 4);
  if (err != cudaSuccess) return (int)err;
  self_scan_kernel<true><<<c, kThreads, smem_bytes(l, 4),
                           (cudaStream_t)stream>>>(
      (const float*)rho, (const float*)du, (const float*)dv,
      (const float*)f_corr, (const float*)e0, (const float*)dz_slice,
      (const float*)soft, (float*)here, (float*)s_out, l);
  return (int)cudaGetLastError();
}

extern "C" int mv_light_advect_mul(const void* here, const void* t_in,
                                   const void* du, const void* dv,
                                   void* out, int c, int l, void* stream) {
  cudaError_t err = prepare(advect_mul_kernel, l);
  if (err != cudaSuccess) return (int)err;
  advect_mul_kernel<<<c, kThreads, smem_bytes(l), (cudaStream_t)stream>>>(
      (const float*)here, (const float*)t_in, (const float*)du,
      (const float*)dv, (float*)out, l);
  return (int)cudaGetLastError();
}
