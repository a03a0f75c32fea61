// The LOD sweep's per-frame glue around B7 / B1: B12, the partition, and
// B13, each bucket's store.
//
// Replaces no TPU kernel: the JAX package computes this in XLA inside its
// jitted frame (`multivolumes_tpu/render/sweep.py`,
// `ray_march_view_sweep_lod`: `lod_partition`, `bucket_mips`, the
// Catmull-Smith flags of `warp.catmull_swap_flags`, the bucket loop's
// gathers and its epilogue), fused by the compiler. Eager PyTorch
// dispatched it as about 250 small tensor operations a frame, every one of
// them over N <= 64 rows, and the frame is bound by the host's dispatch, so
// one launch a frame and one a bucket take their place.
// Plain versions: `render/sweep.py:partition_plain`, `bucket_store_plain`.
//
// B12 (`lod_partition_kernel`, one CTA, a thread a volume, looping over N):
//   * the eye in each volume's frame (`math3d.transform_point3`) and its
//     six face frames (`eye_to_face_frames`), in volume order;
//   * the sort key visible ? mip 2^17 + (65536 - trunc(clamp(edge, 0,
//     65535))) : 2^30 and each volume's stable rank: the keys before it,
//     ties broken by volume index, so `order` equals
//     torch.argsort(stable=True);
//   * for each ranked row, its bucket from the host's static table (start,
//     mip_b), the effective mip clamp(clamp(mip, 0, max_mip) + !cube,
//     mip_b, max_mip) (written in volume order) and n_eff = S >> mip;
//   * B1's per-volume operands in rank order: source id, face frames,
//     sample count, run mask (face_mask & visible), and the row's volume
//     as B1's light row;
//   * with a swap basis A, the Catmull-Smith flags of each ranked row: the
//     six face homographies of B = A world_i[:3, :3] in texels
//     (`warp.face_rows`) and the resample-axis choice at the volume's
//     projected centre (`warp.pick_swap_flags`), |dv/dy| < |du/dy|.
// B13 (`lod_store_kernel`, a thread a texel): B1's f32 (count, 6, 4, Sb,
// Sb) output of one bucket, RGB times float(1 / (2 pi)), every channel
// times the face's run mask (0 or 1, a product as the plain version's, so
// NaN stays NaN), rounded to the sweep dtype, transposed where the face's
// flag is set, into color[row, f, c, :Sb, :Sb].
//
// Rounding: every value is computed in the plain version's operation
// order, each operation rounded on its own (`__fmul_rn`, `__fadd_rn`,
// IEEE division), never contracted: the flags are a comparison, where one
// ulp flips a face. The two small matrix products (the eye transform and
// B) are PyTorch's einsum on the card, which rounds each product and then
// sums over the contracted axis: the eye's four terms in pairs, (p0 + p1)
// + (p2 + p3), B's three in order. B12 sums them the same way (a card
// probe over 192 eyes at N = 5 .. 64 matched no other order; the card
// tests hold both products to the library bit for bit).
//
// What bounds them on the card: nothing much. B12 reads and writes about
// 0.3 kB a volume (20 kB at N = 64) and ranks in O(N^2) compares from
// shared memory; B13 reads 16 bytes and writes 8 (bf16) a texel, 19 MB
// for the demo's 8 @ 128 bucket, L2-resident behind B1's store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 8;
constexpr int kMaxN = 8192;
// float(1 / (2 pi)): the plain version's scale, a double rounded to f32
constexpr float kInv2Pi = (float)(1.0 / (2.0 * 3.14159265358979323846));

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp: NaN passes through
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// A 4 x 4 row-vector matrix of one volume, read through its strides
struct Mat {
  const float* p;
  int s1, s2;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[r * s1 + c * s2];
  }
};

struct Table {
  int start[kMaxBuckets];   // first ranked row of each bucket
  int mip[kMaxBuckets];     // its level mip_b
};

struct PartArgs {
  const unsigned char* visible;    // (N,)
  const int* mip_level;            // (N,)
  const float* edge;               // (N,) max_edge_px
  const unsigned char* use_cube;   // (N,)
  const unsigned char* face_mask;  // (N, 6)
  const int* smp_count;            // (N,)
  const long long* tex_ids;        // (N,)
  const float* world_i;            // (N, 4, 4) strided
  const float* wvp;                // (N, 4, 4) strided
  const float* eye;                // (3,)
  const float* basis;              // (3, 3) or null: no flags
  long long* order;                // (N,) out, rank order
  int* mips;                       // (N,) out, volume order
  float* n_eff;                    // (N,) out, rank order
  float* eye_local;                // (N, 3) out, volume order
  float* eye_faces;                // (N, 6, 3) out, volume order
  int* ids;                        // (N,) out, rank order
  int* tex;                        // (N,) out, rank order
  float* faces;                    // (N, 6, 3) out, rank order
  int* smp;                        // (N,) out, rank order
  unsigned char* run;              // (N, 6) out, rank order
  unsigned char* swap;             // (N, 6) out, rank order, or null
  int n, nb, S, max_mip;
  int w0, w1, w2, m0, m1, m2;      // element strides of world_i, wvp
  Table table;
};

// `eye_to_face_frames`: (eu, ev, ew) of face f from the local eye
__device__ __forceinline__ void face_frame(const float* e, int f, float* o) {
  switch (f) {
    case 0: o[0] = -e[2]; o[1] = e[1]; o[2] = e[0]; break;
    case 1: o[0] = e[2]; o[1] = e[1]; o[2] = -e[0]; break;
    case 2: o[0] = e[0]; o[1] = -e[2]; o[2] = e[1]; break;
    case 3: o[0] = e[0]; o[1] = e[2]; o[2] = -e[1]; break;
    case 4: o[0] = e[0]; o[1] = e[1]; o[2] = e[2]; break;
    default: o[0] = -e[0]; o[1] = e[1]; o[2] = -e[2]; break;
  }
}

// `warp._FACES`: axis, sign, (u axis, u coeff), (v axis, v coeff)
struct Face {
  int a;
  float s;
  int bu;
  float cu;
  int bv;
  float cv;
};
__device__ __forceinline__ Face face_of(int f) {
  switch (f) {
    case 0: return {0, 1.0f, 2, -0.5f, 1, -0.5f};
    case 1: return {0, -1.0f, 2, 0.5f, 1, -0.5f};
    case 2: return {1, 1.0f, 0, 0.5f, 2, 0.5f};
    case 3: return {1, -1.0f, 0, 0.5f, 2, -0.5f};
    case 4: return {2, 1.0f, 0, 0.5f, 1, -0.5f};
    default: return {2, -1.0f, 0, -0.5f, 1, -0.5f};
  }
}

// The Catmull-Smith flags of one volume's six faces (`face_rows` +
// `pick_swap_flags`): B (3 x 3) its local basis, o its local eye, ne its
// n_eff, c0 row 3 of its world_view_proj.
__device__ void swap_flags(const float B[3][3], const float* o, float ne,
                           const float* c0, unsigned char* out) {
  const float c0w = fabsf(c0[3]) > 1e-3f ? c0[3] : 1e-3f;
  const float xc = tclamp(div(c0[0], c0w), -1.0f, 1.0f);
  const float yc = tclamp(div(c0[1], c0w), -1.0f, 1.0f);
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const Face fc = face_of(f);
    float den[3], pu[3], pv[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      den[r] = B[r][fc.a];
      const float oa = sub(fc.s, o[fc.a]);
      // face_homography: exit numerators, then nu, nv
      const float eu = add(mul(o[fc.bu], den[r]), mul(oa, B[r][fc.bu]));
      const float ev = add(mul(o[fc.bv], den[r]), mul(oa, B[r][fc.bv]));
      const float half = mul(0.5f, den[r]);
      const float nu = add(half, mul(fc.cu, eu));
      const float nv = add(half, mul(fc.cv, ev));
      // face_rows: in texels
      pu[r] = sub(mul(ne, nu), half);
      pv[r] = sub(mul(ne, nv), half);
    }
    const float dqc = add(add(mul(den[0], xc), mul(den[1], yc)), den[2]);
    const float vqc = add(add(mul(pv[0], xc), mul(pv[1], yc)), pv[2]);
    const float uqc = add(add(mul(pu[0], xc), mul(pu[1], yc)), pu[2]);
    const float dv_dy = sub(mul(pv[1], dqc), mul(den[1], vqc));
    const float du_dy = sub(mul(pu[1], dqc), mul(den[1], uqc));
    out[f] = fabsf(dv_dy) < fabsf(du_dy);
  }
}

__global__ void __launch_bounds__(kThreads)
    lod_partition_kernel(const PartArgs a) {
  extern __shared__ int smem[];
  int* key = smem;                               // (N,) sort keys
  int* rank_vol = smem + a.n;                    // (N,) volume of each rank
  float* el = reinterpret_cast<float*>(smem + 2 * a.n);   // (N, 3) eye
  const float ex = a.eye[0], ey = a.eye[1], ez = a.eye[2];

  for (int v = threadIdx.x; v < a.n; v += blockDim.x) {
    // the sort key; (int) of NaN is 0, as the cast on the card
    const int edge = (int)tclamp(a.edge[v], 0.0f, 65535.0f);
    key[v] = a.visible[v] ? a.mip_level[v] * (1 << 17) + (65536 - edge)
                          : (1 << 30);
    // transform_point3: [eye, 1] @ world_i, summed as the library sums
    const Mat w{a.world_i + (size_t)v * a.w0, a.w1, a.w2};
    float e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[c] = add(add(mul(ex, w(0, c)), mul(ey, w(1, c))),
                 add(mul(ez, w(2, c)), w(3, c)));
      el[v * 3 + c] = e[c];
      a.eye_local[v * 3 + c] = e[c];
    }
#pragma unroll
    for (int f = 0; f < 6; ++f) face_frame(e, f, a.eye_faces + (v * 6 + f) * 3);
  }
  __syncthreads();

  // the stable rank: keys below, and equal keys of lower index
  for (int v = threadIdx.x; v < a.n; v += blockDim.x) {
    const int k = key[v];
    int r = 0;
    for (int u = 0; u < a.n; ++u) {
      const int ku = key[u];
      r += ku < k || (ku == k && u < v);
    }
    rank_vol[r] = v;
    a.order[r] = v;
  }
  __syncthreads();

  float A[3][3];
  if (a.basis) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = a.basis[i * 3 + j];
  }
  for (int j = threadIdx.x; j < a.n; j += blockDim.x) {
    const int v = rank_vol[j];
    int b = 0;
    while (b + 1 < a.nb && a.table.start[b + 1] <= j) ++b;
    // bucket_mips
    const int actual = min(max(a.mip_level[v], 0), a.max_mip);
    const int x = actual + (a.use_cube[v] ? 0 : 1);
    const int eff = min(max(x, a.table.mip[b]), a.max_mip);
    const float ne = (float)(a.S >> eff);
    a.mips[v] = eff;
    a.n_eff[j] = ne;
    a.ids[j] = v;
    a.tex[j] = (int)a.tex_ids[v];
    a.smp[j] = a.smp_count[v];
    const bool vis = a.visible[v];
    const float* e = el + v * 3;
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      a.run[j * 6 + f] = a.face_mask[v * 6 + f] && vis;
      face_frame(e, f, a.faces + (j * 6 + f) * 3);
    }
    if (a.basis) {
      // local_basis: A @ world_i[:3, :3], summed as the library sums
      const Mat w{a.world_i + (size_t)v * a.w0, a.w1, a.w2};
      float B[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          B[i][k] = add(add(mul(A[i][0], w(0, k)), mul(A[i][1], w(1, k))),
                        mul(A[i][2], w(2, k)));
      const Mat m{a.wvp + (size_t)v * a.m0, a.m1, a.m2};
      const float c0[4] = {m(3, 0), m(3, 1), m(3, 2), m(3, 3)};
      swap_flags(B, e, ne, c0, a.swap + j * 6);
    }
  }
}

struct StoreArgs {
  const float* scatter;            // (count, 6, 4, Sb, Sb)
  const unsigned char* run;        // (count, 6)
  const unsigned char* swap;       // (count, 6) or null
  const long long* rows;           // (count,) or null: row0 + k
  void* color;                     // (N, 6, 4, S, S) bf16 or f32
  int count, Sb, S, row0;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lod_store_kernel(const StoreArgs a) {
  const int kf = blockIdx.y;                     // (volume, face)
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = a.Sb * a.Sb;
  if (t >= plane) return;
  const int i = t / a.Sb, j = t - (t / a.Sb) * a.Sb;
  const bool sw = a.swap != nullptr && a.swap[kf];
  const float m = a.run[kf] ? 1.0f : 0.0f;
  const int k = kf / 6, f = kf - (kf / 6) * 6;
  const long long row = a.rows ? a.rows[k] : (long long)(a.row0 + k);
  const float* src = a.scatter + (size_t)kf * 4 * plane +
                     (sw ? j * a.Sb + i : t);
  const size_t out_plane = (size_t)a.S * a.S;
  T* dst = static_cast<T*>(a.color) + ((size_t)row * 6 + f) * 4 * out_plane +
           (size_t)i * a.S + j;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float x = src[(size_t)c * plane];
    if (c < 3) x = mul(x, kInv2Pi);
    store(dst + c * out_plane, mul(x, m));
  }
}

}  // namespace

// B12. visible, use_cube (N,) u8; mip_level, smp_count (N,) i32; edge (N,)
// f32; face_mask (N, 6) u8; tex_ids (N,) i64; world_i, wvp (N, 4, 4) f32
// with element strides w0..w2, m0..m2; eye (3,) f32; basis (3, 3) f32 or
// null (no flags); table: 2 kMaxBuckets ints on the host, the buckets'
// first rows, then their mips (nb of each); the outputs as in PartArgs.
extern "C" int mv_lod_partition(
    const void* visible, const void* mip_level, const void* edge,
    const void* use_cube, const void* face_mask, const void* smp_count,
    const void* tex_ids, const void* world_i, const void* wvp,
    const void* eye, const void* basis, const void* table, void* order,
    void* mips, void* n_eff, void* eye_local, void* eye_faces, void* ids,
    void* tex, void* faces, void* smp, void* run, void* swap, int n, int nb,
    int S, int max_mip, int w0, int w1, int w2, int m0, int m1, int m2,
    void* stream) {
  if (n < 1 || n > kMaxN || nb < 1 || nb > kMaxBuckets)
    return (int)cudaErrorInvalidValue;
  PartArgs a{(const unsigned char*)visible, (const int*)mip_level,
             (const float*)edge, (const unsigned char*)use_cube,
             (const unsigned char*)face_mask, (const int*)smp_count,
             (const long long*)tex_ids, (const float*)world_i,
             (const float*)wvp, (const float*)eye, (const float*)basis,
             (long long*)order, (int*)mips, (float*)n_eff,
             (float*)eye_local, (float*)eye_faces, (int*)ids, (int*)tex,
             (float*)faces, (int*)smp, (unsigned char*)run,
             (unsigned char*)swap, n, nb, S, max_mip, w0, w1, w2, m0, m1,
             m2, {}};
  const int* tab = (const int*)table;
  for (int b = 0; b < kMaxBuckets; ++b) {
    a.table.start[b] = tab[b];
    a.table.mip[b] = tab[kMaxBuckets + b];
  }
  const size_t smem = (size_t)n * 5 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lod_partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = min(kThreads, (n + 31) / 32 * 32);
  lod_partition_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// B13. scatter (count, 6, 4, Sb, Sb) f32; run (count, 6) u8; swap (count,
// 6) u8 or null; rows (count,) i64 or null (rows row0 + k); color (N, 6,
// 4, S, S), bf16 when `bf16`, else f32.
extern "C" int mv_lod_store(const void* scatter, const void* run,
                            const void* swap, const void* rows, void* color,
                            int count, int Sb, int S, int row0, int bf16,
                            void* stream) {
  if (count == 0) return 0;
  const StoreArgs a{(const float*)scatter, (const unsigned char*)run,
                    (const unsigned char*)swap, (const long long*)rows,
                    color, count, Sb, S, row0};
  const dim3 grid((Sb * Sb + kThreads - 1) / kThreads, count * 6);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    lod_store_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    lod_store_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
