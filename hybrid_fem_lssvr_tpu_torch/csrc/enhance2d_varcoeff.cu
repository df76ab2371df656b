// Fused 2D per-element-operator (variable-coefficient) LSSVR enhancement for
// Hopper (sm_90a), plain C interface.  Replaces the Pallas TPU kernel
// hybrid_fem_lssvr_tpu/ops/pallas_kernels.py::fused_enhance_varcoeff_2d in
// both of its methods:
//
//   varcoeff2d_sne_kernel <- method='sne' (semi-normal equations)
//   varcoeff2d_qr_kernel  <- method='qr'  (CGS2 QR)
//
// For -div(a grad u) + (b . grad + c) u = f each quad has its own
// collocation operator.  With the coefficient fields a, a_x, a_y and the
// rhs f sampled at the C^2 interior collocation points (coef [3][C^2][E],
// f [C^2][E], element index fastest) and the boundary-trace values
// bc [Kb = 4M-4] built as in enhance2d.cu:
//
//   wp = Pbc bc
//   g  = f / s2 - (-a AP0 bc - a_x AP1 bc - a_y AP2 bc + AP3 bc)   [C^2]
//   G_k = -a AZ0_k - a_x AZ1_k - a_y AZ2_k + AZ3_k     k < K = M^2 - Kb
//   y  = argmin ||G y - g||;   w = wp + Z y
//   slack = s2 max |g - G y|;  bcv = max |bc - B w|
//
// AZ / AP are the four host-f64 operator parts (Lap, Gx, Gy, Dconst)
// projected on the null basis Z / the particular map Pbc and scaled by
// 1/s2; with n_terms == 3 the Dconst part is identically zero and skipped.
//
// Built WITHOUT --use_fast_math.  Each entry point launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <limits.h>

#include "enhance_common.cuh"
#include "enhance_qr.cuh"

namespace {

using enh::kEps;
using enh::nan_max;
using enh::trace_bc;
namespace qr = enh::qr;

// The statics as the host packs them (both kernels take this buffer):
//   AZ [4][C2][K], AP [4][C2][KB], Z [M2][K], Pbc [M2][KB], B [KB][M2],
//   pts [8][KB]; both kernels copy them once a block into the padded
// shared-memory layout of qr::Statics (enhance_qr.cuh), whose rows they
// read as 16-byte broadcasts.
constexpr int kBlocks = 4;  // operator blocks: Lap, Gx, Gy, Dconst

template <int M, int C>
using Statics = qr::Statics<M, C, kBlocks>;

// ---------------------------------------------------------------------------
// 1. method='sne': N = G^T G and G^T g accumulated row by row as rank-1
//    updates (G is never stored), an unrolled Cholesky N = L L^T in
//    registers, y = N^-1 G^T g, then one refinement step in the factored
//    system, y += N^-1 G^T (g - G y) (Bjorck's semi-normal method).
//    sqrt(max(., 0)) and the 1e-30 in the divisions are the reference's.
//
// Bound on the H100: operations.  Per quad and row about K (K+1)/2 + K
// FMAs for N and G^T g, ~5 K + 3 Kb to build G's row and g's entry, and
// ~3 K in each of the two later walks (refinement; the final residual for
// the slack, each rebuilding G's row), over C^2 rows, plus w and B w:
// ~17.7 k FMAs a quad at M = C = 6 against 576 B read and 152 B written.
//
// Design: one thread a quad, N's lower triangle (136 floats at K = 16) in
// registers, so 255 registers a thread and 8 warps an SM at most; the
// blocks are persistent (as many as the card holds at once).
// - The statics are read through qr::row_G, qr::row_g and qr::quad_w as
//   float4 broadcasts (the whole warp reads one address).
// - The first walk reads each row's coefficients a, a_x, a_y and f from
//   device memory once, the next row's loads in flight while the current
//   row is processed, and keeps the row weights (-a, -a_x, -a_y) and g in
//   the thread's slots of shared memory: the later walks rebuild G's row
//   from there and no longer rebuild g.
// - bc goes to the slots as well once g is built, so that it is not held
//   in registers across the Cholesky.
// - w goes out through the slots (store_w) in whole lines.
// Slots: slot i of a thread at [i kSneThreads + thread], conflict-free.
// What binds it on the H100 (PERF.md §6): neither the coefficient loads
// nor the shared-memory reads (all of a quad's loads in flight at once,
// or a quarter fewer shared reads, left the time as it was); ~27k
// instructions a quad issue at ~0.7 a cycle with two warps a scheduler.
// w stored a row a thread took an eighth of the time; store_w took most
// of that back.
constexpr int kSneThreads = 256;

template <int M, int C>
struct SneSlots {
  using S = Statics<M, C>;
  static constexpr int CS = 0;                // row weights [C2][3]
  static constexpr int G = CS + 3 * S::C2;    // g [C2]
  static constexpr int BC = G + S::C2;        // bc [KB]
  static constexpr int SIZE = BC + S::KB;
  static constexpr int smem_floats() {
    return S::SIZE + kSneThreads * SIZE;
  }
};

// Row q's residual g_q - G_q y (one fma a term), G's row rebuilt into G
// from the weights and g kept in the thread's slots ``mine``.
template <int M, int C>
__device__ __forceinline__ float sne_residual(const float* s,
                                              const float* mine, int q,
                                              int nb, const float* y,
                                              float* G) {
  using P = SneSlots<M, C>;
  float cs[kBlocks] = {0.f, 0.f, 0.f, 1.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) cs[i] = mine[(P::CS + 3 * q + i) * kSneThreads];
  qr::row_G<M, C, kBlocks>(s, q, cs, nb, G);
  float er = mine[(P::G + q) * kSneThreads];
#pragma unroll
  for (int k = 0; k < P::S::K; ++k) er = fmaf(-G[k], y[k], er);
  return er;
}

// w [E][M2] of the warp's quads e0 .. e0 + 31, each thread's row wv, by
// way of the warp's columns of the slots (all dead by now): a row a thread
// written straight to global memory puts 32 lines under each store, and
// the warp's rows are one contiguous run.  Entry L = lane M2 + m of the run
// sits at L + L / 32 of the warp's slot matrix (row-major, 32 wide), which
// keeps both the row writes and the run reads free of bank conflicts.
// Lanes past the last quad have left the loop: nv lanes take part.
template <int M2>
__device__ __forceinline__ void store_w(float* wst, const float (&wv)[M2],
                                        float* __restrict__ w, int e, int E) {
  constexpr int T = kSneThreads;
  const int lane = threadIdx.x & 31, e0 = e - lane;
  const int nv = E - e0 < 32 ? E - e0 : 32;
  const unsigned mask = nv == 32 ? 0xffffffffu : (1u << nv) - 1u;
#pragma unroll
  for (int m = 0; m < M2; ++m) {
    const int L = lane * M2 + m, i = L + (L >> 5);
    wst[(i >> 5) * T + (i & 31)] = wv[m];
  }
  __syncwarp(mask);
  float* dst = w + (size_t)e0 * M2;
#pragma unroll 4
  for (int L = lane; L < nv * M2; L += nv) {
    const int i = L + (L >> 5);
    dst[L] = wst[(i >> 5) * T + (i & 31)];
  }
  __syncwarp(mask);  // the slots are the next quad's again
}

template <int M, int C>
__global__ void __launch_bounds__(kSneThreads, 1)
varcoeff2d_sne_kernel(const float* __restrict__ fem,
                      const float* __restrict__ coef,
                      const float* __restrict__ f,
                      const float* __restrict__ gedge,
                      const float* __restrict__ statics,
                      float* __restrict__ w, float* __restrict__ slack,
                      float* __restrict__ bcv, int nx, int ny, int nmax,
                      float inv_s2, float s2, int n_terms, int diag) {
  using S = Statics<M, C>;
  using P = SneSlots<M, C>;
  constexpr int K = S::K, C2 = S::C2, KB = S::KB, T = kSneThreads;
  extern __shared__ __align__(16) float s[];
  qr::load_statics<M, C, kBlocks>(s, statics);
  float* mine = s + S::SIZE + threadIdx.x;  // this thread's slot 0
  const int E = nx * ny;
  // With n_terms == 3 the constant part is identically zero and skipped.
  const int nb = n_terms > 3 ? 4 : 3;
  const size_t plane = (size_t)C2 * E;

  for (int e = blockIdx.x * T + threadIdx.x; e < E; e += gridDim.x * T) {
    float bc[KB];
    trace_bc<KB>(fem, gedge, s + S::PTS, e, nx, ny, nmax, bc);
    // N lower triangle, row-major: N[i][k] at i (i + 1) / 2 + k, k <= i.
    float N[K * (K + 1) / 2], b[K];
#pragma unroll
    for (int i = 0; i < K * (K + 1) / 2; ++i) N[i] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) b[k] = 0.f;
    const float* ca = coef + e;
    const float* fa = f + e;
    float c0 = ca[0], c1 = ca[plane], c2 = ca[2 * plane], fq = fa[0];
#pragma unroll 1
    for (int q = 0; q < C2; ++q) {
      const float cs[kBlocks] = {-c0, -c1, -c2, 1.f};
      const float fs = __fmul_rn(fq, inv_s2);
      const size_t o = (size_t)(q + 1 < C2 ? q + 1 : q) * E;
      c0 = ca[o];
      c1 = ca[plane + o];
      c2 = ca[2 * plane + o];
      fq = fa[o];
#pragma unroll
      for (int i = 0; i < 3; ++i) mine[(P::CS + 3 * q + i) * T] = cs[i];
      const float gq = qr::row_g<M, C, kBlocks>(s, q, cs, nb, fs, bc);
      mine[(P::G + q) * T] = gq;
      float G[K];
      qr::row_G<M, C, kBlocks>(s, q, cs, nb, G);
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int k = 0; k <= i; ++k)
          N[i * (i + 1) / 2 + k] = fmaf(G[i], G[k], N[i * (i + 1) / 2 + k]);
        b[i] = fmaf(G[i], gq, b[i]);
      }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) mine[(P::BC + k) * T] = bc[k];

    // Right-looking Cholesky in place: N becomes L, its diagonal holding
    // 1 / (L_jj + eps) (L_jj itself is needed nowhere else).
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float Ljj = sqrtf(nan_max(0.f, N[j * (j + 1) / 2 + j]));
      const float dinv = 1.f / (Ljj + kEps);
      N[j * (j + 1) / 2 + j] = dinv;
#pragma unroll
      for (int i = j + 1; i < K; ++i) N[i * (i + 1) / 2 + j] *= dinv;
#pragma unroll
      for (int i = j + 1; i < K; ++i) {
#pragma unroll
        for (int k = j + 1; k <= i; ++k)
          N[i * (i + 1) / 2 + k] = fmaf(-N[i * (i + 1) / 2 + j],
                                        N[k * (k + 1) / 2 + j],
                                        N[i * (i + 1) / 2 + k]);
      }
    }
    auto chol_solve = [&](float* v) {  // in place: v <- N^-1 v
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v[j] *= N[j * (j + 1) / 2 + j];
#pragma unroll
        for (int i = j + 1; i < K; ++i)
          v[i] = fmaf(-N[i * (i + 1) / 2 + j], v[j], v[i]);
      }
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        v[j] *= N[j * (j + 1) / 2 + j];
#pragma unroll
        for (int i = 0; i < j; ++i)
          v[i] = fmaf(-N[j * (j + 1) / 2 + i], v[j], v[i]);
      }
    };
    float y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = b[k];
    chol_solve(y);
    // Refinement: d = N^-1 G^T (g - G y), G's rows rebuilt from the slots.
#pragma unroll
    for (int k = 0; k < K; ++k) b[k] = 0.f;
#pragma unroll 1
    for (int q = 0; q < C2; ++q) {
      float G[K];
      const float er = sne_residual<M, C>(s, mine, q, nb, y, G);
#pragma unroll
      for (int k = 0; k < K; ++k) b[k] = fmaf(G[k], er, b[k]);
    }
    chol_solve(b);
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] += b[k];

    float sl = 0.f;
    if (diag) {
#pragma unroll 1
      for (int q = 0; q < C2; ++q) {
        float G[K];
        sl = nan_max(sl, fabsf(sne_residual<M, C>(s, mine, q, nb, y, G)));
      }
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) bc[k] = mine[(P::BC + k) * T];
    float wv[S::M2];
    const float bv = qr::quad_w<M, C, kBlocks>(s, bc, y, wv, diag != 0);
    store_w<S::M2>(mine - (threadIdx.x & 31), wv, w, e, E);
    if (diag) {
      slack[e] = s2 * sl;
      bcv[e] = bv;
    }
  }
}

// The sne kernel's dynamic shared memory a block and its blocks resident
// on the card (0 on error, with the CUDA error in *err).
template <int M, int C>
int sne_shape(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  *smem = sizeof(float) * SneSlots<M, C>::smem_floats();
  return enh::resident_blocks(varcoeff2d_sne_kernel<M, C>, cache, device,
                              kSneThreads, *smem, err);
}

template <int M, int C>
cudaError_t launch_sne(int device, cudaStream_t st, const float* fem,
                       const float* coef, const float* f, const float* gedge,
                       const float* statics, float* w, float* slack,
                       float* bcv, int nx, int ny, int nmax, float inv_s2,
                       float s2, int n_terms, int diag) {
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  const int resident = sne_shape<M, C>(device, &smem, &err);
  if (resident == 0) return err;
  const long long need =
      ((long long)nx * ny + kSneThreads - 1) / kSneThreads;
  varcoeff2d_sne_kernel<M, C>
      <<<(unsigned)(need < resident ? need : resident), kSneThreads, smem,
         st>>>(fem, coef, f, gedge, statics, w, slack, bcv, nx, ny, nmax,
               inv_s2, s2, n_terms, diag);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. method='qr': CGS2 QR of G (two Gram-Schmidt passes per column),
//    y = R^-1 Q^T g by back substitution — the algebra of the reference's
//    batched QR, column by column, in enh::qr::enhance_quad
//    (enhance_qr.cuh), shared with graded2d_kernel.
//
// The K columns of Q are needed at once: K C^2 = 576 floats a quad at
// M = C = 6, more than a thread's registers.  Design: a group of eight
// lanes a quad, four quads a warp, each lane holding five of the 36 rows
// of Q in registers; dot products are a lane's partial sum and a butterfly
// of warp shuffles.  The kernel gives the routine each row's weights
// (-a, -a_x, -a_y and 1 for the constant part).  Blocks of kQrWarps warps
// are persistent (as many as the card holds at once), each warp walking
// over groups of four quads; the statics (padded, 32 KB at M = C = 6) are
// loaded once a block.  Bound: operations (~2 K^2 C^2 FMAs for the two
// passes); what binds is the QR's chain of dependent shuffle butterflies
// (enhance_qr.cuh).
constexpr int kQrWarps = 4;
constexpr int kQrThreads = 32 * kQrWarps;

// Row q's weights: G_k = -a AZ0_k - a_x AZ1_k - a_y AZ2_k + AZ3_k and
// g_q = f_q / s2 - (the same of AP bc); the slack's scale is s2.
struct QrWeights {
  const float* coef;
  const float* f;
  size_t plane;
  int E, e;
  float inv_s2, s2;

  __device__ __forceinline__ float slack_scale() const { return s2; }

  __device__ __forceinline__ void operator()(int q, float (&cs)[kBlocks],
                                             float& fq) const {
    const size_t o = (size_t)q * E + e;
    cs[0] = -coef[o];
    cs[1] = -coef[plane + o];
    cs[2] = -coef[2 * plane + o];
    cs[3] = 1.f;
    fq = f[o] * inv_s2;
  }
};

template <int M, int C>
__global__ void __launch_bounds__(kQrThreads, qr::kMinBlocks)
varcoeff2d_qr_kernel(const float* __restrict__ fem,
                     const float* __restrict__ coef,
                     const float* __restrict__ f,
                     const float* __restrict__ gedge,
                     const float* __restrict__ statics,
                     float* __restrict__ w, float* __restrict__ slack,
                     float* __restrict__ bcv, int nx, int ny, int nmax,
                     float inv_s2, float s2, int n_terms, int diag) {
  using S = Statics<M, C>;
  extern __shared__ __align__(16) float s[];
  qr::load_statics<M, C, kBlocks>(s, statics);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / qr::kLanes, sub = lane % qr::kLanes;
  float* sc = s + S::SIZE + warp * qr::kGroups * S::kScratch + grp;
  const int E = nx * ny;
  const int units = (E + qr::kGroups - 1) / qr::kGroups;
  // With n_terms == 3 the constant part is identically zero and skipped.
  const int nb = n_terms > 3 ? 4 : 3;
  QrWeights wt{coef, f, (size_t)S::C2 * E, E, 0, inv_s2, s2};
  for (int u = blockIdx.x * kQrWarps + warp; u < units;
       u += gridDim.x * kQrWarps) {
    const int e0 = u * qr::kGroups + grp;
    const bool active = e0 < E;
    wt.e = active ? e0 : E - 1;
    qr::enhance_quad<M, C, kBlocks>(s, wt, nb, sub, sc, fem, gedge, wt.e,
                                      nx, ny, nmax, w, slack, bcv, active,
                                      diag != 0);
  }
}

// The qr kernel's dynamic shared memory a block and its blocks resident on
// the card (0 on error, with the CUDA error in *err).
template <int M, int C>
int qr_shape(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  *smem = sizeof(float) * Statics<M, C>::smem_floats(kQrWarps);
  return enh::resident_blocks(varcoeff2d_qr_kernel<M, C>, cache, device,
                              kQrThreads, *smem, err);
}

// A method's launch shape at (M, C) (0 = 'sne', 1 = 'qr'): dynamic shared
// memory a block, blocks resident on the card and threads a block.
// Returns 0 or a CUDA error code.
int shape_of(int method, int device, int M, int C, int* smem_bytes,
             int* blocks, int* threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *blocks = 0;
#define X(m, c)                                                \
  if (M == m && C == c)                                        \
    *blocks = method == 1 ? qr_shape<m, c>(device, &smem, &err) \
                          : sne_shape<m, c>(device, &smem, &err);
  ENH2D_SHAPES(X)
#undef X
  *smem_bytes = (int)smem;
  *threads = method == 1 ? kQrThreads : kSneThreads;
  if (*blocks > 0) return 0;
  return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidValue;
}

template <int M, int C>
cudaError_t launch_qr(int device, cudaStream_t st, const float* fem,
                      const float* coef, const float* f, const float* gedge,
                      const float* statics, float* w, float* slack,
                      float* bcv, int nx, int ny, int nmax, float inv_s2,
                      float s2, int n_terms, int diag) {
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  const int resident = qr_shape<M, C>(device, &smem, &err);
  if (resident == 0) return err;
  varcoeff2d_qr_kernel<M, C>
      <<<qr::grid_for(nx * ny, kQrWarps, resident), kQrThreads, smem, st>>>(
          fem, coef, f, gedge, statics, w, slack, bcv, nx, ny, nmax, inv_s2,
          s2, n_terms, diag);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int enhance2d_varcoeff_supported(int M, int C) {
#define X(m, c) if (M == m && C == c) return 1;
  ENH2D_SHAPES(X)
#undef X
  return 0;
}

const char* enhance2d_varcoeff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// method: 0 = 'sne', 1 = 'qr'.
int enhance2d_varcoeff_f32(int device, void* stream, const float* fem,
                           const float* coef, const float* f,
                           const float* gedge, const float* statics, float* w,
                           float* slack, float* bcv, int nx, int ny, int nmax,
                           int M, int C, float inv_s2, float s2, int n_terms,
                           int method, int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1 || (long long)nx * ny > INT_MAX - 64 || n_terms < 3 ||
      n_terms > 4 || method < 0 || method > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                              \
  if (M == m && C == c) {                                                    \
    if (method == 1)                                                         \
      return (int)launch_qr<m, c>(device, st, fem, coef, f, gedge, statics, \
                                  w, slack, bcv, nx, ny, nmax, inv_s2, s2,   \
                                  n_terms, diag);                            \
    return (int)launch_sne<m, c>(device, st, fem, coef, f, gedge, statics,  \
                                 w, slack, bcv, nx, ny, nmax, inv_s2, s2,    \
                                 n_terms, diag);                             \
  }
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// Each kernel's launch shape at (M, C): dynamic shared memory a block,
// blocks resident on the card, threads a block.
int enhance2d_varcoeff_launch_shape(int device, int M, int C,
                                    int* smem_bytes, int* blocks,
                                    int* threads) {
  return shape_of(1, device, M, C, smem_bytes, blocks, threads);
}

int enhance2d_varcoeff_sne_launch_shape(int device, int M, int C,
                                        int* smem_bytes, int* blocks,
                                        int* threads) {
  return shape_of(0, device, M, C, smem_bytes, blocks, threads);
}

}  // extern "C"
