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
using enh::load_statics;
using enh::nan_max;
using enh::trace_bc;
namespace qr = enh::qr;

// The statics as the host packs them (both kernels take this buffer), and
// the sne kernel's shared-memory copy of them:
//   AZ [4][C2][K], AP [4][C2][KB], Z [M2][K], Pbc [M2][KB], B [KB][M2],
//   pts [8][KB].
template <int M, int C>
struct Layout {
  static constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4, K = M2 - KB;
  static constexpr int AZ = 0;
  static constexpr int AP = AZ + 4 * C2 * K;
  static constexpr int Z = AP + 4 * C2 * KB;
  static constexpr int PBC = Z + M2 * K;
  static constexpr int B = PBC + M2 * KB;
  static constexpr int PTS = B + KB * M2;
  static constexpr int SIZE = PTS + 8 * KB;
};

// One collocation row q of the scaled system: the K entries of G and the
// rhs entry g, from the coefficients at that point.
template <int M, int C>
__device__ __forceinline__ float row_of_G(const float* s, int q, float a,
                                          float ax, float ay, float fq,
                                          const float* bc, float inv_s2,
                                          bool has_const, float* Grow) {
  using L = Layout<M, C>;
  const float* AZ = s + L::AZ;
  const float* AP = s + L::AP;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
  for (int k = 0; k < L::KB; ++k) {
    p0 += AP[(0 * L::C2 + q) * L::KB + k] * bc[k];
    p1 += AP[(1 * L::C2 + q) * L::KB + k] * bc[k];
    p2 += AP[(2 * L::C2 + q) * L::KB + k] * bc[k];
  }
  if (has_const) {
#pragma unroll
    for (int k = 0; k < L::KB; ++k)
      p3 += AP[(3 * L::C2 + q) * L::KB + k] * bc[k];
  }
#pragma unroll
  for (int k = 0; k < L::K; ++k) {
    float v = -a * AZ[(0 * L::C2 + q) * L::K + k] -
              ax * AZ[(1 * L::C2 + q) * L::K + k] -
              ay * AZ[(2 * L::C2 + q) * L::K + k];
    if (has_const) v += AZ[(3 * L::C2 + q) * L::K + k];
    Grow[k] = v;
  }
  return fq * inv_s2 - (-a * p0 - ax * p1 - ay * p2 + p3);
}

// w = wp + Z y written to its [M2] row; returns bcv = max |bc - B w|
// (0 when diag is false).
template <int M, int C>
__device__ __forceinline__ float write_w(const float* s, const float* bc,
                                         const float* y, float* wrow,
                                         bool diag) {
  using L = Layout<M, C>;
  const float* Z = s + L::Z;
  const float* Pbc = s + L::PBC;
  const float* Bm = s + L::B;
  float bw[L::KB];
#pragma unroll
  for (int k = 0; k < L::KB; ++k) bw[k] = 0.f;
#pragma unroll 4
  for (int m = 0; m < L::M2; ++m) {
    float wp = 0.f, zy = 0.f;
#pragma unroll
    for (int k = 0; k < L::KB; ++k) wp += Pbc[m * L::KB + k] * bc[k];
#pragma unroll
    for (int k = 0; k < L::K; ++k) zy += Z[m * L::K + k] * y[k];
    const float wm = wp + zy;
    wrow[m] = wm;
    if (diag) {
#pragma unroll
      for (int k = 0; k < L::KB; ++k) bw[k] += Bm[k * L::M2 + m] * wm;
    }
  }
  float bv = 0.f;
  if (diag) {
#pragma unroll
    for (int k = 0; k < L::KB; ++k) bv = nan_max(bv, fabsf(bc[k] - bw[k]));
  }
  return bv;
}

// ---------------------------------------------------------------------------
// 1. method='sne': N = G^T G and G^T g accumulated row by row as rank-1
//    updates (G is never stored), an unrolled Cholesky N = L L^T in
//    registers, y = N^-1 G^T g, then one refinement step in the factored
//    system, y += N^-1 G^T (g - G y) (Bjorck's semi-normal method).
//    sqrt(max(., 0)) and the 1e-30 in the divisions are the reference's.
//
// Bound on the H100: operations.  Per quad and row about K (K+1)/2 + 5 K
// + 4 Kb FMAs in the first pass (~300 at M = C = 6) and ~170 in each of
// the two later passes (refinement; final residual for the slack) over
// C^2 rows: ~23 k FMAs against 576 B read and 152 B written.  Design: one
// thread per quad, N (136 entries at K = 16) in registers; the later
// passes read the coefficients again (their 576 B a quad are still in L2
// for most of a wave).
constexpr int kSneThreads = 128;

template <int M, int C>
__global__ void __launch_bounds__(kSneThreads)
varcoeff2d_sne_kernel(const float* __restrict__ fem,
                      const float* __restrict__ coef,
                      const float* __restrict__ f,
                      const float* __restrict__ gedge,
                      const float* __restrict__ statics,
                      float* __restrict__ w, float* __restrict__ slack,
                      float* __restrict__ bcv, int nx, int ny, int nmax,
                      float inv_s2, float s2, int n_terms, int diag) {
  using L = Layout<M, C>;
  constexpr int K = L::K, C2 = L::C2, KB = L::KB;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, L::SIZE);
  const int E = nx * ny;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const bool has_const = n_terms > 3;
  float bc[KB];
  trace_bc<KB>(fem, gedge, s + L::PTS, e, nx, ny, nmax, bc);
  const float* ca = coef + e;
  const size_t plane = (size_t)C2 * E;

  // N lower triangle, row-major: N[i][k] at i (i + 1) / 2 + k, k <= i.
  float N[K * (K + 1) / 2];
  float b[K], Grow[K];
#pragma unroll
  for (int i = 0; i < K * (K + 1) / 2; ++i) N[i] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) b[k] = 0.f;
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    const size_t o = (size_t)q * E;
    const float gq = row_of_G<M, C>(s, q, ca[o], ca[plane + o],
                                    ca[2 * plane + o], f[o + e], bc, inv_s2,
                                    has_const, Grow);
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) N[i * (i + 1) / 2 + k] += Grow[i] * Grow[k];
      b[i] += Grow[i] * gq;
    }
  }
  // Right-looking Cholesky in place: N becomes L, dinv = 1 / (L_jj + eps).
  float dinv[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float Ljj = sqrtf(nan_max(0.f, N[j * (j + 1) / 2 + j]));
    N[j * (j + 1) / 2 + j] = Ljj;
    dinv[j] = 1.f / (Ljj + kEps);
#pragma unroll
    for (int i = j + 1; i < K; ++i) N[i * (i + 1) / 2 + j] *= dinv[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
#pragma unroll
      for (int k = j + 1; k <= i; ++k)
        N[i * (i + 1) / 2 + k] -=
            N[i * (i + 1) / 2 + j] * N[k * (k + 1) / 2 + j];
    }
  }
  auto chol_solve = [&](float* v) {  // in place: v <- N^-1 v
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] *= dinv[j];
#pragma unroll
      for (int i = j + 1; i < K; ++i) v[i] -= N[i * (i + 1) / 2 + j] * v[j];
    }
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      v[j] *= dinv[j];
#pragma unroll
      for (int i = 0; i < j; ++i) v[i] -= N[j * (j + 1) / 2 + i] * v[j];
    }
  };
  float y[K];
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] = b[k];
  chol_solve(y);
  // Refinement: d = N^-1 G^T (g - G y).
#pragma unroll
  for (int k = 0; k < K; ++k) b[k] = 0.f;
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    const size_t o = (size_t)q * E;
    float er = row_of_G<M, C>(s, q, ca[o], ca[plane + o], ca[2 * plane + o],
                              f[o + e], bc, inv_s2, has_const, Grow);
#pragma unroll
    for (int k = 0; k < K; ++k) er -= Grow[k] * y[k];
#pragma unroll
    for (int k = 0; k < K; ++k) b[k] += Grow[k] * er;
  }
  chol_solve(b);
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] += b[k];

  const float bv = write_w<M, C>(s, bc, y, w + (size_t)e * L::M2, diag != 0);
  if (!diag) return;
  float sl = 0.f;
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    const size_t o = (size_t)q * E;
    float er = row_of_G<M, C>(s, q, ca[o], ca[plane + o], ca[2 * plane + o],
                              f[o + e], bc, inv_s2, has_const, Grow);
#pragma unroll
    for (int k = 0; k < K; ++k) er -= Grow[k] * y[k];
    sl = nan_max(sl, fabsf(er));
  }
  slack[e] = s2 * sl;
  bcv[e] = bv;
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
constexpr int kQrBlocks = 4;  // operator blocks: Lap, Gx, Gy, Dconst
constexpr int kQrWarps = 4;
constexpr int kQrThreads = 32 * kQrWarps;

template <int M, int C>
using QrStatics = qr::Statics<M, C, kQrBlocks>;

// Row q's weights: G_k = -a AZ0_k - a_x AZ1_k - a_y AZ2_k + AZ3_k and
// g_q = f_q / s2 - (the same of AP bc); the slack's scale is s2.
struct QrWeights {
  const float* coef;
  const float* f;
  size_t plane;
  int E, e;
  float inv_s2, s2;

  __device__ __forceinline__ float slack_scale() const { return s2; }

  __device__ __forceinline__ void operator()(int q, float (&cs)[kQrBlocks],
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
  using S = QrStatics<M, C>;
  extern __shared__ __align__(16) float s[];
  qr::load_statics<M, C, kQrBlocks>(s, statics);
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
    qr::enhance_quad<M, C, kQrBlocks>(s, wt, nb, sub, sc, fem, gedge, wt.e,
                                      nx, ny, nmax, w, slack, bcv, active,
                                      diag != 0);
  }
}

// The qr kernel's dynamic shared memory a block and its blocks resident on
// the card (0 on error, with the CUDA error in *err).
template <int M, int C>
int qr_shape(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  *smem = sizeof(float) * QrStatics<M, C>::smem_floats(kQrWarps);
  return enh::resident_blocks(varcoeff2d_qr_kernel<M, C>, cache, device,
                              kQrThreads, *smem, err);
}

int launch_shape(int device, int M, int C, size_t* smem, cudaError_t* err) {
#define X(m, c) \
  if (M == m && C == c) return qr_shape<m, c>(device, smem, err);
  ENH2D_SHAPES(X)
#undef X
  *err = cudaErrorInvalidValue;
  return 0;
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
  const int E = nx * ny;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                              \
  if (M == m && C == c) {                                                    \
    if (method == 1)                                                         \
      return (int)launch_qr<m, c>(device, st, fem, coef, f, gedge, statics, \
                                  w, slack, bcv, nx, ny, nmax, inv_s2, s2,   \
                                  n_terms, diag);                            \
    varcoeff2d_sne_kernel<m, c>                                              \
        <<<(unsigned)((E + kSneThreads - 1) / kSneThreads), kSneThreads,     \
           sizeof(float) * Layout<m, c>::SIZE, st>>>(                        \
            fem, coef, f, gedge, statics, w, slack, bcv, nx, ny, nmax,       \
            inv_s2, s2, n_terms, diag);                                      \
    return (int)cudaGetLastError();                                          \
  }
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The qr kernel's launch shape at (M, C): dynamic shared memory a block,
// blocks resident on the card, threads a block.
int enhance2d_varcoeff_launch_shape(int device, int M, int C,
                                    int* smem_bytes, int* blocks,
                                    int* threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *blocks = launch_shape(device, M, C, &smem, &err);
  *smem_bytes = (int)smem;
  *threads = kQrThreads;
  return *blocks > 0 ? 0 : (int)err;
}

}  // extern "C"
