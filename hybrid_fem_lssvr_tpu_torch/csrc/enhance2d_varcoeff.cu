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

#include "enhance_common.cuh"

namespace {

using enh::kEps;
using enh::load_statics;
using enh::nan_max;
using enh::trace_bc;

// Shared-memory layout of the statics, common to both kernels:
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
//    batched QR, column by column.
//
// The K columns of Q are needed at once: K C^2 = 576 floats a quad at
// M = C = 6, more than a thread's registers.  Design: one thread per quad,
// 64 quads a block; Q (built in place over G), g and R live in dynamic
// shared memory laid out [slot][thread] (conflict-free): (K + 1) C^2 +
// K (K + 1) / 2 floats a thread, which with the statics is 221 KB a block
// at M = C = 6: one block, two warps, an SM.  Bound: operations
// (~2 K^2 C^2 FMAs for the two passes); the low occupancy and one
// shared-memory read per FMA make it slow next to 'sne'.
constexpr int kQrThreads = 64;

template <int M, int C>
__global__ void __launch_bounds__(kQrThreads)
varcoeff2d_qr_kernel(const float* __restrict__ fem,
                     const float* __restrict__ coef,
                     const float* __restrict__ f,
                     const float* __restrict__ gedge,
                     const float* __restrict__ statics,
                     float* __restrict__ w, float* __restrict__ slack,
                     float* __restrict__ bcv, int nx, int ny, int nmax,
                     float inv_s2, float s2, int n_terms, int diag) {
  using L = Layout<M, C>;
  constexpr int K = L::K, C2 = L::C2, KB = L::KB;
  constexpr int T = kQrThreads;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, L::SIZE);
  float* Q = s + L::SIZE + threadIdx.x;        // Q[(k C2 + q) T]
  float* gs = Q + (size_t)K * C2 * T;          // gs[q T]
  float* R = gs + (size_t)C2 * T;              // R[(j (j + 1) / 2 + i) T]
  const int E = nx * ny;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const bool has_const = n_terms > 3;
  float bc[KB];
  trace_bc<KB>(fem, gedge, s + L::PTS, e, nx, ny, nmax, bc);
  const float* ca = coef + e;
  const size_t plane = (size_t)C2 * E;

  float Grow[K];
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    const size_t o = (size_t)q * E;
    gs[q * T] = row_of_G<M, C>(s, q, ca[o], ca[plane + o], ca[2 * plane + o],
                               f[o + e], bc, inv_s2, has_const, Grow);
#pragma unroll
    for (int k = 0; k < K; ++k) Q[(k * C2 + q) * T] = Grow[k];
  }
  float v[C2];
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int q = 0; q < C2; ++q) v[q] = Q[(j * C2 + q) * T];
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
      for (int i = 0; i < j; ++i) {
        const float* qi = Q + (size_t)i * C2 * T;
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains for ILP
#pragma unroll
        for (int q = 0; q < C2; ++q) part[q & 3] += qi[q * T] * v[q];
        const float rij = (part[0] + part[1]) + (part[2] + part[3]);
        float* r = R + (j * (j + 1) / 2 + i) * T;
        *r = pass == 0 ? rij : *r + rij;
#pragma unroll
        for (int q = 0; q < C2; ++q) v[q] -= rij * qi[q * T];
      }
    }
    float nrm = 0.f;
#pragma unroll
    for (int q = 0; q < C2; ++q) nrm += v[q] * v[q];
    const float rjj = sqrtf(nrm);
    R[(j * (j + 1) / 2 + j) * T] = rjj;
    const float inv = 1.f / (rjj + kEps);
#pragma unroll
    for (int q = 0; q < C2; ++q) Q[(j * C2 + q) * T] = v[q] * inv;
  }
  float y[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float acc = 0.f;
#pragma unroll 4
    for (int q = 0; q < C2; ++q) acc += Q[(j * C2 + q) * T] * gs[q * T];
#pragma unroll
    for (int i = j + 1; i < K; ++i)
      acc -= R[(i * (i + 1) / 2 + j) * T] * y[i];
    y[j] = acc / (R[(j * (j + 1) / 2 + j) * T] + kEps);
  }
  const float bv = write_w<M, C>(s, bc, y, w + (size_t)e * L::M2, diag != 0);
  if (!diag) return;
  float sl = 0.f;
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    const size_t o = (size_t)q * E;
    row_of_G<M, C>(s, q, ca[o], ca[plane + o], ca[2 * plane + o], f[o + e],
                   bc, inv_s2, has_const, Grow);
    float er = gs[q * T];
#pragma unroll
    for (int k = 0; k < K; ++k) er -= Grow[k] * y[k];
    sl = nan_max(sl, fabsf(er));
  }
  slack[e] = s2 * sl;
  bcv[e] = bv;
}

template <int M, int C>
constexpr size_t qr_smem_bytes() {
  using L = Layout<M, C>;
  return sizeof(float) *
         (L::SIZE + (size_t)kQrThreads *
                        ((L::K + 1) * L::C2 + L::K * (L::K + 1) / 2));
}

template <int M, int C>
cudaError_t launch_qr(cudaStream_t st, const float* fem, const float* coef,
                      const float* f, const float* gedge,
                      const float* statics, float* w, float* slack,
                      float* bcv, int nx, int ny, int nmax, float inv_s2,
                      float s2, int n_terms, int diag) {
  constexpr size_t smem = qr_smem_bytes<M, C>();
  // Above 48 KB dynamic shared memory is opt-in, per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      varcoeff2d_qr_kernel<M, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int E = nx * ny;
  varcoeff2d_qr_kernel<M, C>
      <<<(unsigned)((E + kQrThreads - 1) / kQrThreads), kQrThreads, smem,
         st>>>(fem, coef, f, gedge, statics, w, slack, bcv, nx, ny, nmax,
               inv_s2, s2, n_terms, diag);
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
  if (nx < 1 || ny < 1 || n_terms < 3 || n_terms > 4 || method < 0 ||
      method > 1)
    return (int)cudaErrorInvalidValue;
  const int E = nx * ny;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                              \
  if (M == m && C == c) {                                                    \
    if (method == 1)                                                         \
      return (int)launch_qr<m, c>(st, fem, coef, f, gedge, statics, w,       \
                                  slack, bcv, nx, ny, nmax, inv_s2, s2,      \
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

}  // extern "C"
