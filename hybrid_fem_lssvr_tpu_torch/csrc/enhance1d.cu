// Fused 1D LSSVR enhancement kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels, each replacing one Pallas TPU kernel of
// hybrid_fem_lssvr_tpu/ops/pallas_kernels.py:
//
//   separable_kernel  <- fused_enhance_separable
//   shared_kernel     <- fused_enhance_shared
//   varcoeff_kernel   <- fused_enhance_varcoeff
//
// Design common to all three: one thread per element.  The host-f64
// operators ("statics", at most a few hundred floats) are copied once per
// block into shared memory and read there as warp-wide broadcasts.  Nodal
// values fem[e], fem[e+1] and the sampled per-element inputs (laid out
// [rows][E], element index fastest) are read with coalesced loads; all
// per-element algebra runs in registers, with M and C as template
// parameters so every small array stays in registers; w is written
// straight to its [E, M] row.  The ragged edge (E not a multiple of the
// block) is masked, so any E is accepted.
//
// Built WITHOUT --use_fast_math: the diagnostics gate tests isfinite() and
// the max reductions propagate NaN as jnp.max does on the TPU.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include "enhance_common.cuh"

namespace {

using enh::kEps;
using enh::load_statics;
using enh::nan_max;
using enh::nan_min;

constexpr int kThreads = 128;
constexpr int kMaxR = 4;  // rank of a separable rhs (MAX_FACTORS in Python)

// ---------------------------------------------------------------------------
// 1. Separable rhs (replaces pallas_kernels.py::fused_enhance_separable).
//
//   w     = WfF^T a + Wbc bc            a = R element factors
//   slack = max_c |PF^T a + Qres bc|    exact-algebra residual
//   bcv   = max_k |bc_k - (B w)_k|      from the computed w
//   ok    = finite(slack, bcv) && bcv <= 0.01 (1 + max|bc|)   (optional)
//   w     = ok ? (finite(w) ? w : 0) : linear fallback         (optional)
//
// Bound on the H100: bytes.  Per element it moves one nodal value (the
// neighbour's is shared through L1), R = 2 factor rows, w[M] and up to
// three diagnostics: about 56 B at M = 8, against ~2 (R + 2) (M + C)
// flops.  Design: one pass, coalesced row reads, w written once with the
// gate and fallback fused in (no second read-modify-write of [E, M]).
//
// statics: WfF^T [M][R], Wbc [M][2], PF^T [C][R], Qres [C][2], B [2][M].
template <int M, int C>
__global__ void __launch_bounds__(kThreads)
separable_kernel(const float* __restrict__ fem, const float* __restrict__ a,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv,
                 float* __restrict__ ok, int E, int R, int diag,
                 int fallback) {
  extern __shared__ float s[];
  load_statics(s, statics, M * R + 2 * M + C * R + 2 * C + 2 * M);
  const float* WfFT = s;
  const float* Wbc = WfFT + M * R;
  const float* PFT = Wbc + 2 * M;
  const float* Qres = PFT + C * R;
  const float* Bm = Qres + 2 * C;

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float av[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) av[r] = (r < R) ? a[(size_t)r * E + e] : 0.f;
  const float b0 = fem[e], b1 = fem[e + 1];

  float wv[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float acc = WfFT[m * R] * av[0];
#pragma unroll
    for (int r = 1; r < kMaxR; ++r)
      if (r < R) acc += WfFT[m * R + r] * av[r];
    acc += Wbc[2 * m] * b0;
    acc += Wbc[2 * m + 1] * b1;
    wv[m] = acc;
  }
  float* wrow = w + (size_t)e * M;
  if (!diag) {
#pragma unroll
    for (int m = 0; m < M; ++m) wrow[m] = wv[m];
    return;
  }
  float sl = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float er = PFT[c * R] * av[0];
#pragma unroll
    for (int r = 1; r < kMaxR; ++r)
      if (r < R) er += PFT[c * R + r] * av[r];
    er += Qres[2 * c] * b0;
    er += Qres[2 * c + 1] * b1;
    sl = nan_max(sl, fabsf(er));
  }
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    r0 += Bm[m] * wv[m];
    r1 += Bm[M + m] * wv[m];
  }
  const float bv = nan_max(fabsf(b0 - r0), fabsf(b1 - r1));
  slack[e] = sl;
  bcv[e] = bv;
  if (fallback) {
    const bool fin = isfinite(sl) && isfinite(bv);
    const float scale = 1.f + nan_max(fabsf(b0), fabsf(b1));
    const bool okv = fin && (bv <= 0.01f * scale);
    ok[e] = okv ? 1.f : 0.f;
    // Linear interpolant [(b0+b1)/2, (b1-b0)/2, 0, ...] as mask products,
    // so a NaN boundary value poisons every coefficient as on the TPU.
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float wf = (m == 0 ? 1.f : 0.f) * 0.5f * (b0 + b1) +
                       (m == 1 ? 1.f : 0.f) * 0.5f * (b1 - b0);
      const float safe = isfinite(wv[m]) ? wv[m] : 0.f;
      wv[m] = okv ? safe : wf;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) wrow[m] = wv[m];
}

// ---------------------------------------------------------------------------
// 2. Generic rhs (replaces pallas_kernels.py::fused_enhance_shared).
//
//   w     = Wf f + Wbc bc       f = rhs sampled at the C collocation points
//   slack = max_c |f - D w|,  bcv = max_k |bc - B w|      (optional)
//
// Bound on the H100: bytes.  Per element it reads C = 12 rhs samples
// (48 B) and a nodal value and writes w[M] plus two diagnostics (~40 B),
// against ~4 M C flops.  Design: the rhs rows are read coalesced, the
// [M, C] contraction runs from shared-memory broadcasts into registers.
//
// statics: Wf [M][C], Wbc [M][2], D [C][M], B [2][M].
template <int M, int C>
__global__ void __launch_bounds__(kThreads)
shared_kernel(const float* __restrict__ fem, const float* __restrict__ f,
              const float* __restrict__ statics, float* __restrict__ w,
              float* __restrict__ slack, float* __restrict__ bcv, int E,
              int diag) {
  extern __shared__ float s[];
  load_statics(s, statics, M * C + 2 * M + C * M + 2 * M);
  const float* Wf = s;
  const float* Wbc = Wf + M * C;
  const float* D = Wbc + 2 * M;
  const float* Bm = D + C * M;

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float fc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) fc[c] = f[(size_t)c * E + e];
  const float b0 = fem[e], b1 = fem[e + 1];

  float wv[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc += Wf[m * C + c] * fc[c];
    wv[m] = acc + (Wbc[2 * m] * b0 + Wbc[2 * m + 1] * b1);
  }
  float* wrow = w + (size_t)e * M;
#pragma unroll
  for (int m = 0; m < M; ++m) wrow[m] = wv[m];
  if (!diag) return;
  float sl = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float dw = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) dw += D[c * M + m] * wv[m];
    sl = nan_max(sl, fabsf(fc[c] - dw));
  }
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    r0 += Bm[m] * wv[m];
    r1 += Bm[M + m] * wv[m];
  }
  slack[e] = sl;
  bcv[e] = nan_max(fabsf(b0 - r0), fabsf(b1 - r1));
}

// ---------------------------------------------------------------------------
// 3. Per-element operators (replaces pallas_kernels.py::
//    fused_enhance_varcoeff), null-space least squares by CGS2 QR:
//
//   wp = Pbc bc;  g = f / s^2 - D~ wp;  G_k = a2 (W2 Z)_k + a1 (W1 Z)_k
//   + a0 (W0 Z)_k;  QR of G (K = M-2 columns, two Gram-Schmidt passes per
//   column);  y = R^-1 Q^T g;  w = wp + Z y.
//   Graded mode (he != nullptr): rho = h_ref / h_e folds into a2 (rho^2)
//   and a1 (rho).
//   Diagnostics: slack = s^2 max|g - G y|, bcv = max|bc - B w|,
//   cond = max R_jj / max(min R_jj, eps).
//
// Bound on the H100: bytes, then registers.  Per element it reads 4 C
// sampled values (a2, a1, a0, f: 192 B at C = 12) and writes ~44 B,
// against ~4 K^2 C flops of QR (~1.7 kflop at M = 8) — below the card's
// flop/byte balance, so the memory stream bounds it if the QR stays in
// registers.  Design: Q (K x C), the coefficients and g live in registers
// (about 150 floats at M = 8, C = 12); G is never stored — its columns
// are rebuilt from (a2, a1, a0) when needed.
//
// statics: AZ [3][C][K], AP [3C][2], Z [M][K], Pbc [M][2], B [2][M].
template <int M, int C>
__global__ void __launch_bounds__(kThreads)
varcoeff_kernel(const float* __restrict__ fem, const float* __restrict__ coef,
                const float* __restrict__ he, const float* __restrict__ statics,
                float* __restrict__ w, float* __restrict__ slack,
                float* __restrict__ bcv, float* __restrict__ cond, int E,
                float h_ref, float inv_s2, float s2, int diag) {
  constexpr int K = M - 2;
  extern __shared__ float s[];
  load_statics(s, statics, 3 * C * K + 6 * C + M * K + 2 * M + 2 * M);
  const float* AZ2 = s;
  const float* AZ1 = AZ2 + C * K;
  const float* AZ0 = AZ1 + C * K;
  const float* AP = AZ0 + C * K;
  const float* Z = AP + 6 * C;
  const float* Pbc = Z + M * K;
  const float* Bm = Pbc + 2 * M;

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float a2[C], a1[C], a0[C], g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a2[c] = coef[(size_t)(0 * C + c) * E + e];
    a1[c] = coef[(size_t)(1 * C + c) * E + e];
    a0[c] = coef[(size_t)(2 * C + c) * E + e];
  }
  if (he != nullptr) {
    const float rho = h_ref / he[e];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a2[c] = a2[c] * (rho * rho);
      a1[c] = a1[c] * rho;
    }
  }
  const float b0 = fem[e], b1 = fem[e + 1];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float p2 = AP[2 * c] * b0 + AP[2 * c + 1] * b1;
    const float p1 = AP[2 * (C + c)] * b0 + AP[2 * (C + c) + 1] * b1;
    const float p0 = AP[2 * (2 * C + c)] * b0 + AP[2 * (2 * C + c) + 1] * b1;
    const float fc = coef[(size_t)(3 * C + c) * E + e];
    g[c] = fc * inv_s2 - (a2[c] * p2 + a1[c] * p1 + a0[c] * p0);
  }

  float q[K][C];
  float Rm[K][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      q[j][c] = a2[c] * AZ2[c * K + j] + a1[c] * AZ1[c * K + j] +
                a0[c] * AZ0[c * K + j];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        float rij = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) rij += q[i][c] * q[j][c];
        Rm[i][j] = pass == 0 ? rij : Rm[i][j] + rij;
#pragma unroll
        for (int c = 0; c < C; ++c) q[j][c] = q[j][c] - rij * q[i][c];
      }
    }
    float nrm = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) nrm += q[j][c] * q[j][c];
    const float rjj = sqrtf(nrm);
    Rm[j][j] = rjj;
#pragma unroll
    for (int c = 0; c < C; ++c) q[j][c] = q[j][c] / (rjj + kEps);
  }
  float y[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc += q[j][c] * g[c];
#pragma unroll
    for (int i = j + 1; i < K; ++i) acc = acc - Rm[j][i] * y[i];
    y[j] = acc / (Rm[j][j] + kEps);
  }
  float wv[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float zy = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) zy += Z[m * K + k] * y[k];
    wv[m] = (Pbc[2 * m] * b0 + Pbc[2 * m + 1] * b1) + zy;
  }
  float* wrow = w + (size_t)e * M;
#pragma unroll
  for (int m = 0; m < M; ++m) wrow[m] = wv[m];
  if (!diag) return;

  float sl = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float er = g[c];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float Gkc = a2[c] * AZ2[c * K + k] + a1[c] * AZ1[c * K + k] +
                        a0[c] * AZ0[c * K + k];
      er = er - Gkc * y[k];
    }
    sl = nan_max(sl, fabsf(er));
  }
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    r0 += Bm[m] * wv[m];
    r1 += Bm[M + m] * wv[m];
  }
  float dmax = Rm[0][0], dmin = Rm[0][0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    dmax = nan_max(dmax, Rm[j][j]);
    dmin = nan_min(dmin, Rm[j][j]);
  }
  slack[e] = s2 * sl;
  bcv[e] = nan_max(fabsf(b0 - r0), fabsf(b1 - r1));
  cond[e] = dmax / nan_max(dmin, kEps);
}

inline unsigned blocks_for(int E) { return (unsigned)((E + kThreads - 1) / kThreads); }

}  // namespace

// (M, C) pairs compiled; enhance1d_supported() answers for them.
#define ENH_SHAPES(X) X(4, 12) X(6, 12) X(8, 12) X(10, 12) X(12, 12) X(6, 10)

extern "C" {

int enhance1d_supported(int M, int C) {
#define X(m, c) if (M == m && C == c) return 1;
  ENH_SHAPES(X)
#undef X
  return 0;
}

const char* enhance1d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int enhance1d_separable_f32(int device, void* stream, const float* fem,
                            const float* a, const float* statics, float* w,
                            float* slack, float* bcv, float* ok, int E, int M,
                            int C, int R, int diag, int fallback) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || R < 1 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (M * R + 2 * M + C * R + 2 * C + 2 * M);
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                          \
  if (M == m && C == c) {                                                \
    separable_kernel<m, c><<<blocks_for(E), kThreads, smem, st>>>(       \
        fem, a, statics, w, slack, bcv, ok, E, R, diag, fallback);       \
    return (int)cudaGetLastError();                                      \
  }
  ENH_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

int enhance1d_shared_f32(int device, void* stream, const float* fem,
                         const float* f, const float* statics, float* w,
                         float* slack, float* bcv, int E, int M, int C,
                         int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (M * C + 2 * M + C * M + 2 * M);
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                          \
  if (M == m && C == c) {                                                \
    shared_kernel<m, c><<<blocks_for(E), kThreads, smem, st>>>(          \
        fem, f, statics, w, slack, bcv, E, diag);                        \
    return (int)cudaGetLastError();                                      \
  }
  ENH_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

int enhance1d_varcoeff_f32(int device, void* stream, const float* fem,
                           const float* coef, const float* he,
                           const float* statics, float* w, float* slack,
                           float* bcv, float* cond, int E, int M, int C,
                           float h_ref, float inv_s2, float s2, int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || M < 3) return (int)cudaErrorInvalidValue;
  const int K = M - 2;
  const size_t smem =
      sizeof(float) * (3 * C * K + 6 * C + M * K + 2 * M + 2 * M);
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                          \
  if (M == m && C == c) {                                                \
    varcoeff_kernel<m, c><<<blocks_for(E), kThreads, smem, st>>>(        \
        fem, coef, he, statics, w, slack, bcv, cond, E, h_ref, inv_s2,   \
        s2, diag);                                                       \
    return (int)cudaGetLastError();                                      \
  }
  ENH_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
