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
// values fem[e], fem[e+1] (varcoeff_kernel: fem[n], fem[n+1] with
// n = e + e / Ef, for P families of Ef elements solved in one launch) and
// the sampled per-element inputs (laid out [rows][E], element index
// fastest) are read with coalesced loads (by varcoeff_kernel through
// cp.async, one element ahead); all per-element
// algebra runs in registers, with M and C as template parameters so every
// small array stays in registers; w is written straight to its [E, M]
// row.  The ragged edge (E not a multiple of the block) is masked, so any
// E is accepted.
//
// Built WITHOUT --use_fast_math: the diagnostics gate tests isfinite() and
// the max reductions propagate NaN as jnp.max does on the TPU.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include <limits.h>

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
//   Families: the E elements are P = E / Ef families of Ef elements each
//   (a parametric family solved in one launch); family p's nodal values
//   are fem[p (Ef + 1) ...], so element e reads fem[e + e / Ef] and the
//   next value.  Ef = E is the single mesh.
//   Diagnostics: slack = s^2 max|g - G y|, bcv = max|bc - B w|,
//   cond = max R_jj / max(min R_jj, eps).
//
// Bound on the H100: bytes.  Per element it reads 4 C sampled values (a2,
// a1, a0, f: 192 B at C = 12) and writes ~44 B, against ~4 K^2 C flops of
// QR (~1.7 kflop at M = 8) — below the card's flop/byte balance, so the
// memory stream bounds it if the instructions an element stay few and
// the loads overlap the arithmetic.  Design:
// - Persistent blocks (one wave); each thread walks over the elements e,
//   e + stride, ...  The next element's 4 C coefficients, its two nodal
//   values and its width are copied by cp.async into the thread's own
//   slots of shared memory (two stages) while the current element is
//   solved, so loads, arithmetic and stores overlap; no barrier is needed
//   beyond the one after the statics' load.  Slot i of a thread at
//   [i kVcThreads + thread]: conflict-free.
// - The statics are packed on the host row by row (ops/kernels.py,
//   pack_varcoeff) and read as 16-byte broadcasts: row c of G from its
//   three blocks [3][KP] (six loads at M = 8 for 18 fma).
// - Q (K x C) and R's upper triangle live in registers; g replaces f in
//   its slot, and the coefficients are read from the slots where they are
//   used (G is built twice: for the QR and, with diagnostics, for the
//   residual), not held, so nothing spills up to M = 12.
// - Q_j = v (1 / (R_jj + eps)): one reciprocal a column in place of C
//   divisions.
// What binds it on the H100 (PERF.md §6): the arithmetic's instruction
// issue (dropping the residual or the QR's passes cut the time in
// proportion); holding G for the residual in registers (8 warps an SM)
// or 16 warps at 128 registers was no faster.
//
// statics: AZ [C][3][KP] (W2 Z, W1 Z, W0 Z of row c), AP [C][8] (W2 Pbc,
// W1 Pbc, W0 Pbc of row c, two zeros), Z [M][KP], B [2][MP], Pbc [M][2];
// KP and MP are K and M rounded up to a multiple of 4, zeros in the
// padding.
constexpr int kVcThreads = 128;

template <int M, int C>
struct VcLayout {
  static constexpr int K = M - 2, KP = (K + 3) / 4 * 4, MP = (M + 3) / 4 * 4;
  static constexpr int AZ = 0;
  static constexpr int AP = AZ + C * 3 * KP;
  static constexpr int Z = AP + 8 * C;
  static constexpr int B = Z + M * KP;
  static constexpr int PBC = B + 2 * MP;
  static constexpr int SIZE = PBC + 2 * M;
  // A thread's slots of one stage: the 4 C rows (a2, a1, a0, f), fem[e],
  // fem[e + 1] and h_e.
  static constexpr int FEM = 4 * C, HE = FEM + 2, SLOTS = HE + 1;
  static constexpr int smem_floats() {
    return SIZE + 2 * kVcThreads * SLOTS;
  }
};

// Starts the copy of element e's inputs into a stage of the thread's slots.
// Element e = p Ef + k of family p reads its nodal pair at e + e / Ef and
// the next index: the families' Ef + 1 nodal values lie one after another,
// so no element reads across the seam between two families.
template <int M, int C>
__device__ __forceinline__ void vc_fetch(float* slot,
                                         const float* __restrict__ coef,
                                         const float* __restrict__ fem,
                                         const float* __restrict__ he, int e,
                                         int E, int Ef) {
  using L = VcLayout<M, C>;
  constexpr int T = kVcThreads;
#pragma unroll 4
  for (int r = 0; r < 4 * C; ++r)
    enh::cp_async4(slot + r * T, coef + (size_t)r * E + e);
  const int n = e + e / Ef;
  enh::cp_async4(slot + L::FEM * T, fem + n);
  enh::cp_async4(slot + (L::FEM + 1) * T, fem + n + 1);
  if (he != nullptr) enh::cp_async4(slot + L::HE * T, he + e);
}

// Row c of G: G[k] = a0 (W0 Z)_ck + (a1 (W1 Z)_ck + a2 (W2 Z)_ck), one
// fma a term.
template <int M, int C>
__device__ __forceinline__ void vc_row_G(const float* s, int c, float a2,
                                         float a1, float a0, float* G) {
  using L = VcLayout<M, C>;
  const float* az = s + L::AZ + c * 3 * L::KP;
#pragma unroll
  for (int t = 0; t < L::KP / 4; ++t) {
    const float4 z2 = *reinterpret_cast<const float4*>(az + 4 * t);
    const float4 z1 = *reinterpret_cast<const float4*>(az + L::KP + 4 * t);
    const float4 z0 = *reinterpret_cast<const float4*>(az + 2 * L::KP + 4 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * t + i < L::K)
        G[enh::lim<L::K>(4 * t + i)] = fmaf(
            a0, enh::part(z0, i), fmaf(a1, enh::part(z1, i),
                                       a2 * enh::part(z2, i)));
  }
}

// The coefficients of row c from a stage of the slots (rho folded in).
template <int M, int C>
__device__ __forceinline__ void vc_coefs(const float* in, int c, bool graded,
                                         float rho, float& a2, float& a1,
                                         float& a0) {
  constexpr int T = kVcThreads;
  a2 = in[c * T];
  a1 = in[(C + c) * T];
  a0 = in[(2 * C + c) * T];
  if (graded) {
    a2 = a2 * (rho * rho);
    a1 = a1 * rho;
  }
}

// The whole enhancement of element e from a stage of the slots `in`.
template <int M, int C>
__device__ __forceinline__ void vc_element(
    const float* s, float* in, bool graded, int e, float h_ref,
    float inv_s2, float s2, bool diag, float* __restrict__ w,
    float* __restrict__ slack, float* __restrict__ bcv,
    float* __restrict__ cond) {
  using L = VcLayout<M, C>;
  constexpr int K = L::K, T = kVcThreads;
  const float rho = graded ? h_ref / in[L::HE * T] : 1.f;
  const float b0 = in[L::FEM * T], b1 = in[(L::FEM + 1) * T];

  // G (becoming Q in place) and g, row by row; g replaces f in its slot.
  float q[K][C];
  float* g = in + 3 * C * T;  // g[c] at g[c T]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float a2, a1, a0, G[K];
    vc_coefs<M, C>(in, c, graded, rho, a2, a1, a0);
    const float4 ap0 = *reinterpret_cast<const float4*>(s + L::AP + 8 * c);
    const float4 ap1 =
        *reinterpret_cast<const float4*>(s + L::AP + 8 * c + 4);
    const float p2 = fmaf(ap0.y, b1, ap0.x * b0);
    const float p1 = fmaf(ap0.w, b1, ap0.z * b0);
    const float p0 = fmaf(ap1.y, b1, ap1.x * b0);
    g[c * T] = __fmul_rn(g[c * T], inv_s2) -
               fmaf(a0, p0, fmaf(a1, p1, a2 * p2));
    vc_row_G<M, C>(s, c, a2, a1, a0, G);
#pragma unroll
    for (int k = 0; k < K; ++k) q[k][c] = G[k];
  }

  // CGS2; R_ij (i <= j) at j (j + 1) / 2 + i.
  float R[K * (K + 1) / 2];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < j; ++i) {
        float rij = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) rij = fmaf(q[i][c], q[j][c], rij);
        R[j * (j + 1) / 2 + i] = pass == 0 ? rij : R[j * (j + 1) / 2 + i] + rij;
#pragma unroll
        for (int c = 0; c < C; ++c) q[j][c] = fmaf(-rij, q[i][c], q[j][c]);
      }
    }
    float nrm = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) nrm = fmaf(q[j][c], q[j][c], nrm);
    const float rjj = sqrtf(nrm);
    R[j * (j + 1) / 2 + j] = rjj;
    const float inv = 1.f / (rjj + kEps);
#pragma unroll
    for (int c = 0; c < C; ++c) q[j][c] *= inv;
  }
  // y = R^-1 Q^T g: Q^T g summed over c in order for every column at once
  // (g read once from its slot), then back substitution.
  float y[K];
#pragma unroll
  for (int j = 0; j < K; ++j) y[j] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float gc = g[c * T];
#pragma unroll
    for (int j = 0; j < K; ++j) y[j] = fmaf(q[j][c], gc, y[j]);
  }
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float acc = y[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i)
      acc = fmaf(-R[i * (i + 1) / 2 + j], y[i], acc);
    y[j] = acc / (R[j * (j + 1) / 2 + j] + kEps);
  }
  float wv[M];
  float* wrow = w + (size_t)e * M;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float2 pb = *reinterpret_cast<const float2*>(s + L::PBC + 2 * m);
    wv[m] = fmaf(pb.y, b1, pb.x * b0) +
            enh::dot_row<K>(s + L::Z + m * L::KP, y);
    wrow[m] = wv[m];
  }
  if (!diag) return;

  // The residual reads the statics and the coefficients again: without
  // this barrier the compiler keeps the build's loads of them (~3 K C
  // floats) in registers across the QR, and spills.
  asm volatile("" ::: "memory");
  float sl = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float a2, a1, a0, G[K];
    vc_coefs<M, C>(in, c, graded, rho, a2, a1, a0);
    vc_row_G<M, C>(s, c, a2, a1, a0, G);
    float er = g[c * T];
#pragma unroll
    for (int k = 0; k < K; ++k) er = fmaf(-G[k], y[k], er);
    sl = nan_max(sl, fabsf(er));
  }
  const float r0 = enh::dot_row<M>(s + L::B, wv);
  const float r1 = enh::dot_row<M>(s + L::B + L::MP, wv);
  float dmax = R[0], dmin = R[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    dmax = nan_max(dmax, R[j * (j + 1) / 2 + j]);
    dmin = nan_min(dmin, R[j * (j + 1) / 2 + j]);
  }
  slack[e] = s2 * sl;
  bcv[e] = nan_max(fabsf(b0 - r0), fabsf(b1 - r1));
  cond[e] = dmax / nan_max(dmin, kEps);
}

template <int M, int C>
__global__ void __launch_bounds__(kVcThreads)
varcoeff_kernel(const float* __restrict__ fem, const float* __restrict__ coef,
                const float* __restrict__ he, const float* __restrict__ statics,
                float* __restrict__ w, float* __restrict__ slack,
                float* __restrict__ bcv, float* __restrict__ cond, int E,
                int Ef, float h_ref, float inv_s2, float s2, int diag) {
  using L = VcLayout<M, C>;
  constexpr int T = kVcThreads, STAGE = L::SLOTS * T;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, L::SIZE);
  float* slots = s + L::SIZE + threadIdx.x;  // stage b: slots + b STAGE
  const int stride = gridDim.x * T;
  int e = blockIdx.x * T + threadIdx.x;
  if (e < E) vc_fetch<M, C>(slots, coef, fem, he, e, E, Ef);
  enh::cp_async_commit();
  for (int b = 0; e < E; e += stride, b ^= 1) {
    // The slots of the stage refilled below were last read for the element
    // before: keep those reads above the copy.
    asm volatile("" ::: "memory");
    if (e < E - stride)
      vc_fetch<M, C>(slots + (b ^ 1) * STAGE, coef, fem, he, e + stride, E,
                     Ef);
    enh::cp_async_commit();
    enh::cp_async_wait<1>();  // this element's copies have landed
    vc_element<M, C>(s, slots + b * STAGE, he != nullptr, e, h_ref, inv_s2,
                     s2, diag != 0, w, slack, bcv, cond);
  }
  enh::cp_async_wait<0>();
}

// The varcoeff kernel's dynamic shared memory a block and its blocks
// resident on the card (0 on error, with the CUDA error in *err).
template <int M, int C>
int vc_shape(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  *smem = sizeof(float) * VcLayout<M, C>::smem_floats();
  return enh::resident_blocks(varcoeff_kernel<M, C>, cache, device,
                              kVcThreads, *smem, err);
}

template <int M, int C>
cudaError_t launch_varcoeff(int device, cudaStream_t st, const float* fem,
                            const float* coef, const float* he,
                            const float* statics, float* w, float* slack,
                            float* bcv, float* cond, int E, int Ef,
                            float h_ref, float inv_s2, float s2, int diag) {
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  const int resident = vc_shape<M, C>(device, &smem, &err);
  if (resident == 0) return err;
  const int need = (int)(((long long)E + kVcThreads - 1) / kVcThreads);
  varcoeff_kernel<M, C>
      <<<(unsigned)(need < resident ? need : resident), kVcThreads, smem,
         st>>>(fem, coef, he, statics, w, slack, bcv, cond, E, Ef, h_ref,
               inv_s2, s2, diag);
  return cudaGetLastError();
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
                           float* bcv, float* cond, int E, int Ef, int M,
                           int C, float h_ref, float inv_s2, float s2,
                           int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // (the persistent threads step e by up to a few 1e5 within int range; the
  // nodal index e + e / Ef stays below E + E / Ef + 1)
  if (E < 1 || E > INT_MAX - (1 << 24) || M < 3 || Ef < 1 || E % Ef != 0 ||
      E / Ef > (1 << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                            \
  if (M == m && C == c)                                                    \
    return (int)launch_varcoeff<m, c>(device, st, fem, coef, he, statics,  \
                                      w, slack, bcv, cond, E, Ef, h_ref,   \
                                      inv_s2, s2, diag);
  ENH_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The varcoeff kernel's launch shape at (M, C): dynamic shared memory a
// block, blocks resident on the card, threads a block.
int enhance1d_varcoeff_launch_shape(int device, int M, int C, int* smem_bytes,
                                    int* blocks, int* threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *blocks = 0;
#define X(m, c) \
  if (M == m && C == c) *blocks = vc_shape<m, c>(device, &smem, &err);
  ENH_SHAPES(X)
#undef X
  *smem_bytes = (int)smem;
  *threads = kVcThreads;
  if (*blocks > 0) return 0;
  return err != cudaSuccess ? (int)err : (int)cudaErrorInvalidValue;
}

}  // extern "C"
