// Fused graded-mesh 2D LSSVR enhancement for Hopper (sm_90a), plain C
// interface.  Replaces the Pallas TPU kernel
// hybrid_fem_lssvr_tpu/ops/pallas_kernels.py::fused_enhance_graded_2d.
//
// On a graded tensor-product mesh (node positions xs [nx+1], ys [ny+1]) each
// quad has its own geometry xl = xs[ex], hx = xs[ex+1] - xs[ex] (and the same
// in y), chain factors sx = 2/hx, sy = 2/hy and row scale
// inv_s2 = 1 / (sx^2 + sy^2).  With the coefficient fields sampled at its
// C^2 collocation points (coef [3][C^2][E] = a, a_x, a_y, element index
// fastest; the constants a0, 0, 0 when var == 0), the rhs f [C^2][E] and the
// boundary-trace values bc [Kb = 4M-4] (bilinear trace with the Dirichlet
// override, enh::trace_bc):
//
//   c   = [-a sx^2, -a sy^2, (bx - a_x) sx, (by - a_y) sy, c] * inv_s2
//   G_k = sum_s c_s AZ_s[q][k]            (five unit-scale blocks)
//   g   = f inv_s2 - sum_s c_s (AP_s bc)[q]
//   y   = argmin ||G y - g||  (CGS2 QR);   w = Pbc bc + Z y
//   slack = (sx^2 + sy^2) max |g - G y|;   bcv = max |bc - B w|
//
// The algebra after G is that of varcoeff2d_qr_kernel
// (enhance2d_varcoeff.cu): one thread per quad, 64 quads a block, Q (built
// in place over G), g and R in dynamic shared memory laid out
// [slot][thread] (conflict-free).  At M = C = 6 that is 748 floats a quad
// plus 34.6 KB of statics: 226 KB a block, one block (two warps) an SM.
// Bound on the H100: operations (~2 K^2 C^2 FMAs for the two Gram-Schmidt
// passes, ~5 K C^2 to form G, 4 Kb C^2 for the trace products); every FMA
// of the QR reads shared memory, and two warps an SM hide little latency.
//
// Built WITHOUT --use_fast_math.  The entry point launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include "enhance_common.cuh"

namespace {

using enh::kEps;
using enh::load_statics;
using enh::nan_max;
using enh::trace_bc;

// Shared-memory layout of the statics:
//   AZ [5][C2][K], AP [5][C2][KB], Z [M2][K], Pbc [M2][KB], B [KB][M2],
//   pts [8][KB].
template <int M, int C>
struct Layout {
  static constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4, K = M2 - KB;
  static constexpr int AZ = 0;
  static constexpr int AP = AZ + 5 * C2 * K;
  static constexpr int Z = AP + 5 * C2 * KB;
  static constexpr int PBC = Z + M2 * K;
  static constexpr int B = PBC + M2 * KB;
  static constexpr int PTS = B + KB * M2;
  static constexpr int SIZE = PTS + 8 * KB;
};

struct Geom {
  float sx, sy, sx2, sy2, inv_s2;
};

// The five per-point block weights c_s at collocation row q.
struct Coefs {
  float a, cx, cy;  // a, bx - a_x, by - a_y at the point
};

__device__ __forceinline__ void block_weights(const Geom& gm, const Coefs& k,
                                              float c, float* cs) {
  cs[0] = -k.a * gm.sx2 * gm.inv_s2;
  cs[1] = -k.a * gm.sy2 * gm.inv_s2;
  cs[2] = k.cx * gm.sx * gm.inv_s2;
  cs[3] = k.cy * gm.sy * gm.inv_s2;
  cs[4] = c * gm.inv_s2;
}

// One collocation row q of the scaled system: the K entries of G and the
// rhs entry g.
template <int M, int C>
__device__ __forceinline__ float row_of_G(const float* s, int q,
                                          const float* cs, float fq,
                                          const float* bc, float inv_s2,
                                          float* Grow) {
  using L = Layout<M, C>;
  const float* AZ = s + L::AZ;
  const float* AP = s + L::AP;
  float dwp = 0.f;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    float p = 0.f;
#pragma unroll
    for (int k = 0; k < L::KB; ++k) p += AP[(b * L::C2 + q) * L::KB + k] * bc[k];
    dwp += cs[b] * p;
  }
#pragma unroll
  for (int k = 0; k < L::K; ++k) {
    float v = 0.f;
#pragma unroll
    for (int b = 0; b < 5; ++b) v += cs[b] * AZ[(b * L::C2 + q) * L::K + k];
    Grow[k] = v;
  }
  return fq * inv_s2 - dwp;
}

constexpr int kThreads = 64;

template <int M, int C>
__global__ void __launch_bounds__(kThreads)
graded2d_kernel(const float* __restrict__ fem, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ coef,
                const float* __restrict__ f, const float* __restrict__ gedge,
                const float* __restrict__ statics, float* __restrict__ w,
                float* __restrict__ slack, float* __restrict__ bcv, int nx,
                int ny, int nmax, float a0, float bx, float by, float c,
                int var, int diag) {
  using L = Layout<M, C>;
  constexpr int K = L::K, C2 = L::C2, KB = L::KB, M2 = L::M2;
  constexpr int T = kThreads;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, L::SIZE);
  float* Q = s + L::SIZE + threadIdx.x;  // Q[(k C2 + q) T]
  float* gs = Q + (size_t)K * C2 * T;    // gs[q T]
  float* R = gs + (size_t)C2 * T;        // R[(j (j + 1) / 2 + i) T]
  const int E = nx * ny;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int ex = e % nx, ey = e / nx;
  Geom gm;
  gm.sx = 2.f / (xs[ex + 1] - xs[ex]);
  gm.sy = 2.f / (ys[ey + 1] - ys[ey]);
  gm.sx2 = gm.sx * gm.sx;
  gm.sy2 = gm.sy * gm.sy;
  gm.inv_s2 = 1.f / (gm.sx2 + gm.sy2);
  float bc[KB];
  trace_bc<KB>(fem, gedge, s + L::PTS, e, nx, ny, nmax, bc);
  const size_t plane = (size_t)C2 * E;
  auto coefs_at = [&](int q) {
    Coefs k{a0, bx, by};
    if (var) {
      const size_t o = (size_t)q * E + e;
      k.a = coef[o];
      k.cx = bx - coef[plane + o];
      k.cy = by - coef[2 * plane + o];
    }
    return k;
  };

  float Grow[K], cs[5];
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    block_weights(gm, coefs_at(q), c, cs);
    gs[q * T] = row_of_G<M, C>(s, q, cs, f[(size_t)q * E + e], bc, gm.inv_s2,
                               Grow);
#pragma unroll
    for (int k = 0; k < K; ++k) Q[(k * C2 + q) * T] = Grow[k];
  }
  // CGS2: two Gram-Schmidt passes per column, the reference's batched QR.
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
    for (int i = j + 1; i < K; ++i) acc -= R[(i * (i + 1) / 2 + j) * T] * y[i];
    y[j] = acc / (R[(j * (j + 1) / 2 + j) * T] + kEps);
  }
  // w = Pbc bc + Z y, and bcv = max |bc - B w|.
  const float* Zm = s + L::Z;
  const float* Pbc = s + L::PBC;
  const float* Bm = s + L::B;
  float* wrow = w + (size_t)e * M2;
  float bw[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) bw[k] = 0.f;
#pragma unroll 4
  for (int m = 0; m < M2; ++m) {
    float wp = 0.f, zy = 0.f;
#pragma unroll
    for (int k = 0; k < KB; ++k) wp += Pbc[m * KB + k] * bc[k];
#pragma unroll
    for (int k = 0; k < K; ++k) zy += Zm[m * K + k] * y[k];
    const float wm = wp + zy;
    wrow[m] = wm;
    if (diag) {
#pragma unroll
      for (int k = 0; k < KB; ++k) bw[k] += Bm[k * M2 + m] * wm;
    }
  }
  if (!diag) return;
  float bv = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k) bv = nan_max(bv, fabsf(bc[k] - bw[k]));
  float sl = 0.f;
#pragma unroll 1
  for (int q = 0; q < C2; ++q) {
    block_weights(gm, coefs_at(q), c, cs);
    row_of_G<M, C>(s, q, cs, f[(size_t)q * E + e], bc, gm.inv_s2, Grow);
    float er = gs[q * T];
#pragma unroll
    for (int k = 0; k < K; ++k) er -= Grow[k] * y[k];
    sl = nan_max(sl, fabsf(er));
  }
  slack[e] = (gm.sx2 + gm.sy2) * sl;
  bcv[e] = bv;
}

template <int M, int C>
constexpr size_t smem_bytes() {
  using L = Layout<M, C>;
  return sizeof(float) *
         (L::SIZE + (size_t)kThreads *
                        ((L::K + 1) * L::C2 + L::K * (L::K + 1) / 2));
}

template <int M, int C>
cudaError_t launch(cudaStream_t st, const float* fem, const float* xs,
                   const float* ys, const float* coef, const float* f,
                   const float* gedge, const float* statics, float* w,
                   float* slack, float* bcv, int nx, int ny, int nmax,
                   float a0, float bx, float by, float c, int var, int diag) {
  constexpr size_t smem = smem_bytes<M, C>();
  // Above 48 KB dynamic shared memory is opt-in, per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      graded2d_kernel<M, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int E = nx * ny;
  graded2d_kernel<M, C>
      <<<(unsigned)((E + kThreads - 1) / kThreads), kThreads, smem, st>>>(
          fem, xs, ys, coef, f, gedge, statics, w, slack, bcv, nx, ny, nmax,
          a0, bx, by, c, var, diag);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int enhance2d_graded_supported(int M, int C) {
#define X(m, c) if (M == m && C == c) return 1;
  ENH2D_SHAPES(X)
#undef X
  return 0;
}

const char* enhance2d_graded_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int enhance2d_graded_f32(int device, void* stream, const float* fem,
                         const float* xs, const float* ys, const float* coef,
                         const float* f, const float* gedge,
                         const float* statics, float* w, float* slack,
                         float* bcv, int nx, int ny, int nmax, int M, int C,
                         float a0, float bx, float by, float c, int var,
                         int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1 || (var && coef == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c_)                                                            \
  if (M == m && C == c_)                                                    \
    return (int)launch<m, c_>(st, fem, xs, ys, coef, f, gedge, statics, w,  \
                              slack, bcv, nx, ny, nmax, a0, bx, by, c, var, \
                              diag);
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
