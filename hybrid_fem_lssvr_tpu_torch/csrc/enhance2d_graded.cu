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
// (enhance2d_varcoeff.cu), in enh::qr::enhance_quad (enhance_qr.cuh): a
// group of eight lanes a quad, four quads a warp, the quad's Q in the
// group's registers, dot products as butterflies of warp shuffles.  The
// kernel gives it the five block weights of each row.  Blocks of kWarps
// warps are persistent (as many as the card holds at once), each warp
// walking over groups of four quads; the statics (38 KB at M = C = 6,
// padded) are loaded once a block.  The bound on the H100 is operations
// (~2 K^2 C^2 FMAs for the two Gram-Schmidt passes, ~5 K C^2 to form G,
// 5 Kb C^2 for g); what binds is the QR's chain of dependent shuffle
// butterflies (enhance_qr.cuh).
//
// Built WITHOUT --use_fast_math.  The entry point launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <limits.h>

#include "enhance_common.cuh"
#include "enhance_qr.cuh"

namespace {

namespace qr = enh::qr;

constexpr int kBlocks = 5;  // operator blocks: Lap_xx, Lap_yy, Gx, Gy, I
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int M, int C>
using Statics = qr::Statics<M, C, kBlocks>;

// The five block weights c_s of each collocation row q and its rhs
// f_q inv_s2, from the quad's chain factors sx, sy and row scale inv_s2 =
// 1 / (sx^2 + sy^2) and the coefficients at q (the constants a0, bx, by
// where var is 0):
//   c = [-a sx^2, -a sy^2, (bx - a_x) sx, (by - a_y) sy, c] * inv_s2;
// the slack's scale is sx^2 + sy^2.
struct Weights {
  float sx, sy, inv_s2;
  const float* coef;
  const float* f;
  size_t plane;
  int E, e;
  float a0, bx, by, c;
  bool var;

  __device__ __forceinline__ void operator()(int q, float (&cs)[kBlocks],
                                             float& fq) const {
    const size_t o = (size_t)q * E + e;
    float a = a0, cx = bx, cy = by;
    if (var) {
      a = coef[o];
      cx = bx - coef[plane + o];
      cy = by - coef[2 * plane + o];
    }
    cs[0] = -a * (sx * sx) * inv_s2;
    cs[1] = -a * (sy * sy) * inv_s2;
    cs[2] = cx * sx * inv_s2;
    cs[3] = cy * sy * inv_s2;
    cs[4] = c * inv_s2;
    fq = f[o] * inv_s2;
  }

  __device__ __forceinline__ float slack_scale() const {
    return sx * sx + sy * sy;
  }
};

template <int M, int C>
__global__ void __launch_bounds__(kThreads, qr::kMinBlocks)
graded2d_kernel(const float* __restrict__ fem, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ coef,
                const float* __restrict__ f, const float* __restrict__ gedge,
                const float* __restrict__ statics, float* __restrict__ w,
                float* __restrict__ slack, float* __restrict__ bcv, int nx,
                int ny, int nmax, float a0, float bx, float by, float c,
                int var, int diag) {
  using S = Statics<M, C>;
  extern __shared__ __align__(16) float s[];
  qr::load_statics<M, C, kBlocks>(s, statics);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / qr::kLanes, sub = lane % qr::kLanes;
  float* sc = s + S::SIZE + warp * qr::kGroups * S::kScratch + grp;
  const int E = nx * ny;
  const int units = (E + qr::kGroups - 1) / qr::kGroups;
  Weights wt{0.f, 0.f, 0.f, coef, f, (size_t)S::C2 * E, E, 0, a0, bx, by, c,
             var != 0};
  for (int u = blockIdx.x * kWarps + warp; u < units;
       u += gridDim.x * kWarps) {
    const int e0 = u * qr::kGroups + grp;
    const bool active = e0 < E;
    const int e = active ? e0 : E - 1;
    const int ex = e % nx, ey = e / nx;
    wt.sx = 2.f / (xs[ex + 1] - xs[ex]);
    wt.sy = 2.f / (ys[ey + 1] - ys[ey]);
    wt.inv_s2 = 1.f / (wt.sx * wt.sx + wt.sy * wt.sy);
    wt.e = e;
    qr::enhance_quad<M, C, kBlocks>(s, wt, kBlocks, sub, sc, fem, gedge, e,
                                    nx, ny, nmax, w, slack, bcv, active,
                                    diag != 0);
  }
}

template <int M, int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * Statics<M, C>::smem_floats(kWarps);
}

// The kernel's dynamic shared memory a block and its blocks resident on the
// card (0 on error, with the CUDA error in *err).
template <int M, int C>
int shape(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  *smem = smem_bytes<M, C>();
  return enh::resident_blocks(graded2d_kernel<M, C>, cache, device, kThreads,
                              *smem, err);
}

int launch_shape(int device, int M, int C, size_t* smem, cudaError_t* err) {
#define X(m, c) \
  if (M == m && C == c) return shape<m, c>(device, smem, err);
  ENH2D_SHAPES(X)
#undef X
  *err = cudaErrorInvalidValue;
  return 0;
}

template <int M, int C>
cudaError_t launch(int device, cudaStream_t st, const float* fem,
                   const float* xs, const float* ys, const float* coef,
                   const float* f, const float* gedge, const float* statics,
                   float* w, float* slack, float* bcv, int nx, int ny,
                   int nmax, float a0, float bx, float by, float c, int var,
                   int diag) {
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  const int resident = shape<M, C>(device, &smem, &err);
  if (resident == 0) return err;
  graded2d_kernel<M, C>
      <<<qr::grid_for(nx * ny, kWarps, resident), kThreads, smem, st>>>(
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
  if (nx < 1 || ny < 1 || (long long)nx * ny > INT_MAX - 64 ||
      (var && coef == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c_)                                                            \
  if (M == m && C == c_)                                                    \
    return (int)launch<m, c_>(device, st, fem, xs, ys, coef, f, gedge,     \
                              statics, w, slack, bcv, nx, ny, nmax, a0, bx, \
                              by, c, var, diag);
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The kernel's launch shape at (M, C): dynamic shared memory a block, blocks
// resident on the card, threads a block.
int enhance2d_graded_launch_shape(int device, int M, int C, int* smem_bytes,
                                  int* blocks, int* threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *blocks = launch_shape(device, M, C, &smem, &err);
  *smem_bytes = (int)smem;
  *threads = kThreads;
  return *blocks > 0 ? 0 : (int)err;
}

}  // extern "C"
