// Fused 2D shared-operator LSSVR enhancement kernels for Hopper (sm_90a),
// plain C interface.  Each replaces one Pallas TPU kernel of
// hybrid_fem_lssvr_tpu/ops/pallas_kernels.py:
//
//   stacked2d_kernel <- fused_enhance_stacked_2d
//   shared2d_kernel  <- fused_enhance_shared_2d
//
// Both take the nodal grid fem [ny+1][nx+1], the rhs sampled at the C^2
// interior collocation points of every quad, f [C^2][E] (element index
// fastest, so loads coalesce), and the Dirichlet data along the four domain
// edges (gedge, see enhance_common.cuh); they build the boundary-trace
// values bc [Kb = 4M-4] of each quad in registers and apply the shared
// host-f64 operators to z = [f; bc].
//
// Design: one thread per quad.  The operators live in shared memory and are
// read as warp-wide broadcasts; z is streamed row by row (f from device
// memory, bc from registers) into M^2 (+C^2) accumulators held in
// registers, with (M, C) template parameters so every small array unrolls.
// The corner values are read from the nodal grid itself (no flattened
// copies).  w is written as [E][M^2] rows (144 B a thread at M = 6): those
// stores do not coalesce.  The ragged edge is masked, so any nx, ny runs.
//
// Built WITHOUT --use_fast_math (NaN must reach the solve_ok gate).  Each
// entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include "enhance_common.cuh"

namespace {

using enh::bc_violation;
using enh::load_statics;
using enh::nan_max;
using enh::store_row;
using enh::trace_bc;

constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// 1. Stacked operator (replaces pallas_kernels.py::fused_enhance_stacked_2d).
//
//   [w; e] = [[Wf, Wbc], [Pres, Qres]] [f; bc]     one [M2+C2, C2+Kb] product
//   slack  = max |e|   (exact-algebra residual),  bcv = max |bc - B w|
//
// Bound on the H100: operations.  Per quad (M2+C2)(C2+Kb) = 4032 FMAs at
// M = C = 6 against 144 B of f read and 144 B of w written (8.5 GFLOP
// against 0.31 GB at 1024^2).  The operator is stored transposed and padded
// to float4 rows, OT [C2+Kb][ROWS_P], so one 16-byte shared-memory broadcast
// feeds four FMAs.
//
// statics: OT [C2+KB][ROWS_P], B [KB][M2], pts [8][KB].
//
// DIAG is a template parameter here (the other kernels take it at run time)
// because it sets the number of accumulator registers, ROWS.
template <int M, int C, bool DIAG>
__global__ void __launch_bounds__(kThreads)
stacked2d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                 const float* __restrict__ gedge,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv, int nx,
                 int ny, int nmax) {
  constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  constexpr int ROWS = DIAG ? M2 + C2 : M2;
  constexpr int ROWS_P = (ROWS + 3) / 4 * 4;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, (C2 + KB) * ROWS_P + KB * M2 + 8 * KB);
  const float4* OT = reinterpret_cast<const float4*>(s);
  const float* Bm = s + (C2 + KB) * ROWS_P;
  const float* pts = Bm + KB * M2;

  const int E = nx * ny;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float bc[KB];
  trace_bc<KB>(fem, gedge, pts, e, nx, ny, nmax, bc);

  float acc[ROWS_P];
#pragma unroll
  for (int r = 0; r < ROWS_P; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C2; ++c) {
    const float z = f[(size_t)c * E + e];
#pragma unroll
    for (int r = 0; r < ROWS_P / 4; ++r) {
      const float4 o = OT[c * (ROWS_P / 4) + r];
      acc[4 * r] += o.x * z;
      acc[4 * r + 1] += o.y * z;
      acc[4 * r + 2] += o.z * z;
      acc[4 * r + 3] += o.w * z;
    }
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float z = bc[k];
#pragma unroll
    for (int r = 0; r < ROWS_P / 4; ++r) {
      const float4 o = OT[(C2 + k) * (ROWS_P / 4) + r];
      acc[4 * r] += o.x * z;
      acc[4 * r + 1] += o.y * z;
      acc[4 * r + 2] += o.z * z;
      acc[4 * r + 3] += o.w * z;
    }
  }
  store_row<M2>(w + (size_t)e * M2, acc);
  if constexpr (DIAG) {
    float sl = 0.f;
#pragma unroll
    for (int c = 0; c < C2; ++c) sl = nan_max(sl, fabsf(acc[M2 + c]));
    slack[e] = sl;
    bcv[e] = bc_violation<M2, KB>(Bm, acc, bc);
  }
}

// ---------------------------------------------------------------------------
// 2. Separate operators (replaces pallas_kernels.py::fused_enhance_shared_2d),
//    for a bundle without the residual projector Pres.
//
//   w = Wf f + Wbc bc;  slack = max |f - D w|;  bcv = max |bc - B w|
//
// Bound on the H100: operations (M2 (C2 + Kb) FMAs for w, C2 M2 + Kb M2
// for the diagnostics: 4032 at M = C = 6, as the stacked kernel).  f stays
// in registers for the residual.
//
// statics: Wf [M2][C2], Wbc [M2][KB], D [C2][M2], B [KB][M2], pts [8][KB].
template <int M, int C>
__global__ void __launch_bounds__(kThreads)
shared2d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                const float* __restrict__ gedge,
                const float* __restrict__ statics, float* __restrict__ w,
                float* __restrict__ slack, float* __restrict__ bcv, int nx,
                int ny, int nmax, int diag) {
  constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, M2 * C2 + M2 * KB + C2 * M2 + KB * M2 + 8 * KB);
  const float* Wf = s;
  const float* Wbc = Wf + M2 * C2;
  const float* D = Wbc + M2 * KB;
  const float* Bm = D + C2 * M2;
  const float* pts = Bm + KB * M2;

  const int E = nx * ny;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float bc[KB];
  trace_bc<KB>(fem, gedge, pts, e, nx, ny, nmax, bc);
  float fc[C2];
#pragma unroll
  for (int c = 0; c < C2; ++c) fc[c] = f[(size_t)c * E + e];

  float wv[M2];
#pragma unroll
  for (int m = 0; m < M2; ++m) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int c = 0; c < C2; ++c) a += Wf[m * C2 + c] * fc[c];
#pragma unroll
    for (int k = 0; k < KB; ++k) b += Wbc[m * KB + k] * bc[k];
    wv[m] = a + b;
  }
  store_row<M2>(w + (size_t)e * M2, wv);
  if (!diag) return;
  float sl = 0.f;
#pragma unroll
  for (int c = 0; c < C2; ++c) {
    float dw = 0.f;
#pragma unroll
    for (int m = 0; m < M2; ++m) dw += D[c * M2 + m] * wv[m];
    sl = nan_max(sl, fabsf(fc[c] - dw));
  }
  slack[e] = sl;
  bcv[e] = bc_violation<M2, KB>(Bm, wv, bc);
}

inline unsigned blocks_for(int E) {
  return (unsigned)((E + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int enhance2d_supported(int M, int C) {
#define X(m, c) if (M == m && C == c) return 1;
  ENH2D_SHAPES(X)
#undef X
  return 0;
}

const char* enhance2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int enhance2d_stacked_f32(int device, void* stream, const float* fem,
                          const float* f, const float* gedge,
                          const float* statics, float* w, float* slack,
                          float* bcv, int nx, int ny, int nmax, int M, int C,
                          int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  const int E = nx * ny, M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  const int rows = diag ? M2 + C2 : M2;
  const int rows_p = (rows + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((C2 + KB) * rows_p + KB * M2 + 8 * KB);
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                            \
  if (M == m && C == c) {                                                  \
    if (diag)                                                              \
      stacked2d_kernel<m, c, true><<<blocks_for(E), kThreads, smem, st>>>( \
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);            \
    else                                                                   \
      stacked2d_kernel<m, c, false><<<blocks_for(E), kThreads, smem, st>>>(\
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);            \
    return (int)cudaGetLastError();                                        \
  }
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

int enhance2d_shared_f32(int device, void* stream, const float* fem,
                         const float* f, const float* gedge,
                         const float* statics, float* w, float* slack,
                         float* bcv, int nx, int ny, int nmax, int M, int C,
                         int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  const int E = nx * ny, M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  const size_t smem =
      sizeof(float) * (M2 * C2 + M2 * KB + C2 * M2 + KB * M2 + 8 * KB);
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                         \
  if (M == m && C == c) {                                               \
    shared2d_kernel<m, c><<<blocks_for(E), kThreads, smem, st>>>(       \
        fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax, diag);     \
    return (int)cudaGetLastError();                                     \
  }
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
