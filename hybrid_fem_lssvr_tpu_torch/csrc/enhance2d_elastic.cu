// Fused 2D vector (plane-strain elasticity) LSSVR enhancement kernel for
// Hopper (sm_90a), plain C interface.  It replaces the Pallas TPU kernel
// fused_enhance_elastic_2d of hybrid_fem_lssvr_tpu/ops/pallas_kernels.py.
//
// Per quad e, with both displacement components' data stacked:
//
//   f  [2 C^2]: the body force at the C^2 interior collocation points, f1's
//               rows then f2's, sampled by the wrapper into f [2 C^2][E]
//               (element index fastest, so loads coalesce);
//   bc [2 KB]:  per component c the bilinear trace of the corner values of
//               fem[c] at the KB = 4M-4 trace points, overridden on the
//               domain edges by g_c (gedge [2][4][KB][nmax], see
//               enhance_common.cuh);
//
//   w     = [Wf | Wbc] [f; bc]                       [2 M^2]
//   slack = max |f - D w|,   bcv = max |bc - B w|,   B = diag(Bs, Bs)
//
// Bound on the H100: operations.  2M^2 (2C^2 + 2KB) FMAs for w, 2C^2 2M^2
// for D w and 2 KB M^2 for B w (B's zero blocks skipped): 14,688 a quad at
// M = C = 6, 30.8 GFLOP at 1024^2 quads (0.46 ms at 67 TFLOP/s) against
// 0.62 GB of f read and w written (0.19 ms at 3.35 TB/s).
//
// Design: one thread per quad, as stacked2d_kernel of enhance2d.cu.  The
// operators live in shared memory and are read as warp-wide broadcasts:
// [Wf | Wbc] transposed and padded to float4 rows, OT [2C^2 + 2KB][RP], so
// one 16-byte broadcast feeds four FMAs, and D [2C^2][RP] likewise.  At
// M = 6 they take 56.5 KB a block, above the 48 KB of static shared memory,
// so the launch opts in to dynamic shared memory.  The 2 M^2 accumulators
// stay in registers; f is streamed row by row from device memory; both
// traces are built in registers (enh::trace_bc once per component).  The
// slack reads f a second time rather than keeping 2 C^2 more values live
// beside the accumulators.  The ragged edge is masked, so any nx, ny runs.
//
// Built WITHOUT --use_fast_math (NaN must reach the solve_ok gate).  The
// entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the first CUDA error.

#include "enhance_common.cuh"

namespace {

using enh::bc_violation;
using enh::load_statics;
using enh::nan_max;
using enh::store_row;
using enh::trace_bc;

constexpr int kThreads = 128;

template <int M, int C>
struct Shape {
  static constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  static constexpr int R = 2 * M2;              // rows of w
  static constexpr int RP = (R + 3) / 4 * 4;    // padded to float4
  static constexpr int Z = 2 * C2 + 2 * KB;     // columns of [Wf | Wbc]
  // statics: OT [Z][RP], pts [8][KB], then (diagnostics) Bs [KB][M2] and
  // D [2 C2][RP].
  static constexpr int kPart = Z * RP + 8 * KB;
  static constexpr int kFull = kPart + KB * M2 + 2 * C2 * RP;
};

template <int M, int C>
__global__ void __launch_bounds__(kThreads)
elastic2d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                 const float* __restrict__ gedge,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv, int nx,
                 int ny, int nmax, int diag) {
  using S = Shape<M, C>;
  constexpr int M2 = S::M2, C2 = S::C2, KB = S::KB, R = S::R, RP = S::RP;
  extern __shared__ __align__(16) float s[];
  load_statics(s, statics, diag ? S::kFull : S::kPart);
  const float4* OT = reinterpret_cast<const float4*>(s);
  const float* pts = s + S::Z * RP;
  const float* Bs = pts + 8 * KB;
  const float4* D = reinterpret_cast<const float4*>(Bs + KB * M2);

  const int E = nx * ny;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float bc[2 * KB];
  trace_bc<KB>(fem, gedge, pts, e, nx, ny, nmax, bc);
  trace_bc<KB>(fem + (size_t)(ny + 1) * (nx + 1),
               gedge + (size_t)4 * KB * nmax, pts, e, nx, ny, nmax, bc + KB);

  float acc[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < 2 * C2; ++c) {
    const float z = f[(size_t)c * E + e];
#pragma unroll
    for (int r = 0; r < RP / 4; ++r) {
      const float4 o = OT[c * (RP / 4) + r];
      acc[4 * r] += o.x * z;
      acc[4 * r + 1] += o.y * z;
      acc[4 * r + 2] += o.z * z;
      acc[4 * r + 3] += o.w * z;
    }
  }
#pragma unroll
  for (int k = 0; k < 2 * KB; ++k) {
    const float z = bc[k];
#pragma unroll
    for (int r = 0; r < RP / 4; ++r) {
      const float4 o = OT[(2 * C2 + k) * (RP / 4) + r];
      acc[4 * r] += o.x * z;
      acc[4 * r + 1] += o.y * z;
      acc[4 * r + 2] += o.z * z;
      acc[4 * r + 3] += o.w * z;
    }
  }
  store_row<R>(w + (size_t)e * R, acc);
  if (!diag) return;
  bcv[e] = nan_max(bc_violation<M2, KB>(Bs, acc, bc),
                   bc_violation<M2, KB>(Bs, acc + M2, bc + KB));
  float sl = 0.f;
#pragma unroll 1
  for (int c = 0; c < 2 * C2; ++c) {
    float dw = 0.f;
#pragma unroll
    for (int r = 0; r < RP / 4; ++r) {
      const float4 d = D[c * (RP / 4) + r];
      dw += d.x * acc[4 * r];
      dw += d.y * acc[4 * r + 1];
      dw += d.z * acc[4 * r + 2];
      dw += d.w * acc[4 * r + 3];
    }
    sl = nan_max(sl, fabsf(f[(size_t)c * E + e] - dw));
  }
  slack[e] = sl;
}

template <int M, int C>
int launch(cudaStream_t st, const float* fem, const float* f,
           const float* gedge, const float* statics, float* w, float* slack,
           float* bcv, int nx, int ny, int nmax, int diag) {
  using S = Shape<M, C>;
  // Above 48 KB dynamic shared memory is opt-in, per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      elastic2d_kernel<M, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * S::kFull));
  if (err != cudaSuccess) return (int)err;
  const int E = nx * ny;
  const size_t smem = sizeof(float) * (diag ? S::kFull : S::kPart);
  elastic2d_kernel<M, C>
      <<<(unsigned)((E + kThreads - 1) / kThreads), kThreads, smem, st>>>(
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax, diag);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int enhance2d_elastic_supported(int M, int C) {
#define X(m, c) if (M == m && C == c) return 1;
  ENH2D_SHAPES(X)
#undef X
  return 0;
}

const char* enhance2d_elastic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// statics: [Wf | Wbc] transposed and padded, pts, Bs, D (Shape above).
int enhance2d_elastic_f32(int device, void* stream, const float* fem,
                          const float* f, const float* gedge,
                          const float* statics, float* w, float* slack,
                          float* bcv, int nx, int ny, int nmax, int M, int C,
                          int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                          \
  if (M == m && C == c)                                                  \
    return launch<m, c>(st, fem, f, gedge, statics, w, slack, bcv, nx,   \
                        ny, nmax, diag);
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
