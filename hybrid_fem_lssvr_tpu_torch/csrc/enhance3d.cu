// Fused 3D LSSVR enhancement on structured hexes for Hopper (sm_90a), plain
// C interface.  Replaces the Pallas TPU kernel
// hybrid_fem_lssvr_tpu/ops/pallas_kernels.py::fused_enhance_stacked_3d.
//
// Per hex e of an nx x ny x nz grid (row-major, x fastest), with the rhs f
// sampled at its C^3 interior collocation points (f [C^3][E], element index
// fastest) and the trilinear trace of its eight corner values at the S
// surface points of the M^3 tensor grid, overridden on the six domain faces
// by the Dirichlet data (gface), z = [f; bc] and
//
//   [w; e] = O z,   O = [[Wf, Wbc], [Pres, Qres]]   ([M^3 + C^3, C^3 + S])
//   slack  = max |e|,   bcv = max |bc - B w|
//
// At M = C = 4, O is [128, 120] and B [56, 64]: 37.9 kflop a hex.
//
// Bound on the H100: operations (2^21 hexes: 79.5 GFLOP against ~1.1 GB
// moved).  The 2D design (one thread per quad, every output row an
// accumulator) would need 128 accumulators beside the 56 trace values, and
// keeping all of z (120 floats) in registers while walking the rows spilled
// 1.3-1.6 KB a thread.  So one thread per hex keeps the trace bc (56 floats)
// in registers and makes four passes over the [M^3 + C^3] output rows,
// kRows = 32 accumulators a pass: the f part of z is streamed from device
// memory (coalesced, the later passes hit the cache), and each step is one
// 16-byte shared-memory broadcast of O^T[j][r..r+3] for four FMAs.  The w
// rows are stored as they come and the residual rows reduce into the
// slack; B w then reads the thread's w row back.  O^T, B^T and the trace
// factors live in 77 KB of opt-in dynamic shared memory, loaded once per
// block; the grid is sized to the resident blocks and strides over the
// hexes, so the operators are not reloaded per 128 hexes.
//
// Built WITHOUT --use_fast_math.  The entry point launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include "enhance_common.cuh"

// (M, C) pairs this source compiles; enhance3d_supported() answers for them
// (SHAPES in ops/kernels3d.py is the Python-side copy).
#define ENH3D_SHAPES(X) X(4, 4)

namespace {

using enh::nan_max;

template <int M, int C, bool DIAG>
struct Layout3 {
  static constexpr int M3 = M * M * M, C3 = C * C * C;
  static constexpr int S = M3 - (M - 2) * (M - 2) * (M - 2);
  static constexpr int Z = C3 + S;                  // inputs of O
  static constexpr int ROWS = DIAG ? M3 + C3 : M3;  // outputs of O
  static_assert(M3 % 4 == 0 && C3 % 4 == 0 && S % 4 == 0,
                "float4 layout needs M^3, C^3 and S divisible by 4");
  static constexpr int OT = 0;              // O^T [Z][ROWS]
  static constexpr int BT = OT + Z * ROWS;  // B^T [M3][S]
  static constexpr int PTS = BT + M3 * S;   // [14][S]: N_a (8), face flags
  static constexpr int SIZE = PTS + 14 * S;
};

constexpr int kThreads = 128;
// Output rows a pass: kRows accumulators beside the 56 trace values.
constexpr int kRows = 32;

// Rows [R r0, R r0 + R) of O z, O^T stored [Z][ROWS]: R accumulators in
// registers.  z is streamed: its f part from device memory (element index
// fastest, so the loads coalesce; later passes hit the cache), its trace
// part from the thread's column of shared memory.  Each step is R / 4
// 16-byte shared-memory broadcasts for R FMAs.  The loops are unrolled by
// 4 only: unrolled in full, the compiler hoists hundreds of shared-memory
// loads and spills them.
template <int C3, int S, int ROWS, int R, int T>
__device__ __forceinline__ void rows_of_Oz(const float4* OT4, int r0,
                                           const float* __restrict__ f,
                                           size_t E, size_t e,
                                           const float* bcs, float* acc) {
  constexpr int RW = ROWS / 4;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int j = 0; j < C3 + S; ++j) {
    const float z = j < C3 ? f[(size_t)j * E + e] : bcs[(j - C3) * T];
    const float4* o = OT4 + j * RW + r0 * (R / 4);
#pragma unroll
    for (int r4 = 0; r4 < R / 4; ++r4) {
      const float4 v = o[r4];
      acc[4 * r4] += v.x * z;
      acc[4 * r4 + 1] += v.y * z;
      acc[4 * r4 + 2] += v.z * z;
      acc[4 * r4 + 3] += v.w * z;
    }
  }
}

// gface [6][S][F]: g at the surface points of the boundary hexes of the
// x-lo, x-hi (indexed ez ny + ey), y-lo, y-hi (ez nx + ex), z-lo, z-hi
// (ey nx + ex) domain face.  A point on an edge or corner of the box lies on
// two or three faces; each row holds g at the same point.
template <int M, int C, bool DIAG>
__global__ void __launch_bounds__(kThreads)
stacked3d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                 const float* __restrict__ gface,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv, int nx,
                 int ny, int nz, int F) {
  using L = Layout3<M, C, DIAG>;
  constexpr int M3 = L::M3, C3 = L::C3, S = L::S, ROWS = L::ROWS;
  static_assert(M3 % kRows == 0 && ROWS % kRows == 0,
                "the w and residual rows must fill whole passes");
  extern __shared__ __align__(16) float s[];
  for (int i = threadIdx.x; i < L::SIZE; i += blockDim.x) s[i] = statics[i];
  __syncthreads();
  const float4* OT4 = reinterpret_cast<const float4*>(s + L::OT);
  const float4* BT4 = reinterpret_cast<const float4*>(s + L::BT);
  const float* pts = s + L::PTS;
  // The thread's trace values, bcs[k * kThreads] (conflict-free).
  float* bcs = s + L::SIZE + threadIdx.x;
  const long long E = (long long)nx * ny * nz;
  const size_t sx = 1, sy = (size_t)nx + 1, sz = sy * ((size_t)ny + 1);

  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    const int ex = (int)(e % nx);
    const int ey = (int)((e / nx) % ny);
    const int ez = (int)(e / ((long long)nx * ny));
    // Trilinear trace, corner order a = 4 cz + 2 cy + cx, with g on the
    // domain faces.
    const float* base = fem + ez * sz + ey * sy + ex * sx;
    float u[8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      u[a] = base[((a >> 2) & 1) * sz + ((a >> 1) & 1) * sy + (a & 1) * sx];
    const bool on[6] = {ex == 0, ex == nx - 1, ey == 0,
                        ey == ny - 1, ez == 0, ez == nz - 1};
    const int idx[6] = {ez * ny + ey, ez * ny + ey, ez * nx + ex,
                        ez * nx + ex, ey * nx + ex, ey * nx + ex};
    const bool boundary = on[0] || on[1] || on[2] || on[3] || on[4] || on[5];
#pragma unroll 4
    for (int k = 0; k < S; ++k) {
      float v = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) v += pts[a * S + k] * u[a];
      if (boundary) {
#pragma unroll
        for (int fc = 0; fc < 6; ++fc) {
          if (on[fc] && pts[(8 + fc) * S + k] > 0.5f) {
            v = gface[((size_t)fc * S + k) * F + idx[fc]];
            break;
          }
        }
      }
      bcs[k * kThreads] = v;
    }

    // [w; e] = O [f; bc], kRows output rows a pass: w rows are stored,
    // residual rows reduce into the slack.
    float4* wrow = reinterpret_cast<float4*>(w + (size_t)e * M3);
    float sl = 0.f;
#pragma unroll 1
    for (int r0 = 0; r0 < ROWS / kRows; ++r0) {
      float acc[kRows];
      rows_of_Oz<C3, S, ROWS, kRows, kThreads>(OT4, r0, f, (size_t)E,
                                               (size_t)e, bcs, acc);
      if (r0 < M3 / kRows) {
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4)
          wrow[r0 * (kRows / 4) + r4] = make_float4(
              acc[4 * r4], acc[4 * r4 + 1], acc[4 * r4 + 2], acc[4 * r4 + 3]);
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) sl = nan_max(sl, fabsf(acc[r]));
      }
    }
    if (!DIAG) continue;
    slack[e] = sl;
    // bcv = max |bc - B w|, B w accumulated over the w row just stored
    // (read back through the cache), one w value a step.
    const float* wr = w + (size_t)e * M3;
    float bw[S];
#pragma unroll
    for (int k = 0; k < S; ++k) bw[k] = 0.f;
#pragma unroll 2
    for (int m = 0; m < M3; ++m) {
      const float wm = wr[m];
#pragma unroll
      for (int k4 = 0; k4 < S / 4; ++k4) {
        const float4 b = BT4[m * (S / 4) + k4];
        bw[4 * k4] += b.x * wm;
        bw[4 * k4 + 1] += b.y * wm;
        bw[4 * k4 + 2] += b.z * wm;
        bw[4 * k4 + 3] += b.w * wm;
      }
    }
    float bv = 0.f;
#pragma unroll
    for (int k = 0; k < S; ++k)
      bv = nan_max(bv, fabsf(bcs[k * kThreads] - bw[k]));
    bcv[e] = bv;
  }
}

template <int M, int C, bool DIAG>
cudaError_t launch(int device, cudaStream_t st, const float* fem,
                   const float* f, const float* gface, const float* statics,
                   float* w, float* slack, float* bcv, int nx, int ny, int nz,
                   int F) {
  using L = Layout3<M, C, DIAG>;
  constexpr size_t smem = sizeof(float) * (L::SIZE + L::S * kThreads);
  auto kernel = stacked3d_kernel<M, C, DIAG>;
  // Above 48 KB dynamic shared memory is opt-in, per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long E = (long long)nx * ny * nz;
  const long long need = (E + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  kernel<<<blocks, kThreads, smem, st>>>(fem, f, gface, statics, w, slack,
                                         bcv, nx, ny, nz, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int enhance3d_supported(int M, int C) {
#define X(m, c) if (M == m && C == c) return 1;
  ENH3D_SHAPES(X)
#undef X
  return 0;
}

const char* enhance3d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int enhance3d_stacked_f32(int device, void* stream, const float* fem,
                          const float* f, const float* gface,
                          const float* statics, float* w, float* slack,
                          float* bcv, int nx, int ny, int nz, int F, int M,
                          int C, int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                            \
  if (M == m && C == c)                                                    \
    return (int)(diag ? launch<m, c, true>(device, st, fem, f, gface,      \
                                           statics, w, slack, bcv, nx, ny, \
                                           nz, F)                          \
                      : launch<m, c, false>(device, st, fem, f, gface,     \
                                            statics, w, slack, bcv, nx,    \
                                            ny, nz, F));
  ENH3D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
