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
// At M = C = 4, O is [128, 120] and B [56, 64]: 37.9 kflop a hex, 79.5
// GFLOP at 2^21 hexes against ~1.1 GB moved.
//
// Bound on the H100: operations.  At the float32 rate of the CUDA cores
// that is 1.19 ms (67 TFLOP/s), which a float32 design cannot approach
// while it also builds the trace; PR 3's one-thread-a-hex kernel ran 4.95
// ms.  So the products run on the tensor cores in 3xTF32 (enhance_mma.cuh):
// three TF32 products a product, 0.48 ms at the dense TF32 peak of 495
// TFLOP/s.  Design:
//   * One persistent block a SM (the grid is the number of resident
//     blocks, queried once per device and variant) loads the operators
//     once, split and fragment-ordered: O^T [120][128] (123 KB), B^T
//     [64][56] (29 KB), the trace factors (3 KB).  It is two sub-blocks of
//     four warps with their own barriers and streams of 64-hex tiles, so
//     that one's loads, trace and stores overlap the other's products.
//   * A tile's z lives k-major in shared memory, [k][hex] with a row stride
//     of 72 floats (conflict-free fragment loads).  Its f rows come in with
//     cp.async (a tile's row of f is contiguous) while two threads a hex
//     build its 56 trace rows (corner gather, face override with each
//     face's loads issued together).
//   * A warp owns 16 hexes and all 128 outputs (64 accumulators a thread).
//     The w rows are summed outside the tensor cores a k-step at a time
//     (bcv is rounding of an exact zero and needs the float32 rounding);
//     the residual rows stay in them and reduce into the slack across the
//     four lanes of a fragment row.  w's columns are interleaved on the
//     host so its accumulators are B w's A fragments as they stand; B w
//     reads the trace from the z tile.  w goes out an n-tile at a time
//     through a small staging tile, each store writing whole 32-byte
//     sectors.
//   * 225 KB of shared memory, 250 registers a thread, no spill.
//
// Built WITHOUT --use_fast_math (NaN must reach the solve_ok gate).  The
// entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the first CUDA error.

#include <limits.h>
#include <stdint.h>

#include "enhance_common.cuh"
#include "enhance_mma.cuh"

// (M, C) pairs this source compiles; enhance3d_supported() answers for them
// (SHAPES in ops/kernels3d.py is the Python-side copy).
#define ENH3D_SHAPES(X) X(4, 4)

namespace {

using enh::nan_max;

// A block is two sub-blocks of four warps, each with its own tile stream
// and barrier, so that one's trace and epilogue overlap the other's
// products.
constexpr int kThreads = 256;
constexpr int kSubs = 2;
constexpr int kSubThreads = kThreads / kSubs;
constexpr int kSubWarps = kSubThreads / 32;
constexpr int kTile = 16 * kSubWarps;  // hexes a tile, 16 a warp
constexpr int kLd = kTile + 8;         // z tile row stride: 8 (mod 32)

template <int M, int C, bool DIAG>
struct Layout3 {
  static constexpr int M3 = M * M * M, C3 = C * C * C;
  static constexpr int S = M3 - (M - 2) * (M - 2) * (M - 2);
  static constexpr int ROWS = DIAG ? M3 + C3 : M3;  // outputs of O
  static_assert(C3 % 8 == 0 && S % 8 == 0 && M3 % 8 == 0,
                "the k and n steps need C^3, S and M^3 divisible by 8");
  static constexpr int NT = ROWS / 8, NW = M3 / 8, NB = S / 8;
  // statics (ops/kernels3d.py _pack): O^T [C3 + S][ROWS] (w columns
  // interleaved) and B^T [M3][S], split and fragment-ordered (4 floats an
  // entry pair), then the trace factors [14][S].
  static constexpr int OF = 0;
  static constexpr int BF = OF + 2 * (C3 + S) * ROWS;
  static constexpr int PTS = BF + 2 * M3 * S;
  static constexpr int SIZE = PTS + 14 * S;
  // shared memory beyond the statics, per sub-block: the f rows and the
  // trace rows of its z tile, k-major; then a staging tile a warp.
  static constexpr int FBUF = SIZE;
  static constexpr int TBUF = FBUF + C3 * kLd;
  static constexpr int SUB = C3 * kLd + S * kLd;
  static constexpr int STAGE = SIZE + kSubs * SUB;
  static constexpr int SMEM = STAGE + kSubs * kSubWarps * enh::tc::kStage;
  static_assert(SIZE % 4 == 0 && BF % 4 == 0 && PTS % 4 == 0,
                "float4 statics");
  static_assert(sizeof(float) * SMEM <= 232448,
                "more shared memory than a block can have");
};

// gface [6][S][F]: g at the surface points of the boundary hexes of the
// x-lo, x-hi (indexed ez ny + ey), y-lo, y-hi (ez nx + ex), z-lo, z-hi
// (ey nx + ex) domain face.  A point on an edge or corner of the box lies on
// two or three faces; each row holds g at the same point.  Writes trace
// rows [k0, k0 + KP) of hex e into column ``col`` of the k-major tile.
template <int S, int KP>
__device__ __forceinline__ void trace_rows(const float* __restrict__ fem,
                                           const float* __restrict__ gface,
                                           const float* pts, int e, int nx,
                                           int ny, int nz, int F, int k0,
                                           float* col) {
  static_assert(S % KP == 0 && KP % 4 == 0 && S % 4 == 0,
                "float4 rows of the trace factors");
  const int ex = e % nx, exy = e / nx;
  const int ey = exy % ny, ez = exy / ny;
  const size_t sy = (size_t)nx + 1, sz = sy * ((size_t)ny + 1);
  // Trilinear trace, corner order a = 4 cz + 2 cy + cx.
  const float* base = fem + ez * sz + ey * sy + ex;
  float u[8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
    u[a] = base[((a >> 2) & 1) * sz + ((a >> 1) & 1) * sy + (a & 1)];
  float v[KP];
#pragma unroll
  for (int k4 = 0; k4 < KP / 4; ++k4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float4 n = reinterpret_cast<const float4*>(pts + a * S + k0)[k4];
      acc.x += n.x * u[a];
      acc.y += n.y * u[a];
      acc.z += n.z * u[a];
      acc.w += n.w * u[a];
    }
    v[4 * k4] = acc.x;
    v[4 * k4 + 1] = acc.y;
    v[4 * k4 + 2] = acc.z;
    v[4 * k4 + 3] = acc.w;
  }
  // g on the domain faces of the hex: all of a face's values are loaded
  // together (one round trip to memory, not one a point); the faces go in
  // reverse order, so that where faces meet the first one wins.
  const bool on[6] = {ex == 0, ex == nx - 1, ey == 0,
                      ey == ny - 1, ez == 0, ez == nz - 1};
  const int idx[6] = {ez * ny + ey, ez * ny + ey, ez * nx + ex,
                      ez * nx + ex, ey * nx + ex, ey * nx + ex};
#pragma unroll
  for (int fc = 5; fc >= 0; --fc) {
    if (on[fc]) {
      const float* gf = gface + ((size_t)fc * S + k0) * F + idx[fc];
      float gv[KP];
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) gv[kk] = gf[(size_t)kk * F];
      const float* flag = pts + (8 + fc) * S + k0;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        if (flag[kk] > 0.5f) v[kk] = gv[kk];
    }
  }
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) col[(k0 + kk) * kLd] = v[kk];
}

template <int M, int C, bool DIAG>
__global__ void __launch_bounds__(kThreads, 1)
stacked3d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                 const float* __restrict__ gface,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv, int nx,
                 int ny, int nz, int F) {
  using L = Layout3<M, C, DIAG>;
  using namespace enh::tc;
  constexpr int M3 = L::M3, C3 = L::C3, S = L::S;
  extern __shared__ __align__(16) float s[];
  for (int i = threadIdx.x; i < L::SIZE / 4; i += kThreads)
    reinterpret_cast<float4*>(s)[i] =
        reinterpret_cast<const float4*>(statics)[i];
  __syncthreads();  // the statics
  const float4* OF = reinterpret_cast<const float4*>(s + L::OF);
  const float4* BF = reinterpret_cast<const float4*>(s + L::BF);
  const float* pts = s + L::PTS;
  const int sub = threadIdx.x / kSubThreads, stid = threadIdx.x % kSubThreads;
  const int warp = stid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* fbuf = s + L::FBUF + sub * L::SUB;
  float* tbuf = s + L::TBUF + sub * L::SUB;
  float* stage = s + L::STAGE + (sub * kSubWarps + warp) * kStage;

  const int E = nx * ny * nz;  // < 2^31, checked by the entry point
  const int tiles = (E + kTile - 1) / kTile;
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  // Two threads a hex build its trace rows, half of them each.
  constexpr int kParts = kSubThreads / kTile, kPart = S / kParts;
  static_assert(kPart * kParts == S, "trace rows split evenly");
  const int el = stid % kTile, part = stid / kTile;

  for (int tile = kSubs * blockIdx.x + sub; tile < tiles;
       tile += kSubs * (int)gridDim.x) {
    load_tile<kTile>(fbuf, kLd, f, C3, E, tile * kTile, vec, stid,
                     kSubThreads);
    cp_async_commit();
    if (tile * kTile + el < E)
      trace_rows<S, kPart>(fem, gface, pts, tile * kTile + el, nx, ny, nz, F,
                           part * kPart, tbuf + el);
    cp_async_wait<0>();
    sub_sync(1 + sub, kSubThreads);  // the z tile is whole

    const int e0 = tile * kTile + warp * 16;
    if (e0 < E) {  // warp-uniform
      const int rows = E - e0 < 16 ? E - e0 : 16;
      // [w; e] = O [f; bc] for the warp's 16 hexes; the residual rows e
      // keep their sums in the tensor cores.
      float acc[L::NT][4];
      zero(acc);
      strip_mma<L::NT, 3, true, L::NW>(acc, fbuf + warp * 16, kLd, C3 / 8,
                                       OF, lane);
      strip_mma<L::NT, 3, true, L::NW>(acc, tbuf + warp * 16, kLd, S / 8,
                                       OF + (C3 / 8) * L::NT * 32, lane);
      store_rows<M3>(w + (size_t)e0 * M3, acc, stage, rows, lane);
      if constexpr (DIAG) {
        // rows g and g + 8 of the strip
        float sl0 = 0.f, sl1 = 0.f;
#pragma unroll
        for (int nt = L::NW; nt < L::NT; ++nt) {
          sl0 = nan_max(nan_max(sl0, fabsf(acc[nt][0])), fabsf(acc[nt][1]));
          sl1 = nan_max(nan_max(sl1, fabsf(acc[nt][2])), fabsf(acc[nt][3]));
        }
        // bcv = max |bc - B w|, w from the accumulators.
        float bw[L::NB][4];
        zero(bw);
        strip_mma_regs<L::NB, 3, 0, L::NW>(bw, acc, BF, lane);
        const float* bc = tbuf + warp * 16 + g;
        float bv0 = 0.f, bv1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < L::NB; ++nt) {
          const int k = 8 * nt + 2 * t;
          bv0 = nan_max(bv0, fabsf(bc[k * kLd] - bw[nt][0]));
          bv0 = nan_max(bv0, fabsf(bc[(k + 1) * kLd] - bw[nt][1]));
          bv1 = nan_max(bv1, fabsf(bc[k * kLd + 8] - bw[nt][2]));
          bv1 = nan_max(bv1, fabsf(bc[(k + 1) * kLd + 8] - bw[nt][3]));
        }
        sl0 = row_max(sl0);
        sl1 = row_max(sl1);
        bv0 = row_max(bv0);
        bv1 = row_max(bv1);
        if (t == 0) {
          if (g < rows) {
            slack[e0 + g] = sl0;
            bcv[e0 + g] = bv0;
          }
          if (g + 8 < rows) {
            slack[e0 + g + 8] = sl1;
            bcv[e0 + g + 8] = bv1;
          }
        }
      }
    }
    sub_sync(1 + sub, kSubThreads);  // the z tile is read
  }
}

template <int M, int C, bool DIAG>
cudaError_t launch(int device, cudaStream_t st, const float* fem,
                   const float* f, const float* gface, const float* statics,
                   float* w, float* slack, float* bcv, int nx, int ny, int nz,
                   int F) {
  constexpr size_t smem = sizeof(float) * Layout3<M, C, DIAG>::SMEM;
  static int cache[enh::kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  const int resident = enh::resident_blocks(
      stacked3d_kernel<M, C, DIAG>, cache, device, kThreads, smem, &err);
  if (resident == 0) return err;
  const int tiles = (nx * ny * nz + kTile - 1) / kTile;
  const int need = (tiles + kSubs - 1) / kSubs;
  stacked3d_kernel<M, C, DIAG>
      <<<(unsigned)(need < resident ? need : resident), kThreads, smem,
         st>>>(fem, f, gface, statics, w, slack, bcv, nx, ny, nz, F);
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

// statics: O^T and B^T split and fragment-ordered, then the trace factors
// (Layout3).
int enhance3d_stacked_f32(int device, void* stream, const float* fem,
                          const float* f, const float* gface,
                          const float* statics, float* w, float* slack,
                          float* bcv, int nx, int ny, int nz, int F, int M,
                          int C, int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1 || nz < 1 ||
      (long long)nx * ny * nz > INT_MAX - 2 * kTile)
    return (int)cudaErrorInvalidValue;
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
