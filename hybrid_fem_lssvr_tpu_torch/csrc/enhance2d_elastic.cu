// Fused 2D vector (plane-strain elasticity) LSSVR enhancement kernel for
// Hopper (sm_90a), plain C interface.  It replaces the Pallas TPU kernel
// fused_enhance_elastic_2d of hybrid_fem_lssvr_tpu/ops/pallas_kernels.py.
//
// Per quad e, with both displacement components' data stacked:
//
//   f  [2 C^2]: the body force at the C^2 interior collocation points, f1's
//               rows then f2's, sampled by the wrapper into f [2 C^2][E]
//               (element index fastest);
//   bc [2 KB]:  per component c the bilinear trace of the corner values of
//               fem[c] at the KB = 4M-4 trace points, overridden on the
//               domain edges by g_c (gedge [2][4][KB][nmax], see
//               enhance_common.cuh);
//
//   w     = [Wf | Wbc] [f; bc]                       [2 M^2]
//   slack = max |f - D w|,   bcv = max |bc - B w|,   B = diag(Bs, Bs)
//
// Bound on the H100: 2M^2 (2C^2 + 2KB) multiply-adds for w, 2C^2 2M^2 for
// D w and 2 KB M^2 for B w (B's zero blocks skipped): 14,688 a quad at
// M = C = 6, 30.8 GFLOP at 1024^2 quads (0.46 ms at the CUDA cores' 67
// TFLOP/s) against 0.62 GB of f read and w written (0.19 ms at 3.35 TB/s).
//
// PR 4's one-thread-a-quad kernel ran 2.37 ms at M = 6 with 218 registers
// and one shared-memory broadcast per four FMAs.  Design (enhance3d.cu's,
// through enhance_mma.cuh): the products run on the tensor cores in split
// TF32, 64-quad tiles as the M side.
//   * One persistent block a SM loads the operators once, split,
//     fragment-ordered and zero-padded to multiples of 8 ([Wf | Wbc]^T
//     [112][72], D^T [72][72], the rows of B^T each component reads
//     [40][24] twice at M = 6); it is two sub-blocks of four warps with
//     their own barriers and tile streams, so that one's loads, traces and
//     stores overlap the other's products.
//   * A tile's z lives k-major in shared memory ([k][quad], row stride 72
//     floats: conflict-free fragment loads).  Its f rows come in with
//     cp.async while one thread a quad and component builds that
//     component's trace rows (enh::trace_bc) into the tile.
//   * A warp owns 16 quads and all 2 M^2 outputs (36 accumulators a thread
//     at M = 6).  w = [Wf | Wbc] z takes four TF32 products a product
//     (lo*lo too): chip_smoke compares the slack, which multiplies w's
//     rounding by ||D|| (~6e7 at 1024^2), with the plain version's, and
//     with w in 3xTF32 the two differ by 0.030 of its size there, over
//     SLACK_REL's 0.025; in 4xTF32 by 0.016 (the emulation of
//     tests/test_torch_tf32_split.py run as a script, M = 6).  D w and B w
//     are 3xTF32; all three sum outside the tensor cores a k-step at a
//     time.
//   * w goes to the warp's element-major tile in shared memory, from there
//     to device memory in coalesced 16-byte stores (a strip's rows are
//     contiguous), and D w and B w read it there (rolled k loops: 123
//     registers, no spill), f and the trace from the z tile; their maxima
//     reduce across the four lanes of a fragment row.
//   * 220 KB of shared memory a block at M = 6.
//
// Built WITHOUT --use_fast_math (NaN must reach the solve_ok gate).  The
// entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the first CUDA error.

#include <stdint.h>

#include "enhance_common.cuh"
#include "enhance_mma.cuh"

namespace {

using enh::nan_max;
using enh::trace_bc;
using enh::tc::pad8;

// A block is two sub-blocks of four warps, each with its own tile stream
// and barrier, so that one's trace and epilogue overlap the other's
// products.
constexpr int kThreads = 256;
constexpr int kSubs = 2;
constexpr int kSubThreads = kThreads / kSubs;
constexpr int kSubWarps = kSubThreads / 32;
constexpr int kTile = 16 * kSubWarps;  // quads a tile, 16 a warp
constexpr int kLd = kTile + 8;         // z tile row stride: 8 (mod 32)

template <int M, int C>
struct Shape {
  static constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  static constexpr int R = 2 * M2, NP = pad8(R);      // columns of w
  static constexpr int FR = 2 * C2, FRP = pad8(FR);   // f rows of z
  static constexpr int TR = 2 * KB;                   // trace rows of z
  static_assert(TR % 8 == 0, "2 KB = 8 (M - 1) trace rows");
  static constexpr int K = FRP + TR;                  // z, f rows padded
  static constexpr int NW = NP / 8, ND = FRP / 8, NB = pad8(KB) / 8;
  // The k-steps of w that component 0's and 1's block of B reads: columns
  // [0, KB0) and [B1, NP).
  static constexpr int KB0 = pad8(M2), B1 = M2 / 8 * 8, KB1 = NP - B1;
  // statics (ops/kernels2d_elastic.py _pack), split and fragment-ordered
  // (4 floats an entry pair) but the trace points: [Wf | Wbc]^T [K][NP]
  // (w columns interleaved), the trace points [8][KB], D^T [NP][FRP], the
  // rows of B^T each component reads, [KB0][KB] and [KB1][KB].
  static constexpr int OF = 0;
  static constexpr int PTS = OF + 2 * K * NP;
  static constexpr int DF = PTS + 8 * KB;
  static constexpr int BF0 = DF + 2 * NP * FRP;
  static constexpr int BF1 = BF0 + 2 * KB0 * 8 * NB;
  static constexpr int SIZE = BF1 + 2 * KB1 * 8 * NB;
  // shared memory beyond the statics, per sub-block: the f rows and the
  // trace rows of its z tile, k-major; then a tile of w rows a warp,
  // element-major (row stride 4 (mod 8): conflict-free both ways).
  static constexpr int FBUF = SIZE;
  static constexpr int TBUF = FBUF + FRP * kLd;
  static constexpr int SUB = FRP * kLd + TR * kLd;
  static constexpr int WLD = NP + 4;
  static constexpr int WT = SIZE + kSubs * SUB;
  static constexpr int SMEM = WT + kSubs * kSubWarps * 16 * WLD;
  static_assert(SIZE % 4 == 0 && DF % 4 == 0, "float4 statics");
  static_assert(sizeof(float) * SMEM <= 232448,
                "more shared memory than a block can have");
};

template <int M, int C, bool DIAG>
__global__ void __launch_bounds__(kThreads, 1)
elastic2d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                 const float* __restrict__ gedge,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv, int nx,
                 int ny, int nmax) {
  using S = Shape<M, C>;
  using namespace enh::tc;
  constexpr int KB = S::KB, R = S::R, FR = S::FR, FRP = S::FRP;
  extern __shared__ __align__(16) float s[];
  for (int i = threadIdx.x; i < S::SIZE / 4; i += kThreads)
    reinterpret_cast<float4*>(s)[i] =
        reinterpret_cast<const float4*>(statics)[i];
  if constexpr (FRP > FR) {  // the padding rows of the f rows stay zero
    constexpr int kPad = (FRP - FR) * kLd;
    for (int i = threadIdx.x; i < kSubs * kPad; i += kThreads)
      s[S::FBUF + (i / kPad) * S::SUB + FR * kLd + i % kPad] = 0.f;
  }
  __syncthreads();  // the statics
  const float4* OF = reinterpret_cast<const float4*>(s + S::OF);
  const float4* DF = reinterpret_cast<const float4*>(s + S::DF);
  const float4* BF0 = reinterpret_cast<const float4*>(s + S::BF0);
  const float4* BF1 = reinterpret_cast<const float4*>(s + S::BF1);
  const float* pts = s + S::PTS;
  const int sub = threadIdx.x / kSubThreads, stid = threadIdx.x % kSubThreads;
  const int warp = stid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* fbuf = s + S::FBUF + sub * S::SUB;
  float* tbuf = s + S::TBUF + sub * S::SUB;
  float* wt = s + S::WT + (sub * kSubWarps + warp) * 16 * S::WLD;

  const int E = nx * ny;
  const int tiles = (E + kTile - 1) / kTile;
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  // One thread per quad and component builds that component's trace rows.
  static_assert(kSubThreads == 2 * kTile, "two components a quad");
  const int el = stid % kTile, comp = stid / kTile;
  const float* fem_c = fem + (size_t)comp * (ny + 1) * (nx + 1);
  const float* gedge_c = gedge + (size_t)comp * 4 * KB * nmax;

  for (int tile = kSubs * blockIdx.x + sub; tile < tiles;
       tile += kSubs * (int)gridDim.x) {
    load_tile<kTile>(fbuf, kLd, f, FR, E, tile * kTile, vec, stid,
                     kSubThreads);
    cp_async_commit();
    if (tile * kTile + el < E)
      trace_bc<KB>(fem_c, gedge_c, pts, tile * kTile + el, nx, ny, nmax,
                   tbuf + comp * KB * kLd + el, kLd);
    cp_async_wait<0>();
    sub_sync(1 + sub, kSubThreads);  // the z tile is whole

    const int e0 = tile * kTile + warp * 16;
    if (e0 < E) {  // warp-uniform
      const int rows = E - e0 < 16 ? E - e0 : 16;
      // w = [Wf | Wbc] z for the warp's 16 quads, 4xTF32, into the warp's
      // tile of w rows and from there to device memory.
      {
        float acc[S::NW][4];
        zero(acc);
        strip_mma<S::NW, 4, true>(acc, fbuf + warp * 16, kLd, FRP / 8, OF,
                                  lane);
        strip_mma<S::NW, 4, true>(acc, tbuf + warp * 16, kLd, S::TR / 8,
                                  OF + (FRP / 8) * S::NW * 32, lane);
        stage_rows<S::NW>(acc, wt, S::WLD, lane);
      }
      __syncwarp();
      copy_rows<R>(w + (size_t)e0 * R, wt, S::WLD, rows, lane);
      if constexpr (DIAG) {
        // slack = max |f - D w| over the strip's rows g and g + 8.
        float sl0 = 0.f, sl1 = 0.f;
        {
          float dw[S::ND][4];
          zero(dw);
          strip_mma<S::ND, 3, false>(dw, wt, S::WLD, S::NW, DF, lane);
          const float* fr = fbuf + warp * 16 + g;
#pragma unroll
          for (int nt = 0; nt < S::ND; ++nt) {
            const int c = 8 * nt + 2 * t;
            if (c < FR) {  // FR is even
              sl0 = nan_max(sl0, fabsf(fr[c * kLd] - dw[nt][0]));
              sl0 = nan_max(sl0, fabsf(fr[(c + 1) * kLd] - dw[nt][1]));
              sl1 = nan_max(sl1, fabsf(fr[c * kLd + 8] - dw[nt][2]));
              sl1 = nan_max(sl1, fabsf(fr[(c + 1) * kLd + 8] - dw[nt][3]));
            }
          }
        }
        // bcv = max |bc - B w| over both components' blocks of B.
        float bv0 = 0.f, bv1 = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float bw[S::NB][4];
          zero(bw);
          strip_mma<S::NB, 3, false>(bw, wt + (c ? S::B1 : 0), S::WLD,
                                     (c ? S::KB1 : S::KB0) / 8,
                                     c ? BF1 : BF0, lane);
          const float* bc = tbuf + c * KB * kLd + warp * 16 + g;
#pragma unroll
          for (int nt = 0; nt < S::NB; ++nt) {
            const int k = 8 * nt + 2 * t;
            if (k < KB) {  // KB is even
              bv0 = nan_max(bv0, fabsf(bc[k * kLd] - bw[nt][0]));
              bv0 = nan_max(bv0, fabsf(bc[(k + 1) * kLd] - bw[nt][1]));
              bv1 = nan_max(bv1, fabsf(bc[k * kLd + 8] - bw[nt][2]));
              bv1 = nan_max(bv1, fabsf(bc[(k + 1) * kLd + 8] - bw[nt][3]));
            }
          }
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
int launch(int device, cudaStream_t st, const float* fem, const float* f,
           const float* gedge, const float* statics, float* w, float* slack,
           float* bcv, int nx, int ny, int nmax) {
  constexpr size_t smem = sizeof(float) * Shape<M, C>::SMEM;
  static int cache[enh::kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  const int resident = enh::resident_blocks(
      elastic2d_kernel<M, C, DIAG>, cache, device, kThreads, smem, &err);
  if (resident == 0) return (int)err;
  const int tiles = (nx * ny + kTile - 1) / kTile;
  const int need = (tiles + kSubs - 1) / kSubs;
  elastic2d_kernel<M, C, DIAG>
      <<<(unsigned)(need < resident ? need : resident), kThreads, smem,
         st>>>(fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);
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

// statics: [Wf | Wbc]^T, pts, D^T, the rows of B^T of each component
// (Shape above).
int enhance2d_elastic_f32(int device, void* stream, const float* fem,
                          const float* f, const float* gedge,
                          const float* statics, float* w, float* slack,
                          float* bcv, int nx, int ny, int nmax, int M, int C,
                          int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                             \
  if (M == m && C == c)                                                     \
    return diag ? launch<m, c, true>(device, st, fem, f, gedge, statics, w, \
                                     slack, bcv, nx, ny, nmax)              \
                : launch<m, c, false>(device, st, fem, f, gedge, statics,   \
                                      w, slack, bcv, nx, ny, nmax);
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
