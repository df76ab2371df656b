// Fused 2D shared-operator LSSVR enhancement kernels for Hopper (sm_90a),
// plain C interface.  Each replaces one Pallas TPU kernel of
// hybrid_fem_lssvr_tpu/ops/pallas_kernels.py:
//
//   stacked2d_kernel <- fused_enhance_stacked_2d
//   shared2d_kernel  <- fused_enhance_shared_2d
//
// Both take the nodal grid fem [ny+1][nx+1], the rhs sampled at the C^2
// interior collocation points of every quad, f [C^2][E] (element index
// fastest), and the Dirichlet data along the four domain edges (gedge, see
// enhance_common.cuh); they build the boundary-trace values bc [KB = 4M-4]
// of each quad and apply the shared host-f64 operators to z = [f; bc]:
//
//   stacked:  [w; e] = [[Wf, Wbc], [Pres, Qres]] z,  slack = max |e|
//   shared:   w = [Wf | Wbc] z,                      slack = max |f - D w|
//   both:     bcv = max |bc - B w|
//
// Bound on the H100: per quad (M^2 + C^2)(C^2 + KB) + KB M^2 multiply-adds
// (stacked) or M^2 (C^2 + KB) + C^2 M^2 + KB M^2 (shared), 4,752 and 4,032
// at M = C = 6, against 144 B of f read and 144 B of w written: 10.0 and
// 8.5 GFLOP against 0.31 GB at 1024^2, 0.149 and 0.126 ms at the float32
// rate of the CUDA cores, 0.094 ms (bytes) with the products on the tensor
// cores.  The earlier one-thread-a-quad kernels (0.49 and 0.46 ms) did
// one shared-memory load per one to four FMAs and wrote w as 144-byte rows
// a thread.  Design (enhance3d.cu's recipe, through enhance_mma.cuh):
//   * The products run on the tensor cores in split TF32, strips of 16
//     quads as the M side of mma.sync.m16n8k8.  The operators are split
//     and fragment-ordered on the host (ops/kernels2d.py ``_frag``),
//     zero-padded to multiples of 8: stacked, O^T [C^2+KB][M^2+C^2] and
//     B^T [M^2][KB] (40 KB at M = 6); shared, [Wf | Wbc]^T [C^2+KB][M^2]
//     and [D; B]^T [M^2][C^2+KB] (42 KB).
//   * Every warp runs its own stream of strips, with no barrier but its
//     own: its strip's z lives k-major in its shared tile ([k][quad], f
//     rows then the trace rows, row stride 24 floats: conflict-free
//     fragment loads); the f rows come in with cp.async while two lanes a
//     quad build half its trace rows each (enh::trace_bc).  Blocks of 8
//     warps, two a SM (106 KB of shared memory each at M = 6, at most 128
//     registers a thread), persistent: the grid is the number of resident
//     blocks, queried once per device and variant.
//   * stacked: [w; e] in one product, 3xTF32.  The n-tiles holding w (and
//     the first residual rows, where M^2 is not a multiple of 8) are summed
//     outside the tensor cores a k-step at a time: bcv is rounding of an
//     exact zero, and the tensor cores round their sums toward zero.  The
//     residual rows stay in the tensor cores and reduce into the slack
//     across the four lanes of a fragment row.  w's columns are interleaved
//     on the host, so its accumulators are B w's A fragments as they stand
//     (B^T's rows beyond M^2 are zero: the residual columns of a shared
//     n-tile add nothing).
//   * shared: the slack f - D w multiplies w's rounding by ||D|| (~9e7 at
//     1024^2), and chip_smoke holds it to the plain float32 version's in
//     the mean: w in 3xTF32 lands at 3.5 times it, in 4xTF32 at 2.6 times
//     (hi + lo holds z and the operator to 2^-22 only).  So [Wf | Wbc] is
//     split three ways (hi + lo + lo2, exact) and w takes five products a
//     product (hi lo2, lo lo, lo hi, hi lo, hi hi): 0.72 times it
//     (tests/test_torch_tf32_split.py run as a script).  The k-steps over
//     f rows alone, whose part of w is ~1e-6, take three.  D w and B w are
//     [D; B] w, from w's accumulators, D's rows alone in plain TF32 (see
//     the kernel), the rest in 3xTF32; output column c is compared with
//     row c of the z tile (f, then the trace).
//   * w goes out through the warp's element-major staging tile, whose rows
//     are contiguous in w: whole 32-byte sectors, 16 bytes a lane.
//   * The ragged edge is masked, so any nx, ny runs.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, 1024^2 quads,
// M = C = 6, with diagnostics): stacked 0.22 ms (torch.mm of O z 0.37),
// shared 0.21 ms (torch.mm of [Wf | Wbc] z alone 0.17; of w, D w and B w
// together 0.38); 120 and 128 registers, no spill.  Without diagnostics the
// stacked kernel takes 0.15 ms for 105 mma a strip against 234 with them:
// the mma.sync beyond that cost ~244 TFLOP/s of TF32, half the dense peak,
// on top of the loads.  Sharing each operator fragment between two strips
// (fewer shared-memory loads) spilled at 128 registers and ran no faster
// with more; a second z tile a warp to fetch the next strip's f during the
// products ran slower (16 warps in one block).
//
// Built WITHOUT --use_fast_math (NaN must reach the solve_ok gate).  Each
// entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the first CUDA error.

#include <limits.h>
#include <stdint.h>

#include "enhance_common.cuh"
#include "enhance_mma.cuh"

namespace {

using enh::nan_max;
using enh::trace_bc;
using enh::tc::pad8;

constexpr int kWarps = 8;  // a block: warps with a strip stream each
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = 24;  // z tile row stride: 24 (mod 32), conflict-free

// What both kernels share.  statics (ops/kernels2d.py) end in the trace
// points [8][KB]; shared memory holds the statics, then a z tile a warp,
// then a w staging tile a warp.
template <int M, int C>
struct Dims {
  static constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4;
  static constexpr int K = C2 + KB, KP = pad8(K);  // z rows, padded
  static constexpr int MP = pad8(M2), NW = MP / 8;  // w columns, padded
  static constexpr int WLD = MP + 4;  // staging row stride: 4 (mod 8)
  static constexpr int ZT = KP * kLd, WT = 16 * WLD;
  static_assert(KB % 2 == 0, "two lanes a quad build half the trace each");
};

template <int M, int C, bool DIAG>
struct Stacked : Dims<M, C> {
  using D = Dims<M, C>;
  static constexpr int ROWS = DIAG ? D::M2 + D::C2 : D::M2;  // outputs of O
  static constexpr int NT = pad8(ROWS) / 8, NB = pad8(D::KB) / 8;
  // O^T [KP][8 NT] (w columns interleaved), B^T [MP][8 NB]: split and
  // fragment-ordered (4 floats an entry pair).
  static constexpr int OF = 0;
  static constexpr int BF = OF + 2 * D::KP * 8 * NT;
  static constexpr int PTS = BF + 2 * D::MP * 8 * NB;
  static constexpr int SIZE = PTS + 8 * D::KB;
  static constexpr int ZBUF = SIZE, WBUF = ZBUF + kWarps * D::ZT;
  static constexpr int SMEM = WBUF + kWarps * D::WT;
  static_assert(SIZE % 4 == 0 && BF % 4 == 0, "float4 statics");
};

template <int M, int C>
struct Shared : Dims<M, C> {
  using D = Dims<M, C>;
  // w's k-steps [0, KF) hold f rows alone, and [D; B]'s columns [0, C1)
  // D rows alone (ND n-tiles); the other NB2 n-tiles hold D's last rows
  // (where C^2 is not a multiple of 8) and B's.
  static constexpr int KF = D::C2 / 8, C1 = 8 * KF, ND = KF;
  static constexpr int NB2 = pad8(D::K - C1) / 8;
  static_assert(KF > 0, "a k-step of f rows alone");
  // [Wf | Wbc]^T [KP][MP] (w columns interleaved) split (4 floats an entry
  // pair), the lo2 of its rows [C1, KP) (2 floats an entry pair); the
  // columns [0, C1) of [D; B]^T [MP][K] and the rest, split.
  static constexpr int WF = 0;
  static constexpr int WF3 = WF + 2 * D::KP * D::MP;
  static constexpr int RF1 = WF3 + (D::KP - C1) * D::MP;
  static constexpr int RF2 = RF1 + 2 * D::MP * C1;
  static constexpr int PTS = RF2 + 2 * D::MP * 8 * NB2;
  static constexpr int SIZE = PTS + 8 * D::KB;
  static constexpr int ZBUF = SIZE, WBUF = ZBUF + kWarps * D::ZT;
  static constexpr int SMEM = WBUF + kWarps * D::WT;
  static_assert(SIZE % 4 == 0 && RF1 % 4 == 0 && RF2 % 4 == 0,
                "float4 statics");
};

// Block prologue: the statics into shared memory, the padding rows of every
// warp's z tile to zero (the operators' padding rows are zero, and 0 * NaN
// is not).
template <class L>
__device__ __forceinline__ void prologue(float* s,
                                         const float* __restrict__ statics) {
  for (int i = threadIdx.x; i < L::SIZE / 4; i += kThreads)
    reinterpret_cast<float4*>(s)[i] =
        reinterpret_cast<const float4*>(statics)[i];
  if constexpr (L::KP > L::K) {
    constexpr int kPad = (L::KP - L::K) * kLd;
    for (int i = threadIdx.x; i < kWarps * kPad; i += kThreads)
      s[L::ZBUF + (i / kPad) * L::ZT + L::K * kLd + i % kPad] = 0.f;
  }
  __syncthreads();
}

// Fills the warp's z tile for the strip of quads [e0, e0 + rows): the f
// rows by cp.async, the trace rows by two lanes a quad.  On return the
// tile is whole and visible to the warp.
template <int M, int C>
__device__ __forceinline__ void load_z(float* zt,
                                       const float* __restrict__ fem,
                                       const float* __restrict__ f,
                                       const float* __restrict__ gedge,
                                       const float* pts, int e0, int rows,
                                       int E, bool vec, int nx, int ny,
                                       int nmax, int lane) {
  using D = Dims<M, C>;
  constexpr int kHalf = D::KB / 2;
  enh::tc::load_tile<16>(zt, kLd, f, D::C2, E, e0, vec, lane, 32);
  enh::tc::cp_async_commit();
  const int q = lane & 15, half = lane >> 4;
  if (q < rows)
    trace_bc<D::KB, kHalf>(fem, gedge, pts, e0 + q, nx, ny, nmax,
                           zt + (D::C2 + half * kHalf) * kLd + q, kLd,
                           half * kHalf);
  enh::tc::cp_async_wait<0>();
  __syncwarp();
}

// Writes the strip's slack and bcv: v0, v1 hold the lane's maxima over rows
// g and g + 8 of its columns.
__device__ __forceinline__ void store_diag(float* __restrict__ slack,
                                           float* __restrict__ bcv, float sl0,
                                           float sl1, float bv0, float bv1,
                                           int e0, int rows, int lane) {
  using enh::tc::row_max;
  const int g = lane >> 2, t = lane & 3;
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

// ---------------------------------------------------------------------------
// 1. Stacked operator (replaces pallas_kernels.py::fused_enhance_stacked_2d).
template <int M, int C, bool DIAG>
__global__ void __launch_bounds__(kThreads, 2)
stacked2d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                 const float* __restrict__ gedge,
                 const float* __restrict__ statics, float* __restrict__ w,
                 float* __restrict__ slack, float* __restrict__ bcv, int nx,
                 int ny, int nmax) {
  using L = Stacked<M, C, DIAG>;
  using namespace enh::tc;
  constexpr int M2 = L::M2, C2 = L::C2, KB = L::KB;
  extern __shared__ __align__(16) float s[];
  prologue<L>(s, statics);
  const float4* OF = reinterpret_cast<const float4*>(s + L::OF);
  const float4* BF = reinterpret_cast<const float4*>(s + L::BF);
  const float* pts = s + L::PTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* zt = s + L::ZBUF + warp * L::ZT;
  float* wt = s + L::WBUF + warp * L::WT;

  const int E = nx * ny;  // < 2^31 - 16, checked by the entry point
  const int strips = (E + 15) / 16;
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  for (int strip = blockIdx.x * kWarps + warp; strip < strips;
       strip += gridDim.x * kWarps) {
    const int e0 = 16 * strip, rows = E - e0 < 16 ? E - e0 : 16;
    load_z<M, C>(zt, fem, f, gedge, pts, e0, rows, E, vec, nx, ny, nmax,
                 lane);
    // [w; e] = O z; the n-tiles from NW on hold residual rows only.
    float acc[L::NT][4];
    zero(acc);
    strip_mma<L::NT, 3, true, L::NW>(acc, zt, kLd, L::KP / 8, OF, lane);
    stage_rows<L::NW>(acc, wt, L::WLD, lane);
    __syncwarp();
    copy_rows<M2>(w + (size_t)e0 * M2, wt, L::WLD, rows, lane);
    if constexpr (DIAG) {
      // slack over the residual columns M2 <= c < ROWS of rows g, g + 8;
      // in an interleaved n-tile, c0 / c2 hold column 8 nt + t and c1 / c3
      // column 8 nt + t + 4.
      float sl0 = 0.f, sl1 = 0.f;
#pragma unroll
      for (int nt = M2 / 8; nt < L::NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * nt + t + 4 * h;
          if (c >= M2 && c < L::ROWS) {
            sl0 = nan_max(sl0, fabsf(acc[nt][h]));
            sl1 = nan_max(sl1, fabsf(acc[nt][2 + h]));
          }
        }
      }
      // bcv = max |bc - B w|, w from the accumulators, bc from the z tile.
      float bw[L::NB][4];
      zero(bw);
      strip_mma_regs<L::NB, 3, 0, L::NW>(bw, acc, BF, lane);
      const float* bc = zt + C2 * kLd + g;
      float bv0 = 0.f, bv1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < L::NB; ++nt) {
        const int k = 8 * nt + 2 * t;
        if (k < KB) {  // KB is even
          bv0 = nan_max(bv0, fabsf(bc[k * kLd] - bw[nt][0]));
          bv0 = nan_max(bv0, fabsf(bc[(k + 1) * kLd] - bw[nt][1]));
          bv1 = nan_max(bv1, fabsf(bc[k * kLd + 8] - bw[nt][2]));
          bv1 = nan_max(bv1, fabsf(bc[(k + 1) * kLd + 8] - bw[nt][3]));
        }
      }
      store_diag(slack, bcv, sl0, sl1, bv0, bv1, e0, rows, lane);
    }
    __syncwarp();  // the tiles are read
  }
}

// ---------------------------------------------------------------------------
// 2. Separate operators (replaces pallas_kernels.py::fused_enhance_shared_2d),
//    for a bundle without the residual projector Pres.
template <int M, int C, bool DIAG>
__global__ void __launch_bounds__(kThreads, 2)
shared2d_kernel(const float* __restrict__ fem, const float* __restrict__ f,
                const float* __restrict__ gedge,
                const float* __restrict__ statics, float* __restrict__ w,
                float* __restrict__ slack, float* __restrict__ bcv, int nx,
                int ny, int nmax) {
  using L = Shared<M, C>;
  using namespace enh::tc;
  constexpr int M2 = L::M2, C2 = L::C2, K = L::K, KF = L::KF;
  extern __shared__ __align__(16) float s[];
  prologue<L>(s, statics);
  const float4* WF = reinterpret_cast<const float4*>(s + L::WF);
  const float2* WF3 = reinterpret_cast<const float2*>(s + L::WF3);
  const float4* RF1 = reinterpret_cast<const float4*>(s + L::RF1);
  const float4* RF2 = reinterpret_cast<const float4*>(s + L::RF2);
  const float* pts = s + L::PTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* zt = s + L::ZBUF + warp * L::ZT;
  float* wt = s + L::WBUF + warp * L::WT;

  const int E = nx * ny;  // < 2^31 - 16, checked by the entry point
  const int strips = (E + 15) / 16;
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  for (int strip = blockIdx.x * kWarps + warp; strip < strips;
       strip += gridDim.x * kWarps) {
    const int e0 = 16 * strip, rows = E - e0 < 16 ? E - e0 : 16;
    load_z<M, C>(zt, fem, f, gedge, pts, e0, rows, E, vec, nx, ny, nmax,
                 lane);
    // w = [Wf | Wbc] z: three TF32 products a product over the f rows
    // alone (w's rhs part, ~1e-6 at 1024^2), five over the rest.
    float acc[L::NW][4];
    zero(acc);
    strip_mma<L::NW, 3, true>(acc, zt, kLd, KF, WF, lane);
    strip_mma<L::NW, 5, true>(acc, zt + 8 * KF * kLd, kLd, L::KP / 8 - KF,
                              WF + KF * L::NW * 32, lane, WF3);
    stage_rows<L::NW>(acc, wt, L::WLD, lane);
    __syncwarp();
    copy_rows<M2>(w + (size_t)e0 * M2, wt, L::WLD, rows, lane);
    if constexpr (DIAG) {
      // r = [D; B] w, against row c of the z tile in column c (f for
      // c < C2, the trace beyond).  D's rows alone in plain TF32, summed
      // in the tensor cores: w is small where D is large (sum |D| |w| ~ 40
      // against ||D|| ~ 9e7 at 1024^2), so its error, ~4e-3, is far below
      // the slack's own rounding.  The rest in 3xTF32: bcv is rounding of
      // an exact zero.  c0 / c2 hold column 8 nt + 2 t of rows g / g + 8,
      // c1 / c3 the next column.
      float r1[L::ND][4], r2[L::NB2][4];
      zero(r1);
      zero(r2);
      strip_mma_regs<L::ND, 1, 0, L::NW, 0>(r1, acc, RF1, lane);
      strip_mma_regs<L::NB2, 3, 0, L::NW>(r2, acc, RF2, lane);
      const float* zg = zt + g;
      float sl0 = 0.f, sl1 = 0.f, bv0 = 0.f, bv1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < L::ND; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * nt + 2 * t + h;  // < C1 <= C2
          sl0 = nan_max(sl0, fabsf(zg[c * kLd] - r1[nt][h]));
          sl1 = nan_max(sl1, fabsf(zg[c * kLd + 8] - r1[nt][2 + h]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < L::NB2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = L::C1 + 8 * nt + 2 * t + h;
          if (c < K) {
            const float d0 = fabsf(zg[c * kLd] - r2[nt][h]);
            const float d1 = fabsf(zg[c * kLd + 8] - r2[nt][2 + h]);
            if (c < C2) {
              sl0 = nan_max(sl0, d0);
              sl1 = nan_max(sl1, d1);
            } else {
              bv0 = nan_max(bv0, d0);
              bv1 = nan_max(bv1, d1);
            }
          }
        }
      }
      store_diag(slack, bcv, sl0, sl1, bv0, bv1, e0, rows, lane);
    }
    __syncwarp();  // the tiles are read
  }
}

// The launch shape of a kernel variant on ``device``: its dynamic shared
// memory and the number of its blocks resident on the card (0 on error,
// with the CUDA error in *err).
template <class L, class Kernel>
int shape_of(Kernel kernel, int* cache, int device, size_t* smem,
             cudaError_t* err) {
  *smem = sizeof(float) * L::SMEM;
  return enh::resident_blocks(kernel, cache, device, kThreads, *smem,
                                  err);
}

template <int M, int C, bool DIAG>
int shape_stacked(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  return shape_of<Stacked<M, C, DIAG>>(stacked2d_kernel<M, C, DIAG>, cache,
                                       device, smem, err);
}

template <int M, int C, bool DIAG>
int shape_shared(int device, size_t* smem, cudaError_t* err) {
  static int cache[enh::kMaxDevices] = {};
  return shape_of<Shared<M, C>>(shared2d_kernel<M, C, DIAG>, cache, device,
                                smem, err);
}

// kind 0: stacked2d_kernel, 1: shared2d_kernel.
int launch_shape(int kind, int device, int M, int C, int diag, size_t* smem,
                 cudaError_t* err) {
#define X(m, c)                                                              \
  if (M == m && C == c) {                                                    \
    if (kind == 0)                                                           \
      return diag ? shape_stacked<m, c, true>(device, smem, err)             \
                  : shape_stacked<m, c, false>(device, smem, err);           \
    return diag ? shape_shared<m, c, true>(device, smem, err)                \
                : shape_shared<m, c, false>(device, smem, err);              \
  }
  ENH2D_SHAPES(X)
#undef X
  *err = cudaErrorInvalidValue;
  return 0;
}

int launch(int kind, int device, void* stream, const float* fem,
           const float* f, const float* gedge, const float* statics, float* w,
           float* slack, float* bcv, int nx, int ny, int nmax, int M, int C,
           int diag) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nx < 1 || ny < 1 || (long long)nx * ny > INT_MAX - 16)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int resident = launch_shape(kind, device, M, C, diag, &smem, &err);
  if (resident == 0) return (int)err;
  const int strips = (nx * ny + 15) / 16;
  const int need = (strips + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  cudaStream_t st = (cudaStream_t)stream;
#define X(m, c)                                                             \
  if (M == m && C == c) {                                                   \
    if (kind == 0 && diag)                                                  \
      stacked2d_kernel<m, c, true><<<grid, kThreads, smem, st>>>(           \
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);             \
    else if (kind == 0)                                                     \
      stacked2d_kernel<m, c, false><<<grid, kThreads, smem, st>>>(          \
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);             \
    else if (diag)                                                          \
      shared2d_kernel<m, c, true><<<grid, kThreads, smem, st>>>(            \
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);             \
    else                                                                    \
      shared2d_kernel<m, c, false><<<grid, kThreads, smem, st>>>(           \
          fem, f, gedge, statics, w, slack, bcv, nx, ny, nmax);             \
    return (int)cudaGetLastError();                                         \
  }
  ENH2D_SHAPES(X)
#undef X
  return (int)cudaErrorInvalidValue;
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

// statics: O^T and B^T split and fragment-ordered, then the trace points
// (Stacked above).
int enhance2d_stacked_f32(int device, void* stream, const float* fem,
                          const float* f, const float* gedge,
                          const float* statics, float* w, float* slack,
                          float* bcv, int nx, int ny, int nmax, int M, int C,
                          int diag) {
  return launch(0, device, stream, fem, f, gedge, statics, w, slack, bcv, nx,
                ny, nmax, M, C, diag);
}

// statics: [Wf | Wbc]^T split three ways and [D; B]^T split in two column
// blocks, fragment-ordered, then the trace points (Shared above).
int enhance2d_shared_f32(int device, void* stream, const float* fem,
                         const float* f, const float* gedge,
                         const float* statics, float* w, float* slack,
                         float* bcv, int nx, int ny, int nmax, int M, int C,
                         int diag) {
  return launch(1, device, stream, fem, f, gedge, statics, w, slack, bcv, nx,
                ny, nmax, M, C, diag);
}

// The launch shape of stacked2d_kernel (kind 0) or shared2d_kernel (1):
// *smem_bytes of dynamic shared memory a block, *blocks resident on the
// card.  Returns the CUDA error.
int enhance2d_launch_shape(int kind, int device, int M, int C, int diag,
                           int* smem_bytes, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  *blocks = launch_shape(kind, device, M, C, diag, &smem, &err);
  *smem_bytes = (int)smem;
  return *blocks > 0 ? 0 : (int)err;
}

}  // extern "C"
