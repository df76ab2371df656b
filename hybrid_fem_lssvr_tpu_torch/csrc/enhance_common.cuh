// Helpers shared by the fused LSSVR enhancement kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// (M, C) pairs the 2D sources compile; their *_supported() functions answer
// for them (SHAPES in ops/kernels2d.py is the Python-side copy).
#define ENH2D_SHAPES(X) X(4, 4) X(5, 5) X(6, 6)

namespace enh {

constexpr float kEps = 1e-30f;

// max / min that propagate NaN (jnp.max / jnp.maximum semantics; fmaxf
// drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// Copies the host-f64 operators ("statics") into shared memory, once per
// block; they are read there as warp-wide broadcasts.
__device__ __forceinline__ void load_statics(float* dst,
                                             const float* __restrict__ src,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// v[k] = g[k nmax] where flag[k] is set: one domain edge's Dirichlet values
// over a quad's trace, all loaded together (one round trip to memory, not
// one a point).
template <int KB>
__device__ __forceinline__ void override_edge(float (&v)[KB],
                                              const float* __restrict__ g,
                                              int nmax, const float* flag) {
  float gv[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) gv[k] = g[(size_t)k * nmax];
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (flag[k] > 0.5f) v[k] = gv[k];
}

// Boundary-trace values of quad e on an nx x ny grid, row-major quads:
// the bilinear trace of the four corner values fem[ey..ey+1][ex..ex+1] at
// the KB trace points, overridden on domain-boundary edges by the Dirichlet
// data sampled along that edge.
//
//   pts   [8][KB]: N00, N10, N01, N11 (bilinear shape factors at the trace
//                  points), then 0/1 flags: point on the element's left,
//                  right, bottom, top edge.
//   gedge [4][KB][nmax]: g at the trace points of the boundary elements
//                  along the left (index ey), right (ey), bottom (ex) and
//                  top (ex) domain edge.  A corner point lies on two edges;
//                  both rows hold g at the same point.
//
// Value k goes to bc[k * stride].  The edges go in the reverse of the order
// left, right, bottom, top, so that where two meet the first of that order
// wins.
template <int KB>
__device__ __forceinline__ void trace_bc(const float* __restrict__ fem,
                                         const float* __restrict__ gedge,
                                         const float* pts, int e, int nx,
                                         int ny, int nmax, float* bc,
                                         int stride = 1) {
  const int ex = e % nx, ey = e / nx;
  const float* row0 = fem + (size_t)ey * (nx + 1) + ex;
  const float* row1 = row0 + (nx + 1);
  const float u00 = row0[0], u10 = row0[1], u01 = row1[0], u11 = row1[1];
  float v[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k)
    v[k] = pts[k] * u00 + pts[KB + k] * u10 + pts[2 * KB + k] * u01 +
           pts[3 * KB + k] * u11;
  if (ey == ny - 1)
    override_edge<KB>(v, gedge + (size_t)3 * KB * nmax + ex, nmax,
                      pts + 7 * KB);
  if (ey == 0)
    override_edge<KB>(v, gedge + (size_t)2 * KB * nmax + ex, nmax,
                      pts + 6 * KB);
  if (ex == nx - 1)
    override_edge<KB>(v, gedge + (size_t)1 * KB * nmax + ey, nmax,
                      pts + 5 * KB);
  if (ex == 0) override_edge<KB>(v, gedge + ey, nmax, pts + 4 * KB);
#pragma unroll
  for (int k = 0; k < KB; ++k) bc[k * stride] = v[k];
}

// Stores one quad's M2 coefficients as a row of w [E][M2], 16 bytes at a
// time where the row is float4-aligned.
template <int M2>
__device__ __forceinline__ void store_row(float* __restrict__ wrow,
                                          const float* wv) {
  if constexpr (M2 % 4 == 0) {
#pragma unroll
    for (int m = 0; m < M2; m += 4)
      *reinterpret_cast<float4*>(wrow + m) =
          make_float4(wv[m], wv[m + 1], wv[m + 2], wv[m + 3]);
  } else {
#pragma unroll
    for (int m = 0; m < M2; ++m) wrow[m] = wv[m];
  }
}

// bcv = max_k |bc_k - (B w)_k|, B [KB][M2] in shared memory.
template <int M2, int KB>
__device__ __forceinline__ float bc_violation(const float* Bm, const float* wv,
                                              const float* bc) {
  float bv = 0.f;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    float r = 0.f;
#pragma unroll
    for (int m = 0; m < M2; ++m) r += Bm[k * M2 + m] * wv[m];
    bv = nan_max(bv, fabsf(bc[k] - r));
  }
  return bv;
}

}  // namespace enh
