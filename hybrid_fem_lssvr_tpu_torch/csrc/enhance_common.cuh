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
template <int KB>
__device__ __forceinline__ void trace_bc(const float* __restrict__ fem,
                                         const float* __restrict__ gedge,
                                         const float* pts, int e, int nx,
                                         int ny, int nmax, float* bc) {
  const int ex = e % nx, ey = e / nx;
  const float* row0 = fem + (size_t)ey * (nx + 1) + ex;
  const float* row1 = row0 + (nx + 1);
  const float u00 = row0[0], u10 = row0[1], u01 = row1[0], u11 = row1[1];
  const bool is_l = ex == 0, is_r = ex == nx - 1;
  const bool is_b = ey == 0, is_t = ey == ny - 1;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    float v = pts[k] * u00 + pts[KB + k] * u10 + pts[2 * KB + k] * u01 +
              pts[3 * KB + k] * u11;
    if (is_l && pts[4 * KB + k] > 0.5f)
      v = gedge[(size_t)(0 * KB + k) * nmax + ey];
    else if (is_r && pts[5 * KB + k] > 0.5f)
      v = gedge[(size_t)(1 * KB + k) * nmax + ey];
    else if (is_b && pts[6 * KB + k] > 0.5f)
      v = gedge[(size_t)(2 * KB + k) * nmax + ex];
    else if (is_t && pts[7 * KB + k] > 0.5f)
      v = gedge[(size_t)(3 * KB + k) * nmax + ex];
    bc[k] = v;
  }
}

}  // namespace enh
