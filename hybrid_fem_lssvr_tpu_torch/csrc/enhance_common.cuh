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

// An index kept below N: a compile-time index that only a guarded, dead
// branch of an unrolled loop takes past the end of its array.
template <int N>
__device__ __forceinline__ int lim(int i) {
  return i < N ? i : N - 1;
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc + sum_k row[k] x[k], k < N in order (one fma each), from a 16-byte
// aligned row of shared memory.
template <int N>
__device__ __forceinline__ float dot_row(const float* row, const float* x,
                                         float acc = 0.f) {
#pragma unroll
  for (int c = 0; c < (N + 3) / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * c + i < N) acc = fmaf(part(v, i), x[lim<N>(4 * c + i)], acc);
  }
  return acc;
}

// cp.async of one float (any alignment) or four (16-byte aligned).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
// Waits until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// v[k] = g[k nmax] where flag[k] is set: one domain edge's Dirichlet values
// over a quad's trace, all loaded together (one round trip to memory, not
// one a point).
template <int KP>
__device__ __forceinline__ void override_edge(float (&v)[KP],
                                              const float* __restrict__ g,
                                              int nmax, const float* flag) {
  float gv[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) gv[k] = g[(size_t)k * nmax];
#pragma unroll
  for (int k = 0; k < KP; ++k)
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
// Values k0 .. k0 + KP - 1 (all KB by default); value k goes to
// bc[(k - k0) * stride].  The edges go in the reverse of the order left,
// right, bottom, top, so that where two meet the first of that order wins.
template <int KB, int KP = KB>
__device__ __forceinline__ void trace_bc(const float* __restrict__ fem,
                                         const float* __restrict__ gedge,
                                         const float* pts, int e, int nx,
                                         int ny, int nmax, float* bc,
                                         int stride = 1, int k0 = 0) {
  const int ex = e % nx, ey = e / nx;
  const float* row0 = fem + (size_t)ey * (nx + 1) + ex;
  const float* row1 = row0 + (nx + 1);
  const float u00 = row0[0], u10 = row0[1], u01 = row1[0], u11 = row1[1];
  const float* p = pts + k0;
  float v[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k)
    v[k] = p[k] * u00 + p[KB + k] * u10 + p[2 * KB + k] * u01 +
           p[3 * KB + k] * u11;
  const float* g = gedge + (size_t)k0 * nmax;
  if (ey == ny - 1)
    override_edge<KP>(v, g + (size_t)3 * KB * nmax + ex, nmax, p + 7 * KB);
  if (ey == 0)
    override_edge<KP>(v, g + (size_t)2 * KB * nmax + ex, nmax, p + 6 * KB);
  if (ex == nx - 1)
    override_edge<KP>(v, g + (size_t)1 * KB * nmax + ey, nmax, p + 5 * KB);
  if (ex == 0) override_edge<KP>(v, g + ey, nmax, p + 4 * KB);
#pragma unroll
  for (int k = 0; k < KP; ++k) bc[k * stride] = v[k];
}

// The launch shape of a persistent kernel, queried once per device:
// opts in to ``smem`` bytes of dynamic shared memory and returns the number
// of blocks resident on the whole card (0 on error, with the CUDA error in
// *err).  ``cache`` [kMaxDevices] belongs to the kernel variant.
constexpr int kMaxDevices = 64;
template <class Kernel>
__host__ int resident_blocks(Kernel kernel, int* cache, int device,
                             int threads, size_t smem, cudaError_t* err) {
  if (device < 0 || device >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[device] > 0) return cache[device];
  // Above 48 KB dynamic shared memory is opt-in, per kernel.
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (*err != cudaSuccess) return 0;
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem);
  if (*err != cudaSuccess) return 0;
  cache[device] = sms * (per_sm > 0 ? per_sm : 1);
  return cache[device];
}

}  // namespace enh
