// Element tiles through the tensor cores in split TF32 (sm_80 and later;
// built for sm_90a), shared by the redesigned enhancement kernels
// (enhance3d.cu, enhance2d_elastic.cu, enhance2d.cu).
//
// A warp owns a strip of 16 elements and computes every output of a
// per-element product out[e][n] = sum_k a[e][k] op[k][n] as the M side of
// mma.sync.m16n8k8 TF32: the elements are the 16 rows of A, the operator is
// B.  TF32 keeps 10 mantissa bits, so each float32 value x is split into
// hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact; tf32 rounds to
// nearest, ties away) and a product is summed from lo*hi + hi*lo + hi*hi
// (TERMS = 3, "3xTF32") or also lo*lo (TERMS = 4); TERMS = 1 is plain
// TF32, hi*hi alone, for a product whose error does not matter.  hi + lo
// holds x to 2^-22 of its size, four times float32's rounding; where that
// is too coarse, the operator is split once more, lo2 = tf32(x - hi - lo)
// (hi + lo + lo2 = x exactly), and TERMS = 5 adds lo*lo and hi*lo2.
// Products of two TF32 values are exact in float32.  The tensor cores
// round their float32 sums toward zero, which biases a long sum kept in
// them, so each k-step's terms
// are summed by the tensor cores from zero and added to the accumulators on
// the CUDA cores, which round to nearest: the diagnostics (bcv is float32
// rounding of an exact zero) then stay at the size of a float32 product's.
//
// The operator is split and packed on the host (ops/kernels2d.py ``_frag``)
// in fragment order, op[k][n] zero-padded to K and N multiples of 8:
// float4 frag[ks][nt][lane] = (b0.hi, b1.hi, b0.lo, b1.lo) with
// b0 = op[8 ks + t][8 nt + g], b1 = op[8 ks + t + 4][8 nt + g], g = lane / 4,
// t = lane % 4: one conflict-free 16-byte shared-memory load gives a lane
// both halves of its B fragment; lo2, where TERMS = 5 reads it, is a second
// array float2 frag3[ks][nt][lane] = (b0.lo2, b1.lo2).  The element side is
// split in registers.
//
// Fragment layouts of m16n8k8 (PTX ISA, "Matrix fragments for mma.m16n8k8",
// .tf32):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Where a product's output feeds a second product (w feeds B w and D w),
// the host orders the output columns of each n-tile as
// (0, 4, 1, 5, 2, 6, 3, 7) (``_frag``'s ``interleave``): lane (g, t) then
// holds c0 = out[g][8 nt + t], c1 = out[g][8 nt + t + 4], c2, c3 the same of
// row g + 8, which is the A fragment of k-step nt as it stands
// (strip_mma_regs) and which stage_rows writes to a shared tile without
// bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "enhance_common.cuh"

namespace enh {
namespace tc {

// n rounded up to a multiple of 8 (the k and n steps of m16n8k8).
__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d = a b (TF32 operands, float32 result).
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a b.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// d = a b where ``first`` (d's first term), else d += a b.
__device__ __forceinline__ void mma_term(float (&d)[4], bool first,
                                         const uint32_t (&a)[4], float b0,
                                         float b1) {
  if (first)
    mma0(d, a, __float_as_uint(b0), __float_as_uint(b1));
  else
    mma(d, a, __float_as_uint(b0), __float_as_uint(b1));
}

// One k-step for the warp's strip: acc[nt] += a op[k-step][nt], nt < NT,
// with a = (a0, a1, a2, a3) the lane's A fragment in float32 and ``b``
// the operator's fragments of this k-step (frag + ks NT 32 + lane; ``b3``
// the same of frag3 where TERMS = 5).  The n-tiles go in groups of at most
// 4 (registers: a group holds 8 a tile); each term runs over a whole group
// before the next, so that consecutive mma.sync of a warp do not wait on
// one another.  N-tiles from NOUT on keep their sums in the tensor cores
// (no output of theirs is a float32 rounding of zero that a diagnostic
// reads).
template <int NT, int TERMS, int NOUT = NT>
__device__ __forceinline__ void kstep(float (&acc)[NT][4], const float (&a)[4],
                                      const float4* b,
                                      const float2* b3 = nullptr) {
  static_assert(TERMS == 1 || (TERMS >= 3 && TERMS <= 5),
                "1, 3, 4 or 5 TF32 products");
  constexpr int kGroups = (NT + 3) / 4;
  constexpr int G = (NT + kGroups - 1) / kGroups;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = to_tf32(a[i]);
    al[i] = to_tf32(a[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += G) {
    float4 v[G];
    float2 v3[G];
    float d[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (n0 + j < NT) {
        v[j] = b[(n0 + j) * 32];
        if constexpr (TERMS == 5) v3[j] = b3[(n0 + j) * 32];
      }
    }
    // Small terms first, the hi * hi term last: hi * lo2, lo * lo, lo * hi,
    // hi * lo, hi * hi, those of them that TERMS takes.  An n-tile below
    // NOUT (``out``, compile-time after unrolling) sums the k-step from
    // zero in d and adds it to acc on the CUDA cores.
    constexpr bool kLoHi = TERMS >= 3;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (n0 + j < NT) {
        const bool out = n0 + j < NOUT;
        float(&dj)[4] = out ? d[j] : acc[n0 + j];
        if constexpr (TERMS == 5) mma_term(dj, out, ah, v3[j].x, v3[j].y);
      }
    }
    if constexpr (TERMS >= 4) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (n0 + j < NT) {
          const bool out = n0 + j < NOUT;
          mma_term(out ? d[j] : acc[n0 + j], out && TERMS == 4, al, v[j].z,
                   v[j].w);
        }
      }
    }
    if constexpr (kLoHi) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (n0 + j < NT) {
          const bool out = n0 + j < NOUT;
          mma_term(out ? d[j] : acc[n0 + j], out && TERMS == 3, al, v[j].x,
                   v[j].y);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (n0 + j < NT)
          mma(n0 + j < NOUT ? d[j] : acc[n0 + j], ah,
              __float_as_uint(v[j].z), __float_as_uint(v[j].w));
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (n0 + j < NT) {
        const bool out = n0 + j < NOUT;
        mma_term(out ? d[j] : acc[n0 + j], out && TERMS == 1, ah, v[j].x,
                 v[j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (n0 + j < NOUT)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n0 + j][i] += d[j][i];
  }
}

// acc += a op for the strip, a read from a shared-memory tile, k_steps
// k-steps of the fragment-ordered operator ``frag``.  The tile is k-major
// (KMAJOR), a[e][k] at p[k * ld + e], ld = 8 or 24 (mod 32), or element-major,
// a[e][k] at p[e * ld + k], ld = 4 (mod 8); p at the strip's first element
// and first k; either way the fragment loads are conflict-free.
// ``frag3`` is the operator's lo2 array where TERMS = 5.
template <int NT, int TERMS, bool KMAJOR, int NOUT = NT>
__device__ __forceinline__ void strip_mma(float (&acc)[NT][4], const float* p,
                                          int ld, int k_steps,
                                          const float4* frag, int lane,
                                          const float2* frag3 = nullptr) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < k_steps; ++ks) {
    const size_t off = (size_t)ks * NT * 32 + lane;
    const float2* b3 = TERMS == 5 ? frag3 + off : nullptr;
    if constexpr (KMAJOR) {
      const float* q = p + (8 * ks + t) * ld + g;
      const float a[4] = {q[0], q[8], q[4 * ld], q[4 * ld + 8]};
      kstep<NT, TERMS, NOUT>(acc, a, frag + off, b3);
    } else {
      const float* q = p + g * ld + 8 * ks + t;
      const float a[4] = {q[0], q[8 * ld], q[4], q[8 * ld + 4]};
      kstep<NT, TERMS, NOUT>(acc, a, frag + off, b3);
    }
  }
}

// acc += a op for the strip, with a's k-steps [K0, K0 + KS) held in the
// accumulators ``w`` of an earlier product whose output columns were
// interleaved (see above): w[ks] is the A fragment of k-step ks.  NOUT as
// in kstep.
template <int NT, int TERMS, int K0, int KS, int NOUT = NT, int NW>
__device__ __forceinline__ void strip_mma_regs(float (&acc)[NT][4],
                                               const float (&w)[NW][4],
                                               const float4* frag, int lane) {
  static_assert(K0 + KS <= NW, "k-steps beyond the held outputs");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float a[4] = {w[K0 + ks][0], w[K0 + ks][2], w[K0 + ks][1],
                        w[K0 + ks][3]};
    kstep<NT, TERMS, NOUT>(acc, a, frag + (size_t)ks * NT * 32 + lane);
    // A compiler barrier: without it the operator loads of every k-step
    // of the unrolled loop are hoisted to its top, at a cost in registers.
    asm volatile("" ::: "memory");
  }
}

// Stores rows [0, rows) of the strip's interleaved outputs (see above)
// that hold the columns [0, R) of out [E][R], the strip's first row at
// ``out``.  Each n-tile goes through the warp's staging tile ``stage``
// [16][kStageLd] in shared memory (conflict-free writes), so that each
// store to device memory writes whole 32-byte sectors (16 bytes a lane,
// two lanes a row).
constexpr int kStageLd = 12;
constexpr int kStage = 16 * kStageLd;
template <int R, int NT>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[NT][4],
                                           float* stage, int rows, int lane) {
  static_assert(R % 8 == 0 && R / 8 <= NT, "whole n-tiles, all held");
  constexpr int NW = R / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NW; ++nt) {
    float* st = stage + g * kStageLd + t;
    st[0] = acc[nt][0];
    st[4] = acc[nt][1];
    st[8 * kStageLd] = acc[nt][2];
    st[8 * kStageLd + 4] = acc[nt][3];
    __syncwarp();
    // lane: row lane / 2, columns 4 (lane % 2) .. + 3
    const int r = lane >> 1, c = 4 * (lane & 1);
    if (r < rows)
      *reinterpret_cast<float4*>(out + r * R + 8 * nt + c) =
          *reinterpret_cast<const float4*>(stage + r * kStageLd + c);
    __syncwarp();
  }
}

// Writes the strip's interleaved outputs n-tiles [0, NW) (see above) into
// an element-major shared tile in their true column order, out[e * ld + n]
// (ld = 4 (mod 8): conflict-free).
template <int NW, int NT>
__device__ __forceinline__ void stage_rows(const float (&acc)[NT][4],
                                           float* tile, int ld, int lane) {
  static_assert(NW <= NT, "fewer outputs held than staged");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NW; ++nt) {
    float* q = tile + g * ld + 8 * nt + t;
    q[0] = acc[nt][0];
    q[4] = acc[nt][1];
    q[8 * ld] = acc[nt][2];
    q[8 * ld + 4] = acc[nt][3];
  }
}

// Copies rows [0, rows) of an element-major shared tile (stride ld) to
// device memory, where they are contiguous rows of R floats: 16 bytes a
// lane, consecutive lanes on consecutive addresses, where R allows it.
template <int R>
__device__ __forceinline__ void copy_rows(float* __restrict__ dst,
                                          const float* tile, int ld, int rows,
                                          int lane) {
  if constexpr (R % 4 == 0) {
    constexpr int kChunks = R / 4;
    for (int c = lane; c < rows * kChunks; c += 32) {
      const int r = c / kChunks, m = 4 * (c - r * kChunks);
      reinterpret_cast<float4*>(dst)[c] =
          *reinterpret_cast<const float4*>(tile + r * ld + m);
    }
  } else {
    for (int i = lane; i < rows * R; i += 32) {
      const int r = i / R;
      dst[i] = tile[r * ld + i - r * R];
    }
  }
}

// max over the four lanes that hold one accumulator row (NaN-propagating).
__device__ __forceinline__ float row_max(float v) {
  v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return nan_max(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The cp.async helpers live in enhance_common.cuh.
using enh::cp_async16;
using enh::cp_async4;
using enh::cp_async_commit;
using enh::cp_async_wait;

// Starts the copy of rows [0, rows) of a [rows][E] global array (element
// index fastest), columns [e0, e0 + TILE) clipped at E, into a k-major
// shared tile dst[row * ld + (e - e0)], by threads [0, threads) (this one
// is ``tid``).  16-byte copies where the rows are 16-byte aligned
// (E % 4 == 0 and an aligned base), 4-byte ones otherwise.
template <int TILE>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int rows, int E, int e0, bool vec,
                                          int tid, int threads) {
  const int valid = E - e0 < TILE ? E - e0 : TILE;
  if (vec) {
    constexpr int kChunks = TILE / 4;
    for (int i = tid; i < rows * kChunks; i += threads) {
      const int r = i / kChunks, c = 4 * (i - r * kChunks);
      if (c < valid)
        cp_async16(dst + r * ld + c, src + (size_t)r * E + e0 + c);
    }
  } else {
    for (int i = tid; i < rows * TILE; i += threads) {
      const int r = i / TILE, c = i - r * TILE;
      if (c < valid) cp_async4(dst + r * ld + c, src + (size_t)r * E + e0 + c);
    }
  }
}

// Barrier ``id`` (1..15) over the ``threads`` threads of a sub-block.
__device__ __forceinline__ void sub_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace tc
}  // namespace enh
