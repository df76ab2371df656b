// The per-quad least-squares enhancement of the per-element 2D kernels
// (enhance2d_graded.cu, enhance2d_varcoeff.cu method='qr'), computed by a
// group of kLanes lanes of a warp, four quads a warp (sm_90a).  Its
// shared-memory layout of the statics (Statics), the builders of G's and
// g's rows (row_G, row_g) and of w and B w (w_entry, bw_entry) also serve
// varcoeff2d_sne_kernel, which gives a quad one thread (quad_w).
//
// Per quad the kernels solve, with bc [KB = 4M-4] its boundary trace and
// NB operator blocks AZ_b [C^2][K], AP_b [C^2][KB] (K = M^2 - KB):
//
//   G_k = sum_b cs_b(q) AZ_b[q][k]          per collocation row q < C^2
//   g_q = fq - sum_b cs_b(q) (AP_b[q] . bc)
//   y   = argmin ||G y - g||  (CGS2 QR, y = R^-1 Q^T g)
//   w   = Pbc bc + Z y;   bcv = max |bc - B w|;   slack = scale max |g - G y|
//
// The row weights cs_b(q) and fq are the kernel's (a functor); the rest is
// here.  The QR is the reference's (ops/kkt.py _batched_mgs_qr_factor):
// two modified Gram-Schmidt passes a column in column order, R_ij the sum
// of the two passes' coefficients, Q_j = v / (R_jj + 1e-30), then back
// substitution; only the order of each dot product's sum differs.
//
// Design.  A quad's Q is K C^2 floats (576 at M = C = 6), too many for one
// thread's registers, and from shared memory every multiply-add of the QR
// would wait on a load.  So the kLanes lanes of a group share the quad's
// rows: lane `sub` holds rows q = sub + kLanes r,
// r < R = ceil(C^2 / kLanes) (rows past C^2 are zero: they change no dot
// product and no norm), across all K columns, in registers.  A dot product
// over the rows is the lane's partial sum over its R rows, in order, then
// a butterfly of __shfl_xor_sync over lane distances 1, 2, 4, after which
// every lane of the group holds the same sum; the axpy that follows is
// local.  Column j's second pass runs beside column j+1's first pass
// against the same Q columns (one column of look-ahead): two independent
// chains of dot, butterfly and axpy.  R goes to the warp's scratch in
// shared memory as it is completed, and g when it is built; all lanes run
// the back substitution (K^2 / 2 steps).  The lanes split w (M^2
// outputs), B w (KB) and the slack's rows; the diagnostics' maxima are
// butterflies too.
//
// What binds it on the H100 (at M = C = 6): latency.  The second pass of
// column j is a chain of j dependent steps (dot, three shuffles and adds,
// axpy), some 150 steps a quad with the norms, most of a warp's time even
// when it runs alone on its scheduler; Q's registers leave 12 warps an
// SM, and from 8 warps on the time no longer falls (the schedulers'
// shared shuffle and shared-memory pipe and instruction slots).
//
// Statics in shared memory (Statics below): rows padded to a stride
// ld(n) that is a multiple of four floats with an odd quotient, so that
// the group's lanes, reading the same columns of kLanes different rows
// with one 16-byte load each, hit kLanes disjoint groups of four banks;
// the four groups of a warp read the same addresses (a broadcast).
// Scratch: kScratch slots a quad, slot s of the warp's group g at
// [s kGroups + g] (a broadcast read within a group, conflict-free across
// groups and for the lanes' own slots).
#pragma once

#include "enhance_common.cuh"

namespace enh {
namespace qr {

constexpr int kLanes = 8;             // lanes a quad
constexpr int kGroups = 32 / kLanes;  // quads a warp
// Resident blocks of 4 warps an SM that the register budget must allow: 3
// cap a thread at 168 registers (12 warps an SM).
constexpr int kMinBlocks = 3;
constexpr unsigned kFull = 0xffffffffu;

// The row stride of a static with n columns: n rounded up to a multiple of
// 4 whose quotient by 4 is odd.
__host__ __device__ constexpr int ld(int n) {
  return (n + 3) / 4 % 2 ? (n + 3) / 4 * 4 : (n + 3) / 4 * 4 + 4;
}

// Shared-memory layout of the statics for NB operator blocks:
//   AZ [NB][C2][ld(K)], AP [NB][C2][ld(KB)], Z [M2][ld(K)],
//   Pbc [M2][ld(KB)], B [KB][ld(M2)], pts [8][KB];
// then kScratch slots a quad: R (upper triangle by columns, R_ij at
// j (j + 1) / 2 + i), bc [KB], w [M2] and g [R kLanes] (row q of g at
// slot q, the padding rows included).
template <int M, int C, int NB>
struct Statics {
  static constexpr int M2 = M * M, C2 = C * C, KB = 4 * M - 4, K = M2 - KB;
  static constexpr int R = (C2 + kLanes - 1) / kLanes;  // rows a lane
  static constexpr int KP = ld(K), KBP = ld(KB), M2P = ld(M2);
  static constexpr int AZ = 0;
  static constexpr int AP = AZ + NB * C2 * KP;
  static constexpr int Z = AP + NB * C2 * KBP;
  static constexpr int PBC = Z + M2 * KP;
  static constexpr int B = PBC + M2 * KBP;
  static constexpr int PTS = B + KB * M2P;
  static constexpr int SIZE = PTS + 8 * KB;
  static constexpr int S_R = 0, S_BC = K * (K + 1) / 2, S_W = S_BC + KB;
  static constexpr int S_G = S_W + M2;
  static constexpr int kScratch = S_G + R * kLanes;
  // Floats of shared memory for a block of `warps` warps.
  static constexpr int smem_floats(int warps) {
    return SIZE + warps * kGroups * kScratch;
  }
};

// rows x cols of a dense row-major src into dst with row stride `stride`,
// zeros in the padding (all threads of the block).
__device__ __forceinline__ void load_padded(float* dst,
                                            const float* __restrict__ src,
                                            int rows, int cols, int stride) {
  for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) {
    const int r = i / stride, c = i - r * stride;
    dst[i] = c < cols ? src[(size_t)r * cols + c] : 0.f;
  }
}

// The statics as the host packs them (AZ, AP, Z, Pbc, B, pts, dense) into
// the padded layout above, once a block.
template <int M, int C, int NB>
__device__ __forceinline__ void load_statics(float* s,
                                             const float* __restrict__ src) {
  using S = Statics<M, C, NB>;
  load_padded(s + S::AZ, src, NB * S::C2, S::K, S::KP);
  src += NB * S::C2 * S::K;
  load_padded(s + S::AP, src, NB * S::C2, S::KB, S::KBP);
  src += NB * S::C2 * S::KB;
  load_padded(s + S::Z, src, S::M2, S::K, S::KP);
  src += S::M2 * S::K;
  load_padded(s + S::PBC, src, S::M2, S::KB, S::KBP);
  src += S::M2 * S::KB;
  load_padded(s + S::B, src, S::KB, S::M2, S::M2P);
  src += S::KB * S::M2;
  load_padded(s + S::PTS, src, 8, S::KB, S::KB);
  __syncthreads();
}

// The sum of p over the group's lanes, in every lane of the group: lane
// distances 1, 2, 4 (float addition commutes, so the partners agree).
__device__ __forceinline__ float group_sum(float p) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) p += __shfl_xor_sync(kFull, p, o);
  return p;
}

// The same for nan_max.
__device__ __forceinline__ float group_max(float p) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    p = nan_max(p, __shfl_xor_sync(kFull, p, o));
  return p;
}

// The lane's partial sum over its R rows of Q[r][a] Q[r][b], one fma a
// row, in order.
template <int R, int K>
__device__ __forceinline__ float rows_dot(const float (&Q)[R][K], int a,
                                          int b) {
  float p = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) p = fmaf(Q[r][a], Q[r][b], p);
  return p;
}

// Row q of the quad's G: G[k] = sum_b cs[b] AZ_b[q][k] (b < nb, one fma
// a block, in block order).
template <int M, int C, int NB>
__device__ __forceinline__ void row_G(const float* s, int q,
                                      const float (&cs)[NB], int nb,
                                      float* G) {
  using S = Statics<M, C, NB>;
#pragma unroll
  for (int k = 0; k < S::K; ++k) G[k] = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b >= nb) continue;
    const float* row = s + S::AZ + (b * S::C2 + q) * S::KP;
#pragma unroll
    for (int c = 0; c < (S::K + 3) / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(row + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * c + i < S::K) {
          const int k = lim<S::K>(4 * c + i);
          G[k] = fmaf(cs[b], part(v, i), G[k]);
        }
    }
  }
}

// Row q of the quad's g: fq - sum_b cs[b] (AP_b[q] . bc).
template <int M, int C, int NB>
__device__ __forceinline__ float row_g(const float* s, int q,
                                       const float (&cs)[NB], int nb,
                                       float fq, const float* bc) {
  using S = Statics<M, C, NB>;
  float dwp = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b >= nb) continue;
    const float p = dot_row<S::KB>(s + S::AP + (b * S::C2 + q) * S::KBP, bc);
    dwp = fmaf(cs[b], p, dwp);
  }
  return fq - dwp;
}

// Entry m of w = Pbc bc + Z y: each product one fma a term, in order.
template <int M, int C, int NB>
__device__ __forceinline__ float w_entry(const float* s, int m,
                                         const float* bc, const float* y) {
  using S = Statics<M, C, NB>;
  return dot_row<S::KB>(s + S::PBC + m * S::KBP, bc) +
         dot_row<S::K>(s + S::Z + m * S::KP, y);
}

// Entry k of B w, one fma a term, in order.
template <int M, int C, int NB>
__device__ __forceinline__ float bw_entry(const float* s, int k,
                                          const float* wv) {
  using S = Statics<M, C, NB>;
  return dot_row<S::M2>(s + S::B + k * S::M2P, wv);
}

// w [M2] of a quad that one thread holds whole (bc [KB] and y [K] in its
// registers); returns bcv = max_k |bc_k - (B w)_k|, 0 without diag.  The
// per-thread counterpart of the group's w and bcv in enhance_quad below,
// with the same sums.
template <int M, int C, int NB>
__device__ __forceinline__ float quad_w(const float* s, const float* bc,
                                        const float* y, float (&wv)[M * M],
                                        bool diag) {
  using S = Statics<M, C, NB>;
#pragma unroll
  for (int m = 0; m < S::M2; ++m) wv[m] = w_entry<M, C, NB>(s, m, bc, y);
  float bv = 0.f;
  if (diag) {
#pragma unroll
    for (int k = 0; k < S::KB; ++k)
      bv = nan_max(bv, fabsf(bc[k] - bw_entry<M, C, NB>(s, k, wv)));
  }
  return bv;
}

// The whole enhancement of the group's quad e (see the top of the file).
// `weights(q, cs, fq)` gives row q's block weights cs [NB] and fq, and
// `weights.slack_scale()` the slack's scale; nb <= NB blocks are used.
// `sub` is the lane within the group, `sc` the group's first scratch slot.
// w [E][M2] and, with diag, slack[e] = scale max |g - G y| and bcv[e] are
// written where `active` (an inactive group computes on a valid e and
// stores nothing, so that every lane of the warp reaches every shuffle).
template <int M, int C, int NB, class Weights>
__device__ __forceinline__ void enhance_quad(
    const float* s, const Weights& weights, int nb, int sub, float* sc,
    const float* __restrict__ fem, const float* __restrict__ gedge, int e,
    int nx, int ny, int nmax, float* __restrict__ w,
    float* __restrict__ slack, float* __restrict__ bcv, bool active,
    bool diag) {
  using S = Statics<M, C, NB>;
  constexpr int K = S::K, KB = S::KB, M2 = S::M2, C2 = S::C2, R = S::R;
  __syncwarp();  // the scratch of the previous quad is read

  float bc[KB];
  trace_bc<KB>(fem, gedge, s + S::PTS, e, nx, ny, nmax, bc);
#pragma unroll
  for (int k = 0; k < KB; ++k)
    if (k % kLanes == sub) sc[(S::S_BC + k) * kGroups] = bc[k];

  // The lane's rows of g, to the scratch (bc is then needed no more), and
  // of G (becoming Q in place).
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = sub + kLanes * r;
    const int qc = q < C2 ? q : C2 - 1;
    float cs[NB], fq;
    weights(qc, cs, fq);
    const float g = row_g<M, C, NB>(s, qc, cs, nb, fq, bc);
    sc[(S::S_G + q) * kGroups] = q < C2 ? g : 0.f;
  }
  float Q[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = sub + kLanes * r;
    const int qc = q < C2 ? q : C2 - 1;
    float cs[NB], fq;
    weights(qc, cs, fq);
    row_G<M, C, NB>(s, qc, cs, nb, Q[r]);
    if (q >= C2) {
#pragma unroll
      for (int k = 0; k < K; ++k) Q[r][k] = 0.f;
    }
  }

  // CGS2.  r1[i]: the first pass's R_ij of column j (the column in hand);
  // r1n: of column j + 1, whose first pass runs beside j's second.
  float r1[K], r1n[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int jn = lim<K>(j + 1);  // the next column (none after K - 1)
#pragma unroll
    for (int i = 0; i < j; ++i) {
      float pa = rows_dot(Q, i, j), pb = 0.f;
      if (j + 1 < K) pb = rows_dot(Q, i, jn);
      pa = group_sum(pa);
      if (j + 1 < K) pb = group_sum(pb);
      sc[(S::S_R + j * (j + 1) / 2 + i) * kGroups] = r1[i] + pa;
#pragma unroll
      for (int r = 0; r < R; ++r) Q[r][j] = fmaf(-pa, Q[r][i], Q[r][j]);
      if (j + 1 < K) {
        r1n[i] = pb;
#pragma unroll
        for (int r = 0; r < R; ++r)
          Q[r][jn] = fmaf(-pb, Q[r][i], Q[r][jn]);
      }
    }
    const float rjj = sqrtf(group_sum(rows_dot(Q, j, j)));
    sc[(S::S_R + j * (j + 1) / 2 + j) * kGroups] = rjj;
    const float inv = 1.f / (rjj + kEps);
#pragma unroll
    for (int r = 0; r < R; ++r) Q[r][j] *= inv;
    if (j + 1 < K) {
      const float pb = group_sum(rows_dot(Q, j, jn));
      r1n[j] = pb;
#pragma unroll
      for (int r = 0; r < R; ++r)
        Q[r][jn] = fmaf(-pb, Q[r][j], Q[r][jn]);
#pragma unroll
      for (int i = 0; i <= j; ++i) r1[i] = r1n[i];
    }
  }

  // y = R^-1 Q^T g, back substitution in the reference's order.
  float g[R], qtg[K], y[K];
#pragma unroll
  for (int r = 0; r < R; ++r) g[r] = sc[(S::S_G + sub + kLanes * r) * kGroups];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float p = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) p = fmaf(Q[r][j], g[r], p);
    qtg[j] = group_sum(p);
  }
  __syncwarp();  // R and bc are in the scratch
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float acc = qtg[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i)
      acc = fmaf(-sc[(S::S_R + i * (i + 1) / 2 + j) * kGroups], y[i], acc);
    y[j] = acc / (sc[(S::S_R + j * (j + 1) / 2 + j) * kGroups] + kEps);
  }

  // w = Pbc bc + Z y: outputs m = sub + kLanes t.
#pragma unroll
  for (int k = 0; k < KB; ++k) bc[k] = sc[(S::S_BC + k) * kGroups];
  float* wrow = w + (size_t)e * M2;
#pragma unroll 1
  for (int t = 0; t < (M2 + kLanes - 1) / kLanes; ++t) {
    const int m = sub + kLanes * t;
    const int mc = m < M2 ? m : M2 - 1;
    const float wm = w_entry<M, C, NB>(s, mc, bc, y);
    if (m < M2) {
      if (active) wrow[m] = wm;
      sc[(S::S_W + m) * kGroups] = wm;
    }
  }
  if (!diag) return;
  __syncwarp();  // w is in the scratch

  // bcv = max_k |bc_k - (B w)_k|: rows k = sub + kLanes t.
  float wv[M2];
#pragma unroll
  for (int m = 0; m < M2; ++m) wv[m] = sc[(S::S_W + m) * kGroups];
  float bv = 0.f;
#pragma unroll 1
  for (int t = 0; t < (KB + kLanes - 1) / kLanes; ++t) {
    const int k = sub + kLanes * t;
    const int kc = k < KB ? k : KB - 1;
    const float bw = bw_entry<M, C, NB>(s, kc, wv);
    if (k < KB) bv = nan_max(bv, fabsf(sc[(S::S_BC + k) * kGroups] - bw));
  }
  bv = group_max(bv);

  // slack: G's rows rebuilt (Q holds them no longer), against g.
  float sl = 0.f;
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const int q = sub + kLanes * r;
    const int qc = q < C2 ? q : C2 - 1;
    float cs[NB], fq, G[K];
    weights(qc, cs, fq);
    row_G<M, C, NB>(s, qc, cs, nb, G);
    float er = sc[(S::S_G + q) * kGroups];
#pragma unroll
    for (int k = 0; k < K; ++k) er = fmaf(-G[k], y[k], er);
    if (q < C2) sl = nan_max(sl, fabsf(er));
  }
  sl = group_max(sl);
  if (active && sub == 0) {
    slack[e] = weights.slack_scale() * sl;
    bcv[e] = bv;
  }
}

// The launch of a persistent per-quad kernel: `resident` blocks of
// `warps` warps at most, each warp taking four quads at a time.
__host__ __forceinline__ unsigned grid_for(int E, int warps, int resident) {
  const int units = (E + kGroups - 1) / kGroups;
  const int need = (units + warps - 1) / warps;
  return (unsigned)(need < resident ? need : resident);
}

}  // namespace qr
}  // namespace enh
