// Per-bin complex Gaussian-elimination core shared by the FDN kernels in
// fdn_kernels.cu.
//
// Counterpart of the in-register core of flamo_tpu/ops/pallas_solve.py
// (_ge_core, _ge_core_nopivot_factors, _transpose_solve_from_factors,
// _assemble_fdn).  There each elimination scalar is an (8, 128) vector
// register tile of 1024 bins; here ONE THREAD OWNS ONE BIN and keeps the
// N x N complex loop matrix in registers (2 N^2 floats: 72 at N = 6).  All
// loops run over the compile-time N and are fully unrolled, so every
// A[i][j] index is a constant and the arrays never leave registers.  At
// N = 6 the kernels take 96-128 registers and spill nothing; from N = 8
// the gradient kernels reach the 255-register limit, and from N = 10 the
// matrix and its pivot copies spill to local memory: correct, but slower
// (nvcc -Xptxas -v for sm_90a, through cuda_build.build's ptxas_log).
//
// Complex numbers are float2 (x = re, y = im), with the same explicit
// formulas as the TPU kernel's re/im pairs.  Pivoting is select-based
// (branch-free), exactly as there: the strictly larger |a|^2 wins, so
// the first maximal row is the pivot.
//
// The gradient kernels K1 and K3b end with sums over the block's bins of
// N^2 + 2N + 1 per-bin values (49 at N = 6).  On an H100 K1 is bound by
// issue slots, not by bytes: ~1,450 instructions a thread at N = 6 with 3
// warps a scheduler on most SMs, and one shuffle tree a value (5 SHFL and
// 5 FADD each, a predicated store) took a third of them.  warp_sums sums
// them by recursive halving instead: 51 shuffles and 51 adds at N = 6,
// each lane then holding the warp sums of at most two values.  A
// transposed sum through shared memory (every thread parks its values,
// then runs of 64 bins are summed by a thread a value) measured no faster
// (controls/k6_k1_designs/time_designs.py).
#pragma once

#include <cuda_runtime.h>

namespace fdn {

// Threads (= bins) per block of K1-K3.  Four warps: the per-block sums of
// the gradient kernels take warp_sums in each warp and one pass over
// kThreads / 32 partial rows in shared memory.
constexpr int kThreads = 128;
constexpr int kMaxN = 16;

// Per-block partials row: U_bar (N*N), b_bar (N), c_bar (N), loss (1).
__host__ __device__ constexpr int n_partials(int N) { return N * N + 2 * N + 1; }

__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
}

__device__ __forceinline__ float2 csub(float2 x, float2 y) {
  return make_float2(x.x - y.x, x.y - y.y);
}

__device__ __forceinline__ float cabs2(float2 x) { return x.x * x.x + x.y * x.y; }

// conj(y) / |y|^2: one reciprocal per pivot, shared by the rows below it
__device__ __forceinline__ float2 crecip(float2 y) {
  const float inv = 1.0f / (y.x * y.x + y.y * y.y);
  return make_float2(y.x * inv, -y.y * inv);
}

__device__ __forceinline__ float2 cdiv(float2 x, float2 y) {
  const float inv = 1.0f / (y.x * y.x + y.y * y.y);
  return make_float2((x.x * y.x + x.y * y.y) * inv, (x.y * y.x - x.x * y.y) * inv);
}

__device__ __forceinline__ float2 csel(bool m, float2 a, float2 b) { return m ? a : b; }

__device__ __forceinline__ float2 load_or_zero(const float2* __restrict__ p, bool live) {
  return live ? p[0] : make_float2(0.0f, 0.0f);
}

// A bin's row of N complex values, moved as float4s where N is even (the
// row must then start on 16 bytes; the wrappers hand such rows in), else
// as float2s; a masked lane (live false) reads zeros.
template <int N>
__device__ __forceinline__ void load_row(const float2* __restrict__ p, bool live,
                                         float2 (&v)[N]) {
  if constexpr (N % 2 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float4 q = live ? p4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[2 * i] = make_float2(q.x, q.y);
      v[2 * i + 1] = make_float2(q.z, q.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = load_or_zero(p + i, live);
  }
}

template <int N>
__device__ __forceinline__ void store_row(float2* __restrict__ p, const float2 (&v)[N]) {
  if constexpr (N % 2 == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      p4[i] = make_float4(v[2 * i].x, v[2 * i].y, v[2 * i + 1].x, v[2 * i + 1].y);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// A = I - diag(d) U (rows of U scaled by d_i), or its transpose
// I - U^T diag(d) (A[i][j] = delta_ij - U[j][i] d_j).  U is (N, N) row-major,
// in global memory (read through L1) or, with SHARED, in shared memory.
template <int N, bool TRANSPOSE, bool SHARED = false>
__device__ __forceinline__ void assemble(const float2 (&d)[N], const float* __restrict__ U,
                                         float2 (&A)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int idx = TRANSPOSE ? j * N + i : i * N + j;
      float u;
      if constexpr (SHARED)
        u = U[idx];
      else
        u = __ldg(U + idx);
      const float2 dd = TRANSPOSE ? d[j] : d[i];
      float re = -dd.x * u;
      const float im = -dd.y * u;
      if (i == j) re += 1.0f;
      A[i][j] = make_float2(re, im);
    }
  }
}

// y = A^{-1} b from the upper triangle left in A
template <int N>
__device__ __forceinline__ void back_substitute(const float2 (&A)[N][N], const float2 (&b)[N],
                                                float2 (&y)[N]) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float2 acc = b[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = csub(acc, cmul(A[i][j], y[j]));
    y[i] = cdiv(acc, A[i][i]);
  }
}

// Elimination with select-based partial pivoting; A and b are overwritten.
// Only columns j >= k of a row are copied or swapped at step k: the
// columns left of the pivot are never read again.
template <int N>
__device__ __forceinline__ void ge_pivot(float2 (&A)[N][N], float2 (&b)[N], float2 (&y)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float best = cabs2(A[k][k]);
    int piv = k;
    float2 pa[N];
#pragma unroll
    for (int j = k; j < N; ++j) pa[j] = A[k][j];
    float2 pb = b[k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float cand = cabs2(A[i][k]);
      const bool better = cand > best;
      best = better ? cand : best;
      piv = better ? i : piv;
#pragma unroll
      for (int j = k; j < N; ++j) pa[j] = csel(better, A[i][j], pa[j]);
      pb = csel(better, b[i], pb);
    }
    // the row that gave the pivot receives the old row k
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const bool sw = piv == i;
#pragma unroll
      for (int j = k; j < N; ++j) A[i][j] = csel(sw, A[k][j], A[i][j]);
      b[i] = csel(sw, b[k], b[i]);
    }
#pragma unroll
    for (int j = k; j < N; ++j) A[k][j] = pa[j];
    b[k] = pb;
    const float2 pinv = crecip(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float2 f = cmul(A[i][k], pinv);
#pragma unroll
      for (int j = k + 1; j < N; ++j) A[i][j] = csub(A[i][j], cmul(f, A[k][j]));
      b[i] = csub(b[i], cmul(f, b[k]));
    }
  }
  back_substitute<N>(A, b, y);
}

// ge_pivot with a warp's vote on each exchange.  At step k every lane finds
// its pivot row as ge_pivot does (the first row of largest |a|^2); then,
// for each candidate row i, the warp votes, and the exchange of rows k and
// i runs (as selects) only when a lane of the warp pivots to row i.  Where
// no lane pivots at a step, the step is the elimination alone; where some
// do, only the rows they chose are exchanged, where ge_pivot selects over
// every candidate row twice.  Each lane's values are ge_pivot's.  Every
// lane of the warp must call it (masked lanes on A = I, which never
// pivot).
template <int N>
__device__ __forceinline__ void ge_pivot_voted(float2 (&A)[N][N], float2 (&b)[N],
                                               float2 (&y)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float best = cabs2(A[k][k]);
    int piv = k;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float cand = cabs2(A[i][k]);
      const bool better = cand > best;
      best = better ? cand : best;
      piv = better ? i : piv;
    }
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      if (__any_sync(0xffffffffu, piv == i)) {
        const bool sw = piv == i;
#pragma unroll
        for (int j = k; j < N; ++j) {
          const float2 a = A[k][j];
          A[k][j] = csel(sw, A[i][j], a);
          A[i][j] = csel(sw, a, A[i][j]);
        }
        const float2 bk = b[k];
        b[k] = csel(sw, b[i], bk);
        b[i] = csel(sw, bk, b[i]);
      }
    }
    const float2 pinv = crecip(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float2 f = cmul(A[i][k], pinv);
#pragma unroll
      for (int j = k + 1; j < N; ++j) A[i][j] = csub(A[i][j], cmul(f, A[k][j]));
      b[i] = csub(b[i], cmul(f, b[k]));
    }
  }
  back_substitute<N>(A, b, y);
}

// Elimination WITHOUT pivoting that leaves the factors in A: U in the
// upper triangle (diagonal included), the unit-L multipliers in the
// emptied slots below it.  Valid while the leading pivots stay away from
// zero (stable FDN loops).
template <int N>
__device__ __forceinline__ void ge_nopivot_factors(float2 (&A)[N][N], float2 (&b)[N],
                                                   float2 (&y)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float2 pinv = crecip(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const float2 f = cmul(A[i][k], pinv);
      A[i][k] = f;
#pragma unroll
      for (int j = k + 1; j < N; ++j) A[i][j] = csub(A[i][j], cmul(f, A[k][j]));
      b[i] = csub(b[i], cmul(f, b[k]));
    }
  }
  back_substitute<N>(A, b, y);
}

// (L U)^T w = c from the factors of ge_nopivot_factors: U^T z = c by
// forward substitution, then L^T w = z by back substitution.
template <int N>
__device__ __forceinline__ void transpose_solve_from_factors(const float2 (&A)[N][N],
                                                             const float2 (&c)[N],
                                                             float2 (&w)[N]) {
  float2 z[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float2 acc = c[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = csub(acc, cmul(A[j][i], z[j]));
    z[i] = cdiv(acc, A[i][i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float2 acc = z[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = csub(acc, cmul(A[j][i], w[j]));
    w[i] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One stage of the halving: a lane keeps one half of its V values (the
// lower half where lane & MASK is 0) and sends the other half to
// lane ^ MASK, which sends it the matching half of its own; the kept half
// adds what arrives.  An odd V is padded with a zero.  [base, end) is the
// range of value indices that the lane's slots stand for.
template <int NV, int V, int MASK>
__device__ __forceinline__ void halve(float (&v)[NV], int lane, int& base, int& end) {
  constexpr int H = (V + 1) / 2;
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = i + H < V ? v[i + H] : 0.0f;
    const float send = upper ? lo : hi;
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
  if (upper) {
    base += H;
  } else {
    end = min(end, base + H);
  }
}

__host__ __device__ constexpr int half_up(int v) { return (v + 1) / 2; }

// The warp's sums of NV per-thread values by recursive halving (a
// transpose-reduce): after five stages of halve each lane holds at most
// ceil(NV / 32) of the sums and parks them in the warp's row of red.  At
// N = 6 the 49 values take 51 shuffles and 51 adds, where a shuffle tree
// a value took 245 of each.  Every thread of the block must call it.
template <int NV>
__device__ __forceinline__ void warp_sums(float (&v)[NV], float (*red)[NV]) {
  constexpr int V1 = half_up(NV), V2 = half_up(V1), V3 = half_up(V2), V4 = half_up(V3);
  const int lane = threadIdx.x & 31;
  int base = 0, end = NV;
  halve<NV, NV, 16>(v, lane, base, end);
  halve<NV, V1, 8>(v, lane, base, end);
  halve<NV, V2, 4>(v, lane, base, end);
  halve<NV, V3, 2>(v, lane, base, end);
  halve<NV, V4, 1>(v, lane, base, end);
#pragma unroll
  for (int i = 0; i < half_up(V4); ++i) {
    if (base + i < end) red[threadIdx.x >> 5][base + i] = v[i];
  }
}

// After warp_sums: add the warps' sums into this block's row.
template <int NV>
__device__ __forceinline__ void block_store(float (*red)[NV], float* __restrict__ row) {
  __syncthreads();
  for (int v = threadIdx.x; v < NV; v += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][v];
    row[v] = s;
  }
}

// Cotangents shared by the two gradient kernels, in JAX's convention
// (tb = dL/dRe tf - i dL/dIm tf), given w = A^{-T} c and y = A^{-1} diag(d) b:
//   D_bar_i  = (tb w_i) ((U y)_i + b_i)            per bin (WITH_DBAR)
//   U_bar_ij = Re sum_m tb w_i d_i y_j              block partial
//   b_bar_i  = Re sum_m tb w_i d_i                  block partial
//   c_bar_i  = Re sum_m tb y_i                      block partial
// followed by the loss partial; the block's sums of the row go to its
// partials row.  U and b are read through L1 and D_bar is stored a float2
// a channel (K1); with SHARED, U and b are read from shared memory and
// D_bar is stored as one row after the loop (store_row: float4s where N
// is even, so dbar_row must start on 16 bytes; K3b hands in its row of
// the warp's span in shared memory there).
template <int N, bool WITH_DBAR, bool SHARED = false>
__device__ __forceinline__ void cotangents(const float2 (&d)[N], const float* __restrict__ U,
                                           const float* __restrict__ b, const float2 (&y)[N],
                                           const float2 (&w)[N], float2 tb, float loss,
                                           bool live, float2* __restrict__ dbar_row,
                                           float (*red)[n_partials(N)],
                                           float* __restrict__ partials_row) {
  constexpr int NV = n_partials(N);
  float v[NV];
  float2 dbar[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float2 bb = cmul(tb, w[i]);
    if (WITH_DBAR) {
      float ur = 0.0f, ui = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float u = SHARED ? U[i * N + j] : __ldg(U + i * N + j);
        ur += u * y[j].x;
        ui += u * y[j].y;
      }
      const float bi = SHARED ? b[i] : __ldg(b + i);
      const float2 db = cmul(bb, make_float2(ur + bi, ui));
      if constexpr (SHARED)
        dbar[i] = db;
      else if (live)
        dbar_row[i] = db;
    }
    const float2 bbD = cmul(bb, d[i]);
    v[N * N + i] = bbD.x;
    v[N * N + N + i] = cmul(tb, y[i]).x;
#pragma unroll
    for (int j = 0; j < N; ++j) v[i * N + j] = cmul(bbD, y[j]).x;
  }
  if (WITH_DBAR && SHARED && live) store_row<N>(dbar_row, dbar);
  v[NV - 1] = loss;
  warp_sums<NV>(v, red);
  block_store<NV>(red, partials_row);
}

}  // namespace fdn
