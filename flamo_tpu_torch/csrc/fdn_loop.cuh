// The looped per-bin elimination core of fdn_loop.cu: one WARP a bin, the
// channel count N a run-time value, for the N > 16 that the unrolled core
// of fdn_ge.cuh (one thread a bin, the N x N matrix in registers, one
// library a channel count) cannot hold: from N = 10 its matrix spills.
//
// Counterpart of the same elimination in flamo_tpu/ops/pallas_solve.py
// (_ge_core, _ge_core_nopivot_factors, _transpose_solve_from_factors),
// which unrolls over N at trace time, and of flamo_tpu/ops/solve.py's
// gauss_solve_loop, the JAX package's rolled elimination for large N.
//
// A bin's N x N complex system lies in shared memory, row r at A + r S with
// the odd row stride S = N | 1 (float2s): 32 lanes each on its own row,
// at one column, touch 32 different bank pairs, so walking a column (the
// pivot search, the row updates) is free of bank conflicts; a row walked
// by the lanes is contiguous.  Lane l owns rows l, l + 32, ...: it finds
// its rows' best pivot candidate, the warp takes the arg-max by shuffles,
// and each lane updates its own rows.  Every value is computed with
// fdn_ge.cuh's cmul/csub/crecip/cdiv, and the pivot rule is the same: the
// strictly larger |a|^2 wins, so the first row of largest magnitude is the
// pivot.  Each entry of the eliminated matrix sees the unrolled core's
// operations in the same order (where nvcc contracts the same multiply-
// adds, the same bits); the substitutions run column by column (a lane a
// row, after each solved unknown), so the back substitution subtracts its
// terms in the opposite order and rounds apart from the unrolled core's.
//
// Every function is called by all 32 lanes of the warp with the same
// arguments, and ends with __syncwarp(), after which the warp's writes to
// shared memory are visible to all its lanes.
#pragma once

#include "fdn_ge.cuh"

namespace fdn {
namespace loop {

constexpr unsigned kFull = 0xffffffffu;

// the padded row stride (float2s, or floats for a staged U): odd
__host__ __device__ inline int stride(int N) { return N | 1; }

// Swap rows k and piv (columns k..N-1; the columns left of k are never
// read again) and their right-hand sides, piv the first row i >= k of
// largest |A[i][k]|^2.
__device__ __forceinline__ void pivot_rows(float2* A, float2* b, int N, int S, int k, int lane) {
  float best = -1.0f;
  int piv = N;
  for (int i = k + lane; i < N; i += 32) {
    const float v = cabs2(A[i * S + k]);
    if (v > best) {
      best = v;
      piv = i;
    }
  }
  // arg-max over the lanes: the larger value, on a tie the lower row;
  // the butterfly leaves every lane with the same (best, piv)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, piv, o);
    if (ov > best || (ov == best && oi < piv)) {
      best = ov;
      piv = oi;
    }
  }
  if (piv != k) {  // the same on every lane
    float2* rk = A + k * S;
    float2* rp = A + piv * S;
    for (int j = k + lane; j < N; j += 32) {
      const float2 a = rk[j];
      rk[j] = rp[j];
      rp[j] = a;
    }
    if (lane == 0) {
      const float2 a = b[k];
      b[k] = b[piv];
      b[piv] = a;
    }
  }
  __syncwarp();
}

// Step k of the elimination: rows k+1..N-1 minus their multiple of row k.
// With FACTORS the multipliers are kept in the emptied slots A[i][k] (the
// unit-L factor below the diagonal, U on and above it).
template <bool FACTORS>
__device__ __forceinline__ void eliminate_step(float2* A, float2* b, int N, int S, int k,
                                               int lane) {
  const float2* rk = A + k * S;
  const float2 pinv = crecip(rk[k]);
  const float2 bk = b[k];
  for (int i = k + 1 + lane; i < N; i += 32) {
    float2* ri = A + i * S;
    const float2 f = cmul(ri[k], pinv);
    if (FACTORS) ri[k] = f;
    for (int j = k + 1; j < N; ++j) ri[j] = csub(ri[j], cmul(f, rk[j]));
    b[i] = csub(b[i], cmul(f, bk));
  }
  __syncwarp();
}

// The elimination of A y = b, pivoted or (PIVOT false) keeping its
// factors; b is overwritten.
template <bool PIVOT>
__device__ __forceinline__ void eliminate(float2* A, float2* b, int N, int S, int lane) {
  for (int k = 0; k < N; ++k) {
    if (PIVOT) pivot_rows(A, b, N, S, k, lane);
    eliminate_step<!PIVOT>(A, b, N, S, k, lane);
  }
}

// y = A^{-1} b from the upper triangle left in A, column by column: once
// y_i is known every row above it subtracts its term.  b is overwritten.
__device__ __forceinline__ void back_substitute(const float2* A, float2* b, float2* y, int N,
                                                int S, int lane) {
  for (int i = N - 1; i >= 0; --i) {
    const float2 yi = cdiv(b[i], A[i * S + i]);
    if (lane == 0) y[i] = yi;
    for (int r = lane; r < i; r += 32) b[r] = csub(b[r], cmul(A[r * S + i], yi));
    __syncwarp();
  }
}

// (L U)^T w = c from the factors that eliminate<false> leaves in A: U^T z =
// c by forward substitution (the unrolled core's order), z in w, then
// L^T w = z backward, in place.  c is overwritten.
__device__ __forceinline__ void transpose_solve_from_factors(const float2* A, float2* c,
                                                             float2* w, int N, int S,
                                                             int lane) {
  for (int i = 0; i < N; ++i) {
    const float2 zi = cdiv(c[i], A[i * S + i]);
    if (lane == 0) w[i] = zi;
    const float2* ri = A + i * S;
    for (int r = i + 1 + lane; r < N; r += 32) c[r] = csub(c[r], cmul(ri[r], zi));
    __syncwarp();
  }
  for (int i = N - 1; i > 0; --i) {
    const float2 wi = w[i];
    const float2* ri = A + i * S;
    for (int r = lane; r < i; r += 32) w[r] = csub(w[r], cmul(ri[r], wi));
    __syncwarp();
  }
}

// A = I - diag(d) U, or its transpose I - U^T diag(d), from U staged with
// row stride SU (as fdn_ge.cuh's assemble).
template <bool TRANSPOSE>
__device__ __forceinline__ void assemble(float2* A, const float2* d, const float* sU, int N,
                                         int S, int SU, int lane) {
  for (int i = 0; i < N; ++i) {
    for (int j = lane; j < N; j += 32) {
      const float u = TRANSPOSE ? sU[j * SU + i] : sU[i * SU + j];
      const float2 dd = TRANSPOSE ? d[j] : d[i];
      float re = -dd.x * u;
      const float im = -dd.y * u;
      if (i == j) re += 1.0f;
      A[i * S + j] = make_float2(re, im);
    }
  }
  __syncwarp();
}

// JAX's cotangent tb of tf in scale (|tf X| - t)^2 (scale = 2 / M for the
// mean), and diff = |tf X| - t; a safe divide where |tf X| = 0.
__device__ __forceinline__ float2 mse_cotangent(float2 tf, float2 x, float tt, float scale,
                                                float& diff) {
  const float zr = tf.x * x.x - tf.y * x.y;
  const float zi = tf.x * x.y + tf.y * x.x;
  const float a = sqrtf(zr * zr + zi * zi);
  diff = a - tt;
  const float g = scale * diff / (a > 0.0f ? a : 1.0f);
  const float dzr = g * zr;
  const float dzi = g * zi;
  return make_float2(dzr * x.x + dzi * x.y, dzr * x.y - dzi * x.x);
}

// sum_p c[p stride] z^p by Horner, from the highest tap down (the unrolled
// K5's horner_s on taps kept in their global layout)
__device__ __forceinline__ float2 horner(const float* c, int P, int step, float2 z) {
  float2 out = make_float2(c[(P - 1) * step], 0.0f);
  for (int p = P - 2; p >= 0; --p) {
    out = cmul(out, z);
    out.x += c[p * step];
  }
  return out;
}

// U (N x N, row-major in global memory) staged by the whole block with row
// stride SU; the caller synchronises the block.
__device__ __forceinline__ void stage_u(const float* __restrict__ U, float* sU, int N, int SU) {
  for (int v = threadIdx.x; v < N * N; v += blockDim.x) sU[(v / N) * SU + v % N] = __ldg(U + v);
}

// U (as stage_u), b and c staged by the whole block; the caller
// synchronises the block.
__device__ __forceinline__ void stage_ubc(const float* __restrict__ U, const float* __restrict__ b,
                                          const float* __restrict__ c, float* sU, float* sb,
                                          float* sc, int N, int S) {
  stage_u(U, sU, N, S);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sb[i] = __ldg(b + i);
    sc[i] = __ldg(c + i);
  }
}

// tf = c^T y: each lane's rows in order, then a butterfly, which leaves
// the same sum on every lane.
__device__ __forceinline__ float2 project(const float* sc, const float2* y, int N, int lane) {
  float2 tf = make_float2(0.0f, 0.0f);
  for (int i = lane; i < N; i += 32) {
    tf.x += sc[i] * y[i].x;
    tf.y += sc[i] * y[i].y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tf.x += __shfl_xor_sync(kFull, tf.x, o);
    tf.y += __shfl_xor_sync(kFull, tf.y, o);
  }
  return tf;
}

}  // namespace loop
}  // namespace fdn
