// Candidate designs of K2 (fdn_solve_kernel, the per-bin FDN-loop solve),
// timed by controls/k9_k2_designs/time_designs.py beside the package's and
// the previous library's (controls/fdn_kernels_prev): one thread a bin,
// every one's values and pivots equal to ge_pivot's bit for bit.
// fdn_solve_design_kernel<N, TRANSPOSE, PIV, SHARED_U, VEC, THREADS>:
//   PIV 0: ge_pivot, its selects and swaps at every step;
//   PIV 1: ge_pivot's selects at the steps where a lane of the warp
//          pivots (one vote a step);
//   PIV 2: ge_pivot_voted, a vote a candidate row: the swap of row k with
//          row i runs where a lane of the warp pivots to row i (N - 1 - k
//          votes a step);
//   SHARED_U: U staged in shared memory once a block (else __ldg);
//   VEC: a bin's rows of D, B and Y moved as float4s (else float2s);
//   THREADS: bins a block.
// design -> (PIV, SHARED_U, VEC, THREADS):
//   0: (0, no, no, 128)   the previous kernel's choices, masked lanes kept
//   1: (1, yes, yes, 128)
//   2: (2, yes, yes, 128) the package's kernel
//   3: (1, no, no, 128)
//   4: (0, yes, yes, 128)
//   5: (1, yes, yes, 64)
//   6: (2, yes, yes, 64)
//   7: (2, no, no, 128)
#include <cstddef>

#include "fdn_ge.cuh"

namespace k2d {

using namespace fdn;

// a vote a step: the selects and swaps of ge_pivot at the steps where a
// lane of the warp pivots
template <int N>
__device__ __forceinline__ void ge_pivot_stepvote(float2 (&A)[N][N], float2 (&b)[N],
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
    if (k + 1 < N && __any_sync(0xffffffffu, piv != k)) {
      float2 pa[N];
#pragma unroll
      for (int j = k; j < N; ++j) pa[j] = A[k][j];
      float2 pb = b[k];
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        const bool sel = piv == i;
#pragma unroll
        for (int j = k; j < N; ++j) pa[j] = csel(sel, A[i][j], pa[j]);
        pb = csel(sel, b[i], pb);
      }
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

__device__ __forceinline__ float2 load_or_zero(const float2* __restrict__ p, bool live) {
  return live ? p[0] : make_float2(0.0f, 0.0f);
}

template <int N, bool VEC>
__device__ __forceinline__ void load_row(const float2* __restrict__ p, bool live,
                                         float2 (&v)[N]) {
  if constexpr (VEC && N % 2 == 0) {
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

template <int N, bool VEC>
__device__ __forceinline__ void store_row(float2* __restrict__ p, const float2 (&v)[N]) {
  if constexpr (VEC && N % 2 == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      p4[i] = make_float4(v[2 * i].x, v[2 * i].y, v[2 * i + 1].x, v[2 * i + 1].y);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N, bool TRANSPOSE, int PIV, bool SHARED_U, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
    fdn_solve_design_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                            const float2* __restrict__ B, float2* __restrict__ Y, int M) {
  __shared__ float sU[N * N];
  if constexpr (SHARED_U) {
    for (int v = threadIdx.x; v < N * N; v += THREADS) sU[v] = __ldg(U + v);
  }
  const int m = blockIdx.x * THREADS + threadIdx.x;
  const bool live = m < M;
  const size_t row = static_cast<size_t>(live ? m : 0) * N;
  float2 d[N], rhs[N], y[N];
  load_row<N, VEC>(D + row, live, d);
  load_row<N, VEC>(B + row, live, rhs);
  float2 A[N][N];
  if constexpr (SHARED_U) {
    __syncthreads();
    assemble<N, TRANSPOSE, true>(d, sU, A);
  } else {
    assemble<N, TRANSPOSE>(d, U, A);
  }
  if constexpr (PIV == 0)
    ge_pivot<N>(A, rhs, y);
  else if constexpr (PIV == 1)
    ge_pivot_stepvote<N>(A, rhs, y);
  else
    ge_pivot_voted<N>(A, rhs, y);
  if (live) store_row<N, VEC>(Y + row, y);
}

template <bool TR, int PIV, bool SU, bool VEC, int THREADS>
int launch(const void* D, const void* U, const void* B, void* Y, int M, cudaStream_t s) {
  fdn_solve_design_kernel<FDN_N, TR, PIV, SU, VEC, THREADS>
      <<<(M + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          static_cast<const float2*>(D), static_cast<const float*>(U),
          static_cast<const float2*>(B), static_cast<float2*>(Y), M);
  return static_cast<int>(cudaGetLastError());
}

template <bool TR>
int launch_design(int design, const void* D, const void* U, const void* B, void* Y, int M,
                  cudaStream_t s) {
  switch (design) {
    case 0: return launch<TR, 0, false, false, 128>(D, U, B, Y, M, s);
    case 1: return launch<TR, 1, true, true, 128>(D, U, B, Y, M, s);
    case 2: return launch<TR, 2, true, true, 128>(D, U, B, Y, M, s);
    case 3: return launch<TR, 1, false, false, 128>(D, U, B, Y, M, s);
    case 4: return launch<TR, 0, true, true, 128>(D, U, B, Y, M, s);
    case 5: return launch<TR, 1, true, true, 64>(D, U, B, Y, M, s);
    case 6: return launch<TR, 2, true, true, 64>(D, U, B, Y, M, s);
    case 7: return launch<TR, 2, false, false, 128>(D, U, B, Y, M, s);
    default: return -2;
  }
}

}  // namespace k2d

#ifndef FDN_N
#error "compile with -DFDN_N=<channel count>"
#endif

extern "C" {

int fdn_solve_design_launch(int design, int N, int transpose, const void* D, const void* U,
                            const void* B, void* Y, int M, void* stream) {
  if (N != FDN_N) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  return transpose ? k2d::launch_design<true>(design, D, U, B, Y, M, s)
                   : k2d::launch_design<false>(design, D, U, B, Y, M, s);
}

}  // extern "C"
