// Hand-written Hopper (sm_90a) kernels of the per-bin solves for any
// channel count N, N a run-time argument: one library for every N (built
// as N = 1, with fdn_reg.cu linked in), with a plain C interface that
// flamo_tpu_torch/ops/fdn_kernels.py and ops/sos_kernels.py load through
// ctypes.  The wrappers there take the unrolled kernels of fdn_kernels.cu
// and sos_kernels.cu (one library a channel count, 1..16) up to 16
// channels and these above, but for K2, K3f, K3b and K5 from 17 to 64
// channels, which go to fdn_reg.cu's register-resident kernels (its own
// entry points fl_reg_*): here K1 and K6 run at every N > 16, and K2,
// K3f, K3b and K5 from 65 channels up (and wherever fdn_reg.cu's block
// does not fit).  Every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError(), or kBadSize for
// sizes it does not take.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py;
// there the elimination is unrolled over N at trace time, for any N):
//   ge_loop_solve_kernel      (K2 looped)  <- _fdn_kernel,             pallas_call at :277
//   ge_loop_dense_kernel      (K6 looped)  <- _solve_kernel,           pallas_call at :161
//   ge_loop_tf_mse_kernel     (K1 looped)  <- _fdn_tf_mse_kernel,      pallas_call at :719
//   ge_loop_tf_fwd_kernel     (K3f looped) <- _fdn_tf_kernel,          pallas_call at :451
//   ge_loop_tf_bwd_kernel     (K3b looped) <- _fdn_tf_bwd_kernel,      pallas_call at :474
//   ge_loop_sos_tf_mse_kernel (K5 looped)  <- _fdn_sos_tf_mse_kernel,  pallas_call at :1376
// Each computes the same function as its unrolled counterpart in
// fdn_kernels.cu or sos_kernels.cu, with the same layouts, and the same
// pivot rule.
//
// Design (fdn_loop.cuh): one warp a bin, the bin's N x N complex system in
// shared memory with an odd row stride, a lane a row.  Blocks hold W warps
// (loop_warps: as many as fit 227 KB, at most 8) and walk the bins with a
// grid stride, W bins at a time; the grid is at most the blocks that are
// resident on the card at once.  Each warp owns its slice of the block's
// dynamic shared memory: the system, its vectors and, in K1, K3b and K5,
// its sums.  U, b and c (and K5's taps) are staged once a block.
//
// What bounds them on an H100: arithmetic, as the unrolled kernels.
// Pivoted elimination of one right-hand side is ~(2/3) N^3 complex
// multiply-adds, 8 FP32 operations each: at M = 48001 bins that is ~8.4
// GFLOP at N = 32 (~0.13 ms at 67 TFLOP/s) and ~67 GFLOP at N = 64 (~1.0
// ms), against 25-50 MB of D, B and Y (~0.01 ms at 3.35 TB/s); K6's dense A
// at N = 64 is 1.57 GB (~0.47 ms), still below its operations.  K5 adds
// each channel's cascade (2 K Horners of P taps) and, with its tap sums,
// 2 K quotients and P powers a channel: ~50 kFLOP a bin at N = 64, K = 12,
// P = 3, against ~0.7 MFLOP of elimination.  This first design keeps every
// operand in shared memory and is bound by its latency: a lane's update of
// a row reads and writes shared memory for each entry, and with 4-8 warps
// an SM at N = 64 little hides it.  Its times against the bound are in
// PERF.md.
//
// The sums over bins of K1, K3b and K5 (U_bar with N^2 values, b_bar and
// c_bar with N each, K1's and K5's loss, K5's 2 P K N tap sums) cannot
// keep the unrolled kernels' one partials row a block of 128 bins (~200
// MB at N = 64, M = 48001): each warp adds its bins' values into its own
// sums in shared memory (a value always on the same lane, so no atomics
// and a fixed order), and at the end each block adds its warps' sums in
// warp order into its one partials row, which the wrapper sums with
// torch.sum.  For a given card and grid the result is the same on every
// launch.
//
// K5's cascade: lane l computes the guarded cascade Gam_n of its channels
// n = l, l + 32, ... from the taps staged in their global (part, p, k, n)
// layout (consecutive lanes on consecutive channels, no bank conflicts),
// with sos_common.cuh's phasor and pow2_scale rescaling (the unrolled K5's
// arithmetic), and after the solves the tap sums of the same channels,
// t_n = Gam_bar_n Gam_n against each section's response, into the warp's
// tap sums in the partials row's order; without fused taps it writes the
// masked Gam_bar rows for K4b (sos_cascade.cu).

#include <cfloat>
#include <cstddef>

#include "fdn_loop.cuh"
#include "sos_common.cuh"

namespace fdn {
namespace loop {

constexpr int kBadSize = -2;
constexpr int kMaxWarps = 8;
// the dynamic shared memory a block may opt in to on sm_90 (227 KB)
constexpr int kSmemLimit = 232448;

enum Kind { kSolve = 0, kDense = 1, kTfMse = 2, kTfFwd = 3, kTfBwd = 4 };
constexpr int kMaxP = sos::kMaxP;
constexpr int kMaxK = sos::kMaxK;

__host__ __device__ inline int even(int n) { return n + (n & 1); }

// floats of the block-wide part of shared memory: U (K2, K1, K3f, K3b)
// and b, c (K1, K3f, K3b)
__host__ __device__ inline int common_floats(int kind, int N) {
  if (kind == kDense) return 0;
  return even(N * stride(N) + (kind == kSolve ? 0 : 2 * N));
}

// float2s of a warp's system and vectors: d, rhs, y (K2, K3f); rhs, y
// (K6); d, rhs, y, w (K1, K3b)
__host__ __device__ inline int warp_float2s(int kind, int N) {
  const int vecs = kind == kSolve || kind == kTfFwd ? 3 : kind == kDense ? 2 : 4;
  return N * stride(N) + vecs * N;
}

// floats of a warp's sums (K1, K3b): U_bar, b_bar, c_bar, loss (K3b's 0)
__host__ __device__ inline int warp_sum_floats(int kind, int N) {
  return kind == kTfMse || kind == kTfBwd ? n_partials(N) : 0;
}

inline size_t smem_bytes(int kind, int N, int warps) {
  return 4 * static_cast<size_t>(common_floats(kind, N)) +
         static_cast<size_t>(warps) *
             (8 * static_cast<size_t>(warp_float2s(kind, N)) + 4 * warp_sum_floats(kind, N));
}

// warps a block: as many as fit kSmemLimit, at most kMaxWarps; 0 when not
// even one bin fits
inline int loop_warps(int kind, int N) {
  int w = 0;
  while (w < kMaxWarps && smem_bytes(kind, N, w + 1) <= static_cast<size_t>(kSmemLimit)) ++w;
  return w;
}

// ---------------------------------------------------------------------------
// K5 looped's shared memory: once a block U, b, c and the 2 P K N taps;
// each warp its system, its vectors d, dp = d Gam, Gam, rhs, y, w and the
// guard flags (N floats, in ceil(N / 2) float2s), and its sums: the
// N^2 + 2N + 1 head values and, with fused taps, the 2 P K N tap sums.
// ---------------------------------------------------------------------------
__host__ __device__ inline int sos_common_floats(int N, int K, int P) {
  return even(N * stride(N) + 2 * N + 2 * P * K * N);
}

__host__ __device__ inline int sos_warp_float2s(int N) {
  return N * stride(N) + 6 * N + (N + 1) / 2;
}

__host__ __device__ inline int sos_sum_floats(int N, int K, int P, bool fuse_taps) {
  return n_partials(N) + (fuse_taps ? 2 * P * K * N : 0);
}

inline size_t sos_smem_bytes(int N, int K, int P, bool fuse_taps, int warps) {
  return 4 * static_cast<size_t>(sos_common_floats(N, K, P)) +
         static_cast<size_t>(warps) * (8 * static_cast<size_t>(sos_warp_float2s(N)) +
                                       4 * static_cast<size_t>(sos_sum_floats(N, K, P, fuse_taps)));
}

inline int sos_warps(int N, int K, int P, bool fuse_taps) {
  int w = 0;
  while (w < kMaxWarps &&
         sos_smem_bytes(N, K, P, fuse_taps, w + 1) <= static_cast<size_t>(kSmemLimit))
    ++w;
  return w;
}

// One bin's cotangents (fdn_ge.cuh's cotangents, a lane a row), given
// y = A^{-1} diag(d) b, w = A^{-T} c and tb: D_bar_i = tb w_i ((U y)_i +
// b_i) into dbar_row (WITH_DBAR), and added into the warp's sums
// [U_bar, b_bar, c_bar]: Re(tb w_i d_i y_j), Re(tb w_i d_i), Re(tb y_i).
// rhs is overwritten (tb w_i d_i parked for U_bar).
template <bool WITH_DBAR>
__device__ __forceinline__ void add_cotangents(const float2* d, const float* sU, const float* sb,
                                               const float2* y, const float2* w, float2 tb,
                                               float2* rhs, float2* __restrict__ dbar_row,
                                               float* sums, int N, int S, int lane) {
  float* Ubar = sums;
  float* bbar = sums + N * N;
  float* cbar = bbar + N;
  for (int i = lane; i < N; i += 32) {
    const float2 bb = cmul(tb, w[i]);
    if (WITH_DBAR) {
      float ur = 0.0f, ui = 0.0f;
      for (int j = 0; j < N; ++j) {
        const float u = sU[i * S + j];
        ur += u * y[j].x;
        ui += u * y[j].y;
      }
      dbar_row[i] = cmul(bb, make_float2(ur + sb[i], ui));
    }
    const float2 bbD = cmul(bb, d[i]);
    rhs[i] = bbD;
    bbar[i] += bbD.x;
    cbar[i] += cmul(tb, y[i]).x;
  }
  __syncwarp();
  for (int i = 0; i < N; ++i) {
    const float2 bbD = rhs[i];
    for (int j = lane; j < N; j += 32) Ubar[i * N + j] += cmul(bbD, y[j]).x;
  }
  __syncwarp();
}

// The block's partials row: its W warps' NV sums (from sums0, warp after
// warp) added in warp order.  Every thread of the block calls it.
__device__ __forceinline__ void fold_sums(const float* sums0, int W, int NV,
                                          float* __restrict__ out) {
  __syncthreads();
  for (int v = threadIdx.x; v < NV; v += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < W; ++q) s += sums0[static_cast<size_t>(q) * NV + v];
    out[v] = s;
  }
}

// K2 looped: (I - diag(D_m) U) y_m = B_m, or with TRANSPOSE the transposed
// system that its gradient needs.  D, B, Y (M, N) complex, U (N, N).
template <bool TRANSPOSE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ge_loop_solve_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                         const float2* __restrict__ B, float2* __restrict__ Y, int N, int M) {
  extern __shared__ float4 smem[];
  const int S = stride(N), W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  float* sU = reinterpret_cast<float*>(smem);
  float2* A = reinterpret_cast<float2*>(sU + common_floats(kSolve, N)) +
              static_cast<size_t>(warp) * warp_float2s(kSolve, N);
  float2* d = A + N * S;
  float2* rhs = d + N;
  float2* y = rhs + N;
  stage_u(U, sU, N, S);
  __syncthreads();
  for (int m = blockIdx.x * W + warp; m < M; m += gridDim.x * W) {
    const size_t row = static_cast<size_t>(m) * N;
    for (int j = lane; j < N; j += 32) {
      d[j] = D[row + j];
      rhs[j] = B[row + j];
    }
    __syncwarp();
    assemble<TRANSPOSE>(A, d, sU, N, S, S, lane);
    eliminate<true>(A, rhs, N, S, lane);
    back_substitute(A, rhs, y, N, S, lane);
    for (int j = lane; j < N; j += 32) Y[row + j] = y[j];
    __syncwarp();
  }
}

// K6 looped: A_m y_m = B_m for a dense complex N x N matrix per row m, or
// with TRANSPOSE A_m^T y_m = B_m: the warp reads A's row-major entries in
// order and writes entry (p, q) to (q, p) of its system, so A^T is never
// stored.
template <bool TRANSPOSE>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ge_loop_dense_kernel(const float2* __restrict__ Am, const float2* __restrict__ B,
                         float2* __restrict__ Y, int N, int M) {
  extern __shared__ float4 smem[];
  const int S = stride(N), W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  float2* A = reinterpret_cast<float2*>(smem) + static_cast<size_t>(warp) * warp_float2s(kDense, N);
  float2* rhs = A + N * S;
  float2* y = rhs + N;
  for (int m = blockIdx.x * W + warp; m < M; m += gridDim.x * W) {
    const float2* __restrict__ a = Am + static_cast<size_t>(m) * N * N;
    for (int e = lane; e < N * N; e += 32) {
      const int p = e / N, q = e - p * N;
      A[TRANSPOSE ? q * S + p : p * S + q] = __ldg(a + e);
    }
    const size_t row = static_cast<size_t>(m) * N;
    for (int j = lane; j < N; j += 32) rhs[j] = __ldg(B + row + j);
    __syncwarp();
    eliminate<true>(A, rhs, N, S, lane);
    back_substitute(A, rhs, y, N, S, lane);
    for (int j = lane; j < N; j += 32) Y[row + j] = y[j];
    __syncwarp();
  }
}

// K1 looped: loss and cotangents of L = (1/M) sum_m (|tf_m X_m| - t_m)^2 in
// one pass, tf_m = c^T y_m, y_m = (I - diag(D_m) U)^{-1} diag(D_m) b, as
// fdn_kernels.cu's fdn_tf_mse_kernel: PIVOT eliminates the adjoint system
// A^T w = c anew, pivoted; without it both solves run unpivoted, the
// adjoint from the forward factors.  scale = 2 / M.  Cotangents in JAX's
// convention (fdn_ge.cuh's cotangents): D_bar per bin (WITH_DBAR), and the
// block's row of partials [U_bar, b_bar, c_bar, sum of (|tf X| - t)^2].
template <bool PIVOT, bool WITH_DBAR>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ge_loop_tf_mse_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                          const float* __restrict__ b, const float* __restrict__ c,
                          const float2* __restrict__ X, const float* __restrict__ t,
                          float2* __restrict__ Dbar, float* __restrict__ partials, float scale,
                          int N, int M) {
  extern __shared__ float4 smem[];
  const int S = stride(N), W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int NV = n_partials(N);
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + N * S;
  float* sc = sb + N;
  float2* A = reinterpret_cast<float2*>(sU + common_floats(kTfMse, N)) +
              static_cast<size_t>(warp) * warp_float2s(kTfMse, N);
  float2* d = A + N * S;
  float2* rhs = d + N;
  float2* y = rhs + N;
  float2* w = y + N;
  float* sums0 = reinterpret_cast<float*>(reinterpret_cast<float2*>(sU + common_floats(kTfMse, N)) +
                                          static_cast<size_t>(W) * warp_float2s(kTfMse, N));
  float* sums = sums0 + static_cast<size_t>(warp) * NV;
  stage_ubc(U, b, c, sU, sb, sc, N, S);
  for (int v = lane; v < NV; v += 32) sums[v] = 0.0f;
  __syncthreads();
  float loss = 0.0f;  // lane 0's
  for (int m = blockIdx.x * W + warp; m < M; m += gridDim.x * W) {
    const size_t row = static_cast<size_t>(m) * N;
    for (int j = lane; j < N; j += 32) {
      const float2 dj = D[row + j];
      d[j] = dj;
      rhs[j] = make_float2(dj.x * sb[j], dj.y * sb[j]);
    }
    __syncwarp();
    assemble<false>(A, d, sU, N, S, S, lane);
    eliminate<PIVOT>(A, rhs, N, S, lane);
    back_substitute(A, rhs, y, N, S, lane);
    float diff;
    const float2 tb = mse_cotangent(project(sc, y, N, lane), X[m], t[m], scale, diff);
    // w = A^{-T} c
    for (int j = lane; j < N; j += 32) rhs[j] = make_float2(sc[j], 0.0f);
    __syncwarp();
    if (PIVOT) {
      assemble<true>(A, d, sU, N, S, S, lane);
      eliminate<true>(A, rhs, N, S, lane);
      back_substitute(A, rhs, w, N, S, lane);
    } else {
      transpose_solve_from_factors(A, rhs, w, N, S, lane);
    }
    add_cotangents<WITH_DBAR>(d, sU, sb, y, w, tb, rhs, WITH_DBAR ? Dbar + row : nullptr,
                              sums, N, S, lane);
    loss += diff * diff;
  }
  if (lane == 0) sums[NV - 1] = loss;
  fold_sums(sums0, W, NV, partials + static_cast<size_t>(blockIdx.x) * NV);
}

// K3f looped: tf_m = c^T y_m, y_m = (I - diag(D_m) U)^{-1} diag(D_m) b,
// pivoted, as fdn_kernels.cu's fdn_tf_fwd_kernel; y is stored for the
// backward.  TF (M,), Y (M, N) complex.
__global__ void __launch_bounds__(kMaxWarps * 32)
    ge_loop_tf_fwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                          const float* __restrict__ b, const float* __restrict__ c,
                          float2* __restrict__ TF, float2* __restrict__ Y, int N, int M) {
  extern __shared__ float4 smem[];
  const int S = stride(N), W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + N * S;
  float* sc = sb + N;
  float2* A = reinterpret_cast<float2*>(sU + common_floats(kTfFwd, N)) +
              static_cast<size_t>(warp) * warp_float2s(kTfFwd, N);
  float2* d = A + N * S;
  float2* rhs = d + N;
  float2* y = rhs + N;
  stage_ubc(U, b, c, sU, sb, sc, N, S);
  __syncthreads();
  for (int m = blockIdx.x * W + warp; m < M; m += gridDim.x * W) {
    const size_t row = static_cast<size_t>(m) * N;
    for (int j = lane; j < N; j += 32) {
      const float2 dj = D[row + j];
      d[j] = dj;
      rhs[j] = make_float2(dj.x * sb[j], dj.y * sb[j]);
    }
    __syncwarp();
    assemble<false>(A, d, sU, N, S, S, lane);
    eliminate<true>(A, rhs, N, S, lane);
    back_substitute(A, rhs, y, N, S, lane);
    const float2 tf = project(sc, y, N, lane);
    for (int j = lane; j < N; j += 32) Y[row + j] = y[j];
    if (lane == 0) TF[m] = tf;
    __syncwarp();
  }
}

// K3b looped: one adjoint elimination w_m = A_m^{-T} c a bin, pivoted, then
// the cotangents of tf (fdn_kernels.cu's fdn_tf_bwd_kernel, through K1
// looped's add_cotangents): D_bar per bin, and the block's row of
// partials [U_bar, b_bar, c_bar, 0].  TFB (M,) is JAX's cotangent of tf.
__global__ void __launch_bounds__(kMaxWarps * 32)
    ge_loop_tf_bwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                          const float* __restrict__ b, const float* __restrict__ c,
                          const float2* __restrict__ Y, const float2* __restrict__ TFB,
                          float2* __restrict__ Dbar, float* __restrict__ partials, int N,
                          int M) {
  extern __shared__ float4 smem[];
  const int S = stride(N), W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int NV = n_partials(N);
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + N * S;
  float* sc = sb + N;
  float2* A = reinterpret_cast<float2*>(sU + common_floats(kTfBwd, N)) +
              static_cast<size_t>(warp) * warp_float2s(kTfBwd, N);
  float2* d = A + N * S;
  float2* rhs = d + N;
  float2* y = rhs + N;
  float2* w = y + N;
  float* sums0 = reinterpret_cast<float*>(reinterpret_cast<float2*>(sU + common_floats(kTfBwd, N)) +
                                          static_cast<size_t>(W) * warp_float2s(kTfBwd, N));
  float* sums = sums0 + static_cast<size_t>(warp) * NV;
  stage_ubc(U, b, c, sU, sb, sc, N, S);
  for (int v = lane; v < NV; v += 32) sums[v] = 0.0f;
  __syncthreads();
  for (int m = blockIdx.x * W + warp; m < M; m += gridDim.x * W) {
    const size_t row = static_cast<size_t>(m) * N;
    for (int j = lane; j < N; j += 32) {
      d[j] = D[row + j];
      y[j] = Y[row + j];
      rhs[j] = make_float2(sc[j], 0.0f);
    }
    const float2 tb = TFB[m];
    __syncwarp();
    assemble<true>(A, d, sU, N, S, S, lane);
    eliminate<true>(A, rhs, N, S, lane);
    back_substitute(A, rhs, w, N, S, lane);
    add_cotangents<true>(d, sU, sb, y, w, tb, rhs, Dbar + row, sums, N, S, lane);
  }
  fold_sums(sums0, W, NV, partials + static_cast<size_t>(blockIdx.x) * NV);
}

// K5 looped: the attenuated FDN's step, as sos_kernels.cu's
// fdn_sos_tf_mse_kernel.  At bin m (phasor of m + off) Gam_n is channel n's
// guarded SOS cascade of the taps bt/at (P, K, N), folded into the loop:
//   tf = c^T (I - diag(D Gam) U)^{-1} diag(D) b,  L = (1/M) sum (|tf X| - t)^2,
// with JAX's cotangents (tb of tf, bb_i = tb w_i, w = A^{-T} c):
//   U_bar_ij = Re sum bb_i D_i Gam_i y_j,  b_bar_i = Re sum bb_i D_i,
//   c_bar_i = Re sum tb y_i,  Gam_bar_i = bb_i (U y)_i D_i,
//   D_bar_i = bb_i ((U y)_i Gam_i + b_i)  (WITH_DBAR).
// The block's partials row: [U_bar, b_bar, c_bar, loss] and, with
// FUSE_TAPS, the 2 P K N tap sums ordered (part, p, k, n) from t_n =
// Gam_bar_n Gam_n:
//   b_bar[p,k,n] += Re(t_n / B_kn z^p),  a_bar[p,k,n] -= Re(t_n / A_kn z^p)
// a bin, nothing where |B_kn|^2 or |A_kn|^2 is 0; without, Gbar gets the
// Gam_bar rows (0 where the guard took FLT_EPSILON) for K4b.  PIVOT and
// the adjoint as K1 looped.  scale = 2 / M.
template <bool PIVOT, bool WITH_DBAR, bool FUSE_TAPS>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ge_loop_sos_tf_mse_kernel(const float2* __restrict__ D, const float* __restrict__ bt,
                              const float* __restrict__ at, const float* __restrict__ U,
                              const float* __restrict__ b, const float* __restrict__ c,
                              const float2* __restrict__ X, const float* __restrict__ t,
                              float2* __restrict__ Dbar, float2* __restrict__ Gbar,
                              float* __restrict__ partials, float scale, int N, int M, int K,
                              int P, float w_scale, float off) {
  extern __shared__ float4 smem[];
  const int S = stride(N), W = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int KN = K * N, PKN = P * KN;
  const int NV0 = n_partials(N);
  const int NV = sos_sum_floats(N, K, P, FUSE_TAPS);
  const int WF2 = sos_warp_float2s(N);
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + N * S;
  float* sc = sb + N;
  float* sT = sc + N;  // bt then at, each (P, K, N) as in global memory
  float2* warps0 = reinterpret_cast<float2*>(sU + sos_common_floats(N, K, P));
  float2* A = warps0 + static_cast<size_t>(warp) * WF2;
  float2* d = A + N * S;
  float2* dp = d + N;  // D Gam
  float2* gam = dp + N;
  float2* rhs = gam + N;
  float2* y = rhs + N;
  float2* w = y + N;
  float* ok = reinterpret_cast<float*>(w + N);  // 1 where the guard passed
  float* sums0 = reinterpret_cast<float*>(warps0 + static_cast<size_t>(W) * WF2);
  float* sums = sums0 + static_cast<size_t>(warp) * NV;
  float* Ubar = sums;
  float* bbar = sums + N * N;
  float* cbar = bbar + N;
  float* tsum = sums + NV0;
  stage_ubc(U, b, c, sU, sb, sc, N, S);
  for (int v = threadIdx.x; v < 2 * PKN; v += blockDim.x)
    sT[v] = v < PKN ? __ldg(bt + v) : __ldg(at + v - PKN);
  for (int v = lane; v < NV; v += 32) sums[v] = 0.0f;
  __syncthreads();
  float loss = 0.0f;  // lane 0's
  for (int m = blockIdx.x * W + warp; m < M; m += gridDim.x * W) {
    const size_t row = static_cast<size_t>(m) * N;
    const float2 z = sos::bin_phasor(m, w_scale, off);
    // each lane's channels: the guarded cascade, rescaled at each section
    for (int j = lane; j < N; j += 32) {
      float2 pb = make_float2(1.0f, 0.0f), pa = pb;
      for (int k = 0; k < K; ++k) {
        const float* cb = sT + k * N + j;
        const float s = sos::pow2_scale(pa);
        pb = sos::scaled(cmul(pb, horner(cb, P, KN, z)), s);
        pa = sos::scaled(cmul(pa, horner(cb + PKN, P, KN, z)), s);
      }
      sos::rescale_pair(pb, pa);
      const float den = cabs2(pa);
      const bool gk = den != 0.0f;
      const float inv = 1.0f / (gk ? den : 1.0f);
      const float2 g = gk ? make_float2((pb.x * pa.x + pb.y * pa.y) * inv,
                                        (pb.y * pa.x - pb.x * pa.y) * inv)
                          : make_float2(FLT_EPSILON, 0.0f);
      const float2 dj = D[row + j];
      d[j] = dj;
      gam[j] = g;
      ok[j] = gk ? 1.0f : 0.0f;
      dp[j] = cmul(dj, g);
      rhs[j] = make_float2(dj.x * sb[j], dj.y * sb[j]);
    }
    __syncwarp();
    assemble<false>(A, dp, sU, N, S, S, lane);
    eliminate<PIVOT>(A, rhs, N, S, lane);
    back_substitute(A, rhs, y, N, S, lane);
    float diff;
    const float2 tb = mse_cotangent(project(sc, y, N, lane), X[m], t[m], scale, diff);
    for (int j = lane; j < N; j += 32) rhs[j] = make_float2(sc[j], 0.0f);
    __syncwarp();
    if (PIVOT) {
      assemble<true>(A, dp, sU, N, S, S, lane);
      eliminate<true>(A, rhs, N, S, lane);
      back_substitute(A, rhs, w, N, S, lane);
    } else {
      transpose_solve_from_factors(A, rhs, w, N, S, lane);
    }
    // per row: D_bar, the b/c sums, bb dp_i (parked in rhs) for U_bar, and
    // Gam_bar to the tap sums or to Gbar
    for (int i = lane; i < N; i += 32) {
      const float2 bb = cmul(tb, w[i]);
      float ur = 0.0f, ui = 0.0f;
      for (int j = 0; j < N; ++j) {
        const float u = sU[i * S + j];
        ur += u * y[j].x;
        ui += u * y[j].y;
      }
      const float2 dpbar = cmul(bb, make_float2(ur, ui));
      const float2 gambar = cmul(dpbar, d[i]);
      if (WITH_DBAR) {
        float2 db = cmul(dpbar, gam[i]);
        db.x += bb.x * sb[i];
        db.y += bb.y * sb[i];
        Dbar[row + i] = db;
      }
      bbar[i] += cmul(bb, d[i]).x;
      cbar[i] += cmul(tb, y[i]).x;
      rhs[i] = cmul(bb, dp[i]);
      const bool gk = ok[i] != 0.0f;
      if (FUSE_TAPS) {
        if (gk) {
          const float2 tn = cmul(gambar, gam[i]);
          for (int part = 0; part < 2; ++part) {
            const float sign = part ? -1.0f : 1.0f;
            for (int k = 0; k < K; ++k) {
              const int at_k = part * PKN + k * N + i;
              const float2 sec = horner(sT + at_k, P, KN, z);
              const float dd = cabs2(sec);
              if (!(dd > 0.0f)) continue;
              const float qi = __fdividef(sign, dd);
              float2 q = make_float2((tn.x * sec.x + tn.y * sec.y) * qi,
                                     (tn.y * sec.x - tn.x * sec.y) * qi);
              float* out = tsum + at_k;
              for (int p = 0; p < P; ++p) {
                out[p * KN] += q.x;
                if (p + 1 < P) q = cmul(q, z);
              }
            }
          }
        }
      } else {
        Gbar[row + i] = gk ? gambar : make_float2(0.0f, 0.0f);
      }
    }
    __syncwarp();
    for (int i = 0; i < N; ++i) {
      const float2 bbdp = rhs[i];
      for (int j = lane; j < N; j += 32) Ubar[i * N + j] += cmul(bbdp, y[j]).x;
    }
    loss += diff * diff;
    __syncwarp();
  }
  if (lane == 0) sums[NV0 - 1] = loss;
  fold_sums(sums0, W, NV, partials + static_cast<size_t>(blockIdx.x) * NV);
}

using SosKernel = void (*)(const float2*, const float*, const float*, const float*,
                           const float*, const float*, const float2*, const float*, float2*,
                           float2*, float*, float, int, int, int, int, float, float);

// K5 looped's instantiation for (pivot, with_dbar, fuse_taps)
SosKernel sos_kernel(bool pivot, bool with_dbar, bool fuse_taps) {
  static const SosKernel table[8] = {
      ge_loop_sos_tf_mse_kernel<false, false, false>, ge_loop_sos_tf_mse_kernel<false, false, true>,
      ge_loop_sos_tf_mse_kernel<false, true, false>,  ge_loop_sos_tf_mse_kernel<false, true, true>,
      ge_loop_sos_tf_mse_kernel<true, false, false>,  ge_loop_sos_tf_mse_kernel<true, false, true>,
      ge_loop_sos_tf_mse_kernel<true, true, false>,   ge_loop_sos_tf_mse_kernel<true, true, true>};
  return table[(pivot ? 4 : 0) + (with_dbar ? 2 : 0) + (fuse_taps ? 1 : 0)];
}

// Set a kernel's dynamic shared memory (opting in above 48 KB) and return
// the blocks of the grid: at most the blocks resident on the card at once,
// and no more than the bins need.  0 on an error (read by the caller from
// cudaGetLastError()).
template <typename Kernel>
int configure(Kernel kernel, size_t smem, int warps, int M) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem) !=
          cudaSuccess)
    return 0;
  const int need = (M + warps - 1) / warps;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  return need < resident ? need : resident;
}

template <bool PIVOT, bool WITH_DBAR>
int tf_mse_grid(int N, int M) {
  const int W = loop_warps(kTfMse, N);
  return configure(ge_loop_tf_mse_kernel<PIVOT, WITH_DBAR>, smem_bytes(kTfMse, N, W), W, M);
}

int tf_mse_grid_any(bool pivot, bool with_dbar, int N, int M) {
  if (pivot && with_dbar) return tf_mse_grid<true, true>(N, M);
  if (pivot) return tf_mse_grid<true, false>(N, M);
  if (with_dbar) return tf_mse_grid<false, true>(N, M);
  return tf_mse_grid<false, false>(N, M);
}

int tf_bwd_grid(int N, int M) {
  const int W = loop_warps(kTfBwd, N);
  return configure(ge_loop_tf_bwd_kernel, smem_bytes(kTfBwd, N, W), W, M);
}

int sos_grid(bool pivot, bool with_dbar, bool fuse_taps, int N, int K, int P, int M) {
  const int W = sos_warps(N, K, P, fuse_taps);
  return configure(sos_kernel(pivot, with_dbar, fuse_taps),
                   sos_smem_bytes(N, K, P, fuse_taps, W), W, M);
}

// a grid's blocks as the C interface returns them: the count, or -1000 -
// the CUDA error while sizing it, or kBadSize
int grid_or_error(int blocks) {
  if (blocks > 0) return blocks;
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? -1000 - err : kBadSize;
}

// the warps resident on an SM of the kernel's block of W warps (its
// dynamic shared memory set first), or a negative grid_or_error code
template <typename Kernel>
int resident_warps(Kernel kernel, size_t smem, int W) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, W * 32, smem) != cudaSuccess)
    return grid_or_error(0);
  return per_sm * W;
}

bool sizes_ok(int kind, int N, int M) { return N >= 1 && M >= 1 && loop_warps(kind, N) >= 1; }

bool sos_sizes_ok(int N, int K, int P, bool fuse_taps, int M) {
  return N >= 1 && M >= 1 && K >= 1 && K <= kMaxK && P >= 1 && P <= kMaxP &&
         sos_warps(N, K, P, fuse_taps) >= 1;
}

}  // namespace loop
}  // namespace fdn

using fdn::loop::kDense;
using fdn::loop::kSolve;
using fdn::loop::kTfBwd;
using fdn::loop::kTfFwd;
using fdn::loop::kTfMse;

extern "C" {

int fl_threads_per_block() { return 32 * fdn::loop::kMaxWarps; }

// built once for every channel count
int fl_channels() { return 1; }

const char* fl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dynamic shared memory of a block of ``warps`` warps, and a block's warps
// (0: N does not fit), for kind 0 (K2), 1 (K6), 2 (K1), 3 (K3f), 4 (K3b)
long long fl_smem_bytes(int kind, int N, int warps) {
  return static_cast<long long>(fdn::loop::smem_bytes(kind, N, warps));
}

int fl_warps(int kind, int N) { return fdn::loop::loop_warps(kind, N); }

// the same for K5 looped, whose shared memory also depends on K, P and
// fuse_taps
long long fl_sos_smem_bytes(int N, int K, int P, int fuse_taps, int warps) {
  return static_cast<long long>(fdn::loop::sos_smem_bytes(N, K, P, fuse_taps != 0, warps));
}

int fl_sos_warps(int N, int K, int P, int fuse_taps) {
  return fdn::loop::sos_warps(N, K, P, fuse_taps != 0);
}

// warps resident on an SM as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives them for K2 looped's, K3f's and K3b's (backward) and K5 looped's
// blocks at these sizes; negative on an error
int fl_solve_resident_warps(int N, int transpose) {
  using namespace fdn::loop;
  if (!sizes_ok(kSolve, N, 1)) return kBadSize;
  const int W = loop_warps(kSolve, N);
  const size_t smem = smem_bytes(kSolve, N, W);
  if (transpose) return resident_warps(ge_loop_solve_kernel<true>, smem, W);
  return resident_warps(ge_loop_solve_kernel<false>, smem, W);
}

int fl_tf_resident_warps(int backward, int N) {
  using namespace fdn::loop;
  const int kind = backward ? kTfBwd : kTfFwd;
  if (!sizes_ok(kind, N, 1)) return kBadSize;
  const int W = loop_warps(kind, N);
  const size_t smem = smem_bytes(kind, N, W);
  if (backward) return resident_warps(ge_loop_tf_bwd_kernel, smem, W);
  return resident_warps(ge_loop_tf_fwd_kernel, smem, W);
}

int fl_sos_resident_warps(int pivot, int with_dbar, int fuse_taps, int N, int K, int P) {
  using namespace fdn::loop;
  if (!sos_sizes_ok(N, K, P, fuse_taps != 0, 1)) return kBadSize;
  const int W = sos_warps(N, K, P, fuse_taps != 0);
  return resident_warps(sos_kernel(pivot != 0, with_dbar != 0, fuse_taps != 0),
                        sos_smem_bytes(N, K, P, fuse_taps != 0, W), W);
}

// K1 looped's grid (its rows of partials); negative on an error
int fl_tf_mse_grid(int pivot, int with_dbar, int N, int M) {
  if (!fdn::loop::sizes_ok(kTfMse, N, M)) return fdn::loop::kBadSize;
  return fdn::loop::grid_or_error(fdn::loop::tf_mse_grid_any(pivot != 0, with_dbar != 0, N, M));
}

// K3b looped's grid; negative on an error
int fl_tf_bwd_grid(int N, int M) {
  if (!fdn::loop::sizes_ok(kTfBwd, N, M)) return fdn::loop::kBadSize;
  return fdn::loop::grid_or_error(fdn::loop::tf_bwd_grid(N, M));
}

// K5 looped's grid; negative on an error
int fl_sos_tf_mse_grid(int pivot, int with_dbar, int fuse_taps, int N, int K, int P, int M) {
  if (!fdn::loop::sos_sizes_ok(N, K, P, fuse_taps != 0, M)) return fdn::loop::kBadSize;
  return fdn::loop::grid_or_error(
      fdn::loop::sos_grid(pivot != 0, with_dbar != 0, fuse_taps != 0, N, K, P, M));
}

int fl_solve_launch(int N, int transpose, const void* D, const void* U, const void* B, void* Y,
                    int M, void* stream) {
  using namespace fdn::loop;
  if (!sizes_ok(kSolve, N, M)) return kBadSize;
  const auto s = static_cast<cudaStream_t>(stream);
  const int W = loop_warps(kSolve, N);
  const size_t smem = smem_bytes(kSolve, N, W);
  auto args = [&](auto kernel) {
    const int blocks = configure(kernel, smem, W, M);
    if (blocks > 0)
      kernel<<<blocks, W * 32, smem, s>>>(static_cast<const float2*>(D),
                                          static_cast<const float*>(U),
                                          static_cast<const float2*>(B), static_cast<float2*>(Y),
                                          N, M);
  };
  if (transpose)
    args(ge_loop_solve_kernel<true>);
  else
    args(ge_loop_solve_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

int fl_dense_solve_launch(int N, int transpose, const void* A, const void* B, void* Y, int M,
                          void* stream) {
  using namespace fdn::loop;
  if (!sizes_ok(kDense, N, M)) return kBadSize;
  const auto s = static_cast<cudaStream_t>(stream);
  const int W = loop_warps(kDense, N);
  const size_t smem = smem_bytes(kDense, N, W);
  auto args = [&](auto kernel) {
    const int blocks = configure(kernel, smem, W, M);
    if (blocks > 0)
      kernel<<<blocks, W * 32, smem, s>>>(static_cast<const float2*>(A),
                                          static_cast<const float2*>(B), static_cast<float2*>(Y),
                                          N, M);
  };
  if (transpose)
    args(ge_loop_dense_kernel<true>);
  else
    args(ge_loop_dense_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

// ``blocks`` is fl_tf_mse_grid's for the same (pivot, with_dbar, N, M):
// partials holds that many rows of N^2 + 2N + 1 floats
int fl_tf_mse_launch(int N, int pivot, int with_dbar, const void* D, const void* U, const void* b,
                     const void* c, const void* X, const void* t, void* Dbar, void* partials,
                     float scale, int M, int blocks, void* stream) {
  using namespace fdn::loop;
  if (!sizes_ok(kTfMse, N, M) || blocks < 1) return kBadSize;
  const auto s = static_cast<cudaStream_t>(stream);
  const int W = loop_warps(kTfMse, N);
  const size_t smem = smem_bytes(kTfMse, N, W);
  auto args = [&](auto kernel) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return;
    kernel<<<blocks, W * 32, smem, s>>>(
        static_cast<const float2*>(D), static_cast<const float*>(U),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<const float2*>(X), static_cast<const float*>(t), static_cast<float2*>(Dbar),
        static_cast<float*>(partials), scale, N, M);
  };
  if (pivot && with_dbar)
    args(ge_loop_tf_mse_kernel<true, true>);
  else if (pivot)
    args(ge_loop_tf_mse_kernel<true, false>);
  else if (with_dbar)
    args(ge_loop_tf_mse_kernel<false, true>);
  else
    args(ge_loop_tf_mse_kernel<false, false>);
  return static_cast<int>(cudaGetLastError());
}

int fl_tf_fwd_launch(int N, const void* D, const void* U, const void* b, const void* c, void* TF,
                     void* Y, int M, void* stream) {
  using namespace fdn::loop;
  if (!sizes_ok(kTfFwd, N, M)) return kBadSize;
  const int W = loop_warps(kTfFwd, N);
  const size_t smem = smem_bytes(kTfFwd, N, W);
  const int blocks = configure(ge_loop_tf_fwd_kernel, smem, W, M);
  if (blocks > 0)
    ge_loop_tf_fwd_kernel<<<blocks, W * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(D), static_cast<const float*>(U),
        static_cast<const float*>(b), static_cast<const float*>(c), static_cast<float2*>(TF),
        static_cast<float2*>(Y), N, M);
  return static_cast<int>(cudaGetLastError());
}

// ``blocks`` is fl_tf_bwd_grid's for the same (N, M): partials holds that
// many rows of N^2 + 2N + 1 floats
int fl_tf_bwd_launch(int N, const void* D, const void* U, const void* b, const void* c,
                     const void* Y, const void* TFB, void* Dbar, void* partials, int M,
                     int blocks, void* stream) {
  using namespace fdn::loop;
  if (!sizes_ok(kTfBwd, N, M) || blocks < 1) return kBadSize;
  const int W = loop_warps(kTfBwd, N);
  const size_t smem = smem_bytes(kTfBwd, N, W);
  if (cudaFuncSetAttribute(ge_loop_tf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) == cudaSuccess)
    ge_loop_tf_bwd_kernel<<<blocks, W * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(D), static_cast<const float*>(U),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<const float2*>(Y), static_cast<const float2*>(TFB),
        static_cast<float2*>(Dbar), static_cast<float*>(partials), N, M);
  return static_cast<int>(cudaGetLastError());
}

// ``blocks`` is fl_sos_tf_mse_grid's for the same flags and sizes:
// partials holds that many rows of N^2 + 2N + 1 (+ 2 P K N with
// fuse_taps) floats; Dbar (with_dbar) and Gbar (without fuse_taps) are
// (M, N) complex, else null
int fl_sos_tf_mse_launch(int N, int pivot, int with_dbar, int fuse_taps, const void* D,
                         const void* bt, const void* at, const void* U, const void* b,
                         const void* c, const void* X, const void* t, void* Dbar, void* Gbar,
                         void* partials, float scale, int M, int K, int P, float w_scale,
                         float off, int blocks, void* stream) {
  using namespace fdn::loop;
  if (!sos_sizes_ok(N, K, P, fuse_taps != 0, M) || blocks < 1) return kBadSize;
  const int W = sos_warps(N, K, P, fuse_taps != 0);
  const size_t smem = sos_smem_bytes(N, K, P, fuse_taps != 0, W);
  const SosKernel kernel = sos_kernel(pivot != 0, with_dbar != 0, fuse_taps != 0);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) == cudaSuccess)
    kernel<<<blocks, W * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(D), static_cast<const float*>(bt),
        static_cast<const float*>(at), static_cast<const float*>(U),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<const float2*>(X), static_cast<const float*>(t), static_cast<float2*>(Dbar),
        static_cast<float2*>(Gbar), static_cast<float*>(partials), scale, N, M, K, P, w_scale,
        off);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
