// Hand-written Hopper (sm_90a) kernels of the per-bin solves for any
// channel count N, N a run-time argument: one library for every N (built
// as N = 1), with a plain C interface that
// flamo_tpu_torch/ops/fdn_kernels.py loads through ctypes.  The wrappers
// there take the unrolled kernels of fdn_kernels.cu (one library a channel
// count, 1..16) up to 16 channels and these above.  Every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError(), or kBadSize for sizes it does not take.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py;
// there the elimination is unrolled over N at trace time, for any N):
//   ge_loop_solve_kernel  (K2 looped) <- _fdn_kernel,         pallas_call at :277
//   ge_loop_dense_kernel  (K6 looped) <- _solve_kernel,       pallas_call at :161
//   ge_loop_tf_mse_kernel (K1 looped) <- _fdn_tf_mse_kernel,  pallas_call at :719
// Each computes the same function as its unrolled counterpart in
// fdn_kernels.cu, with the same layouts, and the same pivot rule.
//
// Design (fdn_loop.cuh): one warp a bin, the bin's N x N complex system in
// shared memory with an odd row stride, a lane a row.  Blocks hold W warps
// (loop_warps: as many as fit 227 KB, at most 8) and walk the bins with a
// grid stride, W bins at a time; the grid is at most the blocks that are
// resident on the card at once.  Each warp owns its slice of the block's
// dynamic shared memory: the system, its vectors and, in K1, its sums.
// U, and K1's b and c, are staged once a block with the same odd stride.
//
// What bounds them on an H100: arithmetic, as the unrolled kernels.
// Pivoted elimination of one right-hand side is ~(2/3) N^3 complex
// multiply-adds, 8 FP32 operations each: at M = 48001 bins that is ~8.4
// GFLOP at N = 32 (~0.13 ms at 67 TFLOP/s) and ~67 GFLOP at N = 64 (~1.0
// ms), against 25-50 MB of D, B and Y (~0.01 ms at 3.35 TB/s); K6's dense A
// at N = 64 is 1.57 GB (~0.47 ms), still below its operations.  This
// first design keeps every operand in shared memory and is bound by its
// latency: a lane's update of a row reads and writes shared memory for
// each entry, and with 4-8 warps an SM at N = 64 little hides it.  Its
// times against the bound are in PERF.md.
//
// K1's sums over bins (U_bar with N^2 values, b_bar and c_bar with N each,
// and the loss) cannot keep the unrolled kernel's one partials row a
// block of 128 bins (~200 MB at N = 64, M = 48001): each warp adds its
// bins' values into its own sums in shared memory (a value always on the
// same lane, so no atomics and a fixed order), and at the end each block
// adds its warps' sums in warp order into its one partials row, which the
// wrapper sums with torch.sum.  For a given card and grid the result is
// the same on every launch.

#include <cstddef>

#include "fdn_loop.cuh"

namespace fdn {
namespace loop {

constexpr int kBadSize = -2;
constexpr int kMaxWarps = 8;
// the dynamic shared memory a block may opt in to on sm_90 (227 KB)
constexpr int kSmemLimit = 232448;

enum Kind { kSolve = 0, kDense = 1, kTfMse = 2 };

__host__ __device__ inline int even(int n) { return n + (n & 1); }

// floats of the block-wide part of shared memory: U (K2, K1) and b, c (K1)
__host__ __device__ inline int common_floats(int kind, int N) {
  if (kind == kDense) return 0;
  return even(N * stride(N) + (kind == kTfMse ? 2 * N : 0));
}

// float2s of a warp's system and vectors: d, rhs, y (K2); rhs, y (K6);
// d, rhs, y, w (K1)
__host__ __device__ inline int warp_float2s(int kind, int N) {
  const int vecs = kind == kSolve ? 3 : kind == kDense ? 2 : 4;
  return N * stride(N) + vecs * N;
}

// floats of a warp's sums (K1): U_bar, b_bar, c_bar, loss
__host__ __device__ inline int warp_sum_floats(int kind, int N) {
  return kind == kTfMse ? n_partials(N) : 0;
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
  float* Ubar = sums;
  float* bbar = sums + N * N;
  float* cbar = bbar + N;
  stage_u(U, sU, N, S);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sb[i] = __ldg(b + i);
    sc[i] = __ldg(c + i);
  }
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
    // tf = c^T y: each lane's rows in order, then a butterfly, which
    // leaves the same sum on every lane
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
    const float2 x = X[m];
    const float tt = t[m];
    const float zr = tf.x * x.x - tf.y * x.y;
    const float zi = tf.x * x.y + tf.y * x.x;
    const float a = sqrtf(zr * zr + zi * zi);
    const float diff = a - tt;
    // d/dz of (|z| - t)^2, scaled; safe divide where |z| = 0
    const float g = scale * diff / (a > 0.0f ? a : 1.0f);
    const float dzr = g * zr;
    const float dzi = g * zi;
    const float2 tb = make_float2(dzr * x.x + dzi * x.y, dzr * x.y - dzi * x.x);
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
    // per row: D_bar, and bbD = tb w_i d_i (parked in rhs) for U_bar
    for (int i = lane; i < N; i += 32) {
      const float2 bb = cmul(tb, w[i]);
      if (WITH_DBAR) {
        float ur = 0.0f, ui = 0.0f;
        for (int j = 0; j < N; ++j) {
          const float u = sU[i * S + j];
          ur += u * y[j].x;
          ui += u * y[j].y;
        }
        Dbar[row + i] = cmul(bb, make_float2(ur + sb[i], ui));
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
    loss += diff * diff;
    __syncwarp();
  }
  if (lane == 0) sums[NV - 1] = loss;
  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * NV;
  for (int v = threadIdx.x; v < NV; v += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < W; ++q) s += sums0[static_cast<size_t>(q) * NV + v];
    out[v] = s;
  }
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

bool sizes_ok(int kind, int N, int M) { return N >= 1 && M >= 1 && loop_warps(kind, N) >= 1; }

}  // namespace loop
}  // namespace fdn

using fdn::loop::kDense;
using fdn::loop::kSolve;
using fdn::loop::kTfMse;

extern "C" {

int fl_threads_per_block() { return 32 * fdn::loop::kMaxWarps; }

// built once for every channel count
int fl_channels() { return 1; }

const char* fl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dynamic shared memory of a block of ``warps`` warps, and a block's warps
// (0: N does not fit), for kind 0 (K2), 1 (K6), 2 (K1)
long long fl_smem_bytes(int kind, int N, int warps) {
  return static_cast<long long>(fdn::loop::smem_bytes(kind, N, warps));
}

int fl_warps(int kind, int N) { return fdn::loop::loop_warps(kind, N); }

// K1 looped's grid (its rows of partials); negative on an error
int fl_tf_mse_grid(int pivot, int with_dbar, int N, int M) {
  if (!fdn::loop::sizes_ok(kTfMse, N, M)) return fdn::loop::kBadSize;
  const int blocks = fdn::loop::tf_mse_grid_any(pivot != 0, with_dbar != 0, N, M);
  if (blocks <= 0) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? -1000 - err : fdn::loop::kBadSize;
  }
  return blocks;
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

}  // extern "C"
