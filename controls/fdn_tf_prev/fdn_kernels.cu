// Hand-written Hopper (sm_90a) kernels of the colorless-FDN path, with a
// plain C interface that flamo_tpu_torch/ops/fdn_kernels.py loads through
// ctypes.  Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(), or kBadN when asked for another
// channel count than the FDN_N this library was built for.
//
// Layout: the public (M, N) complex64 tensors are read and written as
// they lie in memory, interleaved float2, row m = bin m.  Thread m reads
// its N consecutive float2 (8 N bytes); a warp covers one contiguous
// 256 N-byte span, so every byte of each cache line it touches is used.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py):
//   fdn_tf_mse_kernel  (K1) <- _fdn_tf_mse_kernel, pallas_call at :719
//   fdn_solve_kernel   (K2) <- _fdn_kernel,        pallas_call at :277
//   fdn_tf_fwd_kernel  (K3f) <- _fdn_tf_kernel,    pallas_call at :451
//   fdn_tf_bwd_kernel  (K3b) <- _fdn_tf_bwd_kernel, pallas_call at :474
//   dense_solve_kernel (K6) <- _solve_kernel,      pallas_call at :161
//
// What bounds K1-K3 on an H100: arithmetic.  At N = 6 a bin reads 48 bytes
// of D (plus 12 of X and t for K1) and does ~1-2.5 kFLOP of complex
// elimination, so at 3.35 TB/s and 67 TFLOP/s of FP32 the operation time
// is ~2x the memory time; at M = 48001 both are ~1 us, so a launch costs
// more than either.  The design answers the arithmetic bound by keeping
// everything per bin in registers (nothing but D, X, t in and the outputs
// out) and by the no-pivot K1 variant, which reuses the forward factors
// instead of a second elimination.  K1 is bound by issue slots: with 376
// blocks of 4 warps on 132 SMs most schedulers run 3 warps of ~1,200
// instructions each, so its block sums (fdn_ge.cuh, warp_sums) are
// recursive halvings, not one shuffle tree a value.
//
// K6 takes a dense matrix per bin instead of assembling it.  At M = 48001
// (the graph step) it is bound by bytes: at N = 6 a bin reads 288 bytes of
// A and 48 of B and writes 48 of y against ~1 kFLOP (18.4 MB, ~5.5 us).
// At the masked step's P = 2000 rows its bound is 0.23 us and it is bound
// by latency: a launch as the profiler sees it (~0.9 us for an empty
// kernel), one load round trip, one system's ~1.2 us chain of dependent
// elimination steps and the store, 2.2 us in all for a single system on
// this card (NVIDIA H100 80GB HBM3, 700.00 W; controls/k6_k1_designs).
// So K6 runs one thread a system in blocks of kSolveRows = 32: 63 blocks
// on 63 SMs at P = 2000, where blocks of 128 put 16 SMs' L1s under all of
// the strided loads (each thread loads its own 288 contiguous bytes, so a
// warp's load touches 32 lines).  Staging A through shared memory with
// 16-byte loads measured slower at every P up to 32000 (its barriers and
// round trip add to the chain) and no faster at 48001; a group of 8 lanes
// a system (a lane a row, the pivot found by shuffles) lengthened the
// chain further.  K6 reads A in the caller's (rows, N, N) layout, with no
// transposed copy.
//
// The ragged edge m >= M is masked: there is no padding to a tile.
// Masked threads of the gradient kernels run with D = X = t = tb = 0,
// which makes y = 0, tf = 0 and every cotangent exactly 0, and they still
// take part in the warp shuffles of the block reductions.

#include <cstddef>

#include "fdn_ge.cuh"

namespace fdn {

constexpr int kBadN = -1;

// K6's rows (= threads) per block: one warp, so that the masked step's
// 2000 rows spread over 63 SMs (see the notes above).
constexpr int kSolveRows = 32;

__device__ __forceinline__ float2 load_or_zero(const float2* __restrict__ p, bool live) {
  return live ? p[0] : make_float2(0.0f, 0.0f);
}

// K1: loss and cotangents of L = (1/M) sum_m (|tf_m X_m| - t_m)^2 in one pass.
// scale = 2 / M (the true bin count).  partials row per block:
// [U_bar, b_bar, c_bar, sum of (|tf X| - t)^2].
template <int N, bool PIVOT, bool WITH_DBAR>
__global__ void __launch_bounds__(kThreads)
    fdn_tf_mse_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      const float2* __restrict__ X, const float* __restrict__ t,
                      float2* __restrict__ Dbar, float* __restrict__ partials, float scale,
                      int M) {
  constexpr int NV = n_partials(N);
  __shared__ float red[kThreads / 32][NV];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const size_t row = static_cast<size_t>(live ? m : 0) * N;

  float2 d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = load_or_zero(D + row + i, live);
  float2 A[N][N];
  assemble<N, false>(d, U, A);
  float2 rhs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float bi = __ldg(b + i);
    rhs[i] = make_float2(d[i].x * bi, d[i].y * bi);
  }
  float2 y[N];
  if (PIVOT) {
    ge_pivot<N>(A, rhs, y);
  } else {
    ge_nopivot_factors<N>(A, rhs, y);
  }
  float2 tf = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ci = __ldg(c + i);
    tf.x += ci * y[i].x;
    tf.y += ci * y[i].y;
  }

  const float2 x = load_or_zero(X + (live ? m : 0), live);
  const float tt = live ? t[m] : 0.0f;
  const float zr = tf.x * x.x - tf.y * x.y;
  const float zi = tf.x * x.y + tf.y * x.x;
  const float a = sqrtf(zr * zr + zi * zi);
  const float diff = a - tt;
  // d/dz of (|z| - t)^2, scaled; safe divide where |z| = 0
  const float g = scale * diff / (a > 0.0f ? a : 1.0f);
  const float dzr = g * zr;
  const float dzi = g * zi;
  const float2 tb = make_float2(dzr * x.x + dzi * x.y, dzr * x.y - dzi * x.x);

  float2 cc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) cc[i] = make_float2(__ldg(c + i), 0.0f);
  float2 w[N];
  if (PIVOT) {
    float2 At[N][N];
    assemble<N, true>(d, U, At);
    ge_pivot<N>(At, cc, w);
  } else {
    transpose_solve_from_factors<N>(A, cc, w);
  }
  cotangents<N, WITH_DBAR>(d, U, b, y, w, tb, diff * diff, live,
                           WITH_DBAR ? Dbar + row : nullptr, red,
                           partials + static_cast<size_t>(blockIdx.x) * NV);
}

// K2: (I - diag(D_m) U) y_m = B_m, or with TRANSPOSE the system
// (I - diag(D_m) U)^T y_m = B_m that its gradient needs.  One thread a
// bin, as K1-K3; at N = 6 it is bound by issue slots, and ge_pivot's
// selects and swaps (~340 of its ~1,100 instructions at N = 6) run only
// for the rows some lane of the warp pivots to (ge_pivot_voted, a vote a
// candidate row): the values and the pivots are ge_pivot's, and on the
// card its results are ge_pivot's bit for bit (a vote a step measured as
// fast but rounded ~1 bin in 4 differently: the compiler fused other
// multiplies and adds around its branch; controls/k9_k2_designs).  U is
// staged in shared memory once a block (its 36 values read as
// broadcasts, not 36 loads through L1 a thread), and a bin's rows of D,
// B and Y move as float4s where N is even (the wrapper hands them 16-byte
// aligned).  Masked lanes (m >= M) solve A = I, B = 0 and stay in the
// warp for its votes.
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

template <int N, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads)
    fdn_solve_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                     const float2* __restrict__ B, float2* __restrict__ Y, int M) {
  __shared__ float sU[N * N];
  for (int v = threadIdx.x; v < N * N; v += kThreads) sU[v] = __ldg(U + v);
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const size_t row = static_cast<size_t>(live ? m : 0) * N;
  float2 d[N], rhs[N], y[N];
  load_row<N>(D + row, live, d);
  load_row<N>(B + row, live, rhs);
  __syncthreads();
  float2 A[N][N];
  assemble<N, TRANSPOSE, true>(d, sU, A);
  ge_pivot_voted<N>(A, rhs, y);
  if (live) store_row<N>(Y + row, y);
}

// K3f: tf_m = c^T (I - diag(D_m) U)^{-1} diag(D_m) b, pivoted; y is
// stored for the backward.
template <int N>
__global__ void __launch_bounds__(kThreads)
    fdn_tf_fwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      float2* __restrict__ TF, float2* __restrict__ Y, int M) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const size_t row = static_cast<size_t>(m) * N;
  float2 d[N], rhs[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = D[row + i];
    const float bi = __ldg(b + i);
    rhs[i] = make_float2(d[i].x * bi, d[i].y * bi);
  }
  float2 A[N][N];
  assemble<N, false>(d, U, A);
  ge_pivot<N>(A, rhs, y);
  float2 tf = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ci = __ldg(c + i);
    tf.x += ci * y[i].x;
    tf.y += ci * y[i].y;
    Y[row + i] = y[i];
  }
  TF[m] = tf;
}

// K3b: one adjoint elimination w = A^{-T} c per bin, then D_bar per bin and
// the U/b/c block partials (loss slot 0).  tb is JAX's cotangent of tf.
template <int N>
__global__ void __launch_bounds__(kThreads)
    fdn_tf_bwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      const float2* __restrict__ Y, const float2* __restrict__ TFB,
                      float2* __restrict__ Dbar, float* __restrict__ partials, int M) {
  constexpr int NV = n_partials(N);
  __shared__ float red[kThreads / 32][NV];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const size_t row = static_cast<size_t>(live ? m : 0) * N;
  float2 d[N], y[N], cc[N], w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = load_or_zero(D + row + i, live);
    y[i] = load_or_zero(Y + row + i, live);
    cc[i] = make_float2(__ldg(c + i), 0.0f);
  }
  const float2 tb = load_or_zero(TFB + (live ? m : 0), live);
  float2 At[N][N];
  assemble<N, true>(d, U, At);
  ge_pivot<N>(At, cc, w);
  cotangents<N, true>(d, U, b, y, w, tb, 0.0f, live, Dbar + row, red,
                      partials + static_cast<size_t>(blockIdx.x) * NV);
}

// K6: A_m y_m = B_m for a dense complex N x N matrix per row m (batch and
// bins folded into the rows), or with TRANSPOSE A_m^T y_m = B_m, which the
// gradient needs: the kernel then reads A[j][i], so A^T is never stored.
// A is (M, N, N) row-major per row, B and Y are (M, N).  One thread a
// row, kSolveRows rows a block.
template <int N, bool TRANSPOSE>
__global__ void __launch_bounds__(kSolveRows)
    dense_solve_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                       float2* __restrict__ Y, int M) {
  const int m = blockIdx.x * kSolveRows + threadIdx.x;
  if (m >= M) return;
  const float2* __restrict__ a = A + static_cast<size_t>(m) * (N * N);
  const size_t row = static_cast<size_t>(m) * N;
  float2 Am[N][N], rhs[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Am[i][j] = __ldg(a + (TRANSPOSE ? j * N + i : i * N + j));
    rhs[i] = __ldg(B + row + i);
  }
  ge_pivot<N>(Am, rhs, y);
#pragma unroll
  for (int i = 0; i < N; ++i) Y[row + i] = y[i];
}

inline unsigned n_blocks(int M, int per_block = kThreads) {
  return static_cast<unsigned>((M + per_block - 1) / per_block);
}

template <int N>
void launch_tf_mse(bool pivot, bool with_dbar, const float2* D, const float* U,
                   const float* b, const float* c, const float2* X, const float* t,
                   float2* Dbar, float* partials, float scale, int M, cudaStream_t s) {
  const dim3 grid(n_blocks(M)), block(kThreads);
  if (pivot && with_dbar)
    fdn_tf_mse_kernel<N, true, true><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
  else if (pivot)
    fdn_tf_mse_kernel<N, true, false><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
  else if (with_dbar)
    fdn_tf_mse_kernel<N, false, true><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
  else
    fdn_tf_mse_kernel<N, false, false><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
}

template <int N>
void launch_solve(bool transpose, const float2* D, const float* U, const float2* B, float2* Y,
                  int M, cudaStream_t s) {
  const dim3 grid(n_blocks(M)), block(kThreads);
  if (transpose)
    fdn_solve_kernel<N, true><<<grid, block, 0, s>>>(D, U, B, Y, M);
  else
    fdn_solve_kernel<N, false><<<grid, block, 0, s>>>(D, U, B, Y, M);
}

template <int N>
void launch_dense_solve(bool transpose, const float2* A, const float2* B, float2* Y, int M,
                        cudaStream_t s) {
  const dim3 grid(n_blocks(M, kSolveRows)), block(kSolveRows);
  if (transpose)
    dense_solve_kernel<N, true><<<grid, block, 0, s>>>(A, B, Y, M);
  else
    dense_solve_kernel<N, false><<<grid, block, 0, s>>>(A, B, Y, M);
}

template <int N>
void launch_tf_fwd(const float2* D, const float* U, const float* b, const float* c, float2* TF,
                   float2* Y, int M, cudaStream_t s) {
  fdn_tf_fwd_kernel<N><<<n_blocks(M), kThreads, 0, s>>>(D, U, b, c, TF, Y, M);
}

template <int N>
void launch_tf_bwd(const float2* D, const float* U, const float* b, const float* c,
                   const float2* Y, const float2* TFB, float2* Dbar, float* partials, int M,
                   cudaStream_t s) {
  fdn_tf_bwd_kernel<N><<<n_blocks(M), kThreads, 0, s>>>(D, U, b, c, Y, TFB, Dbar, partials, M);
}

}  // namespace fdn

// One build instantiates the kernels for one channel count, FDN_N, given
// on the nvcc command line (-DFDN_N=6): the unrolled eliminations at large
// N compile slowly, so each N is its own small library, built in parallel
// with the others and only when first needed.
#ifndef FDN_N
#error "compile with -DFDN_N=<channel count>"
#endif
static_assert(FDN_N >= 1 && FDN_N <= fdn::kMaxN, "FDN_N out of range");

extern "C" {

int fdn_threads_per_block() { return fdn::kThreads; }

int fdn_channels() { return FDN_N; }

const char* fdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fdn_tf_mse_launch(int N, int pivot, int with_dbar, const void* D, const void* U,
                      const void* b, const void* c, const void* X, const void* t, void* Dbar,
                      void* partials, float scale, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
  fdn::launch_tf_mse<FDN_N>(pivot != 0, with_dbar != 0, static_cast<const float2*>(D),
    static_cast<const float*>(U), static_cast<const float*>(b),
    static_cast<const float*>(c), static_cast<const float2*>(X),
    static_cast<const float*>(t), static_cast<float2*>(Dbar),
    static_cast<float*>(partials), scale, M, s);
  return static_cast<int>(cudaGetLastError());
}

int fdn_solve_launch(int N, int transpose, const void* D, const void* U, const void* B, void* Y,
                     int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
  fdn::launch_solve<FDN_N>(transpose != 0, static_cast<const float2*>(D),
    static_cast<const float*>(U), static_cast<const float2*>(B),
    static_cast<float2*>(Y), M, s);
  return static_cast<int>(cudaGetLastError());
}

int fdn_dense_solve_launch(int N, int transpose, const void* A, const void* B, void* Y, int M,
                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
  fdn::launch_dense_solve<FDN_N>(transpose != 0, static_cast<const float2*>(A),
    static_cast<const float2*>(B), static_cast<float2*>(Y), M, s);
  return static_cast<int>(cudaGetLastError());
}

int fdn_tf_fwd_launch(int N, const void* D, const void* U, const void* b, const void* c,
                      void* TF, void* Y, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
  fdn::launch_tf_fwd<FDN_N>(static_cast<const float2*>(D), static_cast<const float*>(U),
    static_cast<const float*>(b), static_cast<const float*>(c),
    static_cast<float2*>(TF), static_cast<float2*>(Y), M, s);
  return static_cast<int>(cudaGetLastError());
}

int fdn_tf_bwd_launch(int N, const void* D, const void* U, const void* b, const void* c,
                      const void* Y, const void* TFB, void* Dbar, void* partials, int M,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
  fdn::launch_tf_bwd<FDN_N>(static_cast<const float2*>(D), static_cast<const float*>(U),
    static_cast<const float*>(b), static_cast<const float*>(c),
    static_cast<const float2*>(Y), static_cast<const float2*>(TFB),
    static_cast<float2*>(Dbar), static_cast<float*>(partials), M, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
