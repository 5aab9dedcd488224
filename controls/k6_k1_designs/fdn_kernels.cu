// The candidate designs of K6 (the dense per-bin solve) and of K1's and
// K3b's block sums, weighed against each other and against the previous
// kernels (controls/fdn_kernels_prev) by time_designs.py beside this file,
// on one card: a frozen record, with its own copy of the elimination core
// (fdn_ge.cuh here).  The package's kernels are in
// flamo_tpu_torch/csrc/fdn_kernels.cu; the designs kept there are K6's
// variant 3 (one thread a system loading its own system, blocks of 32)
// and the halving sums (reduce 1) in blocks of 128.
//
// K6 (fdn_dense_solve_variant_launch, variant):
//   0, 1  one thread a system, A and B staged through shared memory by
//         16-byte loads of consecutive threads (all loads of a thread
//         before its stores), rows at an odd float2 stride, Y written back
//         the same way; blocks of 32 or 128 systems;
//   2     a group of G lanes a system (G = N rounded up to a power of
//         two), a lane a row: the pivot's argmax by shuffles, the lower
//         row winning ties; staged as 0;
//   3, 4  one thread a system loading its own contiguous N x N matrix, in
//         blocks of 32 or 64 (the previous kernel's blocks were 128).
// K1 (fdn_tf_mse_variant_launch, reduce and threads) and K3b
// (fdn_tf_bwd_variant_launch, reduce): the block sums of the N^2 + 2N + 1
// per-bin values as one shuffle tree a value (0), recursive halving (1)
// or a transposed sum through shared memory (2); K1's training variant
// also in blocks of 64.  fdn_floor_launch: an empty kernel (0) and one
// load and one store (1), the yardsticks of a launch's fixed cost.
// Every entry returns cudaGetLastError(), kBadN for another channel count
// than FDN_N, or kBadSize for a variant it does not hold.
//
// Build with -DFDN_N=6 for sm_90a, as time_designs.py does.

#include <cstddef>
#include <cstdint>

#include "fdn_ge.cuh"

namespace fdn {

constexpr int kBadN = -1;

__device__ __forceinline__ float2 load_or_zero(const float2* __restrict__ p, bool live) {
  return live ? p[0] : make_float2(0.0f, 0.0f);
}

// K1: loss and cotangents of L = (1/M) sum_m (|tf_m X_m| - t_m)^2 in one pass.
// scale = 2 / M (the true bin count).  partials row per block:
// [U_bar, b_bar, c_bar, sum of (|tf X| - t)^2].
template <int N, bool PIVOT, bool WITH_DBAR, int REDUCE, int THREADS>
__global__ void __launch_bounds__(THREADS)
    fdn_tf_mse_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      const float2* __restrict__ X, const float* __restrict__ t,
                      float2* __restrict__ Dbar, float* __restrict__ partials, float scale,
                      int M) {
  constexpr int NV = n_partials(N);
  __shared__ float red[reduce_floats(REDUCE, THREADS, NV)];
  const int m = blockIdx.x * THREADS + threadIdx.x;
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
  cotangents<N, WITH_DBAR, REDUCE, THREADS>(d, U, b, y, w, tb, diff * diff, live,
                                            WITH_DBAR ? Dbar + row : nullptr, red,
                                            partials + static_cast<size_t>(blockIdx.x) * NV);
}

// K3b: one adjoint elimination w = A^{-T} c per bin, then D_bar per bin and
// the U/b/c block partials (loss slot 0).  tb is JAX's cotangent of tf.
template <int N, int REDUCE>
__global__ void __launch_bounds__(kThreads)
    fdn_tf_bwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      const float2* __restrict__ Y, const float2* __restrict__ TFB,
                      float2* __restrict__ Dbar, float* __restrict__ partials, int M) {
  constexpr int NV = n_partials(N);
  __shared__ float red[reduce_floats(REDUCE, kThreads, NV)];
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
  cotangents<N, true, REDUCE, kThreads>(d, U, b, y, w, tb, 0.0f, live, Dbar + row, red,
                                        partials + static_cast<size_t>(blockIdx.x) * NV);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The float2 pair (e, e + 1) at src (e even) as one 16-byte load, or two
// 8-byte ones where src is not 16-byte aligned.
__device__ __forceinline__ float4 load_pair(const float2* __restrict__ src, int e, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(src + e));
  const float2 lo = __ldg(src + e), hi = __ldg(src + e + 1);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Element e of rows of W float2 into shared memory at a row stride of S.
template <int W, int S>
__device__ __forceinline__ void put(float2* __restrict__ dst, int e, float2 v) {
  dst[(e / W) * S + e % W] = v;
}

// Stage nrows systems (rows of A, N x N float2, and of B, N float2, each
// contiguous in device memory) into shared memory at the row strides SA
// and SB.  Consecutive threads take consecutive 16-byte pairs of A's span
// and then of B's, and a thread issues all its loads, of A and of B,
// before its first store: one round trip to memory.
template <int N, int ROWS, int THREADS, int SA, int SB>
__device__ __forceinline__ void stage_systems(const float2* __restrict__ A,
                                              const float2* __restrict__ B, int nrows,
                                              float2* __restrict__ sa, float2* __restrict__ sb) {
  constexpr int NN = N * N;
  constexpr int ITER = ((ROWS * NN + ROWS * N) / 2 + THREADS - 1) / THREADS;
  constexpr int CHUNK = ITER < 24 ? ITER : 24;
  const int na = nrows * NN, nb = nrows * N, pa = na / 2, pb = nb / 2;
  const bool va = aligned16(A), vb = aligned16(B);
#pragma unroll
  for (int c0 = 0; c0 < ITER; c0 += CHUNK) {
    float4 buf[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int p = threadIdx.x + (c0 + i) * THREADS;
      buf[i] = c0 + i >= ITER ? make_float4(0.f, 0.f, 0.f, 0.f)
               : p < pa       ? load_pair(A, 2 * p, va)
               : p < pa + pb  ? load_pair(B, 2 * (p - pa), vb)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int p = threadIdx.x + (c0 + i) * THREADS;
      if (c0 + i >= ITER || p >= pa + pb) continue;
      float2* dst = p < pa ? sa : sb;
      const int e = p < pa ? 2 * p : 2 * (p - pa);
      if (p < pa) {
        put<NN, SA>(dst, e, make_float2(buf[i].x, buf[i].y));
        put<NN, SA>(dst, e + 1, make_float2(buf[i].z, buf[i].w));
      } else {
        put<N, SB>(dst, e, make_float2(buf[i].x, buf[i].y));
        put<N, SB>(dst, e + 1, make_float2(buf[i].z, buf[i].w));
      }
    }
  }
  if ((na & 1) && threadIdx.x == 0) put<NN, SA>(sa, na - 1, __ldg(A + na - 1));
  if ((nb & 1) && threadIdx.x == THREADS - 1) put<N, SB>(sb, nb - 1, __ldg(B + nb - 1));
}

// nrows rows of W float2 at a row stride of S in shared memory out to
// contiguous device memory, by consecutive threads in 16-byte pieces.
template <int W, int S, int THREADS>
__device__ __forceinline__ void unstage_rows(const float2* __restrict__ src, int nrows,
                                             float2* __restrict__ dst) {
  const int n = nrows * W;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* __restrict__ dst4 = reinterpret_cast<float4*>(dst);
    for (int q = threadIdx.x; 2 * q + 1 < n; q += THREADS) {
      const int e = 2 * q;
      const float2 lo = src[(e / W) * S + e % W];
      const float2 hi = src[((e + 1) / W) * S + (e + 1) % W];
      dst4[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    if ((n & 1) && threadIdx.x == 0) dst[n - 1] = src[((n - 1) / W) * S + (n - 1) % W];
  } else {
    for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = src[(e / W) * S + e % W];
  }
}

// Row strides of K6's staged matrices and right-hand sides, in float2: odd,
// so that threads reading their own rows at the same offset hit distinct
// banks.
__host__ __device__ constexpr int mat_stride(int N) { return (N * N) | 1; }
__host__ __device__ constexpr int vec_stride(int N) { return N | 1; }

// K6: A_m y_m = B_m for a dense complex N x N matrix per row m (batch and
// bins folded into the rows), or with TRANSPOSE A_m^T y_m = B_m, which the
// gradient needs: the kernel then reads A[j][i], so A^T is never stored.
// A is (M, N, N) row-major per row, B and Y are (M, N).  One thread a
// system, ROWS systems a block: the block stages its span of A and B
// through shared memory and writes Y back the same way.
template <int N, bool TRANSPOSE, int ROWS>
__global__ void __launch_bounds__(ROWS)
    dense_solve_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                       float2* __restrict__ Y, int M) {
  constexpr int NN = N * N, SA = mat_stride(N), SB = vec_stride(N);
  extern __shared__ float2 staged[];
  float2* sa = staged;
  float2* sb = staged + ROWS * SA;
  const int m0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, M - m0);
  stage_systems<N, ROWS, ROWS, SA, SB>(A + static_cast<size_t>(m0) * NN,
                                       B + static_cast<size_t>(m0) * N, nrows, sa, sb);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < nrows) {
    const float2* a = sa + r * SA;
    float2 Am[N][N], rhs[N], y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) Am[i][j] = a[TRANSPOSE ? j * N + i : i * N + j];
      rhs[i] = sb[r * SB + i];
    }
    ge_pivot<N>(Am, rhs, y);
#pragma unroll
    for (int i = 0; i < N; ++i) sb[r * SB + i] = y[i];
  }
  __syncthreads();
  unstage_rows<N, SB, ROWS>(sb, nrows, Y + static_cast<size_t>(m0) * N);
}

__host__ __device__ constexpr int group_lanes(int N) {
  return N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : N <= 8 ? 8 : 16;
}

__device__ __forceinline__ float2 shfl2(float2 v, int src, int width) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src, width),
                     __shfl_sync(0xffffffffu, v.y, src, width));
}

// K6 over a group of G lanes a system, a lane a row (row r of A, or of
// A^T): the pivot's argmax by shuffles within the group, the lower row
// winning ties as ge_pivot's strictly-larger rule makes it; the pivot row
// broadcast by shuffles (the row that gave it receives the old row k in
// the same shuffle); back substitution a row at a time, each y_i broadcast
// to the group.
template <int N, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads)
    dense_solve_group_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                             float2* __restrict__ Y, int M) {
  constexpr int G = group_lanes(N), SYS = kThreads / G;
  constexpr int SA = mat_stride(N), SB = vec_stride(N);
  extern __shared__ float2 staged[];
  float2* sa = staged;
  float2* sb = staged + SYS * SA;
  const int m0 = blockIdx.x * SYS;
  const int nrows = min(SYS, M - m0);
  stage_systems<N, SYS, kThreads, SA, SB>(A + static_cast<size_t>(m0) * N * N,
                                          B + static_cast<size_t>(m0) * N, nrows, sa, sb);
  __syncthreads();
  const int lane = threadIdx.x % G, s = threadIdx.x / G;
  const bool live = lane < N && s < nrows;
  const float2 zero = make_float2(0.0f, 0.0f);
  float2 a[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    a[j] = live ? sa[s * SA + (TRANSPOSE ? j * N + lane : lane * N + j)] : zero;
  float2 rhs = live ? sb[s * SB + lane] : zero;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the sequential scan's rule: a NaN candidate never wins, a NaN
    // diagonal keeps row k
    float v = cabs2(a[k]);
    if (v != v) v = lane == k ? __int_as_float(0x7f800000) : -1.0f;
    if (lane < k || lane >= N) v = -1.0f;
    int p = lane;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o, G);
      const int op = __shfl_xor_sync(0xffffffffu, p, o, G);
      const bool take = op < p ? !(v > ov) : ov > v;
      v = take ? ov : v;
      p = take ? op : p;
    }
    const int src = lane == p ? k : p;
    const bool moves = lane == p || lane == k;
    float2 prow[N];
#pragma unroll
    for (int j = k; j < N; ++j) {
      const float2 x = shfl2(a[j], src, G);
      prow[j] = lane == p ? a[j] : x;
      a[j] = moves ? x : a[j];
    }
    const float2 xr = shfl2(rhs, src, G);
    const float2 prhs = lane == p ? rhs : xr;
    rhs = moves ? xr : rhs;
    if (lane > k) {
      const float2 f = cmul(a[k], crecip(prow[k]));
#pragma unroll
      for (int j = k + 1; j < N; ++j) a[j] = csub(a[j], cmul(f, prow[j]));
      rhs = csub(rhs, cmul(f, prhs));
    }
  }
  // back substitution in back_substitute's order: row i subtracts
  // A[i][j] y_j for j = i + 1, ..., N - 1, then divides
  float2 y[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float2 acc = rhs;
#pragma unroll
    for (int j = i + 1; j < N; ++j) acc = csub(acc, cmul(a[j], y[j]));
    y[i] = shfl2(cdiv(acc, a[i]), i, G);
  }
  float2 yv = y[0];
#pragma unroll
  for (int i = 1; i < N; ++i) yv = lane == i ? y[i] : yv;
  __syncthreads();
  if (live) sb[s * SB + lane] = yv;
  __syncthreads();
  unstage_rows<N, SB, kThreads>(sb, nrows, Y + static_cast<size_t>(m0) * N);
}

// The launch floor's two yardsticks: a kernel that does nothing, and one
// whose thread 0 loads one float2 and stores it.
__global__ void empty_kernel() {}

__global__ void load_store_kernel(const float2* __restrict__ src, float2* __restrict__ dst) {
  if (threadIdx.x == 0) dst[0] = __ldg(src);
}

// K6 with each thread loading its own system straight from device memory
// (no staging), ROWS threads a block.
template <int N, bool TRANSPOSE, int ROWS>
__global__ void __launch_bounds__(ROWS)
    dense_solve_direct_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
                              float2* __restrict__ Y, int M) {
  const int m = blockIdx.x * ROWS + threadIdx.x;
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

constexpr int kBadSize = -2;

template <int N, int REDUCE, int THREADS>
void launch_tf_mse_t(bool pivot, bool with_dbar, const float2* D, const float* U, const float* b,
                     const float* c, const float2* X, const float* t, float2* Dbar,
                     float* partials, float scale, int M, cudaStream_t s) {
  const dim3 grid(n_blocks(M, THREADS)), block(THREADS);
  if (pivot && with_dbar)
    fdn_tf_mse_kernel<N, true, true, REDUCE, THREADS><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
  else if (pivot)
    fdn_tf_mse_kernel<N, true, false, REDUCE, THREADS><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
  else if (with_dbar)
    fdn_tf_mse_kernel<N, false, true, REDUCE, THREADS><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
  else
    fdn_tf_mse_kernel<N, false, false, REDUCE, THREADS><<<grid, block, 0, s>>>(D, U, b, c, X, t, Dbar, partials, scale, M);
}

// Launch a kernel that takes `smem` bytes of dynamic shared memory, opting
// in above the default 48 KB.
template <typename Kernel, typename... Args>
int launch_dynamic(Kernel kernel, unsigned grid, unsigned block, int smem, cudaStream_t s,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int ROWS>
int launch_dense_solve_rows(bool transpose, const float2* A, const float2* B, float2* Y, int M,
                            cudaStream_t s) {
  const int smem = ROWS * (mat_stride(N) + vec_stride(N)) * static_cast<int>(sizeof(float2));
  if (transpose)
    return launch_dynamic(dense_solve_kernel<N, true, ROWS>, n_blocks(M, ROWS), ROWS, smem, s, A, B, Y, M);
  return launch_dynamic(dense_solve_kernel<N, false, ROWS>, n_blocks(M, ROWS), ROWS, smem, s, A, B, Y, M);
}

template <int N, int ROWS>
void launch_dense_solve_direct_t(bool transpose, const float2* A, const float2* B, float2* Y,
                                 int M, cudaStream_t s) {
  if (transpose)
    dense_solve_direct_kernel<N, true, ROWS><<<n_blocks(M, ROWS), ROWS, 0, s>>>(A, B, Y, M);
  else
    dense_solve_direct_kernel<N, false, ROWS><<<n_blocks(M, ROWS), ROWS, 0, s>>>(A, B, Y, M);
}

template <int N, int ROWS>
int launch_dense_solve_direct(bool transpose, const float2* A, const float2* B, float2* Y, int M,
                              cudaStream_t s) {
  launch_dense_solve_direct_t<N, ROWS>(transpose, A, B, Y, M, s);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_dense_solve_group(bool transpose, const float2* A, const float2* B, float2* Y, int M,
                             cudaStream_t s) {
  constexpr int SYS = kThreads / group_lanes(N);
  const int smem = SYS * (mat_stride(N) + vec_stride(N)) * static_cast<int>(sizeof(float2));
  if (transpose)
    return launch_dynamic(dense_solve_group_kernel<N, true>, n_blocks(M, SYS), kThreads, smem, s, A, B, Y, M);
  return launch_dynamic(dense_solve_group_kernel<N, false>, n_blocks(M, SYS), kThreads, smem, s, A, B, Y, M);
}

inline void launch_floor(int which, const float2* src, float2* dst, cudaStream_t s) {
  if (which == 0)
    empty_kernel<<<1, 32, 0, s>>>();
  else
    load_store_kernel<<<1, 32, 0, s>>>(src, dst);
}

template <int N, int REDUCE>
void launch_tf_bwd_t(const float2* D, const float* U, const float* b, const float* c,
                     const float2* Y, const float2* TFB, float2* Dbar, float* partials, int M,
                     cudaStream_t s) {
  fdn_tf_bwd_kernel<N, REDUCE><<<n_blocks(M), kThreads, 0, s>>>(D, U, b, c, Y, TFB, Dbar, partials, M);
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

// variants timed against each other: reduce 0 trees, 1 halving,
// 2 transposed; threads 128 or 64
int fdn_tf_mse_variant_launch(int N, int pivot, int with_dbar, int reduce, int threads,
                              const void* D, const void* U, const void* b, const void* c,
                              const void* X, const void* t, void* Dbar, void* partials,
                              float scale, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
#if FDN_N == 6
  const auto D2 = static_cast<const float2*>(D);
  const auto U2 = static_cast<const float*>(U);
  const auto b2 = static_cast<const float*>(b);
  const auto c2 = static_cast<const float*>(c);
  const auto X2 = static_cast<const float2*>(X);
  const auto t2 = static_cast<const float*>(t);
  const auto Db = static_cast<float2*>(Dbar);
  const auto P = static_cast<float*>(partials);
  const bool pv = pivot != 0, wd = with_dbar != 0;
  if (threads == 64 && !pv && !wd) {
    if (reduce == 0) fdn::launch_tf_mse_t<FDN_N, 0, 64>(pv, wd, D2, U2, b2, c2, X2, t2, Db, P, scale, M, s);
    else if (reduce == 1) fdn::launch_tf_mse_t<FDN_N, 1, 64>(pv, wd, D2, U2, b2, c2, X2, t2, Db, P, scale, M, s);
    else fdn::launch_tf_mse_t<FDN_N, 2, 64>(pv, wd, D2, U2, b2, c2, X2, t2, Db, P, scale, M, s);
  } else if (threads == 128) {
    if (reduce == 0) fdn::launch_tf_mse_t<FDN_N, 0, 128>(pv, wd, D2, U2, b2, c2, X2, t2, Db, P, scale, M, s);
    else if (reduce == 1) fdn::launch_tf_mse_t<FDN_N, 1, 128>(pv, wd, D2, U2, b2, c2, X2, t2, Db, P, scale, M, s);
    else fdn::launch_tf_mse_t<FDN_N, 2, 128>(pv, wd, D2, U2, b2, c2, X2, t2, Db, P, scale, M, s);
  } else {
    return fdn::kBadSize;
  }
  return static_cast<int>(cudaGetLastError());
#else
  return fdn::kBadSize;
#endif
}

// variants timed against each other: one thread a system, staged in
// blocks of 32 (0) or 128 (1); a group of lanes a system, staged (2); one
// thread a system loading its own system in blocks of 32 (3) or 64 (4)
int fdn_dense_solve_variant_launch(int N, int transpose, int variant, const void* A,
                                   const void* B, void* Y, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
  const bool tr = transpose != 0;
  const auto A2 = static_cast<const float2*>(A);
  const auto B2 = static_cast<const float2*>(B);
  const auto Y2 = static_cast<float2*>(Y);
  if (variant == 0) return fdn::launch_dense_solve_rows<FDN_N, 32>(tr, A2, B2, Y2, M, s);
#if FDN_N <= 8
  if (variant == 1) return fdn::launch_dense_solve_rows<FDN_N, 128>(tr, A2, B2, Y2, M, s);
#endif
  if (variant == 2) return fdn::launch_dense_solve_group<FDN_N>(tr, A2, B2, Y2, M, s);
  if (variant == 3) return fdn::launch_dense_solve_direct<FDN_N, 32>(tr, A2, B2, Y2, M, s);
  if (variant == 4) return fdn::launch_dense_solve_direct<FDN_N, 64>(tr, A2, B2, Y2, M, s);
  return fdn::kBadSize;
}

int fdn_tf_bwd_variant_launch(int N, int reduce, const void* D, const void* U, const void* b,
                              const void* c, const void* Y, const void* TFB, void* Dbar,
                              void* partials, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N != FDN_N) return fdn::kBadN;
#if FDN_N == 6
  const auto D2 = static_cast<const float2*>(D);
  const auto U2 = static_cast<const float*>(U);
  const auto b2 = static_cast<const float*>(b);
  const auto c2 = static_cast<const float*>(c);
  const auto Y2 = static_cast<const float2*>(Y);
  const auto T2 = static_cast<const float2*>(TFB);
  const auto Db = static_cast<float2*>(Dbar);
  const auto P = static_cast<float*>(partials);
  if (reduce == 0) fdn::launch_tf_bwd_t<FDN_N, 0>(D2, U2, b2, c2, Y2, T2, Db, P, M, s);
  else if (reduce == 1) fdn::launch_tf_bwd_t<FDN_N, 1>(D2, U2, b2, c2, Y2, T2, Db, P, M, s);
  else fdn::launch_tf_bwd_t<FDN_N, 2>(D2, U2, b2, c2, Y2, T2, Db, P, M, s);
  return static_cast<int>(cudaGetLastError());
#else
  return fdn::kBadSize;
#endif
}

// the launch floor's yardsticks: 0 the empty kernel, 1 one load and one store
int fdn_floor_launch(int which, const void* src, void* dst, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  fdn::launch_floor(which, static_cast<const float2*>(src), static_cast<float2*>(dst), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
