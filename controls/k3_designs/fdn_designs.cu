// Candidate designs of K3f (fdn_tf_fwd_kernel, the FDN transfer function)
// and K3b (fdn_tf_bwd_kernel, its VJP), timed by
// controls/k3_designs/time_designs.py beside the package's and the
// previous library's (controls/fdn_tf_prev): one thread a bin, every
// one's values and pivots ge_pivot's.  fdn_ge.cuh here is a copy of the
// package's.
//
// tf_fwd_design_kernel<N, PIV, SHARED, VEC, LINES>:
//   PIV 0: ge_pivot, its selects and swaps at every step;
//   PIV 2: ge_pivot_voted, a vote a candidate row;
//   SHARED: U, b and c staged in shared memory once a block (else __ldg);
//   VEC: a bin's rows of D and Y moved as float4s (else float2s);
//   LINES 1: Y parked in shared memory and stored by the warp as whole
//            128-byte lines (lane l stores float4s l + 32 k of the warp's
//            span of 32 rows), else each bin's row from its own thread;
//   LINES 2: D also loaded so into shared memory, each thread then
//            reading its row there.
// design -> (PIV, SHARED, VEC, LINES):
//   0: (0, no, no, 0)    the previous kernel's choices, masked lanes kept
//   1: (0, yes, yes, 0)
//   2: (2, no, no, 0)
//   3: (2, yes, no, 0)
//   4: (2, yes, yes, 0)  the first redesign
//   5: (2, yes, yes, 1)  the package's kernel
//   6: (2, yes, yes, 2)
//
// tf_bwd_design_kernel<N, PIV, SHARED, VEC, THREADS, LINES>: PIV, SHARED
// as above (SHARED: the cotangents read U and b there too), VEC the rows
// of D, Y and D_bar, THREADS the bins a block (the block sums are K1's
// recursive halvings, a partials row a block), LINES 1 D_bar stored as
// whole lines, LINES 2 also D and Y loaded so.
// design -> (PIV, SHARED, VEC, THREADS, LINES):
//   0: (0, no, no, 128, 0)   the previous kernel's choices
//   1: (0, yes, yes, 128, 0)
//   2: (2, no, no, 128, 0)
//   3: (2, yes, no, 128, 0)
//   4: (2, yes, yes, 128, 0) the first redesign
//   5: (2, yes, yes, 64, 0)
//   6: (2, yes, yes, 128, 1) the package's kernel
//   7: (2, yes, yes, 128, 2)

#include <cstddef>

#include "fdn_ge.cuh"

#ifndef FDN_N
#error "compile with -DFDN_N=<channel count>"
#endif

namespace fdn {

constexpr int kBadDesign = -1;

template <bool SHARED>
__device__ __forceinline__ float rd(const float* __restrict__ p, int i) {
  if constexpr (SHARED)
    return p[i];
  else
    return __ldg(p + i);
}

template <int N, int PIV>
__device__ __forceinline__ void eliminate(float2 (&A)[N][N], float2 (&rhs)[N], float2 (&y)[N]) {
  if constexpr (PIV == 0)
    ge_pivot<N>(A, rhs, y);
  else
    ge_pivot_voted<N>(A, rhs, y);
}

template <int N, bool VEC>
__device__ __forceinline__ void load_v(const float2* __restrict__ p, bool live, float2 (&v)[N]) {
  if constexpr (VEC) {
    load_row<N>(p, live, v);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = load_or_zero(p + i, live);
  }
}

template <int N, bool VEC>
__device__ __forceinline__ void store_v(float2* __restrict__ p, const float2 (&v)[N]) {
  if constexpr (VEC) {
    store_row<N>(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N, int THREADS>
__device__ __forceinline__ void stage(const float* __restrict__ U, const float* __restrict__ b,
                                      const float* __restrict__ c, float* sU, float* sb,
                                      float* sc) {
  for (int v = threadIdx.x; v < N * N; v += THREADS) sU[v] = __ldg(U + v);
  if (threadIdx.x < N) {
    sb[threadIdx.x] = __ldg(b + threadIdx.x);
    sc[threadIdx.x] = __ldg(c + threadIdx.x);
  }
}

// A warp's span of 32 bins' rows (N even: 16 N float4s) in shared
// memory, moved to or from global memory as whole lines: lane l moves
// float4s l, l + 32, ..., only those of bins below M.  ``first`` is the
// warp's first bin.
template <int N>
__device__ __forceinline__ void span_load(const float2* __restrict__ g, int first, int M,
                                          float4* span) {
  const int lane = threadIdx.x & 31;
  const int n4 = max(0, min(32, M - first)) * (N / 2);
  const float4* src = reinterpret_cast<const float4*>(g + static_cast<size_t>(first) * N);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int k = lane + 32 * j;
    if (k < n4) span[k] = src[k];
  }
  __syncwarp();
}

template <int N>
__device__ __forceinline__ void span_store(float2* __restrict__ g, int first, int M,
                                           const float4* span) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int n4 = max(0, min(32, M - first)) * (N / 2);
  float4* dst = reinterpret_cast<float4*>(g + static_cast<size_t>(first) * N);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int k = lane + 32 * j;
    if (k < n4) dst[k] = span[k];
  }
}

template <int N>
__device__ __forceinline__ void row_to_span(float4* span, const float2 (&v)[N]) {
  float4* mine = span + (threadIdx.x & 31) * (N / 2);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    mine[i] = make_float4(v[2 * i].x, v[2 * i].y, v[2 * i + 1].x, v[2 * i + 1].y);
}

template <int N>
__device__ __forceinline__ void row_from_span(const float4* span, bool live, float2 (&v)[N]) {
  const float4* mine = span + (threadIdx.x & 31) * (N / 2);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float4 q = live ? mine[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[2 * i] = make_float2(q.x, q.y);
    v[2 * i + 1] = make_float2(q.z, q.w);
  }
}

template <int N, int PIV, bool SHARED, bool VEC, int LINES>
__global__ void __launch_bounds__(kThreads)
    tf_fwd_design_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                         const float* __restrict__ b, const float* __restrict__ c,
                         float2* __restrict__ TF, float2* __restrict__ Y, int M) {
  static_assert(!LINES || N % 2 == 0, "whole float4 rows only");
  __shared__ float sU[N * N], sb[N], sc[N];
  __shared__ float4 sY[LINES ? kThreads * N / 2 : 1];
  if (SHARED) stage<N, kThreads>(U, b, c, sU, sb, sc);
  const float* Uu = SHARED ? sU : U;
  const float* bu = SHARED ? sb : b;
  const float* cu = SHARED ? sc : c;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const size_t row = static_cast<size_t>(live ? m : 0) * N;
  const int first = m - (threadIdx.x & 31);  // the warp's first bin
  float4* span = sY + (LINES ? (threadIdx.x >> 5) * (32 * N / 2) : 0);
  float2 d[N], rhs[N], y[N];
  if constexpr (LINES == 2) {
    span_load<N>(D, first, M, span);
    row_from_span<N>(span, live, d);
    __syncwarp();
  } else {
    load_v<N, VEC>(D + row, live, d);
  }
  if (SHARED) __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float bi = rd<SHARED>(bu, i);
    rhs[i] = make_float2(d[i].x * bi, d[i].y * bi);
  }
  float2 A[N][N];
  assemble<N, false, SHARED>(d, Uu, A);
  eliminate<N, PIV>(A, rhs, y);
  float2 tf = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ci = rd<SHARED>(cu, i);
    tf.x += ci * y[i].x;
    tf.y += ci * y[i].y;
  }
  if constexpr (LINES != 0) {
    row_to_span<N>(span, y);
    span_store<N>(Y, first, M, span);
    if (live) TF[m] = tf;
  } else if (live) {
    store_v<N, VEC>(Y + row, y);
    TF[m] = tf;
  }
}

template <int NV, int THREADS>
__device__ __forceinline__ void block_store_t(float (*red)[NV], float* __restrict__ row) {
  __syncthreads();
  for (int v = threadIdx.x; v < NV; v += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][v];
    row[v] = s;
  }
}

template <int N, int PIV, bool SHARED, bool VEC, int THREADS, int LINES>
__global__ void __launch_bounds__(THREADS)
    tf_bwd_design_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                         const float* __restrict__ b, const float* __restrict__ c,
                         const float2* __restrict__ Y, const float2* __restrict__ TFB,
                         float2* __restrict__ Dbar, float* __restrict__ partials, int M) {
  static_assert(!LINES || N % 2 == 0, "whole float4 rows only");
  constexpr int NV = n_partials(N);
  __shared__ float red[THREADS / 32][NV];
  __shared__ float sU[N * N], sb[N], sc[N];
  __shared__ float4 sD[LINES ? THREADS * N / 2 : 1];
  __shared__ float4 sY[LINES == 2 ? THREADS * N / 2 : 1];
  if (SHARED) stage<N, THREADS>(U, b, c, sU, sb, sc);
  const float* Uu = SHARED ? sU : U;
  const float* bu = SHARED ? sb : b;
  const float* cu = SHARED ? sc : c;
  const int m = blockIdx.x * THREADS + threadIdx.x;
  const bool live = m < M;
  const size_t row = static_cast<size_t>(live ? m : 0) * N;
  const int first = m - (threadIdx.x & 31);  // the warp's first bin
  float4* spanD = sD + (LINES ? (threadIdx.x >> 5) * (32 * N / 2) : 0);
  float4* spanY = sY + (LINES == 2 ? (threadIdx.x >> 5) * (32 * N / 2) : 0);
  float2 d[N], y[N], cc[N], w[N];
  if constexpr (LINES == 2) {
    span_load<N>(D, first, M, spanD);
    span_load<N>(Y, first, M, spanY);
    row_from_span<N>(spanD, live, d);
    row_from_span<N>(spanY, live, y);
    __syncwarp();
  } else {
    load_v<N, VEC>(D + row, live, d);
    load_v<N, VEC>(Y + row, live, y);
  }
  const float2 tb = load_or_zero(TFB + (live ? m : 0), live);
  if (SHARED) __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) cc[i] = make_float2(rd<SHARED>(cu, i), 0.0f);
  float2 At[N][N];
  assemble<N, true, SHARED>(d, Uu, At);
  eliminate<N, PIV>(At, cc, w);
  // fdn_ge.cuh's cotangents with the D_bar row store of VEC and the block
  // sums of THREADS
  float v[NV];
  float2 dbar[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float2 bb = cmul(tb, w[i]);
    float ur = 0.0f, ui = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float u = rd<SHARED>(Uu, i * N + j);
      ur += u * y[j].x;
      ui += u * y[j].y;
    }
    dbar[i] = cmul(bb, make_float2(ur + rd<SHARED>(bu, i), ui));
    const float2 bbD = cmul(bb, d[i]);
    v[N * N + i] = bbD.x;
    v[N * N + N + i] = cmul(tb, y[i]).x;
#pragma unroll
    for (int j = 0; j < N; ++j) v[i * N + j] = cmul(bbD, y[j]).x;
  }
  if constexpr (LINES != 0) {
    row_to_span<N>(spanD, dbar);
    span_store<N>(Dbar, first, M, spanD);
  } else if (live) {
    store_v<N, VEC>(Dbar + row, dbar);
  }
  v[NV - 1] = 0.0f;
  warp_sums<NV>(v, red);
  block_store_t<NV, THREADS>(red, partials + static_cast<size_t>(blockIdx.x) * NV);
}

inline unsigned blocks(int M, int threads) {
  return static_cast<unsigned>((M + threads - 1) / threads);
}

template <int PIV, bool SH, bool VEC, int LINES>
void fwd(const float2* D, const float* U, const float* b, const float* c, float2* TF, float2* Y,
         int M, cudaStream_t s) {
  tf_fwd_design_kernel<FDN_N, PIV, SH, VEC, LINES>
      <<<blocks(M, kThreads), kThreads, 0, s>>>(D, U, b, c, TF, Y, M);
}

template <int PIV, bool SH, bool VEC, int THREADS, int LINES>
void bwd(const float2* D, const float* U, const float* b, const float* c, const float2* Y,
         const float2* TFB, float2* Dbar, float* partials, int M, cudaStream_t s) {
  tf_bwd_design_kernel<FDN_N, PIV, SH, VEC, THREADS, LINES>
      <<<blocks(M, THREADS), THREADS, 0, s>>>(D, U, b, c, Y, TFB, Dbar, partials, M);
}

}  // namespace fdn

extern "C" {

// bins a block of K3b design ``design`` (its partials rows: one a block)
int tf_bwd_design_threads(int design) { return design == 5 ? 64 : fdn::kThreads; }

int tf_fwd_design_launch(int design, int N, const void* D, const void* U, const void* b,
                         const void* c, void* TF, void* Y, int M, void* stream) {
  using namespace fdn;
  if (N != FDN_N) return kBadDesign;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float2*>(D);
  const auto u = static_cast<const float*>(U);
  const auto bb = static_cast<const float*>(b);
  const auto cc = static_cast<const float*>(c);
  const auto tf = static_cast<float2*>(TF);
  const auto y = static_cast<float2*>(Y);
  switch (design) {
    case 0: fwd<0, false, false, 0>(d, u, bb, cc, tf, y, M, s); break;
    case 1: fwd<0, true, true, 0>(d, u, bb, cc, tf, y, M, s); break;
    case 2: fwd<2, false, false, 0>(d, u, bb, cc, tf, y, M, s); break;
    case 3: fwd<2, true, false, 0>(d, u, bb, cc, tf, y, M, s); break;
    case 4: fwd<2, true, true, 0>(d, u, bb, cc, tf, y, M, s); break;
    case 5: fwd<2, true, true, 1>(d, u, bb, cc, tf, y, M, s); break;
    case 6: fwd<2, true, true, 2>(d, u, bb, cc, tf, y, M, s); break;
    default: return kBadDesign;
  }
  return static_cast<int>(cudaGetLastError());
}

int tf_bwd_design_launch(int design, int N, const void* D, const void* U, const void* b,
                         const void* c, const void* Y, const void* TFB, void* Dbar,
                         void* partials, int M, void* stream) {
  using namespace fdn;
  if (N != FDN_N) return kBadDesign;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto d = static_cast<const float2*>(D);
  const auto u = static_cast<const float*>(U);
  const auto bb = static_cast<const float*>(b);
  const auto cc = static_cast<const float*>(c);
  const auto y = static_cast<const float2*>(Y);
  const auto tb = static_cast<const float2*>(TFB);
  const auto db = static_cast<float2*>(Dbar);
  const auto p = static_cast<float*>(partials);
  switch (design) {
    case 0: bwd<0, false, false, 128, 0>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 1: bwd<0, true, true, 128, 0>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 2: bwd<2, false, false, 128, 0>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 3: bwd<2, true, false, 128, 0>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 4: bwd<2, true, true, 128, 0>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 5: bwd<2, true, true, 64, 0>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 6: bwd<2, true, true, 128, 1>(d, u, bb, cc, y, tb, db, p, M, s); break;
    case 7: bwd<2, true, true, 128, 2>(d, u, bb, cc, y, tb, db, p, M, s); break;
    default: return kBadDesign;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
