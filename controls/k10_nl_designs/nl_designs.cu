// Candidate designs of K10 'noreduce' and 'lanered' (the phase-2
// micro-benchmark's running-sum and per-pass-reduction kernels), timed by
// controls/k10_nl_designs/time_designs.py beside the package's kernels
// (flamo_tpu_torch/csrc/phase2_micro.cu) and the previous ones
// (controls/phase2_micro_prev).  Each design computes its variant's
// function as phase2_micro_plain defines it, from the same operands
// (t (2, M), taps c (P, K, N), row-major) into one row of 3 partial sums a
// block, in the previous kernels' frame: one thread a bin over every pass
// it runs, q = tn conj(sec) / |sec|^2 and its projections on z and z^2
// formed every pass; noreduce adds Re q to one running sum and
// Re q z + Re q z^2 to the other and reduces them once a block, lanered
// runs one warp tree a pass on the three's sum into its warp's slot in
// shared memory and sums the warps at the end.  The levers:
//
// nl_design_kernel<PC, LANERED>(..., passes, scale):
//   passes, scale  lever 1: the L = lcm(K, N) distinct passes scaled by
//                  2 K N / L, or all 2 K N passes scaled by 1;
//   PC             lever 2: 0 reads the taps through L1 with a runtime P
//                  (sos::horner), 3 stages every pass's taps in shared
//                  memory and unrolls Horner over P = 3.
//
// pkg_design_kernel<EPI>(..., passes, scale): the package's frame (a
// thread a bin and a group of up to 12 of the plan's passes, P = 3, taps
// staged, W = sum conj(sec) / |sec|^2 in registers, Q = tn W r) with the
// block sum as
//   EPI 0  full's: three values, a 3-wide row;
//   EPI 1  noreduce's: two values (Re Q, Re Q z + Re Q z^2), a 2-wide
//          row, thread 2 storing the 0 (the package's noreduce);
//   EPI 2  noreduce's two values and a warp tree of 0, a 3-wide row;
//   EPI 3  noreduce's two values into a 3-wide row whose third slot lane
//          0 zeroes.

#include <cstddef>

// controls/k10_designs/sos_common.cuh (time_designs.py passes -I)
#include "sos_common.cuh"

namespace k10nl {

using sos::cabs2;
using sos::cmul;
using sos::kThreads;
using sos::kWarps;

constexpr int kBadSize = -2;
constexpr int kOut = 3;
constexpr int kStage = 2048;  // staged taps a block (floats)

__device__ __forceinline__ float2 quotient(float2 tn, float2 sec) {
  const float d = cabs2(sec);
  const bool ok = d > 0.0f;
  const float inv = 1.0f / (ok ? d : 1.0f);
  return ok ? make_float2((tn.x * sec.x + tn.y * sec.y) * inv, (tn.y * sec.x - tn.x * sec.y) * inv)
            : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float2 bin_tn(const float* __restrict__ t, int m, int M) {
  return m < M ? make_float2(__ldg(t + m), __ldg(t + M + m)) : make_float2(0.0f, 0.0f);
}

// Horner at one section: PC = 0 reads c (global, stride apart) through L1
// with the runtime P; PC > 0 reads PC staged taps (shared, stride 1).
template <int PC>
__device__ __forceinline__ float2 section(const float* c, int stride, int P, float2 z) {
  if constexpr (PC == 0) {
    return sos::horner(c, stride, P, z);
  } else {
    float2 out = make_float2(c[PC - 1], 0.0f);
#pragma unroll
    for (int p = PC - 2; p >= 0; --p) {
      out = cmul(out, z);
      out.x += c[p];
    }
    return out;
  }
}

__device__ __forceinline__ float2 inv_conj(float2 sec) {
  const float d = cabs2(sec);
  const bool ok = d > 0.0f;
  const float inv = 1.0f / (ok ? d : 1.0f);
  return ok ? make_float2(sec.x * inv, -sec.y * inv) : make_float2(0.0f, 0.0f);
}

__host__ __device__ inline int n_blocks(int M) { return (M + kThreads - 1) / kThreads; }

constexpr int kGroup = 12;  // pkg_design_kernel: passes a thread

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    pkg_design_kernel(const float* __restrict__ t, const float* __restrict__ c,
                      float* __restrict__ partials, int M, int K, int N, int passes, float scale,
                      float w_scale) {
  constexpr int P = 3;
  __shared__ float taps[kGroup * P];
  __shared__ float red[kWarps * kOut];
  const int nbx = n_blocks(M);
  const int g = blockIdx.x / nbx;
  const int m = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  const int s0 = g * kGroup;
  const int ns = min(kGroup, passes - s0);
  float* const row = partials + static_cast<size_t>(blockIdx.x) * kOut;
  if (threadIdx.x < ns * P) {
    const int s = s0 + threadIdx.x / P, p = threadIdx.x % P;
    taps[threadIdx.x] = __ldg(c + (p * K + s % K) * N + s % N);
  }
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  __syncthreads();
  float2 w = make_float2(0.0f, 0.0f);
  for (int j = 0; j < ns; ++j) {
    const float2 v = inv_conj(section<P>(taps + j * P, 1, P, z));
    w.x += v.x;
    w.y += v.y;
  }
  float2 q = cmul(tn, w);
  q = make_float2(q.x * scale, q.y * scale);
  const float2 z2 = cmul(z, z);
  const float p1 = q.x * z.x - q.y * z.y, p2 = q.x * z2.x - q.y * z2.y;
  if constexpr (EPI == 0) {
    sos::put(red, kOut, 0, q.x);
    sos::put(red, kOut, 1, p1);
    sos::put(red, kOut, 2, p2);
    sos::store_row(red, kOut, row);
  } else if constexpr (EPI == 1) {
    sos::put(red, 2, 0, q.x);
    sos::put(red, 2, 1, p1 + p2);
    sos::store_row(red, 2, row);
    if (threadIdx.x == 2) row[2] = 0.0f;
  } else {
    sos::put(red, kOut, 0, q.x);
    sos::put(red, kOut, 1, p1 + p2);
    if constexpr (EPI == 2)
      sos::put(red, kOut, 2, 0.0f);
    else if ((threadIdx.x & 31) == 0)
      red[(threadIdx.x >> 5) * kOut + 2] = 0.0f;
    sos::store_row(red, kOut, row);
  }
}

template <int PC, bool LANERED>
__global__ void __launch_bounds__(kThreads)
    nl_design_kernel(const float* __restrict__ t, const float* __restrict__ c,
                     float* __restrict__ partials, int M, int P, int K, int N, int passes,
                     float scale, float w_scale) {
  __shared__ float taps[kStage];
  __shared__ float red[kWarps * kOut];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (PC > 0) {
    for (int i = threadIdx.x; i < passes * PC; i += kThreads) {
      const int s = i / PC, p = i % PC;
      taps[i] = __ldg(c + (p * K + s % K) * N + s % N);
    }
  }
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  if (LANERED && (threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = 0.0f;
  if constexpr (PC > 0) __syncthreads();
  float accr = 0.0f, acci = 0.0f;
  for (int s = 0, k = 0, n = 0; s < passes; ++s) {
    float2 sec;
    if constexpr (PC > 0)
      sec = section<PC>(taps + s * PC, 1, PC, z);
    else
      sec = section<0>(c + k * N + n, K * N, P, z);
    float2 q = quotient(tn, sec);
    float v = q.x, vi = 0.0f;
#pragma unroll
    for (int p = 1; p < kOut; ++p) {
      q = cmul(q, z);
      if constexpr (LANERED)
        v += q.x;
      else
        vi += q.x;
    }
    if constexpr (LANERED) {
      sos::put(red, 1, 0, v, true);
    } else {
      accr += v;
      acci += vi;
    }
    k = k + 1 == K ? 0 : k + 1;
    n = n + 1 == N ? 0 : n + 1;
  }
  float* const row = partials + static_cast<size_t>(blockIdx.x) * kOut;
  if constexpr (LANERED) {
    __syncthreads();
    if (threadIdx.x < kOut) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w];
      row[threadIdx.x] = sum * scale;
    }
  } else {
    sos::put(red, 2, 0, accr * scale);
    sos::put(red, 2, 1, acci * scale);
    sos::store_row(red, 2, row);
    if (threadIdx.x == 2) row[2] = 0.0f;
  }
}

}  // namespace k10nl

extern "C" {

// Rows (= blocks) of a design launch: one a 128-bin block.
long long nl_design_rows(int M) { return k10nl::n_blocks(M); }

// pc: 0 (runtime P through L1) or 3 (P = 3, staged taps); lanered: 0
// noreduce, 1 lanered.
int nl_design_launch(int pc, int lanered, const void* t, const void* c, void* partials, int M,
                     int P, int K, int N, int passes, float scale, float w_scale, void* stream) {
  if ((pc != 0 && pc != 3) || (pc != 0 && pc != P) || passes < 1 ||
      (pc && passes * pc > k10nl::kStage) || P < 2 || P > sos::kMaxP || M < 1)
    return k10nl::kBadSize;
  const auto* tt = static_cast<const float*>(t);
  const auto* cc = static_cast<const float*>(c);
  auto* out = static_cast<float*>(partials);
  const dim3 grid(static_cast<unsigned>(nl_design_rows(M))), block(k10nl::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
#define K10NL(PCV, LR)                                                                          \
  if (pc == PCV && lanered == LR) {                                                             \
    k10nl::nl_design_kernel<PCV, LR>                                                            \
        <<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, passes, scale, w_scale);               \
    return static_cast<int>(cudaGetLastError());                                                \
  }
  K10NL(0, false) K10NL(0, true) K10NL(3, false) K10NL(3, true)
#undef K10NL
  return k10nl::kBadSize;
}

// Rows of a pkg design launch: bin blocks x pass groups.
long long pkg_design_rows(int M, int passes) {
  const long long groups = (passes + k10nl::kGroup - 1) / k10nl::kGroup;
  return static_cast<long long>(k10nl::n_blocks(M)) * groups;
}

// epi: 0..3 (above); P = 3 only.
int pkg_design_launch(int epi, const void* t, const void* c, void* partials, int M, int P, int K,
                      int N, int passes, float scale, float w_scale, void* stream) {
  if (P != 3 || passes < 1 || M < 1) return k10nl::kBadSize;
  const auto* tt = static_cast<const float*>(t);
  const auto* cc = static_cast<const float*>(c);
  auto* out = static_cast<float*>(partials);
  const dim3 grid(static_cast<unsigned>(pkg_design_rows(M, passes))), block(k10nl::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
#define K10PKG(E)                                                                               \
  if (epi == E) {                                                                               \
    k10nl::pkg_design_kernel<E><<<grid, block, 0, s>>>(tt, cc, out, M, K, N, passes, scale,     \
                                                       w_scale);                                \
    return static_cast<int>(cudaGetLastError());                                                \
  }
  K10PKG(0) K10PKG(1) K10PKG(2) K10PKG(3)
#undef K10PKG
  return k10nl::kBadSize;
}

}  // extern "C"
