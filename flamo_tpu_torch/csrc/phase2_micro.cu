// Hand-written Hopper (sm_90a) kernels of the phase-2 micro-benchmark K10,
// with a plain C interface that flamo_tpu_torch/ops/phase2_micro.py loads
// through ctypes.  The entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError(), or kBadSize (-2) for
// a variant, sizes or a pass plan out of the limits below.
//
// Kernels and the TPU kernel they replace: the four variants of _kernel in
// scripts/bench_phase2_micro.py (pallas_call at :149), which isolate the
// tap-cotangent phase of K5 (_fdn_sos_tf_mse_kernel; sos_kernels.cu's
// tap_partials):
//   phase2_full_kernel<P>     <- 'full'
//   phase2_noreduce_kernel<P> <- 'noreduce'
//   phase2_lanered_kernel<P>  <- 'lanered'
//   phase2_ps_kernel<P>       <- 'ps'
//
// t is (2, M) float32 (re row, then im row); taps c (P, K, N) float32,
// row-major; z = e^{-j w}, w = (2 pi / nfft) m, and tn = t[0, m] + j t[1, m]
// for bin m.  Section pass s (0 <= s < S = 2 K N) takes the taps
// c[:, s % K, s % N] (the TPU kernel's indexing: where gcd(K, N) > 1 it
// revisits some (k, n) pairs and skips others), sec = sum_p c[p] z^p and
// q = tn conj(sec) / |sec|^2, 0 where |sec|^2 = 0.  Each block writes one
// row of 3 partial sums; the wrapper adds the rows with torch.sum.  No
// atomics: two runs give the same partials.  Threads m >= M run with
// tn = 0, so they add exactly 0, and take part in the warp shuffles.
// Every variant projects q on z^0, z^1 and z^2, as the TPU kernel does
// (its zs = [z, z^2]), whatever P.
//
// full, noreduce and lanered share one body (pass_sums<P, V>).  The passes
// repeat with period L = lcm(K, N), each repeat giving the same q, so they
// run the L distinct passes once and scale by r = 2 K N / L (the wrapper's
// pass plan: passes, scale).  A thread takes one bin and a group of
// kGroupPasses passes; the groups lie side by side in the grid, each block
// staging its group's taps in shared memory.  The sums are linear in q =
// tn u, u = conj(sec) / |sec|^2:
//   full:     [sum Re q, sum Re q z, sum Re q z^2].  A thread adds
//             W = sum u over its passes in registers, forms Q = tn W r and
//             its three projections once, and the block reduces them once
//             into its row.
//   noreduce: [sum Re q, sum Re q z + sum Re q z^2, 0]: as full, per-bin
//             running sums over every pass and no reduction before the one
//             block sum, of two values (Re Q, Re Q z + Re Q z^2) and a 0.
//   lanered:  [T, T, T], T = the sum of full's three = sum Re(u tz) with
//             tz = tn (1 + z + z^2) formed once a bin: one warp tree a pass
//             on Re(u tz), lane 0 adding it to its warp's slot in shared
//             memory, and the cross-warp sum deferred to the end, scaled
//             by r (the benchmark's measure of a reduction a pass).
//   ps:       as full, over every (k, n) pair: a thread takes one bin and
//             one channel n (the channels side by side in the grid, a
//             block's K sections' taps staged), forms each section's
//             response sec_k once, the prefix products pre_k, one guarded
//             quotient of the product, and the suffix products from the
//             last section down, adding pre_k suf_{k+1}; its two passes
//             over k (the b-tap and a-tap passes) are the same, so it runs
//             one and scales by 2 (the plan's scale).
//
// What bounds them on an H100: arithmetic and, at these sizes, the launch.
// full at K = 12, N = 6 needs 12 distinct passes a bin (~22 FLOP each:
// Horner 14, |sec|^2 3, the reciprocal, its conjugate product and the sum
// of W) against 8 bytes of t; ps ~430 FLOP a bin and channel.  The kernels
// before this design (controls/phase2_micro_prev) ran one thread a bin
// over all 144 passes, with a runtime P reading the taps through L1, q
// formed and projected every pass, and full's three warp trees a pass.
// P is a template argument of every kernel (2..8), so Horner unrolls and
// reads the staged taps at fixed offsets; K stays a runtime bound under a
// guarded unroll to kRegK in ps, whose products live in registers.

#include <cstddef>

#include "sos_common.cuh"

namespace p2 {

using sos::cabs2;
using sos::cmul;
using sos::kThreads;
using sos::kWarps;

constexpr int kBadSize = -2;
constexpr int kOut = 3;           // sums per block row: projections on z^0, z^1, z^2
constexpr int kRegK = 16;         // ps keeps its products in registers up to here
constexpr int kGroupPasses = 12;  // full, noreduce, lanered: distinct passes a thread
enum Variant { kFull = 0, kNoreduce = 1, kLanered = 2, kPs = 3 };

// tn conj(sec) / |sec|^2, 0 where |sec|^2 = 0
__device__ __forceinline__ float2 quotient(float2 tn, float2 sec) {
  const float d = cabs2(sec);
  const bool ok = d > 0.0f;
  const float inv = 1.0f / (ok ? d : 1.0f);
  return ok ? make_float2((tn.x * sec.x + tn.y * sec.y) * inv, (tn.y * sec.x - tn.x * sec.y) * inv)
            : make_float2(0.0f, 0.0f);
}

// conj(sec) / |sec|^2, 0 where |sec|^2 = 0: the quotient of tn = 1
__device__ __forceinline__ float2 inv_conj(float2 sec) {
  const float d = cabs2(sec);
  const bool ok = d > 0.0f;
  const float inv = 1.0f / (ok ? d : 1.0f);
  return ok ? make_float2(sec.x * inv, -sec.y * inv) : make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float2 bin_tn(const float* __restrict__ t, int m, int M) {
  return m < M ? make_float2(__ldg(t + m), __ldg(t + M + m)) : make_float2(0.0f, 0.0f);
}

// sum_p taps[p] z^p by Horner from the top tap, P known at compile time
template <int P>
__device__ __forceinline__ float2 horner_c(const float* taps, float2 z) {
  float2 out = make_float2(taps[P - 1], 0.0f);
#pragma unroll
  for (int p = P - 2; p >= 0; --p) {
    out = cmul(out, z);
    out.x += taps[p];
  }
  return out;
}

// A thread's (re, im) sum Q scaled by r, projected on z^0, z^1, z^2 and
// summed over the block into its row (one warp tree a value, once): full
// and ps (Re Q, Re Q z, Re Q z^2), noreduce (Re Q, Re Q z + Re Q z^2, 0),
// its 0 parked by lane 0 in the warp's row (0.05-0.06 us faster than a
// 2-wide row with the 0 stored apart in controls/k10_nl_designs).
template <int V = kFull>
__device__ __forceinline__ void put_row(float* red, float2 q, float r, float2 z,
                                        float* __restrict__ row) {
  q = make_float2(q.x * r, q.y * r);
  const float2 z2 = cmul(z, z);
  sos::put(red, kOut, 0, q.x);
  if constexpr (V == kNoreduce) {
    sos::put(red, kOut, 1, (q.x * z.x - q.y * z.y) + (q.x * z2.x - q.y * z2.y));
    if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * kOut + 2] = 0.0f;
  } else {
    sos::put(red, kOut, 1, q.x * z.x - q.y * z.y);
    sos::put(red, kOut, 2, q.x * z2.x - q.y * z2.y);
  }
  sos::store_row(red, kOut, row);
}

__host__ __device__ inline int n_blocks(int M) { return (M + kThreads - 1) / kThreads; }

// The body of full, noreduce and lanered (V).  Blocks are (pass group g,
// bin block) with the bin blocks fastest.
template <int P, int V>
__device__ __forceinline__ void pass_sums(const float* __restrict__ t,
                                          const float* __restrict__ c,
                                          float* __restrict__ partials, int M, int K, int N,
                                          int passes, float scale, float w_scale) {
  __shared__ float taps[kGroupPasses * P];
  __shared__ float red[kWarps * kOut];
  const int nbx = n_blocks(M);
  const int g = blockIdx.x / nbx;
  const int m = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  const int s0 = g * kGroupPasses;
  const int ns = min(kGroupPasses, passes - s0);
  float* const row = partials + static_cast<size_t>(blockIdx.x) * kOut;
  if (threadIdx.x < ns * P) {
    const int s = s0 + threadIdx.x / P, p = threadIdx.x % P;
    taps[threadIdx.x] = __ldg(c + (p * K + s % K) * N + s % N);
  }
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  if constexpr (V == kLanered) {
    // Re q + Re q z + Re q z^2 = Re(u tz), tz = tn (1 + z + z^2); lane 0
    // zeroes its warp's slot (only it touches the slot until the end)
    const float2 z2 = cmul(z, z);
    const float2 tz = cmul(tn, make_float2(1.0f + z.x + z2.x, z.y + z2.y));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = 0.0f;
    __syncthreads();
    for (int j = 0; j < ns; ++j) {
      const float2 u = inv_conj(horner_c<P>(taps + j * P, z));
      sos::put(red, 1, 0, u.x * tz.x - u.y * tz.y, true);
    }
    __syncthreads();
    if (threadIdx.x < kOut) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w];
      row[threadIdx.x] = sum * scale;
    }
  } else {
    __syncthreads();
    // a runtime loop, as in the fastest design (controls/k10_designs): the
    // loop unrolled over kGroupPasses measured 0.1-0.3 us slower
    float2 w = make_float2(0.0f, 0.0f);
    for (int j = 0; j < ns; ++j) {
      const float2 v = inv_conj(horner_c<P>(taps + j * P, z));
      w.x += v.x;
      w.y += v.y;
    }
    put_row<V>(red, cmul(tn, w), scale, z, row);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    phase2_full_kernel(const float* __restrict__ t, const float* __restrict__ c,
                       float* __restrict__ partials, int M, int K, int N, int passes,
                       float scale, float w_scale) {
  pass_sums<P, kFull>(t, c, partials, M, K, N, passes, scale, w_scale);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    phase2_noreduce_kernel(const float* __restrict__ t, const float* __restrict__ c,
                           float* __restrict__ partials, int M, int K, int N, int passes,
                           float scale, float w_scale) {
  pass_sums<P, kNoreduce>(t, c, partials, M, K, N, passes, scale, w_scale);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    phase2_lanered_kernel(const float* __restrict__ t, const float* __restrict__ c,
                          float* __restrict__ partials, int M, int K, int N, int passes,
                          float scale, float w_scale) {
  pass_sums<P, kLanered>(t, c, partials, M, K, N, passes, scale, w_scale);
}

// Every loop over k is unrolled over kRegK with a k < K guard, so sec[]
// and pre[] are indexed by constants and stay in registers.
template <int P>
__global__ void __launch_bounds__(kThreads)
    phase2_ps_kernel(const float* __restrict__ t, const float* __restrict__ c,
                     float* __restrict__ partials, int M, int K, int N, int passes,
                     float scale, float w_scale) {
  __shared__ float taps[kRegK * P];
  __shared__ float red[kWarps * kOut];
  const int nbx = n_blocks(M);
  const int n = blockIdx.x / nbx;
  const int m = (blockIdx.x - n * nbx) * kThreads + threadIdx.x;
  if (threadIdx.x < K * P) {
    const int k = threadIdx.x / P, p = threadIdx.x % P;
    taps[threadIdx.x] = __ldg(c + (p * K + k) * N + n);
  }
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  const float2 one = make_float2(1.0f, 0.0f);
  __syncthreads();
  float2 sec[kRegK], pre[kRegK];
  float2 prod = one;
#pragma unroll
  for (int k = 0; k < kRegK; ++k) {
    if (k < K) {
      pre[k] = prod;
      sec[k] = horner_c<P>(taps + k * P, z);
      prod = cmul(prod, sec[k]);
    }
  }
  // sum_k pre_k suf_{k+1}, suf_k = prod_{j >= k} sec_j from the last down
  float2 acc = make_float2(0.0f, 0.0f), suf = one;
#pragma unroll
  for (int k = kRegK - 1; k >= 0; --k) {
    if (k < K) {
      const float2 v = cmul(pre[k], suf);
      acc.x += v.x;
      acc.y += v.y;
      suf = cmul(suf, sec[k]);
    }
  }
  put_row(red, cmul(quotient(tn, prod), acc), scale, z,
          partials + static_cast<size_t>(blockIdx.x) * kOut);
}

inline int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// The pass plan the wrapper hands in: full, noreduce and lanered run
// `passes` passes, a multiple of lcm(K, N), scaled so that passes * scale
// = 2 K N; ps one pass over k scaled by 2.
inline bool plan_ok(int variant, int K, int N, int passes, float scale) {
  if (variant == kPs) return passes == 1 && scale == 2.0f;
  const long long S = 2LL * K * N;
  const long long L = static_cast<long long>(K) / gcd(K, N) * N;
  return passes >= 1 && passes % L == 0 && passes * static_cast<double>(scale) == S;
}

// Partial rows (= blocks) of a launch.
inline long long rows(int variant, int M, int N, int passes) {
  const long long nbx = n_blocks(M);
  if (variant == kPs) return nbx * N;
  return nbx * ((passes + kGroupPasses - 1) / kGroupPasses);
}

inline bool sizes_ok(int variant, int M, int P, int K, int N, int passes, float scale) {
  return variant >= kFull && variant <= kPs && M >= 1 && M <= 0x7fffffff - kThreads && P >= 2 &&
         P <= sos::kMaxP && K >= 1 && K <= (variant == kPs ? kRegK : sos::kMaxK) && N >= 1 &&
         2LL * K * N <= 0x7fffffffLL && plan_ok(variant, K, N, passes, scale) &&
         rows(variant, M, N, passes) <= 0x7fffffffLL;
}

// the four kernels' one signature (ps takes passes and ignores it)
using Kernel = void (*)(const float*, const float*, float*, int, int, int, int, float, float);

template <int P>
Kernel kernel_of(int variant) {
  switch (variant) {
    case kFull: return &phase2_full_kernel<P>;
    case kNoreduce: return &phase2_noreduce_kernel<P>;
    case kLanered: return &phase2_lanered_kernel<P>;
    default: return &phase2_ps_kernel<P>;
  }
}

// The kernel that variant launches at P taps (P in 2..kMaxP).
inline Kernel kernel_at(int variant, int P) {
  switch (P) {
    case 2: return kernel_of<2>(variant);
    case 3: return kernel_of<3>(variant);
    case 4: return kernel_of<4>(variant);
    case 5: return kernel_of<5>(variant);
    case 6: return kernel_of<6>(variant);
    case 7: return kernel_of<7>(variant);
    default: return kernel_of<8>(variant);
  }
}

}  // namespace p2

// One library for every size (P, K and N are runtime sizes; each variant
// has one copy a P); cuda_build builds it as the library of N = 1.
extern "C" {

int p2_threads_per_block() { return p2::kThreads; }

int p2_channels() { return 1; }

const char* p2_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// The partial rows of a launch (3 floats each), or kBadSize.
int p2_rows(int variant, int M, int P, int K, int N, int passes, float scale) {
  if (!p2::sizes_ok(variant, M, P, K, N, passes, scale)) return p2::kBadSize;
  return static_cast<int>(p2::rows(variant, M, N, passes));
}

// variant: 0 full, 1 noreduce, 2 lanered, 3 ps; (passes, scale) the
// wrapper's pass plan.  partials holds p2_rows(...) rows of 3 floats.
int p2_launch(int variant, const void* t, const void* c, void* partials, int M, int P, int K,
              int N, int passes, float scale, float w_scale, void* stream) {
  if (!p2::sizes_ok(variant, M, P, K, N, passes, scale)) return p2::kBadSize;
  const dim3 grid(static_cast<unsigned>(p2::rows(variant, M, N, passes))), block(p2::kThreads);
  const p2::Kernel kernel = p2::kernel_at(variant, P);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(c), static_cast<float*>(partials), M,
      K, N, passes, scale, w_scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local (spill) bytes of the kernel that variant
// launches at P taps, from cudaFuncGetAttributes; 0 or the CUDA error.
int p2_attributes(int variant, int P, int* registers, int* local_bytes) {
  if (P < 2 || P > sos::kMaxP || variant < p2::kFull || variant > p2::kPs) return p2::kBadSize;
  cudaFuncAttributes a;
  const cudaError_t rc =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(p2::kernel_at(variant, P)));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // extern "C"
