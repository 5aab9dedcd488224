// Hand-written Hopper (sm_90a) kernels of the phase-2 micro-benchmark K10,
// with a plain C interface that flamo_tpu_torch/ops/phase2_micro.py loads
// through ctypes.  The entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError(), or kBadSize (-2) for
// a variant or sizes out of the limits below.
//
// Kernels and the TPU kernel they replace: the four variants of _kernel in
// scripts/bench_phase2_micro.py (pallas_call at :149), which isolate the
// tap-cotangent phase of K5 (_fdn_sos_tf_mse_kernel; sos_kernels.cu's
// tap_partials):
//   phase2_full_kernel     <- 'full'
//   phase2_noreduce_kernel <- 'noreduce'
//   phase2_lanered_kernel  <- 'lanered'
//   phase2_ps_kernel       <- 'ps'
//
// One thread per bin m of t (2, M) float32 (re row, then im row); taps c
// (P, K, N) float32, row-major; z = e^{-j w}, w = (2 pi / nfft) m, and
// tn = t[0, m] + j t[1, m].  Section pass s (0 <= s < S = 2 K N) takes the
// taps c[:, s % K, s % N] (the TPU kernel's indexing: where gcd(K, N) > 1
// it revisits some (k, n) pairs and skips others), sec = sum_p c[p] z^p and
// q = tn conj(sec) / |sec|^2, 0 where |sec|^2 = 0.  Each block writes one
// row of partial sums; the wrapper adds the rows with torch.sum.  No
// atomics: two runs give the same partials.  Threads m >= M run with
// tn = 0, so they add exactly 0, and take part in the warp shuffles.
// Every variant projects q on z^0, z^1 and z^2, as the TPU kernel does
// (its zs = [z, z^2]), whatever P; each writes a row of 3 per block.
//
//   full:     [sum Re q, sum Re q z, sum Re q z^2]; per pass 3 warp
//             shuffle trees, the warp's sums added by lane 0 into its
//             shared-memory row, the cross-warp sum deferred to the end
//             (K5's pattern: 3 S trees per warp).
//   noreduce: [sum Re q, sum Re q z + sum Re q z^2, 0]; two register
//             accumulators per thread over all S passes, one block
//             reduction at the end.
//   lanered:  [T, T, T], T = the sum of full's three; one warp tree per
//             pass on the pass's summed value, the cross-warp sum deferred.
//   ps:       as full, over every (k, n) pair: per channel n the prefix
//             and suffix products of its K <= kRegK sections in registers
//             (2 (K + 1) complex values), one guarded quotient of the
//             product, and for two passes over k, q = tp pre_k suf_{k+1}
//             with 3 warp trees each.
//
// What bounds them on an H100: arithmetic.  A full pass costs a bin ~35
// FLOP (Horner 14, |sec|^2 3, the divide, q 8, two projections 6, three
// adds) against 8 bytes of t.  At K = 12, N = 6 the 144 passes repeat the
// lcm(K, N) = 12 distinct ones, and ps's second pass over k its first, so
// the function needs far less than the kernels do (chip_smoke.py's
// kernel_work counts both).  The warp trees are no FLOPs but take
// instruction slots: 3 S trees of 5 shuffle-add steps per warp in full
// and ps.  The design keeps every intermediate of a bin in registers, as
// the TPU kernel keeps its tile.

#include <cstddef>

#include "sos_common.cuh"

namespace p2 {

using sos::cabs2;
using sos::cmul;
using sos::horner;
using sos::kThreads;
using sos::kWarps;

constexpr int kBadSize = -2;
constexpr int kOut = 3;    // sums per block row: projections on z^0, z^1, z^2
constexpr int kRegK = 16;  // ps keeps its products in registers up to here
enum Variant { kFull = 0, kNoreduce = 1, kLanered = 2, kPs = 3 };

// tn conj(sec) / |sec|^2, 0 where |sec|^2 = 0
__device__ __forceinline__ float2 quotient(float2 tn, float2 sec) {
  const float d = cabs2(sec);
  const bool ok = d > 0.0f;
  const float inv = 1.0f / (ok ? d : 1.0f);
  return ok ? make_float2((tn.x * sec.x + tn.y * sec.y) * inv, (tn.y * sec.x - tn.x * sec.y) * inv)
            : make_float2(0.0f, 0.0f);
}

// Lane 0 zeroes its warp's row (only it touches the row until store_row).
__device__ __forceinline__ void zero_row(float* red, int nv) {
  if ((threadIdx.x & 31) == 0)
    for (int v = 0; v < nv; ++v) red[(threadIdx.x >> 5) * nv + v] = 0.0f;
}

__device__ __forceinline__ float2 bin_tn(const float* __restrict__ t, int m, int M) {
  return m < M ? make_float2(__ldg(t + m), __ldg(t + M + m)) : make_float2(0.0f, 0.0f);
}

// (k, n) = (s % K, s % N) of the next pass, without integer divisions
__device__ __forceinline__ void next_pair(int& k, int& n, int K, int N) {
  k = k + 1 == K ? 0 : k + 1;
  n = n + 1 == N ? 0 : n + 1;
}

// Re q z^p for p < 3, one warp tree each, added into slots 0..2
__device__ __forceinline__ void put_projections(float* red, float2 q, float2 z) {
#pragma unroll
  for (int p = 0; p < kOut; ++p) {
    sos::put(red, kOut, p, q.x, true);
    q = cmul(q, z);
  }
}

__global__ void __launch_bounds__(kThreads)
    phase2_full_kernel(const float* __restrict__ t, const float* __restrict__ c,
                       float* __restrict__ partials, int M, int P, int K, int N, float w_scale) {
  __shared__ float red[kWarps * kOut];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  zero_row(red, kOut);
  for (int s = 0, k = 0, n = 0; s < 2 * K * N; ++s, next_pair(k, n, K, N)) {
    const float2 sec = horner(c + k * N + n, K * N, P, z);
    put_projections(red, quotient(tn, sec), z);
  }
  sos::store_row(red, kOut, partials + static_cast<size_t>(blockIdx.x) * kOut);
}

__global__ void __launch_bounds__(kThreads)
    phase2_noreduce_kernel(const float* __restrict__ t, const float* __restrict__ c,
                           float* __restrict__ partials, int M, int P, int K, int N,
                           float w_scale) {
  __shared__ float red[kWarps * kOut];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  float accr = 0.0f, acci = 0.0f;
  for (int s = 0, k = 0, n = 0; s < 2 * K * N; ++s, next_pair(k, n, K, N)) {
    float2 q = quotient(tn, horner(c + k * N + n, K * N, P, z));
    accr += q.x;
#pragma unroll
    for (int p = 1; p < kOut; ++p) {
      q = cmul(q, z);
      acci += q.x;
    }
  }
  sos::put(red, kOut, 0, accr);
  sos::put(red, kOut, 1, acci);
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) * kOut + 2] = 0.0f;
  sos::store_row(red, kOut, partials + static_cast<size_t>(blockIdx.x) * kOut);
}

__global__ void __launch_bounds__(kThreads)
    phase2_lanered_kernel(const float* __restrict__ t, const float* __restrict__ c,
                          float* __restrict__ partials, int M, int P, int K, int N,
                          float w_scale) {
  __shared__ float red[kWarps];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  zero_row(red, 1);
  for (int s = 0, k = 0, n = 0; s < 2 * K * N; ++s, next_pair(k, n, K, N)) {
    float2 q = quotient(tn, horner(c + k * N + n, K * N, P, z));
    float v = q.x;
#pragma unroll
    for (int p = 1; p < kOut; ++p) {
      q = cmul(q, z);
      v += q.x;
    }
    sos::put(red, 1, 0, v, true);
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w];
    partials[static_cast<size_t>(blockIdx.x) * kOut + threadIdx.x] = sum;
  }
}

// Every loop over k is unrolled over kRegK with a k < K guard, so pre[]
// and suf[] are indexed by constants and stay in registers.
__global__ void __launch_bounds__(kThreads)
    phase2_ps_kernel(const float* __restrict__ t, const float* __restrict__ c,
                     float* __restrict__ partials, int M, int P, int K, int N, float w_scale) {
  __shared__ float red[kWarps * kOut];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  const float2 one = make_float2(1.0f, 0.0f);
  const int stride = K * N;
  zero_row(red, kOut);
  for (int n = 0; n < N; ++n) {
    float2 pre[kRegK + 1], suf[kRegK + 1];
    pre[0] = one;
    float2 prod = one;
#pragma unroll
    for (int k = 0; k < kRegK; ++k) {
      if (k < K) {
        pre[k + 1] = cmul(pre[k], horner(c + k * N + n, stride, P, z));
        prod = pre[k + 1];
      }
    }
    // suf[k] = prod_{j >= k} sec_j, built from the last section down
#pragma unroll
    for (int k = kRegK - 1; k >= 0; --k) {
      if (k < K) suf[k] = cmul(k + 1 < K ? suf[k + 1] : one, horner(c + k * N + n, stride, P, z));
    }
    const float2 tp = quotient(tn, prod);
    for (int rep = 0; rep < 2; ++rep) {  // the b-tap and a-tap passes
#pragma unroll
      for (int k = 0; k < kRegK; ++k) {
        if (k < K) {
          const float2 q = cmul(tp, cmul(pre[k], k + 1 < K ? suf[k + 1] : one));
          put_projections(red, q, z);
        }
      }
    }
  }
  sos::store_row(red, kOut, partials + static_cast<size_t>(blockIdx.x) * kOut);
}

inline unsigned n_blocks(int M) { return static_cast<unsigned>((M + kThreads - 1) / kThreads); }

inline bool sizes_ok(int variant, int M, int P, int K, int N) {
  return M >= 1 && M <= 0x7fffffff - kThreads && P >= 2 && P <= sos::kMaxP && K >= 1 &&
         K <= (variant == kPs ? kRegK : sos::kMaxK) && N >= 1 &&
         static_cast<long long>(2) * K * N <= 0x7fffffffLL;
}

}  // namespace p2

// One library for every size (P, K and N are runtime sizes); cuda_build
// builds it as the library of N = 1.
extern "C" {

int p2_threads_per_block() { return p2::kThreads; }

int p2_channels() { return 1; }

const char* p2_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// variant: 0 full, 1 noreduce, 2 lanered, 3 ps.  partials holds one row of
// 3 floats per block of 128 bins.
int p2_launch(int variant, const void* t, const void* c, void* partials, int M, int P, int K,
              int N, float w_scale, void* stream) {
  if (!p2::sizes_ok(variant, M, P, K, N)) return p2::kBadSize;
  const auto* tt = static_cast<const float*>(t);
  const auto* cc = static_cast<const float*>(c);
  auto* out = static_cast<float*>(partials);
  const dim3 grid(p2::n_blocks(M)), block(p2::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case p2::kFull:
      p2::phase2_full_kernel<<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, w_scale);
      break;
    case p2::kNoreduce:
      p2::phase2_noreduce_kernel<<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, w_scale);
      break;
    case p2::kLanered:
      p2::phase2_lanered_kernel<<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, w_scale);
      break;
    case p2::kPs:
      p2::phase2_ps_kernel<<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, w_scale);
      break;
    default:
      return p2::kBadSize;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
