// Candidate designs of K10 'full' and 'ps' (the phase-2 micro-benchmark's
// per-section and prefix/suffix kernels), timed by
// controls/k10_designs/time_designs.py beside the package's kernels
// (flamo_tpu_torch/csrc/phase2_micro.cu) and the previous ones
// (controls/phase2_micro_prev).  Each design computes its variant's
// function as phase2_micro_plain defines it, from the same operands
// (t (2, M), taps c (P, K, N), row-major) into one row of 3 partial sums a
// block; the levers are template arguments and runtime sizes:
//
// full_design_kernel<PC, TREES>(..., passes, G, scale):
//   passes, scale  lever 1: the L = lcm(K, N) distinct passes scaled by
//                  2 K N / L, or all 2 K N passes scaled by 1 (K5's count:
//                  every pass a distinct section);
//   G              lever 2: passes a thread; the ceil(passes / G) groups
//                  lie side by side in the grid (G = passes: one thread a
//                  bin over every pass, as before);
//   TREES          lever 3 off: three warp trees a pass into the warp's
//                  shared-memory row (the previous frame); on its
//                  absence, W = sum conj(sec) / |sec|^2 in registers and
//                  one block reduction of tn W's three projections;
//   PC             lever 4: 0 reads the taps through L1 with a runtime P
//                  (sos::horner), 3 stages the group's taps in shared
//                  memory and unrolls Horner over P = 3.
//
// ps_design_kernel<PC, TREES, SPLIT, RECUR>(..., reps, scale):
//   reps, scale    lever 1: one pass over k scaled by 2, or two (the
//                  previous kernel's, K5's b-tap and a-tap passes); each
//                  section's Horner sum is formed once a pass (the
//                  previous kernel formed it twice, for the prefix and the
//                  suffix products);
//   SPLIT          lever 2: one thread a (bin, channel), the channels side
//                  by side in the grid, or one thread a bin over every
//                  channel;
//   TREES          lever 3 off: three warp trees a k and pass;
//   PC             lever 4, as in full (the block's channels' taps);
//   RECUR          sum_k pre_k suf_{k+1} by the recurrence acc = acc sec_k
//                  + pre_k in the forward pass, no suffix products and no
//                  arrays (not the package's formulation; measured only).
//
// A memory clobber starts each pass over k so that the compiler forms the
// second pass (reps = 2) anew from the staged taps.

#include <cstddef>

#include "sos_common.cuh"

namespace k10d {

using sos::cabs2;
using sos::cmul;
using sos::kThreads;
using sos::kWarps;

constexpr int kBadSize = -2;
constexpr int kOut = 3;
constexpr int kRegK = 16;
constexpr int kStage = 2048;  // staged taps a block (floats)

__device__ __forceinline__ float2 inv_conj(float2 sec) {
  const float d = cabs2(sec);
  const bool ok = d > 0.0f;
  const float inv = 1.0f / (ok ? d : 1.0f);
  return ok ? make_float2(sec.x * inv, -sec.y * inv) : make_float2(0.0f, 0.0f);
}

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

__device__ __forceinline__ void zero_row(float* red) {
  if ((threadIdx.x & 31) == 0)
    for (int v = 0; v < kOut; ++v) red[(threadIdx.x >> 5) * kOut + v] = 0.0f;
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

// q scaled by r, its three projections each added by a warp tree into the
// warp's row (the previous frame)
__device__ __forceinline__ void put_tree(float* red, float2 q, float r, float2 z) {
  q = make_float2(q.x * r, q.y * r);
#pragma unroll
  for (int p = 0; p < kOut; ++p) {
    sos::put(red, kOut, p, q.x, true);
    q = cmul(q, z);
  }
}

// a thread's sum Q scaled by r: its three projections, once, into the row
__device__ __forceinline__ void put_once(float* red, float2 q, float r, float2 z) {
  q = make_float2(q.x * r, q.y * r);
  const float2 z2 = cmul(z, z);
  sos::put(red, kOut, 0, q.x);
  sos::put(red, kOut, 1, q.x * z.x - q.y * z.y);
  sos::put(red, kOut, 2, q.x * z2.x - q.y * z2.y);
}

__host__ __device__ inline int n_blocks(int M) { return (M + kThreads - 1) / kThreads; }

template <int PC, bool TREES>
__global__ void __launch_bounds__(kThreads)
    full_design_kernel(const float* __restrict__ t, const float* __restrict__ c,
                       float* __restrict__ partials, int M, int P, int K, int N, int passes,
                       int G, float scale, float w_scale) {
  __shared__ float taps[kStage];
  __shared__ float red[kWarps * kOut];
  const int nbx = n_blocks(M);
  const int g = blockIdx.x / nbx;
  const int m = (blockIdx.x - g * nbx) * kThreads + threadIdx.x;
  const int s0 = g * G;
  const int ns = min(G, passes - s0);
  if constexpr (PC > 0) {
    for (int i = threadIdx.x; i < ns * PC; i += kThreads) {
      const int s = s0 + i / PC, p = i % PC;
      taps[i] = __ldg(c + (p * K + s % K) * N + s % N);
    }
  }
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  if constexpr (TREES) zero_row(red);
  if constexpr (PC > 0) __syncthreads();
  float2 w = make_float2(0.0f, 0.0f);
  int k = s0 % K, n = s0 % N;
  for (int j = 0; j < ns; ++j) {
    float2 sec;
    if constexpr (PC > 0)
      sec = section<PC>(taps + j * PC, 1, PC, z);
    else
      sec = section<0>(c + k * N + n, K * N, P, z);
    if constexpr (TREES) {
      put_tree(red, quotient(tn, sec), scale, z);
    } else {
      const float2 v = inv_conj(sec);
      w.x += v.x;
      w.y += v.y;
    }
    k = k + 1 == K ? 0 : k + 1;
    n = n + 1 == N ? 0 : n + 1;
  }
  if constexpr (!TREES) put_once(red, cmul(tn, w), scale, z);
  sos::store_row(red, kOut, partials + static_cast<size_t>(blockIdx.x) * kOut);
}

template <int PC, bool TREES, bool SPLIT, bool RECUR>
__global__ void __launch_bounds__(kThreads)
    ps_design_kernel(const float* __restrict__ t, const float* __restrict__ c,
                     float* __restrict__ partials, int M, int P, int K, int N, int reps,
                     float scale, float w_scale) {
  __shared__ float taps[kStage];
  __shared__ float red[kWarps * kOut];
  const int nbx = n_blocks(M);
  const int b = SPLIT ? blockIdx.x / nbx : 0;
  const int m = (blockIdx.x - b * nbx) * kThreads + threadIdx.x;
  const int n0 = SPLIT ? b : 0, n1 = SPLIT ? b + 1 : N;
  if constexpr (PC > 0) {  // taps[(n - n0) K PC + k PC + p]
    for (int i = threadIdx.x; i < (n1 - n0) * K * PC; i += kThreads) {
      const int n = n0 + i / (K * PC), k = i / PC % K, p = i % PC;
      taps[i] = __ldg(c + (p * K + k) * N + n);
    }
  }
  const float2 z = sos::bin_phasor(m, w_scale, 0.0f);
  const float2 tn = bin_tn(t, m, M);
  const float2 one = make_float2(1.0f, 0.0f);
  if constexpr (TREES) zero_row(red);
  if constexpr (PC > 0) __syncthreads();
  float2 W = make_float2(0.0f, 0.0f);
  for (int n = n0; n < n1; ++n) {
    for (int rep = 0; rep < reps; ++rep) {
      asm volatile("" ::: "memory");
      const float* cn = PC > 0 ? taps + (n - n0) * K * PC : c + n;
      const int stride = PC > 0 ? 1 : K * N;
      const int kstep = PC > 0 ? PC : N;
      float2 prod = one, acc = make_float2(0.0f, 0.0f);
      if constexpr (RECUR) {
#pragma unroll
        for (int k = 0; k < kRegK; ++k) {
          if (k < K) {
            const float2 sec = section<PC>(cn + k * kstep, stride, P, z);
            const float2 a = cmul(acc, sec);
            acc = make_float2(a.x + prod.x, a.y + prod.y);
            prod = cmul(prod, sec);
          }
        }
        const float2 v = cmul(inv_conj(prod), acc);
        W.x += v.x;
        W.y += v.y;
      } else {
        float2 sec[kRegK], pre[kRegK];
#pragma unroll
        for (int k = 0; k < kRegK; ++k) {
          if (k < K) {
            pre[k] = prod;
            sec[k] = section<PC>(cn + k * kstep, stride, P, z);
            prod = cmul(prod, sec[k]);
          }
        }
        const float2 tp = TREES ? quotient(tn, prod) : inv_conj(prod);
        float2 suf = one;
#pragma unroll
        for (int k = kRegK - 1; k >= 0; --k) {
          if (k < K) {
            const float2 v = cmul(pre[k], suf);
            if constexpr (TREES) {
              put_tree(red, cmul(tp, v), scale, z);
            } else {
              acc.x += v.x;
              acc.y += v.y;
            }
            suf = cmul(suf, sec[k]);
          }
        }
        if constexpr (!TREES) {
          const float2 v = cmul(tp, acc);
          W.x += v.x;
          W.y += v.y;
        }
      }
    }
  }
  if constexpr (!TREES) put_once(red, cmul(tn, W), scale, z);
  sos::store_row(red, kOut, partials + static_cast<size_t>(blockIdx.x) * kOut);
}

}  // namespace k10d

extern "C" {

// Rows (= blocks) of a full design launch: bin blocks x pass groups.
long long full_design_rows(int M, int passes, int G) {
  return static_cast<long long>(k10d::n_blocks(M)) * ((passes + G - 1) / G);
}

// Rows of a ps design launch: bin blocks, x channels with split.
long long ps_design_rows(int M, int N, int split) {
  return static_cast<long long>(k10d::n_blocks(M)) * (split ? N : 1);
}

// pc: 0 (runtime P through L1) or 3 (P = 3, staged taps).
int full_design_launch(int pc, int trees, const void* t, const void* c, void* partials, int M,
                       int P, int K, int N, int passes, int G, float scale, float w_scale,
                       void* stream) {
  if ((pc != 0 && pc != P) || (pc != 0 && pc != 3) || G < 1 || passes < 1 ||
      (pc && G * pc > k10d::kStage) || P < 2 || P > sos::kMaxP)
    return k10d::kBadSize;
  const auto* tt = static_cast<const float*>(t);
  const auto* cc = static_cast<const float*>(c);
  auto* out = static_cast<float*>(partials);
  const dim3 grid(static_cast<unsigned>(full_design_rows(M, passes, G))), block(k10d::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
#define K10D_FULL(PCV, TR)                                                                      \
  if (pc == PCV && trees == TR) {                                                               \
    k10d::full_design_kernel<PCV, TR>                                                           \
        <<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, passes, G, scale, w_scale);            \
    return static_cast<int>(cudaGetLastError());                                                \
  }
  K10D_FULL(0, false) K10D_FULL(0, true) K10D_FULL(3, false) K10D_FULL(3, true)
#undef K10D_FULL
  return k10d::kBadSize;
}

int ps_design_launch(int pc, int trees, int split, int recur, const void* t, const void* c,
                     void* partials, int M, int P, int K, int N, int reps, float scale,
                     float w_scale, void* stream) {
  if ((pc != 0 && pc != P) || (pc != 0 && pc != 3) || K > k10d::kRegK || reps < 1 ||
      (pc && (split ? 1 : N) * K * pc > k10d::kStage) || (recur && trees) || P < 2 ||
      P > sos::kMaxP)
    return k10d::kBadSize;
  const auto* tt = static_cast<const float*>(t);
  const auto* cc = static_cast<const float*>(c);
  auto* out = static_cast<float*>(partials);
  const dim3 grid(static_cast<unsigned>(ps_design_rows(M, N, split))), block(k10d::kThreads);
  auto s = static_cast<cudaStream_t>(stream);
#define K10D_PS(PCV, TR, SP, RC)                                                                \
  if (pc == PCV && trees == TR && split == SP && recur == RC) {                                 \
    k10d::ps_design_kernel<PCV, TR, SP, RC>                                                     \
        <<<grid, block, 0, s>>>(tt, cc, out, M, P, K, N, reps, scale, w_scale);                 \
    return static_cast<int>(cudaGetLastError());                                                \
  }
  K10D_PS(0, true, false, false) K10D_PS(0, true, true, false)
  K10D_PS(0, false, false, false) K10D_PS(0, false, true, false)
  K10D_PS(3, true, false, false) K10D_PS(3, true, true, false)
  K10D_PS(3, false, false, false) K10D_PS(3, false, true, false)
  K10D_PS(0, false, false, true) K10D_PS(0, false, true, true)
  K10D_PS(3, false, false, true) K10D_PS(3, false, true, true)
#undef K10D_PS
  return k10d::kBadSize;
}

}  // extern "C"
