// The SOS-cascade kernels K4f and K4b as they were before their redesign
// (flamo_tpu_torch/csrc/sos_kernels.cu, K5 left out), kept as the control
// that chip_smoke.py times the redesigned kernels against (previous_ms).
// Built for one channel count, -DFDN_N=6; nothing of the package loads it.
//
// Hand-written Hopper (sm_90a) kernels of the attenuated-FDN path, with a
// plain C interface that flamo_tpu_torch/ops/sos_kernels.py loads through
// ctypes.  Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(), kBadN (-1) when asked for
// another channel count than the FDN_N this library was built for, or
// kBadSize (-2) for taps or sizes out of the limits below.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py):
//   sos_cascade_fwd_kernel (K4f) <- _sos_cascade_fwd_kernel, pallas_call at :940
//   sos_cascade_bwd_kernel (K4b) <- _sos_cascade_bwd_kernel, pallas_call at
//                                   :957 (VJP of pallas_sos_cascade) and :989
//                                   (_sos_bwd_rows)
//   fdn_sos_tf_mse_kernel  (K5)  <- _fdn_sos_tf_mse_kernel, pallas_call at :1376
//
// The guarded SOS cascade of a channel n at the phasor z = e^{-j w},
//   H_n = prod_k B_kn(z) / prod_k A_kn(z),  B_kn(z) = sum_p b[p,k,n] z^p,
// is FLT_EPSILON (real) with zero gradient where |prod_k A_kn|^2 = 0, as
// _iir_guard_prods; a single section whose |B_k|^2 or |A_k|^2 is 0 adds
// nothing to the tap cotangents.  Taps are (P, K, N) float32, row-major.
// K and P are runtime sizes (loops, no per-section arrays): P <= kMaxP,
// K <= kMaxK.  The phasor, the Horner sum and the warp reductions are
// sos_common.cuh's, which phase2_micro.cu shares.
//
// What bounds them on an H100: arithmetic.  At N = 6, K = 12, P = 3 a bin
// costs ~3.0 kFLOP of Horner and products in K4f, ~7.7 kFLOP in K4b (the
// cascade again, then 2 K section quotients and P powers per channel) and
// ~9.7 kFLOP in K5 (K4f's cascade, K1's eliminations and the K4b tap
// sums; chip_smoke.py's kernel_work counts them), against 48-75 bytes of
// D, X, t, H and partials per bin: at 67 TFLOP/s and 3.35 TB/s the
// operations take 3-7x the memory time.  K4b and K5 also recompute the
// 2 K section Horners per channel for the tap sums (~2.0 kFLOP per bin
// more than those counts, which take each section response once).
//
// K4f and K4b keep every intermediate of a bin in registers and reduce
// the 2 P K tap sums as they are produced, one warp shuffle tree per value
// into a shared-memory row per warp, then one row per block that the
// wrapper sums with torch.sum.
//
// K5 runs one thread per bin, so its grid has only M / 32 warps (~11 an
// SM at M = 48001), and its tap sums are 2 P K N values a block.  It
// stages the taps in shared memory once a block, unrolls the cascade and
// the tap sums over a compile-time P (one copy per P, dispatched on the
// runtime P), and transposes the tap sums: each bin parks its phasor and
// its N values t_n in shared memory, and the block's threads then take the
// 2 K N sections (split over runs of the block's bins so that the work
// covers the threads evenly), each summing its P values over its bins in
// registers, so no tap sum takes a shuffle tree.  The U/b/c/loss heads
// (N^2 + 2 N + 1 values) keep their warp trees.  No atomics: two runs give
// the same partials.
//
// Threads of the ragged edge m >= M run with zero operands (K5: D = X =
// t = 0; K4b: t = 0), so they add exactly 0, and they take part in the
// warp shuffles and barriers of the block reductions.

#include <cfloat>
#include <cstddef>

#include "sos_common.cuh"

namespace sos {

constexpr int kBadN = -1;
constexpr int kBadSize = -2;
constexpr int kMaxSharedFloats = 48 * 1024 / 4;  // without opting in
constexpr int kMaxSmemFloats = 232448 / 4;       // a block's 227 KB, opted in

// Guarded cascade response of channel n; ok is false where the
// denominator product vanished (the response is then FLT_EPSILON).
__device__ __forceinline__ float2 cascade(const float* __restrict__ b, const float* __restrict__ a,
                                          int n, int K, int P, int N, float2 z, bool& ok) {
  const int stride = K * N;
  float2 pb = make_float2(1.0f, 0.0f);
  float2 pa = make_float2(1.0f, 0.0f);
  for (int k = 0; k < K; ++k) {
    pb = cmul(pb, horner(b + k * N + n, stride, P, z));
    pa = cmul(pa, horner(a + k * N + n, stride, P, z));
  }
  const float den = cabs2(pa);
  ok = den != 0.0f;
  const float inv = 1.0f / (ok ? den : 1.0f);
  return ok ? make_float2((pb.x * pa.x + pb.y * pa.y) * inv, (pb.y * pa.x - pb.x * pa.y) * inv)
            : make_float2(FLT_EPSILON, 0.0f);
}

// Tap cotangents of channel n from t = (cotangent of H_n) * H_n, masked:
//   b_bar[p,k,n] =  sum_m Re(t / B_kn z^p),  a_bar[p,k,n] = -sum_m Re(t / A_kn z^p),
// warp-summed into slot base + ((part * P + p) * K + k) * stride.
__device__ __forceinline__ void tap_partials(const float* __restrict__ b,
                                             const float* __restrict__ a, int n, int K, int P,
                                             int N, float2 z, float2 t, float* red, int nv,
                                             int base, int stride) {
  for (int part = 0; part < 2; ++part) {
    const float* c = part ? a : b;
    const float sign = part ? -1.0f : 1.0f;
    for (int k = 0; k < K; ++k) {
      const float2 sec = horner(c + k * N + n, K * N, P, z);
      const float d = cabs2(sec);
      const bool okd = d > 0.0f;
      const float invd = sign / (okd ? d : 1.0f);
      float2 q = okd ? make_float2((t.x * sec.x + t.y * sec.y) * invd,
                                   (t.y * sec.x - t.x * sec.y) * invd)
                     : make_float2(0.0f, 0.0f);
      for (int p = 0; p < P; ++p) {
        put(red, nv, base + ((part * P + p) * K + k) * stride, q.x);
        q = cmul(q, z);
      }
    }
  }
}

// K4f: one thread per (bin, channel); H (M, N) complex64, interleaved.
__global__ void __launch_bounds__(kThreads)
    sos_cascade_fwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                           float2* __restrict__ H, int M, int N, int K, int P, float w_scale,
                           float off) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= M * N) return;
  const int m = idx / N;
  const int n = idx - m * N;
  bool ok;
  H[idx] = cascade(b, a, n, K, P, N, bin_phasor(m, w_scale, off), ok);
}

// K4b: grid (bin blocks, N); block (x, n) reduces its bins of channel n
// into partials row x * N + n of 2 P K values, ordered (part, p, k).
// G is JAX's cotangent of H, (M, N) complex64.
__global__ void __launch_bounds__(kThreads)
    sos_cascade_bwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                           const float2* __restrict__ G, float* __restrict__ partials, int M,
                           int N, int K, int P, float w_scale, float off) {
  extern __shared__ float red[];
  const int nv = 2 * P * K;
  const int n = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const float2 z = bin_phasor(m, w_scale, off);
  bool ok;
  const float2 h = cascade(b, a, n, K, P, N, z, ok);
  float2 t = make_float2(0.0f, 0.0f);
  if (m < M && ok) t = cmul(G[static_cast<size_t>(m) * N + n], h);
  tap_partials(b, a, n, K, P, N, z, t, red, nv, 0, 1);
  store_row(red, nv, partials + (static_cast<size_t>(blockIdx.x) * N + n) * nv);
}

inline unsigned n_blocks(long long work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

inline bool sizes_ok(int M, int N, int K, int P) {
  return M >= 1 && N >= 1 && K >= 1 && K <= kMaxK && P >= 1 && P <= kMaxP &&
         static_cast<long long>(M) * N <= 0x7fffffffLL - kThreads;
}

}  // namespace sos

// One build is for one channel count, FDN_N (-DFDN_N=6), as fdn_kernels.cu:
// K5 is unrolled over it, and K4f/K4b, which loop over N at run time, are
// launched from the library of the taps' channel count.
#ifndef FDN_N
#error "compile with -DFDN_N=<channel count>"
#endif
static_assert(FDN_N >= 1 && FDN_N <= fdn::kMaxN, "FDN_N out of range");

extern "C" {

int sos_threads_per_block() { return sos::kThreads; }

int sos_channels() { return FDN_N; }

const char* sos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sos_cascade_fwd_launch(const void* b, const void* a, void* H, int M, int N, int K, int P,
                           float w_scale, float off, void* stream) {
  if (N != FDN_N) return sos::kBadN;
  if (!sos::sizes_ok(M, N, K, P)) return sos::kBadSize;
  sos::sos_cascade_fwd_kernel<<<sos::n_blocks(static_cast<long long>(M) * N), sos::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(a), static_cast<float2*>(H), M, N,
      K, P, w_scale, off);
  return static_cast<int>(cudaGetLastError());
}

int sos_cascade_bwd_launch(const void* b, const void* a, const void* G, void* partials, int M,
                           int N, int K, int P, float w_scale, float off, void* stream) {
  if (N != FDN_N) return sos::kBadN;
  if (!sos::sizes_ok(M, N, K, P)) return sos::kBadSize;
  const dim3 grid(sos::n_blocks(M), N);
  const size_t smem = sizeof(float) * sos::kWarps * 2 * P * K;
  sos::sos_cascade_bwd_kernel<<<grid, sos::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<const float*>(a), static_cast<const float2*>(G),
      static_cast<float*>(partials), M, N, K, P, w_scale, off);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
