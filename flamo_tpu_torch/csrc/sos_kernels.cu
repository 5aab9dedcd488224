// Hand-written Hopper (sm_90a) kernel K5 of the attenuated-FDN path, the
// fused step, with a plain C interface that flamo_tpu_torch/ops/sos_kernels.py
// loads through ctypes.  Every entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError(), kBadN (-1) when
// asked for another channel count than the FDN_N this library was built
// for, or kBadSize (-2) for taps or sizes out of the limits below.  The SOS
// cascade alone and its tap VJP (K4f, K4b) are sos_cascade.cu's, one
// library for every channel count.
//
// Kernel and the TPU kernel it replaces (flamo_tpu/ops/pallas_solve.py):
//   fdn_sos_tf_mse_kernel  (K5)  <- _fdn_sos_tf_mse_kernel, pallas_call at :1376
//
// The guarded SOS cascade of a channel n at the phasor z = e^{-j w},
//   H_n = prod_k B_kn(z) / prod_k A_kn(z),  B_kn(z) = sum_p b[p,k,n] z^p,
// is FLT_EPSILON (real) with zero gradient where prod_k A_kn = 0, as
// _iir_guard_prods (the running products kept near 1 by powers of two,
// sos_common.cuh's pow2_scale); a single section whose |B_k|^2 or |A_k|^2
// is 0 adds nothing to the tap cotangents.  Taps are (P, K, N) float32, row-major,
// P <= kMaxP, K <= kMaxK.  The phasor, the Horner sums and the warp
// reductions are sos_common.cuh's, which phase2_micro.cu and
// sos_cascade.cu share.
//
// What bounds it on an H100: arithmetic.  At N = 6, K = 12, P = 3 a bin
// costs ~9.7 kFLOP (K4f's cascade, K1's eliminations and the K4b tap
// sums; chip_smoke.py's kernel_work counts them), against ~75 bytes of
// D, X, t and partials per bin: at 67 TFLOP/s and 3.35 TB/s the
// operations take ~7x the memory time.  K5 also recomputes the 2 K
// section Horners per channel for the tap sums (~2.0 kFLOP per bin more
// than that count, which takes each section response once).
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
// Threads of the ragged edge m >= M run with zero operands (D = X = t =
// 0), so they add exactly 0, and they take part in the warp shuffles and
// barriers of the block reductions.

#include <cfloat>
#include <cstddef>

#include "sos_common.cuh"

namespace sos {

constexpr int kBadN = -1;
constexpr int kBadSize = -2;
constexpr int kMaxSharedFloats = 48 * 1024 / 4;  // without opting in
constexpr int kMaxSmemFloats = 232448 / 4;       // a block's 227 KB, opted in

// ---------------------------------------------------------------------------
// K5's own helpers.  The block stages the 2 P K N taps in shared memory once,
// a section's P taps together: taps_s[((k N + n) 2 + part) P + p], part 0
// the numerator b, 1 the denominator a.  PT > 0 is a compile-time tap count
// (the loops over p unroll); PT = 0 reads the runtime P.
// ---------------------------------------------------------------------------

// The K5 block's dynamic shared memory in floats: with FUSE_TAPS the bins'
// rows (z and t_0..t_{N-1}, float2, kThreads rows), the staged taps, the
// warps' head rows and, with parts > 1, the runs' tap sums.
__host__ __device__ inline int k5_smem_floats(int N, int K, int P, bool fuse_taps, int parts) {
  const int taps = 2 * P * K * N;
  return (fuse_taps ? 2 * kThreads * (N + 1) : 0) + taps + kWarps * fdn::n_partials(N) +
         (fuse_taps && parts > 1 ? parts * taps : 0);
}

// The runs a block's bins split into for the tap sums (a power of two, each
// run kThreads / parts bins): the 2 K N sections x parts work items should
// cover the block's threads evenly.  The fewest bin visits for the busiest
// thread wins, ties to fewer runs, within the 48 KB a launch gets without
// opting in (2 K N = 144: 8 runs of 16 bins, 9 items a thread).
inline int k5_tap_parts(int N, int K, int P) {
  const long long S = 2LL * K * N;
  int best = 1;
  long long best_cost = (S + kThreads - 1) / kThreads * kThreads;
  for (int parts = 2; parts <= kThreads; parts *= 2) {
    if (k5_smem_floats(N, K, P, true, parts) > kMaxSharedFloats) break;
    const long long cost = (S * parts + kThreads - 1) / kThreads * (kThreads / parts);
    if (cost < best_cost) {
      best = parts;
      best_cost = cost;
    }
  }
  return best;
}

__device__ __forceinline__ void stage_taps(const float* __restrict__ bt,
                                           const float* __restrict__ at, float* taps_s, int K,
                                           int P, int N) {
  const int kn = K * N;
  const int pkn = P * kn;
  for (int v = threadIdx.x; v < 2 * pkn; v += kThreads) {
    const int part = v >= pkn;
    const int r = v - part * pkn;  // p K N + k N + n, the global layout
    const int p = r / kn;
    taps_s[((r - p * kn) * 2 + part) * P + p] = __ldg((part ? at : bt) + r);
  }
}

// sum_p c[p] z^p by Horner from shared memory, from the highest tap down
template <int PT>
__device__ __forceinline__ float2 horner_s(const float* c, int P, float2 z) {
  const int np = PT > 0 ? PT : P;
  float2 out = make_float2(c[np - 1], 0.0f);
#pragma unroll
  for (int p = np - 2; p >= 0; --p) {
    out = cmul(out, z);
    out.x += c[p];
  }
  return out;
}

// The guarded cascades of all N channels (cascade()'s arithmetic), k outer
// so that the 2 N section products of a k are independent, the running
// products rescaled by a power of two at each section (pow2_scale).
template <int N, int PT>
__device__ __forceinline__ void cascade_all(const float* taps_s, int K, int P, float2 z,
                                            float2 (&gam)[N], bool (&gok)[N]) {
  const int np = PT > 0 ? PT : P;
  float2 pb[N], pa[N];
#pragma unroll
  for (int i = 0; i < N; ++i) pb[i] = pa[i] = make_float2(1.0f, 0.0f);
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float* c = taps_s + (k * N + i) * 2 * np;
      const float s = sos::pow2_scale(pa[i]);
      pb[i] = sos::scaled(cmul(pb[i], horner_s<PT>(c, np, z)), s);
      pa[i] = sos::scaled(cmul(pa[i], horner_s<PT>(c + np, np, z)), s);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sos::rescale_pair(pb[i], pa[i]);
    const float den = cabs2(pa[i]);
    gok[i] = den != 0.0f;
    const float inv = 1.0f / (gok[i] ? den : 1.0f);
    gam[i] = gok[i] ? make_float2((pb[i].x * pa[i].x + pb[i].y * pa[i].y) * inv,
                                  (pb[i].y * pa[i].x - pb[i].x * pa[i].y) * inv)
                    : make_float2(FLT_EPSILON, 0.0f);
  }
}

// K5's tap sums, transposed.  The block's bins have parked their phasor z
// and their t_n = Gam_bar_n Gam_n in `bins` (row j: z, t_0..t_{N-1}).  A
// work item is one section (part, k, n) over one run of kThreads / parts
// bins: its thread keeps the section's P taps and P sums in registers and
// walks the run, every lane of a warp on the same bin (shared-memory
// broadcasts of z), adding
//   b_bar[p,k,n] += Re(t_n / B_kn z^p),  a_bar[p,k,n] -= Re(t_n / A_kn z^p)
// a bin, nothing where |B_kn|^2 or |A_kn|^2 is 0.  The reciprocal of
// |B_kn|^2 is the fast one (__fdividef, within 2 ulp).  With one run an item
// writes its P sums into the block's row at ((part P + p) K + k) N + n;
// with more, the runs' sums meet in `acc` and are added in run order.  No
// shuffles, no atomics: two launches give the same row.
template <int N, int P>
__device__ __forceinline__ void tap_sums(const float2* bins, const float* taps_s, float* acc,
                                         int K, int parts, float* __restrict__ row) {
  const int S = 2 * K * N;
  const int run = kThreads / parts;
  for (int item = threadIdx.x; item < S * parts; item += kThreads) {
    const int r = item / S;
    const int s = item - r * S;  // (part K + k) N + n
    const int n = s % N;
    const int part = s / N >= K;
    const int k = s / N - part * K;
    float c[P], sum[P];
    const float* cs = taps_s + ((k * N + n) * 2 + part) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      c[p] = cs[p];
      sum[p] = 0.0f;
    }
    const float sign = part ? -1.0f : 1.0f;
    const float2* rb = bins + r * run * (N + 1);
#pragma unroll 4
    for (int j = 0; j < run; ++j) {
      const float2 z = rb[j * (N + 1)];
      const float2 t = rb[j * (N + 1) + 1 + n];
      const float2 sec = horner_s<P>(c, P, z);
      const float d = cabs2(sec);
      const bool ok = d > 0.0f;
      const float inv = __fdividef(sign, ok ? d : 1.0f);
      float2 q = ok ? make_float2((t.x * sec.x + t.y * sec.y) * inv,
                                  (t.y * sec.x - t.x * sec.y) * inv)
                    : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sum[p] += q.x;
        if (p + 1 < P) q = cmul(q, z);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (parts == 1) {
        row[((part * P + p) * K + k) * N + n] = sum[p];
      } else {
        acc[(s * P + p) * parts + r] = sum[p];
      }
    }
  }
  if (parts > 1) {
    __syncthreads();
    for (int v = threadIdx.x; v < S * P; v += kThreads) {
      float total = 0.0f;
      for (int r = 0; r < parts; ++r) total += acc[v * parts + r];
      const int s = v / P;
      const int p = v - s * P;
      const int part = s / N >= K;
      row[((part * P + p) * K + s / N - part * K) * N + s % N] = total;
    }
  }
}

// K5: one thread per bin.  Gam = guarded cascade of the taps bt/at, folded
// into the loop diagonal:
//   tf = c^T (I - diag(D Gam) U)^{-1} diag(D) b,  L = (1/M) sum (|tf X| - t)^2,
// with JAX's cotangents (tb of tf, bb_i = tb w_i, w = A^{-T} c):
//   U_bar_ij = Re sum bb_i D_i Gam_i y_j,  b_bar_i = Re sum bb_i D_i,
//   c_bar_i = Re sum tb y_i,  Gam_bar_i = bb_i (U y)_i D_i,
//   D_bar_i = bb_i ((U y)_i Gam_i + b_i)  (WITH_DBAR).
// Partials row per block: [U_bar, b_bar, c_bar, loss], each a warp tree
// and one add over the warps, and, with FUSE_TAPS, the 2 P K N tap sums
// ordered (part, p, k, n) from t_i = Gam_bar_i Gam_i (tap_sums); without,
// Gbar gets the masked Gam_bar rows for K4b (sos_cascade.cu).  scale = 2 / M.  With
// FUSE_TAPS the cascade and the tap sums are unrolled over P (one copy of
// each per P in 1..kMaxP, chosen by the runtime P); the four fuse_taps =
// False kernels loop over the runtime P.
template <int N, bool PIVOT, bool WITH_DBAR, bool FUSE_TAPS>
__global__ void __launch_bounds__(kThreads)
    fdn_sos_tf_mse_kernel(const float2* __restrict__ D, const float* __restrict__ bt,
                          const float* __restrict__ at, const float* __restrict__ U,
                          const float* __restrict__ b, const float* __restrict__ c,
                          const float2* __restrict__ X, const float* __restrict__ t,
                          float2* __restrict__ Dbar, float2* __restrict__ Gbar,
                          float* __restrict__ partials, float scale, int M, int K, int P,
                          int parts, float w_scale, float off) {
  extern __shared__ float4 smem4[];
  constexpr int NV0 = fdn::n_partials(N);
  const int ntaps = 2 * P * K * N;
  float2* bins = reinterpret_cast<float2*>(smem4);  // FUSE_TAPS: [kThreads][N + 1]
  float* taps_s = reinterpret_cast<float*>(smem4) + (FUSE_TAPS ? 2 * kThreads * (N + 1) : 0);
  float* red = taps_s + ntaps;     // [kWarps][NV0]
  float* acc = red + kWarps * NV0;  // parts > 1: [2 K N P][parts]
  float* row = partials + static_cast<size_t>(blockIdx.x) * (NV0 + (FUSE_TAPS ? ntaps : 0));
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool live = m < M;
  const size_t mrow = static_cast<size_t>(live ? m : 0) * N;
  const float2 z = bin_phasor(m, w_scale, off);
  stage_taps(bt, at, taps_s, K, P, N);
  __syncthreads();

  // phase 1: cascade, solve, loss and the U/b/c heads
  float2 d[N], gam[N], dp[N];
  bool gok[N];
  if constexpr (FUSE_TAPS) {
    switch (P) {
      case 1: cascade_all<N, 1>(taps_s, K, P, z, gam, gok); break;
      case 2: cascade_all<N, 2>(taps_s, K, P, z, gam, gok); break;
      case 3: cascade_all<N, 3>(taps_s, K, P, z, gam, gok); break;
      case 4: cascade_all<N, 4>(taps_s, K, P, z, gam, gok); break;
      case 5: cascade_all<N, 5>(taps_s, K, P, z, gam, gok); break;
      case 6: cascade_all<N, 6>(taps_s, K, P, z, gam, gok); break;
      case 7: cascade_all<N, 7>(taps_s, K, P, z, gam, gok); break;
      default: cascade_all<N, kMaxP>(taps_s, K, P, z, gam, gok); break;
    }
  } else {
    cascade_all<N, 0>(taps_s, K, P, z, gam, gok);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = live ? D[mrow + i] : make_float2(0.0f, 0.0f);
    dp[i] = cmul(d[i], gam[i]);
  }
  float2 A[N][N];
  fdn::assemble<N, false>(dp, U, A);
  float2 rhs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float bi = __ldg(b + i);
    rhs[i] = make_float2(d[i].x * bi, d[i].y * bi);
  }
  float2 y[N];
  if (PIVOT) {
    fdn::ge_pivot<N>(A, rhs, y);
  } else {
    fdn::ge_nopivot_factors<N>(A, rhs, y);
  }
  float2 tf = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float ci = __ldg(c + i);
    tf.x += ci * y[i].x;
    tf.y += ci * y[i].y;
  }
  const float2 x = live ? X[m] : make_float2(0.0f, 0.0f);
  const float tt = live ? t[m] : 0.0f;
  const float zr = tf.x * x.x - tf.y * x.y;
  const float zi = tf.x * x.y + tf.y * x.x;
  const float amag = sqrtf(zr * zr + zi * zi);
  const float diff = amag - tt;
  const float g = scale * diff / (amag > 0.0f ? amag : 1.0f);
  const float dzr = g * zr;
  const float dzi = g * zi;
  const float2 tb = make_float2(dzr * x.x + dzi * x.y, dzr * x.y - dzi * x.x);

  float2 cc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) cc[i] = make_float2(__ldg(c + i), 0.0f);
  float2 w[N];
  if (PIVOT) {
    float2 At[N][N];
    fdn::assemble<N, true>(dp, U, At);
    fdn::ge_pivot<N>(At, cc, w);
  } else {
    fdn::transpose_solve_from_factors<N>(A, cc, w);
  }

  if constexpr (FUSE_TAPS) bins[threadIdx.x * (N + 1)] = z;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float2 bb = cmul(tb, w[i]);
    float ur = 0.0f, ui = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float u = __ldg(U + i * N + j);
      ur += u * y[j].x;
      ui += u * y[j].y;
    }
    const float2 dpbar = cmul(bb, make_float2(ur, ui));
    const float2 gambar = cmul(dpbar, d[i]);
    if (WITH_DBAR) {
      float2 db = cmul(dpbar, gam[i]);
      const float bi = __ldg(b + i);
      db.x += bb.x * bi;
      db.y += bb.y * bi;
      if (live) Dbar[mrow + i] = db;
    }
    put(red, NV0, N * N + i, cmul(bb, d[i]).x);
    put(red, NV0, N * N + N + i, cmul(tb, y[i]).x);
    const float2 bbdp = cmul(bb, dp[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) put(red, NV0, i * N + j, cmul(bbdp, y[j]).x);
    const float2 zero = make_float2(0.0f, 0.0f);
    if constexpr (FUSE_TAPS) {
      bins[threadIdx.x * (N + 1) + 1 + i] = gok[i] ? cmul(gambar, gam[i]) : zero;
    } else if (live) {
      Gbar[mrow + i] = gok[i] ? gambar : zero;
    }
  }
  put(red, NV0, NV0 - 1, diff * diff);
  store_row(red, NV0, row);  // its barrier also puts every bin's row in place

  // phase 2: the tap sums, transposed over the block's bins
  if constexpr (FUSE_TAPS) {
    float* taps_row = row + NV0;
    switch (P) {
      case 1: tap_sums<N, 1>(bins, taps_s, acc, K, parts, taps_row); break;
      case 2: tap_sums<N, 2>(bins, taps_s, acc, K, parts, taps_row); break;
      case 3: tap_sums<N, 3>(bins, taps_s, acc, K, parts, taps_row); break;
      case 4: tap_sums<N, 4>(bins, taps_s, acc, K, parts, taps_row); break;
      case 5: tap_sums<N, 5>(bins, taps_s, acc, K, parts, taps_row); break;
      case 6: tap_sums<N, 6>(bins, taps_s, acc, K, parts, taps_row); break;
      case 7: tap_sums<N, 7>(bins, taps_s, acc, K, parts, taps_row); break;
      default: tap_sums<N, kMaxP>(bins, taps_s, acc, K, parts, taps_row); break;
    }
  }
}

inline unsigned n_blocks(long long work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

inline bool sizes_ok(int M, int N, int K, int P) {
  return M >= 1 && N >= 1 && K >= 1 && K <= kMaxK && P >= 1 && P <= kMaxP &&
         static_cast<long long>(M) * N <= 0x7fffffffLL - kThreads;
}

template <int N>
cudaError_t launch_tf_mse(bool pivot, bool with_dbar, bool fuse_taps, const float2* D,
                          const float* bt, const float* at, const float* U, const float* b,
                          const float* c, const float2* X, const float* t, float2* Dbar,
                          float2* Gbar, float* partials, float scale, int M, int K, int P,
                          float w_scale, float off, cudaStream_t s) {
  const dim3 grid(n_blocks(M)), block(kThreads);
  const int parts = fuse_taps ? k5_tap_parts(N, K, P) : 1;
  const int smem = static_cast<int>(sizeof(float)) * k5_smem_floats(N, K, P, fuse_taps, parts);
  // above 48 KB (large P K N with fuse_taps) the kernel opts in
#define SOS_K5(PV, WD, FT)                                                                     \
  do {                                                                                         \
    auto kernel = fdn_sos_tf_mse_kernel<N, PV, WD, FT>;                                        \
    if (smem > kMaxSharedFloats * static_cast<int>(sizeof(float))) {                           \
      const cudaError_t err =                                                                  \
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);     \
      if (err != cudaSuccess) return err;                                                      \
    }                                                                                          \
    kernel<<<grid, block, smem, s>>>(D, bt, at, U, b, c, X, t, Dbar, Gbar, partials, scale, M, \
                                     K, P, parts, w_scale, off);                               \
  } while (0)
  if (pivot) {
    if (with_dbar) {
      if (fuse_taps) SOS_K5(true, true, true); else SOS_K5(true, true, false);
    } else {
      if (fuse_taps) SOS_K5(true, false, true); else SOS_K5(true, false, false);
    }
  } else {
    if (with_dbar) {
      if (fuse_taps) SOS_K5(false, true, true); else SOS_K5(false, true, false);
    } else {
      if (fuse_taps) SOS_K5(false, false, true); else SOS_K5(false, false, false);
    }
  }
#undef SOS_K5
  return cudaSuccess;
}

}  // namespace sos

// One build is for one channel count, FDN_N (-DFDN_N=6), as fdn_kernels.cu:
// K5 is unrolled over it.
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

int fdn_sos_tf_mse_launch(int N, int pivot, int with_dbar, int fuse_taps, const void* D,
                          const void* bt, const void* at, const void* U, const void* b,
                          const void* c, const void* X, const void* t, void* Dbar, void* Gbar,
                          void* partials, float scale, int M, int K, int P, float w_scale,
                          float off, void* stream) {
  if (N != FDN_N) return sos::kBadN;
  if (!sos::sizes_ok(M, N, K, P)) return sos::kBadSize;
  // a block's shared memory with one run of tap sums; every size that
  // sizes_ok allows fits (at most 87568 bytes, N = 16, K = 64, P = 8)
  if (sos::k5_smem_floats(N, K, P, fuse_taps != 0, 1) > sos::kMaxSmemFloats) return sos::kBadSize;
  const cudaError_t err = sos::launch_tf_mse<FDN_N>(pivot != 0, with_dbar != 0, fuse_taps != 0,
    static_cast<const float2*>(D), static_cast<const float*>(bt), static_cast<const float*>(at),
    static_cast<const float*>(U), static_cast<const float*>(b), static_cast<const float*>(c),
    static_cast<const float2*>(X), static_cast<const float*>(t), static_cast<float2*>(Dbar),
    static_cast<float2*>(Gbar), static_cast<float*>(partials), scale, M, K, P, w_scale, off,
    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
