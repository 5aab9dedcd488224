// Hand-written Hopper (sm_90a) kernels of K2, K3f, K3b and K5 for
// 17 <= N <= 64 channels on the register-resident core of fdn_reg.cuh, N
// a run-time argument.  Linked into the looped library (cuda_build.
// LIB_UNITS: fdn_loop.cu and this file), with its own C entry points
// fl_reg_* at the end of this file; the wrappers (flamo_tpu_torch/ops/
// fdn_kernels.py, ops/sos_kernels.py) take these kernels where they take
// the size and fdn_loop.cu's shared-memory kernels elsewhere.  Every
// launch goes on the stream it is given, allocates nothing, and returns
// cudaGetLastError(), or kBadSize for sizes it does not take.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py):
//   reg_solve_kernel       (K2 looped)  <- _fdn_kernel,            pallas_call at :277
//   reg_tf_fwd_kernel      (K3f looped) <- _fdn_tf_kernel,         pallas_call at :451
//   reg_tf_bwd_kernel      (K3b looped) <- _fdn_tf_bwd_kernel,     pallas_call at :474
//   reg_sos_tf_mse_kernel  (K5 looped)  <- _fdn_sos_tf_mse_kernel, pallas_call at :1376
// Each computes the same function as fdn_loop.cu's ge_loop_solve_kernel,
// ge_loop_tf_fwd_kernel, ge_loop_tf_bwd_kernel and
// ge_loop_sos_tf_mse_kernel, with the same layouts and pivot rule.
//
// What bounds them on an H100: operations.  At M = 48001 bins K2's
// pivoted elimination is ~0.07 ms of FP32 work at N = 32 and ~0.53 ms at
// 64 (67 TFLOP/s) against ~0.01 ms of D, B and Y; K3f adds the rhs and
// the projection (~0.07 and ~0.53 ms), K3b the cotangents (U y and the
// rank-one U_bar, ~0.08 and ~0.56 ms); K5 adds the adjoint solve, each
// channel's cascade and the tap sums, ~0.11 and ~0.65 ms
// (chip_smoke.kernel_work).  The shared-memory core they replace sat at
// 15-60x those bounds: every term of a row update loaded and stored its
// own row's entry in shared memory (three accesses for four FMAs), a
// warp's system alone took 34.8 KB at N = 64 (6 warps an SM for K2 and
// K3f), and K3b and K5 kept a copy of their sums over bins per warp
// (K3b's N^2 + 2N + 1 floats, 16.9 KB at N = 64: 4 warps an SM; K5's
// ~72 KB a warp at N = 64, K = 12, P = 3: 2 warps).  Here a row lives in
// registers, so a row update is FMAs on registers and 16-byte broadcast
// loads of the pivot row; a bin's shared memory shrinks to its pivot
// buffers and vectors (1.3 KB at N = 32, 5.8 KB at 64); registers, not
// shared memory, set the occupancy.
//
// K3b's and K5's sums over bins (U_bar, b_bar, c_bar, K5's loss and, with
// fused taps, its 2 P K N tap sums) are kept once a block: after its
// solves each bin parks its per-bin vectors in its slot of a tile of the
// block's bins in shared memory (bb d (K5: bb dp) and y for U_bar,
// Re(bb d) and Re(tb y) for b_bar and c_bar; K5's t_n = Gam_bar_n Gam_n
// and z for the tap sums and (|tf X| - t)^2, K3b's loss slot 0), and at
// each tile boundary the block's threads add the tile into the block's
// one shared copy of the sums, each thread at fixed indices: U_bar's
// real-part rank-T product entry by entry, and each (part, k, n)
// section's P tap sums over the tile's bins (its taps from the staged
// copy, the sums in registers across the tile).  The order is fixed,
// with no atomics, and each block writes one partials row as before
// (summed by the wrapper).  Each channel's cascade keeps sos_common.cuh's
// arithmetic (bin_phasor, pow2_scale, rescale_pair).
//
// A block holds `bins` groups (max_bins: K2 and K3f 4 bins at N <= 32,
// else 1; K3b and K5 8 and 4, so that a block's U, taps and sums serve
// more bins), fewer where shared memory runs out; the grid walks the bins
// with a stride and is at most the blocks resident on the card.  The
// launch bounds hold every kernel to 128 registers a thread, 16 warps an
// SM (K3f K2's, K3b K5's); at that cap ptxas spills a few loop invariants
// of some kernels (each reloaded a few times a bin, outside the
// elimination; PERF.md).  Ten kernels: K2 at H = 1 and 2 (the direction
// a run-time flag), K3f and K3b at H = 1 and 2, K5 at H = 1 and 2,
// pivoted or not (D_bar and the fused tap sums run-time flags; the
// pivoted adjoint runs through the forward elimination's code a second
// time).  The file compiles as six parts (FDN_REG_PART 1-6, one nvcc
// each, linked into one library; 0 or unset: all of it), so that ptxas
// works on the large unrolled kernels side by side.

#include <cfloat>
#include <cstddef>

#include "fdn_reg.cuh"
#include "sos_common.cuh"

#ifndef FDN_REG_PART
#define FDN_REG_PART 0
#endif
#define FDN_REG_IN(part) (FDN_REG_PART == 0 || FDN_REG_PART == (part))

namespace fdn {
namespace reg {

constexpr int kBadSize = -2;
constexpr int kSmemLimit = 232448;  // the dynamic shared memory a block may opt in to
enum Kind { kSolve = 0, kSos = 1, kTfFwd = 2, kTfBwd = 3 };

// a block's bins at most: K2 and K3f 4 warps of bins at N <= 32, one
// group above; K5 and K3b 8 and 4
__host__ __device__ inline int max_bins(int kind, int N) {
  const bool one = N <= 32;
  return kind == kSolve || kind == kTfFwd ? (one ? 4 : 1) : (one ? 8 : 4);
}

// the launch bounds: the most threads of a block, and blocks an SM, so
// that a thread gets at most 128 registers
constexpr int kSolveThreads = 128;
constexpr int kSolveBlocks = 4;
template <int H>
struct SosBounds {
  static constexpr int threads = H == 1 ? 256 : 512;
  static constexpr int blocks = H == 1 ? 2 : 1;
};

__host__ __device__ inline int tile_floats(int N) { return al4(8 * N + 3); }

__host__ __device__ inline int sum_floats(int N, int K, int P, bool fuse_taps) {
  return n_partials(N) + (fuse_taps ? 2 * P * K * N : 0);
}

// dynamic shared memory of a block of `bins` bins: U (row stride N | 1)
// and each bin's region; K3f also b and c; K5 b, c, the 2 P K N taps, its
// sums and the tile (a slot of 8 N + 3 floats a bin); K3b as K5 without
// taps (its sums n_partials(N), the loss slot 0)
inline size_t smem_bytes(int kind, int N, int K, int P, bool fuse_taps, int bins) {
  size_t floats = al4(N * loop::stride(N));
  if (kind != kSolve) floats += al4(2 * N);
  if (kind == kSos)
    floats += al4(2 * P * K * N) + al4(sum_floats(N, K, P, fuse_taps)) +
              static_cast<size_t>(bins) * tile_floats(N);
  if (kind == kTfBwd) floats += al4(n_partials(N)) + static_cast<size_t>(bins) * tile_floats(N);
  return 4 * floats + static_cast<size_t>(bins) * 8 * bin_float2s(N);
}

// a block's bins (0: the size is not taken)
inline int bins_for(int kind, int N, int K, int P, bool fuse_taps) {
  if (N < kMinN || N > kMaxN) return 0;
  if (kind == kSos && (K < 1 || K > sos::kMaxK || P < 1 || P > sos::kMaxP)) return 0;
  int b = 0;
  while (b < max_bins(kind, N) &&
         smem_bytes(kind, N, K, P, fuse_taps, b + 1) <= static_cast<size_t>(kSmemLimit))
    ++b;
  return b;
}

inline int block_threads(int kind, int N, int K, int P, bool fuse_taps) {
  return bins_for(kind, N, K, P, fuse_taps) * 32 * group_warps(N);
}

// K2: (I - diag(D_m) U) y_m = B_m, or with transpose the transposed system
// that its gradient needs.  D, B, Y (M, N) complex, U (N, N).
template <int H>
__global__ void __launch_bounds__(kSolveThreads, kSolveBlocks)
    reg_solve_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                     const float2* __restrict__ B, float2* __restrict__ Y, int N, int M,
                     int transpose) {
  extern __shared__ float4 smem[];
  int gi;
  const Group<H> g = make_group<H>(N, gi);
  const int G = group_warps(N), bins = blockDim.x / g.threads, S = loop::stride(N);
  float* sU = reinterpret_cast<float*>(smem);
  const Bin s = bin_at<H>(reinterpret_cast<float2*>(sU + al4(N * S)) + gi * bin_float2s(N), G);
  loop::stage_u(U, sU, N, S);
  __syncthreads();
  for (int m = blockIdx.x * bins + gi; m < M; m += gridDim.x * bins) {
    const size_t row0 = static_cast<size_t>(m) * N;
    float2 d = make_float2(0.0f, 0.0f), rhs = d, cp = d, z = d;
    if (g.row < N) {
      d = D[row0 + g.row];
      rhs = B[row0 + g.row];
    }
    if (transpose) {
      if (g.row < N && g.h == 0) s.d[g.row] = d;
      g.sync();
    }
    float2 a[kR], dinv = d;
    int pos = g.row;
    assemble<H>(a, d, s.d, sU, S, g, N, transpose != 0);
    eliminate<H, true, false>(a, rhs, pos, cp, z, dinv, g, s, G, N);
    back_substitute<H>(a, rhs, pos, dinv, s.y, g, N);
    for (int j = g.t; j < N; j += g.threads) Y[row0 + j] = s.y[j];
    g.sync();
  }
}

// The block's sums plus the tile's first nb slots: each thread its fixed
// indices of [U_bar, b_bar, c_bar, loss] and, with fuse_taps, of the
// (part, k, n) sections' P tap sums (the partials row's order, (part, p,
// k, n)), added slot by slot.  Every thread of the block calls it.
__device__ __forceinline__ void add_tile(const float* tile, int nb, float* sums, const float* sT,
                                         int N, int K, int P, bool fuse_taps) {
  const int TS = tile_floats(N), KN = K * N, PKN = P * KN;
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e - i * N;
    float acc = 0.0f;
    for (int q = 0; q < nb; ++q) {
      const float2* u = reinterpret_cast<const float2*>(tile + q * TS);
      const float2 ui = u[i], yj = u[N + j];
      acc += ui.x * yj.x - ui.y * yj.y;
    }
    sums[e] += acc;
  }
  // b_bar and c_bar lie at 6N.. of a slot, the loss at 8N + 2
  for (int e = threadIdx.x; e <= 2 * N; e += blockDim.x) {
    const int at = e < 2 * N ? 6 * N + e : 8 * N + 2;
    float acc = 0.0f;
    for (int q = 0; q < nb; ++q) acc += tile[q * TS + at];
    sums[N * N + e] += acc;
  }
  if (!fuse_taps) return;
  float* tsum = sums + n_partials(N);
  for (int it = threadIdx.x; it < 2 * KN; it += blockDim.x) {
    const int part = it / KN, kn = it - part * KN, n = kn % N;
    const float* cf = sT + part * PKN + kn;
    const float sign = part ? -1.0f : 1.0f;
    float* out = tsum + part * PKN + kn;
    for (int q = 0; q < nb; ++q) {
      const float* sl = tile + q * TS;
      const float2 tn = reinterpret_cast<const float2*>(sl)[2 * N + n];
      const float2 z = *reinterpret_cast<const float2*>(sl + 8 * N);
      const float2 sec = loop::horner(cf, P, KN, z);
      const float dd = cabs2(sec);
      if (!(dd > 0.0f)) continue;
      const float qi = __fdividef(sign, dd);
      float2 qv =
          make_float2((tn.x * sec.x + tn.y * sec.y) * qi, (tn.y * sec.x - tn.x * sec.y) * qi);
      for (int p = 0; p < P; ++p) {
        out[p * KN] += qv.x;
        if (p + 1 < P) qv = cmul(qv, z);
      }
    }
  }
}

// K5: the attenuated FDN's step, as fdn_loop.cu's ge_loop_sos_tf_mse_kernel
// (its note has the function, the cotangents and the partials row's
// layout): PIVOT runs the adjoint A^T w = c as a second pivoted
// elimination, without it the adjoint comes from the unpivoted factors
// (U^T z = c beside the elimination, then L^T w = z).  with_dbar writes
// D_bar, fuse_taps adds the tap sums (else Gbar gets the masked Gam_bar
// rows for K4b).  scale = 2 / M.
template <int H, bool PIVOT>
__global__ void __launch_bounds__(SosBounds<H>::threads, SosBounds<H>::blocks)
    reg_sos_tf_mse_kernel(const float2* __restrict__ D, const float* __restrict__ bt,
                          const float* __restrict__ at, const float* __restrict__ U,
                          const float* __restrict__ b, const float* __restrict__ c,
                          const float2* __restrict__ X, const float* __restrict__ t,
                          float2* __restrict__ Dbar, float2* __restrict__ Gbar,
                          float* __restrict__ partials, float scale, int N, int M, int K, int P,
                          float w_scale, float off, int with_dbar, int fuse_taps) {
  extern __shared__ float4 smem[];
  int gi;
  const Group<H> g = make_group<H>(N, gi);
  const int G = group_warps(N), bins = blockDim.x / g.threads, S = loop::stride(N);
  const int KN = K * N, PKN = P * KN, TS = tile_floats(N);
  const int NV = sum_floats(N, K, P, fuse_taps != 0);
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + al4(N * S);
  float* sc = sb + N;
  float* sT = sb + al4(2 * N);  // bt then at, each (P, K, N) as in global memory
  float* sums = sT + al4(2 * PKN);
  float* tile = sums + al4(NV);
  const Bin s = bin_at<H>(reinterpret_cast<float2*>(tile + bins * TS) + gi * bin_float2s(N), G);
  float* slot = tile + gi * TS;  // this group's: u, y, t (float2s), bb, cb, z, loss
  loop::stage_u(U, sU, N, S);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sb[i] = __ldg(b + i);
    sc[i] = __ldg(c + i);
  }
  for (int v = threadIdx.x; v < 2 * PKN; v += blockDim.x)
    sT[v] = v < PKN ? __ldg(bt + v) : __ldg(at + v - PKN);
  for (int v = threadIdx.x; v < NV; v += blockDim.x) sums[v] = 0.0f;
  __syncthreads();
  const bool live = g.row < N;
  const int n = g.row;  // the row's channel
  for (int base = blockIdx.x * bins; base < M; base += gridDim.x * bins) {
    const int m = base + gi;
    if (m < M) {
      const size_t row0 = static_cast<size_t>(m) * N;
      const float2 z = sos::bin_phasor(m, w_scale, off);
      float2* tu = reinterpret_cast<float2*>(slot);
      float2 dp = make_float2(0.0f, 0.0f), rhs = dp, w = dp;
      if (live) {  // the channel's guarded cascade, rescaled at each section
        float2 pb = make_float2(1.0f, 0.0f), pa = pb;
        for (int k = 0; k < K; ++k) {
          const float* cb = sT + k * N + n;
          const float sk = sos::pow2_scale(pa);
          pb = sos::scaled(cmul(pb, loop::horner(cb, P, KN, z)), sk);
          pa = sos::scaled(cmul(pa, loop::horner(cb + PKN, P, KN, z)), sk);
        }
        sos::rescale_pair(pb, pa);
        const float den = cabs2(pa);
        const bool gk = den != 0.0f;
        const float inv = 1.0f / (gk ? den : 1.0f);
        const float2 gam =
            gk ? make_float2((pb.x * pa.x + pb.y * pa.y) * inv, (pb.y * pa.x - pb.x * pa.y) * inv)
               : make_float2(FLT_EPSILON, 0.0f);
        const float2 d = D[row0 + n];
        dp = cmul(d, gam);
        rhs = make_float2(d.x * sb[n], d.y * sb[n]);
        if (g.h == 0) {  // Gam and its guard, parked in the tile slot for the cotangents
          tu[2 * N + n] = gam;
          slot[6 * N + n] = gk ? 1.0f : 0.0f;
        }
      }
      float2 a[kR];
      int pos = g.row;
      if (PIVOT) {  // y = A^{-1} D b, then w = A^{-T} c pivoted anew
        if (live && g.h == 0) {  // D Gam for A^T, the rhs for the first pass
          s.d[n] = dp;
          s.w[n] = rhs;
        }
        g.sync();
        const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {  // d, rhs and c from shared memory
          assemble<H>(a, live ? s.d[n] : zero, s.d, sU, S, g, N, pass == 1);
          pos = g.row;
          float2 r = !live ? zero : pass ? make_float2(sc[n], 0.0f) : s.w[n];
          float2 unused = zero, dinv = zero;
          eliminate<H, true, false>(a, r, pos, unused, unused, dinv, g, s, G, N);
          back_substitute<H>(a, r, pos, dinv, pass ? s.w : s.y, g, N);
        }
        if (live) w = s.w[n];
      } else {
        float2 cp = make_float2(live ? sc[n] : 0.0f, 0.0f), dinv = cp;
        assemble<H>(a, dp, s.d, sU, S, g, N, false);
        eliminate<H, false, true>(a, rhs, pos, cp, w, dinv, g, s, G, N);
        back_substitute<H>(a, rhs, pos, dinv, s.y, g, N);
        lt_solve<H>(a, w, g, s, G, N);
      }
      // tf = c^T y, its cotangent tb and the squared error, on the
      // group's first warp
      if (g.warp == 0) {
        float2 tf = make_float2(0.0f, 0.0f);
        for (int i = g.lane; i < N; i += 32) {
          tf.x += sc[i] * s.y[i].x;
          tf.y += sc[i] * s.y[i].y;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          tf.x += __shfl_xor_sync(kFull, tf.x, o);
          tf.y += __shfl_xor_sync(kFull, tf.y, o);
        }
        float diff;
        const float2 tb = loop::mse_cotangent(tf, X[m], t[m], scale, diff);
        if (g.lane == 0) {
          s.scal[0] = tb;
          *reinterpret_cast<float2*>(slot + 8 * N) = z;
          slot[8 * N + 2] = diff * diff;
        }
      }
      g.sync();
      if (live && g.h == 0) {  // the row's cotangents, parked in the tile
        const float2 tb = s.scal[0];
        const float2 d = D[row0 + n];
        const float2 gam = tu[2 * N + n];
        const bool gk = slot[6 * N + n] != 0.0f;
        const float2 dp = cmul(d, gam);
        const float2 bb = cmul(tb, w);
        float ur = 0.0f, ui = 0.0f;
        for (int j = 0; j < N; ++j) {
          const float u = sU[n * S + j];
          ur += u * s.y[j].x;
          ui += u * s.y[j].y;
        }
        const float2 dpbar = cmul(bb, make_float2(ur, ui));
        const float2 gambar = cmul(dpbar, d);
        if (with_dbar) {
          float2 db = cmul(dpbar, gam);
          db.x += bb.x * sb[n];
          db.y += bb.y * sb[n];
          Dbar[row0 + n] = db;
        }
        const float2 yn = s.y[n];
        tu[n] = cmul(bb, dp);
        tu[N + n] = yn;
        slot[6 * N + n] = cmul(bb, d).x;
        slot[7 * N + n] = cmul(tb, yn).x;
        if (fuse_taps)
          tu[2 * N + n] = gk ? cmul(gambar, gam) : make_float2(0.0f, 0.0f);
        else
          Gbar[row0 + n] = gk ? gambar : make_float2(0.0f, 0.0f);
      }
    }
    __syncthreads();
    add_tile(tile, min(bins, M - base), sums, sT, N, K, P, fuse_taps != 0);
    __syncthreads();
  }
  for (int v = threadIdx.x; v < NV; v += blockDim.x)
    partials[static_cast<size_t>(blockIdx.x) * NV + v] = sums[v];
}

// K3f: tf_m = c^T y_m, y_m = (I - diag(D_m) U)^{-1} diag(D_m) b, pivoted, as
// fdn_loop.cu's ge_loop_tf_fwd_kernel: K2's elimination with the rhs
// d_r b_r, then tf by project's butterfly on the group's first warp (the
// shared-memory kernel's order of sums).  TF (M,), Y (M, N) complex, Y
// kept for K3b.
template <int H>
__global__ void __launch_bounds__(kSolveThreads, kSolveBlocks)
    reg_tf_fwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      float2* __restrict__ TF, float2* __restrict__ Y, int N, int M) {
  extern __shared__ float4 smem[];
  int gi;
  const Group<H> g = make_group<H>(N, gi);
  const int G = group_warps(N), bins = blockDim.x / g.threads, S = loop::stride(N);
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + al4(N * S);
  float* sc = sb + N;
  const Bin s = bin_at<H>(reinterpret_cast<float2*>(sb + al4(2 * N)) + gi * bin_float2s(N), G);
  loop::stage_ubc(U, b, c, sU, sb, sc, N, S);
  __syncthreads();
  for (int m = blockIdx.x * bins + gi; m < M; m += gridDim.x * bins) {
    const size_t row0 = static_cast<size_t>(m) * N;
    float2 d = make_float2(0.0f, 0.0f), rhs = d, unused = d;
    if (g.row < N) {
      d = D[row0 + g.row];
      rhs = make_float2(d.x * sb[g.row], d.y * sb[g.row]);
    }
    float2 a[kR], dinv = d;
    int pos = g.row;
    assemble<H>(a, d, s.d, sU, S, g, N, false);
    eliminate<H, true, false>(a, rhs, pos, unused, unused, dinv, g, s, G, N);
    back_substitute<H>(a, rhs, pos, dinv, s.y, g, N);
    if (g.warp == 0) {
      const float2 tf = loop::project(sc, s.y, N, g.lane);
      if (g.lane == 0) TF[m] = tf;
    }
    for (int j = g.t; j < N; j += g.threads) Y[row0 + j] = s.y[j];
    g.sync();
  }
}

// K3b: w_m = A_m^{-T} c a bin by a pivoted elimination of the transposed
// system (as K5's pivoted second pass), then tf's cotangents, as
// fdn_loop.cu's ge_loop_tf_bwd_kernel: D_bar_n = tb w_n ((U y)_n + b_n)
// per bin, and the block's row of partials [U_bar, b_bar, c_bar, 0] from
// K5's tile (bb d and y for U_bar, Re(bb d) and Re(tb y) for b_bar and
// c_bar, the loss slot 0), added once a tile by add_tile.  Y (M, N) is
// K3f's, TFB (M,) JAX's cotangent of tf.
template <int H>
__global__ void __launch_bounds__(SosBounds<H>::threads, SosBounds<H>::blocks)
    reg_tf_bwd_kernel(const float2* __restrict__ D, const float* __restrict__ U,
                      const float* __restrict__ b, const float* __restrict__ c,
                      const float2* __restrict__ Y, const float2* __restrict__ TFB,
                      float2* __restrict__ Dbar, float* __restrict__ partials, int N, int M) {
  extern __shared__ float4 smem[];
  int gi;
  const Group<H> g = make_group<H>(N, gi);
  const int G = group_warps(N), bins = blockDim.x / g.threads, S = loop::stride(N);
  const int NV = n_partials(N), TS = tile_floats(N);
  float* sU = reinterpret_cast<float*>(smem);
  float* sb = sU + al4(N * S);
  float* sc = sb + N;
  float* sums = sb + al4(2 * N);
  float* tile = sums + al4(NV);
  const Bin s = bin_at<H>(reinterpret_cast<float2*>(tile + bins * TS) + gi * bin_float2s(N), G);
  float* slot = tile + gi * TS;  // this group's: u, y (float2s), bb, cb, loss
  loop::stage_ubc(U, b, c, sU, sb, sc, N, S);
  for (int v = threadIdx.x; v < NV; v += blockDim.x) sums[v] = 0.0f;
  __syncthreads();
  const bool live = g.row < N;
  const int n = g.row;  // the row's channel
  for (int base = blockIdx.x * bins; base < M; base += gridDim.x * bins) {
    const int m = base + gi;
    if (m < M) {
      const size_t row0 = static_cast<size_t>(m) * N;
      float2 d = make_float2(0.0f, 0.0f);
      if (live) d = D[row0 + n];
      if (live && g.h == 0) s.d[n] = d;  // d_j for A^T
      for (int j = g.t; j < N; j += g.threads) s.y[j] = Y[row0 + j];
      g.sync();
      float2 a[kR], rhs = make_float2(live ? sc[n] : 0.0f, 0.0f), unused = d, dinv = d;
      int pos = g.row;
      assemble<H>(a, d, s.d, sU, S, g, N, true);
      eliminate<H, true, false>(a, rhs, pos, unused, unused, dinv, g, s, G, N);
      back_substitute<H>(a, rhs, pos, dinv, s.w, g, N);
      if (live && g.h == 0) {  // the row's cotangents, parked in the tile
        const float2 tb = TFB[m];
        const float2 bb = cmul(tb, s.w[n]);
        float ur = 0.0f, ui = 0.0f;
        for (int j = 0; j < N; ++j) {
          const float u = sU[n * S + j];
          ur += u * s.y[j].x;
          ui += u * s.y[j].y;
        }
        Dbar[row0 + n] = cmul(bb, make_float2(ur + sb[n], ui));
        const float2 bbd = cmul(bb, d), yn = s.y[n];
        float2* tu = reinterpret_cast<float2*>(slot);
        tu[n] = bbd;
        tu[N + n] = yn;
        slot[6 * N + n] = bbd.x;
        slot[7 * N + n] = cmul(tb, yn).x;
        if (n == 0) slot[8 * N + 2] = 0.0f;
      }
    }
    __syncthreads();
    add_tile(tile, min(bins, M - base), sums, nullptr, N, 0, 0, false);
    __syncthreads();
  }
  for (int v = threadIdx.x; v < NV; v += blockDim.x)
    partials[static_cast<size_t>(blockIdx.x) * NV + v] = sums[v];
}

using SolveKernel = void (*)(const float2*, const float*, const float2*, float2*, int, int, int);
using SosKernel = void (*)(const float2*, const float*, const float*, const float*,
                           const float*, const float*, const float2*, const float*, float2*,
                           float2*, float*, float, int, int, int, int, float, float, int, int);

using TfFwdKernel = void (*)(const float2*, const float*, const float*, const float*, float2*,
                            float2*, int, int);
using TfBwdKernel = void (*)(const float2*, const float*, const float*, const float*,
                            const float2*, const float2*, float2*, float*, int, int);

// each part's kernels
SolveKernel solve_kernel_of(int H);            // part 1
SosKernel sos_kernel_h1(bool pivot);           // part 2
SosKernel sos_kernel_h2_pivot();               // part 3
SosKernel sos_kernel_h2_nopivot();             // part 4
TfFwdKernel tf_fwd_kernel_of(int H);           // part 5
TfBwdKernel tf_bwd_kernel_of(int H);           // part 6

#if FDN_REG_IN(1)
SolveKernel solve_kernel_of(int H) {
  if (H == 1) return reg_solve_kernel<1>;
  return reg_solve_kernel<2>;
}
#endif
#if FDN_REG_IN(2)
SosKernel sos_kernel_h1(bool pivot) {
  if (pivot) return reg_sos_tf_mse_kernel<1, true>;
  return reg_sos_tf_mse_kernel<1, false>;
}
#endif
#if FDN_REG_IN(3)
SosKernel sos_kernel_h2_pivot() { return reg_sos_tf_mse_kernel<2, true>; }
#endif
#if FDN_REG_IN(4)
SosKernel sos_kernel_h2_nopivot() { return reg_sos_tf_mse_kernel<2, false>; }
#endif
#if FDN_REG_IN(5)
TfFwdKernel tf_fwd_kernel_of(int H) {
  if (H == 1) return reg_tf_fwd_kernel<1>;
  return reg_tf_fwd_kernel<2>;
}
#endif
#if FDN_REG_IN(6)
TfBwdKernel tf_bwd_kernel_of(int H) {
  if (H == 1) return reg_tf_bwd_kernel<1>;
  return reg_tf_bwd_kernel<2>;
}
#endif

#if FDN_REG_IN(1)
inline SolveKernel solve_kernel(int N) { return solve_kernel_of(threads_a_row(N)); }

inline SosKernel sos_kernel(int N, bool pivot) {
  if (threads_a_row(N) == 1) return sos_kernel_h1(pivot);
  return pivot ? sos_kernel_h2_pivot() : sos_kernel_h2_nopivot();
}

inline TfFwdKernel tf_fwd_kernel(int N) { return tf_fwd_kernel_of(threads_a_row(N)); }

inline TfBwdKernel tf_bwd_kernel(int N) { return tf_bwd_kernel_of(threads_a_row(N)); }

// a grid's blocks as the C interface returns them: the count, or -1000 -
// the CUDA error while sizing it, or kBadSize
int grid_or_error(int blocks) {
  if (blocks > 0) return blocks;
  const int err = static_cast<int>(cudaGetLastError());
  return err != 0 ? -1000 - err : kBadSize;
}

// Set a kernel's dynamic shared memory (opting in above 48 KB); its blocks
// resident on an SM (0 on an error, read by the caller from
// cudaGetLastError()).
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int threads) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

// a block's warps resident on an SM for a kind without taps (K2, K3f,
// K3b), or a negative code
template <typename Kernel>
int resident_warps(Kernel kernel, int kind, int N) {
  const int bins = bins_for(kind, N, 0, 0, false);
  if (bins < 1) return kBadSize;
  const int threads = block_threads(kind, N, 0, 0, false);
  const int per_sm = resident_blocks(kernel, smem_bytes(kind, N, 0, 0, false, bins), threads);
  return per_sm > 0 ? per_sm * threads / 32 : grid_or_error(0);
}

// the grid: at most the blocks resident on the card at once, and no more
// than the bins need; 0 on an error
template <typename Kernel>
int configure(Kernel kernel, size_t smem, int threads, int bins, int M) {
  const int per_sm = resident_blocks(kernel, smem, threads);
  int device = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int need = (M + bins - 1) / bins;
  return need < sms * per_sm ? need : sms * per_sm;
}

#endif

}  // namespace reg
}  // namespace fdn

#if FDN_REG_IN(1)
extern "C" {

// a block's bins of kind 0 (K2), 1 (K5), 2 (K3f) or 3 (K3b) at N (K, P
// and fuse_taps: K5's only), 0 where the kernel does not take the size;
// its dynamic shared memory for ``bins`` bins; a bin's warps
int fl_reg_bins(int kind, int N, int K, int P, int fuse_taps) {
  return fdn::reg::bins_for(kind, N, K, P, fuse_taps != 0);
}

long long fl_reg_smem_bytes(int kind, int N, int K, int P, int fuse_taps, int bins) {
  return static_cast<long long>(fdn::reg::smem_bytes(kind, N, K, P, fuse_taps != 0, bins));
}

int fl_reg_group_warps(int N) { return fdn::reg::group_warps(N); }

// warps resident on an SM as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives them for the kernel's block at these sizes (K2's one kernel serves
// both directions, K5's D_bar is a run-time flag); negative on an error
int fl_reg_solve_resident_warps(int N) {
  using namespace fdn::reg;
  return resident_warps(solve_kernel(N), kSolve, N);
}

int fl_reg_tf_fwd_resident_warps(int N) {
  using namespace fdn::reg;
  return resident_warps(tf_fwd_kernel(N), kTfFwd, N);
}

int fl_reg_tf_bwd_resident_warps(int N) {
  using namespace fdn::reg;
  return resident_warps(tf_bwd_kernel(N), kTfBwd, N);
}

int fl_reg_sos_resident_warps(int pivot, int fuse_taps, int N, int K, int P) {
  using namespace fdn::reg;
  const bool fuse = fuse_taps != 0;
  const int bins = bins_for(kSos, N, K, P, fuse);
  if (bins < 1) return kBadSize;
  const int threads = block_threads(kSos, N, K, P, fuse);
  const int per_sm = resident_blocks(sos_kernel(N, pivot != 0),
                                     smem_bytes(kSos, N, K, P, fuse, bins), threads);
  return per_sm > 0 ? per_sm * threads / 32 : grid_or_error(0);
}

// K2 both ways, as fdn_loop.cu's fl_solve_launch
int fl_reg_solve_launch(int N, int transpose, const void* D, const void* U, const void* B,
                        void* Y, int M, void* stream) {
  using namespace fdn::reg;
  const int bins = bins_for(kSolve, N, 0, 0, false);
  if (bins < 1 || M < 1) return kBadSize;
  const int threads = block_threads(kSolve, N, 0, 0, false);
  const size_t smem = smem_bytes(kSolve, N, 0, 0, false, bins);
  const SolveKernel kernel = solve_kernel(N);
  const int blocks = configure(kernel, smem, threads, bins, M);
  if (blocks > 0)
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(D), static_cast<const float*>(U),
        static_cast<const float2*>(B), static_cast<float2*>(Y), N, M, transpose != 0);
  return static_cast<int>(cudaGetLastError());
}

// K3f, as fdn_loop.cu's fl_tf_fwd_launch; a grid that could not be sized
// returns its CUDA error, or kBadSize, and launches nothing
int fl_reg_tf_fwd_launch(int N, const void* D, const void* U, const void* b, const void* c,
                         void* TF, void* Y, int M, void* stream) {
  using namespace fdn::reg;
  const int bins = bins_for(kTfFwd, N, 0, 0, false);
  if (bins < 1 || M < 1) return kBadSize;
  const int threads = block_threads(kTfFwd, N, 0, 0, false);
  const size_t smem = smem_bytes(kTfFwd, N, 0, 0, false, bins);
  const TfFwdKernel kernel = tf_fwd_kernel(N);
  const int blocks = configure(kernel, smem, threads, bins, M);
  if (blocks < 1) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? err : kBadSize;
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(D), static_cast<const float*>(U), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float2*>(TF), static_cast<float2*>(Y), N, M);
  return static_cast<int>(cudaGetLastError());
}

// K3b's grid (its rows of partials); negative on an error
int fl_reg_tf_bwd_grid(int N, int M) {
  using namespace fdn::reg;
  const int bins = bins_for(kTfBwd, N, 0, 0, false);
  if (bins < 1 || M < 1) return kBadSize;
  return grid_or_error(configure(tf_bwd_kernel(N), smem_bytes(kTfBwd, N, 0, 0, false, bins),
                                 block_threads(kTfBwd, N, 0, 0, false), bins, M));
}

// ``blocks`` is fl_reg_tf_bwd_grid's for the same (N, M): partials holds
// that many rows of N^2 + 2N + 1 floats, Dbar is (M, N) complex
int fl_reg_tf_bwd_launch(int N, const void* D, const void* U, const void* b, const void* c,
                         const void* Y, const void* TFB, void* Dbar, void* partials, int M,
                         int blocks, void* stream) {
  using namespace fdn::reg;
  const int bins = bins_for(kTfBwd, N, 0, 0, false);
  if (bins < 1 || M < 1 || blocks < 1) return kBadSize;
  const size_t smem = smem_bytes(kTfBwd, N, 0, 0, false, bins);
  const TfBwdKernel kernel = tf_bwd_kernel(N);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) == cudaSuccess)
    kernel<<<blocks, block_threads(kTfBwd, N, 0, 0, false), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(D), static_cast<const float*>(U),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<const float2*>(Y), static_cast<const float2*>(TFB),
        static_cast<float2*>(Dbar), static_cast<float*>(partials), N, M);
  return static_cast<int>(cudaGetLastError());
}

// K5's grid (its rows of partials); negative on an error
int fl_reg_sos_tf_mse_grid(int pivot, int fuse_taps, int N, int K, int P, int M) {
  using namespace fdn::reg;
  const bool fuse = fuse_taps != 0;
  const int bins = bins_for(kSos, N, K, P, fuse);
  if (bins < 1 || M < 1) return kBadSize;
  return grid_or_error(configure(sos_kernel(N, pivot != 0), smem_bytes(kSos, N, K, P, fuse, bins),
                                 block_threads(kSos, N, K, P, fuse), bins, M));
}

// ``blocks`` is fl_reg_sos_tf_mse_grid's for the same flags and sizes:
// partials holds that many rows of N^2 + 2N + 1 (+ 2 P K N with
// fuse_taps) floats; Dbar (with_dbar) and Gbar (without fuse_taps) are
// (M, N) complex, else null
int fl_reg_sos_tf_mse_launch(int N, int pivot, int with_dbar, int fuse_taps, const void* D,
                             const void* bt, const void* at, const void* U, const void* b,
                             const void* c, const void* X, const void* t, void* Dbar,
                             void* Gbar, void* partials, float scale, int M, int K, int P,
                             float w_scale, float off, int blocks, void* stream) {
  using namespace fdn::reg;
  const bool fuse = fuse_taps != 0;
  const int bins = bins_for(kSos, N, K, P, fuse);
  if (bins < 1 || M < 1 || blocks < 1) return kBadSize;
  const size_t smem = smem_bytes(kSos, N, K, P, fuse, bins);
  const SosKernel kernel = sos_kernel(N, pivot != 0);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) == cudaSuccess)
    kernel<<<blocks, block_threads(kSos, N, K, P, fuse), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(D), static_cast<const float*>(bt),
        static_cast<const float*>(at), static_cast<const float*>(U),
        static_cast<const float*>(b), static_cast<const float*>(c),
        static_cast<const float2*>(X), static_cast<const float*>(t), static_cast<float2*>(Dbar),
        static_cast<float2*>(Gbar), static_cast<float*>(partials), scale, N, M, K, P, w_scale,
        off, with_dbar != 0, fuse);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
#endif
