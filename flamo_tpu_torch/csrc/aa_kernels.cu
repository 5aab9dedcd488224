// Hand-written Hopper (sm_90a) kernels of the active-acoustics path, with a
// plain C interface that flamo_tpu_torch/ops/aa_kernels.py loads through
// ctypes.  Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(), or kBadN when asked for another
// microphone count than the FDN_N this library was built for, or
// kBadSize for sizes the kernel does not take.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py):
//   aa_tf_mse_kernel      (K8) <- _aa_tf_mse_kernel,      pallas_call at :1602
//   aa_taps_tf_mse_kernel (K9) <- _aa_taps_tf_mse_kernel, pallas_call at :1820
//     (precision 'highest'), and aa_taps_tf_mse_tc_kernel, the same TPU
//     kernel on the tensor cores for 'high' and 'default' (below K9)
//
// Both compute, per rfft bin m, for the frozen room H_m (N mics x L
// loudspeakers), the mixer response G_m (L x N) and the frozen rhs r_m:
//     A_m = I_N - H_m G_m,   y_m = A_m^{-1} r_m,
//     loss = (1/(M N)) sum_{m,i} (|y_mi| - t_mi)^2,
// and the mixer cotangent through one adjoint solve (JAX's convention:
// unconjugated transposes):
//     w_i = (2/(M N)) (|y_i| - t_i) / |y_i| conj(y_i),  A^T xi = w,
//     S_jk = (H^T xi)_j y_k,  dloss/dRe G = Re S,  dloss/dIm G = -Im S.
// All operands are channels-major real rows (rows, M), bins last, as the
// TPU kernels take them: row i*L + j of hr/hi is H[i, j], row j*N + k of
// gr/gi and of the S rows is G[j, k].  Thread m reads element m of a row,
// so a warp reads 128 contiguous bytes of each row.
//
// ONE THREAD OWNS ONE BIN.  The N x N loop matrix, y, w and xi stay in
// registers (unrolled over the compile-time N); H and G are never held
// whole: A accumulates sum_j H[:, j] G[j, :] as L rank-1 updates over a
// runtime loop, so a 13-loudspeaker rig needs no new instantiation.  The
// solve is fdn_ge.cuh's: pivoted (with a register copy of A for the
// transposed system), or no-pivot with the adjoint from the same L/U
// factors, as K1.  The adjoint re-reads H (from L2 where it still is).
//
// K8 takes the mixer response rows and writes the loss row (M,) and the S
// rows (L N, M).  What bounds it on an H100: bytes.  At N = 4, L = 13,
// M = 48001 it reads 220 rows (H and G re/im, r re/im, t) and writes 105
// (S re/im, loss): ~62 MB, more than the 50 MB L2, ~0.019 ms at 3.35 TB/s,
// against a few kFLOP per bin (~0.003 ms at 67 TFLOP/s).
//
// K9 takes the envelope-folded taps tw (order, L N) instead of G and makes
// G_m = sum_t tw[t] P_t(m) from the DFT powers P_t(m) = e^{-j 2 pi t (m +
// off) / nfft}, with the angle from the exact integer t (m + off) mod
// nfft (the TPU kernel builds the powers by log-doubling a float32
// phasor).  Its tap cotangent tb[t, jk] = sum_m Re S_jk P_r,t - Im S_jk
// P_i,t is a sum over every bin.  What bounds it: operations.  Two order x
// L N real contractions on re and im per bin (~41.6 kFLOP at order = 100,
// L N = 52) plus the solve (~3 kFLOP): ~2.2 GFLOP at M = 48001, ~0.033 ms
// at 67 TFLOP/s of FP32 (the rows are ~23 MB, ~0.007 ms).  Two kernels
// compute it: aa_taps_tf_mse_kernel, FP32 on the CUDA cores (precision
// 'highest'), and aa_taps_tf_mse_tc_kernel, TF32 on the tensor cores
// ('high', 'default').  They share the frame of a tile (tile_powers,
// tile_solve below):
//   - a block of kTapThreads = 256 threads (8 warps) takes a tile of
//     kTapBins = 64 bins at a time, grid-stride over the tiles, the grid
//     sized to fill the SMs (two blocks an SM);
//   - the powers go to shared memory tap-major (row t: Re P_t of the
//     tile's bins, then Im P_t), four lanes a bin, exact integer phases;
//   - G goes to shared memory row jk (the tile's Gr, then Gi), the N x N
//     solve runs on four lanes a bin whose sums are added by xor
//     shuffles, and S overwrites G as [Sr | -Si];
//   - the tap cotangent [Pr | Pi]^T [Sr; -Si] is held in registers over
//     all the block's tiles; each block writes its partial (blocks, order,
//     L N) once, and the wrapper adds them with torch.sum in a fixed order,
//     so the result is deterministic on a given card.  More of tb than the
//     registers hold takes another pass over the bins.
// This kernel is precision 'highest', FP32 on CUDA cores.
//
// The ragged edge m >= M is masked: K8's dead threads return; K9's run
// with H = r = t = 0, which makes A = I, y = 0 and every cotangent exactly
// 0, and still take part in the block's barriers.

#include <cstddef>
#include <cstdint>

#include "aa_tile.cuh"
#include "fdn_ge.cuh"

namespace aa {

using fdn::cabs2;
using fdn::cmul;

constexpr int kThreads = 128;  // K8: bins per block
constexpr int kMaxN = 8;
constexpr int kBadN = -1;
constexpr int kBadSize = -2;
// Given the accumulated H G (s) and the bin's rhs and targets: A = I - s,
// y = A^{-1} r, the bin's loss sum_i (|y_i| - t_i)^2 (returned), and the
// adjoint xi = A^{-T} w.
template <int N, bool PIVOT>
__device__ __forceinline__ float solve_loss_adjoint(const float2 (&s)[N][N], const float2 (&r)[N],
                                                    const float (&t)[N], float scale,
                                                    float2 (&y)[N], float2 (&xi)[N]) {
  float2 A[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) A[i][k] = make_float2((i == k ? 1.0f : 0.0f) - s[i][k].x, -s[i][k].y);
  }
  float2 A0[N][N];
  if constexpr (PIVOT) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) A0[i][k] = A[i][k];
    }
  }
  float2 b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) b[i] = r[i];
  if constexpr (PIVOT) {
    fdn::ge_pivot<N>(A, b, y);
  } else {
    fdn::ge_nopivot_factors<N>(A, b, y);
  }
  float loss = 0.0f;
  float2 w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float est = sqrtf(cabs2(y[i]));
    const float diff = est - t[i];
    loss += diff * diff;
    // safe divide: dead and zero bins have est = 0 and diff = 0
    const float g = scale * diff / (est > 0.0f ? est : 1.0f);
    w[i] = make_float2(g * y[i].x, -g * y[i].y);
  }
  if constexpr (PIVOT) {
    float2 At[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) At[i][k] = A0[k][i];
    }
    fdn::ge_pivot<N>(At, w, xi);
  } else {
    fdn::transpose_solve_from_factors<N>(A, w, xi);
  }
  return loss;
}

__device__ __forceinline__ float2 load2(const float* __restrict__ re, const float* __restrict__ im,
                                        size_t idx, bool live) {
  return live ? make_float2(__ldg(re + idx), __ldg(im + idx)) : make_float2(0.0f, 0.0f);
}

// (H^T xi)_j for loudspeaker j, H re-read from its rows
template <int N>
__device__ __forceinline__ float2 h_transpose_xi(const float* __restrict__ hr,
                                                 const float* __restrict__ hi,
                                                 const float2 (&xi)[N], int j, int L, size_t Ms,
                                                 int m, bool live) {
  float2 a = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i)
    cadd_to(a, cmul(load2(hr, hi, static_cast<size_t>(i * L + j) * Ms + m, live), xi[i]));
  return a;
}

// K8: loss row and S rows from the mixer-response rows.
template <int N, bool PIVOT>
__global__ void __launch_bounds__(kThreads)
    aa_tf_mse_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                     const float* __restrict__ gr, const float* __restrict__ gi,
                     const float* __restrict__ rr, const float* __restrict__ ri,
                     const float* __restrict__ t, float* __restrict__ loss_row,
                     float* __restrict__ sgr, float* __restrict__ sgi, float scale, int L, int M) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const size_t Ms = static_cast<size_t>(M);
  float2 s[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) s[i][k] = make_float2(0.0f, 0.0f);
  }
#pragma unroll 1
  for (int j = 0; j < L; ++j) {
    float2 h[N], g[N];
#pragma unroll
    for (int i = 0; i < N; ++i) h[i] = load2(hr, hi, static_cast<size_t>(i * L + j) * Ms + m, true);
#pragma unroll
    for (int k = 0; k < N; ++k) g[k] = load2(gr, gi, static_cast<size_t>(j * N + k) * Ms + m, true);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) cadd_to(s[i][k], cmul(h[i], g[k]));
    }
  }
  float2 r[N], y[N], xi[N];
  float tv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r[i] = load2(rr, ri, static_cast<size_t>(i) * Ms + m, true);
    tv[i] = __ldg(t + static_cast<size_t>(i) * Ms + m);
  }
  loss_row[m] = solve_loss_adjoint<N, PIVOT>(s, r, tv, scale, y, xi);
#pragma unroll 1
  for (int j = 0; j < L; ++j) {
    const float2 a = h_transpose_xi<N>(hr, hi, xi, j, L, Ms, m, true);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float2 sv = cmul(a, y[k]);
      const size_t o = static_cast<size_t>(j * N + k) * Ms + m;
      sgr[o] = sv.x;
      sgi[o] = sv.y;
    }
  }
}

// ---------------------------------------------------------------------------
// K9's tile frame, shared by its two kernels
// ---------------------------------------------------------------------------
constexpr int kTapBins = 64;                        // bins per tile
constexpr int kTapThreads = 256;                    // threads per block (8 warps)
constexpr int kTapWarps = kTapThreads / 32;
constexpr int kTapSplit = kTapThreads / kTapBins;   // lanes per bin (powers, solve)
constexpr int kTapStride = 2 * kTapBins + 4;        // floats a row of sP and sGS
static_assert(kTapStride % 32 == 4, "rows four banks apart");

// The solve of the tile at bin m0 from its G in sGS (row j N + k: the
// tile's Gr in columns [0, 64), Gi in [64, 128)): lanes 4 b .. 4 b + 3
// own bin b, lane q the loudspeakers j = q, q + kTapSplit, ...; they
// split H G over their loudspeakers, add their N x N sums by two xor
// shuffles (commutative, so every lane holds the same sum), run K8's
// solve (fdn_ge.cuh, pivot or no pivot) each, and write the S rows of
// their loudspeakers over G in sGS as store([Sr | -Si]).  Bins m >= M run
// with H = r = t = 0: A = I, y = 0 and S = 0.  Lane 0 of a bin writes its
// loss when `write_loss`.
template <int N, bool PIVOT, class Store>
__device__ __forceinline__ void tile_solve(const float* __restrict__ hr,
                                           const float* __restrict__ hi,
                                           const float* __restrict__ rr,
                                           const float* __restrict__ ri,
                                           const float* __restrict__ t,
                                           float* __restrict__ loss_row, float* __restrict__ sGS,
                                           float scale, int L, int M, int m0, bool write_loss,
                                           Store store) {
  const int b = threadIdx.x / kTapSplit, q = threadIdx.x % kTapSplit;
  const size_t Ms = static_cast<size_t>(M);
  const int m = m0 + b;
  const bool live = m < M;
  float2 s[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) s[i][k] = make_float2(0.0f, 0.0f);
  }
#pragma unroll 1
  for (int j = q; j < L; j += kTapSplit) {
    float2 h[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      h[i] = load2(hr, hi, static_cast<size_t>(i * L + j) * Ms + m, live);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float* gr = sGS + (j * N + k) * kTapStride + b;
      const float2 gv = make_float2(gr[0], gr[kTapBins]);
#pragma unroll
      for (int i = 0; i < N; ++i) cadd_to(s[i][k], cmul(h[i], gv));
    }
  }
#pragma unroll
  for (int x = 1; x < kTapSplit; x *= 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        s[i][k].x += __shfl_xor_sync(0xffffffffu, s[i][k].x, x);
        s[i][k].y += __shfl_xor_sync(0xffffffffu, s[i][k].y, x);
      }
    }
  }
  float2 r[N], y[N], xi[N];
  float tv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r[i] = load2(rr, ri, static_cast<size_t>(i) * Ms + m, live);
    tv[i] = live ? __ldg(t + static_cast<size_t>(i) * Ms + m) : 0.0f;
  }
  const float loss = solve_loss_adjoint<N, PIVOT>(s, r, tv, scale, y, xi);
  if (live && q == 0 && write_loss) loss_row[m] = loss;
#pragma unroll 1
  for (int j = q; j < L; j += kTapSplit) {
    const float2 a = h_transpose_xi<N>(hr, hi, xi, j, L, Ms, m, live);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float2 sv = cmul(a, y[k]);
      float* so = sGS + (j * N + k) * kTapStride + b;
      so[0] = store(sv.x);
      so[kTapBins] = store(-sv.y);
    }
  }
}

// ---------------------------------------------------------------------------
// K9 'highest': aa_taps_tf_mse_kernel<N, PIVOT, STAGE_TW>, FP32 on the CUDA
// cores, in the tile frame above.  Both contractions are register-tiled
// SIMT GEMMs out of shared memory, float4 loads into per-thread tiles of
// FP32 FMAs:
//   - synthesis [Gr; Gi] = [Pr; Pi] (128 x order) tw (order x L N): a
//     thread's tile is 4 bins (their Re and Im rows) by kSynJ = 4
//     columns jk, an outer product per tap t from one float4 of Pr, one
//     of Pi (row t of sP) and one of tw; the 16 x ceil(L N / 4) tiles go
//     round the block's threads, and each writes its G as float4s;
//   - tap cotangent tb = [Pr | Pi]^T [Sr; -Si]: a thread owns kCotT = 6
//     taps t = tq + a nT by kCotJ = 4 columns jk = jq + c nJ (nT =
//     ceil(order / 6), nJ = ceil(L N / 4)) and runs the 128 rows of bins
//     four at a time as dot products, float4s of rows t of sP and rows jk
//     of sGS; its 24 sums stay in registers over all the block's tiles.
//     The lanes take the tiles columns first: a quarter warp shares its
//     taps' rows (broadcasts) and reads consecutive rows jk, which the
//     stride of 132 floats puts on distinct banks.  At order = 100, L N =
//     52 that is 17 x 13 = 221 tiles for 256 threads (8 x 4 tiles, 169 of
//     them, taken taps first, measured 0.111 ms against 0.0997 on an
//     NVIDIA H100 80GB HBM3 at 700 W; 7 x 4, 6 x 5, 4 x 6, 8 x 3 and
//     4 x 8 all lay between: controls/k9_k2_designs).  More than 256 such
//     tiles (order x L N above 6144 of tb) take another pass over the
//     bins, recomputing powers, G and the solve.
// tw (order x L N, zero-padded to 4 columns a row) is staged in shared
// memory once a block where that leaves the SM its two blocks (f32_stage_tw;
// 20.8 KB at order = 100, L N = 52); otherwise its float4s come through
// L1 (__ldg).  Shared memory at order = 100, L N = 52: 4 x 132 x (100 +
// 52) + 20.8 KB = 101.1 KB a block, two blocks (16 warps) an SM, at most
// 128 registers a thread.  G is summed over t in order, an FMA a tap, as
// the previous kernel did; S comes from the four-lane solve and its sums.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; the design probes of
// controls/k9_k2_designs, each leaving one phase out of the first, 8 x 4
// version at 0.111 ms): the tap cotangent took ~0.042 ms, the synthesis
// ~0.030, the solve ~0.016 and the powers ~0.011; the contractions run
// at a third to a half of the FP32 rate, their float4 shared loads and
// the barriers between the phases in the way.
// ---------------------------------------------------------------------------
constexpr int kSynJ = 4;   // synthesis: columns jk of a thread's tile
constexpr int kSynR = 16;  // synthesis: tiles of 4 bins across the tile's 64
constexpr int kCotT = 6;   // cotangent: taps of a thread's tile
constexpr int kCotJ = 4;   // cotangent: columns jk of a thread's tile
static_assert(kSynR * 4 == kTapBins && kSynJ == 4, "float4s of 4 bins, 4 columns");

// The FP32 kernel's dynamic shared memory: the powers (order rows) and the
// G/S rows (L N), kTapStride floats each, and tw (order x round_up(L N, 4))
// when staged.
__host__ __device__ inline int f32_smem_bytes(int order, int LN, bool stage_tw) {
  return 4 * (kTapStride * (order + LN) + (stage_tw ? order * round_up(LN, 4) : 0));
}

// Stage tw when that leaves an SM as many blocks as without it (two while
// a block takes at most 115712 bytes: 228 KB an SM, 1 KB of it reserved a
// block) and a block can have it.
__host__ __device__ inline bool f32_stage_tw(int order, int LN) {
  constexpr int kTwoBlocks = 115712;
  const int with = f32_smem_bytes(order, LN, true), without = f32_smem_bytes(order, LN, false);
  return with <= kMaxSmem && (with <= kTwoBlocks || without > kTwoBlocks);
}

template <int N, bool PIVOT, bool STAGE_TW>
__global__ void __launch_bounds__(kTapThreads, 2)
    aa_taps_tf_mse_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                          const float* __restrict__ tw, const float* __restrict__ rr,
                          const float* __restrict__ ri, const float* __restrict__ t,
                          float* __restrict__ loss_row, float* __restrict__ partials, float scale,
                          int L, int M, int order, int nfft, int off_mod, float w_scale) {
  extern __shared__ float4 smem4[];
  const int LN = L * N, LN4 = round_up(LN, 4);
  float* sP = reinterpret_cast<float*>(smem4);  // [order][kTapStride]
  float* sGS = sP + order * kTapStride;          // [LN][kTapStride]
  float* sTW = sGS + LN * kTapStride;            // [order][LN4], when staged
  const int tid = threadIdx.x;
  const int n_tiles = (M + kTapBins - 1) / kTapBins;
  if constexpr (STAGE_TW) {  // read by the first synthesis, after a barrier
    for (int v = tid; v < order * LN4; v += kTapThreads) {
      const int c = v % LN4;
      sTW[v] = c < LN ? __ldg(tw + (v / LN4) * LN + c) : 0.0f;
    }
  }
  const int nT = (order + kCotT - 1) / kCotT, nJ = (LN + kCotJ - 1) / kCotJ;
  const int n_items = nT * nJ, n_syn = kSynR * ((LN + kSynJ - 1) / kSynJ);

#pragma unroll 1
  for (int i0 = 0; i0 < n_items; i0 += kTapThreads) {
    const int item = i0 + tid;
    const bool has_item = item < n_items;
    const int tq = has_item ? item / nJ : 0, jq = item % nJ;  // columns first
    // the rows of sP and sGS this thread's tb tile reads, clamped into
    // range (the clamped ones are not stored)
    int po[kCotT], so[kCotJ];
#pragma unroll
    for (int a = 0; a < kCotT; ++a) po[a] = min(tq + a * nT, order - 1) * kTapStride;
#pragma unroll
    for (int c = 0; c < kCotJ; ++c) so[c] = min(jq + c * nJ, LN - 1) * kTapStride;
    float acc[kCotT][kCotJ];
#pragma unroll
    for (int a = 0; a < kCotT; ++a) {
#pragma unroll
      for (int c = 0; c < kCotJ; ++c) acc[a][c] = 0.0f;
    }

#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile * kTapBins;
      tile_powers<kTapBins, kTapThreads>(sP, order, order, m0, nfft, off_mod, w_scale,
                                         KeepF32{});
      __syncthreads();

      // [Gr; Gi] = [Pr; Pi] tw: tile q is bins 4 rq .. 4 rq + 3, columns
      // 4 cq .. 4 cq + 3 (those past L N read zero taps and are not stored)
#pragma unroll 1
      for (int q = tid; q < n_syn; q += kTapThreads) {
        const int rq = q % kSynR, cq = q / kSynR;
        float gr[4][kSynJ], gi[4][kSynJ];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < kSynJ; ++c) gr[e][c] = gi[e][c] = 0.0f;
        }
        const float* pa = sP + 4 * rq;
        const float* wa = sTW + kSynJ * cq;
        const int n0 = kSynJ * cq;
#pragma unroll 4
        for (int tt = 0; tt < order; ++tt) {
          const float4 pr = *reinterpret_cast<const float4*>(pa + tt * kTapStride);
          const float4 pi = *reinterpret_cast<const float4*>(pa + tt * kTapStride + kTapBins);
          float w[kSynJ];
          if constexpr (STAGE_TW) {
            const float4 w4 = *reinterpret_cast<const float4*>(wa + tt * LN4);
            w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
          } else {
#pragma unroll
            for (int c = 0; c < kSynJ; ++c)
              w[c] = n0 + c < LN ? __ldg(tw + static_cast<size_t>(tt) * LN + n0 + c) : 0.0f;
          }
          const float p_r[4] = {pr.x, pr.y, pr.z, pr.w}, p_i[4] = {pi.x, pi.y, pi.z, pi.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int c = 0; c < kSynJ; ++c) {
              gr[e][c] += w[c] * p_r[e];
              gi[e][c] += w[c] * p_i[e];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kSynJ; ++c) {
          if (n0 + c < LN) {
            float* o = sGS + (n0 + c) * kTapStride + 4 * rq;
            *reinterpret_cast<float4*>(o) = make_float4(gr[0][c], gr[1][c], gr[2][c], gr[3][c]);
            *reinterpret_cast<float4*>(o + kTapBins) =
                make_float4(gi[0][c], gi[1][c], gi[2][c], gi[3][c]);
          }
        }
      }
      __syncthreads();

      tile_solve<N, PIVOT>(hr, hi, rr, ri, t, loss_row, sGS, scale, L, M, m0, i0 == 0,
                           KeepF32{});
      __syncthreads();

      // tb += [Pr | Pi]^T [Sr; -Si] on this thread's tile, four rows of
      // bins at a time
      if (has_item) {
#pragma unroll 4
        for (int k0 = 0; k0 < 2 * kTapBins; k0 += 4) {
          float4 p[kCotT], sv[kCotJ];
#pragma unroll
          for (int a = 0; a < kCotT; ++a) p[a] = *reinterpret_cast<const float4*>(sP + po[a] + k0);
#pragma unroll
          for (int c = 0; c < kCotJ; ++c)
            sv[c] = *reinterpret_cast<const float4*>(sGS + so[c] + k0);
#pragma unroll
          for (int a = 0; a < kCotT; ++a) {
#pragma unroll
            for (int c = 0; c < kCotJ; ++c) {
              acc[a][c] += p[a].x * sv[c].x;
              acc[a][c] += p[a].y * sv[c].y;
              acc[a][c] += p[a].z * sv[c].z;
              acc[a][c] += p[a].w * sv[c].w;
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites sP and sGS
    }

    float* __restrict__ out = partials + static_cast<size_t>(blockIdx.x) * order * LN;
#pragma unroll
    for (int a = 0; a < kCotT; ++a) {
#pragma unroll
      for (int c = 0; c < kCotJ; ++c) {
        const int tt = tq + a * nT, jk = jq + c * nJ;
        if (has_item && tt < order && jk < LN) out[static_cast<size_t>(tt) * LN + jk] = acc[a][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9 on the tensor cores: aa_taps_tf_mse_tc_kernel<N, PIVOT, PASSES>, for
// precision 'high' (PASSES = 3) and 'default' (PASSES = 1); 'highest'
// is aa_taps_tf_mse_kernel above.  The same function as K9, with its
// two real contractions as TF32 mma.sync.m16n8k8 products of split
// operands, hi = tf32(x) and lo = tf32(x - hi) (nearest, ties away from
// zero): 'high' adds a_lo b_hi, a_hi b_lo and a_hi b_hi (JAX's 3-pass
// bf16 'high' with TF32 for bf16), 'default' a_hi b_hi alone.  Products
// are summed in the tensor cores over one k-step and then added to FP32
// accumulators on the CUDA cores (mma_add says why).
//
// What bounds it: 2 x 4 x order x L N = 41.6 kFLOP of contraction a bin
// at order = 100, L N = 52, 2.0 GFLOP at M = 48001 and 6.0 GFLOP in three
// passes: 0.0121 ms at the 495 TFLOP/s of dense TF32 for 'high'; for
// 'default' the 22.5 MB of rows (0.0067 ms at 3.35 TB/s) outweigh its
// 0.0040 ms of tensor work; mma.sync runs TF32 below that dense rate.
// The design, in K9's tile frame (tile_powers, tile_solve):
//   - a block of kTapThreads = 256 threads (8 warps) takes a tile of
//     kTapBins = 64 bins at a time, grid-stride over the tiles;
//   - powers: each thread makes every kTapSplit-th power of one bin (exact
//     integer phase, sincosf) into sP, tap-major: row t holds Re P_t of
//     the tile's bins in columns [0, 64) and Im P_t in [64, 128);
//   - synthesis: [Pr; Pi] (128 x order) x tw (order x L N) -> [Gr; Gi],
//     warp w owning rows [16 w, 16 w + 16) and kTcNG n-tiles per A
//     fragment; tw's fragments come through L1 (__ldg, 21 KB at the rig's
//     size) and are split as they are loaded; G goes to sGS, row jk
//     holding the tile's Gr and Gi;
//   - solve: kTapSplit = 4 adjacent lanes per bin split H G over the
//     loudspeakers (j = q, q + 4, ...), add their N x N sums by two xor
//     shuffles (commutative, so every lane holds the same sum), run K8's
//     solve (fdn_ge.cuh, pivot or no pivot) each, and write the S rows of
//     their loudspeakers over G in sGS as [Sr | -Si];
//   - tap cotangent: tb (order x L N) += [Pr | Pi]^T (order x 128) x
//     [Sr; -Si] (128 x L N) in strips of one m-tile by kTcNG n-tiles, one
//     strip a warp, its A fragments loaded once per k-step and its FP32
//     accumulators held in registers over all the block's tiles of bins;
//     a block writes its partial once (per-block partials summed by
//     torch.sum, no atomics, so the sum is deterministic).  More strips
//     than warps (order x L N above 112 x 64) take another pass over the
//     bins.
//   - the inner loops over a strip's kTcNG n-tiles have no branch (a
//     branch there kept the compiler from overlapping their loads): n-tiles
//     past L N load zero taps, or reread the last S row, and are not
//     stored.
// Order pads to a multiple of 16 (m-tiles of tb, k-steps of G) and L N to
// a multiple of 8 with zeros: the powers write zero rows t >= order and
// the tw fragments load zeros outside (order, L N), so G's and S's padded
// rows are zero, and only (order, L N) of tb is written.  For one pass P
// and S are kept in shared memory already rounded to TF32, so their
// fragments need no split.
//
// Shared memory: both arrays have rows of 2 x 64 + 4 = 132 floats, a
// stride = 4 (mod 32) that makes the cotangent's fragment loads (rows on
// the lane's group, columns on its thread in group) and the per-bin row
// accesses free of bank conflicts; the synthesis's A loads (columns on
// the group) take two ways, once per warp and k-step.  At order = 100,
// L N = 52: 4 x 132 x (112 + 56) = 88.7 KB a block, so two blocks, 16
// warps, fit an SM (the FP32 kernel: 101.1 KB, also two blocks of 8
// warps), at most 128 registers a thread (__launch_bounds__(256, 2)).
// What holds it back (H100, 'high'): the contractions' fragment work
// more than their mma; every warp reloads and splits tw's fragments for
// every tile, since a split copy in shared memory (25-50 KB) would leave
// one block an SM; then the solve's dependent H loads and the sincosf.
// mma.sync, not wgmma: wgmma's 64-row warpgroup tiles read B from shared
// memory and want staged, swizzled operands; the contractions here are
// 128 x 112 x 56 and 112 x 128 x 56 per tile, split on the fly, and the
// solve between them needs the block's warps anyway.
constexpr int kTcNG = 8;  // n-tiles a warp runs per A fragment, no branch
                          // between them: a strip of tb tiles, held in
                          // registers, or of G tiles
static_assert(2 * kTapBins == 16 * kTapWarps, "one synthesis m-tile per warp");

__host__ __device__ inline int tc_smem_bytes(int order, int LN) {
  return 4 * kTapStride * (round_up(order, 16) + round_up(LN, 8));
}

template <int N, bool PIVOT, int PASSES>
__global__ void __launch_bounds__(kTapThreads, 2)
    aa_taps_tf_mse_tc_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                             const float* __restrict__ tw, const float* __restrict__ rr,
                             const float* __restrict__ ri, const float* __restrict__ t,
                             float* __restrict__ loss_row, float* __restrict__ partials,
                             float scale, int L, int M, int order, int nfft, int off_mod,
                             float w_scale) {
  extern __shared__ float4 smem4[];
  const int LN = L * N;
  const int OP = round_up(order, 16), LNP = round_up(LN, 8);
  float* sP = reinterpret_cast<float*>(smem4);  // [OP][kTapStride]
  float* sGS = sP + OP * kTapStride;              // [LNP][kTapStride]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (M + kTapBins - 1) / kTapBins;
  const int MT = OP / 16, NT = LNP / 8;

  // tb's strips: m-tile mt and n-tiles [nb, nb + kTcNG), one a warp per
  // pass over the bins (at order = 100, L N = 52: warp w < 7 owns m-tile
  // w and n-tiles 0..7, of which 7 are stored)
  const int n_sg = (NT + kTcNG - 1) / kTcNG, n_strips = MT * n_sg;
#pragma unroll 1
  for (int s0 = 0; s0 < n_strips; s0 += kTapWarps) {
    const int strip = s0 + warp;
    const bool has_strip = strip < n_strips;
    const int mt = strip / n_sg, nb = (strip % n_sg) * kTcNG;
    float acc[kTcNG][4];
#pragma unroll
    for (int i = 0; i < kTcNG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }

#pragma unroll 1
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile * kTapBins;

      tile_powers<kTapBins, kTapThreads>(sP, OP, order, m0, nfft, off_mod, w_scale,
                                         KeepTf32<PASSES>{});
      __syncthreads();

      // [Gr; Gi] = [Pr; Pi] tw: warp w computes rows [16 w, 16 w + 16)
      {
        const int r0 = 16 * warp;
#pragma unroll 1
        for (int n0 = 0; n0 < NT; n0 += kTcNG) {
          float d[kTcNG][4];
#pragma unroll
          for (int j = 0; j < kTcNG; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;
          }
#pragma unroll 1
          for (int k0 = 0; k0 < OP; k0 += 16) {
            FragA<PASSES> a[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* p0 = sP + (k0 + 8 * h + c) * kTapStride + r0 + g;
              const float* p4 = p0 + 4 * kTapStride;
              a[h].set_stored(p0[0], p0[8], p4[0], p4[8]);
            }
#pragma unroll
            for (int j = 0; j < kTcNG; ++j) {  // past L N: zero taps
              const int n = (n0 + j) * 8 + g;
              FragB<PASSES> bf[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k = k0 + 8 * h + c;
                const float* w0 = tw + static_cast<size_t>(k) * LN + n;
                const bool live_n = n < LN;
                bf[h].set(live_n && k < order ? __ldg(w0) : 0.0f,
                          live_n && k + 4 < order ? __ldg(w0 + 4 * LN) : 0.0f);
              }
              mma_add<PASSES>(d[j], a, bf);
            }
          }
#pragma unroll
          for (int j = 0; j < kTcNG; ++j) {
            if (n0 + j < NT) {
              float* o = sGS + ((n0 + j) * 8 + 2 * c) * kTapStride + r0 + g;
              o[0] = d[j][0];
              o[kTapStride] = d[j][1];
              o[8] = d[j][2];
              o[kTapStride + 8] = d[j][3];
            }
          }
        }
      }
      __syncthreads();

      tile_solve<N, PIVOT>(hr, hi, rr, ri, t, loss_row, sGS, scale, L, M, m0, s0 == 0,
                           KeepTf32<PASSES>{});
      __syncthreads();

      // tb += [Pr | Pi]^T [Sr; -Si] over the tile's 128 rows of bins on
      // this warp's strip; its n-tiles past L N reread the last one and are
      // not stored
#pragma unroll 1
      for (int k0 = 0; has_strip && k0 < 2 * kTapBins; k0 += 16) {
        FragA<PASSES> a[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* pa = sP + (mt * 16 + g) * kTapStride + k0 + 8 * h + c;
          a[h].set_stored(pa[0], pa[8 * kTapStride], pa[4], pa[8 * kTapStride + 4]);
        }
#pragma unroll
        for (int j = 0; j < kTcNG; ++j) {
          const int row = min(nb + j, NT - 1) * 8 + g;
          FragB<PASSES> bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* sb = sGS + row * kTapStride + k0 + 8 * h + c;
            bf[h].set_stored(sb[0], sb[4]);
          }
          mma_add<PASSES>(acc[j], a, bf);
        }
      }
      __syncthreads();  // the next tile overwrites sP and sGS
    }

    float* __restrict__ out = partials + static_cast<size_t>(blockIdx.x) * order * LN;
#pragma unroll
    for (int i = 0; i < kTcNG; ++i) {
      if (has_strip && nb + i < NT) {
        const int row = mt * 16 + g, col = (nb + i) * 8 + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr_ = row + (e >= 2 ? 8 : 0), cc = col + (e & 1);
          if (rr_ < order && cc < LN) out[static_cast<size_t>(rr_) * LN + cc] = acc[i][e];
        }
      }
    }
  }
}

inline unsigned n_blocks(int M) { return static_cast<unsigned>((M + kThreads - 1) / kThreads); }

template <int N>
void launch_tf_mse(bool pivot, const float* hr, const float* hi, const float* gr,
                   const float* gi, const float* rr, const float* ri, const float* t,
                   float* loss_row, float* sgr, float* sgi, float scale, int L, int M,
                   cudaStream_t s) {
  if (pivot)
    aa_tf_mse_kernel<N, true><<<n_blocks(M), kThreads, 0, s>>>(hr, hi, gr, gi, rr, ri, t,
                                                                loss_row, sgr, sgi, scale, L, M);
  else
    aa_tf_mse_kernel<N, false><<<n_blocks(M), kThreads, 0, s>>>(hr, hi, gr, gi, rr, ri, t,
                                                                 loss_row, sgr, sgi, scale, L, M);
}

// K9's kernel, block size, dynamic shared memory and bins per tile for
// `passes`: 0 is the FP32 kernel ('highest'), 1 and 3 the tensor-core
// kernel's TF32 passes ('default', 'high').
struct TapsConfig {
  const void* kernel;
  int threads, bytes, bins;
};

template <int N, bool PIVOT>
TapsConfig taps_config(int passes, int order, int LN) {
  if (passes == 0) {
    const bool stage = f32_stage_tw(order, LN);
    const void* k = stage ? reinterpret_cast<const void*>(&aa_taps_tf_mse_kernel<N, PIVOT, true>)
                          : reinterpret_cast<const void*>(&aa_taps_tf_mse_kernel<N, PIVOT, false>);
    return {k, kTapThreads, f32_smem_bytes(order, LN, stage), kTapBins};
  }
  const void* k = passes == 3
                      ? reinterpret_cast<const void*>(&aa_taps_tf_mse_tc_kernel<N, PIVOT, 3>)
                      : reinterpret_cast<const void*>(&aa_taps_tf_mse_tc_kernel<N, PIVOT, 1>);
  return {k, kTapThreads, tc_smem_bytes(order, LN), kTapBins};
}

template <int N>
TapsConfig taps_config(bool pivot, int passes, int order, int LN) {
  return pivot ? taps_config<N, true>(passes, order, LN)
               : taps_config<N, false>(passes, order, LN);
}

inline bool valid_passes(int passes) { return passes == 0 || passes == 1 || passes == 3; }

}  // namespace aa

// One build instantiates the kernels for one microphone count, FDN_N,
// given on the nvcc command line (-DFDN_N=4), like the other libraries.
#ifndef FDN_N
#error "compile with -DFDN_N=<microphone count>"
#endif
static_assert(FDN_N >= 1 && FDN_N <= aa::kMaxN, "FDN_N out of range");

extern "C" {

int aa_threads_per_block() { return aa::kThreads; }

int aa_channels() { return FDN_N; }

const char* aa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int aa_tf_mse_launch(int N, int pivot, const void* hr, const void* hi, const void* gr,
                     const void* gi, const void* rr, const void* ri, const void* t,
                     void* loss_row, void* sgr, void* sgi, float scale, int L, int M,
                     void* stream) {
  if (N != FDN_N) return aa::kBadN;
  if (L < 1 || M < 1) return aa::kBadSize;
  aa::launch_tf_mse<FDN_N>(pivot != 0, static_cast<const float*>(hr),
    static_cast<const float*>(hi), static_cast<const float*>(gr),
    static_cast<const float*>(gi), static_cast<const float*>(rr),
    static_cast<const float*>(ri), static_cast<const float*>(t),
    static_cast<float*>(loss_row), static_cast<float*>(sgr), static_cast<float*>(sgi), scale,
    L, M, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K9's grid on the current device for `passes` (0: the FP32 kernel; 1 or
// 3: the tensor-core kernel's TF32 passes): as many blocks as fit on every
// SM at once, and no more than the tiles; or kBadN, kBadSize (passes not
// 0, 1 or 3, or the shared memory exceeds a block's 227 KB) or kCudaError.
int aa_taps_grid(int N, int pivot, int passes, int order, int L, int M) {
  if (N != FDN_N) return aa::kBadN;
  if (order < 1 || L < 1 || M < 1 || !aa::valid_passes(passes)) return aa::kBadSize;
  const aa::TapsConfig c = aa::taps_config<FDN_N>(pivot != 0, passes, order, L * N);
  if (c.bytes > aa::kMaxSmem) return aa::kBadSize;
  return aa::fill_grid(c.kernel, c.threads, c.bytes, (M + c.bins - 1) / c.bins);
}

int aa_taps_tf_mse_launch(int N, int pivot, int passes, const void* hr, const void* hi,
                          const void* tw, const void* rr, const void* ri, const void* t,
                          void* loss_row, void* partials, float scale, int L, int M, int order,
                          int nfft, int off_mod, float w_scale, int grid, void* stream) {
  if (N != FDN_N) return aa::kBadN;
  if (order < 1 || L < 1 || M < 1 || grid < 1 || nfft < 1 || off_mod < 0 || off_mod >= nfft ||
      !aa::valid_passes(passes))
    return aa::kBadSize;
  const aa::TapsConfig c = aa::taps_config<FDN_N>(pivot != 0, passes, order, L * N);
  if (c.bytes > aa::kMaxSmem) return aa::kBadSize;
  const cudaError_t err =
      cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // both kernels take (hr, hi, tw, rr, ri, t, loss_row, partials, scale,
  // L, M, order, nfft, off_mod, w_scale)
  void* args[] = {&hr, &hi, &tw, &rr, &ri, &t, &loss_row, &partials, &scale,
                  &L,  &M,  &order, &nfft, &off_mod, &w_scale};
  cudaLaunchKernel(c.kernel, dim3(grid), dim3(c.threads), args, c.bytes,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
