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
// at 67 TFLOP/s of FP32 (the rows are ~23 MB, ~0.007 ms).  The design:
//   - a block owns a tile of kTapBins bins at a time (a grid-stride loop
//     over the tiles, the grid sized to fill the SMs);
//   - each thread writes its bin's powers into a row of shared memory
//     (odd row strides: the per-thread row writes and reads are free of
//     bank conflicts), synthesizes G kJB loudspeakers at a time (kJB N
//     complex accumulators, the taps read as warp-wide broadcasts), runs
//     K8's per-bin work and writes its S row to shared memory;
//   - the block then contracts the tile's S against its powers (a small
//     GEMM over the tile's bins, kQ x kQ outputs per thread, the powers
//     read conflict-free and the S values as broadcasts) and adds the
//     result into a shared (order, L N) sum that each output's owning
//     thread alone updates;
//   - each block writes its sum once: per-block partials (blocks, order,
//     L N) that the wrapper adds with torch.sum, in a fixed order, so the
//     result is deterministic on a given card.
// Shared memory at order = 100, L N = 52: 99.6 KB a block (opted in
// above 48 KB), two blocks an SM.  This kernel is precision 'highest',
// FP32 on CUDA cores.
//
// The ragged edge m >= M is masked: K8's dead threads return; K9's run
// with H = r = t = 0, which makes A = I, y = 0 and every cotangent exactly
// 0, and still take part in the block's barriers.

#include <cstddef>
#include <cstdint>

#include "fdn_ge.cuh"

namespace aa {

using fdn::cabs2;
using fdn::cmul;

constexpr int kThreads = 128;  // K8: bins per block
constexpr int kTapBins = 64;   // K9: bins per tile (= threads per block)
constexpr int kJB = 4;         // K9: loudspeakers per synthesis chunk
constexpr int kQ = 4;          // K9: register tile of the tap contraction
constexpr int kMaxN = 8;
constexpr int kBadN = -1;
constexpr int kBadSize = -2;
constexpr int kCudaError = -3;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

__host__ __device__ inline int round_up(int x, int q) { return (x + q - 1) / q * q; }

// K9's shared memory: the power rows and S rows of a tile (odd strides,
// float2) and the (order, L N) sum (padded to kQ).
__host__ __device__ inline int taps_smem_bytes(int order, int LN) {
  const int OS = round_up(order, kQ) + 1, LS = round_up(LN, kQ) + 1;
  return kTapBins * 8 * (OS + LS) + 4 * round_up(order, kQ) * round_up(LN, kQ);
}

__device__ __forceinline__ void cadd_to(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

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

// K9: loss row and per-block tap-cotangent partials from the taps.
// off_mod = bin offset mod nfft (>= 0); w_scale = float(2 pi / nfft).
template <int N, bool PIVOT>
__global__ void __launch_bounds__(kTapBins)
    aa_taps_tf_mse_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                          const float* __restrict__ tw, const float* __restrict__ rr,
                          const float* __restrict__ ri, const float* __restrict__ t,
                          float* __restrict__ loss_row, float* __restrict__ partials, float scale,
                          int L, int M, int order, int nfft, int off_mod, float w_scale) {
  extern __shared__ float4 smem4[];
  const int LN = L * N;
  const int OP = round_up(order, kQ), LP = round_up(LN, kQ);
  const int OS = OP + 1, LS = LP + 1;
  float2* sP = reinterpret_cast<float2*>(smem4);  // [kTapBins][OS]
  float2* sS = sP + kTapBins * OS;                 // [kTapBins][LS]
  float* sTB = reinterpret_cast<float*>(sS + kTapBins * LS);  // [OP][LP]
  const int tid = threadIdx.x;
  for (int v = tid; v < OP * LP; v += kTapBins) sTB[v] = 0.0f;
  const size_t Ms = static_cast<size_t>(M);
  const int n_tiles = (M + kTapBins - 1) / kTapBins;
  const int nq_t = OP / kQ, nq_j = LP / kQ;
  float2* prow = sP + tid * OS;
  float2* srow = sS + tid * LS;

#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m = tile * kTapBins + tid;
    const bool live = m < M;

    // the powers P_t = e^{-j w_scale idx_t}, idx_t = t (m + off) mod nfft,
    // stepped exactly in integers
    const int gm = static_cast<int>((static_cast<long long>(m) % nfft + off_mod) % nfft);
    int idx = 0;
    for (int tt = 0; tt < OP; ++tt) {
      float2 p = make_float2(0.0f, 0.0f);
      if (tt < order) {
        float sn, cs;
        sincosf(w_scale * static_cast<float>(idx), &sn, &cs);
        p = make_float2(cs, -sn);
        idx += gm;
        if (idx >= nfft) idx -= nfft;
      }
      prow[tt] = p;
    }

    // s = H G, G[j, k] = sum_t tw[t, j N + k] P_t, kJB loudspeakers at a time
    float2 s[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) s[i][k] = make_float2(0.0f, 0.0f);
    }
#pragma unroll 1
    for (int j0 = 0; j0 < L; j0 += kJB) {
      float2 g[kJB][N];
#pragma unroll
      for (int jb = 0; jb < kJB; ++jb) {
#pragma unroll
        for (int k = 0; k < N; ++k) g[jb][k] = make_float2(0.0f, 0.0f);
      }
#pragma unroll 2
      for (int tt = 0; tt < order; ++tt) {
        const float2 p = prow[tt];
        const float* __restrict__ twr = tw + static_cast<size_t>(tt) * LN + j0 * N;
#pragma unroll
        for (int jb = 0; jb < kJB; ++jb) {
          if (j0 + jb < L) {
#pragma unroll
            for (int k = 0; k < N; ++k) {
              const float v = __ldg(twr + jb * N + k);
              g[jb][k].x += v * p.x;
              g[jb][k].y += v * p.y;
            }
          }
        }
      }
#pragma unroll
      for (int jb = 0; jb < kJB; ++jb) {
        const int j = j0 + jb;
        if (j < L) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float2 h = load2(hr, hi, static_cast<size_t>(i * L + j) * Ms + m, live);
#pragma unroll
            for (int k = 0; k < N; ++k) cadd_to(s[i][k], cmul(h, g[jb][k]));
          }
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
    if (live) loss_row[m] = loss;

    // the bin's S row into shared memory, zero-padded to LP
#pragma unroll 1
    for (int j = 0; j < L; ++j) {
      const float2 a = h_transpose_xi<N>(hr, hi, xi, j, L, Ms, m, live);
#pragma unroll
      for (int k = 0; k < N; ++k) srow[j * N + k] = cmul(a, y[k]);
    }
    for (int v = LN; v < LP; ++v) srow[v] = make_float2(0.0f, 0.0f);
    __syncthreads();

    // tb[t, jk] += sum_b Re S[b, jk] Re P[b, t] - Im S[b, jk] Im P[b, t]:
    // thread q owns t = tq + a nq_t and jk = jq + c nq_j (a, c < kQ)
    for (int q = tid; q < nq_t * nq_j; q += kTapBins) {
      const int tq = q % nq_t, jq = q / nq_t;
      float acc[kQ][kQ];
#pragma unroll
      for (int a = 0; a < kQ; ++a) {
#pragma unroll
        for (int c = 0; c < kQ; ++c) acc[a][c] = 0.0f;
      }
#pragma unroll 4
      for (int b = 0; b < kTapBins; ++b) {
        float2 p[kQ], sv[kQ];
#pragma unroll
        for (int a = 0; a < kQ; ++a) p[a] = sP[b * OS + tq + a * nq_t];
#pragma unroll
        for (int c = 0; c < kQ; ++c) sv[c] = sS[b * LS + jq + c * nq_j];
#pragma unroll
        for (int a = 0; a < kQ; ++a) {
#pragma unroll
          for (int c = 0; c < kQ; ++c) acc[a][c] += sv[c].x * p[a].x - sv[c].y * p[a].y;
        }
      }
#pragma unroll
      for (int a = 0; a < kQ; ++a) {
#pragma unroll
        for (int c = 0; c < kQ; ++c) sTB[(tq + a * nq_t) * LP + jq + c * nq_j] += acc[a][c];
      }
    }
    __syncthreads();
  }

  float* __restrict__ out = partials + static_cast<size_t>(blockIdx.x) * order * LN;
  for (int v = tid; v < order * LN; v += kTapBins) out[v] = sTB[(v / LN) * LP + v % LN];
}

// ---------------------------------------------------------------------------
// K9 on the tensor cores: aa_taps_tf_mse_tc_kernel<N, PIVOT, PASSES>, for
// precision 'high' (PASSES = 3) and 'default' (PASSES = 1); 'highest'
// stays aa_taps_tf_mse_kernel above.  The same function as K9, with its
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
// The design:
//   - a block of kTcThreads = 256 threads (8 warps) takes a tile of
//     kTcBins = 64 bins at a time, grid-stride over the tiles;
//   - powers: each thread makes every kTcSplit-th power of one bin (exact
//     integer phase, sincosf) into sP, tap-major: row t holds Re P_t of
//     the tile's bins in columns [0, 64) and Im P_t in [64, 128);
//   - synthesis: [Pr; Pi] (128 x order) x tw (order x L N) -> [Gr; Gi],
//     warp w owning rows [16 w, 16 w + 16) and kTcNG n-tiles per A
//     fragment; tw's fragments come through L1 (__ldg, 21 KB at the rig's
//     size) and are split as they are loaded; G goes to sGS, row jk
//     holding the tile's Gr and Gi;
//   - solve: kTcSplit = 4 adjacent lanes per bin split H G over the
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
// warps, fit an SM (the FP32 kernel: 99.6 KB, two blocks of 2 warps),
// at most 128 registers a thread (__launch_bounds__(256, 2)).
// What holds it back (H100, 'high'): the contractions' fragment work
// more than their mma; every warp reloads and splits tw's fragments for
// every tile, since a split copy in shared memory (25-50 KB) would leave
// one block an SM; then the solve's dependent H loads and the sincosf.
// mma.sync, not wgmma: wgmma's 64-row warpgroup tiles read B from shared
// memory and want staged, swizzled operands; the contractions here are
// 128 x 112 x 56 and 112 x 128 x 56 per tile, split on the fly, and the
// solve between them needs the block's warps anyway.
constexpr int kTcBins = 64;
constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcSplit = kTcThreads / kTcBins;  // lanes per bin in the solve
constexpr int kTcStride = 2 * kTcBins + 4;
constexpr int kTcNG = 8;  // n-tiles a warp runs per A fragment, no branch
                          // between them: a strip of tb tiles, held in
                          // registers, or of G tiles
static_assert(2 * kTcBins == 16 * kTcWarps, "one synthesis m-tile per warp");
static_assert(kTcStride % 32 == 4, "conflict-free cotangent fragments");

__host__ __device__ inline int tc_smem_bytes(int order, int LN) {
  return 4 * kTcStride * (round_up(order, 16) + round_up(LN, 8));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 and the plain version's tf32_round: on the
// bits, for finite x (the carry rounds into the exponent); two integer
// operations, which ran faster than the cvt in this kernel
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// an operand's TF32 hi and (for 3 passes) lo part
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  if constexpr (PASSES == 3) lo = tf32_rna(x - __uint_as_float(hi));
}

// P and S as they are kept in shared memory: rounded to TF32 once, as they
// are written, for one pass; as float32, split at each fragment load, for
// three
template <int PASSES>
__device__ __forceinline__ float stored(float x) {
  if constexpr (PASSES == 1) return __uint_as_float(tf32_rna(x));
  return x;
}

template <int PASSES>
__device__ __forceinline__ void split_stored(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (PASSES == 1)
    hi = __float_as_uint(x);
  else
    split<PASSES>(x, hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A (16 x 8, row-major) and B (8 x 8, col-major) fragments of m16n8k8 TF32,
// split.  Lane (g = lane / 4, c = lane % 4): a[0..3] = A[g][c], A[g + 8][c],
// A[g][c + 4], A[g + 8][c + 4]; b[0..1] = B[c][g], B[c + 4][g]; the
// accumulator d[0..3] = D[g][2c], D[g][2c + 1], D[g + 8][2c], D[g + 8][2c + 1].
// set() splits float32 values, set_stored() values as shared memory keeps
// them.
template <int PASSES>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set_stored(float a0, float a1, float a2, float a3) {
    split_stored<PASSES>(a0, hi[0], lo[0]);
    split_stored<PASSES>(a1, hi[1], lo[1]);
    split_stored<PASSES>(a2, hi[2], lo[2]);
    split_stored<PASSES>(a3, hi[3], lo[3]);
  }
};

template <int PASSES>
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split<PASSES>(b0, hi[0], lo[0]);
    split<PASSES>(b1, hi[1], lo[1]);
  }
  __device__ __forceinline__ void set_stored(float b0, float b1) {
    split_stored<PASSES>(b0, hi[0], lo[0]);
    split_stored<PASSES>(b1, hi[1], lo[1]);
  }
};

// d += A B in the precision's passes, inside the tensor cores
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&d)[4], const FragA<PASSES>& a,
                                           const FragB<PASSES>& b) {
  if constexpr (PASSES == 3) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
  }
  mma_tf32(d, a.hi, b.hi);
}

// acc += A0 B0 + A1 B1, two k-steps.  The tensor cores' own additions
// round toward zero, so a running sum kept in the mma accumulator drifts
// toward zero by up to an ulp of the sum each k-step (at M = 48001 the
// tap cotangent came out 2.2e-4 of its max from the plain version, and
// two k-steps to a sum still doubled 'default''s loss gap): each k-step's
// products are summed in an mma from zero and added to the FP32
// accumulator on the CUDA cores, which round to nearest.
template <int PASSES>
__device__ __forceinline__ void mma_add(float (&acc)[4], const FragA<PASSES> (&a)[2],
                                        const FragB<PASSES> (&b)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_passes<PASSES>(d, a[h], b[h]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[e];
  }
}

template <int N, bool PIVOT, int PASSES>
__global__ void __launch_bounds__(kTcThreads, 2)
    aa_taps_tf_mse_tc_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                             const float* __restrict__ tw, const float* __restrict__ rr,
                             const float* __restrict__ ri, const float* __restrict__ t,
                             float* __restrict__ loss_row, float* __restrict__ partials,
                             float scale, int L, int M, int order, int nfft, int off_mod,
                             float w_scale) {
  extern __shared__ float4 smem4[];
  const int LN = L * N;
  const int OP = round_up(order, 16), LNP = round_up(LN, 8);
  float* sP = reinterpret_cast<float*>(smem4);  // [OP][kTcStride]
  float* sGS = sP + OP * kTcStride;              // [LNP][kTcStride]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const size_t Ms = static_cast<size_t>(M);
  const int n_tiles = (M + kTcBins - 1) / kTcBins;
  const int MT = OP / 16, NT = LNP / 8;

  // tb's strips: m-tile mt and n-tiles [nb, nb + kTcNG), one a warp per
  // pass over the bins (at order = 100, L N = 52: warp w < 7 owns m-tile
  // w and n-tiles 0..7, of which 7 are stored)
  const int n_sg = (NT + kTcNG - 1) / kTcNG, n_strips = MT * n_sg;
#pragma unroll 1
  for (int s0 = 0; s0 < n_strips; s0 += kTcWarps) {
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
      const int m0 = tile * kTcBins;

      // the powers P_t = e^{-j w_scale idx_t}, idx_t = t (m + off) mod nfft
      // stepped exactly in integers: thread (b, q) makes t = q, q + kTcSplit, ..
      {
        const int b = tid % kTcBins, q = tid / kTcBins;
        const int gm =
            static_cast<int>((static_cast<long long>(m0 + b) % nfft + off_mod) % nfft);
        int step = 0, idx = 0;
        for (int s = 0; s < kTcSplit; ++s) {
          step += gm;
          if (step >= nfft) step -= nfft;
          if (s < q) {
            idx += gm;
            if (idx >= nfft) idx -= nfft;
          }
        }
        for (int tt = q; tt < OP; tt += kTcSplit) {
          float sn = 0.0f, cs = 0.0f;
          if (tt < order) {
            sincosf(w_scale * static_cast<float>(idx), &sn, &cs);
            idx += step;
            if (idx >= nfft) idx -= nfft;
          }
          sP[tt * kTcStride + b] = stored<PASSES>(cs);
          sP[tt * kTcStride + kTcBins + b] = stored<PASSES>(-sn);
        }
      }
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
              const float* p0 = sP + (k0 + 8 * h + c) * kTcStride + r0 + g;
              const float* p4 = p0 + 4 * kTcStride;
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
              float* o = sGS + ((n0 + j) * 8 + 2 * c) * kTcStride + r0 + g;
              o[0] = d[j][0];
              o[kTcStride] = d[j][1];
              o[8] = d[j][2];
              o[kTcStride + 8] = d[j][3];
            }
          }
        }
      }
      __syncthreads();

      // the solve: lanes 4 b .. 4 b + 3 own bin b, lane q the loudspeakers
      // j = q, q + kTcSplit, ...
      {
        const int b = tid / kTcSplit, q = tid % kTcSplit;
        const int m = m0 + b;
        const bool live = m < M;
        float2 s[N][N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int k = 0; k < N; ++k) s[i][k] = make_float2(0.0f, 0.0f);
        }
#pragma unroll 1
        for (int j = q; j < L; j += kTcSplit) {
          float2 h[N];
#pragma unroll
          for (int i = 0; i < N; ++i)
            h[i] = load2(hr, hi, static_cast<size_t>(i * L + j) * Ms + m, live);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float* gr = sGS + (j * N + k) * kTcStride + b;
            const float2 gv = make_float2(gr[0], gr[kTcBins]);
#pragma unroll
            for (int i = 0; i < N; ++i) cadd_to(s[i][k], cmul(h[i], gv));
          }
        }
#pragma unroll
        for (int x = 1; x < kTcSplit; x *= 2) {
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
        if (live && q == 0 && s0 == 0) loss_row[m] = loss;
#pragma unroll 1
        for (int j = q; j < L; j += kTcSplit) {
          const float2 a = h_transpose_xi<N>(hr, hi, xi, j, L, Ms, m, live);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float2 sv = cmul(a, y[k]);
            float* so = sGS + (j * N + k) * kTcStride + b;
            so[0] = stored<PASSES>(sv.x);
            so[kTcBins] = stored<PASSES>(-sv.y);
          }
        }
      }
      __syncthreads();

      // tb += [Pr | Pi]^T [Sr; -Si] over the tile's 128 rows of bins on
      // this warp's strip; its n-tiles past L N reread the last one and are
      // not stored
#pragma unroll 1
      for (int k0 = 0; has_strip && k0 < 2 * kTcBins; k0 += 16) {
        FragA<PASSES> a[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* pa = sP + (mt * 16 + g) * kTcStride + k0 + 8 * h + c;
          a[h].set_stored(pa[0], pa[8 * kTcStride], pa[4], pa[8 * kTcStride + 4]);
        }
#pragma unroll
        for (int j = 0; j < kTcNG; ++j) {
          const int row = min(nb + j, NT - 1) * 8 + g;
          FragB<PASSES> bf[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* sb = sGS + row * kTcStride + k0 + 8 * h + c;
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

// A grid of as many blocks of `threads` as fit on every SM at once, and
// no more than `tiles`, for `kernel` opted in to `bytes` of dynamic shared
// memory; or kCudaError.
inline int fill_grid(const void* kernel, int threads, int bytes, int tiles) {
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return kCudaError;
  const int fill = (per_sm > 0 ? per_sm : 1) * sms;
  return tiles < fill ? tiles : fill;
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
  if (passes == 0)
    return {reinterpret_cast<const void*>(&aa_taps_tf_mse_kernel<N, PIVOT>), kTapBins,
            taps_smem_bytes(order, LN), kTapBins};
  const void* k = passes == 3
                      ? reinterpret_cast<const void*>(&aa_taps_tf_mse_tc_kernel<N, PIVOT, 3>)
                      : reinterpret_cast<const void*>(&aa_taps_tf_mse_tc_kernel<N, PIVOT, 1>);
  return {k, kTcThreads, tc_smem_bytes(order, LN), kTcBins};
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
