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
// above 48 KB), two blocks an SM.  Every precision of the TPU kernel is
// FP32 on CUDA cores here.
//
// The ragged edge m >= M is masked: K8's dead threads return; K9's run
// with H = r = t = 0, which makes A = I, y = 0 and every cotangent exactly
// 0, and still take part in the block's barriers.

#include <cstddef>

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

template <int N>
const void* taps_kernel(bool pivot) {
  return pivot ? reinterpret_cast<const void*>(&aa_taps_tf_mse_kernel<N, true>)
               : reinterpret_cast<const void*>(&aa_taps_tf_mse_kernel<N, false>);
}

// Opt the kernel in to its dynamic shared memory; cudaSuccess or an error.
template <int N>
cudaError_t taps_prepare(bool pivot, int bytes) {
  return cudaFuncSetAttribute(taps_kernel<N>(pivot), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

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

// K9's grid on the current device: as many blocks of kTapBins threads as
// fit on every SM at once, and no more than the tiles; or kBadN, kBadSize
// (the shared memory exceeds a block's 227 KB) or kCudaError.
int aa_taps_grid(int N, int pivot, int order, int L, int M) {
  if (N != FDN_N) return aa::kBadN;
  if (order < 1 || L < 1 || M < 1) return aa::kBadSize;
  const int bytes = aa::taps_smem_bytes(order, L * N);
  if (bytes > aa::kMaxSmem) return aa::kBadSize;
  if (aa::taps_prepare<FDN_N>(pivot != 0, bytes) != cudaSuccess) return aa::kCudaError;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, aa::taps_kernel<FDN_N>(pivot != 0),
                                                    aa::kTapBins, bytes) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return aa::kCudaError;
  const int tiles = (M + aa::kTapBins - 1) / aa::kTapBins;
  const int fill = (per_sm > 0 ? per_sm : 1) * sms;
  return tiles < fill ? tiles : fill;
}

int aa_taps_tf_mse_launch(int N, int pivot, const void* hr, const void* hi, const void* tw,
                          const void* rr, const void* ri, const void* t, void* loss_row,
                          void* partials, float scale, int L, int M, int order, int nfft,
                          int off_mod, float w_scale, int grid, void* stream) {
  if (N != FDN_N) return aa::kBadN;
  if (order < 1 || L < 1 || M < 1 || grid < 1 || nfft < 1 || off_mod < 0 || off_mod >= nfft)
    return aa::kBadSize;
  const int bytes = aa::taps_smem_bytes(order, L * N);
  if (bytes > aa::kMaxSmem) return aa::kBadSize;
  const cudaError_t err = aa::taps_prepare<FDN_N>(pivot != 0, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* hr_ = static_cast<const float*>(hr);
  const auto* hi_ = static_cast<const float*>(hi);
  const auto* tw_ = static_cast<const float*>(tw);
  const auto* rr_ = static_cast<const float*>(rr);
  const auto* ri_ = static_cast<const float*>(ri);
  const auto* t_ = static_cast<const float*>(t);
  auto* loss_ = static_cast<float*>(loss_row);
  auto* part_ = static_cast<float*>(partials);
  if (pivot != 0)
    aa::aa_taps_tf_mse_kernel<FDN_N, true><<<grid, aa::kTapBins, bytes, s>>>(
        hr_, hi_, tw_, rr_, ri_, t_, loss_, part_, scale, L, M, order, nfft, off_mod, w_scale);
  else
    aa::aa_taps_tf_mse_kernel<FDN_N, false><<<grid, aa::kTapBins, bytes, s>>>(
        hr_, hi_, tw_, rr_, ri_, t_, loss_, part_, scale, L, M, order, nfft, off_mod, w_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
