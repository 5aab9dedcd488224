// Hand-written Hopper (sm_90a) kernels of the active-acoustics steps for
// any microphone count N, N a run-time argument: one library for every N
// (built as N = 1), with a plain C interface that
// flamo_tpu_torch/ops/aa_kernels.py loads through ctypes.  The wrappers
// there take the unrolled kernels of aa_kernels.cu (one library a
// microphone count, 1..8) up to 8 microphones and these above.  Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError(), or kBadSize for sizes it does not take.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py;
// there the elimination is unrolled over N at trace time, for any N):
//   aa_loop_tf_mse_kernel         (K8 looped) <- _aa_tf_mse_kernel,      pallas_call at :1602
//   aa_loop_taps_tf_mse_kernel    (K9 looped, 'highest')
//   aa_loop_taps_tf_mse_tc_kernel (K9 looped, 'high' and 'default')
//                                             <- _aa_taps_tf_mse_kernel, pallas_call at :1820
// Each computes the same function as its counterpart in aa_kernels.cu,
// with the same row layouts, outputs and arithmetic of the contractions.
//
// The per-bin step (aa_bin) runs on ONE WARP a bin, on fdn_loop.cuh's
// looped core: the bin's N x N system in shared memory at the odd row
// stride N | 1, a lane a row.  A = I - sum_j H[:, j] G[j, :] is assembled
// a lane a row (each entry summed over the loudspeakers in order, as the
// unrolled K8), eliminated (pivoted, or keeping its factors), and after the
// loss the adjoint A^T xi = w is solved: pivoted, by assembling A^T anew
// from H and G, which are still in shared memory, and eliminating it (no
// copy of A: 0 bytes, 8 N^2 L more FLOPs a bin; its entries are the same
// sums, so the same bits); without pivoting from the forward factors.
// Then a_j = (H^T xi)_j a lane a loudspeaker and S_jk = a_j y_k a lane an
// entry.
//
// The rows are channels-major, bins last: a warp that read its own bin's
// H and G from global memory would touch a 32-byte sector for each 4-byte
// value.  So the block stages the rows of W consecutive bins (one a warp)
// into shared memory first, each row's W values read together, and
// writes K8's S rows back the same way; in shared memory each bin's rows
// lie at an odd stride of float2s, so the staging stores spread over the
// banks.
//
// K8 looped: blocks of W warps (as many as fit 227 KB, at most 8) walk
// tiles of W bins with a grid stride.  Shared memory a block: W x (the
// bin's H and G, N L float2s each at odd stride, r, the system N (N | 1),
// the vectors rhs, y, w, xi and a = H^T xi, and the targets).  At L = 13:
// 50.5 KB at N = 16, 133 KB at N = 32 (eight warps); the limit is N = 155.
// What bounds it on an H100: bytes, as the unrolled K8 (4 N L + 3 N rows
// read, 2 L N + 1 written: ~0.074 ms at N = 16, M = 48001).
//
// K9 looped keeps the unrolled K9's tile frame (aa_tile.cuh's tile_powers,
// the exact integer DFT phases; the synthesis G = tw^T P and the tap
// cotangent tb = [Pr | Pi]^T [Sr; -Si] as in aa_kernels.cu: register-tiled
// FP32 SIMT products for 'highest', TF32 mma.sync with the split scheme
// a_hi b_hi + a_hi b_lo + a_lo b_hi for 'high' and a_hi b_hi for 'default')
// on tiles of TB bins, and replaces its solve (four lanes a bin, the N x N
// sums in registers) by aa_bin: the block stages H, r and t of `solvers`
// consecutive bins of the tile, each of the first `solvers` warps takes one,
// and S overwrites G in the tile's rows.  TB is 64 where the frame and
// eight solver warps fit a block (N <= 16 at order = 100, L = 13), else 32
// with as many solver warps as fit (six at N = 32); 256 threads a block.
// The tap cotangent is not held in registers across the tiles (at N = 32
// tb has 41,600 entries, seven passes over the bins in the unrolled
// design): each block adds its tiles' products into its own row of the
// partials output, (order padded to 16) x (L N padded to 8) floats, a
// value always by the same thread in the same order (no atomics), and the
// wrapper sums the rows with torch.sum; one pass over the bins.  At N = 32,
// order = 100 a block's row is 186 KB, read and written once a tile (from
// L2).  What bounds it: operations (two order x L N contractions, the
// assembly and the solves: ~0.39 ms at N = 32 at 67 TFLOP/s of FP32).
//
// The ragged edge m >= M: K8's warps skip their bin; K9's run with H = r =
// t = 0, which makes A = I, y = 0 and S = 0.

#include <cstddef>
#include <cstdint>

#include "aa_tile.cuh"
#include "fdn_loop.cuh"

namespace aa {
namespace loop {

using fdn::cabs2;
using fdn::cmul;
using fdn::loop::kFull;
using fdn::loop::stride;

constexpr int kBadSize = -2;
constexpr int kMaxWarps = 8;
constexpr int kThreads = 32 * kMaxWarps;  // K9 looped's block
constexpr int kTcNG = 8;                  // the tensor-core strips' n-tiles
constexpr int kCotT = 6;                  // FP32 cotangent: taps of a thread's tile
constexpr int kCotJ = 4;                  // FP32 cotangent: columns jk of a thread's tile

__host__ __device__ inline int odd(int n) { return n | 1; }

// float2s of one bin's system and vectors: A (N x stride(N)), rhs, y, w,
// xi (N each) and a = H^T xi (L)
__host__ __device__ inline int bin_float2s(int N, int L) { return N * stride(N) + 4 * N + L; }

// bytes of one bin in K8 looped: its staged H and G (odd(N L) float2s
// each), r (N), its system and vectors, and t (N floats)
inline size_t tf_mse_bin_bytes(int N, int L) {
  return 8 * static_cast<size_t>(2 * odd(N * L) + N + bin_float2s(N, L)) +
         4 * static_cast<size_t>(N);
}

inline size_t tf_mse_smem_bytes(int N, int L, int warps) {
  return static_cast<size_t>(warps) * tf_mse_bin_bytes(N, L);
}

// K8 looped's warps a block: as many as fit, at most kMaxWarps; 0 when not
// even one bin fits
inline int tf_mse_warps(int N, int L) {
  int w = 0;
  while (w < kMaxWarps && tf_mse_smem_bytes(N, L, w + 1) <= static_cast<size_t>(kMaxSmem)) ++w;
  return w;
}

// K9 looped's shared memory: the frame of a tile of `bins` (the powers and
// the G/S rows, 2 bins + 4 floats a row; the tensor-core kernel pads
// order to 16 and L N to 8), and each solver warp's bin: its system and
// vectors, its staged H (odd(N L) float2s), r (N) and t (N floats)
inline size_t taps_frame_bytes(int passes, int order, int LN, int bins) {
  const int rows = passes ? round_up(order, 16) + round_up(LN, 8) : order + LN;
  return 4 * static_cast<size_t>(2 * bins + 4) * rows;
}

inline size_t solver_bytes(int N, int L) {
  return 8 * static_cast<size_t>(bin_float2s(N, L) + odd(N * L) + N) + 4 * static_cast<size_t>(N);
}

inline size_t taps_smem_bytes(int passes, int order, int N, int L, int bins, int solvers) {
  return taps_frame_bytes(passes, order, L * N, bins) +
         static_cast<size_t>(solvers) * solver_bytes(N, L);
}

// K9 looped's tile and solver warps: 64 bins and eight solvers where they
// fit a block, else 32 bins and as many solvers as fit; {0, 0} when not
// even one does
struct TapsPlan {
  int bins, solvers;
};

inline TapsPlan taps_plan(int passes, int order, int N, int L) {
  const size_t limit = static_cast<size_t>(kMaxSmem);
  if (taps_smem_bytes(passes, order, N, L, 64, kMaxWarps) <= limit) return {64, kMaxWarps};
  int w = 0;
  while (w < kMaxWarps && taps_smem_bytes(passes, order, N, L, 32, w + 1) <= limit) ++w;
  return {w ? 32 : 0, w};
}

// ---------------------------------------------------------------------------
// one bin on a warp
// ---------------------------------------------------------------------------
// A = I - H G (TRANSPOSE: its transpose, A^T[i][k] = A[k][i], the same sums
// in the same order) a lane a row; h is the bin's H (row i L + j), g(j, k)
// reads G[j][k].
template <bool TRANSPOSE, class GetG>
__device__ __forceinline__ void assemble_hg(float2* A, const float2* h, GetG g, int N, int L, int S,
                                            int lane) {
  for (int i = lane; i < N; i += 32) {
    for (int k = 0; k < N; ++k) {
      float2 s = make_float2(0.0f, 0.0f);
      for (int j = 0; j < L; ++j)
        cadd_to(s, TRANSPOSE ? cmul(h[k * L + j], g(j, i)) : cmul(h[i * L + j], g(j, k)));
      A[i * S + k] = make_float2((i == k ? 1.0f : 0.0f) - s.x, -s.y);
    }
  }
  __syncwarp();
}

// One bin's step, called by all 32 lanes of a warp with the same
// arguments: y = A^{-1} r, the bin's loss sum_i (|y_i| - t_i)^2 (returned
// on every lane), w_i = scale (|y_i| - t_i) / |y_i| conj(y_i), the adjoint
// xi = A^{-T} w and S_jk = (H^T xi)_j y_k, handed to put(j N + k, S_jk)
// after the last read of G (so S may overwrite it).  sys holds the bin's
// system and vectors (bin_float2s), r the rhs and tv the targets.
template <bool PIVOT, class GetG, class PutS>
__device__ __forceinline__ float aa_bin(float2* sys, const float2* h, const float2* r,
                                        const float* tv, GetG g, PutS put, float scale, int N,
                                        int L, int lane) {
  const int S = stride(N);
  float2* A = sys;
  float2* rhs = A + N * S;
  float2* y = rhs + N;
  float2* w = y + N;
  float2* xi = w + N;
  float2* a = xi + N;
  assemble_hg<false>(A, h, g, N, L, S, lane);
  for (int i = lane; i < N; i += 32) rhs[i] = r[i];
  __syncwarp();
  fdn::loop::eliminate<PIVOT>(A, rhs, N, S, lane);
  fdn::loop::back_substitute(A, rhs, y, N, S, lane);
  float loss = 0.0f;
  for (int i = lane; i < N; i += 32) {
    const float2 yi = y[i];
    const float est = sqrtf(cabs2(yi));
    const float diff = est - tv[i];
    loss += diff * diff;
    // safe divide: dead and zero bins have est = 0 and diff = 0
    const float gg = scale * diff / (est > 0.0f ? est : 1.0f);
    w[i] = make_float2(gg * yi.x, -gg * yi.y);
  }
  __syncwarp();
  if constexpr (PIVOT) {
    assemble_hg<true>(A, h, g, N, L, S, lane);
    fdn::loop::eliminate<true>(A, w, N, S, lane);
    fdn::loop::back_substitute(A, w, xi, N, S, lane);
  } else {
    fdn::loop::transpose_solve_from_factors(A, w, xi, N, S, lane);
  }
  for (int j = lane; j < L; j += 32) {
    float2 aj = make_float2(0.0f, 0.0f);
    for (int i = 0; i < N; ++i) cadd_to(aj, cmul(h[i * L + j], xi[i]));
    a[j] = aj;
  }
  __syncwarp();
  for (int e = lane; e < L * N; e += 32) {
    const int j = e / N;
    put(e, cmul(a[j], y[e - j * N]));
  }
  __syncwarp();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) loss += __shfl_xor_sync(kFull, loss, o);
  return loss;
}

// ---------------------------------------------------------------------------
// K8 looped: the loss row and the S rows from the mixer-response rows
// ---------------------------------------------------------------------------
template <bool PIVOT>
__global__ void __launch_bounds__(kThreads)
    aa_loop_tf_mse_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                          const float* __restrict__ gr, const float* __restrict__ gi,
                          const float* __restrict__ rr, const float* __restrict__ ri,
                          const float* __restrict__ t, float* __restrict__ loss_row,
                          float* __restrict__ sgr, float* __restrict__ sgi, float scale, int N,
                          int L, int M) {
  extern __shared__ float4 smem4[];
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NL = N * L, SH = odd(NL), BF = bin_float2s(N, L);
  float2* sH = reinterpret_cast<float2*>(smem4);  // [W][SH]
  float2* sG = sH + W * SH;                        // [W][SH]: G, then S
  float2* sR = sG + W * SH;                        // [W][N]
  float2* sys = sR + W * N;                        // [W][BF]
  float* sT = reinterpret_cast<float*>(sys + W * BF);  // [W][N]
  const size_t Ms = static_cast<size_t>(M);
  const float2 zero = make_float2(0.0f, 0.0f);
  const int n_tiles = (M + W - 1) / W;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * W;
    // each row's W bins read together (H's rows i L + j, G's j N + k)
    for (int v = threadIdx.x; v < NL * W; v += blockDim.x) {
      const int row = v / W, b = v - row * W, m = m0 + b;
      const size_t o = static_cast<size_t>(row) * Ms + m;
      const bool live = m < M;
      sH[b * SH + row] = live ? make_float2(__ldg(hr + o), __ldg(hi + o)) : zero;
      sG[b * SH + row] = live ? make_float2(__ldg(gr + o), __ldg(gi + o)) : zero;
    }
    for (int v = threadIdx.x; v < N * W; v += blockDim.x) {
      const int row = v / W, b = v - row * W, m = m0 + b;
      const size_t o = static_cast<size_t>(row) * Ms + m;
      const bool live = m < M;
      sR[b * N + row] = live ? make_float2(__ldg(rr + o), __ldg(ri + o)) : zero;
      sT[b * N + row] = live ? __ldg(t + o) : 0.0f;
    }
    __syncthreads();
    const int m = m0 + warp;
    if (m < M) {
      float2* g = sG + warp * SH;
      const float loss = aa_bin<PIVOT>(
          sys + warp * BF, sH + warp * SH, sR + warp * N, sT + warp * N,
          [g, N](int j, int k) { return g[j * N + k]; }, [g](int e, float2 s) { g[e] = s; },
          scale, N, L, lane);
      if (lane == 0) loss_row[m] = loss;
    }
    __syncthreads();
    for (int v = threadIdx.x; v < NL * W; v += blockDim.x) {
      const int row = v / W, b = v - row * W, m = m0 + b;
      if (m < M) {
        const float2 s = sG[b * SH + row];
        const size_t o = static_cast<size_t>(row) * Ms + m;
        sgr[o] = s.x;
        sgi[o] = s.y;
      }
    }
    __syncthreads();  // the next tile overwrites the staged rows
  }
}

// ---------------------------------------------------------------------------
// K9 looped: the frame's contractions on tiles of TB bins, rows of
// 2 TB + 4 floats (aa_kernels.cu's kernels at TB = 64 with the tile as a
// parameter)
// ---------------------------------------------------------------------------
// FP32: [Gr; Gi] = [Pr; Pi] tw, a thread's tile 4 bins by 4 columns jk,
// an outer product a tap; tw's float4s through L1
template <int TB>
__device__ __forceinline__ void synthesis_f32(const float* sP, float* sGS,
                                              const float* __restrict__ tw, int order, int LN) {
  constexpr int ST = 2 * TB + 4, R = TB / 4;
  const int n_syn = R * ((LN + 3) / 4);
#pragma unroll 1
  for (int q = threadIdx.x; q < n_syn; q += kThreads) {
    const int rq = q % R, cq = q / R;
    float gr[4][4], gi[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < 4; ++c) gr[e][c] = gi[e][c] = 0.0f;
    }
    const float* pa = sP + 4 * rq;
    const int n0 = 4 * cq;
#pragma unroll 4
    for (int tt = 0; tt < order; ++tt) {
      const float4 pr = *reinterpret_cast<const float4*>(pa + tt * ST);
      const float4 pi = *reinterpret_cast<const float4*>(pa + tt * ST + TB);
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = n0 + c < LN ? __ldg(tw + static_cast<size_t>(tt) * LN + n0 + c) : 0.0f;
      const float p_r[4] = {pr.x, pr.y, pr.z, pr.w}, p_i[4] = {pi.x, pi.y, pi.z, pi.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gr[e][c] += w[c] * p_r[e];
          gi[e][c] += w[c] * p_i[e];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n0 + c < LN) {
        float* o = sGS + (n0 + c) * ST + 4 * rq;
        *reinterpret_cast<float4*>(o) = make_float4(gr[0][c], gr[1][c], gr[2][c], gr[3][c]);
        *reinterpret_cast<float4*>(o + TB) = make_float4(gi[0][c], gi[1][c], gi[2][c], gi[3][c]);
      }
    }
  }
}

// FP32: the block's row of partials (order x LNP) += [Pr | Pi]^T [Sr; -Si]
// over the tile's 2 TB rows of bins; a thread's tile kCotT taps by kCotJ
// columns, summed four rows at a time from float4s, as aa_kernels.cu's;
// `first` starts the row at zero.
template <int TB>
__device__ __forceinline__ void cotangent_f32(const float* sP, const float* sGS,
                                              float* __restrict__ part, int order, int LN,
                                              int LNP, bool first) {
  constexpr int ST = 2 * TB + 4;
  const int nT = (order + kCotT - 1) / kCotT, nJ = (LN + kCotJ - 1) / kCotJ;
#pragma unroll 1
  for (int item = threadIdx.x; item < nT * nJ; item += kThreads) {
    const int tq = item / nJ, jq = item % nJ;  // columns first
    int po[kCotT], so[kCotJ];
#pragma unroll
    for (int a = 0; a < kCotT; ++a) po[a] = min(tq + a * nT, order - 1) * ST;
#pragma unroll
    for (int c = 0; c < kCotJ; ++c) so[c] = min(jq + c * nJ, LN - 1) * ST;
    float acc[kCotT][kCotJ];
#pragma unroll
    for (int a = 0; a < kCotT; ++a) {
#pragma unroll
      for (int c = 0; c < kCotJ; ++c) {
        const int tt = tq + a * nT, jk = jq + c * nJ;
        acc[a][c] = first || tt >= order || jk >= LN ? 0.0f : part[tt * LNP + jk];
      }
    }
#pragma unroll 4
    for (int k0 = 0; k0 < 2 * TB; k0 += 4) {
      float4 p[kCotT], sv[kCotJ];
#pragma unroll
      for (int a = 0; a < kCotT; ++a) p[a] = *reinterpret_cast<const float4*>(sP + po[a] + k0);
#pragma unroll
      for (int c = 0; c < kCotJ; ++c) sv[c] = *reinterpret_cast<const float4*>(sGS + so[c] + k0);
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
#pragma unroll
    for (int a = 0; a < kCotT; ++a) {
#pragma unroll
      for (int c = 0; c < kCotJ; ++c) {
        const int tt = tq + a * nT, jk = jq + c * nJ;
        if (tt < order && jk < LN) part[tt * LNP + jk] = acc[a][c];
      }
    }
  }
}

// TF32: [Gr; Gi] (2 TB x LNP) = [Pr; Pi] tw in m16n8k8 products, a warp an
// m-tile of 16 rows by kTcNG n-tiles; tw's fragments through L1, split as
// they are loaded, zero outside (order, L N)
template <int PASSES, int TB>
__device__ __forceinline__ void synthesis_tc(const float* sP, float* sGS,
                                             const float* __restrict__ tw, int order, int LN) {
  constexpr int ST = 2 * TB + 4, MT = 2 * TB / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / 4, c = lane % 4;
  const int OP = round_up(order, 16), NT = round_up(LN, 8) / 8;
  const int items = MT * ((NT + kTcNG - 1) / kTcNG);
#pragma unroll 1
  for (int it = warp; it < items; it += kMaxWarps) {
    const int r0 = 16 * (it % MT), n0 = (it / MT) * kTcNG;
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
        const float* p0 = sP + (k0 + 8 * h + c) * ST + r0 + g;
        const float* p4 = p0 + 4 * ST;
        a[h].set_stored(p0[0], p0[8], p4[0], p4[8]);
      }
#pragma unroll
      for (int j = 0; j < kTcNG; ++j) {
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
        float* o = sGS + ((n0 + j) * 8 + 2 * c) * ST + r0 + g;
        o[0] = d[j][0];
        o[ST] = d[j][1];
        o[8] = d[j][2];
        o[ST + 8] = d[j][3];
      }
    }
  }
}

// TF32: the block's row of partials (OP x LNP) += [Pr | Pi]^T [Sr; -Si] in
// strips of one m-tile by kTcNG n-tiles, a warp a strip, its accumulators
// loaded from the row (zero when `first`) and stored back; n-tiles past
// L N reread the last S row and are not stored
template <int PASSES, int TB>
__device__ __forceinline__ void cotangent_tc(const float* sP, const float* sGS,
                                             float* __restrict__ part, int order, int LN,
                                             int LNP, bool first) {
  constexpr int ST = 2 * TB + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / 4, c = lane % 4;
  const int MT = round_up(order, 16) / 16, NT = LNP / 8;
  const int n_sg = (NT + kTcNG - 1) / kTcNG;
#pragma unroll 1
  for (int strip = warp; strip < MT * n_sg; strip += kMaxWarps) {
    const int mt = strip / n_sg, nb = (strip % n_sg) * kTcNG;
    float acc[kTcNG][4];
#pragma unroll
    for (int i = 0; i < kTcNG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + (e >= 2 ? 8 : 0), col = (nb + i) * 8 + 2 * c + (e & 1);
        acc[i][e] = first || nb + i >= NT ? 0.0f : part[row * LNP + col];
      }
    }
#pragma unroll 1
    for (int k0 = 0; k0 < 2 * TB; k0 += 16) {
      FragA<PASSES> a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* pa = sP + (mt * 16 + g) * ST + k0 + 8 * h + c;
        a[h].set_stored(pa[0], pa[8 * ST], pa[4], pa[8 * ST + 4]);
      }
#pragma unroll
      for (int j = 0; j < kTcNG; ++j) {
        const int row = min(nb + j, NT - 1) * 8 + g;
        FragB<PASSES> bf[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* sb = sGS + row * ST + k0 + 8 * h + c;
          bf[h].set_stored(sb[0], sb[4]);
        }
        mma_add<PASSES>(acc[j], a, bf);
      }
    }
#pragma unroll
    for (int i = 0; i < kTcNG; ++i) {
      if (nb + i < NT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + g + (e >= 2 ? 8 : 0), col = (nb + i) * 8 + 2 * c + (e & 1);
          part[row * LNP + col] = acc[i][e];
        }
      }
    }
  }
}

// The body of both K9 looped kernels: PASSES 0 is FP32 ('highest'), 1 and
// 3 the TF32 passes ('default', 'high').  Per tile: the powers, the
// synthesis, the solves in rounds of `solvers` bins, the tap cotangent.
template <bool PIVOT, int PASSES, int TB>
__device__ __forceinline__ void taps_body(const float* __restrict__ hr,
                                          const float* __restrict__ hi,
                                          const float* __restrict__ tw,
                                          const float* __restrict__ rr,
                                          const float* __restrict__ ri,
                                          const float* __restrict__ t, float* __restrict__ loss_row,
                                          float* __restrict__ partials, float scale, int N, int L,
                                          int M, int order, int nfft, int off_mod, float w_scale,
                                          int solvers) {
  constexpr int ST = 2 * TB + 4;
  extern __shared__ float4 smem4[];
  const int LN = L * N, NL = LN, SH = odd(NL), BF = bin_float2s(N, L);
  const int OP = round_up(order, 16), LNP = round_up(LN, 8);
  const int rowsP = PASSES ? OP : order, rowsG = PASSES ? LNP : LN;
  float* sP = reinterpret_cast<float*>(smem4);  // [rowsP][ST]
  float* sGS = sP + rowsP * ST;                  // [rowsG][ST]
  float2* sys = reinterpret_cast<float2*>(sGS + rowsG * ST);  // [solvers][BF]
  float2* sH = sys + solvers * BF;                            // [solvers][SH]
  float2* sR = sH + solvers * SH;                             // [solvers][N]
  float* sT = reinterpret_cast<float*>(sR + solvers * N);     // [solvers][N]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t Ms = static_cast<size_t>(M);
  const float2 zero = make_float2(0.0f, 0.0f);
  float* __restrict__ part = partials + static_cast<size_t>(blockIdx.x) * OP * LNP;
  const int n_tiles = (M + TB - 1) / TB;
  bool first = true;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * TB;
    if constexpr (PASSES == 0) {
      tile_powers<TB, kThreads>(sP, order, order, m0, nfft, off_mod, w_scale, KeepF32{});
      __syncthreads();
      synthesis_f32<TB>(sP, sGS, tw, order, LN);
    } else {
      tile_powers<TB, kThreads>(sP, OP, order, m0, nfft, off_mod, w_scale, KeepTf32<PASSES>{});
      __syncthreads();
      synthesis_tc<PASSES, TB>(sP, sGS, tw, order, LN);
    }
    __syncthreads();

#pragma unroll 1
    for (int r0 = 0; r0 < TB; r0 += solvers) {
      // H, r and t of bins r0 .. r0 + solvers - 1, each row's bins read
      // together; bins past the tile or past M are zero
      for (int v = tid; v < NL * solvers; v += kThreads) {
        const int row = v / solvers, q = v - row * solvers, m = m0 + r0 + q;
        const size_t o = static_cast<size_t>(row) * Ms + m;
        sH[q * SH + row] =
            r0 + q < TB && m < M ? make_float2(__ldg(hr + o), __ldg(hi + o)) : zero;
      }
      for (int v = tid; v < N * solvers; v += kThreads) {
        const int row = v / solvers, q = v - row * solvers, m = m0 + r0 + q;
        const size_t o = static_cast<size_t>(row) * Ms + m;
        const bool live = r0 + q < TB && m < M;
        sR[q * N + row] = live ? make_float2(__ldg(rr + o), __ldg(ri + o)) : zero;
        sT[q * N + row] = live ? __ldg(t + o) : 0.0f;
      }
      __syncthreads();
      const int b = r0 + warp;
      if (warp < solvers && b < TB) {
        float* col = sGS + b;  // G[j][k] at row j N + k: Re in column b, Im in TB + b
        const float loss = aa_bin<PIVOT>(
            sys + warp * BF, sH + warp * SH, sR + warp * N, sT + warp * N,
            [col, N](int j, int k) {
              const float* p = col + (j * N + k) * ST;
              return make_float2(p[0], p[TB]);
            },
            [col](int e, float2 s) {
              float* p = col + e * ST;
              if constexpr (PASSES == 0) {
                p[0] = s.x;
                p[TB] = -s.y;
              } else {
                p[0] = stored<PASSES>(s.x);
                p[TB] = stored<PASSES>(-s.y);
              }
            },
            scale, N, L, lane);
        if (lane == 0 && m0 + b < M) loss_row[m0 + b] = loss;
      }
      __syncthreads();
    }

    if constexpr (PASSES == 0)
      cotangent_f32<TB>(sP, sGS, part, order, LN, LNP, first);
    else
      cotangent_tc<PASSES, TB>(sP, sGS, part, order, LN, LNP, first);
    first = false;
    __syncthreads();  // the next tile overwrites sP and sGS
  }
}

template <bool PIVOT, int TB>
__global__ void __launch_bounds__(kThreads, 1)
    aa_loop_taps_tf_mse_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                               const float* __restrict__ tw, const float* __restrict__ rr,
                               const float* __restrict__ ri, const float* __restrict__ t,
                               float* __restrict__ loss_row, float* __restrict__ partials,
                               float scale, int N, int L, int M, int order, int nfft,
                               int off_mod, float w_scale, int solvers) {
  taps_body<PIVOT, 0, TB>(hr, hi, tw, rr, ri, t, loss_row, partials, scale, N, L, M, order, nfft,
                          off_mod, w_scale, solvers);
}

template <bool PIVOT, int PASSES, int TB>
__global__ void __launch_bounds__(kThreads, 1)
    aa_loop_taps_tf_mse_tc_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                                  const float* __restrict__ tw, const float* __restrict__ rr,
                                  const float* __restrict__ ri, const float* __restrict__ t,
                                  float* __restrict__ loss_row, float* __restrict__ partials,
                                  float scale, int N, int L, int M, int order, int nfft,
                                  int off_mod, float w_scale, int solvers) {
  taps_body<PIVOT, PASSES, TB>(hr, hi, tw, rr, ri, t, loss_row, partials, scale, N, L, M, order,
                               nfft, off_mod, w_scale, solvers);
}

template <bool PIVOT, int TB>
const void* taps_kernel_tb(int passes) {
  if (passes == 0) return reinterpret_cast<const void*>(&aa_loop_taps_tf_mse_kernel<PIVOT, TB>);
  if (passes == 1)
    return reinterpret_cast<const void*>(&aa_loop_taps_tf_mse_tc_kernel<PIVOT, 1, TB>);
  return reinterpret_cast<const void*>(&aa_loop_taps_tf_mse_tc_kernel<PIVOT, 3, TB>);
}

inline const void* taps_kernel(bool pivot, int passes, int bins) {
  if (bins == 64) return pivot ? taps_kernel_tb<true, 64>(passes) : taps_kernel_tb<false, 64>(passes);
  return pivot ? taps_kernel_tb<true, 32>(passes) : taps_kernel_tb<false, 32>(passes);
}

inline const void* tf_mse_kernel(bool pivot) {
  return pivot ? reinterpret_cast<const void*>(&aa_loop_tf_mse_kernel<true>)
               : reinterpret_cast<const void*>(&aa_loop_tf_mse_kernel<false>);
}

inline bool valid_passes(int passes) { return passes == 0 || passes == 1 || passes == 3; }

bool taps_sizes_ok(int passes, int order, int N, int L, int M) {
  return N >= 1 && L >= 1 && M >= 1 && order >= 1 && valid_passes(passes) &&
         taps_plan(passes, order, N, L).solvers >= 1;
}

}  // namespace loop
}  // namespace aa

extern "C" {

int aal_threads_per_block() { return aa::loop::kThreads; }

// built once for every microphone count
int aal_channels() { return 1; }

const char* aal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K8 looped's dynamic shared memory for a block of `warps`, and its warps
// a block (0: N does not fit)
long long aal_tf_mse_smem_bytes(int N, int L, int warps) {
  return static_cast<long long>(aa::loop::tf_mse_smem_bytes(N, L, warps));
}

int aal_tf_mse_warps(int N, int L) { return aa::loop::tf_mse_warps(N, L); }

// K9 looped's dynamic shared memory for a tile of `bins` and `solvers`
// solver warps, and the plan taps_plan picks (0 and 0: N does not fit)
long long aal_taps_smem_bytes(int passes, int order, int N, int L, int bins, int solvers) {
  return static_cast<long long>(aa::loop::taps_smem_bytes(passes, order, N, L, bins, solvers));
}

int aal_taps_bins(int passes, int order, int N, int L) {
  return aa::loop::taps_plan(passes, order, N, L).bins;
}

int aal_taps_solvers(int passes, int order, int N, int L) {
  return aa::loop::taps_plan(passes, order, N, L).solvers;
}

// K8 looped, its grid sized here: as many blocks as are resident on the
// card at once, and no more than the tiles of W bins
int aal_tf_mse_launch(int N, int pivot, const void* hr, const void* hi, const void* gr,
                      const void* gi, const void* rr, const void* ri, const void* t,
                      void* loss_row, void* sgr, void* sgi, float scale, int L, int M,
                      void* stream) {
  using namespace aa::loop;
  if (N < 1 || L < 1 || M < 1) return kBadSize;
  const int W = tf_mse_warps(N, L);
  if (W < 1) return kBadSize;
  const int bytes = static_cast<int>(tf_mse_smem_bytes(N, L, W));
  const void* kernel = tf_mse_kernel(pivot != 0);
  const int blocks = aa::fill_grid(kernel, W * 32, bytes, (M + W - 1) / W);
  if (blocks < 1) {
    const int err = static_cast<int>(cudaGetLastError());
    return err != 0 ? err : aa::kCudaError;
  }
  void* args[] = {&hr, &hi, &gr, &gi, &rr, &ri, &t, &loss_row, &sgr, &sgi, &scale, &N, &L, &M};
  cudaLaunchKernel(kernel, dim3(blocks), dim3(W * 32), args, bytes,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K9 looped's grid on the current device for `passes` (0: FP32; 1 or 3:
// TF32 passes): as many blocks as are resident at once, and no more than
// the tiles; or kBadSize, or aa::kCudaError.  The partials hold that many
// rows of round_up(order, 16) x round_up(L N, 8) floats.
int aal_taps_grid(int pivot, int passes, int order, int N, int L, int M) {
  using namespace aa::loop;
  if (!taps_sizes_ok(passes, order, N, L, M)) return kBadSize;
  const TapsPlan p = taps_plan(passes, order, N, L);
  return aa::fill_grid(taps_kernel(pivot != 0, passes, p.bins), kThreads,
                       static_cast<int>(taps_smem_bytes(passes, order, N, L, p.bins, p.solvers)),
                       (M + p.bins - 1) / p.bins);
}

int aal_taps_launch(int N, int pivot, int passes, const void* hr, const void* hi, const void* tw,
                    const void* rr, const void* ri, const void* t, void* loss_row,
                    void* partials, float scale, int L, int M, int order, int nfft, int off_mod,
                    float w_scale, int grid, void* stream) {
  using namespace aa::loop;
  if (!taps_sizes_ok(passes, order, N, L, M) || grid < 1 || nfft < 1 || off_mod < 0 ||
      off_mod >= nfft)
    return kBadSize;
  const TapsPlan p = taps_plan(passes, order, N, L);
  const int bytes = static_cast<int>(taps_smem_bytes(passes, order, N, L, p.bins, p.solvers));
  const void* kernel = taps_kernel(pivot != 0, passes, p.bins);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int solvers = p.solvers;
  void* args[] = {&hr, &hi, &tw, &rr, &ri, &t, &loss_row, &partials, &scale,
                  &N,  &L,  &M,  &order, &nfft, &off_mod, &w_scale, &solvers};
  cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, bytes,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
