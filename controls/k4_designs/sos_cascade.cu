// Every design of K4f and K4b weighed for the H100, behind `design`
// arguments and their own entry points, built and timed by
// controls/k4_designs/time_designs.py beside the previous kernels
// (controls/sos_kernels_prev) and the package's kernels
// (flamo_tpu_torch/csrc/sos_cascade.cu, which grew from (c) and (d) here).
// Nothing of the package loads this file; its headers are copies taken
// with it.  K4f: (a) sos_cascade_fwd_kernel, one thread a bin over a
// runtime block of cb channels; (b) sos_cascade_fwd_lanes_kernel, a thread
// per (bin, channel); (c) sos_cascade_fwd_nc_kernel, (a) with the channel
// block a compile-time NC.  K4b: (a) sos_cascade_bwd_kernel, transposed
// tap sums; (b) sos_cascade_bwd_halving_kernel, the previous grid with
// recursive halving; (c) sos_cascade_bwd_nc_kernel, (a) with NC and
// blocks of `bins` bins; (d) sos_cascade_bwd_free_kernel, (c) with
// branch-free visits.
//
// Hand-written Hopper (sm_90a) kernels K4f and K4b, the guarded SOS cascade
// and its tap VJP, with a plain C interface loaded through ctypes.  One library
// serves every channel count (it is built once, as N = 1): the channels
// run in channel blocks of at most kMaxCB, side by side in the grid, so
// nothing caps N but memory.  Every entry point launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError(), or kBadSize
// (-2) for taps, sizes or plans out of the limits below.
//
// Kernels and the TPU kernels they replace (flamo_tpu/ops/pallas_solve.py):
//   sos_cascade_fwd_kernel (K4f) <- _sos_cascade_fwd_kernel, pallas_call at :940
//   sos_cascade_bwd_kernel (K4b) <- _sos_cascade_bwd_kernel, pallas_call at
//                                   :957 (VJP of pallas_sos_cascade) and :989
//                                   (_sos_bwd_rows)
//
// The guarded SOS cascade of a channel n at the phasor z = e^{-j w},
//   H_n = prod_k B_kn(z) / prod_k A_kn(z),  B_kn(z) = sum_p b[p,k,n] z^p,
// is FLT_EPSILON (real) with zero gradient where |prod_k A_kn|^2 = 0, as
// _iir_guard_prods; a single section whose |B_k|^2 or |A_k|^2 is 0 adds
// nothing to the tap cotangents.  Taps are (P, K, N) float32, row-major,
// P <= kMaxP, K <= kMaxK.
//
// What bounds them on an H100: arithmetic, and at the attenuated FDN's
// size (M = 48001, N = 6, K = 12, P = 3) the launch.  A bin costs ~3.0 kFLOP
// of Horner sums and products in K4f and ~7.7 kFLOP in K4b (the cascade
// again, then the 2 K N section quotients and their P powers), against
// 48-60 bytes of taps, H, G and partials: at 67 TFLOP/s and 3.35 TB/s the
// operations take 3-7x the memory time (chip_smoke.py's kernel_work), and
// both are a few microseconds, near the launch floor.
//
// The design (the model is K5's, sos_kernels.cu): one thread a bin over the
// channels of its block.  The block stages its channels' 2 P K taps in
// shared memory once (broadcast reads: every lane of a warp reads the same
// tap), computes each bin's phasor once (the accurate sincosf: near
// m = nfft/2 the angle is close to pi, where the fast intrinsic loses
// digits), and runs the cascade with k outer, so that the 2 N section
// products of a k are independent, unrolled over a compile-time P (a
// switch on the runtime P picks one of eight copies).  K4f writes H
// through shared memory in coalesced rows.  K4b parks each bin's z and
// t_n = G_n H_n in shared memory; the block's threads then take its
// 2 K N sections over runs of its bins (K5's transposed tap sums: no
// shuffle trees, no atomics, so two launches give the same bits) and
// write one row of 2 P K N sums per bin block, ((part P + p) K + k) N + n,
// which the wrapper adds with one torch.sum.  Threads of the ragged edge
// m >= M run with t = 0, so they add exactly 0, and join every barrier.

#include <algorithm>
#include <cfloat>
#include <cstddef>

#include "sos_common.cuh"

namespace sc {

using sos::bin_phasor;
using sos::cabs2;
using sos::cmul;
using sos::horner_s;
using sos::kMaxK;
using sos::kMaxP;

constexpr int kThreads = 128;  // bins a block
constexpr int kMaxCB = 8;      // channels a block
constexpr int kBadSize = -2;
constexpr int kMaxSharedFloats = 48 * 1024 / 4;  // a block without opting in

// The taps of channels c0 .. c0 + nc - 1 in shared memory, a section's P
// taps together: taps_s[((k nc + i) 2 + part) P + p], part 0 the numerator
// b, 1 the denominator a.
__device__ __forceinline__ void stage_taps(const float* __restrict__ b,
                                           const float* __restrict__ a, float* taps_s, int K,
                                           int P, int N, int c0, int nc, int tid, int nthreads) {
  const int per = P * K * nc;
  for (int v = tid; v < 2 * per; v += nthreads) {
    const int part = v >= per;
    const int r = v - part * per;  // (p K + k) nc + i
    const int pk = r / nc;
    const int i = r - pk * nc;
    const int p = pk / K;
    const int k = pk - p * K;
    taps_s[((k * nc + i) * 2 + part) * P + p] =
        __ldg((part ? a : b) + static_cast<size_t>(pk) * N + c0 + i);
  }
}

// pb / pa, guarded: FLT_EPSILON where |pa|^2 = 0 (ok false)
__device__ __forceinline__ float2 guarded_ratio(float2 pb, float2 pa, bool& ok) {
  const float den = cabs2(pa);
  ok = den != 0.0f;
  const float inv = 1.0f / (ok ? den : 1.0f);
  return ok ? make_float2((pb.x * pa.x + pb.y * pa.y) * inv, (pb.y * pa.x - pb.x * pa.y) * inv)
            : make_float2(FLT_EPSILON, 0.0f);
}

// The guarded cascades of the block's nc <= kMaxCB channels at z, k outer.
template <int PT>
__device__ __forceinline__ void cascade_block(const float* taps_s, int K, int nc, float2 z,
                                              float2 (&h)[kMaxCB], bool (&ok)[kMaxCB]) {
  float2 pb[kMaxCB], pa[kMaxCB];
#pragma unroll
  for (int i = 0; i < kMaxCB; ++i) pb[i] = pa[i] = make_float2(1.0f, 0.0f);
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < kMaxCB; ++i) {
      if (i < nc) {
        const float* c = taps_s + (k * nc + i) * 2 * PT;
        pb[i] = cmul(pb[i], horner_s<PT>(c, PT, z));
        pa[i] = cmul(pa[i], horner_s<PT>(c + PT, PT, z));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxCB; ++i) h[i] = guarded_ratio(pb[i], pa[i], ok[i]);
}

// The block's (rows, nc) tile of H from out_s, row-major, in coalesced rows.
__device__ __forceinline__ void store_tile(const float2* out_s, float2* __restrict__ H, int m0,
                                           int rows, int N, int c0, int nc, int tid,
                                           int nthreads) {
  for (int v = tid; v < rows * nc; v += nthreads) {
    const int j = v / nc;
    H[static_cast<size_t>(m0 + j) * N + c0 + v - j * nc] = out_s[v];
  }
}

// K4f, design (a): block x = channel block (x / bin_blocks) over the
// kThreads bins of bin block (x % bin_blocks), one thread a bin.
template <int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_fwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                           float2* __restrict__ H, int M, int N, int K, int cb, int bin_blocks,
                           float w_scale, float off) {
  extern __shared__ float4 smem4[];
  const int m0 = (blockIdx.x % bin_blocks) * kThreads;
  const int c0 = (blockIdx.x / bin_blocks) * cb;
  const int nc = min(cb, N - c0);
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* out_s = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [kThreads][nc]
  stage_taps(b, a, taps_s, K, PT, N, c0, nc, threadIdx.x, kThreads);
  const float2 z = bin_phasor(m0 + threadIdx.x, w_scale, off);
  __syncthreads();
  float2 h[kMaxCB];
  bool ok[kMaxCB];
  cascade_block<PT>(taps_s, K, nc, z, h, ok);
#pragma unroll
  for (int i = 0; i < kMaxCB; ++i) {
    if (i < nc) out_s[threadIdx.x * nc + i] = h[i];
  }
  __syncthreads();
  store_tile(out_s, H, m0, min(kThreads, M - m0), N, c0, nc, threadIdx.x, kThreads);
}

// K4f, design (b): one thread per (bin, channel), block (32 bins, cb
// channels), warp i on channel c0 + i (its taps are shared-memory
// broadcasts); the grid holds as many blocks as fit the card at once
// (whole waves), each walking tiles of 32 bins after staging its taps
// once; warp 0 computes a tile's 32 phasors for all.
template <int PT>
__global__ void __launch_bounds__(32 * kMaxCB)
    sos_cascade_fwd_lanes_kernel(const float* __restrict__ b, const float* __restrict__ a,
                                 float2* __restrict__ H, int M, int N, int K, int cb,
                                 float w_scale, float off) {
  extern __shared__ float4 smem4[];
  const int c0 = blockIdx.y * cb;
  const int nc = min(cb, N - c0);
  const int lane = threadIdx.x;
  const int i = threadIdx.y;
  const int tid = i * 32 + lane;
  const int nthreads = 32 * blockDim.y;
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* z_s = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [32]
  float2* out_s = z_s + 32;                                            // [32][nc]
  stage_taps(b, a, taps_s, K, PT, N, c0, nc, tid, nthreads);
  const float* cs = taps_s + i * 2 * PT;
  const int tiles = (M + 31) / 32;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * 32;
    if (i == 0) z_s[lane] = bin_phasor(m0 + lane, w_scale, off);
    __syncthreads();
    if (i < nc) {
      const float2 z = z_s[lane];
      float2 pb = make_float2(1.0f, 0.0f), pa = pb;
      for (int k = 0; k < K; ++k) {
        const float* c = cs + k * nc * 2 * PT;
        pb = cmul(pb, horner_s<PT>(c, PT, z));
        pa = cmul(pa, horner_s<PT>(c + PT, PT, z));
      }
      bool ok;
      out_s[lane * nc + i] = guarded_ratio(pb, pa, ok);
    }
    __syncthreads();
    store_tile(out_s, H, m0, min(32, M - m0), N, c0, nc, tid, nthreads);
  }
}

// K4b's tap sums, transposed (K5's tap_sums over a channel block).  The
// block's bins have parked their phasor z and their t_i = G_i H_i in
// `bins` (row j: z, t_0 .. t_{nc-1}).  A work item is one section (part,
// k, i) over one run of kThreads / parts bins: its thread keeps the
// section's P taps and P sums in registers and walks the run, every lane
// of a warp on the same bin (shared-memory broadcasts of z), adding
//   b_bar[p,k,n] += Re(t_i / B_kn z^p),  a_bar[p,k,n] -= Re(t_i / A_kn z^p)
// a bin, nothing where |B_kn|^2 or |A_kn|^2 is 0 (the reciprocal is the
// fast one, __fdividef, within 2 ulp).  With one run an item writes its P
// sums into the block's row at ((part P + p) K + k) N + c0 + i; with more,
// the runs' sums meet in `acc` and are added in run order.
template <int P>
__device__ __forceinline__ void tap_sums(const float2* bins, const float* taps_s, float* acc,
                                         int K, int N, int c0, int nc, int parts,
                                         float* __restrict__ row) {
  const int S = 2 * K * nc;
  const int run = kThreads / parts;
  for (int item = threadIdx.x; item < S * parts; item += kThreads) {
    const int r = item / S;
    const int s = item - r * S;  // (part K + k) nc + i
    const int sk = s / nc;
    const int i = s - sk * nc;
    const int part = sk >= K;
    const int k = sk - part * K;
    float c[P], sum[P];
    const float* cs = taps_s + ((k * nc + i) * 2 + part) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      c[p] = cs[p];
      sum[p] = 0.0f;
    }
    const float sign = part ? -1.0f : 1.0f;
    const float2* rb = bins + r * run * (nc + 1);
#pragma unroll 4
    for (int j = 0; j < run; ++j) {
      const float2 z = rb[j * (nc + 1)];
      const float2 t = rb[j * (nc + 1) + 1 + i];
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
        row[((part * P + p) * K + k) * N + c0 + i] = sum[p];
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
      const int sk = s / nc;
      const int part = sk >= K;
      row[((part * P + p) * K + sk - part * K) * N + c0 + s - sk * nc] = total;
    }
  }
}

// K4b: block x = channel block (x / bin_blocks) over the kThreads bins of
// bin block (x % bin_blocks); G is JAX's cotangent of H, (M, N) complex64;
// row x % bin_blocks of partials gets the block's channels' 2 P K sums.
template <int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_bwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                           const float2* __restrict__ G, float* __restrict__ partials, int M,
                           int N, int K, int cb, int parts, int bin_blocks, float w_scale,
                           float off) {
  extern __shared__ float4 smem4[];
  const int bx = blockIdx.x % bin_blocks;
  const int c0 = (blockIdx.x / bin_blocks) * cb;
  const int nc = min(cb, N - c0);
  const int ntaps = 2 * PT * K * nc;
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* bins = reinterpret_cast<float2*>(taps_s + ntaps);  // [kThreads][nc + 1]
  float* acc = reinterpret_cast<float*>(bins + kThreads * (nc + 1));  // [2 K nc P][parts]
  stage_taps(b, a, taps_s, K, PT, N, c0, nc, threadIdx.x, kThreads);
  const int m = bx * kThreads + threadIdx.x;
  const float2 z = bin_phasor(m, w_scale, off);
  __syncthreads();
  float2 h[kMaxCB];
  bool ok[kMaxCB];
  cascade_block<PT>(taps_s, K, nc, z, h, ok);
  float2* mine = bins + threadIdx.x * (nc + 1);
  mine[0] = z;
#pragma unroll
  for (int i = 0; i < kMaxCB; ++i) {
    if (i < nc) {
      float2 t = make_float2(0.0f, 0.0f);
      if (m < M && ok[i]) t = cmul(G[static_cast<size_t>(m) * N + c0 + i], h[i]);
      mine[1 + i] = t;
    }
  }
  __syncthreads();
  tap_sums<PT>(bins, taps_s, acc, K, N, c0, nc, parts,
               partials + static_cast<size_t>(bx) * 2 * PT * K * N);
}

// K4b, the other design measured: the grid (bin blocks, N) of the kernel
// before the redesign, one thread per (bin, channel), its cascade and
// section quotients from global memory, with its warp sums taken by
// recursive halving (fdn::halve, as K1's warp_sums) in chunks of
// kChunkK sections instead of a shuffle tree a value.
constexpr int kChunkK = 4;
constexpr int kWarps = kThreads / 32;

template <int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_bwd_halving_kernel(const float* __restrict__ b, const float* __restrict__ a,
                                   const float2* __restrict__ G, float* __restrict__ partials,
                                   int M, int N, int K, float w_scale, float off) {
  extern __shared__ float red[];  // [kWarps][2 PT K]
  constexpr int NV = 2 * PT * kChunkK;
  constexpr int V1 = fdn::half_up(NV), V2 = fdn::half_up(V1), V3 = fdn::half_up(V2),
                V4 = fdn::half_up(V3);
  const int nv = 2 * PT * K;
  const int n = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float2 z = bin_phasor(m, w_scale, off);
  float2 pb = make_float2(1.0f, 0.0f), pa = pb;
  for (int k = 0; k < K; ++k) {
    pb = cmul(pb, sos::horner(b + k * N + n, K * N, PT, z));
    pa = cmul(pa, sos::horner(a + k * N + n, K * N, PT, z));
  }
  bool ok;
  const float2 h = guarded_ratio(pb, pa, ok);
  float2 t = make_float2(0.0f, 0.0f);
  if (m < M && ok) t = cmul(G[static_cast<size_t>(m) * N + n], h);
  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    float v[NV];
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int kk = 0; kk < kChunkK; ++kk) {
        float2 q = make_float2(0.0f, 0.0f);
        if (k0 + kk < K) {
          const float2 sec = sos::horner((part ? a : b) + (k0 + kk) * N + n, K * N, PT, z);
          const float d = cabs2(sec);
          const bool okd = d > 0.0f;
          const float invd = (part ? -1.0f : 1.0f) / (okd ? d : 1.0f);
          if (okd) q = make_float2((t.x * sec.x + t.y * sec.y) * invd,
                                   (t.y * sec.x - t.x * sec.y) * invd);
        }
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          v[(part * PT + p) * kChunkK + kk] = q.x;
          q = cmul(q, z);
        }
      }
    }
    int base = 0, end = NV;
    fdn::halve<NV, NV, 16>(v, lane, base, end);
    fdn::halve<NV, V1, 8>(v, lane, base, end);
    fdn::halve<NV, V2, 4>(v, lane, base, end);
    fdn::halve<NV, V3, 2>(v, lane, base, end);
    fdn::halve<NV, V4, 1>(v, lane, base, end);
#pragma unroll
    for (int j = 0; j < fdn::half_up(V4); ++j) {
      const int idx = base + j;  // (part PT + p) kChunkK + kk
      const int kk = idx % kChunkK;
      if (idx < end && k0 + kk < K) red[warp * nv + (idx / kChunkK) * K + k0 + kk] = v[j];
    }
  }
  __syncthreads();
  float* row = partials + static_cast<size_t>(blockIdx.x) * nv * N;
  for (int j = threadIdx.x; j < nv; j += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * nv + j];
    row[j * N + n] = s;
  }
}

// ---------------------------------------------------------------------------
// Designs with a compile-time channel block NC (K4f (c), K4b (c)): the
// channels of a block that has fewer (the last, nc < NC) repeat channel
// nc - 1, whose results are dropped, so no branch splits the 2 NC
// independent section products of a k.  K4b's blocks hold `bins` <=
// kThreads bins (a runtime size): the cascade runs on threads < bins, the
// tap sums on all kThreads threads.
// ---------------------------------------------------------------------------
template <int NC, int PT>
__device__ __forceinline__ void cascade_nc(const float* taps_s, int K, int nc, float2 z,
                                           float2 (&h)[NC], bool (&ok)[NC]) {
  float2 pb[NC], pa[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) pb[i] = pa[i] = make_float2(1.0f, 0.0f);
  for (int k = 0; k < K; ++k) {
    const float* tk = taps_s + k * nc * 2 * PT;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float* c = tk + min(i, nc - 1) * 2 * PT;
      pb[i] = cmul(pb[i], horner_s<PT>(c, PT, z));
      pa[i] = cmul(pa[i], horner_s<PT>(c + PT, PT, z));
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) h[i] = guarded_ratio(pb[i], pa[i], ok[i]);
}

template <int NC, int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_fwd_nc_kernel(const float* __restrict__ b, const float* __restrict__ a,
                              float2* __restrict__ H, int M, int N, int K, int bin_blocks,
                              float w_scale, float off) {
  extern __shared__ float4 smem4[];
  const int m0 = (blockIdx.x % bin_blocks) * kThreads;
  const int c0 = (blockIdx.x / bin_blocks) * NC;
  const int nc = min(NC, N - c0);
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* out_s = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [kThreads][nc]
  stage_taps(b, a, taps_s, K, PT, N, c0, nc, threadIdx.x, kThreads);
  const float2 z = bin_phasor(m0 + threadIdx.x, w_scale, off);
  __syncthreads();
  float2 h[NC];
  bool ok[NC];
  cascade_nc<NC, PT>(taps_s, K, nc, z, h, ok);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i < nc) out_s[threadIdx.x * nc + i] = h[i];
  }
  __syncthreads();
  store_tile(out_s, H, m0, min(kThreads, M - m0), N, c0, nc, threadIdx.x, kThreads);
}

// tap_sums over `bins` rows (runs of bins / parts)
template <int P>
__device__ __forceinline__ void tap_sums_rows(const float2* rows, const float* taps_s, float* acc,
                                              int K, int N, int c0, int nc, int parts, int bins,
                                              float* __restrict__ row) {
  const int S = 2 * K * nc;
  const int run = bins / parts;
  for (int item = threadIdx.x; item < S * parts; item += kThreads) {
    const int r = item / S;
    const int s = item - r * S;  // (part K + k) nc + i
    const int sk = s / nc;
    const int i = s - sk * nc;
    const int part = sk >= K;
    const int k = sk - part * K;
    float c[P], sum[P];
    const float* cs = taps_s + ((k * nc + i) * 2 + part) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      c[p] = cs[p];
      sum[p] = 0.0f;
    }
    const float sign = part ? -1.0f : 1.0f;
    const float2* rb = rows + r * run * (nc + 1);
#pragma unroll 4
    for (int j = 0; j < run; ++j) {
      const float2 z = rb[j * (nc + 1)];
      const float2 t = rb[j * (nc + 1) + 1 + i];
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
        row[((part * P + p) * K + k) * N + c0 + i] = sum[p];
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
      const int sk = s / nc;
      const int part = sk >= K;
      row[((part * P + p) * K + sk - part * K) * N + c0 + s - sk * nc] = total;
    }
  }
}

template <int NC, int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_bwd_nc_kernel(const float* __restrict__ b, const float* __restrict__ a,
                              const float2* __restrict__ G, float* __restrict__ partials, int M,
                              int N, int K, int parts, int bins, int bin_blocks, float w_scale,
                              float off) {
  extern __shared__ float4 smem4[];
  const int bx = blockIdx.x % bin_blocks;
  const int c0 = (blockIdx.x / bin_blocks) * NC;
  const int nc = min(NC, N - c0);
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* rows = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [bins][nc + 1]
  float* acc = reinterpret_cast<float*>(rows + bins * (nc + 1));
  stage_taps(b, a, taps_s, K, PT, N, c0, nc, threadIdx.x, kThreads);
  const int m = bx * bins + threadIdx.x;
  __syncthreads();
  if (threadIdx.x < bins) {
    const float2 z = bin_phasor(m, w_scale, off);
    float2 h[NC];
    bool ok[NC];
    cascade_nc<NC, PT>(taps_s, K, nc, z, h, ok);
    float2* mine = rows + threadIdx.x * (nc + 1);
    mine[0] = z;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < nc) {
        float2 t = make_float2(0.0f, 0.0f);
        if (m < M && ok[i]) t = cmul(G[static_cast<size_t>(m) * N + c0 + i], h[i]);
        mine[1 + i] = t;
      }
    }
  }
  __syncthreads();
  tap_sums_rows<PT>(rows, taps_s, acc, K, N, c0, nc, parts, bins,
                    partials + static_cast<size_t>(bx) * 2 * PT * K * N);
}

// ---------------------------------------------------------------------------
// K4b (d): (c) with branch-free tap sums.  In (c) the guarded quotient of a
// visit compiles to a branch (the t load moved inside it), and the
// reconvergence around each branch keeps a run's visits from overlapping;
// here a section whose |response|^2 is 0 gets a zero reciprocal by two
// selects, and every G load is issued unconditionally (clamped to a valid
// row and channel) before the cascade.
// ---------------------------------------------------------------------------
template <int P>
__device__ __forceinline__ void tap_sums_free(const float2* rows, const float* taps_s, float* acc,
                                              int K, int N, int c0, int nc, int parts, int bins,
                                              float* __restrict__ row) {
  const int S = 2 * K * nc;
  const int run = bins / parts;
  for (int item = threadIdx.x; item < S * parts; item += kThreads) {
    const int r = item / S;
    const int s = item - r * S;  // (part K + k) nc + i
    const int sk = s / nc;
    const int i = s - sk * nc;
    const int part = sk >= K;
    const int k = sk - part * K;
    float c[P], sum[P];
    const float* cs = taps_s + ((k * nc + i) * 2 + part) * P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      c[p] = cs[p];
      sum[p] = 0.0f;
    }
    const float sign = part ? -1.0f : 1.0f;
    const float2* rb = rows + r * run * (nc + 1);
#pragma unroll 4
    for (int j = 0; j < run; ++j) {
      const float2 z = rb[j * (nc + 1)];
      const float2 t = rb[j * (nc + 1) + 1 + i];
      const float2 sec = horner_s<P>(c, P, z);
      const float d = cabs2(sec);
      const bool ok = d > 0.0f;
      const float inv = __fdividef(ok ? sign : 0.0f, ok ? d : 1.0f);
      float2 q = make_float2((t.x * sec.x + t.y * sec.y) * inv, (t.y * sec.x - t.x * sec.y) * inv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        sum[p] += q.x;
        if (p + 1 < P) q = cmul(q, z);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (parts == 1) {
        row[((part * P + p) * K + k) * N + c0 + i] = sum[p];
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
      const int sk = s / nc;
      const int part = sk >= K;
      row[((part * P + p) * K + sk - part * K) * N + c0 + s - sk * nc] = total;
    }
  }
}

template <int NC, int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_bwd_free_kernel(const float* __restrict__ b, const float* __restrict__ a,
                                const float2* __restrict__ G, float* __restrict__ partials, int M,
                                int N, int K, int parts, int bins, int bin_blocks, float w_scale,
                                float off) {
  extern __shared__ float4 smem4[];
  const int bx = blockIdx.x % bin_blocks;
  const int c0 = (blockIdx.x / bin_blocks) * NC;
  const int nc = min(NC, N - c0);
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* rows = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [bins][nc + 1]
  float* acc = reinterpret_cast<float*>(rows + bins * (nc + 1));
  stage_taps(b, a, taps_s, K, PT, N, c0, nc, threadIdx.x, kThreads);
  const int m = bx * bins + threadIdx.x;
  __syncthreads();
  if (threadIdx.x < bins) {
    float2 gv[NC];
    const size_t g0 = static_cast<size_t>(min(m, M - 1)) * N + c0;
#pragma unroll
    for (int i = 0; i < NC; ++i) gv[i] = G[g0 + min(i, nc - 1)];
    const float2 z = bin_phasor(m, w_scale, off);
    float2 h[NC];
    bool ok[NC];
    cascade_nc<NC, PT>(taps_s, K, nc, z, h, ok);
    float2* mine = rows + threadIdx.x * (nc + 1);
    mine[0] = z;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float2 t = cmul(gv[i], h[i]);
      if (i < nc) mine[1 + i] = m < M && ok[i] ? t : make_float2(0.0f, 0.0f);
    }
  }
  __syncthreads();
  tap_sums_free<PT>(rows, taps_s, acc, K, N, c0, nc, parts, bins,
                    partials + static_cast<size_t>(bx) * 2 * PT * K * N);
}

// ---------------------------------------------------------------------------
// host side: sizes, plans, launches
// ---------------------------------------------------------------------------
inline bool sizes_ok(int M, int N, int K, int P, int cb) {
  return M >= 1 && N >= 1 && K >= 1 && K <= kMaxK && P >= 1 && P <= kMaxP && cb >= 1 &&
         cb <= kMaxCB && static_cast<long long>(M) * N <= 0x7fffffffLL - kThreads;
}

inline int fwd_smem_floats(int cb, int K, int P) { return 2 * P * K * cb + 2 * kThreads * cb; }

inline int fwd_lanes_smem_floats(int cb, int K, int P) {
  return 2 * P * K * cb + 2 * 32 + 2 * 32 * cb;
}

// K4b's dynamic shared memory in floats: the staged taps, the bins' rows
// and, with parts > 1, the runs' tap sums (ops/sos_kernels.py plans parts
// with the same count)
inline int bwd_smem_floats(int cb, int K, int P, int parts) {
  const int taps = 2 * P * K * cb;
  return taps + 2 * kThreads * (cb + 1) + (parts > 1 ? parts * taps : 0);
}

inline int blocks(int n, int per) { return (n + per - 1) / per; }

template <int PT>
cudaError_t launch_fwd(int design, const float* b, const float* a, float2* H, int M, int N, int K,
                       int cb, float w_scale, float off, cudaStream_t s) {
  const int cblocks = blocks(N, cb);
  if (design == 0) {
    const int bin_blocks = blocks(M, kThreads);
    const size_t smem = sizeof(float) * fwd_smem_floats(cb, K, PT);
    sos_cascade_fwd_kernel<PT><<<bin_blocks * cblocks, kThreads, smem, s>>>(
        b, a, H, M, N, K, cb, bin_blocks, w_scale, off);
  } else {
    if (cblocks > 65535) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * fwd_lanes_smem_floats(cb, K, PT);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sos_cascade_fwd_lanes_kernel<PT>, 32 * cb, smem);
    if (err != cudaSuccess) return err;
    const int resident = per_sm * sms / cblocks;
    const dim3 grid(std::min(blocks(M, 32), std::max(resident, 1)), cblocks);
    sos_cascade_fwd_lanes_kernel<PT><<<grid, dim3(32, cb), smem, s>>>(b, a, H, M, N, K, cb,
                                                                     w_scale, off);
  }
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_bwd(int design, const float* b, const float* a, const float2* G,
                       float* partials, int M, int N, int K, int cb, int parts, float w_scale,
                       float off, cudaStream_t s) {
  const int bin_blocks = blocks(M, kThreads);
  if (design == 0) {
    const size_t smem = sizeof(float) * bwd_smem_floats(cb, K, PT, parts);
    sos_cascade_bwd_kernel<PT><<<bin_blocks * blocks(N, cb), kThreads, smem, s>>>(
        b, a, G, partials, M, N, K, cb, parts, bin_blocks, w_scale, off);
  } else {
    if (N > 65535) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * kWarps * 2 * PT * K;
    sos_cascade_bwd_halving_kernel<PT><<<dim3(bin_blocks, N), kThreads, smem, s>>>(
        b, a, G, partials, M, N, K, w_scale, off);
  }
  return cudaGetLastError();
}

struct FwdArgs {
  const float* b;
  const float* a;
  float2* H;
  int M, N, K;
  float w_scale, off;
  cudaStream_t s;
};

struct BwdArgs {
  const float* b;
  const float* a;
  const float2* G;
  float* partials;
  int M, N, K, parts, bins;
  float w_scale, off;
  cudaStream_t s;
};

template <int NC, int PT>
cudaError_t fwd_nc(const FwdArgs& x) {
  const int bin_blocks = blocks(x.M, kThreads);
  const size_t smem = sizeof(float) * fwd_smem_floats(NC, x.K, PT);
  sos_cascade_fwd_nc_kernel<NC, PT><<<bin_blocks * blocks(x.N, NC), kThreads, smem, x.s>>>(
      x.b, x.a, x.H, x.M, x.N, x.K, bin_blocks, x.w_scale, x.off);
  return cudaGetLastError();
}

// K4b (c)'s dynamic shared memory in floats with `bins` rows a block
inline int bwd_nc_smem_floats(int cb, int K, int P, int parts, int bins) {
  const int taps = 2 * P * K * cb;
  return taps + 2 * bins * (cb + 1) + (parts > 1 ? parts * taps : 0);
}

template <int NC, int PT>
cudaError_t bwd_nc(const BwdArgs& x) {
  const int bin_blocks = blocks(x.M, x.bins);
  const size_t smem = sizeof(float) * bwd_nc_smem_floats(NC, x.K, PT, x.parts, x.bins);
  sos_cascade_bwd_nc_kernel<NC, PT><<<bin_blocks * blocks(x.N, NC), kThreads, smem, x.s>>>(
      x.b, x.a, x.G, x.partials, x.M, x.N, x.K, x.parts, x.bins, bin_blocks, x.w_scale, x.off);
  return cudaGetLastError();
}

template <int NC, int PT>
cudaError_t bwd_free(const BwdArgs& x) {
  const int bin_blocks = blocks(x.M, x.bins);
  const size_t smem = sizeof(float) * bwd_nc_smem_floats(NC, x.K, PT, x.parts, x.bins);
  sos_cascade_bwd_free_kernel<NC, PT><<<bin_blocks * blocks(x.N, NC), kThreads, smem, x.s>>>(
      x.b, x.a, x.G, x.partials, x.M, x.N, x.K, x.parts, x.bins, bin_blocks, x.w_scale, x.off);
  return cudaGetLastError();
}

#define SC_P_CASES(F, NC, X)          \
  switch (P) {                        \
    case 1: return F<NC, 1>(X);       \
    case 2: return F<NC, 2>(X);       \
    case 3: return F<NC, 3>(X);       \
    case 4: return F<NC, 4>(X);       \
    case 5: return F<NC, 5>(X);       \
    case 6: return F<NC, 6>(X);       \
    case 7: return F<NC, 7>(X);       \
    default: return F<NC, 8>(X);      \
  }

template <int NC>
cudaError_t fwd_nc_p(int P, const FwdArgs& x) {
  SC_P_CASES(fwd_nc, NC, x)
}

template <int NC>
cudaError_t bwd_nc_p(int P, const BwdArgs& x) {
  SC_P_CASES(bwd_nc, NC, x)
}

template <int NC>
cudaError_t bwd_free_p(int P, const BwdArgs& x) {
  SC_P_CASES(bwd_free, NC, x)
}

#define SC_NC_CASES(F, X)             \
  switch (cb) {                       \
    case 1: return F<1>(P, X);        \
    case 2: return F<2>(P, X);        \
    case 3: return F<3>(P, X);        \
    case 4: return F<4>(P, X);        \
    case 5: return F<5>(P, X);        \
    case 6: return F<6>(P, X);        \
    case 7: return F<7>(P, X);        \
    default: return F<8>(P, X);       \
  }

inline cudaError_t fwd_nc_any(int cb, int P, const FwdArgs& x) { SC_NC_CASES(fwd_nc_p, x) }

inline cudaError_t bwd_nc_any(int cb, int P, const BwdArgs& x) { SC_NC_CASES(bwd_nc_p, x) }

inline cudaError_t bwd_free_any(int cb, int P, const BwdArgs& x) { SC_NC_CASES(bwd_free_p, x) }

}  // namespace sc

#define SC_SWITCH_P(P, CALL) \
  switch (P) {               \
    case 1: CALL(1); break;  \
    case 2: CALL(2); break;  \
    case 3: CALL(3); break;  \
    case 4: CALL(4); break;  \
    case 5: CALL(5); break;  \
    case 6: CALL(6); break;  \
    case 7: CALL(7); break;  \
    default: CALL(8); break; \
  }

extern "C" {

int sc_threads_per_block() { return sc::kThreads; }

// one library for every channel count: it reports N = 1, as built
int sc_channels() { return 1; }

const char* sc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4f: H (M, N) complex64 from the taps b, a (P, K, N); cb channels a
// block (1..kMaxCB); design 0 one thread a bin, 1 a thread per (bin,
// channel).
int sos_cascade_fwd_launch(const void* b, const void* a, void* H, int M, int N, int K, int P,
                           int cb, int design, float w_scale, float off, void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb) || design < 0 || design > 1) return sc::kBadSize;
  cudaError_t err = cudaSuccess;
#define SC_FWD(PV)                                                                           \
  err = sc::launch_fwd<PV>(design, static_cast<const float*>(b), static_cast<const float*>(a), \
                           static_cast<float2*>(H), M, N, K, cb, w_scale, off,                 \
                           static_cast<cudaStream_t>(stream))
  SC_SWITCH_P(P, SC_FWD)
#undef SC_FWD
  return static_cast<int>(err);
}

// K4b: partials (ceil(M / kThreads), 2, P, K, N) float32, one row per bin
// block, from JAX's cotangent G (M, N) complex64 of H; cb channels a block,
// their tap sums over parts runs of the block's bins (a power of two,
// within 48 KB of shared memory: bwd_smem_floats); design 0 the
// transposed tap sums, 1 the grid (bin blocks, N) with halving sums (cb
// and parts unused).
int sos_cascade_bwd_launch(const void* b, const void* a, const void* G, void* partials, int M,
                           int N, int K, int P, int cb, int parts, int design, float w_scale,
                           float off, void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb) || design < 0 || design > 1) return sc::kBadSize;
  if (parts < 1 || parts > sc::kThreads || (parts & (parts - 1)) != 0 ||
      sc::bwd_smem_floats(cb, K, P, parts) > sc::kMaxSharedFloats)
    return sc::kBadSize;
  cudaError_t err = cudaSuccess;
#define SC_BWD(PV)                                                                           \
  err = sc::launch_bwd<PV>(design, static_cast<const float*>(b), static_cast<const float*>(a), \
                           static_cast<const float2*>(G), static_cast<float*>(partials), M, N, \
                           K, cb, parts, w_scale, off, static_cast<cudaStream_t>(stream))
  SC_SWITCH_P(P, SC_BWD)
#undef SC_BWD
  return static_cast<int>(err);
}

// K4f (c): H as sos_cascade_fwd_launch, the channel block cb a
// compile-time one.
int sos_cascade_fwd_nc_launch(const void* b, const void* a, void* H, int M, int N, int K, int P,
                              int cb, float w_scale, float off, void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb)) return sc::kBadSize;
  const sc::FwdArgs x{static_cast<const float*>(b), static_cast<const float*>(a),
                      static_cast<float2*>(H), M, N, K, w_scale, off,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sc::fwd_nc_any(cb, P, x));
}

// K4b (c): partials (ceil(M / bins), 2, P, K, N), blocks of `bins` bins
// (32..kThreads, a multiple of 32), the channel block cb a compile-time one.
int sos_cascade_bwd_nc_launch(const void* b, const void* a, const void* G, void* partials, int M,
                              int N, int K, int P, int cb, int parts, int bins, float w_scale,
                              float off, void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb)) return sc::kBadSize;
  if (bins < 32 || bins > sc::kThreads || bins % 32 != 0 || parts < 1 || parts > bins ||
      (parts & (parts - 1)) != 0 ||
      sc::bwd_nc_smem_floats(cb, K, P, parts, bins) > sc::kMaxSharedFloats)
    return sc::kBadSize;
  const sc::BwdArgs x{static_cast<const float*>(b), static_cast<const float*>(a),
                      static_cast<const float2*>(G), static_cast<float*>(partials), M, N, K,
                      parts, bins, w_scale, off, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sc::bwd_nc_any(cb, P, x));
}

// K4b (d): as (c), its tap sums branch-free.
int sos_cascade_bwd_free_launch(const void* b, const void* a, const void* G, void* partials,
                                int M, int N, int K, int P, int cb, int parts, int bins,
                                float w_scale, float off, void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb)) return sc::kBadSize;
  if (bins < 32 || bins > sc::kThreads || bins % 32 != 0 || parts < 1 || parts > bins ||
      (parts & (parts - 1)) != 0 ||
      sc::bwd_nc_smem_floats(cb, K, P, parts, bins) > sc::kMaxSharedFloats)
    return sc::kBadSize;
  const sc::BwdArgs x{static_cast<const float*>(b), static_cast<const float*>(a),
                      static_cast<const float2*>(G), static_cast<float*>(partials), M, N, K,
                      parts, bins, w_scale, off, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sc::bwd_free_any(cb, P, x));
}

}  // extern "C"
