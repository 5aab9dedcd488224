// Hand-written Hopper (sm_90a) kernels K4f and K4b, the guarded SOS cascade
// and its tap VJP, with a plain C interface that
// flamo_tpu_torch/ops/sos_kernels.py loads through ctypes.  One library
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
// is FLT_EPSILON (real) with zero gradient where prod_k A_kn = 0, as
// _iir_guard_prods (the running products are kept near 1 by powers of two,
// sos_common.cuh's pow2_scale, so a long cascade does not underflow); a
// single section whose |B_k|^2 or |A_k|^2 is 0 adds nothing to the tap
// cotangents.  Taps are (P, K, N) float32, row-major,
// P <= kMaxP, K <= kMaxK.
//
// What bounds them on an H100: issue slots and one block's dependent
// chain.  A bin costs ~3.0 kFLOP of Horner sums and products in K4f and
// ~7.7 kFLOP in K4b (the cascade again, then the 2 K N section quotients
// and their P powers), against 48-60 bytes of taps, H, G and partials: at
// 67 TFLOP/s and 3.35 TB/s the operations take 3-7x the memory time
// (chip_smoke.py's kernel_work).  At the attenuated FDN's size (M = 48001,
// N = 6, K = 12, P = 3) the grid is ~3 blocks an SM, and one block alone
// (one bin) takes over half a launch's time: 0.0034 of 0.0063 ms in K4f
// and 0.0107 of 0.0188 ms in K4b (chip_smoke.py phase 5, NVIDIA H100 80GB
// HBM3 at 700 W).  So the design cuts instructions and branches on that
// chain.
//
// The design (the model is K5's, sos_kernels.cu): one thread a bin over the
// NC channels of its block.  The block stages its channels' 2 P K taps in
// shared memory once (broadcast reads: every lane of a warp reads the same
// tap), computes each bin's phasor once (the accurate sincosf: near
// m = nfft/2 the angle is close to pi, where the fast intrinsic loses
// digits), and runs the cascade with k outer, so that the 2 NC section
// products of a k are independent (the k loop unrolled by 2).  NC and P
// are compile-time counts (a switch on the runtime channel block and P
// picks one of 64 copies), so no branch splits those products: the last
// block, with nc < NC channels, repeats its channel nc - 1 and drops the
// copies.  The taps are staged with all of a thread's loads in flight, and
// a section's Horner sum starts from its top tap times z (no product with
// a zero imaginary part).  K4f writes H through shared memory in
// coalesced rows.  K4b
// issues its G loads before the cascade, parks each bin's z and
// t_n = G_n H_n in shared memory, and the block's threads then take its
// 2 K NC sections over runs of its bins (K5's transposed tap sums: no
// shuffle trees, no atomics, so two launches give the same bits); a
// visit has no branch (a section whose |response|^2 is 0 gets a zero
// reciprocal by selects), so the visits of a run overlap.  It writes one
// row of 2 P K N sums per bin block, ((part P + p) K + k) N + n, which the
// wrapper adds with one torch.sum.  Threads of the ragged edge m >= M run
// with t = 0, so they add exactly 0, and join every barrier.  The designs
// weighed on the way, with their times, are in controls/k4_designs.

#include <cfloat>
#include <cstddef>

#include "sos_common.cuh"

namespace sc {

using sos::bin_phasor;
using sos::cabs2;
using sos::cmul;
using sos::kMaxK;
using sos::kMaxP;
using sos::pow2_scale;
using sos::rescale_pair;
using sos::scaled;

constexpr int kThreads = 128;  // bins a block
constexpr int kMaxCB = 8;      // channels a block
constexpr int kBadSize = -2;
constexpr int kMaxSharedFloats = 48 * 1024 / 4;  // a block without opting in

// v / n, by the compile-time NC where n is the block's full channel count
// (every block but a last, shorter one)
template <int NC>
__device__ __forceinline__ int div_nc(int v, int n) {
  return n == NC ? v / NC : v / n;
}

// The taps of channels c0 .. c0 + nc - 1 in shared memory, a section's P
// taps together: taps_s[((k nc + i) 2 + part) P + p], part 0 the numerator
// b, 1 the denominator a.  A thread takes the 2 P taps of one (k, i) at a
// time, every load issued before the first store (one round trip for the
// K nc <= kThreads sections of the main path); neighbouring threads read
// neighbouring channels, and no index takes a division by a runtime size.
template <int NC, int PT>
__device__ __forceinline__ void stage_taps(const float* __restrict__ b,
                                           const float* __restrict__ a, float* taps_s, int K,
                                           int N, int c0, int nc) {
  const int per = K * nc;  // the block's sections: k nc + i
  const size_t row = static_cast<size_t>(K) * N;  // from tap p to tap p + 1
  for (int e0 = 0; e0 < per; e0 += kThreads) {
    const int e = min(e0 + static_cast<int>(threadIdx.x), per - 1);
    const int k = div_nc<NC>(e, nc);
    const size_t src = static_cast<size_t>(k) * N + c0 + e - k * nc;
    float v[2 * PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      v[p] = __ldg(b + p * row + src);
      v[PT + p] = __ldg(a + p * row + src);
    }
    if (e0 + static_cast<int>(threadIdx.x) < per) {
#pragma unroll
      for (int j = 0; j < 2 * PT; ++j) taps_s[e * 2 * PT + j] = v[j];
    }
  }
}

// the reciprocal of d > 0 in one instruction (within 1 ulp; a d below
// FLT_MIN is taken as FLT_MIN)
__device__ __forceinline__ float fast_rcp(float d) {
  d = fmaxf(d, FLT_MIN);
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
#else
  return 1.0f / d;
#endif
}

// sum_p c[p] z^p by Horner, from the highest tap down
template <int PT>
__device__ __forceinline__ float2 section(const float* c, float2 z) {
  if (PT == 1) return make_float2(c[0], 0.0f);
  float2 out = make_float2(fmaf(c[PT - 1], z.x, c[PT - 2]), c[PT - 1] * z.y);
#pragma unroll
  for (int p = PT - 3; p >= 0; --p) {
    out = cmul(out, z);
    out.x += c[p];
  }
  return out;
}

// pb / pa, guarded: FLT_EPSILON where |pa|^2 = 0 (ok false)
__device__ __forceinline__ float2 guarded_ratio(float2 pb, float2 pa, bool& ok) {
  const float den = cabs2(pa);
  ok = den != 0.0f;
  const float inv = 1.0f / (ok ? den : 1.0f);
  return ok ? make_float2((pb.x * pa.x + pb.y * pa.y) * inv, (pb.y * pa.x - pb.x * pa.y) * inv)
            : make_float2(FLT_EPSILON, 0.0f);
}

// The guarded cascades of the block's nc <= NC channels at z, k outer,
// the running products rescaled by a power of two at each section
// (sos_common.cuh's pow2_scale); channels i >= nc repeat channel nc - 1.
template <int NC, int PT>
__device__ __forceinline__ void cascade(const float* taps_s, int K, int nc, float2 z,
                                        float2 (&h)[NC], bool (&ok)[NC]) {
  float2 pb[NC], pa[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) pb[i] = pa[i] = make_float2(1.0f, 0.0f);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* tk = taps_s + k * nc * 2 * PT;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float* c = tk + min(i, nc - 1) * 2 * PT;
      const float s = pow2_scale(pa[i]);
      pb[i] = scaled(cmul(pb[i], section<PT>(c, z)), s);
      pa[i] = scaled(cmul(pa[i], section<PT>(c + PT, z)), s);
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    rescale_pair(pb[i], pa[i]);
    h[i] = guarded_ratio(pb[i], pa[i], ok[i]);
  }
}

// K4f: block x = channel block (x / bin_blocks) of NC channels over the
// kThreads bins of bin block (x % bin_blocks), one thread a bin; H (M, N)
// complex64, interleaved.
template <int NC, int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_fwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                           float2* __restrict__ H, int M, int N, int K, int bin_blocks,
                           float w_scale, float off) {
  extern __shared__ float4 smem4[];
  const int m0 = (blockIdx.x % bin_blocks) * kThreads;
  const int c0 = (blockIdx.x / bin_blocks) * NC;
  const int nc = min(NC, N - c0);
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* out_s = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [kThreads][nc]
  stage_taps<NC, PT>(b, a, taps_s, K, N, c0, nc);
  const float2 z = bin_phasor(m0 + threadIdx.x, w_scale, off);
  __syncthreads();
  float2 h[NC];
  bool ok[NC];
  cascade<NC, PT>(taps_s, K, nc, z, h, ok);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i < nc) out_s[threadIdx.x * nc + i] = h[i];
  }
  __syncthreads();
  const int n_out = min(kThreads, M - m0) * nc;
  for (int v = threadIdx.x; v < n_out; v += kThreads) {
    const int j = div_nc<NC>(v, nc);
    H[static_cast<size_t>(m0 + j) * N + c0 + v - j * nc] = out_s[v];
  }
}

// K4b's tap sums, transposed (K5's tap_sums over a channel block).  The
// block's bins have parked their phasor z and their t_i = G_i H_i in
// `bins` (row j at j (NC + 1): z, t_0 .. t_{nc-1}).  A work item is one
// section (part, k, i) over one run of kThreads / parts bins: its thread
// keeps the section's P taps and P sums in registers and walks the run,
// every lane of a warp on the same bin (shared-memory broadcasts of z),
// adding
//   b_bar[p,k,n] += Re(t_i / B_kn z^p),  a_bar[p,k,n] -= Re(t_i / A_kn z^p)
// a bin, nothing where |B_kn|^2 or |A_kn|^2 is 0 (the reciprocal is the
// fast one, fast_rcp, within 1 ulp; a zero section's is 0 by a select, so
// a visit has no branch).  With one run an item writes its P sums into
// the block's row at ((part P + p) K + k) N + c0 + i; with more, the runs'
// sums meet in `acc` and are added in run order.  A thread's items step
// by kThreads, so (run, section) follow without a division.
template <int NC, int P>
__device__ __forceinline__ void tap_sums(const float2* bins, const float* taps_s, float* acc,
                                         int K, int N, int c0, int nc, int parts,
                                         float* __restrict__ row) {
  const int S = 2 * K * nc;
  const int run = kThreads / parts;
  int r = 0, s = threadIdx.x;  // the item's run and section (part K + k) nc + i
  while (s >= S) {
    s -= S;
    ++r;
  }
  for (; r < parts; s += kThreads) {
    while (s >= S) {
      s -= S;
      ++r;
    }
    if (r >= parts) break;
    const int sk = div_nc<NC>(s, nc);
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
    const float2* rb = bins + r * run * (NC + 1);
#pragma unroll 4
    for (int j = 0; j < run; ++j) {
      const float2 z = rb[j * (NC + 1)];
      const float2 t = rb[j * (NC + 1) + 1 + i];
      const float2 sec = section<P>(c, z);
      const float d = cabs2(sec);
      const float inv = d > 0.0f ? sign * fast_rcp(d) : 0.0f;
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
      for (int q = 0; q < parts; ++q) total += acc[v * parts + q];
      const int sv = v / P;
      const int p = v - sv * P;
      const int sk = div_nc<NC>(sv, nc);
      const int part = sk >= K;
      row[((part * P + p) * K + sk - part * K) * N + c0 + sv - sk * nc] = total;
    }
  }
}

// K4b: block x = channel block (x / bin_blocks) of NC channels over the
// kThreads bins of bin block (x % bin_blocks); G is JAX's cotangent of H,
// (M, N) complex64; row x % bin_blocks of partials gets the block's
// channels' 2 P K sums.
template <int NC, int PT>
__global__ void __launch_bounds__(kThreads)
    sos_cascade_bwd_kernel(const float* __restrict__ b, const float* __restrict__ a,
                           const float2* __restrict__ G, float* __restrict__ partials, int M,
                           int N, int K, int parts, int bin_blocks, float w_scale, float off) {
  extern __shared__ float4 smem4[];
  const int bx = blockIdx.x % bin_blocks;
  const int c0 = (blockIdx.x / bin_blocks) * NC;
  const int nc = min(NC, N - c0);
  float* taps_s = reinterpret_cast<float*>(smem4);
  float2* bins = reinterpret_cast<float2*>(taps_s + 2 * PT * K * nc);  // [kThreads][NC + 1]
  float* acc = reinterpret_cast<float*>(bins + kThreads * (NC + 1));   // [2 K nc P][parts]
  const int m = bx * kThreads + threadIdx.x;
  float2 g[NC];  // loaded at once, from a valid row and channel
  const size_t g0 = static_cast<size_t>(min(m, M - 1)) * N + c0;
#pragma unroll
  for (int i = 0; i < NC; ++i) g[i] = G[g0 + min(i, nc - 1)];
  stage_taps<NC, PT>(b, a, taps_s, K, N, c0, nc);
  const float2 z = bin_phasor(m, w_scale, off);
  __syncthreads();
  float2 h[NC];
  bool ok[NC];
  cascade<NC, PT>(taps_s, K, nc, z, h, ok);
  float2* mine = bins + threadIdx.x * (NC + 1);
  mine[0] = z;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float2 t = cmul(g[i], h[i]);
    if (i < nc) mine[1 + i] = m < M && ok[i] ? t : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  tap_sums<NC, PT>(bins, taps_s, acc, K, N, c0, nc, parts,
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

// K4b's dynamic shared memory in floats: the staged taps, the bins' rows
// and, with parts > 1, the runs' tap sums (ops/sos_kernels.py plans parts
// with the same count)
inline int bwd_smem_floats(int cb, int K, int P, int parts) {
  const int taps = 2 * P * K * cb;
  return taps + 2 * kThreads * (cb + 1) + (parts > 1 ? parts * taps : 0);
}

inline int blocks(int n, int per) { return (n + per - 1) / per; }

struct Args {
  const float* b;
  const float* a;
  const float2* G;  // K4b
  void* out;        // K4f: H; K4b: partials
  int M, N, K, parts;
  float w_scale, off;
  cudaStream_t s;
};

template <int NC, int PT>
cudaError_t launch_fwd(const Args& x) {
  const int bin_blocks = blocks(x.M, kThreads);
  const size_t smem = sizeof(float) * fwd_smem_floats(NC, x.K, PT);
  sos_cascade_fwd_kernel<NC, PT><<<bin_blocks * blocks(x.N, NC), kThreads, smem, x.s>>>(
      x.b, x.a, static_cast<float2*>(x.out), x.M, x.N, x.K, bin_blocks, x.w_scale, x.off);
  return cudaGetLastError();
}

template <int NC, int PT>
cudaError_t launch_bwd(const Args& x) {
  const int bin_blocks = blocks(x.M, kThreads);
  const size_t smem = sizeof(float) * bwd_smem_floats(NC, x.K, PT, x.parts);
  sos_cascade_bwd_kernel<NC, PT><<<bin_blocks * blocks(x.N, NC), kThreads, smem, x.s>>>(
      x.b, x.a, x.G, static_cast<float*>(x.out), x.M, x.N, x.K, x.parts, bin_blocks, x.w_scale,
      x.off);
  return cudaGetLastError();
}

// the launch of kernel F<NC, P> for the runtime P
template <int NC, bool BWD>
cudaError_t launch_p(int P, const Args& x) {
  switch (P) {
    case 1: return BWD ? launch_bwd<NC, 1>(x) : launch_fwd<NC, 1>(x);
    case 2: return BWD ? launch_bwd<NC, 2>(x) : launch_fwd<NC, 2>(x);
    case 3: return BWD ? launch_bwd<NC, 3>(x) : launch_fwd<NC, 3>(x);
    case 4: return BWD ? launch_bwd<NC, 4>(x) : launch_fwd<NC, 4>(x);
    case 5: return BWD ? launch_bwd<NC, 5>(x) : launch_fwd<NC, 5>(x);
    case 6: return BWD ? launch_bwd<NC, 6>(x) : launch_fwd<NC, 6>(x);
    case 7: return BWD ? launch_bwd<NC, 7>(x) : launch_fwd<NC, 7>(x);
    default: return BWD ? launch_bwd<NC, 8>(x) : launch_fwd<NC, 8>(x);
  }
}

// ... and for the runtime channel block cb
template <bool BWD>
cudaError_t launch(int cb, int P, const Args& x) {
  switch (cb) {
    case 1: return launch_p<1, BWD>(P, x);
    case 2: return launch_p<2, BWD>(P, x);
    case 3: return launch_p<3, BWD>(P, x);
    case 4: return launch_p<4, BWD>(P, x);
    case 5: return launch_p<5, BWD>(P, x);
    case 6: return launch_p<6, BWD>(P, x);
    case 7: return launch_p<7, BWD>(P, x);
    default: return launch_p<8, BWD>(P, x);
  }
}

}  // namespace sc

extern "C" {

int sc_threads_per_block() { return sc::kThreads; }

// one library for every channel count: it reports N = 1, as built
int sc_channels() { return 1; }

const char* sc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4f: H (M, N) complex64 from the taps b, a (P, K, N); cb channels a
// block (1..kMaxCB).
int sos_cascade_fwd_launch(const void* b, const void* a, void* H, int M, int N, int K, int P,
                           int cb, float w_scale, float off, void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb)) return sc::kBadSize;
  const sc::Args x{static_cast<const float*>(b), static_cast<const float*>(a), nullptr, H,
                   M, N, K, 1, w_scale, off, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sc::launch<false>(cb, P, x));
}

// K4b: partials (ceil(M / kThreads), 2, P, K, N) float32, one row per bin
// block, from JAX's cotangent G (M, N) complex64 of H; cb channels a block,
// their tap sums over parts runs of the block's bins (a power of two,
// within 48 KB of shared memory: bwd_smem_floats).
int sos_cascade_bwd_launch(const void* b, const void* a, const void* G, void* partials, int M,
                           int N, int K, int P, int cb, int parts, float w_scale, float off,
                           void* stream) {
  if (!sc::sizes_ok(M, N, K, P, cb)) return sc::kBadSize;
  if (parts < 1 || parts > sc::kThreads || (parts & (parts - 1)) != 0 ||
      sc::bwd_smem_floats(cb, K, P, parts) > sc::kMaxSharedFloats)
    return sc::kBadSize;
  const sc::Args x{static_cast<const float*>(b), static_cast<const float*>(a),
                   static_cast<const float2*>(G), partials, M, N, K, parts, w_scale, off,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(sc::launch<true>(cb, P, x));
}

}  // extern "C"
