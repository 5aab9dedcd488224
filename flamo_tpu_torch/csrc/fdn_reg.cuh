// The register-resident per-bin elimination core of fdn_reg.cu, for
// 17 <= N <= 64 channels, N a run-time value.  It computes what
// fdn_loop.cuh's shared-memory core computes, with the same pivot rule
// (the strictly larger |a|^2 wins, the first such row), but keeps each
// row of a bin's N x N complex system in the registers of the thread (or
// the two threads) that own it:
//
//   H = 1, 17 <= N <= 32: one warp a bin, lane r owns row r, all of its
//     columns j = c (c = 0..31) in float2 a[32];
//   H = 2, 33 <= N <= 64: a group of G = ceil(N / 16) warps a bin (3 or 4,
//     the group's size follows N so that at most 15 padding rows idle),
//     thread t owns half h = t % 2 of row r = t / 2: the columns
//     j = 2c + h, dealt cyclically over the pair, so that at every step
//     both halves of a row have the same number of columns left to update
//     (the columns right of the pivot shrink evenly on both).  The pair
//     sits on neighbouring lanes and trades a row's multiplier by one
//     shuffle; the group meets at a named barrier (bar.sync 1 + its index
//     in the block, 32 G threads).
//
// Every loop over a thread's 32 places, and over the elimination's steps
// by place, is unrolled and predicated on j < N, so that no register is
// indexed at run time: step k touches a[k / H] and the places right of it
// only, and the compiler drops the places left of the pivot from each
// step's code.  With H = 2 the two steps of one place (k = 2c, 2c + 1)
// share their code, a loop of two, which halves what ptxas compiles.
// Rows are never swapped in registers: each row carries its position pos
// in the swap-based elimination (fdn_loop.cuh's pivot_rows), exchanged
// with the pivot's at each step, so that ties go to the first row of
// largest magnitude in that order, as there.
//
// Step k: the pivot search is a shuffle arg-max over (|a_k|^2, pos) of the
// rows not yet eliminated; with a group, each warp's best row writes its
// row speculatively into its warp's slot of the bin's pivot buffer and its
// (value, pos) into an arg-max word, one barrier, and every thread takes
// the best word in warp order (the buffers are double, by the step's
// parity, so that one barrier a step suffices).  The others then read the
// pivot row as broadcasts, 16 bytes a load, and update their own columns
// in registers: a row update costs FMAs and broadcast loads and no load or
// store of its own row.  The substitutions stay column by column: once
// y_i is known (the owner of position i divides and writes it to shared
// memory), every row above it subtracts its own term from its registers.
//
// Every function is called by all threads of the group with the same
// arguments; collective operations (shuffles, barriers) sit outside the
// per-row predicates.
//
// Its kernels (fdn_reg.cu) and the TPU kernels they replace
// (flamo_tpu/ops/pallas_solve.py): K2 (:277) eliminates A y = B either
// way; K3f (:451) A y = D b, its projection c^T y on the group's first
// warp; K3b (:474) the transposed system A^T w = c, assembled from the
// bin's d in shared memory, before its cotangents; K5 (:1376) both.  All
// are bound by this elimination's FP32 operations, ~(2/3) N^3 complex
// multiply-adds a bin: ~0.07 ms at N = 32 and ~0.53 ms at 64 for
// M = 48001 bins (chip_smoke.kernel_work).  What the core does about the
// shared-memory core's cost (fdn_loop.cuh: three shared-memory accesses
// for four FMAs, one warp's system 34.8 KB at N = 64) is above: a row's
// update touches registers and 16-byte broadcasts of the pivot row only,
// and a bin's shared memory is its pivot buffers and vectors.  At
// 33..64 channels each step still pays a fixed cost (the arg-max, a
// barrier, the pivot row's write and broadcast, the multiplier's shuffle)
// against half a row of updates a thread.
#pragma once

#include "fdn_loop.cuh"

namespace fdn {
namespace reg {

using loop::kFull;

constexpr int kR = 32;  // places (columns) of a row that a thread holds
constexpr int kMinN = 17;
constexpr int kMaxN = 64;

// A row buffer holds a row's halves kHS<H> float2s apart (the second
// half two float2s further than its 32 places, so that the two halves'
// broadcast loads fall in different banks), then the row's rhs and cp;
// its length kRL<H> is even, so that every buffer starts on 16 bytes.
template <int H>
constexpr int kHS = H == 1 ? kR : kR + 2;
template <int H>
constexpr int kRL = H * kHS<H> + 2;

__host__ __device__ inline int threads_a_row(int N) { return N <= 32 ? 1 : 2; }

// warps of a bin's group
__host__ __device__ inline int group_warps(int N) { return N <= 32 ? 1 : (N + 15) / 16; }

__host__ __device__ inline int al4(int n) { return (n + 3) & ~3; }

// float2s of a bin's shared memory: the pivot buffers (2 parities x G
// warps x kRL), the arg-max words (2 x G), y, w, d (W each) and two
// scalars; even, so that each bin's region starts on 16 bytes
__host__ __device__ inline int bin_float2s(int N) {
  const int H = threads_a_row(N), G = group_warps(N), W = kR * H;
  const int n = 2 * G * (H == 1 ? kRL<1> : kRL<2>) + 2 * G + 3 * W + 2;
  return n + (n & 1);
}

// conj(y) / |y|^2 and x / y as fdn_ge.cuh's crecip and cdiv, the
// reciprocal by __frcp_rn: the same correctly rounded 1 / |y|^2 as the
// division there, in a few instructions
__device__ __forceinline__ float2 crecip_rn(float2 y) {
  const float inv = __frcp_rn(y.x * y.x + y.y * y.y);
  return make_float2(y.x * inv, -y.y * inv);
}

template <int H>
struct Group {
  int t;        // the thread in its group
  int threads;  // the group's threads, 32 G
  int row;      // the row it owns (>= N: padding)
  int h;        // its half of the row (0 for H = 1)
  int lane, warp, bar;
  __device__ __forceinline__ void sync() const {
    if (H == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(threads) : "memory");
  }
};

// the group of the calling thread; groups of 32 G threads follow each
// other in the block
template <int H>
__device__ __forceinline__ Group<H> make_group(int N, int& index) {
  Group<H> g;
  g.threads = 32 * group_warps(N);
  index = threadIdx.x / g.threads;
  g.t = threadIdx.x - index * g.threads;
  g.row = g.t / H;
  g.h = g.t % H;
  g.lane = threadIdx.x & 31;
  g.warp = g.t >> 5;
  g.bar = 1 + index;
  return g;
}

// a bin's shared memory
struct Bin {
  float2* pbuf;  // [2][G][kRL]
  uint2* red;    // [2][G]: the warp's best key and its pos
  float2* y;     // [W]
  float2* w;     // [W]
  float2* d;     // [W]
  float2* scal;  // [2]
};

template <int H>
__device__ __forceinline__ Bin bin_at(float2* base, int G) {
  constexpr int W = kR * H;
  Bin s;
  s.pbuf = base;
  s.red = reinterpret_cast<uint2*>(base + 2 * G * kRL<H>);
  s.y = base + 2 * G * kRL<H> + 2 * G;
  s.w = s.y + W;
  s.d = s.w + W;
  s.scal = s.d + W;
  return s;
}

// column j's place in a row buffer
template <int H>
__device__ __forceinline__ int slot(int j) {
  return (j % H) * kHS<H> + j / H;
}

// whether place c of half h holds a column right of k = ck H + hk; with c
// and ck unrolled only H = 2's place c = ck depends on h and hk
template <int H>
__device__ __forceinline__ bool right_of(int c, int ck, int hk, int h) {
  if (H == 1) return c > ck;
  return c > ck || (c == ck && hk == 0 && h == 1);
}

// v of the half that holds column k (hk = k % H): a shuffle within the
// pair for H = 2
template <int H>
__device__ __forceinline__ float2 from_half(float2 v, int h, int hk) {
  if (H == 1) return v;
  const float2 o = make_float2(__shfl_xor_sync(kFull, v.x, 1), __shfl_xor_sync(kFull, v.y, 1));
  return h == hk ? v : o;
}

// places c with lo <= c (in pairs) of the thread's half row into buf, as
// float4s
template <int H>
__device__ __forceinline__ void put_right(float2* buf, const float2 (&a)[kR], int h, int lo) {
  float4* b4 = reinterpret_cast<float4*>(buf + h * kHS<H>);
#pragma unroll
  for (int q = 0; q < kR / 2; ++q)
    if (2 * q + 1 >= lo)
      b4[q] = make_float4(a[2 * q].x, a[2 * q].y, a[2 * q + 1].x, a[2 * q + 1].y);
}

// places c <= hi (in pairs) likewise
template <int H>
__device__ __forceinline__ void put_left(float2* buf, const float2 (&a)[kR], int h, int hi) {
  float4* b4 = reinterpret_cast<float4*>(buf + h * kHS<H>);
#pragma unroll
  for (int q = 0; q < kR / 2; ++q)
    if (2 * q <= hi) b4[q] = make_float4(a[2 * q].x, a[2 * q].y, a[2 * q + 1].x, a[2 * q + 1].y);
}

// A = I - diag(d) U (row r: d_r the row's own), or with transpose its
// transpose I - U^T diag(d) (d_j from the bin's shared vector sd), from U
// staged with row stride S; zero outside the N x N system.
template <int H>
__device__ __forceinline__ void assemble(float2 (&a)[kR], float2 dr, const float2* sd,
                                         const float* sU, int S, const Group<H>& g, int N,
                                         bool transpose) {
  const bool live = g.row < N;
#pragma unroll
  for (int c = 0; c < kR; ++c) {
    const int j = c * H + g.h;
    float2 v = make_float2(0.0f, 0.0f);
    if (live && j < N) {
      const float u = transpose ? sU[j * S + g.row] : sU[g.row * S + j];
      const float2 dd = transpose ? sd[j] : dr;
      v = make_float2(-dd.x * u, -dd.y * u);
      if (g.row == j) v.x += 1.0f;
    }
    a[c] = v;
  }
}

// The elimination of A y = rhs, PIVOT as fdn_loop.cuh's eliminate<true>;
// without it the multipliers stay in the emptied places (the unit-L
// factor), and with ADJ (no pivot only) the forward substitution
// U^T z = cp runs beside it, as the first half of fdn_loop.cuh's
// transpose_solve_from_factors: at step k the owner of row k puts its
// cp_k beside its row, every thread forms z_k = cp_k / U_kk (kept by the
// owner in z_own) and every row r > k subtracts U_kr z_k from its cp.
// Each row's rhs (and cp) is its own; each pivot row keeps 1 / U_kk in
// dinv for back_substitute.  Step k = ck H + hk: the place ck is
// unrolled, the half hk (H = 2) a loop of two, so that a group's code
// holds each place once.  The pivot search takes the largest key
// bits(|a_k|^2) + 1 (the order of non-negative floats; 0: not a
// candidate) and then the lowest pos among the rows holding it, by two
// warp reductions (redux.sync), which is the first row of largest
// magnitude.
template <int H, bool PIVOT, bool ADJ>
__device__ __forceinline__ void eliminate(float2 (&a)[kR], float2& rhs, int& pos, float2& cp,
                                          float2& z_own, float2& dinv, const Group<H>& g,
                                          const Bin& s, int G, int N) {
  static_assert(!(PIVOT && ADJ), "the adjoint from the factors needs them unpivoted");
  constexpr int W = kR * H, RL = kRL<H>, HS = kHS<H>;
  const bool live = g.row < N;
#pragma unroll
  for (int ck = 0; ck < kR; ++ck) {
#pragma unroll 1
    for (int hk = 0; hk < H; ++hk) {
      const int k = ck * H + hk;
      if (k < N) {
        float2* const pb = s.pbuf + (k & 1) * G * RL;
        int win = 0;
        bool below, mine;
        if (PIVOT) {
          // the rows not yet eliminated (pos >= k) bid
          unsigned key = 0u;
          if (live && pos >= k && g.h == hk) key = __float_as_uint(cabs2(a[ck])) + 1u;
          const unsigned best = __reduce_max_sync(kFull, key);
          const unsigned p = __reduce_min_sync(
              kFull, key != 0u && key == best ? static_cast<unsigned>(pos) : 0xffffffffu);
          if (live && static_cast<unsigned>(pos) == p) {  // the warp's best row, speculatively
            float2* row = pb + g.warp * RL;
            put_right<H>(row, a, g.h, ck);
            if (g.h == 0) row[H * HS] = rhs;
          }
          if (H == 2 && g.lane == 0) s.red[(k & 1) * G + g.warp] = make_uint2(best, p);
          g.sync();
          unsigned piv = p;
          if (H == 2) {  // the best of the warps' words, in warp order
            unsigned bk = 0u;
            piv = 0xffffffffu;
            for (int q = 0; q < G; ++q) {
              const uint2 e = s.red[(k & 1) * G + q];
              if (e.x > bk || (e.x == bk && e.y < piv)) {
                bk = e.x;
                piv = e.y;
                win = q;
              }
            }
          }
          mine = static_cast<unsigned>(pos) == piv;
          if (mine)
            pos = k;
          else if (pos == k)
            pos = static_cast<int>(piv);
          below = live && pos > k;
        } else {
          mine = g.row == k;
          if (mine) {
            put_right<H>(pb, a, g.h, ck);
            if (g.h == 0) {
              pb[H * HS] = rhs;
              if (ADJ) pb[H * HS + 1] = cp;
            }
          }
          g.sync();
          below = live && g.row > k;
        }
        const float2* buf = pb + win * RL;
        const float2 pinv = crecip_rn(buf[hk * HS + ck]);
        if (mine) dinv = pinv;
        const float2 f = from_half<H>(cmul(a[ck], pinv), g.h, hk);
        float2 zk = make_float2(0.0f, 0.0f);
        if (ADJ) {
          zk = cmul(buf[H * HS + 1], pinv);
          if (mine) z_own = zk;
        }
        if (below) {
          if (!PIVOT && g.h == hk) a[ck] = f;
          const float4* b4 = reinterpret_cast<const float4*>(buf + g.h * HS);
#pragma unroll
          for (int q = 0; q < kR / 2; ++q) {
            if (2 * q + 1 < (H == 1 ? ck + 1 : ck)) continue;  // no place right of k
            const float4 p4 = b4[q];
            if (right_of<H>(2 * q, ck, hk, g.h))
              a[2 * q] = csub(a[2 * q], cmul(f, make_float2(p4.x, p4.y)));
            if (right_of<H>(2 * q + 1, ck, hk, g.h))
              a[2 * q + 1] = csub(a[2 * q + 1], cmul(f, make_float2(p4.z, p4.w)));
          }
          rhs = csub(rhs, cmul(f, buf[H * HS]));
          if (ADJ) cp = csub(cp, cmul(buf[slot<H>(g.row)], zk));
        }
      }
    }
  }
}

// y = A^{-1} rhs from the upper triangle the elimination left, column by
// column: the owner of position i writes y_i = rhs dinv to y[i], then every
// row above it subtracts its term (fdn_loop.cuh's back_substitute).  y is
// complete for the whole group on return.
template <int H>
__device__ __forceinline__ void back_substitute(const float2 (&a)[kR], float2 rhs, int pos,
                                                float2 dinv, float2* y, const Group<H>& g,
                                                int N) {
  const bool live = g.row < N;
#pragma unroll
  for (int ci = kR - 1; ci >= 0; --ci) {
#pragma unroll 1
    for (int hi = H - 1; hi >= 0; --hi) {
      const int i = ci * H + hi;
      if (i < N) {
        if (live && pos == i && g.h == 0) y[i] = cmul(rhs, dinv);
        g.sync();
        const float2 t = from_half<H>(cmul(a[ci], y[i]), g.h, hi);
        if (live && pos < i) rhs = csub(rhs, t);
      }
    }
  }
}

// L^T w = z backward from the unit-L factor that eliminate<false, ...>
// left, w (each row's own, z on entry) in place: the owner of row i writes
// its multipliers left of column i and w_i to a pivot buffer, then every
// row r < i subtracts L_ir w_i (the second half of fdn_loop.cuh's
// transpose_solve_from_factors).
template <int H>
__device__ __forceinline__ void lt_solve(const float2 (&a)[kR], float2& w, const Group<H>& g,
                                         const Bin& s, int G, int N) {
  constexpr int RL = kRL<H>, HS = kHS<H>;
  const bool live = g.row < N;
#pragma unroll
  for (int ci = kR - 1; ci >= 0; --ci) {
#pragma unroll 1
    for (int hi = H - 1; hi >= 0; --hi) {
      const int i = ci * H + hi;
      if (i > 0 && i < N) {
        float2* const buf = s.pbuf + (i & 1) * G * RL;
        if (g.row == i) {
          put_left<H>(buf, a, g.h, ci);
          if (g.h == 0) buf[H * HS] = w;
        }
        g.sync();
        if (live && g.row < i) w = csub(w, cmul(buf[slot<H>(g.row)], buf[H * HS]));
      }
    }
  }
}

}  // namespace reg
}  // namespace fdn
