// The tile frame shared by the active-acoustics kernels of aa_kernels.cu
// (K9, up to 8 microphones, unrolled over N) and aa_loop.cu (K9 past 8
// microphones, N a run-time value): the exact-phase DFT powers of a tile
// of bins, TF32 rounding and splitting, the m16n8k8 TF32 products and the
// grid that fills the card.  See aa_kernels.cu for the design.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace aa {

constexpr int kCudaError = -3;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

__host__ __device__ inline int round_up(int x, int q) { return (x + q - 1) / q * q; }

__device__ __forceinline__ void cadd_to(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

// sP and sGS keep values as they are (FP32) or rounded to TF32 (the
// tensor-core kernel's one pass): the functors below
struct KeepF32 {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};

// The powers P_t = e^{-j w_scale idx_t}, idx_t = t (m + off) mod nfft, of
// the tile of BINS bins at bin m0 into sP (rows [0, rows), stride
// 2 BINS + 4), tap-major: row t holds Re P_t of the tile's bins in
// columns [0, BINS) and Im P_t in [BINS, 2 BINS); rows t >= order are
// zero.  Of a block of THREADS, thread (b, q) makes t = q, q + THREADS /
// BINS, ... of bin b, stepped exactly in integers; sP keeps
// store(value).
template <int BINS, int THREADS, class Store>
__device__ __forceinline__ void tile_powers(float* __restrict__ sP, int rows, int order, int m0,
                                            int nfft, int off_mod, float w_scale, Store store) {
  constexpr int kSplit = THREADS / BINS, kStride = 2 * BINS + 4;
  const int b = threadIdx.x % BINS, q = threadIdx.x / BINS;
  const int gm = static_cast<int>((static_cast<long long>(m0 + b) % nfft + off_mod) % nfft);
  int step = 0, idx = 0;
  for (int s = 0; s < kSplit; ++s) {
    step += gm;
    if (step >= nfft) step -= nfft;
    if (s < q) {
      idx += gm;
      if (idx >= nfft) idx -= nfft;
    }
  }
  for (int tt = q; tt < rows; tt += kSplit) {
    float sn = 0.0f, cs = 0.0f;
    if (tt < order) {
      sincosf(w_scale * static_cast<float>(idx), &sn, &cs);
      idx += step;
      if (idx >= nfft) idx -= nfft;
    }
    sP[tt * kStride + b] = store(cs);
    sP[tt * kStride + BINS + b] = store(-sn);
  }
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
struct KeepTf32 {
  __device__ __forceinline__ float operator()(float x) const { return stored<PASSES>(x); }
};

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

}  // namespace aa
