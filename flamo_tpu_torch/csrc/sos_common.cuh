// Device helpers shared by the SOS-cascade kernels (sos_cascade.cu: K4f,
// K4b; sos_kernels.cu: K5) and the phase-2 micro-benchmark kernels (phase2_micro.cu: K10).
//
// The phasor is made per bin from the bin index, in float32 as the TPU
// kernels' _bin_phasor (flamo_tpu/ops/pallas_solve.py):
// w = (2 pi / nfft) (m + off), with the accurate sincosf (near m = nfft/2
// the angle is close to pi, where the fast intrinsics lose digits).  Sums
// over bins are reduced one warp shuffle tree per value into a shared-memory
// row per warp, then one row per block.
#pragma once

#include "fdn_ge.cuh"

namespace sos {

using fdn::cabs2;
using fdn::cmul;
using fdn::kThreads;

constexpr int kMaxP = 8;
constexpr int kMaxK = 64;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float2 bin_phasor(int m, float w_scale, float off) {
  const float w = w_scale * (static_cast<float>(m) + off);
  float s, c;
  sincosf(w, &s, &c);
  return make_float2(c, -s);
}

// Keeping a cascade's running products in range: after each section both
// are scaled by 2^-e, e the exponent frexpf gives the larger part m of
// |pa|'s parts (m = f 2^e, f in [0.5, 1)), so that |pa| lands in [0.5, 1.5)
// however many sections the cascade has (a 30-section 1/3-octave GEQ's
// unscaled products underflow float32 near DC).  Scaling by a power of two
// is exact in float32's normal range, and so is every product and sum after
// it, so pb / pa keeps its bits wherever the unscaled products stay normal
// (the plain versions scale the same way: functional.cascade_prods_scaled).
//
// pow2_scale forms ldexpf(1, -e) from m's bits (its biased exponent E = e +
// 126), e clamped to [-126, 126] so that the scale is a normal float: a
// handful of integer operations on the cascade's dependent chain where the
// library calls took tens.  A zero (or subnormal) m gives 2^126; pa = 0
// stays 0, and the guard then reads only that.  The cascades multiply
// each section's product by the scale of its incoming pa (normalising pa
// before the section is, exactly, scaling the product after it), so that
// the scale is formed beside the section's multiply and not after it, and
// rescale_pair normalises the last product: the pair that reaches the
// ratio is the plain versions' (in exact arithmetic; pb differs where pa
// is 0).
__device__ __forceinline__ float pow2_scale(float2 pa) {
  const int E = min(__float_as_int(fmaxf(fabsf(pa.x), fabsf(pa.y))) >> 23, 252);
  return __int_as_float((253 - E) << 23);
}

__device__ __forceinline__ float2 scaled(float2 v, float s) {
  return make_float2(v.x * s, v.y * s);
}

__device__ __forceinline__ void rescale_pair(float2& pb, float2& pa) {
  const float s = pow2_scale(pa);
  pb = scaled(pb, s);
  pa = scaled(pa, s);
}

// Sum one per-thread value over the warp; lane 0 parks it in the warp's
// shared-memory row of nv values, or adds it to the slot with add.  Every
// thread of the block calls it.
__device__ __forceinline__ void put(float* red, int nv, int idx, float v, bool add = false) {
  v = fdn::warp_sum(v);
  if ((threadIdx.x & 31) == 0) {
    float& slot = red[(threadIdx.x >> 5) * nv + idx];
    slot = add ? slot + v : v;
  }
}

// After all put calls: add the warps' rows into this block's row.
__device__ __forceinline__ void store_row(const float* red, int nv, float* __restrict__ row) {
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * nv + v];
    row[v] = s;
  }
}

}  // namespace sos
