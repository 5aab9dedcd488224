// Device helpers shared by the SOS-cascade kernels (sos_kernels.cu: K4f,
// K4b, K5) and the phase-2 micro-benchmark kernels (phase2_micro.cu: K10).
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
