// Hand-written Hopper (sm_90a) kernel K7 of the eigenvalue path, with a
// plain C interface that flamo_tpu_torch/ops/eig_kernels.py loads through
// ctypes.  The entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError(), or kBadN when asked for another
// degree than the FDN_N this library was built for.
//
// dk_roots_kernel (K7) <- flamo_tpu/ops/pallas_eig.py _dk_kernel, pallas_call
// at :118 (pallas_dk_roots_rows; pallas_dk_roots :129 folds a complex
// batch onto it).
//
// It runs the Durand-Kerner iteration of flamo_tpu_torch.functional.
// _dk_iterate_rows, the plain version, on monic polynomials of degree N:
// the coefficient rows cr, ci (N, B) in, the root rows zr, zi (N, B) out,
// polynomial b in column b.  A GROUP OF LANES OWNS ONE POLYNOMIAL, ONE LANE
// A ROOT: groups of N rounded up to 1, 2, 4 or 8 lanes, kThreads = 64
// threads a block.  Lane n keeps its root z_n and the N coefficients in
// registers for all the iterations; each iteration it computes the monic
// Horner of its own z_n, fetches every z_j of its group by __shfl_sync and
// takes prod_{j != n} (z_n - z_j) in ascending j.  Lanes n >= N of a
// padded group and the groups past the last polynomial run the same code
// on harmless operands (zero coefficients past B), take part in every
// shuffle (full-warp mask, no early return) and write nothing.
//
// The arithmetic is the plain version's, operation for operation: the
// start circle 0.9 (1 + max_k |c_k|) at angles 2 pi (n + 0.354) / N (cos
// and sin in double, rounded once to float), the monic Horner, the
// product prod_{j != n} (z_n - z_j) in ascending j, the simultaneous
// (Jacobi) update z_n -= p(z_n) conj(d) / |d|^2 and the freeze of a slot
// where |d|^2 = 0.  The library is built with -fmad=false, so no multiply
// and add contract into an FMA that PyTorch's separate elementwise
// kernels would round twice: the kernel and its plain version give the
// same bits.  (FMA contraction changes the last bits of each update, and
// Durand-Kerner amplifies them on clustered roots.)
//
// What bounds it on an H100: at the active-acoustics step's B = 1601
// polynomials of degree 4 the bytes (51 KB) and operations (~96 x 4 x 66
// FLOP per polynomial) take well under a microsecond; the 96 dependent
// iterations bound it.  One thread per polynomial filled only 13 blocks
// of 128 threads (13 of the 132 SMs, one warp a scheduler issuing all N
// roots' ~300 instructions an iteration).  One lane a root cuts a lane's
// iteration to one root's Horner, N - 1 products and the guarded quotient
// (plus 2 N shuffles), and the 6404 lanes fill 101 blocks of 64, so the
// iteration's dependent chain, not the instruction throughput, sets the time.

#include <cuda_runtime.h>

#include <cmath>

namespace eig {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr int kThreads = 64;
constexpr int kMaxN = 8;
constexpr int kBadN = -1;
constexpr int kBadSize = -2;

// lanes a polynomial: N rounded up to a power of two
__host__ __device__ constexpr int group_lanes(int N) {
  return N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : 8;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    dk_roots_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
                    float* __restrict__ zr, float* __restrict__ zi, int B, int iters) {
  constexpr int G = group_lanes(N);
  const int n = threadIdx.x % G;  // this lane's root slot
  const int b = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool poly = b < B;
  float c_r[N], c_i[N];
  float R = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    c_r[k] = poly ? __ldg(cr + static_cast<size_t>(k) * B + b) : 0.0f;
    c_i[k] = poly ? __ldg(ci + static_cast<size_t>(k) * B + b) : 0.0f;
    R = fmaxf(R, sqrtf(c_r[k] * c_r[k] + c_i[k] * c_i[k]));
  }
  R = 0.9f * (1.0f + R);
  // the start angle of slot n, each slot's as a compile-time constant
  float cs = 1.0f, sn = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double ang = kTwoPi * (j + 0.354) / N;
    if (j == n) {
      cs = static_cast<float>(cos(ang));
      sn = static_cast<float>(sin(ang));
    }
  }
  float z_r = R * cs;
  float z_i = R * sn;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // monic Horner p(z_n)
    float ar = 1.0f, ai = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float tr = ar * z_r - ai * z_i;
      const float ti = ar * z_i + ai * z_r;
      ar = tr + c_r[k];
      ai = ti + c_i[k];
    }
    // prod_{j != n} (z_n - z_j), z_j from lane j of the group
    float dr = 1.0f, di = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float wr = __shfl_sync(0xffffffffu, z_r, j, G);
      const float wi = __shfl_sync(0xffffffffu, z_i, j, G);
      const float er = z_r - wr;
      const float ei = z_i - wi;
      const float tr = dr * er - di * ei;
      const float ti = dr * ei + di * er;
      dr = j == n ? dr : tr;
      di = j == n ? di : ti;
    }
    const float d2 = dr * dr + di * di;
    const bool ok = d2 > 0.0f;
    const float inv = 1.0f / (ok ? d2 : 1.0f);
    const float sr = (ar * dr + ai * di) * inv;
    const float si = (ai * dr - ar * di) * inv;
    z_r = z_r - (ok ? sr : 0.0f);
    z_i = z_i - (ok ? si : 0.0f);
  }
  if (poly && n < N) {
    zr[static_cast<size_t>(n) * B + b] = z_r;
    zi[static_cast<size_t>(n) * B + b] = z_i;
  }
}

}  // namespace eig

// One build instantiates the kernel for one degree, FDN_N, given on the
// nvcc command line (-DFDN_N=4), like the other kernel libraries.
#ifndef FDN_N
#error "compile with -DFDN_N=<degree>"
#endif
static_assert(FDN_N >= 1 && FDN_N <= eig::kMaxN, "FDN_N out of range");

extern "C" {

int eig_threads_per_block() { return eig::kThreads; }

int eig_channels() { return FDN_N; }

const char* eig_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dk_roots_launch(int N, const void* cr, const void* ci, void* zr, void* zi, int B, int iters,
                    void* stream) {
  if (N != FDN_N) return eig::kBadN;
  if (B < 1 || iters < 0) return eig::kBadSize;
  constexpr int kPolys = eig::kThreads / eig::group_lanes(FDN_N);  // polynomials a block
  const unsigned grid = static_cast<unsigned>((B + kPolys - 1) / kPolys);
  eig::dk_roots_kernel<FDN_N><<<grid, eig::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cr), static_cast<const float*>(ci), static_cast<float*>(zr),
      static_cast<float*>(zi), B, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
