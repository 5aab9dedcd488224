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
// polynomial b in column b.  ONE THREAD OWNS ONE POLYNOMIAL: its N
// coefficients and N root slots stay in registers (4 N floats, plus N new
// slots per update) for all the iterations, with the loops over N
// unrolled at the compile-time degree, and the rows are read and written
// once.  Thread b reads column b of each row, so a warp reads 128
// contiguous bytes per row.
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
// polynomials of degree 4 it is 13 blocks of 128 threads for 132 SMs, so
// latency and the launch bound it, not bytes (51 KB) or operations
// (~96 x 4 x 66 FLOP per polynomial).  Nothing here tries to fill the
// card; a batch of many steps' polynomials would.

#include <cuda_runtime.h>

#include <cmath>

namespace eig {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr int kThreads = 128;
constexpr int kMaxN = 8;
constexpr int kBadN = -1;
constexpr int kBadSize = -2;

template <int N>
__global__ void __launch_bounds__(kThreads)
    dk_roots_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
                    float* __restrict__ zr, float* __restrict__ zi, int B, int iters) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float c_r[N], c_i[N];
  float R = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    c_r[k] = __ldg(cr + static_cast<size_t>(k) * B + b);
    c_i[k] = __ldg(ci + static_cast<size_t>(k) * B + b);
    R = fmaxf(R, sqrtf(c_r[k] * c_r[k] + c_i[k] * c_i[k]));
  }
  R = 0.9f * (1.0f + R);
  float z_r[N], z_i[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const double ang = kTwoPi * (n + 0.354) / N;
    z_r[n] = R * static_cast<float>(cos(ang));
    z_i[n] = R * static_cast<float>(sin(ang));
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float n_r[N], n_i[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      // monic Horner p(z_n)
      float ar = 1.0f, ai = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float tr = ar * z_r[n] - ai * z_i[n];
        const float ti = ar * z_i[n] + ai * z_r[n];
        ar = tr + c_r[k];
        ai = ti + c_i[k];
      }
      // prod_{j != n} (z_n - z_j)
      float dr = 1.0f, di = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == n) continue;
        const float er = z_r[n] - z_r[j];
        const float ei = z_i[n] - z_i[j];
        const float tr = dr * er - di * ei;
        const float ti = dr * ei + di * er;
        dr = tr;
        di = ti;
      }
      const float d2 = dr * dr + di * di;
      const bool ok = d2 > 0.0f;
      const float inv = 1.0f / (ok ? d2 : 1.0f);
      const float sr = (ar * dr + ai * di) * inv;
      const float si = (ai * dr - ar * di) * inv;
      n_r[n] = z_r[n] - (ok ? sr : 0.0f);
      n_i[n] = z_i[n] - (ok ? si : 0.0f);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      z_r[n] = n_r[n];
      z_i[n] = n_i[n];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    zr[static_cast<size_t>(n) * B + b] = z_r[n];
    zi[static_cast<size_t>(n) * B + b] = z_i[n];
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
  const unsigned grid = static_cast<unsigned>((B + eig::kThreads - 1) / eig::kThreads);
  eig::dk_roots_kernel<FDN_N><<<grid, eig::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cr), static_cast<const float*>(ci), static_cast<float*>(zr),
      static_cast<float*>(zi), B, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
