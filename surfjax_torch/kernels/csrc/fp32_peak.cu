// FP32 roofline probe for Hopper (sm_90a).
//
// Replaces tools/vpu_peak.py::run (the Pallas TPU kernels _bulb_mix_kernel,
// _cheb_mix_kernel and _fma_dep_kernel): synthetic kernels that run K
// substeps of the power-8 Mandelbulb orbit update on seeds that never
// escape, so every thread of a warp runs every iteration (no divergence),
// and dependent fused-multiply-add chains as the method's sanity check.
// The two mixes run bulb_substep of frame_fused.cuh, the very function the
// render kernels' bulb_de runs, behind the same `m <= bailout2` test and
// break; their time per iteration-lane is what this card sustains on the
// arithmetic the fused kernel spends most of its time in.
//
// What bounds it on this card: FP32 ALU throughput and the latency of the IEEE
// division and square root sequences (three of each per substep); the
// kernel reads 12 bytes and writes 4 per lane once, whatever K is.
//
// What the design does about it: one thread per lane, seed and orbit in
// registers, K a runtime argument (the compiler cannot fold the loop) and
// the output a function of the last iterate (it cannot drop it); `unroll`
// substeps per loop trip as a template parameter (1, 4, 8), the loop shape
// bulb_de's callers give the compiler. The dependent chain keeps `unroll`
// independent chains per thread instead (1, 4, 8 lanes of the input per
// thread), which is what fills the FMA pipe when one chain's latency does
// not. fp_fma_dep is the TPU tool's chain: its multiplier and addend differ
// from lane to lane, so each FMA reads three registers of its own.
//
// This file is compiled twice: as it stands with the library's flags
// (-fmad=false: every multiply and add rounds on its own, as in the render
// kernels), giving fp_bulb_mix, fp_cheb_mix and fp_fma_dep; and through
// fp32_peak_fma.cu with -fmad=true (the compiler may contract a*b+c),
// giving fp_bulb_mix_fma and fp_cheb_mix_fma. The contracted pair exists
// only here: it prices the contraction the render kernels forgo.
//
// C interface (bound with ctypes, no PyTorch headers); each returns the
// cudaError_t of its launch, or cudaErrorInvalidValue for an `unroll`
// other than 1, 4 or 8 or an `iters` that is not a multiple of it:
//   int fp_bulb_mix[_fma](px, py, pz, out, n, iters, unroll, device, stream)
//   int fp_cheb_mix[_fma](px, py, pz, out, n, iters, unroll, device, stream)
//   int fp_fma_dep(a, out, n, iters, chains, device, stream)

#include "frame_fused.cuh"

#ifdef FP32_PEAK_CONTRACTED
#define FP_NAME(name) name##_fma
#else
#define FP_NAME(name) name
#endif

#define FP_BLOCK 256

namespace {

// K substeps of the orbit update per lane; out = (wx + wy) + (wz + dz) + m.
template <int CHEB, int UNROLL>
__global__ void __launch_bounds__(FP_BLOCK)
FP_NAME(fp_mix_kernel)(const float* __restrict__ px_,
                       const float* __restrict__ py_,
                       const float* __restrict__ pz_, float* __restrict__ out,
                       int n, int iters) {
  const int i = blockIdx.x * FP_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float px = px_[i], py = py_[i], pz = pz_[i];
  const float bailout2 = 64.0f;
  float wx = px, wy = py, wz = pz, dz = 1.0f;
  float m = (px * px + py * py) + pz * pz;
  const int trips = iters / UNROLL;
  bool live = true;
  for (int t = 0; t < trips && live; ++t) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!(m <= bailout2)) { live = false; break; }
      bulb_substep(CHEB, px, py, pz, wx, wy, wz, dz, m);
    }
  }
  out[i] = (wx + wy) + (wz + dz) + m;
}

template <int CHEB>
int launch_mix(const float* px, const float* py, const float* pz, float* out,
               int n, int iters, int unroll, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (iters < 0 || iters % unroll) return (int)cudaErrorInvalidValue;
  dim3 grid((n + FP_BLOCK - 1) / FP_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  switch (unroll) {
    case 1:
      FP_NAME(fp_mix_kernel)<CHEB, 1><<<grid, FP_BLOCK, 0, s>>>(
          px, py, pz, out, n, iters);
      break;
    case 4:
      FP_NAME(fp_mix_kernel)<CHEB, 4><<<grid, FP_BLOCK, 0, s>>>(
          px, py, pz, out, n, iters);
      break;
    case 8:
      FP_NAME(fp_mix_kernel)<CHEB, 8><<<grid, FP_BLOCK, 0, s>>>(
          px, py, pz, out, n, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#ifndef FP32_PEAK_CONTRACTED
// K dependent a = fma(a, b, c) per lane; a thread carries CHAINS lanes
// (i, i + n/CHAINS, ...) as independent chains, with b = 0.999 a0 and
// c = 1e-6 a0 of the lane's own seed a0 (the TPU tool's chain).
template <int CHAINS>
__global__ void __launch_bounds__(FP_BLOCK)
fp_fma_kernel(const float* __restrict__ a_, float* __restrict__ out,
              int per_chain, int iters) {
  const int i = blockIdx.x * FP_BLOCK + threadIdx.x;
  if (i >= per_chain) return;
  float a[CHAINS], b[CHAINS], c[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    a[k] = a_[i + k * per_chain];
    b[k] = a[k] * F(0.999);
    c[k] = a[k] * F(1e-6);
  }
  // 16 steps per trip: the loop's own add, compare and branch are then at
  // most 3 of the 19 operations one chain runs per trip
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) a[k] = __fmaf_rn(a[k], b[k], c[k]);
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) out[i + k * per_chain] = a[k];
}

int launch_fma(const float* a, float* out, int n, int iters, int chains,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (iters < 0 || chains <= 0 || n % chains)
    return (int)cudaErrorInvalidValue;
  const int per_chain = n / chains;
  dim3 grid((per_chain + FP_BLOCK - 1) / FP_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  switch (chains) {
    case 1:
      fp_fma_kernel<1><<<grid, FP_BLOCK, 0, s>>>(a, out, per_chain, iters);
      break;
    case 4:
      fp_fma_kernel<4><<<grid, FP_BLOCK, 0, s>>>(a, out, per_chain, iters);
      break;
    case 8:
      fp_fma_kernel<8><<<grid, FP_BLOCK, 0, s>>>(a, out, per_chain, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif

}  // namespace

extern "C" int FP_NAME(fp_bulb_mix)(const float* px, const float* py,
                                    const float* pz, float* out, int n,
                                    int iters, int unroll, int device,
                                    void* stream) {
  return launch_mix<0>(px, py, pz, out, n, iters, unroll, device, stream);
}

extern "C" int FP_NAME(fp_cheb_mix)(const float* px, const float* py,
                                    const float* pz, float* out, int n,
                                    int iters, int unroll, int device,
                                    void* stream) {
  return launch_mix<1>(px, py, pz, out, n, iters, unroll, device, stream);
}

#ifndef FP32_PEAK_CONTRACTED
extern "C" int fp_fma_dep(const float* a, float* out, int n, int iters,
                          int chains, int device, void* stream) {
  return launch_fma(a, out, n, iters, chains, device, stream);
}
#endif
