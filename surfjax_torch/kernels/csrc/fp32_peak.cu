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
// What bounds it on this card: the SM's issue slots, one warp instruction
// per scheduler and cycle. Per substep of one orbit the loop issues about
// 97 (cheb) or 116 (std) instructions when no IEEE division or square root
// leaves its fast path: the hand count's operations as FMUL and FADD, the
// two square roots and two reciprocals of bulb_substep as MUFU and
// refinement, each behind a range test that branches round the CALL of its
// slow path (BSSY, BRA, BSYNC: 4 CALLs per substep inside the loop, taken
// on no seed of the probe), the escape test. MUFU (16 lanes per SM and
// cycle) needs 8 SM cycles per warp-substep, the issue about 24; the
// kernel reads 12 bytes and writes 4 per lane once, whatever K is.
//
// What the design does about it (PERF.md §6, PR 18: measured inside by the
// profiling instantiation): one orbit per thread, the loop of the first
// port's kernel, seed and orbit in registers, K a runtime argument (the
// compiler cannot fold the loop) and the output a function of the last
// iterate (it cannot drop it); `unroll` substeps per loop trip as a
// template parameter (1, 4, 8), the loop shape bulb_de's callers give the
// compiler. At 31-32 registers an SM holds 2,048 threads, and the first
// port's kernel already issued at 94-95% of the card's rate (-fmad=false),
// so the redesign only takes what the measurement showed lost: the tail of
// the last blocks. 2,097,152 lanes make 8,192 blocks of 256 threads, so 8
// SMs run a 63rd block while the others idle (SMs busy 98.5% of the span);
// 32,768 blocks of 64 (FP_MIX_BLOCK) leave a quarter of that tail (99.4%).
// `__launch_bounds__(FP_MIX_BLOCK, 32)` holds the profiling instantiation
// to the kernel's 32 registers. A lane past n starts escaped: it runs no
// substep and stores nothing, but reaches the warp's profile record.
// The dependent chain keeps `unroll` independent chains per thread instead
// (1, 4, 8 lanes of the input per thread), which is what fills the FMA pipe
// when one chain's latency does not. fp_fma_dep is the TPU tool's chain:
// its multiplier and addend differ from lane to lane, so each FMA reads
// three registers of its own.
//
// PROF (a template parameter: the kernel has no probes) makes lane 0 of
// each warp write, after the warp's last lane is done, the clock64 delta
// of the warp's life, its %globaltimer at the start and at the end, and
// %smid (FP_PROF_WORDS words a warp).
//
// This file is compiled twice: as it stands with the library's flags
// (-fmad=false: every multiply and add rounds on its own, as in the render
// kernels), giving fp_mix (the entries fp_bulb_mix and fp_cheb_mix of
// tools/fp32_peak.py) and fp_fma_dep; and through fp32_peak_fma.cu with
// -fmad=true (the compiler may contract a*b+c), giving fp_mix_fma
// (fp_bulb_mix_fma, fp_cheb_mix_fma). The contracted pair exists only
// here: it prices the contraction the render kernels forgo. The two units
// name their kernels and entries apart (FP_NAME), so the link keeps both.
//
// C interface (bound with ctypes, no PyTorch headers); each returns the
// cudaError_t of its launch or query, or cudaErrorInvalidValue for an
// `unroll` other than 1, 4 or 8 or an `iters` that is not a multiple of it:
//   int fp_mix[_fma](cheb, px, py, pz, out, prof, n, iters, unroll, device,
//                    stream)
//   int fp_mix_occupancy[_fma](cheb, unroll, prof, device,
//                              int* blocks_per_sm)
//   int fp_fma_dep(a, out, n, iters, chains, device, stream)

#include "frame_fused.cuh"

#ifdef FP32_PEAK_CONTRACTED
#define FP_NAME(name) name##_fma
#else
#define FP_NAME(name) name
#endif

// threads per block of fma_dep
#define FP_BLOCK 256
// threads per block of the mixes: one block per 64 lanes
#define FP_MIX_BLOCK 64
// a warp's profile record (PROF): lane 0's clock64 delta over the kernel,
// its %globaltimer at the start and at the end, the SM it ran on (%smid)
#define FP_PROF_WORDS 4

namespace {

__device__ __forceinline__ unsigned long long fp_globaltimer() {
#ifdef __CUDA_ARCH__
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return (unsigned long long)clock64();   // the host stand-in's clock, ns
#endif
}

__device__ __forceinline__ unsigned long long fp_smid() {
#ifdef __CUDA_ARCH__
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
#else
  return 0ull;
#endif
}

template <bool PROF>
struct FpClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stop(unsigned long long*) {}
};
template <>
struct FpClock<true> {
  long long c0;
  unsigned long long g0;
  __device__ __forceinline__ void start() {
    c0 = clock64();
    g0 = fp_globaltimer();
  }
  // after the warp's last lane is done: lane 0 writes the warp's record
  __device__ __forceinline__ void stop(unsigned long long* prof) {
    __syncwarp();
    const long long c1 = clock64();
    const unsigned long long g1 = fp_globaltimer();
    if ((threadIdx.x & 31) == 0) {
      const size_t warp =
          (size_t)blockIdx.x * (FP_MIX_BLOCK / 32) + (threadIdx.x >> 5);
      unsigned long long* rec = prof + warp * FP_PROF_WORDS;
      rec[0] = (unsigned long long)(c1 - c0);
      rec[1] = g0;
      rec[2] = g1;
      rec[3] = fp_smid();
    }
  }
};

// K substeps of the orbit update per lane, or fewer where the orbit
// escapes; out = (wx + wy) + (wz + dz) + m.
template <int CHEB, int UNROLL, bool PROF>
__global__ void __launch_bounds__(FP_MIX_BLOCK, 32)
FP_NAME(fp_mix_kernel)(const float* __restrict__ px_,
                       const float* __restrict__ py_,
                       const float* __restrict__ pz_, float* __restrict__ out,
                       int n, int iters, unsigned long long* prof) {
  FpClock<PROF> clock;
  clock.start();
  const int i = blockIdx.x * FP_MIX_BLOCK + threadIdx.x;
  const bool act = i < n;
  const float px = act ? px_[i] : 0.0f, py = act ? py_[i] : 0.0f,
              pz = act ? pz_[i] : 0.0f;
  const float bailout2 = 64.0f;
  float wx = px, wy = py, wz = pz, dz = 1.0f;
  float m = act ? (px * px + py * py) + pz * pz : __int_as_float(0x7f800000);
  const int trips = iters / UNROLL;
  bool live = true;
  for (int t = 0; t < trips && live; ++t) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!(m <= bailout2)) { live = false; break; }
      bulb_substep(CHEB, px, py, pz, wx, wy, wz, dz, m);
    }
  }
  if (act) out[i] = (wx + wy) + (wz + dz) + m;
  clock.stop(prof);
}

typedef void (*MixKernel)(const float*, const float*, const float*, float*,
                          int, int, unsigned long long*);

template <int CHEB, int UNROLL>
MixKernel mix_of(bool prof) {
  return prof ? FP_NAME(fp_mix_kernel)<CHEB, UNROLL, true>
              : FP_NAME(fp_mix_kernel)<CHEB, UNROLL, false>;
}

// -> the instantiation, or null for an unroll other than 1, 4, 8
MixKernel mix_of(int cheb, int unroll, bool prof) {
  switch (unroll) {
    case 1: return cheb ? mix_of<1, 1>(prof) : mix_of<0, 1>(prof);
    case 4: return cheb ? mix_of<1, 4>(prof) : mix_of<0, 4>(prof);
    case 8: return cheb ? mix_of<1, 8>(prof) : mix_of<0, 8>(prof);
    default: return nullptr;
  }
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

// cheb: 1 for the restructured form (fp_cheb_mix), 0 for the expanded one
// (fp_bulb_mix); prof: null, or one record of FP_PROF_WORDS words per warp
// of the grid (ceil(n / FP_MIX_BLOCK) blocks of FP_MIX_BLOCK threads)
extern "C" int FP_NAME(fp_mix)(int cheb, const float* px, const float* py,
                               const float* pz, float* out,
                               unsigned long long* prof, int n, int iters,
                               int unroll, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MixKernel k = mix_of(cheb, unroll, prof != nullptr);
  if (!k || iters < 0 || iters % unroll) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  k<<<(n + FP_MIX_BLOCK - 1) / FP_MIX_BLOCK, FP_MIX_BLOCK, 0,
      (cudaStream_t)stream>>>(px, py, pz, out, n, iters, prof);
  return (int)cudaGetLastError();
}

// -> in blocks_per_sm how many blocks of the instantiation an SM holds
// (prof: 1 for the profiling instantiation)
extern "C" int FP_NAME(fp_mix_occupancy)(int cheb, int unroll, int prof,
                                         int device, int* blocks_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MixKernel k = mix_of(cheb, unroll, prof != 0);
  if (!k) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, FP_MIX_BLOCK, 0);
}

#ifndef FP32_PEAK_CONTRACTED
extern "C" int fp_fma_dep(const float* a, float* out, int n, int iters,
                          int chains, int device, void* stream) {
  return launch_fma(a, out, n, iters, chains, device, stream);
}
#endif
