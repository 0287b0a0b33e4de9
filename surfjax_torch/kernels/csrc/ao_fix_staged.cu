// ao_fix for scenes without a crowd (with a crowd, ao_fix_crowd.cu), on
// the per-ray stages of kf_staged.cuh.
//
// Replaces, for scenes with no crowd, surfjax/kernels/render_tile.py::
// ao_fix_kernel (body _ao_fix_body), as split_path.cu's
// sp_ao_fix_kernel<false> did before it: AO again at the pre-offset
// receivers p_off (in[0..2]) with the normals n (in[3..5]) on the lanes a
// mesh won (need = in[6] > 0.5), ao_in (in[7]) elsewhere; the arithmetic
// of render_tile.ao_fix_reference, bit for bit (ao_receiver runs
// ao_core<false>'s order).
//
// What bounds it: on c4 `ao` a third of the lanes need AO, 20 evaluations
// of the floor each; the other lanes load 8 bytes and write 4. What held
// the kernel it replaces back (PERF.md): the by-value parameters
// copied into every thread's stack frame (with need 0 on every lane it took
// 0.155 ms, 20x its bytes), and the floor decoded anew at every tap
// through the tape walker. The design, K1's (split_staged.cu) on the lanes
// that need AO:
//   * __grid_constant__ parameters, which the cores read in place;
//   * SplitScene<false> with AO's floor decoded once per lane (hoist) and
//     single-leaf evaluation; tables read through the parameters, every
//     bound computed where it is used; one block per 128 rays, no shared
//     memory, no barrier;
//   * a warp none of whose lanes needs AO skips it;
//   * __launch_bounds__(128, 8): 64 registers, 8 blocks per SM. The taps
//     are a chain of dependent operations, and more warps per SM hide it
//     (90 registers and 5 blocks per SM without the bound: 24% slower).
// Measured and left out (PERF.md): persistent blocks, the scene staged in
// shared memory (one block per row or persistent), the bound (128, 6).
//
// PROF (a template parameter: the production code has no probes) makes
// each warp add, per phase, lane 0's clock64 deltas, the loop trips it
// issued and __popc(__activemask()) per trip (the lanes that evaluate an
// SDF) into its record of a scratch buffer (KP_PHASES x 3 counters, the
// phase names of kf_staged.cuh).
//
// C interface (bound with ctypes, no PyTorch headers):
//   int sp_staged_ao_fix(KFTables, KFSettings, SplitRays,
//                        unsigned long long* prof, int device, void* stream)
// -> cudaError_t of the launch (a scene with a crowd is refused); prof:
// null, or the profile's counters, zeroed by the caller: rows x 4 x
// KP_PHASES x 3.

#include "split_scene.cuh"

// ao_fix on ray i (act false: a lane past the last ray, which takes part
// in the warp's probes only).
template <bool PROF, class Blk>
__device__ __forceinline__ void ao_fix_ray(const Blk& B, const KFSettings& S,
                                           const SplitRays& R, int i,
                                           bool act, Prof<PROF>& P) {
  float ao = 1.0f;
  bool need = false;
  V3 q0{0.0f, 0.0f, 0.0f}, n{0.0f, 0.0f, 1.0f};
  if (act) {
    ao = R.in[7][i];
    need = R.in[6][i] > 0.5f;
    if (need) {
      q0 = V3{R.in[0][i], R.in[1][i], R.in[2][i]};
      n = V3{R.in[3][i], R.in[4][i], R.in[5][i]};
    }
  }
  P.mark(PH_RAY);
  if (__any_sync(KF_FULL, need)) {
    const float a = ao_receiver(B, S, need, q0, n, P);
    if (need) ao = a;
  }
  P.mark(PH_AO_SUM);
  if (act) R.out[0][i] = ao;
  P.mark(PH_WRITE);
}

template <bool PROF>
__global__ void __launch_bounds__(KS_THREADS, 8)
sp_staged_ao_fix_kernel(const __grid_constant__ KFTables G,
                        const __grid_constant__ KFSettings S,
                        const __grid_constant__ SplitRays R,
                        unsigned long long* prof) {
  SplitScene<false> B{G, G, nullptr, S.exit_margin};
  B.hoist(S);
  Prof<PROF> P;
  P.begin(prof, blockIdx.x);
  const int i = blockIdx.x * KS_THREADS + threadIdx.x;
  ao_fix_ray(B, S, R, i, i < R.n, P);
}

extern "C" int sp_staged_ao_fix(KFTables T, KFSettings S, SplitRays R,
                                unsigned long long* prof, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S.n_crowd > 0) return (int)cudaErrorInvalidValue;
  if (R.n <= 0) return 0;
  const unsigned grid = (R.n + KS_THREADS - 1) / KS_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (prof)
    sp_staged_ao_fix_kernel<true><<<grid, KS_THREADS, 0, st>>>(T, S, R, prof);
  else
    sp_staged_ao_fix_kernel<false><<<grid, KS_THREADS, 0, st>>>(T, S, R,
                                                                nullptr);
  return (int)cudaGetLastError();
}
