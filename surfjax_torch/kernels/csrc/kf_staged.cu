// The staged fused-frame kernel for scenes without a crowd (kf_staged.cuh
// holds it and its design note): the production kernel and its profiling
// instantiation (tools/breakdown.py, section `kf_phases`).
//
// C interface (bound with ctypes, no PyTorch headers):
//   int ks_frame_fused(KFTables tables, KFSettings settings, KSLayout layout,
//                      unsigned long long* prof, int* work, int device,
//                      void* stream)
//       -> cudaError_t of the launch; work: one int the caller zeroed, the
//          tile counter; prof: null (the production kernel), or the
//          counters of the profiling instantiation, zeroed by the caller:
//          tiles x KS_WARPS x KP_PHASES x 3 (cycles, loop trips,
//          lane-evaluations)
//   int ks_occupancy(KSLayout layout, int* blocks_per_sm)
//       -> cudaError_t; the production kernel's resident blocks per SM

#include "kf_staged.cuh"

extern "C" int ks_frame_fused(KFTables tables, KFSettings settings,
                              KSLayout layout, unsigned long long* prof,
                              int* work, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (settings.F <= 0 || settings.H <= 0 || settings.W <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return prof ? ks_launch<true>(tables, settings, layout, prof, work, st)
              : ks_launch<false>(tables, settings, layout, nullptr, work, st);
}

extern "C" int ks_occupancy(KSLayout layout, int* blocks_per_sm) {
  if (layout.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kf_staged_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, layout.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kf_staged_kernel<false>, KS_THREADS, layout.bytes);
}
