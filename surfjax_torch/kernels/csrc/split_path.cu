// Split-path kernels for Hopper (sm_90a): K1, K2 and ao_fix for scenes
// with a crowd (without one, the staged kernels of split_staged.cu and
// ao_fix_staged.cu).
//
// Replace the three Pallas TPU kernels that surfjax's split pipeline runs
// for scenes the fused kernel does not take (mesh scenes):
//   * sp_render_tile_kernel <- surfjax/kernels/render_tile.py
//     ::render_tile_kernel (K1, body _k1_body): primary trace of the
//     non-mesh objects, the face-forwarded normal, and AO at the pre-merge
//     hit, for rays given from outside, with an optional per-ray primed
//     march start (in[6], null when the frame is not primed), and unres
//     (out[7]);
//   * sp_trace_rays_kernel <- ::trace_rays_kernel (K2, body _k2_body): the
//     hard or soft visibility of one light through the non-mesh objects,
//     and unres (out[1]);
//   * sp_ao_fix_kernel <- ::ao_fix_kernel (body _ao_fix_body): AO again at
//     pre-offset receivers on the lanes a mesh won (need > 0.5), ao_in
//     elsewhere.
// Each is the per-lane program of the PyTorch plain version in
// surfjax_torch/kernels/render_tile.py (render_tile_reference,
// trace_rays_reference, ao_fix_reference), through the device functions
// of frame_fused.cuh that the fused kernel runs too; the crowd's member
// loops (settings.vector_objects) live there, and all three are
// instantiated with them (<true>).
//
// What bounds them on this card: the scene's DE evaluations (FP32 ALU and
// divergence) where the scene has SDF objects; on a mesh scene whose only
// non-mesh object is a plane, the bytes of the ray arrays (K1 reads 24 and
// writes 28 bytes per ray, K2 reads 32 and writes 4).
//
// What the design does about it: one thread per ray over the flat padded
// (rows, 128) arrays, 128-thread blocks, so consecutive threads read and
// write consecutive floats; a thread whose work is done stops. K2 returns
// 1 at once for a lane whose shadow segment is empty (dist <= 0: the
// driver zeroes it on primary misses), which is what the full test gives
// there. The TPU kernels' tile-level gates are not carried over: each is
// value-exact per lane. K1 and K2 take their step budgets from S, and
// write unres and honour a residual re-run's row flags (R.redo) only in
// their CUT instantiation, which a launch with an unres output runs, as
// split_staged.cu's do (its note).
//
// C interface (bound with ctypes, no PyTorch headers), each returning the
// cudaError_t of its launch (each refuses a scene without a crowd):
//   int sp_render_tile(KFTables, KFSettings, SplitRays, int device, void*)
//   int sp_trace_rays(KFTables, KFSettings, SplitRays, int device, void*)
//   int sp_ao_fix(KFTables, KFSettings, SplitRays, int device, void*)

#include "frame_fused.cuh"

#define SP_BLOCK 128

template <bool CROWD, bool CUT>
__global__ void __launch_bounds__(SP_BLOCK)
sp_render_tile_kernel(const KFTables T, const KFSettings S,
                      const SplitRays R) {
  if constexpr (CUT) {
    if (R.redo && !(R.redo[blockIdx.x] > 0.5f)) return;
  }
  const int i = blockIdx.x * SP_BLOCK + threadIdx.x;
  if (i >= R.n) return;
  const V3 o{R.in[0][i], R.in[1][i], R.in[2][i]};
  const V3 d{R.in[3][i], R.in[4][i], R.in[5][i]};
  float t, obj;
  int leaf;
  bool cut = false;
  if constexpr (CUT) {
    trace_primary<CROWD>(T, S, o, d, R.in[6] ? R.in[6][i] : 0.0f, t, obj,
                         leaf, NoCull{}, Unres{cut});
  } else {
    trace_primary<CROWD>(T, S, o, d, R.in[6] ? R.in[6][i] : 0.0f, t, obj,
                         leaf);
  }
  const float hitf = t < KF_BIG * 0.5f ? 1.0f : 0.0f;
  const float t_sane = hitf > 0.5f ? t : 0.0f;
  const V3 p = along(o, d, t_sane);
  const V3 n = hit_normal<CROWD>(T, S, obj, leaf, p, d);
  float ao = 1.0f;
  if (S.ao && S.n_ana + S.n_sdf + S.n_crowd > 0) {
    const float eps = S.shadow_eps;
    ao = ao_factor<CROWD>(T, S, V3{p.x + n.x * eps, p.y + n.y * eps,
                            p.z + n.z * eps}, n);
  }
  R.out[0][i] = t;
  R.out[1][i] = obj;
  R.out[2][i] = n.x;
  R.out[3][i] = n.y;
  R.out[4][i] = n.z;
  R.out[5][i] = ao;
  R.out[6][i] = hitf;
  if constexpr (CUT) R.out[7][i] = cut ? 1.0f : 0.0f;
}

template <bool CROWD, bool CUT>
__global__ void __launch_bounds__(SP_BLOCK)
sp_trace_rays_kernel(const KFTables T, const KFSettings S,
                     const SplitRays R) {
  if constexpr (CUT) {
    if (R.redo && !(R.redo[blockIdx.x] > 0.5f)) return;
  }
  const int i = blockIdx.x * SP_BLOCK + threadIdx.x;
  if (i >= R.n) return;
  const float dist = R.in[6][i];
  float vis = 1.0f;
  bool cut = false;
  if (!(dist <= 0.0f)) {
    if constexpr (CUT) {
      vis = visibility<CROWD>(T, S, V3{R.in[0][i], R.in[1][i], R.in[2][i]},
                       V3{R.in[3][i], R.in[4][i], R.in[5][i]}, dist,
                       R.in[7][i], Unres{cut});
    } else {
      vis = visibility<CROWD>(T, S, V3{R.in[0][i], R.in[1][i], R.in[2][i]},
                       V3{R.in[3][i], R.in[4][i], R.in[5][i]}, dist,
                       R.in[7][i]);
    }
  }
  R.out[0][i] = vis;
  if constexpr (CUT) R.out[1][i] = cut ? 1.0f : 0.0f;
}

template <bool CROWD>
__global__ void __launch_bounds__(SP_BLOCK)
sp_ao_fix_kernel(const KFTables T, const KFSettings S, const SplitRays R) {
  const int i = blockIdx.x * SP_BLOCK + threadIdx.x;
  if (i >= R.n) return;
  float ao = R.in[7][i];
  if (R.in[6][i] > 0.5f) {
    ao = ao_factor<CROWD>(T, S, V3{R.in[0][i], R.in[1][i], R.in[2][i]},
                   V3{R.in[3][i], R.in[4][i], R.in[5][i]});
  }
  R.out[0][i] = ao;
}

typedef void (*RaysKernel)(KFTables, KFSettings, SplitRays);

// Launch the crowd instantiation `kernel`, or `cut` (with unres) when the
// launch has an unres output (slot `unres` of R.out; a residual re-run
// needs one); a scene without a crowd is refused (its kernels are the
// staged ones).
static int launch_rays(RaysKernel kernel, RaysKernel cut, int unres,
                       const KFTables& T, const KFSettings& S,
                       const SplitRays& R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool with_unres = unres >= 0 && R.out[unres] != nullptr;
  if (S.n_crowd <= 0 || (R.redo && !with_unres))
    return (int)cudaErrorInvalidValue;
  if (R.n <= 0) return 0;
  dim3 grid((R.n + SP_BLOCK - 1) / SP_BLOCK);
  const RaysKernel k = with_unres ? cut : kernel;
  k<<<grid, SP_BLOCK, 0, (cudaStream_t)stream>>>(T, S, R);
  return (int)cudaGetLastError();
}

extern "C" int sp_render_tile(KFTables T, KFSettings S, SplitRays R,
                              int device, void* stream) {
  return launch_rays(sp_render_tile_kernel<true, false>,
                     sp_render_tile_kernel<true, true>, 7, T, S, R, device,
                     stream);
}

extern "C" int sp_trace_rays(KFTables T, KFSettings S, SplitRays R,
                             int device, void* stream) {
  return launch_rays(sp_trace_rays_kernel<true, false>,
                     sp_trace_rays_kernel<true, true>, 1, T, S, R, device,
                     stream);
}

extern "C" int sp_ao_fix(KFTables T, KFSettings S, SplitRays R, int device,
                         void* stream) {
  return launch_rays(sp_ao_fix_kernel<true>, sp_ao_fix_kernel<true>, -1, T,
                     S, R, device, stream);
}
