// Split-path kernels for Hopper (sm_90a): K1 and K2 for scenes with a
// crowd (without one, the staged kernels of split_staged.cu; ao_fix with a
// crowd is ao_fix_crowd.cu, a unit of its own so that K1's and K2's code
// does not move).
//
// Replace two of the three Pallas TPU kernels that surfjax's split
// pipeline runs for scenes the fused kernel does not take (a crowd beside
// a mesh, or under a march cap):
//   * sp_render_tile_kernel <- surfjax/kernels/render_tile.py
//     ::render_tile_kernel (K1, body _k1_body): primary trace of the
//     non-mesh objects, the face-forwarded normal, and AO at the pre-merge
//     hit on every lane, for rays given from outside, with an optional
//     per-ray primed march start (in[6], null when the frame is not
//     primed), and unres (out[7]);
//   * sp_trace_rays_kernel <- ::trace_rays_kernel (K2, body _k2_body): the
//     hard or soft visibility of one light through the non-mesh objects,
//     1 at once where the shadow segment is empty (dist <= 0), and unres
//     (out[1]).
// Each is the per-lane program of the PyTorch plain version in
// surfjax_torch/kernels/render_tile.py (render_tile_reference,
// trace_rays_reference), through the cores of frame_fused.cuh that KF's
// crowd kernel runs too.
//
// What bounds K1 and K2 with a crowd: the crowd's member loops. A lane
// visits a member in the primary trace, in AO and in every light's
// visibility unless an exact per-lane gate skips it, and on the
// crowd-mesh path at 1080p all but a few members per warp are skipped
// (split_warp_masks: 0.6 of 42 SDF members in the primary trace, 1.7 of
// 48 in AO, 0.7-1.4 in hard shadows per warp); the parameters passed by
// value were copied into every thread's stack frame (640 and 560 bytes);
// then AO's 20 taps of the floor per lane through the tape walker, and
// the soft shadows' penumbra marches of the members a warp keeps.
//
// What the design does about it:
//   * __grid_constant__ parameters, which the cores read in place;
//   * warp-level member culling, as kf_frame_kernel<true> does over a
//     pixel block (frame_fused.cuh, "Warp-level member culling"), over 32
//     consecutive rays of the flat padded arrays: before each member loop
//     the warp votes which members may matter to any of its lanes and its
//     lanes visit only those, with their exact gates, so the results are
//     bitwise the plain version's. The rays come from outside, each lane
//     with its own origin, so K1's capsule is the ball of the lanes'
//     origins swept along their mean direction (warp_rays; where the
//     directions cancel, as in a batch shooting each point both ways, the
//     axis (1, 0, 0), whose widening then still bounds every lane), AO's
//     the ball of the lanes' receivers, K2's the ball of its receivers
//     swept along the lanes' light directions to the longest segment,
//     widened for soft shadows by the penumbra radius t/kf. Every lane
//     stays to the end so that the warp votes whole: a lane past the last
//     ray traces the last ray and writes nothing, a K2 lane without a
//     segment only votes, and a warp with no lane left returns at once;
//   * AO's floor decoded once per lane (floor_of, split_scene.cuh) and
//     evaluated as its leaf inline (Floor), as the staged K1 does;
//   * one block per 128-ray row, one thread per ray.
// The CUT instantiation (a launch with an unres output: a march cap or
// its residual re-run, R.redo) notes each lane's unres as the plain
// version does. A culled member's gate leaves its march with no step, so
// culling leaves unres as it was, but for a soft window over the whole
// segment (kf < 1.2): there a member that cannot darken the lane still
// marches and may run out of steps, so under a cap a warp holding such a
// lane keeps every member.
//
// C interface (bound with ctypes, no PyTorch headers), each returning the
// cudaError_t of its launch (each refuses a scene without a crowd):
//   int sp_render_tile(KFTables, KFSettings, SplitRays, int device, void*)
//   int sp_trace_rays(KFTables, KFSettings, SplitRays, int device, void*)

#include "split_scene.cuh"

#define SP_BLOCK 128

// K1: one block per 128-ray row, one thread per ray. Every lane stays to
// the end so that its warp votes whole: a lane past the last ray traces the
// last ray and writes nothing. AO runs on every lane, misses included (the
// receiver is then the ray's origin), as the plain version's does. Eight
// resident blocks per SM (64 registers, 120-130 bytes of spills) hide the
// taps' chains better than five at 96 registers (PERF.md).
template <bool CUT>
__global__ void __launch_bounds__(SP_BLOCK, 8)
sp_render_tile_kernel(const __grid_constant__ KFTables T,
                      const __grid_constant__ KFSettings S,
                      const __grid_constant__ SplitRays R) {
  if constexpr (CUT) {
    if (R.redo && !(R.redo[blockIdx.x] > 0.5f)) return;
  }
  const int i = blockIdx.x * SP_BLOCK + threadIdx.x;
  const bool act = i < R.n;
  if (!__any_sync(KF_FULL, act)) return;   // the whole warp is past the end
  const int k = act ? i : R.n - 1;
  const V3 o{R.in[0][k], R.in[1][k], R.in[2][k]};
  const V3 d{R.in[3][k], R.in[4][k], R.in[5][k]};
  const float t0 = R.in[6] ? R.in[6][k] : 0.0f;
  const WarpCull w{warp_rays(o, d, S.t_max, 0.0f, act), {}, act};
  float t, obj;
  int leaf;
  bool cut = false;
  if constexpr (CUT) {
    trace_primary<true>(T, S, o, d, t0, t, obj, leaf, w, Unres{cut});
  } else {
    trace_primary<true>(T, S, o, d, t0, t, obj, leaf, w);
  }
  const float hitf = t < KF_BIG * 0.5f ? 1.0f : 0.0f;
  const float t_sane = hitf > 0.5f ? t : 0.0f;
  const V3 p = along(o, d, t_sane);
  const V3 n = hit_normal<true>(T, S, obj, leaf, p, d);
  float ao = 1.0f;
  if (S.ao && S.n_ana + S.n_sdf + S.n_crowd > 0) {
    const float eps = S.shadow_eps;
    const V3 q0{p.x + n.x * eps, p.y + n.y * eps, p.z + n.z * eps};
    ao = ao_factor_culled(T, S, q0, n, warp_ball(q0, act), act,
                          floor_of(T, S));
  }
  if (!act) return;
  R.out[0][i] = t;
  R.out[1][i] = obj;
  R.out[2][i] = n.x;
  R.out[3][i] = n.y;
  R.out[4][i] = n.z;
  R.out[5][i] = ao;
  R.out[6][i] = hitf;
  if constexpr (CUT) R.out[7][i] = cut ? 1.0f : 0.0f;
}

// K2: one block per 128-ray row, one thread per ray; the lanes with a
// shadow segment (not dist <= 0) take part in the warp's capsule, the
// others (and those past the last ray) only vote. A warp without such a
// lane writes 1 at once.
template <bool CUT>
__global__ void __launch_bounds__(SP_BLOCK)
sp_trace_rays_kernel(const __grid_constant__ KFTables T,
                     const __grid_constant__ KFSettings S,
                     const __grid_constant__ SplitRays R) {
  if constexpr (CUT) {
    if (R.redo && !(R.redo[blockIdx.x] > 0.5f)) return;
  }
  const int i = blockIdx.x * SP_BLOCK + threadIdx.x;
  const bool in = i < R.n;
  const int k = in ? i : R.n - 1;
  const float dist = R.in[6][k];
  const bool act = in && !(dist <= 0.0f);
  float vis = 1.0f;
  bool cut = false;
  if (__any_sync(KF_FULL, act)) {
    const V3 o{R.in[0][k], R.in[1][k], R.in[2][k]};
    const V3 l{R.in[3][k], R.in[4][k], R.in[5][k]};
    const float kf = R.in[7][k];
    const float len = warp_max(act ? dist : 0.0f);
    WarpSeg hard{}, soft{};
    if (S.soft_shadows) {
      const float kinv = warp_max(act ? 1.0f / kf : 0.0f);
      soft = warp_rays(o, l, len, kinv * (1.0f + CULL_LIN) + CULL_SQRT, act);
      // under a cap a window over the whole segment (kf < 1.2) would note
      // a lane's unres for a member that cannot darken it: keep them all
      if (CUT && __any_sync(KF_FULL, act && kf < F(1.2))) soft.rA = KF_BIG;
    } else {
      hard = warp_rays(o, l, len, 0.0f, act);
    }
    if constexpr (CUT) {
      vis = visibility_culled(T, S, o, l, dist, kf, hard, soft, act,
                              Unres{cut});
    } else {
      vis = visibility_culled(T, S, o, l, dist, kf, hard, soft, act);
    }
  }
  if (!in) return;
  R.out[0][i] = vis;
  if constexpr (CUT) R.out[1][i] = cut ? 1.0f : 0.0f;
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
  const bool with_unres = R.out[unres] != nullptr;
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
  return launch_rays(sp_render_tile_kernel<false>,
                     sp_render_tile_kernel<true>, 7, T, S, R, device,
                     stream);
}

extern "C" int sp_trace_rays(KFTables T, KFSettings S, SplitRays R,
                             int device, void* stream) {
  return launch_rays(sp_trace_rays_kernel<false>, sp_trace_rays_kernel<true>,
                     1, T, S, R, device, stream);
}
