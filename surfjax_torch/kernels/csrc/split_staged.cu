// The split path's K1 and K2 for scenes without a crowd (the crowd's
// instantiations stay in split_path.cu), on the per-ray stages of
// kf_staged.cuh.
//
// Replace, for scenes with no crowd, surfjax/kernels/render_tile.py::
// render_tile_kernel (K1, body _k1_body) and ::trace_rays_kernel (K2, body
// _k2_body), as split_path.cu's sp_render_tile_kernel<false> and
// sp_trace_rays_kernel<false> did before them: the same per-lane
// arithmetic (render_tile.render_tile_reference and trace_rays_reference
// are the plain versions, bit for bit), on rays given from outside:
//   * K1: primary trace of the non-mesh objects (t0: the primed march
//     starts, in[6], or null), the face-forwarded normal, and AO at the
//     pre-merge hit on every lane, misses included;
//   * K2: the hard or soft visibility of one light through the non-mesh
//     objects; 1 at once where the shadow segment is empty (dist <= 0);
//   * both, when the launch passes an unres output (K1 out[7], K2 out[1];
//     the instantiation CUT): unres, 1 on a lane that a march left
//     unfinished when its step budget (S.max_steps, S.shadow_steps) ran
//     out. The capped-march residual (surfjax's _block_residual) launches
//     a kernel with the budgets at the cap, then again at the full budget
//     with R.redo, the flag of each 128-ray row that has such a lane: a
//     row whose flag is 0 returns at once (K1: the block; K2: the row it
//     took), a flagged row writes over the capped launch's outputs. The
//     flag costs one load per row; no capacity, no fallback, no host sync.
//     Without a cap no unres is asked for, and the instantiation without
//     CUT is the code the kernels had before the caps: tracking and
//     storing unres cost K2 14% on c4 at 1080p (PERF.md).
//
// What bounds them: on a mesh scene whose only non-mesh object is a plane
// (c4) the bytes of the ray arrays (K1 reads 24 and writes 28 bytes per
// ray, K2 reads up to 32 and writes 4), and on c4 with AO the 20 floor
// evaluations per lane; with SDF objects (the fit's c5) the marches' SDF
// evaluations, divergent. What held the kernels they replace back was per
// lane (PERF.md, PR 8): each thread copied the 280 bytes of by-value
// parameters that the cores take by reference into its stack frame, and
// AO decoded the floor's row, tape, leaf and parameters anew at every tap,
// through the tape walker's out-of-line call and local array. The design:
//   * __grid_constant__ parameters, which the cores read in place;
//   * one thread per ray over the flat padded arrays, running the stages
//     trace_pixel, ao_receiver and vis_receiver (trace_primary<false>'s,
//     ao_core<false>'s and visibility's order) on SplitScene;
//   * single-leaf evaluation: an object whose tape is one leaf evaluates
//     as that leaf, and an analytic object of one leaf intersects as that
//     leaf, inline: the same operations on the same operands as the tape
//     walker's and the event CSG's, without their local arrays;
//   * K1: AO's unbounded group, when it is one single-leaf object (a
//     floor), decoded once per lane before the taps; the tables read
//     through the parameters from global memory, each bound computed where
//     it is used, one block per 128 rays (no shared memory, no barrier);
//   * K2: persistent blocks that stage the scene's tables and both
//     bounding spheres of every object in shared memory once
//     (stage_scene), keep the tables' pointers as values, and take 128-ray
//     rows from a counter that the last block resets.
// Measured and left out (PERF.md): staging and persistent blocks for K1,
// one block per row for K2, AO's taps unrolled per direction, 256-thread
// blocks, the tables' pointers read from the staged struct.
//
// PROF (a template parameter: the production code has no probes) makes
// each warp add, per phase, lane 0's clock64 deltas, the loop trips it
// issued and __popc(__activemask()) per trip (the lanes that evaluate an
// SDF) into its record of a scratch buffer (KP_PHASES x 3 counters, the
// phase names of kf_staged.cuh).
//
// C interface (bound with ctypes, no PyTorch headers), each returning the
// cudaError_t of its launch (the budgets in KFSettings, R.redo in
// SplitRays):
//   int sp_staged_render_tile(KFTables, KFSettings, SplitRays,
//                             unsigned long long* prof, int device,
//                             void* stream)
//   int sp_staged_trace_rays(KFTables, KFSettings, KSLayout, SplitRays,
//                            unsigned long long* prof, int* work,
//                            int device, void* stream)
// prof: null, or the profile's counters, zeroed by the caller: rows x 4 x
// KP_PHASES x 3 (launches without unres only); work: two ints the caller
// zeroed once (the row counter and the blocks done), which the last block
// of each launch resets.

#include "split_scene.cuh"

// K1 on ray i (act false: a lane past the last ray, which takes part in
// the warp's probes only); CUT: with unres.
template <bool PROF, bool CUT, class Blk>
__device__ __forceinline__ void k1_ray(const Blk& B, const KFSettings& S,
                                       const SplitRays& R, int i, bool act,
                                       Prof<PROF>& P) {
  V3 o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 1.0f};
  float t0 = 0.0f;
  if (act) {
    o = V3{R.in[0][i], R.in[1][i], R.in[2][i]};
    d = V3{R.in[3][i], R.in[4][i], R.in[5][i]};
    if (R.in[6]) t0 = R.in[6][i];
  }
  P.mark(PH_RAY);
  float t, obj;
  int leaf;
  bool cut = false;
  if constexpr (CUT) {
    trace_pixel(B, S, act, o, d, t0, t, obj, leaf, P, Unres{cut});
  } else {
    trace_pixel(B, S, act, o, d, t0, t, obj, leaf, P);
  }
  const float hitf = t < KF_BIG * 0.5f ? 1.0f : 0.0f;
  const float t_sane = hitf > 0.5f ? t : 0.0f;
  const V3 p = along(o, d, t_sane);
  const V3 n = act ? hit_normal<false>(B.Tm, S, obj, leaf, p, d)
                   : V3{0.0f, 0.0f, 1.0f};
  P.mark(PH_NORMAL);
  float ao = 1.0f;
  if (S.ao && S.n_ana + S.n_sdf > 0) {
    const float eps = S.shadow_eps;
    ao = ao_receiver(B, S, act,
                     V3{p.x + n.x * eps, p.y + n.y * eps, p.z + n.z * eps},
                     n, P);
  }
  P.mark(PH_AO_SUM);
  if (act) {
    R.out[0][i] = t;
    R.out[1][i] = obj;
    R.out[2][i] = n.x;
    R.out[3][i] = n.y;
    R.out[4][i] = n.z;
    R.out[5][i] = ao;
    R.out[6][i] = hitf;
    if constexpr (CUT) R.out[7][i] = cut ? 1.0f : 0.0f;
  }
  P.mark(PH_WRITE);
}

// K2 on ray i: visibility of the launch's light (the profile's light 0);
// CUT: with unres.
template <bool PROF, bool CUT, class Blk>
__device__ __forceinline__ void k2_ray(const Blk& B, const KFSettings& S,
                                       const SplitRays& R, int i, bool act,
                                       Prof<PROF>& P) {
  const float dist = act ? R.in[6][i] : 0.0f;
  const bool live = act && !(dist <= 0.0f);
  V3 o{0.0f, 0.0f, 0.0f}, l{0.0f, 0.0f, 1.0f};
  float kf = 0.0f;
  if (live) {
    o = V3{R.in[0][i], R.in[1][i], R.in[2][i]};
    l = V3{R.in[3][i], R.in[4][i], R.in[5][i]};
    kf = R.in[7][i];
  }
  P.mark(PH_RAY);
  bool cut = false;
  float vis;
  if constexpr (CUT) {
    vis = vis_receiver(B, S, live, 0, o, l, dist, kf, P, Unres{cut});
  } else {
    vis = vis_receiver(B, S, live, 0, o, l, dist, kf, P);
  }
  if (act) {
    R.out[0][i] = vis;
    if constexpr (CUT) R.out[1][i] = cut ? 1.0f : 0.0f;
  }
  P.mark(PH_WRITE);
}

// K1: one block per 128-ray row; a re-run skips an unflagged row.
template <bool PROF, bool CUT>
__global__ void __launch_bounds__(KS_THREADS)
sp_staged_render_tile_kernel(const __grid_constant__ KFTables G,
                             const __grid_constant__ KFSettings S,
                             const __grid_constant__ SplitRays R,
                             unsigned long long* prof) {
  if constexpr (CUT) {
    if (R.redo && !(R.redo[blockIdx.x] > 0.5f)) return;
  }
  SplitScene<false> B{G, G, nullptr, S.exit_margin};
  B.hoist(S);
  Prof<PROF> P;
  P.begin(prof, blockIdx.x);
  const int i = blockIdx.x * KS_THREADS + threadIdx.x;
  k1_ray<PROF, CUT>(B, S, R, i, i < R.n, P);
}

// K2: the block stages the scene, then takes rows from `work` until none
// is left (a re-run skips an unflagged row); the last block to finish
// resets the counters. The bound of 8
// resident blocks makes ptxas keep more values in registers around the
// out-of-line cores (fewer spills; PERF.md).
template <bool PROF, bool CUT>
__global__ void __launch_bounds__(KS_THREADS, 8)
sp_staged_trace_rays_kernel(const __grid_constant__ KFTables G,
                            const __grid_constant__ KFSettings S,
                            const __grid_constant__ KSLayout L,
                            const __grid_constant__ SplitRays R,
                            unsigned long long* prof, int* work) {
  unsigned char* sm = ks_smem;
  const int tid = threadIdx.x;
  __shared__ KFTables staged;
  const KFTables T = stage_scene(G, S, L, sm);
  if (tid == 0) staged = T;
  __syncthreads();
  const SplitScene<true> B{T, staged, (const float*)(sm + L.bounds),
                           S.exit_margin};
  Prof<PROF> P;
  const int n_items = (R.n + KS_THREADS - 1) / KS_THREADS;
  int* item_slot = (int*)(sm + L.ctr);
  for (;;) {
    if (tid == 0) *item_slot = atomicAdd(work, 1);
    __syncthreads();
    const int item = *item_slot;
    __syncthreads();
    if (item >= n_items) break;
    if constexpr (CUT) {
      if (R.redo && !(R.redo[item] > 0.5f)) continue;
    }
    P.begin(prof, item);
    const int i = item * KS_THREADS + tid;
    k2_ray<PROF, CUT>(B, S, R, i, i < R.n, P);
  }
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(work + 1, 1) == (int)gridDim.x - 1) {
      work[0] = 0;
      work[1] = 0;
    }
  }
}

template <bool PROF, bool CUT>
static int render_tile_launch(const KFTables& T, const KFSettings& S,
                              const SplitRays& R, unsigned long long* prof,
                              cudaStream_t stream) {
  const unsigned grid = (R.n + KS_THREADS - 1) / KS_THREADS;
  sp_staged_render_tile_kernel<PROF, CUT><<<grid, KS_THREADS, 0, stream>>>(
      T, S, R, prof);
  return (int)cudaGetLastError();
}

// As many blocks as the card holds at once (at most one per row).
template <bool PROF, bool CUT>
static int trace_rays_launch(const KFTables& T, const KFSettings& S,
                             const KSLayout& L, const SplitRays& R,
                             unsigned long long* prof, int* work,
                             cudaStream_t stream) {
  if (!work) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (L.bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sp_staged_trace_rays_kernel<PROF, CUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sp_staged_trace_rays_kernel<PROF, CUT>, KS_THREADS,
        L.bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (R.n + KS_THREADS - 1) / KS_THREADS;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(rows < resident ? rows : resident);
  sp_staged_trace_rays_kernel<PROF, CUT>
      <<<grid, KS_THREADS, L.bytes, stream>>>(T, S, L, R, prof, work);
  return (int)cudaGetLastError();
}

// A launch with an unres output (K1 out[7], K2 out[1]) runs the CUT
// instantiation; a residual re-run (R.redo) needs one. The profile is of
// launches without a cap.
extern "C" int sp_staged_render_tile(KFTables T, KFSettings S, SplitRays R,
                                     unsigned long long* prof, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool cut = R.out[7] != nullptr;
  if ((R.redo && !cut) || (prof && cut)) return (int)cudaErrorInvalidValue;
  if (R.n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (prof) return render_tile_launch<true, false>(T, S, R, prof, st);
  return cut ? render_tile_launch<false, true>(T, S, R, nullptr, st)
             : render_tile_launch<false, false>(T, S, R, nullptr, st);
}

extern "C" int sp_staged_trace_rays(KFTables T, KFSettings S, KSLayout L,
                                    SplitRays R, unsigned long long* prof,
                                    int* work, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool cut = R.out[1] != nullptr;
  if ((R.redo && !cut) || (prof && cut)) return (int)cudaErrorInvalidValue;
  if (R.n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (prof) return trace_rays_launch<true, false>(T, S, L, R, prof, work, st);
  return cut ? trace_rays_launch<false, true>(T, S, L, R, nullptr, work, st)
             : trace_rays_launch<false, false>(T, S, L, R, nullptr, work,
                                               st);
}
