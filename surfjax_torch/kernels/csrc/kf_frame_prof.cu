// The per-pixel fused-frame kernel that kf_staged_kernel replaced for scenes
// without a crowd (kf_frame_kernel<false>), with a clock probe after each
// of its calls: where its time went, beside the staged kernel's profile
// (tools/breakdown.py, section `kf_phases`). No render path launches it.
//
// Its body is kf_frame_kernel<false>'s: one thread per pixel, 128-thread
// blocks of 16x8 pixels, the out-of-line cores of frame_fused.cuh
// (trace_primary<false>, hit_normal<false>, ao_factor<false>,
// visibility) unchanged. Two differences, both for the probes:
// a lane outside the frame stays to the end, idle, instead of returning,
// and the secondary work of a hit pixel is split at the probes into one
// `if (hit)` per phase, so that every lane of a warp reaches each probe.
// The probes sit between the cores, not inside them: the table has cycles
// per phase and no loop trips.
//
// C interface (bound with ctypes, no PyTorch headers):
//   int kf_frame_profile(KFTables tables, KFSettings settings,
//                        unsigned long long* prof, int device,
//                        void* stream)
//       -> cudaError_t of the launch; prof: tiles x KS_WARPS x KP_PHASES
//          x 3 counters, zeroed by the caller, of which the phases below
//          (render_tile.KF_PROF_NAMES) take the first
//          (cycles in the first of each three)

#include "kf_staged.cuh"

enum { PF_RAY = 0, PF_PRIMARY, PF_NORMAL, PF_AO, PF_VIS,
       PF_SHADE = PF_VIS + KP_LIGHTS, PF_WRITE, KF_PROF_PHASES };

__global__ void __launch_bounds__(128)
kf_frame_prof_kernel(const KFTables T, const KFSettings S,
                     unsigned long long* prof) {
  const int j = blockIdx.x * 16 + (threadIdx.x & 15);
  const int i = blockIdx.y * 8 + (threadIdx.x >> 4);
  const int f = blockIdx.z;
  const bool in_frame = i < S.H && j < S.W;
  Prof<true> P;
  P.begin(prof, (f * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);

  V3 o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 1.0f};
  if (in_frame) camera_ray(T, S, f, i, j, o, d);
  P.mark(PF_RAY);

  // primary trace, then the normal of the winning object
  float t = KF_BIG, obj = -1.0f;
  int leaf = 0;
  if (in_frame) {
    const float t0 = T.t0 ? T.t0[((size_t)f * S.H + i) * S.W + j] : 0.0f;
    trace_primary<false>(T, S, o, d, t0, t, obj, leaf);
  }
  P.mark(PF_PRIMARY);
  const bool hit = in_frame && t < KF_BIG * 0.5f;
  const float hitf = hit ? 1.0f : 0.0f;
  const float t_sane = hit ? t : 0.0f;
  const V3 p = along(o, d, t_sane);
  V3 n{0.0f, 0.0f, 1.0f};
  if (in_frame) n = hit_normal<false>(T, S, obj, leaf, p, d);
  P.mark(PF_NORMAL);

  float r = 0.0f + S.bg_r, g = 0.0f + S.bg_g, b = 0.0f + S.bg_b;
  const float eps = S.shadow_eps;
  const V3 p_off{p.x + n.x * eps, p.y + n.y * eps, p.z + n.z * eps};
  float ao = 1.0f;
  if (hit && S.ao && S.n_objects > 0) ao = ao_factor<false>(T, S, p_off, n);
  P.mark(PF_AO);
  const int* ob = object_row(T, hit ? (int)obj : 0);
  const float* mat = T.materials + ob[O_MAT] * KF_MAT_W;
  const int shin = ob[O_SHIN];
  const V3 v{-d.x, -d.y, -d.z};
  if (hit) {
    r = mat[3] * mat[0] * T.ambient[0] * ao;
    g = mat[3] * mat[1] * T.ambient[1] * ao;
    b = mat[3] * mat[2] * T.ambient[2] * ao;
  }
  for (int li = 0; li < S.n_lights; ++li) {
    const float* lrow = T.lights + li * KF_LIGHT_W;
    V3 l{0.0f, 0.0f, 0.0f};
    float dist = 0.0f, vis = 1.0f;
    if (hit) {
      light_ray(S, lrow, T.light_kinds[li] == LIGHT_POINT, p_off, l, dist);
      if (S.shadows) {
        const float radius = lrow[6];
        const float kf = radius > 0.0f ? dist / radius : S.soft_shadow_k;
        vis = visibility(T, S, p_off, l, dist, kf);
      }
    }
    P.mark(PF_VIS + (li < KP_LIGHTS - 1 ? li : KP_LIGHTS - 1));
    if (hit) add_light(mat, shin, lrow, n, l, v, vis, r, g, b);
    P.mark(PF_SHADE);
  }
  if (in_frame) {
    write_pixel(T.out + ((size_t)f * S.H + i) * S.W + j,
                (size_t)S.F * S.H * S.W, r, g, b, t_sane, obj, n, hitf);
  }
  P.mark(PF_WRITE);
}

extern "C" int kf_frame_profile(KFTables tables, KFSettings settings,
                                unsigned long long* prof, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (settings.F <= 0 || settings.H <= 0 || settings.W <= 0) return 0;
  if (!prof) return (int)cudaErrorInvalidValue;
  dim3 grid((settings.W + 15) / 16, (settings.H + 7) / 8, settings.F);
  kf_frame_prof_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      tables, settings, prof);
  return (int)cudaGetLastError();
}
