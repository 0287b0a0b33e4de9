// Fused-frame kernel for Hopper (sm_90a), the instantiation for scenes with
// a crowd; scenes without one take the staged kernel of kf_staged.cu.
//
// Replaces surfjax/kernels/render_tile.py::frame_fused_kernel (KF, the
// Pallas TPU kernel whose body is _kframe_body): for F frames it generates
// each pixel's camera ray, traces the scene (exact analytic hits, then one
// bounded over-relaxed sphere march per SDF object, entered at its bounding
// sphere and, on a primed frame, not before the pixel's t0), takes the
// normal, the AO probes, the soft or hard visibility of every light, and
// Blinn-Phong shading, and writes r, g, b, depth, object id (as a float, -1
// on a miss), normal and hit for every pixel.
//
// What bounds it on this card: FP32 ALU work and divergence, not memory.
// It reads a few KB of scene scalars (cached on chip after the first
// touch) and writes 36 bytes per pixel; a pixel near the Mandelbulb costs
// hundreds of DE evaluations of ~60 flops each, a sky pixel almost none.
//
// What the design does about it:
//   * One thread per pixel, 128-thread blocks covering 8x16-pixel
//     rectangles, grid (ceil(W/16), ceil(H/8), F); coherent rectangles
//     keep the lanes of a warp on similar paths. KF's tile layout, its park
//     points and its tile-level while-loop gates exist only for the TPU and
//     are not carried over: each per-lane gate is value-exact.
//   * The scene is interpreted, not compiled in: the host packs each
//     SceneIR into small int tables (objects, tape nodes, leaves, march
//     orders) and the kernel walks each object's CSG tape with a
//     per-thread value array: one value per node up to KF_TAPE_NODES
//     nodes, and past that value slots that the host's Sethi-Ullman
//     allocation (render_tile.tape_rows) keeps within floor(log2(leaves))
//     + 1 for a tape of any length. The default build serves the scenes
//     within the per-thread arrays of frame_fused.cuh; the KF_WIDE units
//     (*_wide.cu) serve the rest, of any object count, tape length or leaf
//     count, chosen per scene by render_tile.wide_scene. The alternative,
//     generating and compiling source per SceneIR as Pallas unrolls it at
//     trace time, would trade a build per scene for straight-line code;
//     it is left to later speed work.
//   * Built with -fmad=false and without fast math: division and sqrtf are
//     IEEE and no multiply-add is contracted, so each operation rounds as
//     the PyTorch twin's does (render_tile.frame_fused_reference).
//   * The trace, normal, AO and visibility cores are device functions of
//     frame_fused.cuh, shared with the split-path kernels (split_path.cu).
//   * Large scenes (settings.vector_objects) replace surfjax's crowd
//     sections (_crowd_trace, _crowd_normals, _crowd_ao_terms,
//     _crowd_hard_vis, _crowd_soft_vis, _crowd_shade): single sphere/box
//     objects and two-leaf pairs are taken by loops over member rows in
//     those cores, which read a member's leaves directly instead of walking
//     its tape. A crowd member is shaded like any object, from its row of
//     the object table (material row, shininess). The member loops are
//     culled per warp: a member no lane of a warp could need costs each
//     lane 1/32 of a test.
//
// C interface (bound with ctypes, no PyTorch headers):
//   int kf_frame_fused(KFTables tables, KFSettings settings, int device,
//                      void* stream)   -> cudaError_t of the launch
//                      (cudaErrorInvalidValue for a scene without a crowd)
//   const char* kf_error_string(int err)

#include "frame_fused.cuh"

// Declared for the crowd's explicit specialization below, the one defined.
template <bool CROWD>
__global__ void __launch_bounds__(128)
kf_frame_kernel(const KFTables T, const KFSettings S);

// The crowd instantiation: the per-pixel program with the member loops
// culled per warp (the cores' crowd instantiation, frame_fused.cuh,
// "Warp-level member culling"). Every lane stays to the end so that the
// warp votes whole: a pixel outside the frame traces a ray that nobody
// reads, and a lane without a hit runs the AO and light calls only to vote.
template <>
__global__ void __launch_bounds__(128)
kf_frame_kernel<true>(const KFTables T, const KFSettings S) {
  const int j = blockIdx.x * 16 + (threadIdx.x & 15);
  const int i = blockIdx.y * 8 + (threadIdx.x >> 4);
  const int f = blockIdx.z;
  const bool in_frame = i < S.H && j < S.W;
  if (!__any_sync(KF_FULL, in_frame)) return;   // the whole warp is outside

  V3 o, d;
  camera_ray(T, S, f, i, j, o, d);
  float t, obj;
  int leaf;
  const float t0 = (T.t0 && in_frame)
      ? T.t0[((size_t)f * S.H + i) * S.W + j] : 0.0f;
  trace_primary<true>(T, S, o, d, t0, t, obj, leaf,
                      WarpCull{warp_cone(S, o, d, in_frame), {}, in_frame});
  const bool hit = in_frame && t < KF_BIG * 0.5f;
  const float hitf = hit ? 1.0f : 0.0f;
  const float t_sane = hit ? t : 0.0f;
  const V3 p = along(o, d, t_sane);
  const V3 n = hit_normal<true>(T, S, obj, leaf, p, d);

  const float eps = S.shadow_eps;
  const V3 p_off{p.x + n.x * eps, p.y + n.y * eps, p.z + n.z * eps};
  const WarpSeg ball = warp_ball(p_off, hit);
  const float ao = (S.ao && S.n_objects > 0)
      ? ao_factor_culled(T, S, p_off, n, ball, hit) : 1.0f;
  float r = 0.0f + S.bg_r, g = 0.0f + S.bg_g, b = 0.0f + S.bg_b;
  const float* mat = T.materials;
  int shin = 0;
  if (hit) {
    const int* ob = object_row(T, (int)obj);
    mat = T.materials + ob[O_MAT] * KF_MAT_W;
    shin = ob[O_SHIN];
    r = mat[3] * mat[0] * T.ambient[0] * ao;
    g = mat[3] * mat[1] * T.ambient[1] * ao;
    b = mat[3] * mat[2] * T.ambient[2] * ao;
  }
  const V3 v{-d.x, -d.y, -d.z};
  for (int li = 0; li < S.n_lights; ++li) {
    const float* lrow = T.lights + li * KF_LIGHT_W;
    const bool point = T.light_kinds[li] == LIGHT_POINT;
    V3 l;
    float dist;
    light_ray(S, lrow, point, p_off, l, dist);
    float vis = 1.0f;
    if (S.shadows) {
      const float radius = lrow[6];
      const float kf = radius > 0.0f ? dist / radius : S.soft_shadow_k;
      WarpSeg hard, soft;
      warp_light(S, lrow, point, ball, dist, kf, hit, hard, soft);
      vis = visibility_culled(T, S, p_off, l, dist, kf, hard, soft, hit);
    }
    if (hit) add_light(mat, shin, lrow, n, l, v, vis, r, g, b);
  }
  if (!in_frame) return;
  write_pixel(T.out + ((size_t)f * S.H + i) * S.W + j,
              (size_t)S.F * S.H * S.W, r, g, b, t_sane, obj, n, hitf);
}

extern "C" int kf_frame_fused(KFTables tables, KFSettings settings,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (settings.F <= 0 || settings.H <= 0 || settings.W <= 0) return 0;
  dim3 block(128);
  dim3 grid((settings.W + 15) / 16, (settings.H + 7) / 8, settings.F);
  // scenes without a crowd take the staged kernel (ks_frame_fused)
  if (settings.n_crowd <= 0) return (int)cudaErrorInvalidValue;
  kf_frame_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
      tables, settings);
  return (int)cudaGetLastError();
}

extern "C" const char* kf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
