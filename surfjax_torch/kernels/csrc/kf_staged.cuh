// The fused-frame kernel for scenes without a crowd (kf_staged.cu builds it
// and its profiling instantiation), and the per-ray stages it shares with
// K1 and K2 (split_staged.cu).
//
// Replaces, for scenes with no crowd, surfjax/kernels/render_tile.py::
// frame_fused_kernel (KF, body _kframe_body), as frame_fused.cu's
// kf_frame_kernel<false> did before it: the same per-pixel arithmetic (the
// cores of frame_fused.cuh, and render_tile.frame_fused_reference as the
// plain twin, bit for bit).
//
// What bounds it: FP32 work per SDF evaluation, then divergence. On c3 a
// hit pixel takes 49 AO evaluations at 98% SIMT efficiency and 15-17
// shadow-march steps at 61-69% (PERF.md). The design:
//   * persistent blocks: as many 128-thread blocks as the card holds at
//     once, each taking 16x8-pixel tiles (frame, tile row, tile column)
//     from a counter the caller zeroes, until none is left; one thread per
//     pixel, four warps of 16x2 pixels;
//   * staging: at block start the object rows, tapes, leaf rows and
//     parameters, and both bounding spheres of every boundable object
//     (lower: AO and soft shadows; cover: the marches), computed by
//     object_bound itself, go to shared memory once for all the block's
//     tiles, so no pixel recomputes a bound and the tape walker reads
//     shared memory (KSLayout, sized on the host from the scene:
//     render_tile.staged_layout);
//   * per pixel: ray, primary trace (t0 on primed frames), normal, offset
//     receiver -> the pixel's record in shared memory (so nothing of it
//     stays live in registers across the marches); AO; per light the
//     visibility, object by object in visibility's order, and
//     add_light; the nine planes. The marches are march_loop's and
//     soft_march_loop's bodies, inlined.
// Block-wide wavefronts (hit compaction, object-major AO, visibility passes
// with refill), single-leaf evaluation and barriers between the stages
// were measured against this schedule and cost time or none (PERF.md).
//
// PROF (a template parameter: the production code has no probes) makes
// each warp add, per phase, lane 0's clock64 deltas, the loop trips it
// issued and __popc(__activemask()) per trip (the lanes that evaluate an
// SDF) into its record of a scratch buffer (KP_PHASES x 3 counters).
//
// The stages (trace_pixel, ao_receiver, vis_receiver) are templates on the
// block they run on: Block here, SplitScene in split_scene.cuh. A block
// has T (the tables), lower and cover (an object's two bounding spheres),
// eval (an object's SDF), intersect (an analytic object's nearest hit) and
// unbounded_min (AO's unbounded group at a point).
#pragma once

#include "frame_fused.cuh"

#define KS_THREADS 128
#define KS_WARPS (KS_THREADS / 32)

// Byte offsets into the block's dynamic shared memory and the table sizes
// staged (render_tile.KSLayout).
struct KSLayout {
  int bytes, n_nodes, n_leaves, n_order, n_leaf_rows, n_kp;
  int ctr, objects, nodes, leaves, order, leaf_params, node_params, bounds;
  int rec;
};

// Fields of a pixel's record (each a KS_THREADS-float array).
enum { R_PX = 0, R_PY, R_PZ, R_NX, R_NY, R_NZ, R_DX, R_DY, R_DZ, R_OBJ, R_T,
       R_HIT, R_R, R_G, R_B, R_AO, KS_REC };

// Profile phases: objects past KP_OBJ - 1 share the last slot, lights past
// KP_LIGHTS - 1 the last light's (render_tile.KP_PHASE_NAMES).
#define KP_OBJ 8
#define KP_LIGHTS 4
enum { PH_RAY = 0, PH_PRIMARY, PH_NORMAL = PH_PRIMARY + KP_OBJ,
       PH_AO_SETUP, PH_AO_UNB, PH_AO_OBJ, PH_AO_SUM = PH_AO_OBJ + KP_OBJ,
       PH_VIS, PH_SHADE = PH_VIS + KP_LIGHTS * KP_OBJ, PH_WRITE, KP_PHASES };

extern __shared__ __align__(16) unsigned char ks_smem[];

__device__ __forceinline__ int kp_obj(int oi) {
  return oi < KP_OBJ - 1 ? oi : KP_OBJ - 1;
}
__device__ __forceinline__ int kp_vis(int li, int oi) {
  return PH_VIS + (li < KP_LIGHTS - 1 ? li : KP_LIGHTS - 1) * KP_OBJ +
         kp_obj(oi);
}

template <bool ON>
struct Prof {
  __device__ __forceinline__ void begin(unsigned long long*, int) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void trip(int) {}
};

template <>
struct Prof<true> {
  unsigned long long* rec;   // this warp's KP_PHASES x (cycles, trips, lanes)
  long long t;               // lane 0's clock at the last mark
  // this warp's record of tile `item` (frame-major, then rows, columns)
  __device__ __forceinline__ void begin(unsigned long long* base, int item) {
    const int warp = item * KS_WARPS + (threadIdx.x >> 5);
    rec = base + (size_t)warp * KP_PHASES * 3;
    __syncwarp();
    t = clock64();
  }
  // The phase `ph` ends here, on every lane of the warp.
  __device__ __forceinline__ void mark(int ph) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const long long now = clock64();
      atomicAdd(rec + ph * 3, (unsigned long long)(now - t));
      t = now;
    }
  }
  // One trip of a loop of phase `ph`: each active lane evaluates one SDF.
  __device__ __forceinline__ void trip(int ph) {
    const unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
      atomicAdd(rec + ph * 3 + 1, 1ull);
      atomicAdd(rec + ph * 3 + 2, (unsigned long long)__popc(m));
    }
  }
};

// ---------------------------------------------------------------------------
// The marches, inlined: march_loop's and soft_march_loop's bodies unchanged
// (frame_fused.cuh), each trip counted; u notes the lane's unres (Unres:
// the split path's K1 and K2; NoUnres, KF: nothing)
// ---------------------------------------------------------------------------

// march_loop from t over (.., t_clip): true on a hit, t its distance.
template <class Sdf, bool PROF, class U = NoUnres>
__device__ __forceinline__ bool march_lane(const KFSettings& S, Sdf sdf, V3 o,
                                           V3 d, float& t, float t_clip,
                                           Prof<PROF>& P, int ph,
                                           U u = U{}) {
  float h_prev = 0.0f, st_prev = 0.0f;
  bool done = t >= t_clip, hit = false;
  for (int i = 0; i < S.max_steps && !done; ++i) {
    float h = sdf(along(o, d, t));
    bool ovr = S.relaxed && (st_prev > h_prev + fabsf(h));
    float okf = ovr ? 0.0f : 1.0f;
    bool hit_now = !ovr && (h < S.hit_eps + S.hit_eps_scale * t);
    bool over = !ovr && (t > t_clip);
    hit = hit || hit_now;
    done = hit_now || over;
    float step = S.over_relax * h;
    float t_next = ovr ? (t - st_prev) + h_prev : t + step;
    if (!done) {
      t = t_next;
      h_prev = okf * h;
      st_prev = okf * step;
    }
    P.trip(ph);
  }
  u.note(!done);
  return hit;
}

// soft_march_loop from t over (.., t_max) with sharpness kf -> visibility.
template <class Sdf, bool PROF, class U = NoUnres>
__device__ __forceinline__ float soft_lane(const KFSettings& S, Sdf sdf,
                                           V3 o, V3 l, float t, float t_max,
                                           float kf, Prof<PROF>& P, int ph,
                                           U u = U{}) {
  float res = 1.0f, h_prev = 0.0f, st_prev = 0.0f;
  bool done = t > t_max;
  for (int i = 0; i < S.shadow_steps && !done; ++i) {
    float h = sdf(along(o, l, t));
    bool ovr = S.relaxed && (st_prev > h_prev + fabsf(h));
    float okf = ovr ? 0.0f : 1.0f;
    float res_new = fminf(res, kf * h / t);
    float s_allowed = (kf * h - res_new * t) / (kf + res_new);
    float cap = fmaxf(s_allowed, 0.5f);
    float step = fminf(fmaxf(S.over_relax * h, F(1e-3)), cap);
    float t_new = ovr ? (t - st_prev) + h_prev : t + step;
    done = (res_new < F(0.004)) || (t_new > t_max);
    res = res_new;
    t = t_new;
    if (!done) {
      h_prev = okf * h;
      st_prev = okf * step;
    }
    P.trip(ph);
  }
  u.note(!done);
  return clampf(res, 0.0f, 1.0f);
}

// The least SDF at q of the objects without a bound (AO's unbounded group),
// each through B.eval, in order -> false when the scene has none.
template <bool PROF, class Blk>
__device__ __forceinline__ bool unbounded_loop(const Blk& B,
                                               const KFSettings& S, V3 q,
                                               float& hmin, Prof<PROF>& P) {
  const int n_rest = S.n_ana + S.n_sdf;
  const int* rest = B.T.order + n_rest;
  hmin = 0.0f;
  bool first = true;
  for (int k = 0; k < n_rest; ++k) {
    const int* ob = object_row(B.T, rest[k]);
    if (ob[O_BOUNDABLE]) continue;
    float h = B.eval(S, ob, q, S.ao_lod);
    P.trip(PH_AO_UNB);
    hmin = first ? h : fminf(hmin, h);
    first = false;
  }
  return !first;
}

// ---------------------------------------------------------------------------
// The block's state
// ---------------------------------------------------------------------------

struct Block {
  KFTables T;           // the staged copies of the scene's tables
  const float* bounds;  // per object: lower (AO, soft), cover (marches)
  float* rec;           // KS_REC x KS_THREADS, by pixel (thread) index

  __device__ __forceinline__ float& R(int field, int px) const {
    return rec[field * KS_THREADS + px];
  }
  __device__ __forceinline__ V3 rec3(int field, int px) const {
    return V3{R(field, px), R(field + 1, px), R(field + 2, px)};
  }
  __device__ __forceinline__ const float* material(const KFTables& G,
                                                   int px) const {
    const int* ob = object_row(T, (int)R(R_OBJ, px));
    return G.materials + ob[O_MAT] * KF_MAT_W;
  }
  // light li seen from the receiver of pixel px: direction, segment length
  // and penumbra sharpness (kf_frame_kernel's)
  __device__ __forceinline__ void light_of(const KFTables& G,
                                           const KFSettings& S, int px,
                                           int li, V3& l, float& dist,
                                           float& kf) const {
    const float* lrow = G.lights + li * KF_LIGHT_W;
    light_ray(S, lrow, G.light_kinds[li] == LIGHT_POINT, rec3(R_PX, px), l,
              dist);
    const float radius = lrow[6];
    kf = radius > 0.0f ? dist / radius : S.soft_shadow_k;
  }
  __device__ __forceinline__ Bound lower(int oi) const {
    const float* b = bounds + oi * 8;
    return Bound{b[0], b[1], b[2], b[3]};
  }
  __device__ __forceinline__ Bound cover(int oi) const {
    const float* b = bounds + oi * 8 + 4;
    return Bound{b[0], b[1], b[2], b[3]};
  }
  // an object's SDF at p and an analytic object's nearest hit, through the
  // tape walker and the event CSG (the stages below call these, so that
  // another block type can evaluate differently)
  __device__ __forceinline__ float eval(const KFSettings& S, const int* ob,
                                        V3 p, int cap) const {
    return eval_obj(T, S, ob, p, cap);
  }
  __device__ __forceinline__ float intersect(const int* ob, V3 o, V3 d,
                                             float t_lo, float t_hi,
                                             int& leaf) const {
    return intersect_analytic(T, ob, o, d, t_lo, t_hi, leaf);
  }
  template <bool PROF>
  __device__ __forceinline__ bool unbounded_min(const KFSettings& S, V3 q,
                                                float& hmin,
                                                Prof<PROF>& P) const {
    return unbounded_loop(*this, S, q, hmin, P);
  }
};

template <class X>
__device__ __forceinline__ void stage_copy(X* dst, const X* src, int n) {
  for (int k = threadIdx.x; k < n; k += KS_THREADS) dst[k] = src[k];
}

// Stage the scene into the block's shared memory (L's sections): the
// object rows, tapes, leaf rows and parameters, and both bounding spheres
// of every boundable object (lower: AO and soft shadows; cover: the
// marches), by object_bound itself; mesh objects keep their rows but no
// bounds. -> G with its table pointers into shared memory; the caller
// synchronises the block before any thread reads them.
__device__ __forceinline__ KFTables stage_scene(const KFTables& G,
                                                const KFSettings& S,
                                                const KSLayout& L,
                                                unsigned char* sm) {
  const int tid = threadIdx.x;
  int* objects = (int*)(sm + L.objects);
  int* nodes = (int*)(sm + L.nodes);
  int* leaves = (int*)(sm + L.leaves);
  int* order = (int*)(sm + L.order);
  float* leaf_params = (float*)(sm + L.leaf_params);
  float* node_params = (float*)(sm + L.node_params);
  float* bounds = (float*)(sm + L.bounds);
  stage_copy(objects, G.objects, S.n_objects * KF_OBJ_W);
  stage_copy(nodes, G.nodes, L.n_nodes * KF_NODE_W);
  stage_copy(leaves, G.leaves, L.n_leaves * KF_LEAF_W);
  stage_copy(order, G.order, L.n_order);
  stage_copy(leaf_params, G.leaf_params, L.n_leaf_rows * KF_LEAF_PARAM_W);
  stage_copy(node_params, G.node_params, L.n_kp);
  // both bounds of every boundable object, by object_bound itself
  for (int oi = tid; oi < S.n_objects; oi += KS_THREADS) {
    const int* ob = object_row(G, oi);
    if (ob[O_ENGINE] == ENGINE_MESH || !ob[O_BOUNDABLE]) continue;
    const Bound lo = object_bound(G, ob, 1, 0.0f);
    const Bound cv = object_bound(G, ob, 0, S.exit_margin);
    float* b = bounds + oi * 8;
    b[0] = lo.cx; b[1] = lo.cy; b[2] = lo.cz; b[3] = lo.R;
    b[4] = cv.cx; b[5] = cv.cy; b[6] = cv.cz; b[7] = cv.R;
  }
  KFTables T = G;
  T.objects = objects;
  T.nodes = nodes;
  T.leaves = leaves;
  T.order = order;
  T.leaf_params = leaf_params;
  T.node_params = node_params;
  return T;
}

// The tangent frame of AO at normal n (ao_core's).
__device__ __forceinline__ void ao_frame(V3 n, V3& t1, V3& t2) {
  bool big_y = fabsf(n.y) > F(0.9);
  float hx = big_y ? 1.0f : 0.0f, hy = big_y ? 0.0f : 1.0f;
  t1 = vnormalize(V3{hy * n.z, -hx * n.z, hx * n.y - hy * n.x});
  t2 = V3{n.y * t1.z - n.z * t1.y, n.z * t1.x - n.x * t1.z,
          n.x * t1.y - n.y * t1.x};
}

// Tap tp = 4 s + tap - 1 of AO sample s: its radius, az * r and point.
__device__ __forceinline__ V3 ao_tap(const KFSettings& S, V3 q0, V3 n, V3 t1,
                                     V3 t2, int tp, float& r, float& azr) {
  const int s = tp >> 2, tap = (tp & 3) + 1;
  const float ax = AO_DIRS[s][0], ay = AO_DIRS[s][1], az = AO_DIRS[s][2];
  V3 dd{(ax * t1.x + ay * t2.x) + az * n.x,
        (ax * t1.y + ay * t2.y) + az * n.y,
        (ax * t1.z + ay * t2.z) + az * n.z};
  r = (S.ao_radius * (float)tap) * 0.25f;
  azr = az * r;
  return V3{q0.x + dd.x * r, q0.y + dd.y * r, q0.z + dd.z * r};
}

// The unbounded group's term at one tap (0 when the scene has none).
template <bool PROF, class Blk>
__device__ __forceinline__ float ao_unbounded(const Blk& B,
                                              const KFSettings& S, V3 q,
                                              float r, float azr,
                                              Prof<PROF>& P) {
  float hmin;
  return B.unbounded_min(S, q, hmin, P) ? fmaxf(azr - hmin, 0.0f) / r
                                        : 0.0f;
}

// ---------------------------------------------------------------------------
// The stages of one pixel; every lane of the warp calls each, `act` false
// for a pixel that takes no part
// ---------------------------------------------------------------------------

// Primary trace: trace_primary<false>'s body, the bounds from the block;
// u notes the lane's unres.
template <bool PROF, class Blk, class U = NoUnres>
__device__ __forceinline__ void trace_pixel(const Blk& B,
                                            const KFSettings& S, bool act,
                                            V3 o, V3 d, float t0, float& t,
                                            float& obj, int& leaf,
                                            Prof<PROF>& P, U u = U{}) {
  const KFTables& T = B.T;
  t = KF_BIG;
  obj = -1.0f;
  leaf = 0;
  for (int k = 0; k < S.n_ana; ++k) {
    const int oi = T.order[k];
    if (act) {
      int li;
      float ti = B.intersect(object_row(T, oi), o, d, S.t_min,
                             S.t_max, li);
      if (ti < t) { t = ti; obj = (float)oi; leaf = li; }
    }
    P.mark(PH_PRIMARY + kp_obj(oi));
  }
  const float t_start = fmaxf(t0, S.t_min);
  float t_clip = fminf(t, S.t_max);
  for (int k = 0; k < S.n_sdf; ++k) {
    const int oi = T.order[S.n_ana + k];
    const int* ob = object_row(T, oi);
    if (act) {
      float t1, clip2;
      if (ob[O_BOUNDABLE]) {
        bound_entry(B.cover(oi), o, d, t_start, t_clip,
                    entry_shell(T, S, ob), t1, clip2);
      } else {
        t1 = t_start;
        clip2 = t_clip;
      }
      bool hit_i = march_lane(
          S, [&](V3 p) { return B.eval(S, ob, p, 0); }, o, d, t1,
          clip2, P, PH_PRIMARY + kp_obj(oi), u);
      if (hit_i && t1 < t) { t = t1; obj = (float)oi; leaf = 0; }
      t_clip = fminf(t_clip, t);
    }
    P.mark(PH_PRIMARY + kp_obj(oi));
  }
}

// AO of one receiver, all taps and objects on its lane (ao_core<false>'s
// order; in a KF_WIDE build, as in ao_core's, the tap terms are kept, an
// object past the mask's KF_AO_MASK_BITS has its gate tested once after
// the taps, on its lower bound staged in shared memory, and a near one's
// taps are folded into the terms).
template <bool PROF, class Blk>
__device__ __forceinline__ float ao_receiver(const Blk& B,
                                             const KFSettings& S, bool act,
                                             V3 q0, V3 n, Prof<PROF>& P) {
  const KFTables& T = B.T;
  const int n_rest = S.n_ana + S.n_sdf;
  const int* rest = T.order + n_rest;
  const float gate = 2.0f * S.ao_radius;
  unsigned long long near = 0ull;
#if KF_WIDE
  for (int k = 0; k < n_rest && k < KF_AO_MASK_BITS && act; ++k) {
#else
  for (int k = 0; k < n_rest && act; ++k) {
#endif
    const int* ob = object_row(T, rest[k]);
    if (!ob[O_BOUNDABLE]) continue;
    Bound b = B.lower(rest[k]);
    float dx = q0.x - b.cx, dy = q0.y - b.cy, dz = q0.z - b.cz;
    float hb = sqrtf((dx * dx + dy * dy) + dz * dz) - b.R;
    if (hb <= gate) near |= 1ull << k;
  }
  V3 t1, t2;
  ao_frame(n, t1, t2);
  P.mark(PH_AO_SETUP);
  float occ = 0.0f;
#if KF_WIDE
  float terms[KF_MAX_AO_TAPS];
#endif
  for (int tp = 0; tp < S.ao_samples * 4; ++tp) {
    float r, azr;
    const V3 q = ao_tap(S, q0, n, t1, t2, tp, r, azr);
    float term = act ? ao_unbounded(B, S, q, r, azr, P) : 0.0f;
    P.mark(PH_AO_UNB);
#if KF_WIDE
    for (int k = 0; k < n_rest && k < KF_AO_MASK_BITS; ++k) {
#else
    for (int k = 0; k < n_rest; ++k) {
#endif
      if ((near >> k) & 1ull) {
        float h = B.eval(S, object_row(T, rest[k]), q, S.ao_lod);
        P.trip(PH_AO_OBJ + kp_obj(rest[k]));
        term = fmaxf(term, fmaxf(azr - h, 0.0f) / r);
      }
      if (!object_row(T, rest[k])[O_BOUNDABLE]) continue;
      P.mark(PH_AO_OBJ + kp_obj(rest[k]));
    }
#if KF_WIDE
    terms[tp] = term;
#else
    occ = tp == 0 ? term : occ + term;
#endif
  }
#if KF_WIDE
  // past the mask: each object's gate once (the mask loop's operations),
  // then its taps (the same q, r and azr; max is exact in any order)
  for (int k = KF_AO_MASK_BITS; k < n_rest; ++k) {
    const int* ob = object_row(T, rest[k]);
    if (!ob[O_BOUNDABLE]) continue;
    if (act && ao_near(B.lower(rest[k]), q0, gate)) {
      for (int tp = 0; tp < S.ao_samples * 4; ++tp) {
        float r, azr;
        const V3 q = ao_tap(S, q0, n, t1, t2, tp, r, azr);
        float h = B.eval(S, ob, q, S.ao_lod);
        P.trip(PH_AO_OBJ + kp_obj(rest[k]));
        terms[tp] = fmaxf(terms[tp], fmaxf(azr - h, 0.0f) / r);
      }
    }
    P.mark(PH_AO_OBJ + kp_obj(rest[k]));
  }
  for (int tp = 0; tp < S.ao_samples * 4; ++tp)
    occ = tp == 0 ? terms[0] : occ + terms[tp];
#endif
  occ = occ / (float)(S.ao_samples * 4);
  return sat(1.0f - S.ao_strength * occ);
}

// Visibility of one light for one receiver, every object on its lane
// (visibility's order); u notes the lane's unres.
template <bool PROF, class Blk, class U = NoUnres>
__device__ __forceinline__ float vis_receiver(const Blk& B,
                                              const KFSettings& S, bool act,
                                              int li, V3 o, V3 l, float dist,
                                              float kf, Prof<PROF>& P,
                                              U u = U{}) {
  const KFTables& T = B.T;
  if (S.soft_shadows) {
    const float t0 = S.soft_shadow_tmin;
    const int* ord = T.order + S.n_ana + S.n_sdf;
    float soft_vis = 1.0f;
    for (int k = 0; k < S.n_ana + S.n_sdf; ++k) {
      const int* ob = object_row(T, ord[k]);
      const int ph = kp_vis(li, ord[k]);
      const int cf = ob[O_CLOSED_FORM];
      if (act) {
        float v;
        if (cf >= 0) {
          const float* prm = first_leaf_params(T, ob);
          v = cf == LEAF_PLANE ? penumbra_plane(prm, o, l, t0, dist, kf)
                               : penumbra_sphere(prm, o, l, t0, dist, kf);
        } else {
          const float dist_i = soft_vis <= 0.0f ? 0.0f : dist;
          float t_lo = t0, t_hi = dist_i;
          if (ob[O_BOUNDABLE]) {
            influence_window(B.lower(ord[k]), o, l, t0, dist_i, kf, t_lo,
                             t_hi);
            t_lo = fmaxf(t_lo, t0);
            t_hi = fminf(dist_i, t_hi);
          }
          v = soft_lane(
              S,
              [&](V3 p) { return B.eval(S, ob, p, S.secondary_lod); },
              o, l, t_lo, t_hi, kf, P, ph, u);
        }
        soft_vis = fminf(soft_vis, v);
      }
      P.mark(ph);
    }
    return soft_vis;
  }
  float vis = 1.0f;
  for (int k = 0; k < S.n_ana; ++k) {
    if (act) {
      int leaf;
      float ti = B.intersect(object_row(T, T.order[k]), o, l, S.shadow_eps,
                             dist, leaf);
      vis = vis * (ti < dist ? 0.0f : 1.0f);
    }
    P.mark(kp_vis(li, T.order[k]));
  }
  for (int k = 0; k < S.n_sdf; ++k) {
    const int oi = T.order[S.n_ana + k];
    const int* ob = object_row(T, oi);
    if (act) {
      float dist_i = vis <= 0.0f ? 0.0f : dist;
      float t1, clip2;
      if (ob[O_BOUNDABLE]) {
        Bound b = B.cover(oi);
        if (seg_bound_dist(b, o, l, S.shadow_eps, dist) > S.exit_margin)
          dist_i = 0.0f;
        bound_entry(b, o, l, S.shadow_eps, dist_i, S.default_shell, t1,
                    clip2);
      } else {
        t1 = S.shadow_eps;
        clip2 = dist_i;
      }
      bool hit = march_lane(
          S, [&](V3 p) { return B.eval(S, ob, p, 0); }, o, l, t1,
          clip2, P, kp_vis(li, oi), u);
      vis = vis * ((hit && t1 < dist_i) ? 0.0f : 1.0f);
    }
    P.mark(kp_vis(li, oi));
  }
  return vis;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// One 16x8-pixel tile (column tx, row ty) of frame f, thread tid's pixel.
template <bool PROF>
__device__ __forceinline__ void kf_tile(const Block& B, const KFTables& G,
                                        const KFSettings& S, int tx, int ty,
                                        int f, Prof<PROF>& P) {
  const int tid = threadIdx.x;
  // the pixel's ray, primary trace, normal -> its record
  const int j = tx * 16 + (tid & 15);
  const int i = ty * 8 + (tid >> 4);
  const bool in_frame = i < S.H && j < S.W;
  V3 o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 1.0f};
  if (in_frame) camera_ray(G, S, f, i, j, o, d);
  P.mark(PH_RAY);
  float t, obj;
  int leaf;
  const float t0 = (G.t0 && in_frame)
      ? G.t0[((size_t)f * S.H + i) * S.W + j] : 0.0f;
  trace_pixel(B, S, in_frame, o, d, t0, t, obj, leaf, P);
  const bool hit = in_frame && t < KF_BIG * 0.5f;
  const float t_sane = hit ? t : 0.0f;
  const V3 p = along(o, d, t_sane);
  const V3 n = in_frame ? hit_normal<false>(B.T, S, obj, leaf, p, d)
                        : V3{0.0f, 0.0f, 1.0f};
  const float eps = S.shadow_eps;
  B.R(R_PX, tid) = p.x + n.x * eps;
  B.R(R_PY, tid) = p.y + n.y * eps;
  B.R(R_PZ, tid) = p.z + n.z * eps;
  B.R(R_NX, tid) = n.x;
  B.R(R_NY, tid) = n.y;
  B.R(R_NZ, tid) = n.z;
  B.R(R_DX, tid) = d.x;
  B.R(R_DY, tid) = d.y;
  B.R(R_DZ, tid) = d.z;
  B.R(R_OBJ, tid) = obj;
  B.R(R_T, tid) = t_sane;
  B.R(R_HIT, tid) = hit ? 1.0f : 0.0f;
  B.R(R_AO, tid) = 1.0f;
  P.mark(PH_NORMAL);

  // AO, then the ambient term
  if (S.ao && S.n_objects > 0) {
    const float ao = ao_receiver(B, S, hit, B.rec3(R_PX, tid),
                                 B.rec3(R_NX, tid), P);
    if (hit) B.R(R_AO, tid) = ao;
  }
  if (hit) {
    const float ao = B.R(R_AO, tid);
    const float* mat = B.material(G, tid);
    B.R(R_R, tid) = mat[3] * mat[0] * G.ambient[0] * ao;
    B.R(R_G, tid) = mat[3] * mat[1] * G.ambient[1] * ao;
    B.R(R_B, tid) = mat[3] * mat[2] * G.ambient[2] * ao;
  }
  P.mark(PH_AO_SUM);

  // visibility and shading, light by light
  for (int li = 0; li < S.n_lights; ++li) {
    const float* lrow = G.lights + li * KF_LIGHT_W;
    V3 l{0.0f, 0.0f, 0.0f};
    float dist = 0.0f, kf = 0.0f;
    if (hit) B.light_of(G, S, tid, li, l, dist, kf);
    float vis = 1.0f;
    if (S.shadows)
      vis = vis_receiver(B, S, hit, li, B.rec3(R_PX, tid), l, dist, kf, P);
    if (hit) {
      // the light again from the record: nothing of it stays live across
      // the marches
      B.light_of(G, S, tid, li, l, dist, kf);
      const float* mat = B.material(G, tid);
      const int shin = object_row(B.T, (int)B.R(R_OBJ, tid))[O_SHIN];
      const V3 v{-B.R(R_DX, tid), -B.R(R_DY, tid), -B.R(R_DZ, tid)};
      float r = B.R(R_R, tid), g = B.R(R_G, tid), b = B.R(R_B, tid);
      add_light(mat, shin, lrow, B.rec3(R_NX, tid), l, v, vis, r, g, b);
      B.R(R_R, tid) = r;
      B.R(R_G, tid) = g;
      B.R(R_B, tid) = b;
    }
    P.mark(PH_SHADE);
  }

  // the nine planes from the record
  if (in_frame) {
    const bool h = B.R(R_HIT, tid) > 0.5f;
    write_pixel(G.out + ((size_t)f * S.H + i) * S.W + j,
                (size_t)S.F * S.H * S.W,
                h ? B.R(R_R, tid) : 0.0f + S.bg_r,
                h ? B.R(R_G, tid) : 0.0f + S.bg_g,
                h ? B.R(R_B, tid) : 0.0f + S.bg_b, B.R(R_T, tid),
                B.R(R_OBJ, tid), B.rec3(R_NX, tid), h ? 1.0f : 0.0f);
  }
  P.mark(PH_WRITE);
}

// The kernel: the block stages the scene, then takes tiles from `work`
// until none is left.
template <bool PROF>
__global__ void __launch_bounds__(KS_THREADS)
kf_staged_kernel(const KFTables G, const KFSettings S, const KSLayout L,
                 unsigned long long* prof, int* work) {
  unsigned char* sm = ks_smem;
  const int tid = threadIdx.x;
  const int gx = (S.W + 15) / 16, gy = (S.H + 7) / 8;
  Prof<PROF> P;

  int* item_slot = (int*)(sm + L.ctr);
  Block B;
  B.T = stage_scene(G, S, L, sm);
  B.bounds = (const float*)(sm + L.bounds);
  B.rec = (float*)(sm + L.rec);
  __syncthreads();

  const int n_items = gx * gy * S.F;
  for (;;) {
    if (tid == 0) *item_slot = atomicAdd(work, 1);
    __syncthreads();
    const int item = *item_slot;
    __syncthreads();
    if (item >= n_items) break;
    P.begin(prof, item);
    kf_tile(B, G, S, item % gx, (item / gx) % gy, item / (gx * gy), P);
  }
}

#ifdef __CUDACC__
// Launch as many blocks as the card holds at once (at most one per tile),
// taking tiles from work (one int, zeroed by the caller).
template <bool PROF>
static int ks_launch(const KFTables& T, const KFSettings& S,
                     const KSLayout& L, unsigned long long* prof, int* work,
                     cudaStream_t stream) {
  if (!work) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (L.bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kf_staged_kernel<PROF>,
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
        &per_sm, kf_staged_kernel<PROF>, KS_THREADS, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((S.W + 15) / 16) * ((S.H + 7) / 8) *
                          S.F;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  kf_staged_kernel<PROF><<<grid, KS_THREADS, L.bytes, stream>>>(T, S, L,
                                                                prof, work);
  return (int)cudaGetLastError();
}
#endif
