// Device side shared by the fused-frame kernel (frame_fused.cu, whose
// design note covers the scene tables) and the split-path kernels
// (split_path.cu): primary trace, normals, AO and light visibility. Every
// function here is the per-lane arithmetic of the PyTorch plain versions
// in surfjax_torch/kernels/render_tile.py, written in the same association
// order; the sources are built with -fmad=false and without fast math, so
// each float operation rounds exactly as the plain version's does.
#pragma once

#include <cuda_runtime.h>

// Fixed per-thread bounds; the Python wrapper raises above them.
#define KF_MAX_NODES 32        // tape value array (MAX_TAPE_NODES)
#define KF_MAX_LEAVES 16       // event-CSG intervals (MAX_ANALYTIC_LEAVES)
#define KF_MAX_OBJECTS 64      // AO near-object bit mask (MAX_OBJECTS):
                               // the objects outside the crowd
#define KF_MAX_AO_TAPS 36      // 9 AO directions x 4 taps

// Row widths of the host-packed tables (render_tile.pack_scene).
#define KF_OBJ_W 12
#define KF_CROWD_W 8
#define KF_NODE_W 5
#define KF_LEAF_W 5
#define KF_LEAF_PARAM_W 8
#define KF_LIGHT_W 7
#define KF_MAT_W 9

// A float32 constant rounded the way numpy rounds a Python float
// (decimal -> double -> float), as the twin's f32() does.
#define F(x) ((float)(x))

enum { LEAF_SPHERE = 0, LEAF_PLANE = 1, LEAF_BOX = 2, LEAF_MANDELBULB = 3 };
enum { OP_LEAF = 0, OP_UNION = 1, OP_INTERSECT = 2, OP_SUBTRACT = 3,
       OP_SMOOTH_UNION = 4, OP_SMOOTH_INTERSECT = 5, OP_SMOOTH_SUBTRACT = 6 };
enum { ENGINE_ANALYTIC = 0, ENGINE_SDF = 1, ENGINE_MESH = 2 };
enum { LIGHT_POINT = 0 };
// Columns of an object row.
enum { O_ENGINE = 0, O_MAT, O_SHIN, O_NODE0, O_NNODES, O_LEAF0, O_NLEAVES,
       O_BOUNDABLE, O_CLOSED_FORM, O_BULB_SHELL,
       O_CROWD,         // the object's crowd member row, -1 outside the crowd
       O_PROXY_BOUND }; // the priming proxy takes its lower-bound sphere
// Columns of a crowd row: crowd_meta's six, then the member's type and its
// tag (is_sphere for a single; is_sphere0 | is_sphere1 << 1 | op << 2 for a
// pair). Members [0, crowd_sdf_end) are SDF singles, up to crowd_single_end
// analytic singles, the rest SDF pairs; spheres come before boxes.
enum { C_SLOT0 = 0, C_OBJ, C_MAT, C_SHIN_GROUP, C_SLOT1, C_PSLOT, C_TYPE,
       C_TAG };
enum { CROWD_SDF = 0, CROWD_ANALYTIC = 1, CROWD_PAIR = 2 };

// Device pointers, one struct by value (render_tile.KFTables).
struct KFTables {
  const int* objects;       // (n_objects, KF_OBJ_W), meshes included
  const int* nodes;         // (total nodes, KF_NODE_W): op, a, b, leaf, pslot
  const int* leaves;        // (total leaves, KF_LEAF_W): kind slot sign p0 p1
  const int* order;         // of the objects outside the crowd: analytic,
                            // SDF by nodes, both by nodes
  const int* light_kinds;   // (n_lights,)
  const int* crowd;         // (max(1, n_crowd), KF_CROWD_W)
  const float* leaf_params; // (n_leaf_rows, 8)
  const float* node_params; // (n_k, 1) smooth-op k
  const float* lights;      // (n_lights, 7)
  const float* materials;   // (n_mats, 9)
  const float* ambient;     // (3,)
  const float* cam_rows;    // (F, 12): R_flat(9), position(3); KF only
  const float* t0;          // (F, H, W) primed march starts or null; KF only
  float* out;               // (9, F, H, W): r g b depth obj nx ny nz hit;
                            // KF only
};

// Settings by value (render_tile.KFSettings); floats already rounded to f32.
// n_objects counts mesh objects and crowd members too; n_ana + n_sdf are
// the non-mesh objects outside the crowd (the split path intersects meshes
// in mesh_tile.cu).
struct KFSettings {
  int F, H, W, n_objects, n_ana, n_sdf, n_lights;
  int max_steps, shadow_steps, shadows, soft_shadows, ao, ao_samples;
  int normals_fd, relaxed, bulb_cheb, bulb_portable, secondary_lod, ao_lod;
  int n_crowd, crowd_sdf_end, crowd_single_end;
  float fx, fy, cx, cy, t_min, t_max, hit_eps, hit_eps_scale, over_relax;
  float normal_eps, soft_shadow_k, soft_shadow_tmin, shadow_eps, ao_radius;
  float ao_strength, exit_margin, default_shell, bg_r, bg_g, bg_b;
};

// Flat ray arrays of one split-path launch (render_tile.SplitRays).
struct SplitRays {
  const float* in[8];
  float* out[8];
  int n;
};

struct V3 { float x, y, z; };
struct Bound { float cx, cy, cz, R; };

#define KF_BIG F(1e30)

__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 vnormalize(V3 a) {
  float inv = 1.0f / sqrtf(vdot(a, a));
  return V3{a.x * inv, a.y * inv, a.z * inv};
}
__device__ __forceinline__ V3 along(V3 o, V3 d, float t) {
  return V3{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
}
__device__ __forceinline__ float sat(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---------------------------------------------------------------------------
// Leaf SDFs and the Mandelbulb DE
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sdf_sphere(const float* prm, V3 p) {
  V3 q{p.x - prm[0], p.y - prm[1], p.z - prm[2]};
  return sqrtf(vdot(q, q)) - prm[3];
}

__device__ __forceinline__ float sdf_plane(const float* prm, V3 p) {
  return ((prm[0] * p.x + prm[1] * p.y) + prm[2] * p.z) - prm[3];
}

__device__ __forceinline__ float sdf_box(const float* prm, V3 p) {
  float qx = fabsf(p.x - prm[0]) - prm[3];
  float qy = fabsf(p.y - prm[1]) - prm[4];
  float qz = fabsf(p.z - prm[2]) - prm[5];
  float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
  float outside = sqrtf((ox * ox + oy * oy) + oz * oz);
  float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
  return outside + inside;
}

// Bitwise-portable log (surfjax core/math.py::portable_log), op for op.
__device__ __forceinline__ float portable_log(float x) {
  int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xFF) - 126;
  float f = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
  if (f < F(0.7071067811865476)) { f = f + f; e = e - 1; }
  float ef = (float)e;
  float u = f - 1.0f;
  float g = F(-0.07866667956113815);
  g = g * u + F(0.12821748852729797);
  g = g * u + F(-0.131016343832016);
  g = g * u + F(0.1418900042772293);
  g = g * u + F(-0.1662759929895401);
  g = g * u + F(0.2000196874141693);
  g = g * u + F(-0.2500077188014984);
  g = g * u + F(0.33333322405815125);
  g = g * u + F(-0.4999999701976776);
  float u2 = u * u;
  float l1p = u + u2 * g;
  return ef * F(0.6931457519531250) + (l1p + ef * F(1.4286067653301955e-06));
}

// One power-8 update of the DE orbit (w, dz, m) around the seed p, in the
// expanded ("std") or the restructured ("cheb") form; the caller has checked
// m <= bailout2. rsqrt is an exact 1/sqrtf. bulb_de below and the FP32
// roofline probe (fp32_peak.cu) both run exactly this.
__device__ __forceinline__ void bulb_substep(int cheb, float px, float py,
                                             float pz, float& wx, float& wy,
                                             float& wz, float& dz, float& m) {
  const float tiny = F(1e-4);
  float m2 = m * m;
  float m4 = m2 * m2;
  float dz_new = 8.0f * ((m4 * (1.0f / sqrtf(fmaxf(m, F(1e-30))))) * dz)
      + 1.0f;
  float x = wx, y = wy, z = wz;
  float x2 = x * x, y2 = y * y, z2 = z * z;
  float y4 = y2 * y2;
  float k3 = x2 + z2;
  float k3s = fmaxf(k3, tiny);
  float k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s);
  float k2 = 1.0f / sqrtf(k37);
  float k4 = (x2 - y2) + z2;
  float nx, ny, nz;
  if (cheb) {
    float t13 = k3 - 3.0f * y2;
    float k1 = t13 * t13 - 8.0f * y4;
    float a1 = x2 - z2;
    float b1 = 2.0f * (x * z);
    float a2 = a1 * a1 - b1 * b1;
    float b2 = 2.0f * (a1 * b1);
    float re8 = a2 * a2 - b2 * b2;
    float im8 = 2.0f * (a2 * b2);
    float s8 = ((8.0f * y) * k4) * (k1 * k2);
    nx = px + s8 * im8;
    ny = py + (-16.0f * (y2 * k3) * (k4 * k4) + k1 * k1);
    nz = pz - s8 * re8;
  } else {
    float x4 = x2 * x2, z4 = z2 * z2;
    float k1 = ((x4 + y4) + z4) - 6.0f * (y2 * z2)
        - 6.0f * (x2 * y2) + 2.0f * (z2 * x2);
    nx = px + 64.0f * ((((x * y) * z) * (x2 - z2)) * k4)
        * ((x4 - 6.0f * (x2 * z2)) + z4) * k1 * k2;
    ny = py + (-16.0f * (y2 * k3) * (k4 * k4) + k1 * k1);
    nz = pz + -8.0f * (y * k4)
        * ((((x4 * x4) - 28.0f * ((x4 * x2) * z2)) + 70.0f * (x4 * z4))
           - 28.0f * ((x2 * z2) * z4) + (z4 * z4)) * k1 * k2;
  }
  wx = nx; wy = ny; wz = nz; dz = dz_new;
  m = (wx * wx + wy * wy) + wz * wz;
}

// Power-8 Mandelbulb DE, early-exit form: at most `iterations` updates,
// stopping once the orbit escapes.
static __device__ __noinline__ float bulb_de(const float* prm, V3 p, int iterations,
                                      int cheb, int portable) {
  float scale = prm[3];
  float bailout2 = prm[4] * prm[4] * 16.0f;
  float inv_s = 1.0f / scale;
  float px = (p.x - prm[0]) * inv_s;
  float py = (p.y - prm[1]) * inv_s;
  float pz = (p.z - prm[2]) * inv_s;
  float m0 = (px * px + py * py) + pz * pz;
  float wx = px, wy = py, wz = pz, dz = 1.0f, m = m0;
  for (int it = 0; it < iterations; ++it) {
    if (!(m <= bailout2)) break;
    bulb_substep(cheb, px, py, pz, wx, wy, wz, dz, m);
  }
  float r = sqrtf(m);
  float mg = fmaxf(m, F(1e-30));
  float lg = portable ? portable_log(mg) : logf(mg);
  float de = 0.25f * lg * r / dz;
  float far = sqrtf(m0) - F(1.35);
  if (far > 0.0f) de = fminf(de, far + F(0.1));
  return de * scale;
}

// One leaf; cap > 0 limits fractal iterations (secondary-ray LoD).
__device__ __forceinline__ float eval_leaf(const KFSettings& S, int kind,
                                           const float* prm, V3 p, int p1,
                                           int cap) {
  switch (kind) {
    case LEAF_SPHERE: return sdf_sphere(prm, p);
    case LEAF_PLANE: return sdf_plane(prm, p);
    case LEAF_BOX: return sdf_box(prm, p);
    default: {
      int iters = (cap > 0 && cap < p1) ? cap : p1;
      return bulb_de(prm, p, iters, S.bulb_cheb, S.bulb_portable);
    }
  }
}

// The object's post-order CSG tape, interpreted per thread.
static __device__ __noinline__ float eval_obj(const KFTables& T, const KFSettings& S,
                                       const int* ob, V3 p, int cap) {
  float vals[KF_MAX_NODES];
  const int n0 = ob[O_NODE0], nn = ob[O_NNODES], l0 = ob[O_LEAF0];
  for (int k = 0; k < nn; ++k) {
    const int* nd = T.nodes + (n0 + k) * KF_NODE_W;
    const int op = nd[0];
    float v;
    if (op == OP_LEAF) {
      const int* lf = T.leaves + (l0 + nd[3]) * KF_LEAF_W;
      v = eval_leaf(S, lf[0], T.leaf_params + lf[1] * KF_LEAF_PARAM_W, p,
                    lf[4], cap);
    } else {
      const float a = vals[nd[1]], b = vals[nd[2]];
      if (op == OP_UNION) {
        v = fminf(a, b);
      } else if (op == OP_INTERSECT) {
        v = fmaxf(a, b);
      } else if (op == OP_SUBTRACT) {
        v = fmaxf(a, -b);
      } else {
        const float k = T.node_params[nd[4]];
        if (op == OP_SMOOTH_UNION) {
          float h = sat(0.5f + 0.5f * (b - a) / k);
          v = (b + (a - b) * h) - k * h * (1.0f - h);
        } else if (op == OP_SMOOTH_INTERSECT) {
          float h = sat(0.5f - 0.5f * (b - a) / k);
          v = (b + (a - b) * h) + k * h * (1.0f - h);
        } else {
          float h = sat(0.5f - 0.5f * (b + a) / k);
          v = (a + (-b - a) * h) + k * h * (1.0f - h);
        }
      }
    }
    vals[k] = v;
  }
  return vals[nn - 1];
}

// ---------------------------------------------------------------------------
// Analytic engine: leaf intervals and event CSG
// ---------------------------------------------------------------------------

__device__ __forceinline__ void leaf_interval(int kind, const float* prm,
                                              V3 o, V3 d, float& t0,
                                              float& t1) {
  if (kind == LEAF_SPHERE) {
    V3 oc{o.x - prm[0], o.y - prm[1], o.z - prm[2]};
    float b = vdot(oc, d);
    float c = vdot(oc, oc) - prm[3] * prm[3];
    float disc = b * b - c;
    bool has = disc >= 0.0f;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float s = b >= 0.0f ? 1.0f : -1.0f;
    float q = -(b + s * sq);
    float r1 = q != 0.0f ? c / q : -b;
    t0 = has ? fminf(q, r1) : KF_BIG;
    t1 = has ? fmaxf(q, r1) : -KF_BIG;
  } else if (kind == LEAF_PLANE) {
    V3 n{prm[0], prm[1], prm[2]};
    float off = prm[3];
    float denom = vdot(n, d);
    float no = vdot(n, o);
    float safe = denom == 0.0f ? 1.0f : denom;
    float t_star = (off - no) / safe;
    bool inside = (no - off) < 0.0f;
    t0 = denom < 0.0f ? t_star : -KF_BIG;
    t1 = denom < 0.0f ? KF_BIG : t_star;
    if (denom == 0.0f) {
      t0 = inside ? -KF_BIG : KF_BIG;
      t1 = inside ? KF_BIG : -KF_BIG;
    }
  } else {  // box
    float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
    t0 = -KF_BIG;
    t1 = KF_BIG;
    for (int ax = 0; ax < 3; ++ax) {
      const float c = prm[ax], h = prm[3 + ax];
      bool dz = dd[ax] == 0.0f;
      float safe = dz ? 1.0f : dd[ax];
      float inv = 1.0f / safe;
      float lo = (c - h - oo[ax]) * inv;
      float hi = (c + h - oo[ax]) * inv;
      float tn = fminf(lo, hi), tf = fmaxf(lo, hi);
      if (dz) {
        bool in_slab = fabsf(oo[ax] - c) <= h;
        tn = in_slab ? -KF_BIG : KF_BIG;
        tf = in_slab ? KF_BIG : -KF_BIG;
      }
      t0 = fmaxf(t0, tn);
      t1 = fminf(t1, tf);
    }
    if (t0 > t1) { t0 = KF_BIG; t1 = -KF_BIG; }
  }
}

// Boolean tape over per-leaf inside bits -> the root's value.
__device__ __forceinline__ bool eval_tree(const KFTables& T, const int* ob,
                                          unsigned status) {
  unsigned v = 0u;
  const int n0 = ob[O_NODE0], nn = ob[O_NNODES];
  for (int k = 0; k < nn; ++k) {
    const int* nd = T.nodes + (n0 + k) * KF_NODE_W;
    unsigned r;
    if (nd[0] == OP_LEAF) {
      r = (status >> nd[3]) & 1u;
    } else {
      unsigned a = (v >> nd[1]) & 1u, b = (v >> nd[2]) & 1u;
      r = nd[0] == OP_UNION ? (a | b)
          : nd[0] == OP_INTERSECT ? (a & b) : (a & (b ^ 1u));
    }
    v |= r << k;
  }
  return (v >> (nn - 1)) & 1u;
}

// Nearest hit of one analytic object in (t_min, t_max) -> t (BIG on miss).
static __device__ __noinline__ float intersect_analytic(const KFTables& T,
                                                 const int* ob, V3 o, V3 d,
                                                 float t_min, float t_max,
                                                 int& leaf_out) {
  const int nl = ob[O_NLEAVES], l0 = ob[O_LEAF0];
  float i0[KF_MAX_LEAVES], i1[KF_MAX_LEAVES];
  for (int li = 0; li < nl; ++li) {
    const int* lf = T.leaves + (l0 + li) * KF_LEAF_W;
    leaf_interval(lf[0], T.leaf_params + lf[1] * KF_LEAF_PARAM_W, o, d,
                  i0[li], i1[li]);
  }
  leaf_out = 0;
  if (nl == 1 && ob[O_NNODES] == 1) {
    bool e0 = (i0[0] > t_min) && (i0[0] < t_max);
    bool e1 = (i1[0] > t_min) && (i1[0] < t_max);
    return e0 ? i0[0] : (e1 ? i1[0] : KF_BIG);
  }
  float t_best = KF_BIG;
  for (int li = 0; li < nl; ++li) {
    for (int ep = 0; ep < 2; ++ep) {
      const float t_e = ep ? i1[li] : i0[li];
      unsigned before = 0u, after = 0u;
      for (int lj = 0; lj < nl; ++lj) {
        if (lj == li) {
          before |= (unsigned)(ep == 1) << lj;
          after |= (unsigned)(ep != 1) << lj;
        } else {
          unsigned in = (i0[lj] < t_e) && (t_e < i1[lj]);
          before |= in << lj;
          after |= in << lj;
        }
      }
      bool flip = eval_tree(T, ob, before) != eval_tree(T, ob, after);
      if (flip && t_e > t_min && t_e < t_max && t_e < t_best) {
        t_best = t_e;
        leaf_out = li;
      }
    }
  }
  return t_best;
}

__device__ __forceinline__ V3 leaf_normal(int kind, const float* prm, V3 p) {
  if (kind == LEAF_SPHERE) {
    return vnormalize(V3{p.x - prm[0], p.y - prm[1], p.z - prm[2]});
  }
  if (kind == LEAF_PLANE) {
    return V3{prm[0] * 1.0f, prm[1] * 1.0f, prm[2] * 1.0f};
  }
  float qx = p.x - prm[0], qy = p.y - prm[1], qz = p.z - prm[2];
  float dx = fabsf(qx) - prm[3], dy = fabsf(qy) - prm[4];
  float dz = fabsf(qz) - prm[5];
  float sx = qx >= 0.0f ? 1.0f : -1.0f, sy = qy >= 0.0f ? 1.0f : -1.0f;
  float sz = qz >= 0.0f ? 1.0f : -1.0f;
  bool x_wins = (dx >= dy) && (dx >= dz);
  bool y_wins = !x_wins && (dy >= dz);
  return V3{x_wins ? sx : 0.0f, y_wins ? sy : 0.0f,
            (x_wins || y_wins) ? 0.0f : sz};
}

// ---------------------------------------------------------------------------
// Bounds, bound entry, marches
// ---------------------------------------------------------------------------

// Bounding sphere of a boundable SDF object. lower: the pointwise lower
// bound; otherwise the hit-region cover valid up to `margin`.
static __device__ __noinline__ Bound object_bound(const KFTables& T, const int* ob,
                                           int lower, float margin) {
  const int nl = ob[O_NLEAVES], l0 = ob[O_LEAF0];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int li = 0; li < nl; ++li) {
    const float* prm = T.leaf_params +
        T.leaves[(l0 + li) * KF_LEAF_W + 1] * KF_LEAF_PARAM_W;
    sx = sx + prm[0];
    sy = sy + prm[1];
    sz = sz + prm[2];
  }
  const float inv_n = (float)(1.0 / (double)nl);
  const float cx = sx * inv_n, cy = sy * inv_n, cz = sz * inv_n;
  float R = 0.0f;
  for (int li = 0; li < nl; ++li) {
    const int* lf = T.leaves + (l0 + li) * KF_LEAF_W;
    const float* prm = T.leaf_params + lf[1] * KF_LEAF_PARAM_W;
    float br;
    if (lf[0] == LEAF_SPHERE) {
      br = prm[3];
    } else if (lf[0] == LEAF_BOX) {
      br = sqrtf((prm[3] * prm[3] + prm[4] * prm[4]) + prm[5] * prm[5]);
    } else if (lower) {
      br = prm[3] * F(1.39);
    } else {
      br = F(0.045) * prm[3] >= margin ? prm[3] * F(1.3)
                                       : prm[3] * F(1.39) + margin;
    }
    float dx = prm[0] - cx, dy = prm[1] - cy, dz = prm[2] - cz;
    float rr = sqrtf((dx * dx + dy * dy) + dz * dz) + br;
    R = li == 0 ? rr : fmaxf(R, rr);
  }
  float k_margin = 0.0f;
  const int n0 = ob[O_NODE0], nn = ob[O_NNODES];
  for (int k = 0; k < nn; ++k) {
    const int pslot = T.nodes[(n0 + k) * KF_NODE_W + 4];
    if (pslot >= 0) k_margin = k_margin + T.node_params[pslot] * 0.25f;
  }
  return Bound{cx, cy, cz, R + k_margin};
}

// Entry shell of a primary march: thin for a validated single bulb leaf.
__device__ __forceinline__ float entry_shell(const KFTables& T,
                                             const KFSettings& S,
                                             const int* ob) {
  if (!ob[O_BULB_SHELL]) return S.default_shell;
  const float* prm = T.leaf_params +
      T.leaves[ob[O_LEAF0] * KF_LEAF_W + 1] * KF_LEAF_PARAM_W;
  bool valid = (fabsf(prm[4] - 2.0f) < F(1e-6)) &&
               (F(0.045) * prm[3] >= S.exit_margin);
  return valid ? S.exit_margin : S.default_shell;
}

__device__ __forceinline__ void bound_entry(Bound b, V3 o, V3 d,
                                            float t_start, float t_clip,
                                            float shell, float& t1,
                                            float& clip2) {
  float Re = b.R + shell;
  float wx = b.cx - o.x, wy = b.cy - o.y, wz = b.cz - o.z;
  float pb = (wx * d.x + wy * d.y) + wz * d.z;
  float w2 = (wx * wx + wy * wy) + wz * wz;
  float disc = pb * pb - (w2 - Re * Re);
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_in = pb - sq, t_out = pb + sq;
  bool none = (disc < 0.0f) || (t_out <= t_start);
  t1 = none ? t_clip : fmaxf(t_in, t_start);
  clip2 = none ? t_clip : fminf(t_clip, t_out);
}

// Bounded (over-relaxed) sphere march along o + t*d of the SDF `sdf`;
// returns hit, t in t.
template <class Sdf>
__device__ __forceinline__ bool march_loop(const KFSettings& S, Sdf sdf,
                                           V3 o, V3 d, float& t,
                                           float t_clip) {
  bool done = t >= t_clip, hit = false;
  float h_prev = 0.0f, st_prev = 0.0f;
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
  }
  return hit;
}

// Penumbra march of the SDF `sdf` over [t, t_max] -> visibility in [0, 1].
template <class Sdf>
__device__ __forceinline__ float soft_march_loop(const KFSettings& S, Sdf sdf,
                                                 V3 o, V3 l, float t,
                                                 float t_max, float kf) {
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
  }
  return clampf(res, 0.0f, 1.0f);
}

// The marches of one object, through its tape.
static __device__ __noinline__ bool march(const KFTables& T, const KFSettings& S,
                                   const int* ob, V3 o, V3 d, float& t,
                                   float t_clip) {
  return march_loop(S, [&](V3 p) { return eval_obj(T, S, ob, p, 0); }, o, d,
                    t, t_clip);
}

static __device__ __noinline__ float soft_march(const KFTables& T,
                                         const KFSettings& S, const int* ob,
                                         V3 o, V3 l, float t, float t_max,
                                         float kf) {
  return soft_march_loop(
      S, [&](V3 p) { return eval_obj(T, S, ob, p, S.secondary_lod); }, o, l,
      t, t_max, kf);
}

// ---------------------------------------------------------------------------
// The crowd: one member of the member loops (render_tile.py, "The crowd").
// A member's SDF and bound come straight from its leaf rows, not through
// the tape walker; the arithmetic is the tape's for the same object.
// ---------------------------------------------------------------------------

struct CrowdMember {
  const float* prm0;
  const float* prm1;   // the second leaf of a pair
  float k;             // blend radius of a smooth pair
  float obj;           // object index, as the trace carries it
  int type;            // CROWD_SDF, CROWD_ANALYTIC or CROWD_PAIR
  bool s0, s1;         // leaf 0 / leaf 1 is a sphere (else a box)
  int op;              // a pair's CSG op
};

__device__ __forceinline__ CrowdMember crowd_member(const KFTables& T,
                                                    int j) {
  const int* row = T.crowd + j * KF_CROWD_W;
  CrowdMember m;
  m.prm0 = T.leaf_params + row[C_SLOT0] * KF_LEAF_PARAM_W;
  m.prm1 = T.leaf_params + row[C_SLOT1] * KF_LEAF_PARAM_W;
  m.obj = (float)row[C_OBJ];
  m.type = row[C_TYPE];
  const int tag = row[C_TAG];
  m.s0 = tag & 1;
  m.s1 = (tag >> 1) & 1;
  m.op = m.type == CROWD_PAIR ? tag >> 2 : OP_LEAF;
  m.k = m.op >= OP_SMOOTH_UNION ? T.node_params[row[C_PSLOT]] : 0.0f;
  return m;
}

__device__ __forceinline__ float crowd_leaf(const float* prm, bool sphere,
                                            V3 p) {
  return sphere ? sdf_sphere(prm, p) : sdf_box(prm, p);
}

__device__ __forceinline__ float crowd_sdf(const CrowdMember& m, V3 p) {
  const float a = crowd_leaf(m.prm0, m.s0, p);
  if (m.op == OP_LEAF) return a;
  const float b = crowd_leaf(m.prm1, m.s1, p);
  const float k = m.k;
  switch (m.op) {
    case OP_UNION: return fminf(a, b);
    case OP_INTERSECT: return fmaxf(a, b);
    case OP_SUBTRACT: return fmaxf(a, -b);
    case OP_SMOOTH_UNION: {
      float h = sat(0.5f + 0.5f * (b - a) / k);
      return (b + (a - b) * h) - k * h * (1.0f - h);
    }
    case OP_SMOOTH_INTERSECT: {
      float h = sat(0.5f - 0.5f * (b - a) / k);
      return (b + (a - b) * h) + k * h * (1.0f - h);
    }
    default: {
      float h = sat(0.5f - 0.5f * (b + a) / k);
      return (a + (-b - a) * h) + k * h * (1.0f - h);
    }
  }
}

__device__ __forceinline__ Bound crowd_leaf_bound(const float* prm,
                                                  bool sphere) {
  const float r = sphere ? prm[3]
      : sqrtf((prm[3] * prm[3] + prm[4] * prm[4]) + prm[5] * prm[5]);
  return Bound{prm[0], prm[1], prm[2], r};
}

// Bounding sphere of a member: the leaf's own, or for a pair the mean
// centre, the larger leaf reach and k/4 for a smooth op (object_bound's
// arithmetic for a two-leaf tape). Cover and lower bound at once.
__device__ __forceinline__ Bound crowd_bound(const CrowdMember& m) {
  const Bound b0 = crowd_leaf_bound(m.prm0, m.s0);
  if (m.op == OP_LEAF) return b0;
  const Bound b1 = crowd_leaf_bound(m.prm1, m.s1);
  const float cx = (b0.cx + b1.cx) * 0.5f, cy = (b0.cy + b1.cy) * 0.5f;
  const float cz = (b0.cz + b1.cz) * 0.5f;
  float dx = b0.cx - cx, dy = b0.cy - cy, dz = b0.cz - cz;
  float R = sqrtf((dx * dx + dy * dy) + dz * dz) + b0.R;
  dx = b1.cx - cx; dy = b1.cy - cy; dz = b1.cz - cz;
  R = fmaxf(R, sqrtf((dx * dx + dy * dy) + dz * dz) + b1.R);
  if (m.op >= OP_SMOOTH_UNION) R = R + m.k * 0.25f;
  return Bound{cx, cy, cz, R};
}

static __device__ __noinline__ bool crowd_march(const KFSettings& S,
                                                const CrowdMember& m, V3 o,
                                                V3 d, float& t, float t_clip) {
  return march_loop(S, [&](V3 p) { return crowd_sdf(m, p); }, o, d, t,
                    t_clip);
}

static __device__ __noinline__ float crowd_soft_march(const KFSettings& S,
                                                      const CrowdMember& m,
                                                      V3 o, V3 l, float t,
                                                      float t_max, float kf) {
  return soft_march_loop(S, [&](V3 p) { return crowd_sdf(m, p); }, o, l, t,
                         t_max, kf);
}

// Nearest boundary of a member's single sphere/box leaf in (t_min, t_max),
// KF_BIG on a miss: intersect_analytic's single-leaf case.
__device__ __forceinline__ float crowd_exact_t(const CrowdMember& m, V3 o,
                                               V3 d, float t_min,
                                               float t_max) {
  float i0, i1;
  leaf_interval(m.s0 ? LEAF_SPHERE : LEAF_BOX, m.prm0, o, d, i0, i1);
  bool e0 = (i0 > t_min) && (i0 < t_max);
  bool e1 = (i1 > t_min) && (i1 < t_max);
  return e0 ? i0 : (e1 ? i1 : KF_BIG);
}

// ---------------------------------------------------------------------------
// Closed-form penumbrae and shadow-segment gates
// ---------------------------------------------------------------------------

__device__ __forceinline__ float penumbra_plane(const float* prm, V3 o, V3 l,
                                                float t0, float t_max,
                                                float kf) {
  float a = ((prm[0] * o.x + prm[1] * o.y) + prm[2] * o.z) - prm[3];
  float b = (prm[0] * l.x + prm[1] * l.y) + prm[2] * l.z;
  float tm = fmaxf(t_max, t0);
  float f0 = kf * (a + b * t0) / t0;
  float f1 = kf * (a + b * tm) / tm;
  float res = t_max <= t0 ? 1.0f : fminf(f0, f1);
  return clampf(res, 0.0f, 1.0f);
}

__device__ __forceinline__ float pen_sphere_f(float t, float A, float b,
                                              float R, float kf) {
  float s = sqrtf(fmaxf((t - b) * t + (A - b * t), 0.0f));
  return kf * (s - R) / t;
}

__device__ __forceinline__ float penumbra_sphere(const float* prm, V3 o,
                                                 V3 l, float t0, float t_max,
                                                 float kf) {
  const float R = prm[3];
  float wx = prm[0] - o.x, wy = prm[1] - o.y, wz = prm[2] - o.z;
  float A = (wx * wx + wy * wy) + wz * wz;
  float b = (wx * l.x + wy * l.y) + wz * l.z;
  float tm = fmaxf(t_max, t0);
  float qa = b * b - R * R;
  float qb = b * (R * R - A);
  float qc = A * (A - R * R);
  float disc = qb * qb - qa * qc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float safe_qa = fabsf(qa) < F(1e-12) ? F(1e-12) : qa;
  float r1 = clampf((-qb - sq) / safe_qa, t0, tm);
  float r2 = clampf((-qb + sq) / safe_qa, t0, tm);
  if (!(disc >= 0.0f)) { r1 = t0; r2 = t0; }
  float res = fminf(fminf(pen_sphere_f(t0, A, b, R, kf),
                          pen_sphere_f(tm, A, b, R, kf)),
                    fminf(pen_sphere_f(r1, A, b, R, kf),
                          pen_sphere_f(r2, A, b, R, kf)));
  if (t_max <= t0) res = 1.0f;
  return clampf(res, 0.0f, 1.0f);
}

__device__ __forceinline__ void influence_window(Bound bd, V3 o, V3 l,
                                                 float t0, float t_max,
                                                 float kf, float& t_lo,
                                                 float& t_hi) {
  float wx = bd.cx - o.x, wy = bd.cy - o.y, wz = bd.cz - o.z;
  float A = (wx * wx + wy * wy) + wz * wz;
  float bb = (wx * l.x + wy * l.y) + wz * l.z;
  float inv_k = 1.0f / kf;
  float qa = 1.0f - inv_k * inv_k;
  float qb = -(bb + bd.R * inv_k);
  float qc = A - bd.R * bd.R;
  float disc = qb * qb - qa * qc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float safe_qa = fmaxf(qa, F(1e-6));
  t_lo = fmaxf((-qb - sq) / safe_qa, t0);
  t_hi = fminf((-qb + sq) / safe_qa, t_max);
  if ((disc < 0.0f) || (t_hi <= t_lo)) { t_lo = t0; t_hi = 0.0f; }
  if (kf < F(1.2)) { t_lo = t0; t_hi = t_max; }
}

__device__ __forceinline__ float seg_bound_dist(Bound bd, V3 o, V3 l,
                                                float t_lo, float dist) {
  float wx = bd.cx - o.x, wy = bd.cy - o.y, wz = bd.cz - o.z;
  float proj = (wx * l.x + wy * l.y) + wz * l.z;
  proj = fminf(fmaxf(proj, t_lo), fmaxf(dist, t_lo));
  float qx = wx - proj * l.x, qy = wy - proj * l.y, qz = wz - proj * l.z;
  return sqrtf((qx * qx + qy * qy) + qz * qz) - bd.R;
}

// ---------------------------------------------------------------------------
// Warp-level member culling: how kf_frame_kernel<true> runs the crowd's
// member loops (render_tile.crowd_warp_masks is the plain version)
//
// KF's warp is 16x2 pixels of one frame. Before each member loop every lane
// of a warp tests one member of a 32-member chunk against a region that
// holds all the loop's per-lane work on every lane of the warp;
// __ballot_sync gives the chunk's mask, and the lanes then visit the masked
// members in member order with their exact per-lane gates. A member outside
// the mask is one whose per-lane gate makes it an exact no-op on every lane
// of the warp, so the result is bitwise that of the plain member loops,
// which visit every member. The cores below take it as their CULL
// instantiation (a WarpCull argument); the other kernels instantiate them
// with CULL false and visit every member.
//
// Every collective runs with all 32 lanes present (KF_FULL): pixels outside
// the frame and lanes without a hit take part as non-contributors
// (`active` false), and every ballot and shuffle sits in a loop whose trip
// count is the same on all lanes.
//
// A region is a tapered capsule: the points a + t*u, t in [0, len], each
// widened by r(t) = rA + sig*t (len 0: a ball). Lane i's work touches only
// points within r(t) of the axis:
//   primary    rays o + t*d_i, all from the camera o: a = o, u = the lanes'
//              normalised mean direction, len = t_max, rA = 0, sig = max_i
//              |d_i - u|, since |(o + t d_i) - (o + t u)| = t |d_i - u|;
//   secondary  receivers p_i (the hit lanes' p_off) inside the ball (c_w,
//              r_w), c_w the centre of their bounding box:
//     AO       the ball itself;
//     hard     the segments from p_i to a point light L lie in the cone
//              from the ball to L (rB = 0); the segments p_i + t*l, t in
//              [0, t_max], of a directional light in the cylinder of radius
//              r_w along l;
//     soft     the same axis, each point widened by the penumbra radius
//              t/kf_i of its lane: at t = s*dist_i that is s*dist_i/kf_i,
//              so rB grows by rho = max_i dist_i/kf_i. kf < 1.2 (a whole-
//              segment influence window) changes nothing: crowd_bound lower-
//              bounds every member's SDF, so kf*h/t >= 1 holds wherever the
//              penumbra ball misses the bound sphere.
// A member (c, R) may matter only if cull_gap, the least of |c - x(t)| -
// r(t) over the capsule, is at most R plus the loop's reach and a slack.
//
// Slack. Each gate rounds, and the warp test must stay outside its error.
// scale = |c|_1 + |v1| + perp + reach + R + |r(t*)| bounds every length in
// the test (eps = 2^-24):
//   * AO's gate (sqrtf(|q0 - c|^2) - R) and the hard shadows' segment skip
//     (seg_bound_dist: |w - proj*l| - R) subtract vectors before squaring:
//     each is within 12 eps of scale, cull_gap within 12 eps of its own:
//     slack CULL_LIN = 2^-18 (64 eps) of scale;
//   * the primary entry (bound_entry: pb^2 - (w2 - Re^2)), a sphere leaf's
//     exact hit (leaf_interval: b^2 - c, with far members b^2 ~ c) and
//     penumbra_sphere (s^2 = (t - b) t + (A - b t), and the roots of qa,
//     qb, qc, clamped to the segment) subtract squares: an error up to 32
//     eps of scale^2 is up to sqrt(32 eps) scale = 2^-9.5 scale in
//     distance: slack CULL_SQRT = 2^-8 of scale; the penumbra, evaluated up
//     to t = len, also widens its slope sig by 2^-8. The soft boxes and
//     pairs (marches; p = o + t*l rounds with |p|, which |c|_1 bounds) take
//     the same.
// A generous slack only keeps a member a lane then skips by its own gate.
// ---------------------------------------------------------------------------

#define KF_FULL 0xffffffffu
#define CULL_LIN F(3.814697265625e-06)  // 2^-18
#define CULL_SQRT F(0.00390625)         // 2^-8

struct WarpSeg {
  V3 a, u;      // axis a + t*u, t in [0, len]; u = 0 for a ball
  float len;
  float rA;     // radius at t = 0
  float sig;    // radius slope: r(t) = rA + sig*t
  float k;      // sig / sqrt(1 - sig^2): the gap's minimum lies at
                // t = v1 + k*perp (|sig| < 1)
  bool any;     // some lane of the warp is active
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(KF_FULL, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(KF_FULL, v, off));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(KF_FULL, v, off));
  return v;
}

__device__ __forceinline__ WarpSeg make_seg(V3 a, V3 u, float len, float rA,
                                            float sig, bool any) {
  const float k = (sig > -1.0f && sig < 1.0f)
      ? sig / sqrtf(1.0f - sig * sig) : 0.0f;
  return WarpSeg{a, u, len, rA, sig, k, any};
}

// The primary rays' capsule: from the camera o along the active lanes'
// mean direction.
__device__ __forceinline__ WarpSeg warp_cone(const KFSettings& S, V3 o, V3 d,
                                             bool active) {
  const bool any = __any_sync(KF_FULL, active);
  const V3 u = vnormalize(V3{warp_sum(active ? d.x : 0.0f),
                             warp_sum(active ? d.y : 0.0f),
                             warp_sum(active ? d.z : 0.0f)});
  const V3 e{d.x - u.x, d.y - u.y, d.z - u.z};
  const float sig = warp_max(active ? sqrtf(vdot(e, e)) : 0.0f);
  return make_seg(o, u, S.t_max, 0.0f, sig, any);
}

// The active receivers' ball: centre of their bounding box, radius the
// largest distance to it.
__device__ __forceinline__ WarpSeg warp_ball(V3 p, bool active) {
  const bool any = __any_sync(KF_FULL, active);
  const float lo_x = warp_min(active ? p.x : KF_BIG);
  const float lo_y = warp_min(active ? p.y : KF_BIG);
  const float lo_z = warp_min(active ? p.z : KF_BIG);
  const float hi_x = warp_max(active ? p.x : -KF_BIG);
  const float hi_y = warp_max(active ? p.y : -KF_BIG);
  const float hi_z = warp_max(active ? p.z : -KF_BIG);
  const V3 c{(lo_x + hi_x) * 0.5f, (lo_y + hi_y) * 0.5f,
             (lo_z + hi_z) * 0.5f};
  const V3 e{p.x - c.x, p.y - c.y, p.z - c.z};
  const float r = warp_max(active ? sqrtf(vdot(e, e)) : 0.0f);
  return make_seg(c, V3{0.0f, 0.0f, 0.0f}, 0.0f, r, 0.0f, any);
}

// One light's shadow capsules from the receivers' ball: hard (the
// segments themselves) and soft (widened by the penumbra radii).
__device__ __forceinline__ void warp_light(const KFSettings& S,
                                           const float* lrow, bool point,
                                           const WarpSeg& ball, float dist,
                                           float kf, bool active,
                                           WarpSeg& hard, WarpSeg& soft) {
  const float rho = warp_max(active ? dist / kf : 0.0f);
  V3 u;
  float len, rB;
  if (point) {
    const V3 e{lrow[0] - ball.a.x, lrow[1] - ball.a.y, lrow[2] - ball.a.z};
    len = sqrtf(vdot(e, e));
    const float inv = len > 0.0f ? 1.0f / len : 0.0f;
    u = V3{e.x * inv, e.y * inv, e.z * inv};
    // a lane's l = (L - p_i)/dist_i rounds: its far end misses L by a few
    // eps of len
    rB = CULL_LIN * len;
  } else {
    u = V3{0.0f - lrow[0], 0.0f - lrow[1], 0.0f - lrow[2]};
    len = S.t_max;
    rB = ball.rA;
  }
  const float inv_len = len > 0.0f ? 1.0f / len : 0.0f;
  hard = make_seg(ball.a, u, len, ball.rA, (rB - ball.rA) * inv_len,
                  ball.any);
  const float rB_soft = rB + rho * (1.0f + CULL_LIN) + CULL_SQRT * len;
  soft = make_seg(ball.a, u, len, ball.rA, (rB_soft - ball.rA) * inv_len,
                  ball.any);
}

// May a member with bound centre c and reach R_eff matter to some point of
// the capsule? The gap's exact minimum, then the slack `rel` of scale.
__device__ __forceinline__ bool cull_keep(Bound b, float reach,
                                          const WarpSeg& s, float rel) {
  const V3 w{b.cx - s.a.x, b.cy - s.a.y, b.cz - s.a.z};
  const float v1 = vdot(w, s.u);
  const V3 q{w.x - v1 * s.u.x, w.y - v1 * s.u.y, w.z - v1 * s.u.z};
  const float perp = sqrtf(vdot(q, q));
  const float t = s.sig >= 1.0f ? s.len
      : s.sig <= -1.0f ? 0.0f : clampf(v1 + s.k * perp, 0.0f, s.len);
  const float dt = t - v1;
  const float r_t = s.rA + s.sig * t;
  const float gap = sqrtf(dt * dt + perp * perp) - r_t;
  const float r_eff = b.R + reach;
  const float scale = (((fabsf(b.cx) + fabsf(b.cy)) + fabsf(b.cz))
                       + (fabsf(v1) + perp)) + (r_eff + fabsf(r_t));
  return gap <= r_eff + rel * scale;
}

// Visit the members [lo, hi) that may matter to some lane of the warp, in
// member order: body(j, b), b member j's bound (crowd_bound's bits, from
// the lane that tested it). live(): the lane still gains from a member;
// the chunks stop once no lane does. All 32 lanes call this; body may
// diverge.
template <class Live, class Body>
__device__ __forceinline__ void cull_members(const KFTables& T, int lo,
                                             int hi, const WarpSeg& s,
                                             float reach, float rel,
                                             Live live, Body body) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32) {
    if (!__any_sync(KF_FULL, live())) break;
    const int jl = base + lane;
    Bound bl{0.0f, 0.0f, 0.0f, 0.0f};
    bool need = false;
    if (s.any && jl < hi) {
      bl = crowd_bound(crowd_member(T, jl));
      need = cull_keep(bl, reach, s, rel);
    }
    unsigned mask = __ballot_sync(KF_FULL, need);
    while (mask) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      const Bound b{__shfl_sync(KF_FULL, bl.cx, k),
                    __shfl_sync(KF_FULL, bl.cy, k),
                    __shfl_sync(KF_FULL, bl.cz, k),
                    __shfl_sync(KF_FULL, bl.R, k)};
      body(base + k, b);
    }
  }
}

// What kf_frame_kernel<true> hands a core with CULL: the warp's capsule of
// its member loops (seg: the rays' cone, the receivers' ball, a light's
// hard capsule; soft: a light's soft one) and whether this lane takes part
// (in the frame, with a hit). The cores' other instantiations get NoCull.
struct WarpCull {
  WarpSeg seg, soft;
  bool active;
};
struct NoCull {};

// ---------------------------------------------------------------------------
// Scene-level cores shared by KF and the split path
// ---------------------------------------------------------------------------

static __constant__ float AO_DIRS[9][3] = {
    {F(0.0), F(0.0), F(1.0)},
    {F(0.7), F(0.0), F(0.7141428)},
    {F(-0.7), F(0.0), F(0.7141428)},
    {F(0.0), F(0.7), F(0.7141428)},
    {F(0.0), F(-0.7), F(0.7141428)},
    {F(0.5), F(0.5), F(0.7071068)},
    {F(-0.5), F(0.5), F(0.7071068)},
    {F(0.5), F(-0.5), F(0.7071068)},
    {F(-0.5), F(-0.5), F(0.7071068)},
};

__device__ __forceinline__ const int* object_row(const KFTables& T, int oi) {
  return T.objects + oi * KF_OBJ_W;
}

__device__ __forceinline__ const float* first_leaf_params(const KFTables& T,
                                                          const int* ob) {
  return T.leaf_params +
      T.leaves[ob[O_LEAF0] * KF_LEAF_W + 1] * KF_LEAF_PARAM_W;
}

// Primary trace over (t_min, t_max) of the non-mesh objects: analytic
// objects exactly, then the analytic crowd members; then the SDF marches,
// the crowd's members first (singles, then pairs), then the other objects
// cheapest tape first, each clipped by the nearest hit so far. t0 is the
// primed start of the SDF marches (0 when the frame is not primed). t is
// KF_BIG and obj -1 on a miss.
//
// The cores below are templates on CROWD: the kernels are instantiated
// once without the member loops, for scenes with no crowd (n_crowd == 0),
// whose code and register use are then what they were before the crowd
// existed, and once with them. CULL (kf_frame_kernel<true> only) culls the
// member loops per warp against w.seg, the warp's ray cone; every lane
// calls it, w.active false for a pixel outside the frame.
template <bool CROWD, bool CULL = false, class Warp = NoCull>
__device__ __forceinline__ void trace_primary(const KFTables& T,
                                              const KFSettings& S, V3 o,
                                              V3 d, float t0, float& t,
                                              float& obj, int& leaf,
                                              Warp w = {}) {
  t = KF_BIG;
  obj = -1.0f;
  leaf = 0;
  for (int k = 0; k < S.n_ana; ++k) {
    const int oi = T.order[k];
    int li;
    float ti = intersect_analytic(T, object_row(T, oi), o, d, S.t_min,
                                  S.t_max, li);
    if (ti < t) { t = ti; obj = (float)oi; leaf = li; }
  }
  if constexpr (CULL) {
    cull_members(T, S.crowd_sdf_end, S.crowd_single_end, w.seg, 0.0f,
                 CULL_SQRT, [&] { return w.active; }, [&](int j, Bound) {
      if (!w.active) return;
      const CrowdMember m = crowd_member(T, j);
      float tj = crowd_exact_t(m, o, d, S.t_min, S.t_max);
      if (tj < t) { t = tj; obj = m.obj; leaf = 0; }
    });
  } else if constexpr (CROWD) {
    for (int j = S.crowd_sdf_end; j < S.crowd_single_end; ++j) {
      const CrowdMember m = crowd_member(T, j);
      float tj = crowd_exact_t(m, o, d, S.t_min, S.t_max);
      if (tj < t) { t = tj; obj = m.obj; leaf = 0; }
    }
  }
  const float t_start = fmaxf(t0, S.t_min);
  float t_clip = fminf(t, S.t_max);
  if constexpr (CULL) {
    // SDF members: singles, then pairs; a skipped member would have left
    // t and t_clip as they are (t_clip <= t throughout)
    auto march_member = [&](int j, Bound b) {
      if (!w.active) return;
      float t1, clip2;
      bound_entry(b, o, d, t_start, t_clip, S.default_shell, t1, clip2);
      if (t1 < clip2) {
        const CrowdMember m = crowd_member(T, j);
        if (crowd_march(S, m, o, d, t1, clip2) && t1 < t) {
          t = t1; obj = m.obj; leaf = 0;
        }
      }
      t_clip = fminf(t_clip, t);
    };
    auto live = [&] { return w.active; };
    cull_members(T, 0, S.crowd_sdf_end, w.seg, S.default_shell, CULL_SQRT,
                 live, march_member);
    cull_members(T, S.crowd_single_end, S.n_crowd, w.seg, S.default_shell,
                 CULL_SQRT, live, march_member);
  } else if constexpr (CROWD) {
    for (int j = 0; j < S.n_crowd; ++j) {
      if (j == S.crowd_sdf_end) j = S.crowd_single_end;  // SDF members only
      if (j >= S.n_crowd) break;
      const CrowdMember m = crowd_member(T, j);
      float t1, clip2;
      bound_entry(crowd_bound(m), o, d, t_start, t_clip, S.default_shell,
                  t1, clip2);
      // a ray that misses the bound is done before its first step
      bool hit_j = t1 < clip2 && crowd_march(S, m, o, d, t1, clip2);
      if (hit_j && t1 < t) { t = t1; obj = m.obj; leaf = 0; }
      t_clip = fminf(t_clip, t);
    }
  }
  for (int k = 0; k < S.n_sdf; ++k) {
    const int oi = T.order[S.n_ana + k];
    const int* ob = object_row(T, oi);
    float t1, clip2;
    if (ob[O_BOUNDABLE]) {
      Bound b = object_bound(T, ob, 0, S.exit_margin);
      bound_entry(b, o, d, t_start, t_clip, entry_shell(T, S, ob), t1,
                  clip2);
    } else {
      t1 = t_start;
      clip2 = t_clip;
    }
    bool hit_i = march(T, S, ob, o, d, t1, clip2);
    if (hit_i && t1 < t) { t = t1; obj = (float)oi; leaf = 0; }
    t_clip = fminf(t_clip, t);
  }
}

// The FD tetrahedron's normal from its four SDF samples.
__device__ __forceinline__ V3 fd_normal(float s0, float s1, float s2,
                                        float s3) {
  float nx = ((s0 - s1) - s2) + s3;
  float ny = ((-s0 - s1) + s2) + s3;
  float nz = ((-s0 + s1) - s2) + s3;
  float inv = 1.0f / sqrtf((nx * nx + ny * ny) + nz * nz);
  return V3{nx * inv, ny * inv, nz * inv};
}

// Normal of the winning object at p (analytic leaf normal, or the FD
// tetrahedron of its tape), (0, 0, 1) on a miss; face-forwarded against d.
template <bool CROWD>
__device__ __forceinline__ V3 hit_normal(const KFTables& T,
                                         const KFSettings& S, float obj,
                                         int leaf, V3 p, V3 d) {
  V3 n{0.0f, 0.0f, 1.0f};
  if (obj >= 0.0f) {
    const int* ob = object_row(T, (int)obj);
    if (CROWD && ob[O_CROWD] >= 0) {
      // a crowd member: its leaf's closed-form normal (analytic members,
      // normals "auto") or the FD tetrahedron of its own SDF
      const CrowdMember m = crowd_member(T, ob[O_CROWD]);
      if (m.type == CROWD_ANALYTIC && !S.normals_fd) {
        n = leaf_normal(m.s0 ? LEAF_SPHERE : LEAF_BOX, m.prm0, p);
      } else {
        const float e = S.normal_eps;
        float s0 = crowd_sdf(m, V3{p.x + e, p.y - e, p.z - e});
        float s1 = crowd_sdf(m, V3{p.x - e, p.y - e, p.z + e});
        float s2 = crowd_sdf(m, V3{p.x - e, p.y + e, p.z - e});
        float s3 = crowd_sdf(m, V3{p.x + e, p.y + e, p.z + e});
        n = fd_normal(s0, s1, s2, s3);
      }
    } else if (ob[O_ENGINE] == ENGINE_ANALYTIC && !S.normals_fd) {
      const int* lf = T.leaves + (ob[O_LEAF0] + leaf) * KF_LEAF_W;
      V3 nl = leaf_normal(lf[0], T.leaf_params + lf[1] * KF_LEAF_PARAM_W, p);
      const float s = (float)lf[2];
      n = V3{nl.x * s, nl.y * s, nl.z * s};
    } else {
      const float e = S.normal_eps;
      float s0 = eval_obj(T, S, ob, V3{p.x + e, p.y - e, p.z - e}, 0);
      float s1 = eval_obj(T, S, ob, V3{p.x - e, p.y - e, p.z + e}, 0);
      float s2 = eval_obj(T, S, ob, V3{p.x - e, p.y + e, p.z - e}, 0);
      float s3 = eval_obj(T, S, ob, V3{p.x + e, p.y + e, p.z + e}, 0);
      n = fd_normal(s0, s1, s2, s3);
    }
  }
  const float sgn = vdot(n, d) > 0.0f ? -1.0f : 1.0f;
  return V3{n.x * sgn, n.y * sgn, n.z * sgn};
}

// AO factor at the offset receiver q0 with normal n, over the non-mesh
// objects. Per tap the occlusion of the unboundable objects (one
// scene-min group), of every other bounded object and of every crowd member
// within 2*ao_radius combine by max; a farther one contributes exactly
// zero and is skipped. The objects outside the crowd are at most
// KF_MAX_OBJECTS (one bit each); crowd members are not counted: with a
// crowd the tap terms are kept per thread and each near member is folded
// into them in turn (max is exact in any order). CULL: the member loop is
// culled against w.seg, the warp's ball of receivers; every lane of the
// warp calls it, w.active false for a lane without a hit.
template <bool CROWD, bool CULL, class Warp>
__device__ __forceinline__ float ao_core(const KFTables& T,
                                         const KFSettings& S, V3 q0, V3 n,
                                         Warp w) {
  if constexpr (CULL) {
    if (!__any_sync(KF_FULL, w.active)) return 1.0f;   // the whole warp
  }
  unsigned long long near = 0ull;
  bool any_unbounded = false;
  const float gate = 2.0f * S.ao_radius;
  const int n_rest = S.n_ana + S.n_sdf;
  const int* rest = T.order + n_rest;
  for (int k = 0; k < n_rest; ++k) {
    const int* ob = object_row(T, rest[k]);
    if (!ob[O_BOUNDABLE]) {
      any_unbounded = true;
      continue;
    }
    Bound b = object_bound(T, ob, 1, 0.0f);
    float dx = q0.x - b.cx, dy = q0.y - b.cy, dz = q0.z - b.cz;
    float hb = sqrtf((dx * dx + dy * dy) + dz * dz) - b.R;
    if (hb <= gate) near |= 1ull << k;
  }
  bool big_y = fabsf(n.y) > F(0.9);
  float hx = big_y ? 1.0f : 0.0f, hy = big_y ? 0.0f : 1.0f;
  V3 t1 = vnormalize(V3{hy * n.z, -hx * n.z, hx * n.y - hy * n.x});
  V3 t2{n.y * t1.z - n.z * t1.y, n.z * t1.x - n.x * t1.z,
        n.x * t1.y - n.y * t1.x};
  const int cap = S.ao_lod;
  float terms[CROWD ? KF_MAX_AO_TAPS : 1];
  float occ = 0.0f;
  for (int s = 0; s < S.ao_samples; ++s) {
    const float ax = AO_DIRS[s][0], ay = AO_DIRS[s][1], az = AO_DIRS[s][2];
    V3 dd{(ax * t1.x + ay * t2.x) + az * n.x,
          (ax * t1.y + ay * t2.y) + az * n.y,
          (ax * t1.z + ay * t2.z) + az * n.z};
    for (int tap = 1; tap <= 4; ++tap) {
      const float r = (S.ao_radius * (float)tap) * 0.25f;
      const float azr = az * r;
      V3 q{q0.x + dd.x * r, q0.y + dd.y * r, q0.z + dd.z * r};
      float term = 0.0f;
      if (any_unbounded) {
        float hmin = 0.0f;
        bool first = true;
        for (int k = 0; k < n_rest; ++k) {
          const int* ob = object_row(T, rest[k]);
          if (ob[O_BOUNDABLE]) continue;
          float h = eval_obj(T, S, ob, q, cap);
          hmin = first ? h : fminf(hmin, h);
          first = false;
        }
        term = fmaxf(azr - hmin, 0.0f) / r;
      }
      for (int k = 0; k < n_rest; ++k) {
        if (!((near >> k) & 1ull)) continue;
        float h = eval_obj(T, S, object_row(T, rest[k]), q, cap);
        term = fmaxf(term, fmaxf(azr - h, 0.0f) / r);
      }
      if constexpr (CROWD) {
        terms[s * 4 + tap - 1] = term;
      } else {
        occ = (s == 0 && tap == 1) ? term : occ + term;
      }
    }
  }
  if constexpr (CULL) {
    cull_members(T, 0, S.n_crowd, w.seg, gate, CULL_LIN,
                 [&] { return w.active; }, [&](int j, Bound b) {
      if (!w.active) return;
      float dx = q0.x - b.cx, dy = q0.y - b.cy, dz = q0.z - b.cz;
      if (!(sqrtf((dx * dx + dy * dy) + dz * dz) - b.R <= gate)) return;
      const CrowdMember m = crowd_member(T, j);
      for (int s = 0; s < S.ao_samples; ++s) {
        const float ax = AO_DIRS[s][0], ay = AO_DIRS[s][1];
        const float az = AO_DIRS[s][2];
        V3 dd{(ax * t1.x + ay * t2.x) + az * n.x,
              (ax * t1.y + ay * t2.y) + az * n.y,
              (ax * t1.z + ay * t2.z) + az * n.z};
        for (int tap = 1; tap <= 4; ++tap) {
          const float r = (S.ao_radius * (float)tap) * 0.25f;
          V3 q{q0.x + dd.x * r, q0.y + dd.y * r, q0.z + dd.z * r};
          float h = crowd_sdf(m, q);
          float& term = terms[s * 4 + tap - 1];
          term = fmaxf(term, fmaxf(az * r - h, 0.0f) / r);
        }
      }
    });
  } else if constexpr (CROWD) {
    for (int j = 0; j < S.n_crowd; ++j) {
      const CrowdMember m = crowd_member(T, j);
      const Bound b = crowd_bound(m);
      float dx = q0.x - b.cx, dy = q0.y - b.cy, dz = q0.z - b.cz;
      if (!(sqrtf((dx * dx + dy * dy) + dz * dz) - b.R <= gate)) continue;
      for (int s = 0; s < S.ao_samples; ++s) {
        const float ax = AO_DIRS[s][0], ay = AO_DIRS[s][1];
        const float az = AO_DIRS[s][2];
        V3 dd{(ax * t1.x + ay * t2.x) + az * n.x,
              (ax * t1.y + ay * t2.y) + az * n.y,
              (ax * t1.z + ay * t2.z) + az * n.z};
        for (int tap = 1; tap <= 4; ++tap) {
          const float r = (S.ao_radius * (float)tap) * 0.25f;
          V3 q{q0.x + dd.x * r, q0.y + dd.y * r, q0.z + dd.z * r};
          float h = crowd_sdf(m, q);
          float& term = terms[s * 4 + tap - 1];
          term = fmaxf(term, fmaxf(az * r - h, 0.0f) / r);
        }
      }
    }
  }
  if constexpr (CROWD) {
    for (int i = 0; i < S.ao_samples * 4; ++i)
      occ = i == 0 ? terms[0] : occ + terms[i];
  }
  occ = occ / (float)(S.ao_samples * 4);
  return sat(1.0f - S.ao_strength * occ);
}

// The AO core is called out of line. Without CULL it keeps the name and
// signature every kernel called before the culling existed (chip_smoke.py
// phase 1 holds those kernels' code). With CULL the ball goes by value: by
// reference it lives in each thread's stack frame, and the crowd kernel
// ran 5% slower.
template <bool CROWD>
static __device__ __noinline__ float ao_factor(const KFTables& T, const KFSettings& S,
                                        V3 q0, V3 n) {
  return ao_core<CROWD, false>(T, S, q0, n, NoCull{});
}

static __device__ __noinline__ float ao_factor_culled(const KFTables& T,
                                                      const KFSettings& S,
                                                      V3 q0, V3 n,
                                                      WarpSeg ball,
                                                      bool active) {
  return ao_core<true, true>(T, S, q0, n, WarpCull{ball, ball, active});
}

// Visibility of one light from the offset receiver o along l over
// [.., dist] through the non-mesh objects; kf is the penumbra sharpness.
template <bool CROWD>
static __device__ __noinline__ float visibility(const KFTables& T,
                                         const KFSettings& S, V3 o, V3 l,
                                         float dist, float kf) {
  if (S.soft_shadows) {
    const float t0 = S.soft_shadow_tmin;
    const int* ord = T.order + S.n_ana + S.n_sdf;
    float soft_vis = 1.0f;
    // the crowd: spheres in closed form, boxes and pairs by windowed
    // marches; a lane already dark gains nothing from a further member
    for (int j = 0; CROWD && j < S.n_crowd && soft_vis > 0.0f; ++j) {
      const CrowdMember m = crowd_member(T, j);
      float v;
      if (m.op == OP_LEAF && m.s0) {
        v = penumbra_sphere(m.prm0, o, l, t0, dist, kf);
      } else {
        float t_lo, t_hi;
        influence_window(crowd_bound(m), o, l, t0, dist, kf, t_lo, t_hi);
        v = crowd_soft_march(S, m, o, l, fmaxf(t_lo, t0), fminf(dist, t_hi),
                             kf);
      }
      soft_vis = fminf(soft_vis, v);
    }
    for (int k = 0; k < S.n_ana + S.n_sdf; ++k) {
      const int* ob = object_row(T, ord[k]);
      const int cf = ob[O_CLOSED_FORM];
      if (cf >= 0) {
        const float* prm = first_leaf_params(T, ob);
        float v = cf == LEAF_PLANE ? penumbra_plane(prm, o, l, t0, dist, kf)
                                   : penumbra_sphere(prm, o, l, t0, dist, kf);
        soft_vis = fminf(soft_vis, v);
        continue;
      }
      const float dist_i = soft_vis <= 0.0f ? 0.0f : dist;
      float v;
      if (ob[O_BOUNDABLE]) {
        Bound b = object_bound(T, ob, 1, 0.0f);
        float t_lo, t_hi;
        influence_window(b, o, l, t0, dist_i, kf, t_lo, t_hi);
        v = soft_march(T, S, ob, o, l, fmaxf(t_lo, t0), fminf(dist_i, t_hi),
                       kf);
      } else {
        v = soft_march(T, S, ob, o, l, t0, dist_i, kf);
      }
      soft_vis = fminf(soft_vis, v);
    }
    return soft_vis;
  }
  float vis = 1.0f;
  for (int k = 0; k < S.n_ana; ++k) {
    int leaf;
    float ti = intersect_analytic(T, object_row(T, T.order[k]), o, l,
                                  S.shadow_eps, dist, leaf);
    vis = vis * (ti < dist ? 0.0f : 1.0f);
  }
  // the crowd: SDF members (singles, then pairs) by any-hit marches, then
  // the analytic members exactly; an occluded lane stays occluded
  for (int pass = 0; CROWD && pass < 2; ++pass) {
    for (int j = 0; j < S.n_crowd && vis > 0.0f; ++j) {
      const CrowdMember m = crowd_member(T, j);
      if ((m.type == CROWD_ANALYTIC) != (pass == 1)) continue;
      if (pass == 1) {
        float tj = crowd_exact_t(m, o, l, S.shadow_eps, dist);
        vis = vis * (tj < dist ? 0.0f : 1.0f);
        continue;
      }
      const Bound b = crowd_bound(m);
      float dist_j = dist;
      if (seg_bound_dist(b, o, l, S.shadow_eps, dist_j) > S.exit_margin)
        dist_j = 0.0f;
      float t1, clip2;
      bound_entry(b, o, l, S.shadow_eps, dist_j, S.default_shell, t1, clip2);
      bool hit = t1 < clip2 && crowd_march(S, m, o, l, t1, clip2);
      vis = vis * ((hit && t1 < dist_j) ? 0.0f : 1.0f);
    }
  }
  for (int k = 0; k < S.n_sdf; ++k) {
    const int* ob = object_row(T, T.order[S.n_ana + k]);
    float dist_i = vis <= 0.0f ? 0.0f : dist;
    float t1, clip2;
    if (ob[O_BOUNDABLE]) {
      Bound b = object_bound(T, ob, 0, S.exit_margin);
      // a segment clear of the cover sphere by more than the worst hit
      // epsilon cannot register an occlusion
      if (seg_bound_dist(b, o, l, S.shadow_eps, dist) > S.exit_margin)
        dist_i = 0.0f;
      bound_entry(b, o, l, S.shadow_eps, dist_i, S.default_shell, t1, clip2);
    } else {
      t1 = S.shadow_eps;
      clip2 = dist_i;
    }
    bool hit = march(T, S, ob, o, l, t1, clip2);
    vis = vis * ((hit && t1 < dist_i) ? 0.0f : 1.0f);
  }
  return vis;
}

// visibility<true> as kf_frame_kernel<true> runs it: the member loops
// culled against the warp's hard and soft capsules of this light; every
// lane of the warp calls it, `active` false for a lane without a hit. The
// objects outside the crowd repeat visibility<CROWD>'s code: calling
// visibility<false> here instead changed kf_frame_kernel<false>'s SASS
// (ptxas compiles a device function once for all its callers) and made the
// sphere crowds 10% slower, and a wrapper around one shared core changed
// K2's. The capsules go by value: by reference they live in each thread's
// stack frame, and the crowd kernel ran 5% slower.
static __device__ __noinline__ float visibility_culled(
    const KFTables& T, const KFSettings& S, V3 o, V3 l, float dist, float kf,
    WarpSeg hard, WarpSeg soft, bool active) {
  if (!__any_sync(KF_FULL, active)) return 1.0f;   // the whole warp
  if (S.soft_shadows) {
    const float t0 = S.soft_shadow_tmin;
    const int* ord = T.order + S.n_ana + S.n_sdf;
    float soft_vis = 1.0f;
    // the crowd: spheres in closed form, boxes and pairs by windowed
    // marches; a lane already dark gains nothing from a further member
    cull_members(T, 0, S.n_crowd, soft, 0.0f, CULL_SQRT,
                 [&] { return active && soft_vis > 0.0f; },
                 [&](int j, Bound b) {
      if (!(active && soft_vis > 0.0f)) return;
      const CrowdMember m = crowd_member(T, j);
      float v;
      if (m.op == OP_LEAF && m.s0) {
        v = penumbra_sphere(m.prm0, o, l, t0, dist, kf);
      } else {
        float t_lo, t_hi;
        influence_window(b, o, l, t0, dist, kf, t_lo, t_hi);
        v = crowd_soft_march(S, m, o, l, fmaxf(t_lo, t0), fminf(dist, t_hi),
                             kf);
      }
      soft_vis = fminf(soft_vis, v);
    });
    if (!active) return 1.0f;
    for (int k = 0; k < S.n_ana + S.n_sdf; ++k) {
      const int* ob = object_row(T, ord[k]);
      const int cf = ob[O_CLOSED_FORM];
      if (cf >= 0) {
        const float* prm = first_leaf_params(T, ob);
        float v = cf == LEAF_PLANE ? penumbra_plane(prm, o, l, t0, dist, kf)
                                   : penumbra_sphere(prm, o, l, t0, dist, kf);
        soft_vis = fminf(soft_vis, v);
        continue;
      }
      const float dist_i = soft_vis <= 0.0f ? 0.0f : dist;
      float v;
      if (ob[O_BOUNDABLE]) {
        Bound b = object_bound(T, ob, 1, 0.0f);
        float t_lo, t_hi;
        influence_window(b, o, l, t0, dist_i, kf, t_lo, t_hi);
        v = soft_march(T, S, ob, o, l, fmaxf(t_lo, t0), fminf(dist_i, t_hi),
                       kf);
      } else {
        v = soft_march(T, S, ob, o, l, t0, dist_i, kf);
      }
      soft_vis = fminf(soft_vis, v);
    }
    return soft_vis;
  }
  float vis = 1.0f;
  for (int k = 0; k < S.n_ana; ++k) {
    int leaf;
    float ti = intersect_analytic(T, object_row(T, T.order[k]), o, l,
                                  S.shadow_eps, dist, leaf);
    vis = vis * (ti < dist ? 0.0f : 1.0f);
  }
  // the crowd: SDF members (singles, then pairs) by any-hit marches, then
  // the analytic members exactly; an occluded lane stays occluded
  auto lit = [&] { return active && vis > 0.0f; };
  auto march_member = [&](int j, Bound b) {
    if (!(active && vis > 0.0f)) return;
    // past the exit margin the segment is clipped to nothing: no march
    if (seg_bound_dist(b, o, l, S.shadow_eps, dist) > S.exit_margin) return;
    float t1, clip2;
    bound_entry(b, o, l, S.shadow_eps, dist, S.default_shell, t1, clip2);
    const CrowdMember m = crowd_member(T, j);
    bool hit = t1 < clip2 && crowd_march(S, m, o, l, t1, clip2);
    vis = vis * ((hit && t1 < dist) ? 0.0f : 1.0f);
  };
  cull_members(T, 0, S.crowd_sdf_end, hard, S.exit_margin, CULL_LIN, lit,
               march_member);
  cull_members(T, S.crowd_single_end, S.n_crowd, hard, S.exit_margin,
               CULL_LIN, lit, march_member);
  cull_members(T, S.crowd_sdf_end, S.crowd_single_end, hard, 0.0f, CULL_SQRT,
               lit, [&](int j, Bound) {
    if (!(active && vis > 0.0f)) return;
    const CrowdMember m = crowd_member(T, j);
    float tj = crowd_exact_t(m, o, l, S.shadow_eps, dist);
    vis = vis * (tj < dist ? 0.0f : 1.0f);
  });
  if (!active) return 1.0f;
  for (int k = 0; k < S.n_sdf; ++k) {
    const int* ob = object_row(T, T.order[S.n_ana + k]);
    float dist_i = vis <= 0.0f ? 0.0f : dist;
    float t1, clip2;
    if (ob[O_BOUNDABLE]) {
      Bound b = object_bound(T, ob, 0, S.exit_margin);
      // a segment clear of the cover sphere by more than the worst hit
      // epsilon cannot register an occlusion
      if (seg_bound_dist(b, o, l, S.shadow_eps, dist) > S.exit_margin)
        dist_i = 0.0f;
      bound_entry(b, o, l, S.shadow_eps, dist_i, S.default_shell, t1, clip2);
    } else {
      t1 = S.shadow_eps;
      clip2 = dist_i;
    }
    bool hit = march(T, S, ob, o, l, t1, clip2);
    vis = vis * ((hit && t1 < dist_i) ? 0.0f : 1.0f);
  }
  return vis;
}

// ---------------------------------------------------------------------------
// Per-pixel pieces of the fused-frame kernels (frame_fused.cu, kf_staged.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float pow_int(float x, int n) {
  if (n == 0) return 1.0f;
  float result = 0.0f, base = x;
  bool first = true;
  while (n) {
    if (n & 1) {
      result = first ? base : result * base;
      first = false;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return result;
}

// The camera ray of pixel (i, j) of frame f: pixel centres at +0.5.
__device__ __forceinline__ void camera_ray(const KFTables& T,
                                           const KFSettings& S, int f, int i,
                                           int j, V3& o, V3& d) {
  const float* cam = T.cam_rows + f * 12;
  const float xc = ((float)j + 0.5f - S.cx) / S.fx;
  const float yc = ((float)i + 0.5f - S.cy) / S.fy;
  d = vnormalize(V3{(cam[0] * xc + cam[1] * yc) + cam[2],
                    (cam[3] * xc + cam[4] * yc) + cam[5],
                    (cam[6] * xc + cam[7] * yc) + cam[8]});
  o = V3{0.0f + cam[9], 0.0f + cam[10], 0.0f + cam[11]};
}

// A light's direction l and segment length dist from the offset receiver.
__device__ __forceinline__ void light_ray(const KFSettings& S,
                                          const float* lrow, bool point,
                                          V3 p_off, V3& l, float& dist) {
  if (point) {
    float lvx = lrow[0] - p_off.x, lvy = lrow[1] - p_off.y;
    float lvz = lrow[2] - p_off.z;
    dist = sqrtf((lvx * lvx + lvy * lvy) + lvz * lvz);
    float inv = 1.0f / dist;
    l = V3{lvx * inv, lvy * inv, lvz * inv};
  } else {
    l = V3{0.0f - lrow[0], 0.0f - lrow[1], 0.0f - lrow[2]};
    dist = 0.0f + S.t_max;
  }
}

// Blinn-Phong term of one light (shade.py::shade_object), added to r, g, b.
__device__ __forceinline__ void add_light(const float* mat, int shin,
                                          const float* lrow, V3 n, V3 l,
                                          V3 v, float vis, float& r,
                                          float& g, float& b) {
  float ndotl = fmaxf(vdot(n, l), 0.0f);
  float diff = mat[4] * ndotl;
  V3 hv{l.x + v.x, l.y + v.y, l.z + v.z};
  float inv_h = 1.0f / sqrtf(fmaxf(vdot(hv, hv), F(1e-20)));
  V3 hn{hv.x * inv_h, hv.y * inv_h, hv.z * inv_h};
  float ndoth = fmaxf(vdot(n, hn), 0.0f);
  float spec = mat[5] * pow_int(ndoth, shin);
  r = r + vis * lrow[3] * (diff * mat[0] + spec * mat[6]);
  g = g + vis * lrow[4] * (diff * mat[1] + spec * mat[7]);
  b = b + vis * lrow[5] * (diff * mat[2] + spec * mat[8]);
}

// The nine planes of one pixel, out pointing at its first.
__device__ __forceinline__ void write_pixel(float* out, size_t plane,
                                            float r, float g, float b,
                                            float t_sane, float obj, V3 n,
                                            float hitf) {
  out[0 * plane] = r;
  out[1 * plane] = g;
  out[2 * plane] = b;
  out[3 * plane] = t_sane;
  out[4 * plane] = obj;
  out[5 * plane] = n.x * hitf;
  out[6 * plane] = n.y * hitf;
  out[7 * plane] = n.z * hitf;
  out[8 * plane] = hitf;
}
