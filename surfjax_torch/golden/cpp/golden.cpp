// Golden CPU reference renderer, C++ scalar implementation: a copy of
// surfjax/golden/cpp/golden.cpp that also writes each pixel's object id.
// SURVEY.md §2 component 21 / native-code note: strict-FP oracle whose
// semantics are pinned independently of NumPy, XLA and CUDA. Built by
// surfjax_torch/golden/cpp_bridge.py with
//   g++ -O2 -fno-fast-math -ffp-contract=off -pthread -shared -fPIC
// so every operation is a single correctly-rounded IEEE float32 op in
// exactly the written order: the same FP discipline the NumPy golden, the
// port's eager path and its kernels (-fmad=false) follow.
//
// Scope: analytic (sphere/plane/box + event CSG), SDF (smooth ops +
// trig-free power-8 Mandelbulb), and triangle-mesh (brute-force
// Moller-Trumbore + barycentric vertex normals) engines; Lambert /
// Blinn-Phong, hard/soft shadows, AO probes.
//
// Scene data arrives as flat tables (the same SoA data model the compiler
// emits); the math here shares no code with either other implementation.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float BIG = 1e30f;

struct Vec {
  float x, y, z;
};

inline float dot(const Vec &a, const Vec &b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
inline Vec sub(const Vec &a, const Vec &b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec add(const Vec &a, const Vec &b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
inline Vec scale(const Vec &a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline Vec normalize(const Vec &a) {
  float inv = 1.0f / std::sqrt(dot(a, a));
  return {a.x * inv, a.y * inv, a.z * inv};
}
inline float clampf(float x, float lo, float hi) {
  return std::fmin(std::fmax(x, lo), hi);
}
inline float saturate(float x) { return clampf(x, 0.0f, 1.0f); }
inline float mixf(float a, float b, float t) { return a + (b - a) * t; }

float pow_int(float x, int n) {
  if (n == 0) return 1.0f;
  float result = 0.0f;
  bool have = false;
  float base = x;
  while (n) {
    if (n & 1) {
      result = have ? result * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return result;
}

// opcodes / kinds — must match surfjax_torch.api / scene_compile
enum { OP_LEAF = 0, OP_UNION, OP_INTERSECT, OP_SUBTRACT,
       OP_SUNION, OP_SINTER, OP_SSUB };
enum { LEAF_SPHERE = 0, LEAF_PLANE, LEAF_BOX, LEAF_MANDELBULB };
enum { ENGINE_ANALYTIC = 0, ENGINE_SDF, ENGINE_MESH };
enum { LIGHT_POINT = 0, LIGHT_DIRECTIONAL };

struct Scene {
  // header (see cpp_bridge.py for layout)
  int width, height;
  float fx, fy, cx, cy;
  float R[9];
  Vec pos;
  float t_min, t_max, hit_eps, hit_eps_scale, normal_eps, shadow_eps;
  int max_steps, shadow_steps;
  float soft_k, soft_tmin;
  int ao_samples;
  float ao_radius, ao_strength;
  int shadows, soft_shadows, ao;
  int fd_normals;  // settings.normals == "fd": FD tetrahedron everywhere
  Vec bg, ambient;

  const int32_t *objs;      // [engine, node_off, n_nodes, leaf_off,
                            //  n_leaves, mat, shininess] x n_objs
  int n_objs;
  const int32_t *nodes;     // [op, a, b, leaf, pslot] x total_nodes
  const int32_t *leaf_meta; // [kind, sign, p0, p1] x total_leaves
  const float *leaf_params; // (L, 8)
  const float *node_k;      // (K,)
  const float *materials;   // (M, 9)
  const float *lights;      // (NL, 7)
  const int32_t *light_kinds;
  int n_lights;
  // mesh tables (brute force): one shared vertex/face pool; per-object
  // ranges live in obj row slots via mesh_off/mesh_cnt arrays
  const float *mesh_verts;   // (V, 3)
  const float *mesh_vnorm;   // (V, 3) area-weighted vertex normals
  const int32_t *mesh_faces; // (F, 3)
  const int32_t *mesh_obj;   // per scene object: [face_off, face_cnt,
                             //  smooth] x n_objs (zeros for non-mesh)
  // derived at setup (scene-level constants; advisor r3: was recomputed
  // per light per pixel inside the threaded render loop)
  bool any_nonmesh;
};

bool mesh_intersect(const Scene &S, int obj_i, const Vec &o, const Vec &d,
                    float t_min, float t_max, float *t_out, int *tri_out,
                    float *u_out, float *v_out) {
  const int32_t *mo = S.mesh_obj + 3 * obj_i;
  int off = mo[0], cnt = mo[1];
  float t_best = BIG;
  int tri_best = -1;
  float ub = 0.0f, vb = 0.0f;
  // 1e-7: same determinant guard as every device path (see renderer.py)
  const float eps = 1e-7f;
  for (int f = off; f < off + cnt; ++f) {
    const int32_t *fc = S.mesh_faces + 3 * f;
    const float *a = S.mesh_verts + 3 * fc[0];
    const float *b = S.mesh_verts + 3 * fc[1];
    const float *c = S.mesh_verts + 3 * fc[2];
    Vec e1{b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    Vec e2{c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    Vec pv{d.y * e2.z - d.z * e2.y, d.z * e2.x - d.x * e2.z,
           d.x * e2.y - d.y * e2.x};
    float det = dot(e1, pv);
    if (std::fabs(det) <= eps) continue;
    float inv_det = 1.0f / det;
    Vec tv{o.x - a[0], o.y - a[1], o.z - a[2]};
    float u = dot(tv, pv) * inv_det;
    Vec qv{tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z,
           tv.x * e1.y - tv.y * e1.x};
    float v = dot(d, qv) * inv_det;
    float t = dot(e2, qv) * inv_det;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_max
        && t < t_best) {
      t_best = t;
      tri_best = f;
      ub = u;
      vb = v;
    }
  }
  *t_out = t_best;
  *tri_out = tri_best;
  *u_out = ub;
  *v_out = vb;
  return tri_best >= 0;
}

Vec mesh_normal(const Scene &S, int obj_i, int tri, const Vec &p) {
  // barycentrics recomputed by projecting the hit point p — the same
  // definition the jnp engine and NumPy golden use (Hit carries no u,v)
  const int32_t *mo = S.mesh_obj + 3 * obj_i;
  const int32_t *fc = S.mesh_faces + 3 * tri;
  const float *a = S.mesh_verts + 3 * fc[0];
  const float *b = S.mesh_verts + 3 * fc[1];
  const float *c = S.mesh_verts + 3 * fc[2];
  Vec e1{b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  Vec e2{c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  if (!mo[2]) {  // flat: geometric normal
    return normalize({e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
                      e1.x * e2.y - e1.y * e2.x});
  }
  Vec w_{p.x - a[0], p.y - a[1], p.z - a[2]};
  float d11 = dot(e1, e1);
  float d12 = dot(e1, e2);
  float d22 = dot(e2, e2);
  float dw1 = dot(w_, e1);
  float dw2 = dot(w_, e2);
  float denom = d11 * d22 - d12 * d12;
  if (std::fabs(denom) < 1e-20f) denom = 1e-20f;
  float u = (d22 * dw1 - d12 * dw2) / denom;
  float v = (d11 * dw2 - d12 * dw1) / denom;
  float w = 1.0f - u - v;
  const float *n0 = S.mesh_vnorm + 3 * fc[0];
  const float *n1 = S.mesh_vnorm + 3 * fc[1];
  const float *n2 = S.mesh_vnorm + 3 * fc[2];
  Vec n{(w * n0[0] + u * n1[0]) + v * n2[0],
        (w * n0[1] + u * n1[1]) + v * n2[1],
        (w * n0[2] + u * n1[2]) + v * n2[2]};
  return normalize(n);
}

struct ObjView {
  int engine, node_off, n_nodes, leaf_off, n_leaves, mat, shininess;
};
ObjView obj_view(const Scene &S, int i) {
  const int32_t *o = S.objs + 7 * i;
  return {o[0], o[1], o[2], o[3], o[4], o[5], o[6]};
}

// ---------------------------------------------------------------- analytic
struct Interval {
  float t0, t1;
};

Interval leaf_interval(const Scene &S, const ObjView &O, int li,
                       const Vec &o, const Vec &d) {
  const int32_t *m = S.leaf_meta + 4 * (O.leaf_off + li);
  const float *p = S.leaf_params + 8 * (O.leaf_off + li);
  int kind = m[0];
  if (kind == LEAF_SPHERE) {
    Vec c{p[0], p[1], p[2]};
    float r = p[3];
    Vec oc = sub(o, c);
    float b = dot(oc, d);
    float cc = dot(oc, oc) - r * r;
    float disc = b * b - cc;
    if (disc < 0.0f) return {BIG, -BIG};
    float sq = std::sqrt(disc);
    float s = (b >= 0.0f) ? 1.0f : -1.0f;
    float q = -(b + s * sq);
    float r0 = q;
    float r1 = (q != 0.0f) ? cc / q : -b;
    return {std::fmin(r0, r1), std::fmax(r0, r1)};
  }
  if (kind == LEAF_PLANE) {
    Vec n{p[0], p[1], p[2]};
    float off = p[3];
    float denom = dot(n, d);
    float no = dot(n, o);
    if (denom == 0.0f) {
      bool inside = (no - off) < 0.0f;
      return inside ? Interval{-BIG, BIG} : Interval{BIG, -BIG};
    }
    float t_star = (off - no) / denom;
    if (denom < 0.0f) return {t_star, BIG};
    return {-BIG, t_star};
  }
  // LEAF_BOX
  Vec c{p[0], p[1], p[2]};
  Vec h{p[3], p[4], p[5]};
  float t0 = -BIG, t1 = BIG;
  const float oc[3] = {o.x, o.y, o.z};
  const float dc[3] = {d.x, d.y, d.z};
  const float cc_[3] = {c.x, c.y, c.z};
  const float hc[3] = {h.x, h.y, h.z};
  for (int ax = 0; ax < 3; ++ax) {
    if (dc[ax] == 0.0f) {
      bool in_slab = std::fabs(oc[ax] - cc_[ax]) <= hc[ax];
      if (!in_slab) return {BIG, -BIG};
      continue;
    }
    float inv = 1.0f / dc[ax];
    float lo = (cc_[ax] - hc[ax] - oc[ax]) * inv;
    float hi = (cc_[ax] + hc[ax] - oc[ax]) * inv;
    float tn = std::fmin(lo, hi);
    float tf = std::fmax(lo, hi);
    t0 = std::fmax(t0, tn);
    t1 = std::fmin(t1, tf);
  }
  if (t0 > t1) return {BIG, -BIG};
  return {t0, t1};
}

bool eval_bool_tree(const Scene &S, const ObjView &O, const bool *statuses) {
  bool vals[64];
  for (int ni = 0; ni < O.n_nodes; ++ni) {
    const int32_t *nd = S.nodes + 5 * (O.node_off + ni);
    int op = nd[0];
    if (op == OP_LEAF) vals[ni] = statuses[nd[3]];
    else if (op == OP_UNION) vals[ni] = vals[nd[1]] | vals[nd[2]];
    else if (op == OP_INTERSECT) vals[ni] = vals[nd[1]] & vals[nd[2]];
    else vals[ni] = vals[nd[1]] & (!vals[nd[2]]);
  }
  return vals[O.n_nodes - 1];
}

void intersect_analytic(const Scene &S, const ObjView &O, const Vec &o,
                        const Vec &d, float t_min, float t_max, float *t_out,
                        int *leaf_out) {
  Interval iv[32];
  for (int li = 0; li < O.n_leaves; ++li) iv[li] = leaf_interval(S, O, li, o, d);
  if (O.n_leaves == 1 && O.n_nodes == 1) {
    float t0 = iv[0].t0, t1 = iv[0].t1;
    if (t0 > t_min && t0 < t_max) { *t_out = t0; *leaf_out = 0; return; }
    if (t1 > t_min && t1 < t_max) { *t_out = t1; *leaf_out = 0; return; }
    *t_out = BIG; *leaf_out = 0; return;
  }
  float t_best = BIG;
  int leaf_best = 0;
  bool before[32], after[32];
  for (int li = 0; li < O.n_leaves; ++li) {
    for (int ep = 0; ep < 2; ++ep) {
      float t_e = ep == 0 ? iv[li].t0 : iv[li].t1;
      if (!(t_e > t_min && t_e < t_max)) continue;
      for (int lj = 0; lj < O.n_leaves; ++lj) {
        if (lj == li) {
          bool b = (ep == 1);
          before[lj] = b;
          after[lj] = !b;
        } else {
          bool inside = (iv[lj].t0 < t_e) && (t_e < iv[lj].t1);
          before[lj] = inside;
          after[lj] = inside;
        }
      }
      bool flip = eval_bool_tree(S, O, before) != eval_bool_tree(S, O, after);
      if (flip && t_e < t_best) { t_best = t_e; leaf_best = li; }
    }
  }
  *t_out = t_best;
  *leaf_out = leaf_best;
}

Vec leaf_normal(const Scene &S, const ObjView &O, int li, const Vec &p) {
  const int32_t *m = S.leaf_meta + 4 * (O.leaf_off + li);
  const float *prm = S.leaf_params + 8 * (O.leaf_off + li);
  int kind = m[0];
  if (kind == LEAF_SPHERE) {
    Vec c{prm[0], prm[1], prm[2]};
    return normalize(sub(p, c));
  }
  if (kind == LEAF_PLANE) return {prm[0], prm[1], prm[2]};
  // box
  Vec c{prm[0], prm[1], prm[2]};
  Vec h{prm[3], prm[4], prm[5]};
  Vec q = sub(p, c);
  float dx = std::fabs(q.x) - h.x;
  float dy = std::fabs(q.y) - h.y;
  float dz = std::fabs(q.z) - h.z;
  float sx = q.x >= 0.0f ? 1.0f : -1.0f;
  float sy = q.y >= 0.0f ? 1.0f : -1.0f;
  float sz = q.z >= 0.0f ? 1.0f : -1.0f;
  bool x_wins = (dx >= dy) && (dx >= dz);
  bool y_wins = (!x_wins) && (dy >= dz);
  if (x_wins) return {sx, 0.0f, 0.0f};
  if (y_wins) return {0.0f, sy, 0.0f};
  return {0.0f, 0.0f, sz};
}

// --------------------------------------------------------------------- sdf
// Bitwise-portable f32 log — the C++ mirror of core.math.portable_log
// (RenderSettings.bulb_log == "portable"). Identical reduction, f32
// constants and two-round association as the jnp and NumPy mirrors
// (this TU builds with -ffp-contract=off, so every op rounds once);
// pinned bitwise in tests/test_portable_log.py. Domain: normal positive
// finite x (callers guard with fmax(x, 1e-30f)).
static bool g_portable_log = false;

static inline float portable_logf(float x) {
  static const float C[9] = {
      -0.4999999701976776f, 0.33333322405815125f, -0.2500077188014984f,
      0.2000196874141693f, -0.1662759929895401f, 0.1418900042772293f,
      -0.131016343832016f, 0.12821748852729797f, -0.07866667956113815f};
  int32_t bits;
  std::memcpy(&bits, &x, 4);
  int32_t e = ((bits >> 23) & 0xFF) - 126;
  int32_t fb = (bits & 0x007FFFFF) | 0x3F000000;
  float f;
  std::memcpy(&f, &fb, 4);
  if (f < 0.7071067811865476f) { f = f + f; e -= 1; }
  float ef = (float)e;
  float u = f - 1.0f;
  float g = C[8];
  for (int i = 7; i >= 0; --i) g = g * u + C[i];
  float u2 = u * u;
  float l1p = u + u2 * g;
  return ef * 0.6931457519531250f + (l1p + ef * 1.4286067653301955e-06f);
}

float leaf_sdf(const Scene &S, const ObjView &O, int li, const Vec &p) {
  const int32_t *m = S.leaf_meta + 4 * (O.leaf_off + li);
  const float *prm = S.leaf_params + 8 * (O.leaf_off + li);
  int kind = m[0];
  if (kind == LEAF_SPHERE) {
    Vec q = sub(p, {prm[0], prm[1], prm[2]});
    return std::sqrt(dot(q, q)) - prm[3];
  }
  if (kind == LEAF_PLANE) {
    return dot({prm[0], prm[1], prm[2]}, p) - prm[3];
  }
  if (kind == LEAF_BOX) {
    float qx = std::fabs(p.x - prm[0]) - prm[3];
    float qy = std::fabs(p.y - prm[1]) - prm[4];
    float qz = std::fabs(p.z - prm[2]) - prm[5];
    float ox = std::fmax(qx, 0.0f);
    float oy = std::fmax(qy, 0.0f);
    float oz = std::fmax(qz, 0.0f);
    float outside = std::sqrt((ox * ox + oy * oy) + oz * oz);
    float inside = std::fmin(std::fmax(qx, std::fmax(qy, qz)), 0.0f);
    return outside + inside;
  }
  // Mandelbulb (trig-free power-8; mirrors the defined semantics)
  int power = m[2];
  int iterations = m[3];
  float scale = prm[3];
  float bailout2 = prm[4] * prm[4] * 16.0f;
  float inv_s = 1.0f / scale;
  float px = (p.x - prm[0]) * inv_s;
  float py = (p.y - prm[1]) * inv_s;
  float pz = (p.z - prm[2]) * inv_s;
  float wx = px, wy = py, wz = pz;
  float mm = (wx * wx + wy * wy) + wz * wz;
  float dz = 1.0f;
  const float tiny = 1e-4f;
  if (power != 8) {
    // general power-n trig DE (engines/sdf.sdf_mandelbulb_general)
    const float tg = 1e-12f;
    float pw = (float)power;
    for (int it = 0; it < iterations; ++it) {
      if (mm > bailout2) break;
      float r = std::sqrt(std::fmax(mm, tg));
      float rp1 = std::exp((float)(power - 1) * std::log(r));
      dz = pw * rp1 * dz + 1.0f;
      float ct = wz / r;
      ct = std::fmin(std::fmax(ct, -1.0f), 1.0f);
      float theta = std::acos(ct) * pw;
      float phi = std::atan2(wy, wx) * pw;
      float zr = rp1 * r;
      float st = std::sin(theta);
      wx = px + zr * (st * std::cos(phi));
      wy = py + zr * (st * std::sin(phi));
      wz = pz + zr * std::cos(theta);
      mm = (wx * wx + wy * wy) + wz * wz;
    }
    float r = std::sqrt(std::fmax(mm, tg));
    float de = 0.25f * std::log(std::fmax(mm, tg)) * r / dz;
    float r0 = std::sqrt((px * px + py * py) + pz * pz);
    float far_ = r0 - 1.35f;
    if (far_ > 0.0f && far_ + 0.1f < de) de = far_ + 0.1f;
    return de * scale;
  }
  for (int it = 0; it < iterations; ++it) {
    if (mm > bailout2) break;
    float m2 = mm * mm;
    float m4 = m2 * m2;
    dz = 8.0f * std::sqrt((m4 * m2) * mm) * dz + 1.0f;
    float x = wx, y = wy, z = wz;
    float x2 = x * x, x4 = x2 * x2;
    float y2 = y * y, y4 = y2 * y2;
    float z2 = z * z, z4 = z2 * z2;
    float k3 = x2 + z2;
    float k3s = std::fmax(k3, tiny);
    float k37 = ((k3s * k3s) * (k3s * k3s)) * ((k3s * k3s) * k3s);
    float k2 = 1.0f / std::sqrt(k37);
    float k1 = ((x4 + y4) + z4) - 6.0f * (y2 * z2) - 6.0f * (x2 * y2) +
               2.0f * (z2 * x2);
    float k4 = (x2 - y2) + z2;
    wx = px + 64.0f * ((((x * y) * z) * (x2 - z2)) * k4) *
                  ((x4 - 6.0f * (x2 * z2)) + z4) * k1 * k2;
    wy = py + (-16.0f * (y2 * k3) * (k4 * k4) + k1 * k1);
    wz = pz + -8.0f * (y * k4) *
                  ((((x4 * x4) - 28.0f * ((x4 * x2) * z2)) +
                    70.0f * (x4 * z4)) -
                   28.0f * ((x2 * z2) * z4) + (z4 * z4)) *
                  k1 * k2;
    mm = (wx * wx + wy * wy) + wz * wz;
  }
  float r = std::sqrt(mm);
  // max(mm, 1e-30): same guard as engines/sdf (de exactly 0 at mm == 0
  // instead of log(0)*0 = NaN); identical for every normal mm
  float lg = g_portable_log ? portable_logf(std::fmax(mm, 1e-30f))
                          : std::log(std::fmax(mm, 1e-30f));
  float de = 0.25f * lg * r / dz;
  // far-field guard -- see engines/sdf.sdf_mandelbulb
  float r0 = std::sqrt((px * px + py * py) + pz * pz);
  float far_ = r0 - 1.35f;
  if (far_ > 0.0f && far_ + 0.1f < de) de = far_ + 0.1f;
  return de * scale;
}

float eval_sdf(const Scene &S, const ObjView &O, const Vec &p) {
  float vals[64];
  for (int ni = 0; ni < O.n_nodes; ++ni) {
    const int32_t *nd = S.nodes + 5 * (O.node_off + ni);
    int op = nd[0];
    if (op == OP_LEAF) {
      vals[ni] = leaf_sdf(S, O, nd[3], p);
    } else if (op == OP_UNION) {
      vals[ni] = std::fmin(vals[nd[1]], vals[nd[2]]);
    } else if (op == OP_INTERSECT) {
      vals[ni] = std::fmax(vals[nd[1]], vals[nd[2]]);
    } else if (op == OP_SUBTRACT) {
      vals[ni] = std::fmax(vals[nd[1]], -vals[nd[2]]);
    } else {
      float a = vals[nd[1]], b = vals[nd[2]];
      float k = S.node_k[nd[4]];
      if (op == OP_SUNION) {
        float h = saturate(0.5f + 0.5f * (b - a) / k);
        vals[ni] = mixf(b, a, h) - k * h * (1.0f - h);
      } else if (op == OP_SINTER) {
        float h = saturate(0.5f - 0.5f * (b - a) / k);
        vals[ni] = mixf(b, a, h) + k * h * (1.0f - h);
      } else {
        float h = saturate(0.5f - 0.5f * (b + a) / k);
        vals[ni] = mixf(a, -b, h) + k * h * (1.0f - h);
      }
    }
  }
  return vals[O.n_nodes - 1];
}

float sphere_trace(const Scene &S, const ObjView &O, const Vec &o,
                   const Vec &d, float t_min, float t_max, bool *hit) {
  float t = t_min;
  *hit = false;
  for (int i = 0; i < S.max_steps; ++i) {
    Vec p{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
    float h = eval_sdf(S, O, p);
    if (h < S.hit_eps + S.hit_eps_scale * t) { *hit = true; return t; }
    if (t > t_max) return BIG;
    t = t + h;
  }
  return BIG;
}

float scene_sdf_nonmesh(const Scene &S, const Vec &p) {
  float v = BIG;
  for (int i = 0; i < S.n_objs; ++i) {
    ObjView O = obj_view(S, i);
    if (O.engine == ENGINE_MESH) continue;
    v = std::fmin(v, eval_sdf(S, O, p));
  }
  return v;
}

Vec normal_fd(const Scene &S, const ObjView &O, const Vec &p) {
  float e = S.normal_eps;
  float s0 = eval_sdf(S, O, {p.x + e, p.y - e, p.z - e});
  float s1 = eval_sdf(S, O, {p.x - e, p.y - e, p.z + e});
  float s2 = eval_sdf(S, O, {p.x - e, p.y + e, p.z - e});
  float s3 = eval_sdf(S, O, {p.x + e, p.y + e, p.z + e});
  float nx = ((s0 - s1) - s2) + s3;
  float ny = ((-s0 - s1) + s2) + s3;
  float nz = ((-s0 + s1) - s2) + s3;
  return normalize({nx, ny, nz});
}

float soft_shadow(const Scene &S, const Vec &o, const Vec &d, float t_max,
                  float k) {
  // k: per-ray penumbra sharpness — area lights pass dist/radius, else
  // the global soft_shadow_k (same rule as renderer.py / frame.py)
  float t = S.soft_tmin;
  float res = 1.0f;
  // light nearer than t_min -> no shadow segment, visibility 1 (same
  // rule as the kernel and engines/sdf; never sample beyond the light)
  if (t > t_max) return 1.0f;
  for (int i = 0; i < S.shadow_steps; ++i) {
    Vec p{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
    float h = scene_sdf_nonmesh(S, p);
    float res_new = std::fmin(res, k * h / t);
    float s_allowed = (k * h - res_new * t) / (k + res_new);
    float step = clampf(h, 1e-3f, std::fmax(0.5f, s_allowed));
    float t_new = t + step;
    res = res_new;
    t = t_new;
    if (res_new < 0.004f || t_new > t_max) break;
  }
  return saturate(res);
}

const float AO_DIRS[9][3] = {
    {0.0f, 0.0f, 1.0f},   {0.7f, 0.0f, 0.7141428f},
    {-0.7f, 0.0f, 0.7141428f}, {0.0f, 0.7f, 0.7141428f},
    {0.0f, -0.7f, 0.7141428f}, {0.5f, 0.5f, 0.7071068f},
    {-0.5f, 0.5f, 0.7071068f}, {0.5f, -0.5f, 0.7071068f},
    {-0.5f, -0.5f, 0.7071068f}};

float ao_probe(const Scene &S, const Vec &p, const Vec &n) {
  int samples = S.ao_samples < 9 ? S.ao_samples : 9;
  bool big_y = std::fabs(n.y) > 0.9f;
  float hx = big_y ? 1.0f : 0.0f;
  float hy = big_y ? 0.0f : 1.0f;
  Vec t1 = normalize({hy * n.z, -hx * n.z, hx * n.y - hy * n.x});
  Vec t2 = {n.y * t1.z - n.z * t1.y, n.z * t1.x - n.x * t1.z,
            n.x * t1.y - n.y * t1.x};
  float occ = 0.0f;
  for (int s = 0; s < samples; ++s) {
    float ax = AO_DIRS[s][0], ay = AO_DIRS[s][1], az = AO_DIRS[s][2];
    Vec dir{(ax * t1.x + ay * t2.x) + az * n.x,
            (ax * t1.y + ay * t2.y) + az * n.y,
            (ax * t1.z + ay * t2.z) + az * n.z};
    for (int tap = 1; tap <= 4; ++tap) {
      float r = S.ao_radius * (float)tap * 0.25f;
      Vec q{p.x + dir.x * r, p.y + dir.y * r, p.z + dir.z * r};
      float h = scene_sdf_nonmesh(S, q);
      occ = occ + std::fmax(az * r - h, 0.0f) / r;
    }
  }
  occ = occ / (float)(samples * 4);
  return saturate(1.0f - S.ao_strength * occ);
}

void trace_scene(const Scene &S, const Vec &o, const Vec &d, float t_min,
                 float t_max, float *t_out, int *obj_out, int *leaf_out,
                 float *u_out = nullptr, float *v_out = nullptr) {
  float t_best = BIG;
  int obj_best = -1, leaf_best = 0;
  float u_best = 0.0f, v_best = 0.0f;
  for (int i = 0; i < S.n_objs; ++i) {
    ObjView O = obj_view(S, i);
    float t_i = BIG;
    int leaf_i = 0;
    float u_i = 0.0f, v_i = 0.0f;
    if (O.engine == ENGINE_ANALYTIC) {
      intersect_analytic(S, O, o, d, t_min, t_max, &t_i, &leaf_i);
    } else if (O.engine == ENGINE_SDF) {
      bool hit;
      t_i = sphere_trace(S, O, o, d, t_min, t_max, &hit);
      if (!hit) t_i = BIG;
    } else {  // ENGINE_MESH (brute force)
      int tri;
      mesh_intersect(S, i, o, d, t_min, t_max, &t_i, &tri, &u_i, &v_i);
      leaf_i = tri;
    }
    if (t_i < t_best) {
      t_best = t_i; obj_best = i; leaf_best = leaf_i;
      u_best = u_i; v_best = v_i;
    }
  }
  *t_out = t_best;
  *obj_out = obj_best;
  *leaf_out = leaf_best;
  if (u_out) { *u_out = u_best; *v_out = v_best; }
}

}  // namespace

extern "C" void sj_golden_render(
    const float *headerf, const int32_t *headeri, const int32_t *objs,
    int n_objs, const int32_t *nodes, const int32_t *leaf_meta,
    const float *leaf_params, const float *node_k, const float *materials,
    const float *lights, const int32_t *light_kinds, int n_lights,
    const float *mesh_verts, const float *mesh_vnorm,
    const int32_t *mesh_faces, const int32_t *mesh_obj,
    float *out_rgb, float *out_depth, float *out_normal, float *out_hit,
    int32_t *out_obj) {
  Scene S;
  int fi = 0;
  S.fx = headerf[fi++]; S.fy = headerf[fi++];
  S.cx = headerf[fi++]; S.cy = headerf[fi++];
  for (int i = 0; i < 9; ++i) S.R[i] = headerf[fi++];
  S.pos = {headerf[fi], headerf[fi + 1], headerf[fi + 2]}; fi += 3;
  S.t_min = headerf[fi++]; S.t_max = headerf[fi++];
  S.hit_eps = headerf[fi++]; S.hit_eps_scale = headerf[fi++];
  S.normal_eps = headerf[fi++];
  S.shadow_eps = headerf[fi++];
  S.soft_k = headerf[fi++]; S.soft_tmin = headerf[fi++];
  S.ao_radius = headerf[fi++]; S.ao_strength = headerf[fi++];
  S.bg = {headerf[fi], headerf[fi + 1], headerf[fi + 2]}; fi += 3;
  S.ambient = {headerf[fi], headerf[fi + 1], headerf[fi + 2]}; fi += 3;

  int ii = 0;
  S.width = headeri[ii++]; S.height = headeri[ii++];
  S.max_steps = headeri[ii++]; S.shadow_steps = headeri[ii++];
  S.ao_samples = headeri[ii++];
  S.shadows = headeri[ii++]; S.soft_shadows = headeri[ii++];
  S.ao = headeri[ii++];
  S.fd_normals = headeri[ii++];
  g_portable_log = headeri[ii++] != 0;

  S.objs = objs; S.n_objs = n_objs;
  S.nodes = nodes; S.leaf_meta = leaf_meta;
  S.leaf_params = leaf_params; S.node_k = node_k;
  S.materials = materials; S.lights = lights;
  S.light_kinds = light_kinds; S.n_lights = n_lights;
  S.mesh_verts = mesh_verts; S.mesh_vnorm = mesh_vnorm;
  S.mesh_faces = mesh_faces; S.mesh_obj = mesh_obj;

  S.any_nonmesh = false;
  for (int oi = 0; oi < S.n_objs; ++oi)
    if (obj_view(S, oi).engine != ENGINE_MESH) S.any_nonmesh = true;

  // Per-pixel independent (every iteration writes only its own idx), so
  // row-strided threading is bitwise-exact — the per-pixel arithmetic is
  // untouched. Thread count: SJ_GOLDEN_THREADS env or hardware
  // concurrency (capped); strided rows load-balance the fractal rows.
  int n_threads = 1;
  if (const char *env = std::getenv("SJ_GOLDEN_THREADS")) {
    n_threads = std::max(1, std::atoi(env));
  } else {
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  }
  n_threads = std::min(n_threads, 64);
  auto render_rows = [&](int tid) {
  for (int row = tid; row < S.height; row += n_threads) {
    for (int col = 0; col < S.width; ++col) {
      int idx = row * S.width + col;
      float xc = ((float)col + 0.5f - S.cx) / S.fx;
      float yc = ((float)row + 0.5f - S.cy) / S.fy;
      float dx = (S.R[0] * xc + S.R[1] * yc) + S.R[2];
      float dy = (S.R[3] * xc + S.R[4] * yc) + S.R[5];
      float dz = (S.R[6] * xc + S.R[7] * yc) + S.R[8];
      Vec d = normalize({dx, dy, dz});
      Vec o = S.pos;

      float t;
      int obj_id, leaf_id;
      float uu, vv;
      trace_scene(S, o, d, S.t_min, S.t_max, &t, &obj_id, &leaf_id,
                  &uu, &vv);
      bool hit = t < BIG * 0.5f;
      float ts = hit ? t : 0.0f;
      Vec p{o.x + ts * d.x, o.y + ts * d.y, o.z + ts * d.z};

      Vec n{0.0f, 0.0f, 1.0f};
      Vec n_off_v{0.0f, 0.0f, 1.0f};
      if (hit) {
        ObjView O = obj_view(S, obj_id);
        if (O.engine == ENGINE_ANALYTIC && !S.fd_normals) {
          Vec ln = leaf_normal(S, O, leaf_id, p);
          float sgn = (float)S.leaf_meta[4 * (O.leaf_off + leaf_id) + 1];
          n = scale(ln, sgn);
          if (dot(n, d) > 0.0f) n = scale(n, -1.0f);
          n_off_v = n;
        } else if (O.engine == ENGINE_ANALYTIC || O.engine == ENGINE_SDF) {
          n = normal_fd(S, O, p);
          if (dot(n, d) > 0.0f) n = scale(n, -1.0f);
          n_off_v = n;
        } else {
          n = mesh_normal(S, obj_id, leaf_id, p);
          if (dot(n, d) > 0.0f) n = scale(n, -1.0f);
          // geometric normal for the secondary-ray offset
          const int32_t *fc = S.mesh_faces + 3 * leaf_id;
          const float *a = S.mesh_verts + 3 * fc[0];
          const float *b = S.mesh_verts + 3 * fc[1];
          const float *c = S.mesh_verts + 3 * fc[2];
          Vec e1{b[0] - a[0], b[1] - a[1], b[2] - a[2]};
          Vec e2{c[0] - a[0], c[1] - a[1], c[2] - a[2]};
          Vec gn = normalize({e1.y * e2.z - e1.z * e2.y,
                              e1.z * e2.x - e1.x * e2.z,
                              e1.x * e2.y - e1.y * e2.x});
          if (dot(gn, d) > 0.0f) gn = scale(gn, -1.0f);
          n_off_v = gn;
        }
      }
      Vec p_off{p.x + n_off_v.x * S.shadow_eps,
                p.y + n_off_v.y * S.shadow_eps,
                p.z + n_off_v.z * S.shadow_eps};

      float ao = 1.0f;
      if (S.ao && hit) ao = ao_probe(S, p_off, n);

      Vec v{-d.x, -d.y, -d.z};
      float r_out = S.bg.x, g_out = S.bg.y, b_out = S.bg.z;

      if (hit) {
        ObjView O = obj_view(S, obj_id);
        const float *mat = S.materials + 9 * O.mat;
        float alb[3] = {mat[0], mat[1], mat[2]};
        float ka = mat[3], kd = mat[4], ks = mat[5];
        float spc[3] = {mat[6], mat[7], mat[8]};
        float amb[3] = {S.ambient.x, S.ambient.y, S.ambient.z};
        float acc[3];
        for (int c = 0; c < 3; ++c) acc[c] = ka * alb[c] * amb[c] * ao;

        for (int li = 0; li < S.n_lights; ++li) {
          const float *L = S.lights + 7 * li;
          Vec l;
          float dist;
          if (S.light_kinds[li] == LIGHT_POINT) {
            Vec lv{L[0] - p_off.x, L[1] - p_off.y, L[2] - p_off.z};
            dist = std::sqrt(dot(lv, lv));
            l = scale(lv, 1.0f / dist);
          } else {
            l = {-L[0], -L[1], -L[2]};
            dist = S.t_max;
          }
          float vis = 1.0f;
          if (S.shadows) {
            // the soft path applies only when a non-mesh object exists
            // (renderer.py:727): the penumbra march sees only non-mesh
            // SDFs; mesh occluders multiply in as hard shadows below
            if (S.soft_shadows && S.any_nonmesh) {
              float radius = (S.light_kinds[li] == LIGHT_POINT)
                                 ? L[6] : 0.0f;
              float k = radius > 0.0f ? dist / radius : S.soft_k;
              vis = soft_shadow(S, p_off, l, dist, k);
              for (int oi = 0; oi < S.n_objs; ++oi) {
                if (obj_view(S, oi).engine != ENGINE_MESH) continue;
                float t_m;
                int tri;
                float uu2, vv2;
                if (mesh_intersect(S, oi, p_off, l, S.shadow_eps, dist,
                                   &t_m, &tri, &uu2, &vv2) && t_m < dist)
                  vis = 0.0f;
              }
            } else {
              float t_s;
              int oo, ll;
              trace_scene(S, p_off, l, S.shadow_eps, dist, &t_s, &oo, &ll);
              if (t_s < dist) vis = 0.0f;
            }
          }
          float ndotl = std::fmax(dot(n, l), 0.0f);
          float diffc = kd * ndotl;
          // guarded half-vector (see shade.py: l == -v would NaN)
          Vec hh{l.x + v.x, l.y + v.y, l.z + v.z};
          float inv_h = 1.0f / std::sqrt(std::fmax(dot(hh, hh), 1e-20f));
          Vec hv = scale(hh, inv_h);
          float ndoth = std::fmax(dot(n, hv), 0.0f);
          float spec = ks * pow_int(ndoth, O.shininess);
          acc[0] = acc[0] + vis * L[3] * (diffc * alb[0] + spec * spc[0]);
          acc[1] = acc[1] + vis * L[4] * (diffc * alb[1] + spec * spc[1]);
          acc[2] = acc[2] + vis * L[5] * (diffc * alb[2] + spec * spc[2]);
        }
        r_out = acc[0]; g_out = acc[1]; b_out = acc[2];
      }

      out_rgb[3 * idx + 0] = r_out;
      out_rgb[3 * idx + 1] = g_out;
      out_rgb[3 * idx + 2] = b_out;
      out_depth[idx] = ts;
      float hf = hit ? 1.0f : 0.0f;
      out_normal[3 * idx + 0] = n.x * hf;
      out_normal[3 * idx + 1] = n.y * hf;
      out_normal[3 * idx + 2] = n.z * hf;
      out_hit[idx] = hf;
      out_obj[idx] = hit ? obj_id : -1;
    }
  }
  };  // render_rows

  if (n_threads == 1) {
    render_rows(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int tid = 0; tid < n_threads; ++tid)
      pool.emplace_back(render_rows, tid);
    for (auto &th : pool) th.join();
  }
}
