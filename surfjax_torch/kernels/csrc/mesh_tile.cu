// Packet mesh kernel for Hopper (sm_90a).
//
// Replaces surfjax/kernels/mesh_tile.py::mesh_tile_kernel (the Pallas TPU
// kernel whose body is _mesh_body): Moller-Trumbore of every ray of a
// (tile_rows x 128) tile against that tile's candidate triangles, in
// ascending candidate order. Nearest-hit form: the least t with strict <,
// so ties go to the lowest triangle index, with the barycentric shading
// normal (or the geometric one for flat meshes) and the geometric normal
// of the winning triangle. Any-hit form (shadow rays): each ray stops at
// its first occluder; only t < t_max is consumed by the caller. A tile
// whose candidate count exceeds K scans the full packed table instead.
// The plain version is kernels/mesh_tile.py::mesh_tile_reference, in the
// same association.
//
// What bounds it on this card: FP32 work, about 50 operations per
// triangle test, times the tests the rays need. A tile's list is
// conservative for the union of its thousands of rays' segments, so most
// of a ray's candidates are triangles it cannot reach, and a tile that
// overflows K has every triangle as a candidate.
//
// What the design does about it: one thread per ray, in warps of 16x2 rays
// that share nothing (no shared memory, no barrier). Each warp culls its
// tile's candidates for its own rays. A lane clips its ray to the mesh's
// grid box with mesh_candidates' slab arithmetic (the same operations in
// the same order); the warp takes the box of its segments' endpoints and
// mesh_candidates' three oriented axes formed for the warp (its valid
// lanes' directions summed and normalised, and two orthogonals) with the
// range of the endpoints' projections on each, all padded by the same eps
// (warp_box; its min and max are one integer reduction each on bits that
// order as the floats do). Then, 32 candidates at a time, each lane loads
// one candidate's v0/e1/e2 through L1 and tests its box and, where that
// passed, its projections against the warp's region, and the warp votes
// (__ballot_sync); the lanes test the voted candidates in ascending order,
// the rows read through L1 again (three 16-byte loads; the normals only on
// an improving hit). A warp leaves once none of its lanes searches (an
// any-hit lane stops at its first occluder). A triangle that a lane hits
// meets that lane's segment, whose box and projections lie inside the
// warp's, so the vote keeps it: the nearest hit, its ties and the first
// occluder are those of the unculled scan (mesh_candidates' own argument,
// per warp). The vote's plain version is mesh_tile.mesh_warp_masks.
// PERF.md has each element's time against this kernel with it left out,
// and those of the elements measured and left out: staging the tile's
// list in shared memory, 8x4 and 32x1 warps, a prefetch of the next
// chunk's rows.
//
// PROF (a template parameter: the production code has no probes) adds per
// warp lane 0's clock64 deltas per phase, the chunks voted on, the test
// loop's trips and lane-tests, each lane's test count and every chunk's
// vote (MeshTileProf).
//
// C interface (bound with ctypes, no PyTorch headers):
//   int mt_mesh_tile(MeshTileArgs args, int device, void* stream)
//   int mt_mesh_tile_profile(MeshTileArgs args, MeshTileProf prof,
//                            int device, void* stream)
//       -> cudaError_t of the launch

#include <cuda_runtime.h>

#define MT_ROW 24
#define MT_FULL 0xffffffffu
#define MT_WX 16          // warps of 16x2 rays (mesh_tile.MT_WX)
#define MT_THREADS 256    // blocks of two rows of the (rows, 128) rays

// render_tile/mesh_tile.MeshTileArgs, passed by value.
struct MeshTileArgs {
  const float* tri;     // (n_tris, 24): v0 e1 e2 gn n0 n1 n2 pad
  const int* cand;      // (tiles, K) candidate triangle ids
  const int* counts;    // (tiles,) candidate counts; > K means overflow
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* tmax;    // per-ray segment end
  float* t;             // BIG on a miss
  float* nsx; float* nsy; float* nsz;   // shading normal
  float* ngx; float* ngy; float* ngz;   // geometric normal
  int n_rays, tile_rays, K, n_tris, any_hit, smooth;
  float t_min;
  float box_lo[3], box_hi[3];   // the mesh's grid box (only the cull)
};

// mesh_tile.MeshTileProf, passed by value: the profiling instantiation's
// outputs.
struct MeshTileProf {
  unsigned long long* rec;   // (warps, MP_PHASES, 3): cycles, trips, lanes
  int* tests;                // (n_rays,) triangle tests of each lane
  unsigned* masks;           // (warps, mask_words) each chunk's vote
  int mask_words;
};

// Profile phases (mesh_tile.MT_PHASE_NAMES). Cycles are lane 0's clock64
// deltas between the warp's probes; the chunks the warp votes on sit in
// MP_VOTE's second slot, the test loop's trips (candidates the warp visits)
// and lane-tests in MP_TEST's. A hit's record is timed by the lowest lane
// that records it and taken out of the test loop's cycles.
enum { MP_BOX = 0, MP_VOTE, MP_TEST, MP_RECORD, MP_WRITE, MP_PHASES };

template <bool ON>
struct MtProf {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void chunk() {}
  __device__ __forceinline__ void trip() {}
  __device__ __forceinline__ void test() {}
  __device__ __forceinline__ void rec_begin() {}
  __device__ __forceinline__ void rec_end() {}
  __device__ __forceinline__ void finish(const MeshTileProf&, int, int,
                                         bool) {}
};

template <>
struct MtProf<true> {
  long long cyc[MP_PHASES] = {0, 0, 0, 0, 0};
  long long t, r0 = 0, rec = 0;
  int chunks = 0, trips = 0, tests = 0;
  bool leader = false;
  __device__ __forceinline__ void begin() { t = clock64(); }
  __device__ __forceinline__ void mark(int ph) {
    __syncwarp();
    const long long now = clock64();
    cyc[ph] += now - t;
    t = now;
  }
  __device__ __forceinline__ void chunk() { ++chunks; }
  __device__ __forceinline__ void trip() { ++trips; }
  __device__ __forceinline__ void test() { ++tests; }
  __device__ __forceinline__ void rec_begin() {
    leader = (int)(threadIdx.x & 31) == __ffs(__activemask()) - 1;
    if (leader) r0 = clock64();
  }
  __device__ __forceinline__ void rec_end() {
    if (leader) rec += clock64() - r0;
  }
  // The warp's record (lane 0 writes it) and each lane's test count.
  __device__ __forceinline__ void finish(const MeshTileProf& Q, int warp,
                                         int ray, bool in) {
    __syncwarp();
    long long rec_sum = rec;
    for (int off = 16; off > 0; off >>= 1)
      rec_sum += __shfl_xor_sync(MT_FULL, rec_sum, off);
    const unsigned lanes = __reduce_add_sync(MT_FULL, (unsigned)tests);
    if (in) Q.tests[ray] = tests;
    if ((threadIdx.x & 31) == 0) {
      unsigned long long* r = Q.rec + (size_t)warp * MP_PHASES * 3;
      cyc[MP_TEST] -= rec_sum;
      cyc[MP_RECORD] = rec_sum;
      for (int ph = 0; ph < MP_PHASES; ++ph) r[ph * 3] = cyc[ph];
      r[MP_VOTE * 3 + 1] = chunks;
      r[MP_TEST * 3 + 1] = trips;
      r[MP_TEST * 3 + 2] = lanes;
    }
  }
};

// torch.minimum / torch.maximum: a NaN operand gives NaN (the slab's
// 0 * inf), as in mesh_candidates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// A float's bits as an int that orders as the float does (-0 below +0),
// and back.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// The warp's min of lo and max of hi (exact, in any order), padded by
// mesh_candidates' eps.
__device__ __forceinline__ void warp_range(float lo, float hi, float& plo,
                                           float& phi) {
  const float eps = (float)1e-4;
  plo = unordered(__reduce_min_sync(MT_FULL, ordered(lo))) - eps;
  phi = unordered(__reduce_max_sync(MT_FULL, ordered(hi))) + eps;
}

// The warp's region: the padded box of its lanes' clipped segments (lo >
// hi where no lane's segment meets the grid box) and, on each oriented
// axis, the padded range of the segments' endpoints' projections. Any axis
// is sound: a segment's projection lies between its endpoints'.
struct WarpBox {
  float lo[3], hi[3];
  float axis[3][3], plo[3], phi[3];
};

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float a[3], const float p[3]) {
  return (p[0] * a[0] + p[1] * a[1]) + p[2] * a[2];
}

__device__ __forceinline__ WarpBox warp_box(const MeshTileArgs& A,
                                            const float o[3],
                                            const float d[3], float t_max) {
  const float big = (float)1e30;
  float t_lo = A.t_min, t_hi = t_max;
  for (int ax = 0; ax < 3; ++ax) {
    const bool dz = d[ax] == 0.0f;
    const float inv = 1.0f / (dz ? 1.0f : d[ax]);
    const float ta = (A.box_lo[ax] - o[ax]) * inv;
    const float tb = (A.box_hi[ax] - o[ax]) * inv;
    float tn = nan_min(ta, tb), tf = nan_max(ta, tb);
    const bool in_slab = o[ax] > A.box_lo[ax] && o[ax] < A.box_hi[ax];
    if (dz) {
      tn = in_slab ? -big : big;
      tf = in_slab ? big : -big;
    }
    t_lo = nan_max(t_lo, tn);
    t_hi = nan_min(t_hi, tf);
  }
  const bool valid = t_lo <= t_hi;
  WarpBox b;
  float pa[3], pb[3];
  for (int ax = 0; ax < 3; ++ax) {
    pa[ax] = o[ax] + t_lo * d[ax];
    pb[ax] = o[ax] + t_hi * d[ax];
    warp_range(valid ? nan_min(pa[ax], pb[ax]) : big,
               valid ? nan_max(pa[ax], pb[ax]) : -big, b.lo[ax], b.hi[ax]);
  }
  // the axes: the valid lanes' directions summed in the butterfly's order
  // (every lane ends with the same sum), normalised, and two orthogonals
  float* w = b.axis[0];
  float* u = b.axis[1];
  for (int k = 0; k < 3; ++k) {
    float s = valid ? d[k] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      s = s + __shfl_xor_sync(MT_FULL, s, off);
    w[k] = s;
  }
  const float nrm = sqrtf((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]);
  const bool ok = nrm > (float)1e-6;
  for (int k = 0; k < 3; ++k) w[k] = ok ? w[k] / nrm : (k == 0 ? 1.0f : 0.0f);
  const bool big_y = fabsf(w[1]) >= (float)0.9;
  const float ref[3] = {big_y ? 1.0f : 0.0f, big_y ? 0.0f : 1.0f, 0.0f};
  cross3(w, ref, u);
  const float un = sqrtf((u[0] * u[0] + u[1] * u[1]) + u[2] * u[2]);
  for (int k = 0; k < 3; ++k) u[k] = u[k] / un;
  cross3(w, u, b.axis[2]);
  for (int a = 0; a < 3; ++a) {
    const float sa = dot3(b.axis[a], pa), sb = dot3(b.axis[a], pb);
    warp_range(valid ? nan_min(sa, sb) : big, valid ? nan_max(sa, sb) : -big,
               b.plo[a], b.phi[a]);
  }
  return b;
}

// Does the triangle (v0, v0 + e1, v0 + e2) meet the warp's region: its
// box the warp's box and then its projection on each axis the warp's
// range? r0 = (v0, e1.x), r1 = (e1.y, e1.z, e2.x, e2.y), e2z.
__device__ __forceinline__ bool tri_overlaps(const WarpBox& b, float4 r0,
                                             float4 r1, float e2z) {
  const float v0[3] = {r0.x, r0.y, r0.z};
  const float e1[3] = {r0.w, r1.x, r1.y};
  const float e2[3] = {r1.z, r1.w, e2z};
  float p1[3], p2[3];
  bool keep = true;
  for (int ax = 0; ax < 3; ++ax) {
    p1[ax] = v0[ax] + e1[ax];
    p2[ax] = v0[ax] + e2[ax];
    const float lo = fminf(fminf(v0[ax], p1[ax]), p2[ax]);
    const float hi = fmaxf(fmaxf(v0[ax], p1[ax]), p2[ax]);
    keep = keep && lo <= b.hi[ax] && hi >= b.lo[ax];
  }
  if (!keep) return false;
  for (int a = 0; a < 3; ++a) {
    const float t0 = dot3(b.axis[a], v0), t1 = dot3(b.axis[a], p1);
    const float t2 = dot3(b.axis[a], p2);
    const float lo = fminf(fminf(t0, t1), t2);
    const float hi = fmaxf(fmaxf(t0, t1), t2);
    keep = keep && lo <= b.phi[a] && hi >= b.plo[a];
  }
  return keep;
}

template <bool PROF>
__global__ void __launch_bounds__(MT_THREADS)
mt_mesh_tile_kernel(const MeshTileArgs A, const MeshTileProf Q) {
  MtProf<PROF> P;
  P.begin();
  // warp w of the block: columns 16 w .. 16 w + 15 of the block's two rows
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * MT_THREADS + (lane / MT_WX) * 128 +
                  w * MT_WX + lane % MT_WX;
  const int warp = (blockIdx.x * MT_THREADS + threadIdx.x) >> 5;
  const int tile = (blockIdx.x * MT_THREADS) / A.tile_rays;
  const int count = A.counts[tile];
  const bool over = count > A.K;
  const int n = over ? A.n_tris : count;
  const int* cand = A.cand + (size_t)tile * A.K;
  const bool in = ray < A.n_rays;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  float t_max = 0.0f;
  if (in) {
    o[0] = A.ox[ray]; o[1] = A.oy[ray]; o[2] = A.oz[ray];
    d[0] = A.dx[ray]; d[1] = A.dy[ray]; d[2] = A.dz[ray];
    t_max = A.tmax[ray];
  }
  float t_best = (float)1e30;   // BIG, rounded as the host rounds it
  float nsx = 0.0f, nsy = 0.0f, nsz = 1.0f;
  float ngx = 0.0f, ngy = 0.0f, ngz = 1.0f;
  // a lane whose segment is empty can hit nothing
  bool active = in && !(t_max <= A.t_min);
  const WarpBox box = warp_box(A, o, d, t_max);
  // a warp whose box is empty (no lane's segment meets the grid box)
  // votes for nothing
  const bool meets = box.lo[0] <= box.hi[0] && box.lo[1] <= box.hi[1] &&
                     box.lo[2] <= box.hi[2];
  const int n_loop = meets ? n : 0;
  P.mark(MP_BOX);
  for (int base = 0; base < n_loop; base += 32) {
    if (!__any_sync(MT_FULL, active)) break;
    P.chunk();
    // the vote: each lane tests one candidate's row against the region
    const int slot = base + lane;
    int id = 0;
    bool keep = false;
    if (slot < n) {
      id = over ? slot : __ldg(cand + slot);
      const float4* src =
          reinterpret_cast<const float4*>(A.tri + (size_t)id * MT_ROW);
      keep = tri_overlaps(box, __ldg(src), __ldg(src + 1), __ldg(src + 2).x);
    }
    unsigned m = __ballot_sync(MT_FULL, keep);
    P.mark(MP_VOTE);
    while (m) {
      const int s = __ffs(m) - 1;
      m &= m - 1;
      P.trip();
      const int ids = __shfl_sync(MT_FULL, id, s);
      const float4* src =
          reinterpret_cast<const float4*>(A.tri + (size_t)ids * MT_ROW);
      const float4 r0 = __ldg(src), r1 = __ldg(src + 1), r2 = __ldg(src + 2);
      if (!active) continue;
      P.test();
      const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
      const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
      const float pvx = d[1] * e2z - d[2] * e2y;
      const float pvy = d[2] * e2x - d[0] * e2z;
      const float pvz = d[0] * e2y - d[1] * e2x;
      const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
      const bool ok = fabsf(det) > (float)1e-7;
      const float inv_det = 1.0f / (ok ? det : 1.0f);
      const float tvx = o[0] - r0.x, tvy = o[1] - r0.y, tvz = o[2] - r0.z;
      const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = ((d[0] * qvx + d[1] * qvy) + d[2] * qvz) * inv_det;
      const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
      const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                       t > A.t_min && t < t_max && t < t_best;
      if (!hit) continue;
      P.rec_begin();
      t_best = t;
      if (A.any_hit) {
        active = false;
        P.rec_end();
        continue;
      }
      ngx = r2.y; ngy = r2.z; ngz = r2.w;
      if (A.smooth) {
        const float4 r3 = __ldg(src + 3), r4 = __ldg(src + 4);
        const float n2z = __ldg(src + 5).x;
        const float w_ = (1.0f - u) - v;
        const float sx = (w_ * r3.x + u * r3.w) + v * r4.z;
        const float sy = (w_ * r3.y + u * r4.x) + v * r4.w;
        const float sz = (w_ * r3.z + u * r4.y) + v * n2z;
        const float inv = 1.0f / sqrtf((sx * sx + sy * sy) + sz * sz);
        nsx = sx * inv; nsy = sy * inv; nsz = sz * inv;
      } else {
        nsx = ngx; nsy = ngy; nsz = ngz;
      }
      P.rec_end();
    }
    P.mark(MP_TEST);
  }
  if (in) {
    A.t[ray] = t_best;
    A.nsx[ray] = nsx; A.nsy[ray] = nsy; A.nsz[ray] = nsz;
    A.ngx[ray] = ngx; A.ngy[ray] = ngy; A.ngz[ray] = ngz;
  }
  P.mark(MP_WRITE);
  P.finish(Q, warp, ray, in);
  if (PROF) {
    // every chunk's vote (outside the timed phases): what mesh_warp_masks
    // must equal
    for (int base = 0; base < n; base += 32) {
      const int slot = base + lane;
      bool keep = false;
      if (slot < n && meets) {
        const int id = over ? slot : cand[slot];
        const float4* src =
            reinterpret_cast<const float4*>(A.tri + (size_t)id * MT_ROW);
        keep = tri_overlaps(box, src[0], src[1], src[2].x);
      }
      const unsigned m = __ballot_sync(MT_FULL, keep);
      if (lane == 0) Q.masks[(size_t)warp * Q.mask_words + base / 32] = m;
    }
  }
}

template <bool PROF>
static int mt_launch(const MeshTileArgs& args, const MeshTileProf& prof,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args.n_rays <= 0) return 0;
  if (args.tile_rays % MT_THREADS != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(args.n_rays / MT_THREADS);
  mt_mesh_tile_kernel<PROF>
      <<<grid, MT_THREADS, 0, (cudaStream_t)stream>>>(args, prof);
  return (int)cudaGetLastError();
}

extern "C" int mt_mesh_tile(MeshTileArgs args, int device, void* stream) {
  return mt_launch<false>(args, MeshTileProf{nullptr, nullptr, nullptr, 0},
                          device, stream);
}

// The profiling instantiation (tools/breakdown.py, section `mesh_phases`).
extern "C" int mt_mesh_tile_profile(MeshTileArgs args, MeshTileProf prof,
                                    int device, void* stream) {
  return mt_launch<true>(args, prof, device, stream);
}
