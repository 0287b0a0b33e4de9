// The mesh kernel's candidate tables, built on the card (sm_90a).
//
// Computes what kernels/mesh_tile.py::mesh_candidates_reference computes:
// for every tile of tile_rays consecutive rays, the triangles whose box
// and whose projections on three oriented axes meet the tile's region,
// compacted in ascending index order into the tile's row of `cand` (K
// slots; the slots at and above min(count, K) hold n_tris - 1) with the
// exact count in `counts` (a count above K makes mesh_tile scan the whole
// table). In surfjax this is jnp glue around the Pallas mesh kernel
// (surfjax/kernels/mesh_tile.py::mesh_candidates); the plain version is
// its PyTorch form, in the same operations and order, so the two give the
// same tables bitwise.
//
// What bounds it on this card: reading each ray once (o, d and t_max, 28
// bytes a ray; twice, the second time mostly from L2) and each tile's
// pass over the triangle table, 36 bytes of each 96-byte row, from L2.
// The tests themselves are a few FP32 operations each, most of them the
// box's.
//
// One block of MC_THREADS threads per tile, one launch per call:
//   1. each thread clips rays tid, tid + MC_THREADS, ... of the tile to the
//      mesh's grid box (mesh_tile.cu's slab arithmetic) and keeps the min
//      and max of its valid lanes' endpoints (exact in any order) and the
//      sum of their directions, lane after lane from +0.0; the warp sums
//      its threads' sums by the __shfl_xor_sync butterfly (16, 8, 4, 2, 1)
//      and the block the warps' totals in warp order (the plain version's
//      _tile_sum repeats that order);
//   2. every thread forms the three axes from the sum (_warp_axes'
//      arithmetic) and the padded box, reads the tile's rays again and
//      reduces their endpoints' projections on the axes to ranges;
//   3. the threads take the triangles MC_THREADS at a time, one each, test
//      its box and then its projections against the tile's region, and
//      compact the passing ones in index order: a __ballot_sync per warp,
//      the warps' counts in shared memory, an exclusive scan over them and
//      a running count carried from chunk to chunk.
// A tile none of whose lanes meets the grid box has no candidate and
// skips step 3. No host sync, no allocation beyond cand and counts.
//
// C interface (bound with ctypes, no PyTorch headers):
//   int mc_candidates(McArgs args, int device, void* stream)
//       -> cudaError_t of the launch

#include <cuda_runtime.h>

#define MC_THREADS 256   // threads per tile (mesh_tile.MC_THREADS)
#define MC_WARPS (MC_THREADS / 32)
#define MC_ROW 24        // packed triangle row: v0 e1 e2 gn n0 n1 n2 pad
#define MC_FULL 0xffffffffu

// mesh_tile.McArgs, passed by value.
struct McArgs {
  const float* tri;     // (n_tris, 24)
  const float* ox; const float* oy; const float* oz;
  const float* dx; const float* dy; const float* dz;
  const float* tmax;    // per-ray segment end, or null: t_max on every ray
  int* cand;            // (tiles, K) candidate triangle ids
  int* counts;          // (tiles,) candidate counts; > K means overflow
  int tiles, tile_rays, K, n_tris;
  float t_min, t_max;
  float box_lo[3], box_hi[3];   // the mesh's grid box (mesh_tile.grid_box)
};

// torch.minimum / torch.maximum: a NaN operand gives NaN.
__device__ __forceinline__ float mc_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float mc_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void mc_cross(const float a[3], const float b[3],
                                         float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float mc_dot(const float a[3], const float p[3]) {
  return (p[0] * a[0] + p[1] * a[1]) + p[2] * a[2];
}

// Ray r of the launch clipped to the grid box (mesh_tile._lane_clip) ->
// whether its segment meets the box, with its entry and exit points and
// its direction.
__device__ __forceinline__ bool mc_clip(const McArgs& A, size_t r,
                                        float pa[3], float pb[3],
                                        float d[3]) {
  const float big = (float)1e30;
  const float o[3] = {__ldg(A.ox + r), __ldg(A.oy + r), __ldg(A.oz + r)};
  d[0] = __ldg(A.dx + r); d[1] = __ldg(A.dy + r); d[2] = __ldg(A.dz + r);
  float t_lo = A.t_min, t_hi = A.tmax ? __ldg(A.tmax + r) : A.t_max;
  for (int ax = 0; ax < 3; ++ax) {
    const bool dz = d[ax] == 0.0f;
    const float inv = 1.0f / (dz ? 1.0f : d[ax]);
    const float ta = (A.box_lo[ax] - o[ax]) * inv;
    const float tb = (A.box_hi[ax] - o[ax]) * inv;
    float tn = mc_min(ta, tb), tf = mc_max(ta, tb);
    const bool in_slab = o[ax] > A.box_lo[ax] && o[ax] < A.box_hi[ax];
    if (dz) {
      tn = in_slab ? -big : big;
      tf = in_slab ? big : -big;
    }
    t_lo = mc_max(t_lo, tn);
    t_hi = mc_min(t_hi, tf);
  }
  for (int ax = 0; ax < 3; ++ax) {
    pa[ax] = o[ax] + t_lo * d[ax];
    pb[ax] = o[ax] + t_hi * d[ax];
  }
  return t_lo <= t_hi;
}

// The block's reduction of n values per thread: each warp's by the
// butterfly (sum: the plain version's order; min and max: exact), then
// the warps' in warp order, through red. Every thread ends with the
// block's values. kind[k]: 0 sum, 1 min, 2 max.
template <int N>
__device__ __forceinline__ void mc_reduce(float v[N], const int kind[N],
                                          float (*red)[MC_WARPS]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int k = 0; k < N; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(MC_FULL, v[k], off);
      v[k] = kind[k] == 0 ? v[k] + o
             : kind[k] == 1 ? mc_min(v[k], o) : mc_max(v[k], o);
    }
    if (lane == 0) red[k][wid] = v[k];
  }
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    float s = red[k][0];
    for (int w = 1; w < MC_WARPS; ++w)
      s = kind[k] == 0 ? s + red[k][w]
          : kind[k] == 1 ? mc_min(s, red[k][w]) : mc_max(s, red[k][w]);
    v[k] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MC_THREADS)
mc_candidates_kernel(const McArgs A) {
  __shared__ float red[9][MC_WARPS];
  __shared__ int warp_count[2][MC_WARPS];
  const float big = (float)1e30, eps = (float)1e-4;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int tile = blockIdx.x;
  const size_t first = (size_t)tile * A.tile_rays;
  const int n_pad = (A.tile_rays + MC_THREADS - 1) / MC_THREADS * MC_THREADS;

  // 1. the box of the valid lanes' segments and their directions' sum
  // v: lo x y z, hi x y z, sum x y z
  float v[9] = {big, big, big, -big, -big, -big, 0.0f, 0.0f, 0.0f};
  for (int r = tid; r < n_pad; r += MC_THREADS) {
    float pa[3], pb[3], d[3] = {0.0f, 0.0f, 0.0f};
    const bool valid = r < A.tile_rays && mc_clip(A, first + r, pa, pb, d);
    for (int ax = 0; ax < 3; ++ax) {
      if (valid) {
        v[ax] = mc_min(v[ax], mc_min(pa[ax], pb[ax]));
        v[3 + ax] = mc_max(v[3 + ax], mc_max(pa[ax], pb[ax]));
      }
      v[6 + ax] = v[6 + ax] + (valid ? d[ax] : 0.0f);
    }
  }
  const int kind1[9] = {1, 1, 1, 2, 2, 2, 0, 0, 0};
  mc_reduce<9>(v, kind1, red);
  int* cand = A.cand + (size_t)tile * A.K;
  int count = 0;
  // no lane meets the grid box: no triangle can pass the box test
  const bool meets = v[0] <= v[3] && v[1] <= v[4] && v[2] <= v[5];
  if (meets) {
    // 2. the axes (mesh_tile._axes) and the endpoints' ranges on them
    float axis[3][3];
    float* w = axis[0];
    float* u = axis[1];
    for (int k = 0; k < 3; ++k) w[k] = v[6 + k];
    const float nrm = sqrtf((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]);
    const bool ok = nrm > (float)1e-6;
    for (int k = 0; k < 3; ++k)
      w[k] = ok ? w[k] / nrm : (k == 0 ? 1.0f : 0.0f);
    const bool big_y = fabsf(w[1]) >= (float)0.9;
    const float ref[3] = {big_y ? 1.0f : 0.0f, big_y ? 0.0f : 1.0f, 0.0f};
    mc_cross(w, ref, u);
    const float un = sqrtf((u[0] * u[0] + u[1] * u[1]) + u[2] * u[2]);
    for (int k = 0; k < 3; ++k) u[k] = u[k] / un;
    mc_cross(w, u, axis[2]);
    float p[6] = {big, big, big, -big, -big, -big};
    for (int r = tid; r < A.tile_rays; r += MC_THREADS) {
      float pa[3], pb[3], d[3];
      if (!mc_clip(A, first + r, pa, pb, d)) continue;
      for (int a = 0; a < 3; ++a) {
        const float sa = mc_dot(axis[a], pa), sb = mc_dot(axis[a], pb);
        p[a] = mc_min(p[a], mc_min(sa, sb));
        p[3 + a] = mc_max(p[3 + a], mc_max(sa, sb));
      }
    }
    const int kind2[6] = {1, 1, 1, 2, 2, 2};
    mc_reduce<6>(p, kind2, red);
    float lo[3], hi[3], plo[3], phi[3];
    for (int k = 0; k < 3; ++k) {
      lo[k] = v[k] - eps;
      hi[k] = v[3 + k] + eps;
      plo[k] = p[k] - eps;
      phi[k] = p[3 + k] + eps;
    }

    // 3. the triangles, MC_THREADS at a time, compacted in index order
    int parity = 0;
    for (int base = 0; base < A.n_tris; base += MC_THREADS) {
      const int f = base + tid;
      bool keep = false;
      if (f < A.n_tris) {
        const float* row = A.tri + (size_t)f * MC_ROW;
        const float4 r0 = __ldg(reinterpret_cast<const float4*>(row));
        const float4 r1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
        const float e2z = __ldg(row + 8);
        const float v0[3] = {r0.x, r0.y, r0.z};
        const float p1[3] = {v0[0] + r0.w, v0[1] + r1.x, v0[2] + r1.y};
        const float p2[3] = {v0[0] + r1.z, v0[1] + r1.w, v0[2] + e2z};
        keep = true;
        for (int ax = 0; ax < 3; ++ax) {
          const float t_lo = mc_min(mc_min(v0[ax], p1[ax]), p2[ax]);
          const float t_hi = mc_max(mc_max(v0[ax], p1[ax]), p2[ax]);
          keep = keep && t_lo <= hi[ax] && t_hi >= lo[ax];
        }
        if (keep) {
          for (int a = 0; a < 3; ++a) {
            const float t0 = mc_dot(axis[a], v0), t1 = mc_dot(axis[a], p1);
            const float t2 = mc_dot(axis[a], p2);
            keep = keep && mc_min(mc_min(t0, t1), t2) <= phi[a] &&
                   mc_max(mc_max(t0, t1), t2) >= plo[a];
          }
        }
      }
      const unsigned m = __ballot_sync(MC_FULL, keep);
      if (lane == 0) warp_count[parity][wid] = __popc(m);
      __syncthreads();
      int before = count;
      for (int k = 0; k < MC_WARPS; ++k) {
        const int c = warp_count[parity][k];
        before += k < wid ? c : 0;
        count += c;
      }
      if (keep) {
        const int slot = before + __popc(m & ((1u << lane) - 1u));
        if (slot < A.K) cand[slot] = f;
      }
      parity ^= 1;
    }
  }
  for (int j = min(count, A.K) + tid; j < A.K; j += MC_THREADS)
    cand[j] = A.n_tris - 1;
  if (tid == 0) A.counts[tile] = count;
}

extern "C" int mc_candidates(McArgs args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args.tiles <= 0) return 0;
  if (args.tile_rays <= 0 || args.K <= 0 || args.n_tris <= 0)
    return (int)cudaErrorInvalidValue;
  mc_candidates_kernel<<<args.tiles, MC_THREADS, 0, (cudaStream_t)stream>>>(
      args);
  return (int)cudaGetLastError();
}
