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
// triangle test times (rays x candidates of their tile); the triangle rows
// are read once per block from L2 (the packed table of an 8192-triangle
// mesh is 786 KB) and each ray reads 28 and writes 28 bytes.
//
// What the design does about it: one thread per ray, 256-thread blocks
// inside one tile; the block stages the tile's candidate rows (96 bytes
// each) through shared memory 64 at a time, so every row is read from L2
// once per block and then broadcast to the warps. An any-hit block leaves
// its loop as soon as every thread has found an occluder or had an empty
// segment. Making it faster (smaller tiles, better occupancy, per-ray
// grid traversal) is later work.
//
// C interface (bound with ctypes, no PyTorch headers):
//   int mt_mesh_tile(MeshTileArgs args, int device, void* stream)
//       -> cudaError_t of the launch

#include <cuda_runtime.h>

#define MT_BLOCK 256
#define MT_CHUNK 64
#define MT_ROW 24

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
};

__global__ void __launch_bounds__(MT_BLOCK)
mt_mesh_tile_kernel(const MeshTileArgs A) {
  __shared__ float rows[MT_CHUNK * MT_ROW];
  const int ray = blockIdx.x * MT_BLOCK + threadIdx.x;
  const int tile = (blockIdx.x * MT_BLOCK) / A.tile_rays;
  const int count = A.counts[tile];
  const bool over = count > A.K;
  const int n = over ? A.n_tris : count;
  const int* cand = A.cand + (size_t)tile * A.K;
  const bool in = ray < A.n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t_max = 0.0f;
  if (in) {
    ox = A.ox[ray]; oy = A.oy[ray]; oz = A.oz[ray];
    dx = A.dx[ray]; dy = A.dy[ray]; dz = A.dz[ray];
    t_max = A.tmax[ray];
  }
  float t_best = (float)1e30;   // BIG, rounded as the host rounds it
  float nsx = 0.0f, nsy = 0.0f, nsz = 1.0f;
  float ngx = 0.0f, ngy = 0.0f, ngz = 1.0f;
  // a lane whose segment is empty can hit nothing
  bool active = in && !(t_max <= A.t_min);
  for (int base = 0; base < n; base += MT_CHUNK) {
    if (A.any_hit) {
      if (!__syncthreads_or(active)) break;
    } else {
      __syncthreads();
    }
    const int m = min(MT_CHUNK, n - base);
    for (int e = threadIdx.x; e < m * MT_ROW; e += MT_BLOCK) {
      const int r = e / MT_ROW;
      const int id = over ? base + r : cand[base + r];
      rows[e] = A.tri[(size_t)id * MT_ROW + (e - r * MT_ROW)];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < m; ++j) {
      const float* row = rows + j * MT_ROW;
      const float e1x = row[3], e1y = row[4], e1z = row[5];
      const float e2x = row[6], e2y = row[7], e2z = row[8];
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
      const bool ok = fabsf(det) > (float)1e-7;
      const float inv_det = 1.0f / (ok ? det : 1.0f);
      const float tvx = ox - row[0], tvy = oy - row[1], tvz = oz - row[2];
      const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det;
      const float t = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
      const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                       t > A.t_min && t < t_max && t < t_best;
      if (!hit) continue;
      t_best = t;
      if (A.any_hit) {
        active = false;
        break;
      }
      ngx = row[9]; ngy = row[10]; ngz = row[11];
      if (A.smooth) {
        const float w = (1.0f - u) - v;
        const float sx = (w * row[12] + u * row[15]) + v * row[18];
        const float sy = (w * row[13] + u * row[16]) + v * row[19];
        const float sz = (w * row[14] + u * row[17]) + v * row[20];
        const float inv = 1.0f / sqrtf((sx * sx + sy * sy) + sz * sz);
        nsx = sx * inv; nsy = sy * inv; nsz = sz * inv;
      } else {
        nsx = ngx; nsy = ngy; nsz = ngz;
      }
    }
  }
  if (in) {
    A.t[ray] = t_best;
    A.nsx[ray] = nsx; A.nsy[ray] = nsy; A.nsz[ray] = nsz;
    A.ngx[ray] = ngx; A.ngy[ray] = ngy; A.ngz[ray] = ngz;
  }
}

extern "C" int mt_mesh_tile(MeshTileArgs args, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args.n_rays <= 0) return 0;
  if (args.tile_rays % MT_BLOCK != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((args.n_rays + MT_BLOCK - 1) / MT_BLOCK);
  mt_mesh_tile_kernel<<<grid, MT_BLOCK, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
