// Cone-march priming kernel for Hopper (sm_90a).
//
// Replaces surfjax/kernels/render_tile.py::prime_tile_kernel (the Pallas TPU
// kernel whose body is _prime_body / _prime_march): for one coarse ray per
// 4x4 pixel block it finds the largest t_safe such that every ray within
// the block's cone (slope k_m, twice the block's own) has SDF > 0 on
// [t_min, t_safe]. The frame's SDF marches then start at t_safe instead of
// t_min. Two phases, each with its own budget of max_steps: the first
// marches a proxy scene (expensive objects replaced by their lower-bound
// spheres) and hands a ray over once the proxy is within 0.08 of a surface
// or the cone is blocked; the second goes on from the same t with the true
// scene SDF. A step is s = (h - k*t)/(1 + k), which keeps the whole cone
// clear along [t, t + s]; a ray stops for good when s <= 1e-3*t.
//
// What bounds it on this card: FP32 ALU work of the phase-2 DE evaluations
// near the fractal (a ray far from everything leaves in a few proxy steps),
// and launch latency: at 1920x1080 there are only 270x480 coarse rays,
// 28 bytes each.
//
// What the design does about it: one thread per coarse ray over flat
// arrays, 128-thread blocks; a ray that is done stops, so there is no
// parking of done lanes and no tile-level loop gate as on the TPU (both
// are value-exact per lane). The scene is read through the tables of
// frame_fused.cuh and the SDF through its tape walker, so the arithmetic
// is that of render_tile.prime_tile_reference, op for op (-fmad=false).
//
// C interface (bound with ctypes, no PyTorch headers):
//   int pt_prime_tile(KFTables, KFSettings, PrimeArgs, int device, void*)
//     -> cudaError_t of the launch

#include "frame_fused.cuh"

// Ray arrays and cone of one launch (render_tile.PrimeArgs).
struct PrimeArgs {
  const float* in[6];   // ox oy oz dx dy dz
  float* out;           // t0
  int n;
  int has_proxy;        // some SDF object has a proxy sphere
  float k_m;            // cone slope
  float inv1k;          // 1 / (1 + k_m), rounded on the host
};

#define PT_BLOCK 128

// min over the SDF objects of the object's SDF, or with `proxy` of its
// lower-bound sphere where the object has one (O_PROXY_BOUND).
__device__ __forceinline__ float prime_scene(const KFTables& T,
                                             const KFSettings& S, V3 p,
                                             bool proxy) {
  float v = 0.0f;
  for (int k = 0; k < S.n_sdf; ++k) {
    const int* ob = object_row(T, T.order[S.n_ana + k]);
    float h;
    if (proxy && ob[O_PROXY_BOUND]) {
      Bound b = object_bound(T, ob, 1, 0.0f);
      float dx = p.x - b.cx, dy = p.y - b.cy, dz = p.z - b.cz;
      h = sqrtf((dx * dx + dy * dy) + dz * dz) - b.R;
    } else {
      h = eval_obj(T, S, ob, p, 0);
    }
    v = k == 0 ? h : fminf(v, h);
  }
  return v;
}

// One phase of the cone march from t; returns the last proven t.
__device__ __forceinline__ float prime_phase(const KFTables& T,
                                             const KFSettings& S,
                                             const PrimeArgs& A, V3 o, V3 d,
                                             float t, bool proxy) {
  bool done = t >= S.t_max;
  for (int i = 0; i < S.max_steps && !done; ++i) {
    float h = prime_scene(T, S, along(o, d, t), proxy);
    float s_all = (h - A.k_m * t) * A.inv1k;
    if ((s_all <= t * F(1e-3)) || (proxy && h < F(0.08))) break;
    t = fminf(t + s_all, S.t_max);
    done = t >= S.t_max;
  }
  return t;
}

__global__ void __launch_bounds__(PT_BLOCK)
pt_prime_tile_kernel(const KFTables T, const KFSettings S,
                     const PrimeArgs A) {
  const int i = blockIdx.x * PT_BLOCK + threadIdx.x;
  if (i >= A.n) return;
  const V3 o{A.in[0][i], A.in[1][i], A.in[2][i]};
  const V3 d{A.in[3][i], A.in[4][i], A.in[5][i]};
  float t = S.t_min;
  if (A.has_proxy) t = prime_phase(T, S, A, o, d, t, true);
  A.out[i] = prime_phase(T, S, A, o, d, t, false);
}

extern "C" int pt_prime_tile(KFTables T, KFSettings S, PrimeArgs A,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (A.n <= 0) return 0;
  dim3 grid((A.n + PT_BLOCK - 1) / PT_BLOCK);
  pt_prime_tile_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(T, S, A);
  return (int)cudaGetLastError();
}
