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
// clear along [t, t + s]; a ray stops for good when s <= 1e-3*t. The
// arithmetic is that of render_tile.prime_tile_reference, op for op
// (-fmad=false), so t0 equals it bit for bit.
//
// What bounds it on this card: the slowest warp. At 1920x1080 the launch
// is one wave, and its time is that warp's chain of steps one after
// another (on c3 up to 158 steps, each a DE of the Mandelbulb and the
// blob's tape), not the total work (PERF.md: the slowest warp's rays
// alone on the card take over 90% of the kernel's time). The design
// shortens that chain:
//   * the scene staged per block in shared memory (stage_scene, as K2
//     does): the tables and every object's lower sphere, so no step calls
//     object_bound and the tape's reads are shared-memory loads;
//   * the SDF inline: a one-leaf object as its leaf, the others through a
//     copy of the tape walker, the Mandelbulb through a copy of bulb_de's
//     body (the same operations), so the blob's tape and the bulb's orbit
//     overlap instead of running as two out-of-line calls;
//   * __grid_constant__ parameters;
//   * warps of 4x8 coarse rays (blocks of 16x8), whose rays march alike,
//     one thread per coarse ray, one block per item: at 54 registers the
//     card holds 9 blocks per SM, so 1080p's 1,020 blocks run as one wave.
// Measured and left out (PERF.md): persistent blocks, the bound (128, 8),
// the lower spheres cached per lane instead of staged, 32x1, 8x4 and 16x2
// warps, the objects decoded once per lane.
//
// PROF (a template parameter: the production code has no probes) makes
// each warp add, per phase, lane 0's clock64 deltas, the loop trips it
// issued and __popc(__activemask()) per trip into its record of a scratch
// buffer (KP_PHASES x 3 counters; phases PT_*), and write its clock64 and
// %globaltimer deltas from its first probe to its last (PT_CLOCK).
//
// C interface (bound with ctypes, no PyTorch headers):
//   int pt_prime_tile(KFTables, KFSettings, KSLayout, PrimeArgs,
//                     unsigned long long* prof, int device, void* stream)
//     -> cudaError_t of the launch; prof: null, or the profile's counters,
//        zeroed by the caller: blocks x 4 x KP_PHASES x 3
//   int pt_occupancy(KSLayout, int* blocks_per_sm) -> cudaError_t

#include "split_scene.cuh"

// Ray arrays and cone of one launch (render_tile.PrimeArgs).
struct PrimeArgs {
  const float* in[6];   // ox oy oz dx dy dz
  float* out;           // t0
  int n;
  int has_proxy;        // some SDF object has a proxy sphere
  float k_m;            // cone slope
  float inv1k;          // 1 / (1 + k_m), rounded on the host
  int wc;               // coarse rays per row (n is a multiple of it)
};

#define PT_BLOCK KS_THREADS
#define PT_WARP_W 4   // a warp's coarse rays per row: warps of 4x8

// Profile slots (render_tile.PRIME_PHASE_NAMES), in Prof's record: cycles
// per phase; trips: the steps (PT_PROXY, PT_SDF) and the SDF evaluations
// (PT_*_EVAL); PT_CLOCK holds the warp's clock64 and %globaltimer deltas.
enum { PT_LOAD = 0, PT_PROXY, PT_PROXY_EVAL, PT_SDF, PT_SDF_EVAL, PT_WRITE,
       PT_CLOCK };

__device__ __forceinline__ unsigned long long pt_globaltimer() {
#ifdef __CUDA_ARCH__
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#else
  return 0ull;
#endif
}

// bulb_de's body inline (frame_fused.cuh): the same operations
__device__ __forceinline__ float bulb_de_inline(const float* prm, V3 p,
                                                int iterations, int cheb,
                                                int portable) {
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

// eval_leaf with bulb_de inline
__device__ __forceinline__ float eval_leaf_inline(const KFSettings& S,
                                                  int kind, const float* prm,
                                                  V3 p, int p1, int cap) {
  switch (kind) {
    case LEAF_SPHERE: return sdf_sphere(prm, p);
    case LEAF_PLANE: return sdf_plane(prm, p);
    case LEAF_BOX: return sdf_box(prm, p);
    default: {
      int iters = (cap > 0 && cap < p1) ? cap : p1;
      return bulb_de_inline(prm, p, iters, S.bulb_cheb, S.bulb_portable);
    }
  }
}

// eval_obj's body inline (frame_fused.cuh): the same operations (in a
// KF_WIDE build a tape of slot rows by eval_slots)
__device__ __forceinline__ float eval_obj_inline(const KFTables& T,
                                                 const KFSettings& S,
                                                 const int* ob, V3 p,
                                                 int cap) {
  float vals[KF_TAPE_NODES];
  const int n0 = ob[O_NODE0], nn = ob[O_NNODES], l0 = ob[O_LEAF0];
#if KF_WIDE
  if (nn > KF_TAPE_NODES) return eval_slots(T, S, ob, p, cap, vals);
#endif
  for (int k = 0; k < nn; ++k) {
    const int* nd = T.nodes + (n0 + k) * KF_NODE_W;
    const int op = nd[0];
    float v;
    if (op == OP_LEAF) {
      const int* lf = T.leaves + (l0 + nd[3]) * KF_LEAF_W;
      v = eval_leaf_inline(S, lf[0], T.leaf_params + lf[1] * KF_LEAF_PARAM_W,
                           p, lf[4], cap);
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

// The staged block whose SDF evaluates inline: a one-node tape as its leaf
// (vals[0] is that leaf's value), any other through the tape walker's copy.
struct PrimeScene : SplitScene<true> {
  __device__ __forceinline__ float eval(const KFSettings& S, const int* ob,
                                        V3 p, int cap) const {
    if (ob[O_NNODES] == 1) {
      const int* lf = T.leaves +
          (ob[O_LEAF0] + T.nodes[ob[O_NODE0] * KF_NODE_W + 3]) * KF_LEAF_W;
      return eval_leaf_inline(S, lf[0],
                              T.leaf_params + lf[1] * KF_LEAF_PARAM_W, p,
                              lf[4], cap);
    }
    return eval_obj_inline(T, S, ob, p, cap);
  }
};

// The proxy scene (proxy) or the scene SDF at p: the min over the SDF
// objects in order, each its SDF, or under the proxy its lower sphere where
// it has one (O_PROXY_BOUND). Each SDF evaluation is a trip of phase ph.
template <bool PROF, class Blk>
__device__ __forceinline__ float prime_sdf(const Blk& B, const KFSettings& S,
                                           V3 p, bool proxy, Prof<PROF>& P,
                                           int ph) {
  const int* order = B.T.order + S.n_ana;
  float v = 0.0f;
  for (int k = 0; k < S.n_sdf; ++k) {
    const int* ob = object_row(B.T, order[k]);
    float h;
    if (proxy && ob[O_PROXY_BOUND]) {
      const Bound b = B.lower(order[k]);
      float dx = p.x - b.cx, dy = p.y - b.cy, dz = p.z - b.cz;
      h = sqrtf((dx * dx + dy * dy) + dz * dz) - b.R;
    } else {
      P.trip(ph);
      h = B.eval(S, ob, p, 0);
    }
    v = k == 0 ? h : fminf(v, h);
  }
  return v;
}

// One phase of the cone march from t, each step a trip of phase ph.
template <bool PROF, class Blk>
__device__ __forceinline__ float prime_phase(const Blk& B,
                                             const KFSettings& S,
                                             const PrimeArgs& A, bool act,
                                             V3 o, V3 d, float t, bool proxy,
                                             Prof<PROF>& P, int ph) {
  bool done = !act || t >= S.t_max;
  for (int i = 0; i < S.max_steps && !done; ++i) {
    P.trip(ph);
    float h = prime_sdf(B, S, along(o, d, t), proxy, P, ph + 1);
    float s_all = (h - A.k_m * t) * A.inv1k;
    if ((s_all <= t * F(1e-3)) || (proxy && h < F(0.08))) break;
    t = fminf(t + s_all, S.t_max);
    done = t >= S.t_max;
  }
  P.mark(ph);
  return t;
}

// The priming march of coarse ray i (act false: a lane outside the grid,
// which takes part in the warp's probes only): load, both phases, write.
template <bool PROF, class Blk>
__device__ __forceinline__ void prime_lane(const Blk& B, const KFSettings& S,
                                           const PrimeArgs& A, int i,
                                           bool act, Prof<PROF>& P) {
  V3 o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 1.0f};
  if (act) {
    o = V3{A.in[0][i], A.in[1][i], A.in[2][i]};
    d = V3{A.in[3][i], A.in[4][i], A.in[5][i]};
  }
  P.mark(PT_LOAD);
  float t = S.t_min;
  if (A.has_proxy) t = prime_phase(B, S, A, act, o, d, t, true, P, PT_PROXY);
  t = prime_phase(B, S, A, act, o, d, t, false, P, PT_SDF);
  if (act) A.out[i] = t;
  P.mark(PT_WRITE);
}

// The warp's clock64 and %globaltimer at its first and last probe.
template <bool PROF>
struct PrimeClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void stop(unsigned long long*) {}
};
template <>
struct PrimeClock<true> {
  long long c0;
  unsigned long long g0;
  __device__ __forceinline__ void start() {
    c0 = clock64();
    g0 = pt_globaltimer();
  }
  __device__ __forceinline__ void stop(unsigned long long* base) {
    const long long c1 = clock64();
    const unsigned long long g1 = pt_globaltimer();
    if ((threadIdx.x & 31) == 0) {
      const int warp = blockIdx.x * KS_WARPS + (threadIdx.x >> 5);
      unsigned long long* rec = base + (size_t)warp * KP_PHASES * 3 +
                                PT_CLOCK * 3;
      rec[0] = (unsigned long long)(c1 - c0);
      rec[1] = g1 - g0;
      rec[2] = 1ull;
    }
  }
};

// The block stages the scene, then marches its 16x8 coarse rays: four
// warps side by side, each 4 rays wide and 8 high.
template <bool PROF>
__global__ void __launch_bounds__(PT_BLOCK)
pt_prime_tile_kernel(const __grid_constant__ KFTables G,
                     const __grid_constant__ KFSettings S,
                     const __grid_constant__ KSLayout L,
                     const __grid_constant__ PrimeArgs A,
                     unsigned long long* prof) {
  unsigned char* sm = ks_smem;
  __shared__ KFTables staged;
  const int tid = threadIdx.x;
  const KFTables T = stage_scene(G, S, L, sm);
  if (tid == 0) staged = T;
  __syncthreads();
  const PrimeScene B{{T, staged, (const float*)(sm + L.bounds),
                      S.exit_margin}};
  const int gx = (A.wc + 4 * PT_WARP_W - 1) / (4 * PT_WARP_W);
  const int col = (blockIdx.x % gx) * (4 * PT_WARP_W) +
                  (tid >> 5) * PT_WARP_W + (tid % PT_WARP_W);
  const int row = (blockIdx.x / gx) * (32 / PT_WARP_W) +
                  ((tid & 31) / PT_WARP_W);
  Prof<PROF> P;
  PrimeClock<PROF> C;
  P.begin(prof, blockIdx.x);
  C.start();
  prime_lane(B, S, A, row * A.wc + col, col < A.wc && row < A.n / A.wc, P);
  C.stop(prof);
}

template <bool PROF>
static int prime_launch(const KFTables& T, const KFSettings& S,
                        const KSLayout& L, const PrimeArgs& A,
                        unsigned long long* prof, cudaStream_t stream) {
  if (L.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pt_prime_tile_kernel<PROF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid =
      (unsigned)(((A.wc + 4 * PT_WARP_W - 1) / (4 * PT_WARP_W)) *
                 ((A.n / A.wc + 32 / PT_WARP_W - 1) / (32 / PT_WARP_W)));
  pt_prime_tile_kernel<PROF><<<grid, PT_BLOCK, L.bytes, stream>>>(T, S, L, A,
                                                                  prof);
  return (int)cudaGetLastError();
}

extern "C" int pt_prime_tile(KFTables T, KFSettings S, KSLayout L,
                             PrimeArgs A, unsigned long long* prof,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (A.n <= 0) return 0;
  if (A.wc <= 0 || A.n % A.wc) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return prof ? prime_launch<true>(T, S, L, A, prof, st)
              : prime_launch<false>(T, S, L, A, nullptr, st);
}

extern "C" int pt_occupancy(KSLayout L, int* blocks_per_sm) {
  if (L.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pt_prime_tile_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pt_prime_tile_kernel<false>, PT_BLOCK, L.bytes);
}
