// ao_fix for scenes with a crowd (without one, ao_fix_staged.cu), for
// Hopper (sm_90a).
//
// Replaces, for scenes with a crowd, surfjax/kernels/render_tile.py::
// ao_fix_kernel (body _ao_fix_body), as split_path.cu's
// sp_ao_fix_kernel<true> did before it: AO again at the pre-offset
// receivers p_off (in[0..2]) with the normals n (in[3..5]) on the lanes a
// mesh won (need = in[6] > 0.5), ao_in (in[7]) elsewhere; the arithmetic
// of render_tile.ao_fix_reference, bit for bit (ao_core's order).
//
// What bounds it: on the crowd-mesh path at 1080p the mesh wins 5.6% of
// the pixels, so most warps hold no needing lane, and the others load 8
// bytes per lane and write 4; a needing lane evaluates the floor at 20 taps
// and the taps of the members near it. What held the kernel it replaces
// back (PERF.md): the by-value parameters copied into every thread's stack
// frame (with need 0 on every lane it took 0.15 of its 0.28-0.31 ms), every
// lane of a warp with no needing lane paying that copy, and on each needing
// lane the gates of all 48 members and the floor decoded anew through the
// tape walker at each tap. The design is K1's with a crowd (split_path.cu)
// on the needing lanes:
//   * __grid_constant__ parameters, which the cores read in place;
//   * every lane stays to the end so that its warp votes whole: a lane past
//     the last ray and a lane without need only vote, and a warp with no
//     needing lane writes ao_in and skips AO;
//   * warp-level member culling (frame_fused.cuh, "Warp-level member
//     culling"): the needing lanes' receivers form the warp's ball
//     (warp_ball; AO's reach 2*ao_radius, slack CULL_LIN), and each lane
//     visits only the members the warp keeps, with its exact gate, so the
//     result is bitwise the plain version's (its vote:
//     render_tile.split_warp_masks' ao_fix); a lane without need runs the
//     taps on its warp's first needing receiver, so that it takes that
//     lane's branches, and drops the result;
//   * AO's floor decoded once per lane (floor_of) and evaluated as its leaf;
//   * one thread per ray, 128 per block, __launch_bounds__(128, 5): 96
//     registers and 5 blocks per SM ran 7-8% faster than 64 registers and 8
//     (a warp that runs AO takes 66,600 cycles, not 93,000).
// Measured and left out (PERF.md): blocks of 32 or 64 threads (6-21%
// slower, the warps without a needing lane up to 2.5x dearer), and blocks
// whose 128-ray rows are permuted over the launch so that the mesh's rows
// spread over the SMs (9-29% slower).
//
// PROF (a template parameter: the production code has no probes) makes lane
// 0 of each warp add the clock64 deltas of its phases (AF_PHASES: the loads,
// the vote's ball and the floor, the call of the AO core with its member
// vote, the write) and a flag for a warp that skipped AO into its record of
// a scratch buffer. The probes stand around the AO core's call, not inside
// it: that core is K1's and KF's too.
//
// C interface (bound with ctypes, no PyTorch headers):
//   int sp_ao_fix(KFTables, KFSettings, SplitRays, unsigned long long* prof,
//                 int device, void* stream)
// -> cudaError_t of the launch (a scene without a crowd and a residual
// re-run are refused); prof: null, or the profile, zeroed by the caller:
// ceil(n / 32) warps x AF_REC.

#include "split_scene.cuh"

#define AF_BLOCK 128
enum { AF_LOAD = 0, AF_VOTE, AF_AO, AF_WRITE, AF_PHASES };
#define AF_REC (AF_PHASES + 1)   // the phases' cycles, then the skip flag

template <bool PROF>
struct AfProf {
  __device__ __forceinline__ void begin(unsigned long long*) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void skip() {}
};

template <>
struct AfProf<true> {
  unsigned long long* rec;   // this warp's record, written by lane 0 only
  long long t;               // lane 0's clock at the last mark
  __device__ __forceinline__ void begin(unsigned long long* base) {
    rec = base + ((size_t)blockIdx.x * (AF_BLOCK / 32) + (threadIdx.x >> 5))
        * AF_REC;
    __syncwarp();
    t = clock64();
  }
  // The phase `ph` ends here, on every lane of the warp.
  __device__ __forceinline__ void mark(int ph) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const long long now = clock64();
      rec[ph] += (unsigned long long)(now - t);
      t = now;
    }
  }
  __device__ __forceinline__ void skip() {
    if ((threadIdx.x & 31) == 0) rec[AF_PHASES] = 1ull;
  }
};

template <bool PROF>
__global__ void __launch_bounds__(AF_BLOCK, 5)
sp_crowd_ao_fix_kernel(const __grid_constant__ KFTables T,
                       const __grid_constant__ KFSettings S,
                       const __grid_constant__ SplitRays R,
                       unsigned long long* prof) {
  AfProf<PROF> P;
  P.begin(prof);
  const int i = blockIdx.x * AF_BLOCK + threadIdx.x;
  const bool in = i < R.n;
  float ao = 1.0f;
  bool need = false;
  V3 q0{0.0f, 0.0f, 0.0f}, n{0.0f, 0.0f, 1.0f};
  if (in) {
    ao = R.in[7][i];
    need = R.in[6][i] > 0.5f;
    if (need) {
      q0 = V3{R.in[0][i], R.in[1][i], R.in[2][i]};
      n = V3{R.in[3][i], R.in[4][i], R.in[5][i]};
    }
  }
  P.mark(AF_LOAD);
  const unsigned needing = __ballot_sync(KF_FULL, need);
  if (needing) {
    const int src = need ? (int)(threadIdx.x & 31) : __ffs(needing) - 1;
    q0 = V3{__shfl_sync(KF_FULL, q0.x, src), __shfl_sync(KF_FULL, q0.y, src),
            __shfl_sync(KF_FULL, q0.z, src)};
    n = V3{__shfl_sync(KF_FULL, n.x, src), __shfl_sync(KF_FULL, n.y, src),
           __shfl_sync(KF_FULL, n.z, src)};
    const WarpSeg ball = warp_ball(q0, need);
    const Floor fl = floor_of(T, S);
    P.mark(AF_VOTE);
    const float a = ao_factor_culled(T, S, q0, n, ball, need, fl);
    if (need) ao = a;
    P.mark(AF_AO);
  } else {
    P.skip();
  }
  if (in) R.out[0][i] = ao;
  P.mark(AF_WRITE);
}

extern "C" int sp_ao_fix(KFTables T, KFSettings S, SplitRays R,
                         unsigned long long* prof, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S.n_crowd <= 0 || R.redo) return (int)cudaErrorInvalidValue;
  if (R.n <= 0) return 0;
  const unsigned grid = (R.n + AF_BLOCK - 1) / AF_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  if (prof)
    sp_crowd_ao_fix_kernel<true><<<grid, AF_BLOCK, 0, st>>>(T, S, R, prof);
  else
    sp_crowd_ao_fix_kernel<false><<<grid, AF_BLOCK, 0, st>>>(T, S, R,
                                                             nullptr);
  return (int)cudaGetLastError();
}
