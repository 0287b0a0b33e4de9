// A host stand-in for the CUDA runtime, so that a kernel source of
// surfjax_torch/kernels/csrc compiles with g++ and runs on the CPU
// (tests/cuda_host.py builds it; tests/test_torch_mesh_kernel_host.py runs
// the mesh kernel through it against its plain version).
//
// Each CUDA thread of a block is a std::thread; blocks run one after
// another. __syncthreads is a barrier over the block; the warp collectives
// (__syncwarp, __shfl_sync, __ballot_sync, __reduce_*_sync) exchange values
// through the warp's slots between two waits on a barrier of its 32 lanes,
// so every lane of the warp must call them, as the kernels do (full
// masks). __activemask returns the calling lane's own bit. Float arithmetic
// is the host's IEEE single precision; built with -ffp-contract=off, every
// multiply and add rounds on its own, as on the card under -fmad=false.
// tests/cuda_host.py rewrites the launch syntax kernel<<<grid, block,
// smem, stream>>>(args) into cuda_host::launch(kernel, grid, block, smem,
// stream, args), and `extern __shared__` arrays into static ones.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct uint3 { unsigned x, y, z; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "host stub"; }

inline thread_local uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

using std::max;
using std::min;

namespace cuda_host {

struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};

struct Block {
  explicit Block(int n) : bar(n), warps((n + 31) / 32) {}
  std::barrier<> bar;
  std::vector<Warp> warps;
  std::atomic<int> any[2] = {0, 0};
};

inline Block* block = nullptr;
inline thread_local int or_calls = 0;

inline Warp& warp() { return block->warps[threadIdx.x >> 5]; }
inline int lane() { return (int)(threadIdx.x & 31); }

// All 32 lanes put a value in; -> the 32 values, after every lane has put.
inline void exchange(uint64_t v, uint64_t out[32]) {
  Warp& w = warp();
  w.slot[lane()] = v;
  w.bar.arrive_and_wait();
  std::memcpy(out, w.slot, sizeof(w.slot));
  w.bar.arrive_and_wait();
}

template <class T>
inline uint64_t bits(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T>
inline T from_bits(uint64_t b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}

template <class K, class... A>
void launch(K kernel, dim3 grid, dim3 block_dim, size_t, cudaStream_t,
            A... args) {
  gridDim = grid;
  blockDim = block_dim;
  const int n = (int)(block_dim.x * block_dim.y * block_dim.z);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        Block b(n);
        block = &b;
        std::vector<std::thread> threads;
        threads.reserve(n);
        for (int t = 0; t < n; ++t)
          threads.emplace_back([=]() {
            threadIdx = uint3{t % block_dim.x, (t / block_dim.x) % block_dim.y,
                              t / (block_dim.x * block_dim.y)};
            blockIdx = uint3{bx, by, bz};
            or_calls = 0;
            kernel(args...);
          });
        for (auto& th : threads) th.join();
        block = nullptr;
      }
}

}  // namespace cuda_host

inline void __syncthreads() { cuda_host::block->bar.arrive_and_wait(); }

inline int __syncthreads_or(int p) {
  cuda_host::Block& b = *cuda_host::block;
  const int k = cuda_host::or_calls++ & 1;
  if (p) b.any[k].fetch_or(1);
  b.bar.arrive_and_wait();
  const int r = b.any[k].load();
  b.bar.arrive_and_wait();
  if (threadIdx.x == 0) b.any[k].store(0);
  return r;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_host::warp().bar.arrive_and_wait();
}
inline unsigned __activemask() { return 1u << cuda_host::lane(); }

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  uint64_t all[32];
  cuda_host::exchange(cuda_host::bits(v), all);
  return cuda_host::from_bits<T>(all[src & 31]);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return __shfl_sync(0xffffffffu, v, cuda_host::lane() ^ mask);
}
inline unsigned __ballot_sync(unsigned, int p) {
  uint64_t all[32];
  cuda_host::exchange(p ? 1 : 0, all);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)all[l] << l;
  return m;
}
inline int __any_sync(unsigned, int p) { return __ballot_sync(0, p) != 0; }
inline int __all_sync(unsigned, int p) {
  return __ballot_sync(0, p) == 0xffffffffu;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  uint64_t all[32];
  cuda_host::exchange(v, all);
  unsigned s = 0;
  for (int l = 0; l < 32; ++l) s += (unsigned)all[l];
  return s;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  uint64_t all[32];
  cuda_host::exchange(v, all);
  unsigned s = 0;
  for (int l = 0; l < 32; ++l) s = std::max(s, (unsigned)all[l]);
  return s;
}

inline int __reduce_min_sync(unsigned, int v) {
  uint64_t all[32];
  cuda_host::exchange((uint64_t)(int64_t)v, all);
  int s = (int)all[0];
  for (int l = 1; l < 32; ++l) s = std::min(s, (int)all[l]);
  return s;
}
inline int __reduce_max_sync(unsigned, int v) {
  uint64_t all[32];
  cuda_host::exchange((uint64_t)(int64_t)v, all);
  int s = (int)all[0];
  for (int l = 1; l < 32; ++l) s = std::max(s, (int)all[l]);
  return s;
}
inline int __float_as_int(float x) { return cuda_host::from_bits<int>(
    cuda_host::bits(x)); }
inline float __int_as_float(int i) { return cuda_host::from_bits<float>(
    cuda_host::bits(i)); }

inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T>
inline T __ldg(const T* p) { return *p; }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
template <class T>
inline T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
