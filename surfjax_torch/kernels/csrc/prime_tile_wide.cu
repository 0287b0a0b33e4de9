// prime_tile.cu's kernels, the priming kernel, in their KF_WIDE build
// (frame_fused.cuh): for scenes past the per-thread arrays (tapes of
// more than 32 nodes, analytic objects of more than 16 leaves, more than
// 64 objects outside the crowd), which render_tile.wide_scene sends here.
// Every kernel and C entry takes its name with _wide at the end.
#define KF_WIDE 1
#define pt_prime_tile_kernel pt_prime_tile_kernel_wide
#define pt_prime_tile pt_prime_tile_wide
#define pt_occupancy pt_occupancy_wide
#include "prime_tile.cu"
