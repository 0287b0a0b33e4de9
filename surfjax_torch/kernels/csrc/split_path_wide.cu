// split_path.cu's kernels, K1 and K2 with a crowd, in their KF_WIDE build
// (frame_fused.cuh): for scenes past the per-thread arrays (tapes of
// more than 32 nodes, analytic objects of more than 16 leaves, more than
// 64 objects outside the crowd), which render_tile.wide_scene sends here.
// Every kernel and C entry takes its name with _wide at the end.
#define KF_WIDE 1
#define sp_render_tile_kernel sp_render_tile_kernel_wide
#define sp_trace_rays_kernel sp_trace_rays_kernel_wide
#define sp_render_tile sp_render_tile_wide
#define sp_trace_rays sp_trace_rays_wide
#include "split_path.cu"
