// kf_staged.cu's kernels, the staged fused kernel (KF without a crowd), in their KF_WIDE build
// (frame_fused.cuh): for scenes past the per-thread arrays (tapes of
// more than 32 nodes, analytic objects of more than 16 leaves, more than
// 64 objects outside the crowd), which render_tile.wide_scene sends here.
// Every kernel and C entry takes its name with _wide at the end.
#define KF_WIDE 1
#define kf_staged_kernel kf_staged_kernel_wide
#define ks_frame_fused ks_frame_fused_wide
#define ks_occupancy ks_occupancy_wide
#include "kf_staged.cu"
