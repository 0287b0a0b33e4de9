// frame_fused.cu's kernels, KF with a crowd (kf_frame_kernel<true>), in their KF_WIDE build
// (frame_fused.cuh): for scenes past the per-thread arrays (tapes of
// more than 32 nodes, analytic objects of more than 16 leaves, more than
// 64 objects outside the crowd), which render_tile.wide_scene sends here.
// Every kernel and C entry takes its name with _wide at the end.
#define KF_WIDE 1
#define kf_frame_kernel kf_frame_kernel_wide
#define kf_frame_fused kf_frame_fused_wide
#define kf_error_string kf_error_string_wide
#include "frame_fused.cu"
