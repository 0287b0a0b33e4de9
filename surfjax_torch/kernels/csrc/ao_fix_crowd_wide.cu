// ao_fix_crowd.cu's kernels, ao_fix with a crowd, in their KF_WIDE build
// (frame_fused.cuh): for scenes past the per-thread arrays (tapes of
// more than 32 nodes, analytic objects of more than 16 leaves, more than
// 64 objects outside the crowd), which render_tile.wide_scene sends here.
// Every kernel and C entry takes its name with _wide at the end.
#define KF_WIDE 1
#define sp_crowd_ao_fix_kernel sp_crowd_ao_fix_kernel_wide
#define sp_ao_fix sp_ao_fix_wide
#include "ao_fix_crowd.cu"
