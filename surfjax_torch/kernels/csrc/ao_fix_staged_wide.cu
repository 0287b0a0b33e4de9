// ao_fix_staged.cu's kernels, ao_fix without a crowd, in their KF_WIDE build
// (frame_fused.cuh): for scenes past the per-thread arrays (tapes of
// more than 32 nodes, analytic objects of more than 16 leaves, more than
// 64 objects outside the crowd), which render_tile.wide_scene sends here.
// Every kernel and C entry takes its name with _wide at the end.
#define KF_WIDE 1
#define sp_staged_ao_fix_kernel sp_staged_ao_fix_kernel_wide
#define sp_staged_ao_fix sp_staged_ao_fix_wide
#include "ao_fix_staged.cu"
