"""split_kernels_ms_per_frame (ms/frame): device time of the split path's
K1, K2 and ao_fix (csrc/split_staged.cu, csrc/ao_fix_staged.cu; with a
crowd csrc/split_path.cu, csrc/ao_fix_crowd.cu). Layer: K1, K2, ao_fix."""

PATTERNS = ("sp_staged_render_tile_kernel", "sp_staged_trace_rays_kernel",
            "sp_staged_ao_fix_kernel", "sp_render_tile_kernel",
            "sp_trace_rays_kernel", "sp_crowd_ao_fix_kernel")


def read(trace):
    return trace.ms_per_frame(trace.matching(PATTERNS))
