"""torch_ops_ms_per_frame (ms/frame): device time of every operation that
is not one of the port's hand-written kernels (mesh_candidates' tensor
ops, merges, copies and fills, stacking). Layer: glue."""

# the port's hand-written kernels (surfjax_torch/kernels/csrc/*.cu)
HAND_KERNELS = ("kf_staged_kernel", "kf_frame_kernel", "kf_frame_prof_kernel",
                "sp_staged_render_tile_kernel", "sp_staged_trace_rays_kernel",
                "sp_staged_ao_fix_kernel", "sp_render_tile_kernel",
                "sp_trace_rays_kernel", "sp_crowd_ao_fix_kernel",
                "mt_mesh_tile_kernel", "pt_prime_tile_kernel",
                "fp_mix_kernel", "fp_fma_kernel")


def read(trace):
    return trace.ms_per_frame([o for o in trace.device
                               if not any(p in o.name for p in HAND_KERNELS)])
