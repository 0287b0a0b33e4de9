"""mesh_tile_ms_per_frame (ms/frame): device time of the mesh kernel
(csrc/mesh_tile.cu). Layer: mesh kernel."""

PATTERNS = ("mt_mesh_tile_kernel",)


def read(trace):
    return trace.ms_per_frame(trace.matching(PATTERNS))
