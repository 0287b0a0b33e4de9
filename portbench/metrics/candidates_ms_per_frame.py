"""candidates_ms_per_frame (ms/frame): device time of the operations that
the program launched inside its `surfjax_torch.mesh_candidates` span
(kernels/mesh_tile.py: the per-tile candidate sets, by the tensor ops of
the segments' boxes and axes and the compaction), per frame; matched
with their launches by portbench/spans.py. Layer: glue: mesh_candidates."""

from portbench.spans import PREFIX, ms_per_frame_under


def read(trace):
    return ms_per_frame_under(trace, PREFIX + "mesh_candidates")
