"""kf_crowd_ms_per_frame (ms/frame): device time of the operations that
the program launched inside its `surfjax_torch.kernel.kf_crowd` span
(kernels/render_tile.py::frame_fused on a scene that forms a crowd: KF's
crowd instantiation kf_frame_kernel<true>, csrc/frame_fused.cu), per
frame; matched with their launches by portbench/spans.py. None where no
operation lies under the span (a program without it, or no crowd).
Layer: KF crowd kernel."""

from portbench.spans import PREFIX, ms_per_frame_under


def read(trace):
    return ms_per_frame_under(trace, PREFIX + "kernel.kf_crowd")
