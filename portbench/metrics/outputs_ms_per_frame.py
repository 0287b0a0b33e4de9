"""outputs_ms_per_frame (ms/frame): device time of the operations that the
program launched inside its `surfjax_torch.outputs` spans (the output
buffers' assembly: KF's stack into FrameBuffers, the split path's stacks
and untiling, the passes joined), per frame; matched with their launches
by portbench/spans.py. Layer: glue: output assembly."""

from portbench.spans import PREFIX, ms_per_frame_under


def read(trace):
    return ms_per_frame_under(trace, PREFIX + "outputs")
