"""kf_ms_per_frame (ms/frame): device time of KF, the fused frame kernel
(csrc/kf_staged.cu(h); with a crowd csrc/frame_fused.cu). Layer: KF
kernel."""

PATTERNS = ("kf_staged_kernel", "kf_frame_kernel")


def read(trace):
    return trace.ms_per_frame(trace.matching(PATTERNS))
