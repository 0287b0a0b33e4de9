"""program_idle_ms_per_frame (ms/frame): the window's device idle time
(the gaps of the union of every device operation, the harness's
included) that lies inside the program's `surfjax_torch.render_sequence`
spans, per frame: the host's own work inside a call that keeps the card
waiting. Layer: host dispatch."""

from portbench import spans


def read(trace):
    sp = spans.of(trace)
    if sp is None:
        return None
    return sp.idle_in(spans.ROOT) * 1e3 / trace.frames
