"""launches_per_frame (launches/frame): the kernels the card ran in the
window, per frame. Layer: host dispatch (api -> pipeline/frame.py's
render_sequence / render_frame -> kernels/render_tile.py's pass functions)."""


def read(trace):
    n = sum(1 for o in trace.device if o.kernel)
    return n / trace.frames if n else None
