"""host_syncs_per_frame (syncs/frame): host runtime calls that wait for the
device (portbench/spans.py's SYNCS: cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, a blocking cudaMemcpy) that
start inside one of the program's `surfjax_torch.*` spans, per frame.
Layer: host dispatch."""

from portbench import spans


def read(trace):
    sp = spans.of(trace)
    if sp is None:
        return None
    return len(sp.syncs) / trace.frames
