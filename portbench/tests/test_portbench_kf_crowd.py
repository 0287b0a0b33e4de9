"""kf_crowd_ms_per_frame on synthetic traces: the device time launched
inside the program's `surfjax_torch.kernel.kf_crowd` span, and None where
no operation lies under it (KF without a crowd, or a program without the
span).

    python -m pytest portbench/tests/test_portbench_kf_crowd.py -q
"""

import pytest

from portbench import spans, spec
from portbench.trace import Op, Trace

P = spans.PREFIX
READER = "kf_crowd_ms_per_frame"


def _trace(kf_span, frames: int = 48) -> Trace:
    """One call (1-6 s) of a 10 s window: KF's launch inside `kf_span`
    (no program span if None), the output stack's; the harness's count."""
    host = [Op("portbench.window", 0.0, 10.0), Op("portbench.call", 0.9, 6.2),
            Op("portbench.count", 6.5, 6.8),
            Op("cudaLaunchKernel", 1.20, 1.25),
            Op("cudaLaunchKernel", 5.10, 5.12),
            Op("cudaLaunchKernel", 6.55, 6.56)]
    if kf_span is not None:
        host += [Op(P + "render_sequence", 1.0, 6.0), Op(P + "pass", 1.1, 5.9),
                 Op(P + kf_span, 1.15, 1.3), Op(P + "outputs", 5.0, 5.8)]
    device = [Op("kf_frame_kernel<true>", 1.3, 4.9),
              Op("void CatArrayBatchedCopy<c>", 5.2, 5.5)]
    harness = [Op("void reduce_kernel<h>", 6.6, 6.7)]
    return Trace(device=device, harness=harness, host=host,
                 window=(0.0, 10.0), frames=frames)


def test_reads_the_device_time_under_the_crowd_span():
    got = spec.reader(READER).read(_trace("kernel.kf_crowd"))
    assert got == pytest.approx(3.6 * 1e3 / 48)


@pytest.mark.parametrize("kf_span", ["kernel.kf", None])
def test_reports_nothing_without_the_crowd_span(kf_span):
    """A scene without a crowd (KF's span `kernel.kf`), and a program
    without spans, as the port before the crowd's span: None, not 0."""
    assert spec.reader(READER).read(_trace(kf_span)) is None
