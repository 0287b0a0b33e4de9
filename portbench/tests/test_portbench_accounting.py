"""The arithmetic of the metrics: rays per frame, the p95 over all calls,
the idle share as a union of intervals, readers that find nothing."""

import numpy as np
import pytest

from portbench import accounting, spec
from portbench.trace import Op, Trace, breakdown


def test_rays_follow_the_accounting():
    s = {"shadows": True, "ao": True, "ao_samples": 5}
    # 2 frames of 4x3, 7 hits, 2 lights: 24 primary + 7 * (2 + 5)
    assert accounting.rays(2, 4, 3, 7.0, 2, s) == 24 + 49
    s.update(ao=False)
    assert accounting.rays(2, 4, 3, 7.0, 2, s) == 24 + 14
    s.update(shadows=False)
    assert accounting.rays(2, 4, 3, 7.0, 2, s) == 24


def test_p95_is_over_every_call():
    vals = list(range(1, 101))
    np.testing.assert_allclose(accounting.percentile(vals, 95),
                               np.percentile(vals, 95))
    rng = np.random.default_rng(0)
    x = list(rng.exponential(size=257))
    np.testing.assert_allclose(accounting.percentile(x, 95),
                               np.percentile(x, 95))
    assert accounting.percentile([3.0], 95) == 3.0


def test_union_and_gaps_of_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    # [0, 3] + [5, 6] + [9, 10] within [0, 10]
    assert accounting.union_length(iv, 0.0, 10.0) == pytest.approx(5.0)
    assert accounting.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert accounting.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def _trace(ops, frames=4):
    host = [Op("portbench.window", 0.0, 10.0), Op("cudaLaunchKernel", 3.1,
                                                 3.2)]
    return Trace(device=ops, harness=[], host=host, window=(0.0, 10.0),
                 frames=frames)


def test_idle_share_counts_overlap_once():
    ops = [Op("void kf_staged_kernel<false>(...)", 0.0, 2.0),
           Op("elementwise_kernel", 1.0, 3.0),
           Op("Memcpy HtoD (Pageable -> Device)", 5.0, 6.0)]
    tr = _trace(ops)
    assert tr.busy_s == pytest.approx(4.0)
    idle = spec.reader("device_idle_share").read(tr)
    assert idle == pytest.approx(60.0)
    assert spec.reader("launches_per_frame").read(tr) == 2 / 4
    assert spec.reader("kf_ms_per_frame").read(tr) == pytest.approx(
        2.0 * 1e3 / 4)
    assert spec.reader("torch_ops_ms_per_frame").read(tr) == \
        pytest.approx(3.0 * 1e3 / 4)
    bd = breakdown(tr)
    assert bd["device_ops"][0][0].startswith("void kf_staged_kernel")
    # the gaps 3-5 and 6-10: the first covered by no event but the window
    assert dict(bd["idle_gaps"])["portbench.window"] == pytest.approx(6.0)


@pytest.mark.parametrize("metric", ["kf_ms_per_frame",
                                    "split_kernels_ms_per_frame",
                                    "mesh_tile_ms_per_frame",
                                    "torch_ops_ms_per_frame",
                                    "launches_per_frame",
                                    "device_idle_share"])
def test_reader_that_matches_nothing_reports_nothing(metric):
    # only a hand kernel of another layer ran (or nothing at all)
    ops = [Op("pt_prime_tile_kernel<false>", 0.0, 1.0)]
    tr = _trace(ops if metric not in ("launches_per_frame",
                                      "device_idle_share") else [])
    assert spec.reader(metric).read(tr) is None
