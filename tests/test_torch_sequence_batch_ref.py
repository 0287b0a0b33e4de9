"""c4's batched sequence against surfjax: the port's render_sequence
(backend "pallas", the split path's kernels' plain versions on the CPU)
renders two frames in one pass, their tiles joined in every kernel call,
and each frame is held against surfjax's render_sequence, which vmaps its
frames through the Pallas kernels in interpret mode. A file of its own:
surfjax's interpret-mode compile of the mesh kernel takes most of its
half minute, which tests/test_torch_sequence_batch.py's budget has no
room for.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch import api  # noqa: E402
from surfjax_torch.tools.kernel_check import capture_calls  # noqa: E402


def test_c4_sequence_matches_surfjax():
    """c4 (8192-triangle octasphere over a plane, hard shadows) at
    48x48 x 2 frames, tile_rows 8, through the batched split path (one
    pass: one K1 call over both frames' tiles, the mesh kernel once for
    the primary rays and once for the light) against surfjax's
    render_sequence (its frames vmapped, interpret mode), per frame at
    the tolerances of tests/test_torch_mesh_tile.py::
    test_c4_slice_matches_reference_pallas."""
    from surfjax.pipeline.frame import render_sequence as sj_rs

    from tests.test_torch_pipeline import gaps, load_pair
    (sj_s, sj_c, sj_st), (pt_s, pt_c, pt_st), poses = load_pair(
        "c4_mesh", 48, n_frames=2, backend="pallas", tile_rows=8)
    ref = sj_rs(sj_s, sj_c, poses, sj_st)
    with capture_calls() as calls:
        got = api.render_sequence(pt_s, pt_c, poses, pt_st, device="cpu")
    assert [c[0] for c in calls] == ["render_tile", "mesh_candidates",
                                     "mesh_tile", "trace_rays",
                                     "mesh_candidates", "mesh_tile"]
    for f in range(2):
        g = gaps([np.asarray(a)[f] for a in ref], [a[f] for a in got])
        assert g["hit_agree"] > 0.999 and g["obj_agree"] > 0.999, (f, g)
        assert g["rgb_max"] < 1e-3 and g["normal_max"] < 1e-3, (f, g)
        assert 0.3 < float(got.hit[f].float().mean()) < 1.0
        assert (got.obj_id[f] == 0).any() and (got.obj_id[f] == 1).any()
