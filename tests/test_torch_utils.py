"""The port's utilities against surfjax's (tests/test_utils.py holds
surfjax's own): pose_interp, validate_framebuffers, the
NaN/Inf tap `checked`, trace_render and annotate, and the resumable
SequenceCheckpointer (resume, fault, chunk-size change, shorter rerun)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from surfjax.core.camera import orbit_pose as sj_orbit_pose  # noqa: E402
from surfjax.core.camera import pose_interp as sj_pose_interp  # noqa: E402

from surfjax_torch import render  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.camera import pose_interp  # noqa: E402
from surfjax_torch.tools.workload import reframe  # noqa: E402
from surfjax_torch.utils.checkpoint import SequenceCheckpointer  # noqa: E402
from surfjax_torch.utils.checks import (  # noqa: E402
    NonFiniteError, checked, validate_framebuffers,
)
from surfjax_torch.utils.profiling import annotate, trace_render  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _c1(size=32):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 "c1_sphere.yaml"))
    return scene, reframe(cam, size, size), st


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.8125, 1.0])
def test_pose_interp_matches_surfjax(t):
    """Between two orbit poses (the animate command's path; surfjax's, so
    both sides start from the same bits): translation and rotation equal
    to surfjax's op by op to the bit, the rotation orthonormal."""
    with jax.disable_jit():
        q = [sj_orbit_pose(jnp.float32(4.0), jnp.float32(1.0),
                           jnp.float32(th)) for th in (0.3, 1.1)]
        R_ref, t_ref = sj_pose_interp(q[0], q[1], jnp.float32(t))
    p = [tuple(torch.from_numpy(np.array(v)) for v in pose) for pose in q]
    R, tr = pose_interp(p[0], p[1], t)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(t_ref))
    np.testing.assert_array_equal(R.numpy(), np.asarray(R_ref))
    Rm = R.double().numpy().reshape(3, 3)
    np.testing.assert_allclose(Rm.T @ Rm, np.eye(3), atol=1e-6)


def test_validate_framebuffers():
    scene, cam, st = _c1()
    fb = render(scene, cam, st, device="cpu")
    rep = validate_framebuffers(fb)
    assert rep["ok"], rep
    assert 0.0 < rep["hit_frac"] < 1.0
    bad = fb._replace(rgb=fb.rgb.clone())
    bad.rgb[0, 0, 0] = float("nan")
    bad.rgb[0, 1, 0] = float("inf")
    bad.rgb[0, 2, 0] = -1.0
    rep = validate_framebuffers(bad)
    assert (rep["rgb_nan"], rep["rgb_inf"], rep["rgb_negative"]) == (1, 1, 1)
    assert not rep["ok"]


def test_checked_raises_at_the_first_non_finite_op():
    """tests/test_utils.py's case: log(x)/x is clean on [1, 2] and not on
    [0, 2], where log gives -inf; the error names the op."""
    f = checked(lambda x: torch.log(x) / x)
    out = f(torch.tensor([1.0, 2.0]))
    torch.testing.assert_close(out, torch.log(torch.tensor([1.0, 2.0]))
                               / torch.tensor([1.0, 2.0]))
    with pytest.raises(NonFiniteError, match="aten.log"):
        f(torch.tensor([0.0, 2.0]))
    # outside the wrapper nothing is tapped
    assert torch.isinf(torch.log(torch.tensor([0.0]))).all()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_checked_clean_c1_render(backend):
    """A c1 render makes no NaN or Inf in any op of either backend."""
    scene, cam, st = _c1(16)
    fb = checked(render)(scene, cam, st.with_(backend=backend), device="cpu")
    assert validate_framebuffers(fb)["ok"]


def test_trace_render_writes_a_trace(tmp_path):
    scene, cam, st = _c1(8)
    with trace_render(None) as prof:
        assert prof is None
    d = tmp_path / "prof"
    with trace_render(str(d)):
        with annotate("stage_render"):
            render(scene, cam, st, device="cpu")
    (trace,) = list(d.iterdir())
    text = trace.read_text()
    assert trace.suffix == ".json" and "stage_render" in text
    json.loads(text)


def _chunks(calls):
    def render_chunk(start, count):
        calls.append(start)
        return np.full((count, 4, 4, 3), float(start), np.float32)
    return render_chunk


def test_sequence_checkpoint_resume_and_fault(tmp_path):
    calls = []
    cp = SequenceCheckpointer(str(tmp_path), chunk_size=4)
    fired = []

    def fault(start):
        if start == 4 and not fired:
            fired.append(True)
            raise RuntimeError("injected device failure")

    cp.render_all(10, _chunks(calls), fault_hook=fault)
    assert calls == [0, 4, 8] and fired
    out = cp.load_all()
    assert out.shape == (10, 4, 4, 3)
    np.testing.assert_array_equal(out[:, 0, 0, 0], [0] * 4 + [4] * 4 + [8] * 2)
    calls.clear()
    SequenceCheckpointer(str(tmp_path), chunk_size=4).render_all(
        10, _chunks(calls))
    assert calls == []


def test_sequence_checkpoint_gives_up_after_retries(tmp_path):
    cp = SequenceCheckpointer(str(tmp_path), chunk_size=2)

    def broken(start, count):
        raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        cp.render_all(4, broken, max_retries=1)
    with pytest.raises(ValueError, match="no checkpoint chunks"):
        cp.load_all()


def test_sequence_checkpoint_chunk_size_change_resets(tmp_path):
    calls = []
    SequenceCheckpointer(str(tmp_path), chunk_size=4).render_all(
        8, _chunks(calls))
    cp = SequenceCheckpointer(str(tmp_path), chunk_size=8)
    calls.clear()
    cp.render_all(8, _chunks(calls))
    assert calls == [0]
    np.testing.assert_array_equal(cp.load_all()[:, 0, 0, 0], [0] * 8)


def test_sequence_checkpoint_shorter_rerun(tmp_path):
    """A rerun with fewer frames prunes the chunk it re-renders and
    ignores the longer run's chunks past its range."""
    SequenceCheckpointer(str(tmp_path), chunk_size=16).render_all(
        48, _chunks([]))
    cp = SequenceCheckpointer(str(tmp_path), chunk_size=16)
    cp.render_all(20, _chunks([]))
    rgb = cp.load_all(20)
    assert rgb.shape == (20, 4, 4, 3)
    assert (rgb[:16] == 0.0).all() and (rgb[16:] == 16.0).all()
    assert "16:16" not in cp.manifest["chunks"]
    np.testing.assert_array_equal(cp.load_all(), rgb)
    with pytest.raises(ValueError, match="gap"):
        cp.load_all(40)   # 20:4, then the longer run's 32:16
    with pytest.raises(ValueError, match="incomplete"):
        cp.load_all(24)


def test_sequence_checkpoint_takes_tensors(tmp_path):
    """A chunk may come back as a tensor (render_sequence's rgb)."""
    cp = SequenceCheckpointer(str(tmp_path), chunk_size=3)
    cp.render_all(5, lambda s, n: torch.full((n, 2, 2, 3), float(s)))
    out = cp.load_all(5)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 0, 0, 0], [0, 0, 0, 3, 3])
