"""The port's command line (python -m surfjax_torch) on tests/test_cli.py's
tiny config, on the CPU: render --golden --gbuffer writes the files
surfjax's command writes, bit for bit; .exr output, --profile-dir and
animate --chunk-size with its resume."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax.__main__ import main as sj_main  # noqa: E402

from surfjax_torch.__main__ import main  # noqa: E402

from tests.test_cli import _TINY  # noqa: E402


@pytest.fixture()
def tiny_config(tmp_path):
    p = tmp_path / "tiny.yaml"
    p.write_text(_TINY)
    return str(p)


def test_render_golden_gbuffer_equal_to_surfjax(tiny_config, tmp_path):
    ours, theirs = str(tmp_path / "pt.png"), str(tmp_path / "sj.png")
    main(["render", "--config", tiny_config, "--golden", "--gbuffer",
          "--device", "cpu", "--out", ours])
    sj_main(["render", "--config", tiny_config, "--golden", "--gbuffer",
             "--out", theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with np.load(str(tmp_path / "pt_gbuffer.npz")) as a, \
            np.load(str(tmp_path / "sj_gbuffer.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == ["depth", "normal",
                                                       "rgb"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["rgb"].shape == (48, 64, 3)


def test_render_exr_and_profile_dir(tiny_config, tmp_path):
    from tests.test_io import _read_exr
    out = str(tmp_path / "f.exr")
    prof = tmp_path / "prof"
    main(["render", "--config", tiny_config, "--device", "cpu",
          "--gbuffer", "--profile-dir", str(prof), "--out", out])
    planes = _read_exr(out)
    with np.load(str(tmp_path / "f_gbuffer.npz")) as z:
        for k, c in enumerate("RGB"):
            np.testing.assert_array_equal(planes[c], z["rgb"][..., k])
    (trace,) = list(prof.iterdir())
    assert trace.suffix == ".json" and trace.stat().st_size > 0


def test_animate_chunked_resume(tiny_config, tmp_path, capsys):
    out_dir = tmp_path / "frames"
    args = ["animate", "--config", tiny_config, "--frames", "5",
            "--chunk-size", "2", "--device", "cpu", "--out-dir",
            str(out_dir)]
    main(args)
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert pngs == [f"frame_{i:04d}.png" for i in range(5)]
    chunks = sorted(f for f in os.listdir(out_dir) if f.startswith("chunk"))
    assert len(chunks) == 3
    first = {c: (out_dir / c).stat().st_mtime_ns for c in chunks}
    frame0 = (out_dir / pngs[0]).read_bytes()
    # the rerun resumes: no chunk is rendered again
    main(args)
    assert {c: (out_dir / c).stat().st_mtime_ns for c in chunks} == first
    assert (out_dir / pngs[0]).read_bytes() == frame0
    assert "rendered 5 frames" in capsys.readouterr().out
