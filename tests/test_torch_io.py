"""The port's image I/O (surfjax_torch/io/image.py) against surfjax's: the
ULP tools equal on seeded float32 arrays with every kind of value, EXR and
PNG files byte-identical for the same input, golden .npz round trips."""

import numpy as np
import pytest

from surfjax.io import image as sj_image

from surfjax_torch.io import image as pt_image


def _specials(seed, n=4096):
    """Seeded float32 values: normals of both signs and many scales, +-0,
    subnormals, +-inf and the largest finite values."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=n) * 10.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    sub = (rng.uniform(-1, 1, 64) * 1e-39).astype(np.float32)
    special = np.asarray([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                          np.finfo(np.float32).max, np.finfo(np.float32).min,
                          np.finfo(np.float32).tiny, 1.0], np.float32)
    return np.concatenate([a, sub, special])


@pytest.mark.parametrize("seed", [0, 1])
def test_ulp_tools_equal_to_surfjax(seed):
    a = _specials(seed)
    rng = np.random.default_rng(100 + seed)
    # neighbours a few ULP away, other specials, and a itself shuffled
    near = a.view(np.int32) + rng.integers(-3, 4, a.size).astype(np.int32)
    for b in (near.view(np.float32), _specials(seed + 7),
              rng.permutation(a)):
        got = pt_image.ulp_diff_f32(a, b)
        np.testing.assert_array_equal(got, sj_image.ulp_diff_f32(a, b))
        assert pt_image.max_ulp(a, b) == sj_image.max_ulp(a, b)
    assert pt_image.ulp_diff_f32(np.float32([0.0]), np.float32([-0.0]))[0] == 0
    assert pt_image.ulp_diff_f32(np.float32([1e-45]),
                                 np.float32([-1e-45]))[0] == 2
    one = np.float32(1.0)
    nxt = np.nextafter(one, np.float32(2.0), dtype=np.float32)
    assert pt_image.max_ulp(np.asarray([one, one]), np.asarray([nxt, one])) == 1


@pytest.mark.parametrize("kind", ["rgb", "channels"])
def test_save_exr_byte_identical_to_surfjax(tmp_path, kind):
    rng = np.random.default_rng(3)
    if kind == "rgb":
        data = rng.random((7, 5, 3), dtype=np.float32)
    else:
        z = rng.normal(size=(5, 9)).astype(np.float32)
        data = {"Z": z, "A": (z > 0).astype(np.float32)}
    ours, theirs = tmp_path / "pt.exr", tmp_path / "sj.exr"
    pt_image.save_exr(str(ours), data)
    sj_image.save_exr(str(theirs), data)
    assert ours.read_bytes() == theirs.read_bytes()


def test_save_exr_rejects_bad_shapes(tmp_path):
    with pytest.raises(ValueError):
        pt_image.save_exr(str(tmp_path / "x.exr"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        pt_image.save_exr(str(tmp_path / "x.exr"),
                          {"A": np.zeros((2, 3), np.float32),
                           "B": np.zeros((3, 2), np.float32)})


def test_png_and_golden_roundtrip(tmp_path):
    rgb = np.linspace(0, 1, 4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    pt_image.save_png(str(tmp_path / "pt.png"), rgb)
    sj_image.save_png(str(tmp_path / "sj.png"), rgb)
    assert (tmp_path / "pt.png").read_bytes() == \
        (tmp_path / "sj.png").read_bytes()
    path = str(tmp_path / "sub" / "g.npz")
    bufs = {"rgb": rgb, "depth": rgb[..., 0],
            "obj_id": np.arange(24, dtype=np.int32).reshape(4, 6)}
    pt_image.save_golden(path, bufs)
    back = pt_image.load_golden(path)
    assert sorted(back) == sorted(bufs)
    for k in bufs:
        assert back[k].dtype == bufs[k].dtype
        np.testing.assert_array_equal(back[k], bufs[k])
    for k, v in sj_image.load_golden(path).items():
        np.testing.assert_array_equal(v, bufs[k])
