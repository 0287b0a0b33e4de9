"""The FP32 roofline probe of the port (surfjax_torch/tools/fp32_peak.py)
against the TPU tool it replaces (tools/vpu_peak.py), on the CPU.

The TPU tool's three kernel bodies run here through an interpret-mode
`pl.pallas_call`, built as its `run` builds it; the port runs its plain
version (the CUDA kernels exist only on the card, see
tests/test_torch_kernel_cuda.py). Inputs come from a seeded numpy
generator and go to both.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch.core.math import f32, maximum, minimum, sqrt  # noqa: E402
from surfjax_torch.core.scene_compile import LEAF_MANDELBULB  # noqa: E402
from surfjax_torch.engines import sdf as pt_sdf  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.tools import fp32_peak as fp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vpu_peak():
    spec = importlib.util.spec_from_file_location(
        "vpu_peak", os.path.join(ROOT, "tools", "vpu_peak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeds(rows=8):
    rng = np.random.default_rng(0)
    return [rng.uniform(0.1, 0.3, (rows, 128)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("kind", ["bulb_mix", "cheb_mix", "fma_dep"])
def test_reference_matches_tpu_tool_kernels(kind, unroll):
    """8 x 128 lanes, K = 8. The gap is XLA:CPU's side: its rsqrt is
    approximate and it contracts multiply-adds, while the port rounds every
    operation on its own (and its fma_dep is the fused value) -> 1e-5
    relative."""
    vp = _vpu_peak()
    body = {"bulb_mix": vp._bulb_mix_kernel, "cheb_mix": vp._cheb_mix_kernel,
            "fma_dep": vp._fma_dep_kernel}[kind]
    n_in = 1 if kind == "fma_dep" else 3
    ins = _seeds()
    call = pl.pallas_call(
        functools.partial(body, iters=8, unroll=unroll),
        grid=(1,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))] * n_in,
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)
    want = np.asarray(call(*[jnp.asarray(a) for a in ins[:n_in]]))
    px, py, pz = (torch.as_tensor(a) for a in ins)
    # the wrapper on CPU tensors is the plain version, whatever the unroll
    got = fp.fp32_peak(kind, px, py, pz, 8, unroll).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    assert np.ptp(got) > 0.0


@pytest.mark.parametrize("form, kind", [("std", "bulb_mix"),
                                        ("cheb", "cheb_mix")])
def test_plain_substep_is_the_de_loop_of_the_render_path(form, kind):
    """K substeps of the probe's plain version are K iterations of
    `_bulb_while_driver`'s loop, to the bit: the DE recomputed from the
    orbit the probe's loop leaves equals the fused path's DE, and the
    probe's output is that orbit's sum. Seeds span inside and outside the
    bailout radius, so frozen lanes are covered."""
    rng = np.random.default_rng(5)
    p = tuple(torch.as_tensor(rng.uniform(-1.2, 1.2, 512).astype(np.float32))
              for _ in range(3))
    prm = torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0])     # bailout2 = 64
    new_w_of = {"std": pt_sdf._new_w_std, "cheb": pt_sdf._new_w_cheb}[form]
    K = 6
    wx, wy, wz, dz, m = pt_sdf._bulb_orbit(*p, fp.BAILOUT2, K, new_w_of)
    assert bool((m > fp.BAILOUT2).any()) and bool((m <= fp.BAILOUT2).any())
    assert torch.equal(fp.fp32_peak_reference(kind, *p, K),
                       (wx + wy) + (wz + dz) + m)
    de = 0.25 * torch.log(maximum(m, f32(1e-30))) * sqrt(m) / dz
    far = sqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]) - f32(1.35)
    de = torch.where(far > 0.0, minimum(de, far + f32(0.1)), de)
    assert torch.equal(pt_sdf.make_bulb_while(form)(prm, p, 8, K), de)


def test_fma_chain_reference_is_the_fused_chain():
    """Against numpy's float64 evaluation of the same chain rounded once
    per step (the fused value), and within 1e-5 of the two-rounding a*b+c;
    b and c come from the lane's seed."""
    a0 = _seeds()[0]
    got = fp.fp32_peak_reference("fma_dep", torch.as_tensor(a0), None, None,
                                 32).numpy()
    b32, c32 = a0 * np.float32(0.999), a0 * np.float32(1e-6)
    a = a0
    for _ in range(32):
        a = (a.astype(np.float64) * b32.astype(np.float64)
             + c32.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, a)
    two = a0
    for _ in range(32):
        two = two * b32 + c32
    np.testing.assert_allclose(got, two, rtol=1e-5)
    assert np.ptp(got) > 0.0


@pytest.mark.parametrize("form, per_iter", [("std", 81), ("cheb", 62)])
def test_count_ops_reports_bulb_iteration_lanes(form, per_iter):
    """count_ops' "bulb_iters" is the number of orbit updates the lanes
    ran: the bulb's centre never escapes (all 10), a far point runs none,
    and a point just inside the bailout radius escapes after a few; each is
    charged the hand count of its form."""
    st = pt_rt.RenderSettings(bulb_iter=form)
    prm = torch.tensor([0.0, 0.0, 0.0, 1.0, 2.0])
    p = (torch.tensor([0.0, 100.0, 1.5]), torch.zeros(3), torch.zeros(3))
    want = pt_rt._bulb_iters(prm, p, 10, form)
    assert want[0] == 10 and want[1] == 0 and 0 < want[2] < 10

    class NoTape:
        objs = ()

    with pt_rt.count_ops() as counted:
        pt_rt._fast_leaf_fn(st)(LEAF_MANDELBULB, prm, p, 8, 10)
        pt_rt._tally_de(NoTape, torch.tensor([True, True, True]))
    assert counted["bulb_iters"] == int(want.sum())
    assert counted["ops"] == per_iter * int(want.sum())
    assert pt_rt.BULB_ITER_OPS[form] == per_iter == fp.ops_per_iter(
        {"std": "bulb_mix", "cheb": "cheb_mix"}[form])


def test_tool_raises_without_a_card():
    """The probe measures the card: without one `run` and the CLI raise,
    and the wrapper takes only CPU tensors (plain version) or CUDA tensors
    (kernel), counting no launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        fp.run(iters=8, rows=8, grid=1, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA card"):
        fp.run(iters=8, rows=8, grid=1, repeats=1, device="cpu")
    with pytest.raises(SystemExit, match="is_available"):
        fp.main([])
    before = dict(fp.fp32_peak.launches)
    meta = tuple(torch.zeros((8, 128), device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        fp.fp32_peak("cheb_mix", *meta, 8)
    with pytest.raises(ValueError, match="kind must be"):
        fp.fp32_peak("trig_mix", *meta, 8)
    for chain in fp.CHAINS:
        with pytest.raises(ValueError, match="no contracted variant"):
            fp.fp32_peak(chain, *meta, 8, fma=True)
    assert fp.fp32_peak.launches == before


def test_broken_measurements_are_refused():
    """An fma_dep row above 105% of the data-sheet peak, or a mix doing
    more operations per second than the best fma_dep row, raises; nan rows
    (a differential that was not positive) pass through as nan."""
    ok = {"fma_dep@u1": {"tflops": 33.0}, "fma_dep@u4": {"tflops": 43.0},
          "cheb_mix@u1": {"tflops": 20.0},
          "bulb_mix_fma@u1": {"tflops": float("nan")}}
    fp.check_rows(ok)
    fp.check_rows(dict(ok, **{"cheb_mix_fma@u4": {"tflops": 40.0}}))
    with pytest.raises(RuntimeError, match="105%"):
        fp.check_rows(dict(ok, **{"fma_dep@u8": {"tflops": 71.0}}))
    with pytest.raises(RuntimeError, match="more than"):
        fp.check_rows(dict(ok, **{"cheb_mix_fma@u4": {"tflops": 44.0}}))
