"""The many-object scenes of workload.limit_cases (65 to 200 objects, more
than 64 of them outside the crowd) through the port's kernel route on the
CPU: every kernel call of the port's render against the body that
surfjax's Pallas kernel runs, on the same inputs, op by op
(jax.disable_jit), bitwise.

  * K1 (`render_tile`) against `scene_march_twin`, the pure-jnp twin of
    surfjax's K1 body (trace_core, normals_core, _ao_compute): t, obj,
    the normal, AO and hit;
  * K2 (`trace_rays`) against `visibility_core`, K2's body: vis;
  * ao_fix against `_ao_compute` at the receivers that need it, ao_fix's
    body: ao. The mesh kernel takes none of these objects.

Each object goes through surfjax's per-object code, as its Pallas path
unrolls it, but where the case turns the crowd on (`crowd ...`: 128
members and 71 objects outside them, with and without a mesh); there the
crowd's members go through surfjax's crowd sections as well. The port's
plain versions are what the CUDA kernels equal bitwise
(tests/test_torch_kernel_cuda.py, chip_smoke.py phase 24), so this holds
the kernel route's every buffer to surfjax's own kernel arithmetic.

Why not the whole frame against surfjax's `jnp` backend: on these scenes
at 16x16 surfjax's jnp render agrees with the port in hits and ids but not
within the North star (depth 4.1e-4 relative, rgb 5.6e-3 with hard
shadows and 2.0e-2 with soft ones), while the port's frames are within it
of surfjax's Pallas path (tests/test_torch_scene_limits_ref.py): the gap
is between surfjax's two backends. Its compile also
takes 400-440 s at 129 objects. surfjax's per-object Pallas path in
interpret mode takes 309-567 s per case; the bodies op by op take 20-80 s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import surfjax.api as sj_api  # noqa: E402
from surfjax.kernels import render_tile as sj_rt  # noqa: E402

import surfjax_torch.api as api  # noqa: E402
from surfjax_torch.core.camera import flat_camera_rays  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.tools.kernel_check import (  # noqa: E402
    KERNELS, capture_calls, flat,
)

SIZE = (16, 16)
NAMES = ["64 spheres", "120+8", "120+8 soft", "crowd 120+8+70", "mesh + 70",
         "crowd 120+8+70 + mesh"]


def port_calls(scene, cam, st, mesh: bool):
    """The port's kernel calls of a case, on the CPU: a mesh scene's
    render, or the split path's forward over the camera's flat rays."""
    with capture_calls() as calls:
        if mesh:
            api.render(scene, cam, st, device="cpu")
        else:
            static, params = scene.freeze()
            R = torch.as_tensor(np.asarray(cam.rotation,
                                           np.float32).reshape(9))
            pos = torch.as_tensor(np.asarray(cam.position, np.float32))
            o, d, _ = flat_camera_rays(cam.intrinsics, R, pos)
            rt.render_rays_pallas(static, st, params_to_device(params, "cpu"),
                                  o, d)
    return calls


def surfjax_body(static, st, lp, npar, kname, args):
    """surfjax's kernel body for one of the port's calls, op by op ->
    (output names, numpy arrays)."""
    def j(ts):
        return tuple(jnp.asarray(t.numpy()) for t in ts)
    crowd = (sj_rt.crowd_meta(static, st), lp, npar)
    with jax.disable_jit():
        if kname == "render_tile":
            assert len(args) == 4           # no primed starts here
            t, obj, n, ao, hit = sj_rt.scene_march_twin(
                static, st, lp, npar, j(args[2]), j(args[3]))
            return (("t", "obj", "nx", "ny", "nz", "ao", "hit"),
                    (t, obj, n[0], n[1], n[2], ao, hit))
        if kname == "trace_rays":
            o, l, dist, soft_k = args[2:]
            vis, _ = sj_rt.visibility_core(
                static, st, lp, npar, j(o), j(l), jnp.asarray(dist.numpy()),
                soft_k=jnp.asarray(soft_k.numpy()), crowd_refs=crowd)
            return ("vis",), (vis,)
        assert kname == "ao_fix"
        p_off, n, need, ao_in = args[2:]
        ao = sj_rt._ao_compute(static, st, lp, npar, j(p_off), j(n),
                               already_offset=True, crowd_refs=crowd)
        need = jnp.asarray(need.numpy())
        return ("ao",), (jnp.where(need > 0.5, ao,
                                   jnp.asarray(args[5].numpy())),)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_calls_equal_surfjax_bodies(name):
    sj_scene, _, sj_st = workload.limit_cases(sj_api, SIZE)[name]
    scene, cam, st = workload.limit_cases(api, SIZE)[name]
    static, params = sj_scene.freeze()
    crowd, ana, sdf = rt.split_crowd(scene.freeze()[0], st)
    assert len(ana) + len(sdf) > 64
    assert (crowd is not None) == name.startswith("crowd")
    lp = jnp.asarray(params["leaf_params"])
    npar = jnp.asarray(params["node_params"])
    calls = port_calls(scene, cam, st, "mesh" in name)
    held, k1 = [], None
    for k, (kname, args) in enumerate(calls):
        if kname in ("mesh_candidates", "mesh_tile"):
            continue
        got = flat(KERNELS[kname][0](*args))
        k1 = got if k1 is None and kname == "render_tile" else k1
        names, ref = surfjax_body(static, sj_st, lp, npar, kname, args)
        for out_name, a, b in zip(names, got, ref):
            assert np.array_equal(a.numpy(), np.asarray(b)), \
                f"{name} call {k} {kname} {out_name}"
        held.append(kname)
    want = {"render_tile", "trace_rays"} | ({"ao_fix"} if "mesh" in name
                                            else set())
    assert set(held) == want, held
    obj, hit = k1[1], k1[6]
    assert float(hit.mean()) > 0.5
    assert len(torch.unique(obj)) > 20, name
