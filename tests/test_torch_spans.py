"""The program's spans (utils/profiling.annotate): the tree of
`surfjax_torch.*` ranges a render leaves in a torch.profiler trace, on the
CPU, where the kernel wrappers run their plain versions through the same
functions.

  * a split-path pass (a mesh beside an SDF sphere, AO and soft shadows,
    two frames in one pass): the ray set-up, the primary stage with K1,
    the candidates (holding their kernel's span) and mesh kernel per mesh
    and their merge, ao_fix; per light the visibility with K2 and the
    candidates and mesh kernel per mesh; the shading and the outputs
    last; mesh_candidates called alone leaves its span and its kernel's;
  * a mesh-free sequence and frame: KF and the outputs in the pass, no
    span of the split path; KF's span is `kernel.kf_crowd` where the scene
    forms a crowd (its crowd instantiation) and `kernel.kf` where not, and
    on the card each counts its launches apart;
  * with no profiler running a span records nothing, and the decorated
    functions keep their names, docstrings and launch counters.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from surfjax_torch import api  # noqa: E402
from surfjax_torch.kernels import mesh_tile as mt  # noqa: E402
from surfjax_torch.kernels import render_tile as rt  # noqa: E402
from surfjax_torch.meshgen import octasphere  # noqa: E402
from surfjax_torch.pipeline import frame  # noqa: E402
from surfjax_torch.tools import workload  # noqa: E402
from surfjax_torch.utils import profiling  # noqa: E402

PREFIX = "surfjax_torch."


def _span_tree(run):
    """run() under torch.profiler on the CPU -> its spans as nested
    (name, [children]) lists in the order they started, the prefix cut."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = sorted(((e.start_ns(), -e.end_ns(), e.name()[len(PREFIX):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(PREFIX)))
    root, stack = [], []
    for start, neg_end, name in spans:
        while stack and stack[-1][0] <= start:
            stack.pop()
        node = (name, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((-neg_end, node[1]))
    return root


def _names(nodes):
    return [n for n, _ in nodes]


def _child(nodes, name):
    (kids,) = [k for n, k in nodes if n == name]
    return kids


def _split_pass(static, st):
    """The spans of one split-path pass of `static` under `st`, as
    test_torch_sequence_batch._calls_of_pass counts its kernel calls:
    K1, per mesh the candidates, the mesh kernel and the merge, ao_fix
    where AO meets a mesh and another object; per light K2 and per mesh
    the candidates and the mesh kernel."""
    meshes = len(rt._split(static)[2])
    primary = ["kernel.k1"] + ["mesh_candidates", "kernel.mesh_tile",
                               "merge"] * meshes
    if st.ao and meshes and len(static.ir.objects) > meshes:
        primary += ["merge", "kernel.ao_fix"]
    vis = ["kernel.k2"] + ["mesh_candidates", "kernel.mesh_tile"] * meshes
    return primary, vis


def test_split_pass_spans_follow_its_calls():
    scene, cam, st = workload.mesh_soft_ao_scene(api, 64)
    cam = workload.reframe(cam, 64, 48)
    st = st.with_(tile_rows=8)
    poses = workload.poses(
        cam, 2, np.random.default_rng(7).normal(0.0, 0.02, (2, 3)))
    tree = _span_tree(lambda: api.render_sequence(scene, cam, poses, st,
                                                  device="cpu"))
    assert _names(tree) == ["render_sequence"]
    passes = _child(tree, "render_sequence")
    assert _names(passes) == ["pass"]
    top = _child(passes, "pass")
    static = scene.freeze()[0]
    n_lights = len(static.ir.lights)
    assert _names(top) == ["rays", "primary", "lights", "shade", "outputs",
                           "outputs"]
    primary, vis = _split_pass(static, st)
    assert _names(_child(top, "primary")) == primary
    lights = _child(top, "lights")
    assert _names(lights) == ["visibility"] * n_lights
    for _, kids in lights:
        assert _names(kids) == vis
    # the kernels' and the merges' spans are leaves; the candidates' span
    # holds its kernel's
    for name, kids in _child(top, "primary") + lights[0][1]:
        assert _names(kids) == (["kernel.mesh_candidates"]
                                if name == "mesh_candidates" else []), name
        assert all(k == [] for _, k in kids), name
    assert _child(top, "rays") == [] and _child(top, "shade") == []


def test_candidates_span_holds_one_kernel_span():
    """mesh_candidates called alone: its span and, nested, its kernel's
    (the plain version's on the CPU), once per call; the launch counter
    moves only on the card."""
    v, f = octasphere(2)
    scene = api.Scene().add(api.TriangleMesh(
        vertices=v * np.float32(0.8) + np.float32([0.0, 0.0, 3.0]),
        faces=f))
    static, params = scene.freeze()
    ms = static.mesh_static[0]
    tri = torch.as_tensor(params["mesh0_tri_packed"])
    o = tuple(torch.zeros(4, 128) for _ in range(3))
    d = (torch.zeros(4, 128), torch.zeros(4, 128), torch.ones(4, 128))
    before = mt.mesh_candidates.launches
    tree = _span_tree(lambda: [mt.mesh_candidates(ms, tri, o, d, 1e-3, 1e4,
                                                  2) for _ in range(2)])
    assert tree == [("mesh_candidates",
                     [("kernel.mesh_candidates", [])])] * 2
    assert mt.mesh_candidates.launches == before


@pytest.mark.parametrize("entry", ["render_sequence", "render"])
def test_fused_pass_spans(entry):
    scene = api.Scene()
    scene.add(api.Sphere(center=(0.0, 0.0, 3.0), radius=0.7),
              api.Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    cam = api.Camera.pinhole(24, 16, 45.0, position=(0.0, 0.3, 0.0),
                             target=(0.0, 0.0, 3.0))
    st = api.RenderSettings(shadows=True, ao=True, backend="pallas")
    if entry == "render":
        tree = _span_tree(lambda: api.render(scene, cam, st, device="cpu"))
        root = "render_frame"
    else:
        poses = workload.poses(cam, 2, np.zeros((2, 3)))
        tree = _span_tree(lambda: api.render_sequence(scene, cam, poses, st,
                                                      device="cpu"))
        root = "render_sequence"
    assert _names(tree) == [root]
    assert _names(_child(tree, root)) == ["pass"]
    top = _child(_child(tree, root), "pass")
    assert _names(top) == ["kernel.kf", "outputs"], top
    assert all(kids == [] for _, kids in top)


def _kf_scene(crowd: bool):
    """Two spheres over a plane, 24x16: with the crowd on, the spheres form
    KF's crowd; with it off, the staged kernel takes every object."""
    scene = api.Scene()
    for x in (-0.4, 0.4):
        scene.add(api.Sphere(center=(x, 0.0, 3.0), radius=0.3),
                  api.Material.lambert(albedo=(0.8, 0.4, 0.3)))
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-0.5),
              api.Material.lambert())
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    cam = api.Camera.pinhole(24, 16, 45.0, position=(0.0, 0.3, 0.0),
                             target=(0.0, 0.0, 3.0))
    st = api.RenderSettings(shadows=True, ao=True, backend="pallas",
                            vector_objects=crowd)
    assert rt.launches_crowd(scene.freeze()[0], st) == crowd
    return scene, cam, st


@pytest.mark.parametrize("crowd", [True, False])
def test_kf_span_names_the_crowd_instantiation(crowd):
    scene, cam, st = _kf_scene(crowd)
    poses = workload.poses(cam, 2, np.zeros((2, 3)))
    tree = _span_tree(lambda: api.render_sequence(scene, cam, poses, st,
                                                  device="cpu"))
    top = _child(_child(tree, "render_sequence"), "pass")
    kf = "kernel.kf_crowd" if crowd else "kernel.kf"
    assert _names(top) == [kf, "outputs"], top
    assert isinstance(rt.frame_fused.crowd.launches, int)


@pytest.mark.cuda
@pytest.mark.parametrize("crowd", [True, False])
def test_kf_launches_count_apart_on_card(crowd):
    """One render_sequence call: one launch, in `frame_fused.crowd` with a
    crowd and in `frame_fused` without, the other count unmoved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    scene, cam, st = _kf_scene(crowd)
    poses = workload.poses(cam, 2, np.zeros((2, 3)))
    counts = lambda: (rt.frame_fused.crowd.launches, rt.frame_fused.launches)
    before = counts()
    api.render_sequence(scene, cam, poses, st, device="cuda")
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(counts(), before))
    assert got == ((1, 0) if crowd else (0, 1))


def test_annotate_is_free_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)

    @profiling.annotate("test.fn")
    def double(x):
        """Twice x."""
        return 2 * x

    def run():
        with profiling.annotate("test.block"):
            return double(3)

    assert run() == 6 and opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert run() == 6
    assert opened == ["test.block", "test.fn"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"test.block", "test.fn"} <= names
    assert double.__name__ == "double" and double.__doc__ == "Twice x."
    for fn in (frame.render_sequence, frame.render_frame, rt.frame_buffers, rt.render_tile, rt.render_tile_redo,
               rt.trace_rays, rt.trace_rays_redo, rt.ao_fix, rt.prime_tile,
               rt._render_pass, rt._pallas_primary, rt._pallas_vis,
               rt._light_terms, mt.mesh_candidates, mt.mesh_tile):
        inner = inspect.unwrap(fn)
        assert inner is not fn
        assert fn.__name__ == inner.__name__ and fn.__doc__ == inner.__doc__
    for fn in (rt.frame_fused, rt.render_tile, rt.trace_rays, rt.ao_fix,
               rt.prime_tile, mt.mesh_tile, mt.mesh_candidates):
        assert isinstance(fn.launches, int)
    assert isinstance(rt.render_tile.crowd.launches, int)
    assert isinstance(rt.frame_fused.crowd.launches, int)
