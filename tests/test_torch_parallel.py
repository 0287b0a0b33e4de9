"""surfjax_torch.parallel: sharded frames and sequences, the mesh, the dry
run of the sharded fit step.

  * the shard arithmetic as plain functions of (rank, world, mesh shape):
    every rank of a simulated world rendered in this process, the shards
    concatenated frame-major, bitwise equal to the unsharded render in
    every buffer, through the split path's plain versions and the eager
    pipeline, at sizes whose shards end inside a 128-ray row;
  * a spawned gloo world of 4 ranks on the CPU proves the collectives:
    frames, a sequence and the triangle ring, each rank's result bitwise
    equal to the unsharded one; dryrun_multichip(4) spawns its own, within
    1e-6 relative of world 1 (the sum runs in another order);
  * the port against surfjax's sharded render on the 8 virtual CPU devices
    (jnp backend, jitted) at the bounds the eager pipeline is held to
    against jitted surfjax (test_torch_pipeline.JIT_TOL);
  * make_mesh's errors, initialize_distributed returning at once in a
    group, and the dry run against surfjax's unsharded step.

surfjax and jax are imported inside the tests that compare with them, so
the spawned ranks, which import this module, never load them.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from surfjax_torch import api  # noqa: E402
from surfjax_torch.config import load_config  # noqa: E402
from surfjax_torch.core.camera import flat_camera_rays  # noqa: E402
from surfjax_torch.core.scene_compile import params_to_device  # noqa: E402
from surfjax_torch.core.types import FrameBuffers  # noqa: E402
from surfjax_torch.kernels.render_tile import render_rays_pallas  # noqa: E402
from surfjax_torch.parallel import (  # noqa: E402
    initialize_distributed, make_mesh, render_frame_sharded,
    render_sequence_sharded,
)
from surfjax_torch.parallel import dryrun  # noqa: E402
from surfjax_torch.parallel.launch import run_world  # noqa: E402
from surfjax_torch.parallel.mesh import (  # noqa: E402
    _crop_reshape, render_frame_shard, render_sequence_shard,
)
from surfjax_torch.pipeline.frame import (  # noqa: E402
    _pose_tensors, render_rays,
)
from surfjax_torch.tools.workload import (  # noqa: E402
    mesh_soft_ao_scene, poses, reframe,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _config(name, width, height, **overrides):
    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 name + ".yaml"))
    return scene, reframe(cam, width, height), st.with_(**overrides)


def _frame_case(case, backend):
    """-> (scene, camera, settings) of a frame case."""
    if case == "mesh_soft_ao 250x131":
        scene, cam, st = mesh_soft_ao_scene(api, 64)
        return scene, reframe(cam, 250, 131), st.with_(backend=backend)
    name, size = case.split()
    w, h = (int(x) for x in size.split("x"))
    return _config(name, w, h, backend=backend)


def _unsharded_frame(scene, cam, st) -> FrameBuffers:
    """The frame's flat rays in one call -> FrameBuffers (H, W, ...)."""
    static, params = scene.freeze()
    params = params_to_device(params, CPU)
    R, t = _pose_tensors(cam, CPU)
    o, d, n = flat_camera_rays(cam.intrinsics, R, t)
    fn = render_rays_pallas if st.backend == "pallas" else render_rays
    with torch.no_grad():
        fb = fn(static, st, params, o, d)
    intr = cam.intrinsics
    return _crop_reshape(fb, n, intr.height, intr.width)


def _simulated_frame(scene, cam, st, count) -> FrameBuffers:
    """Every rank of a world of `count` rendering its shard here, the
    shards concatenated in rank order (frame-major over a mesh)."""
    static, params = scene.freeze()
    params = params_to_device(params, CPU)
    R, t = _pose_tensors(cam, CPU)
    intr = cam.intrinsics
    with torch.no_grad():
        parts = [render_frame_shard(static, st, params, intr, R, t, r, count)
                 for r in range(count)]
    fb = FrameBuffers(*(torch.cat(p) for p in zip(*parts)))
    return _crop_reshape(fb, intr.width * intr.height, intr.height,
                         intr.width)


def _c5_sequence(size=32, n_frames=4):
    scene, cam, st = _config("c5_anim", size, size, max_steps=32)
    jitter = np.random.default_rng(0).normal(
        0.0, 1e-2, (n_frames, 3)).astype(np.float32)
    return scene, cam, st, poses(cam, n_frames, jitter)


def _unsharded_sequence(scene, cam, st, pose_arrays) -> FrameBuffers:
    frames = [_unsharded_frame(scene, api.Camera(
        cam.intrinsics, tuple(map(tuple, R.reshape(3, 3).tolist())),
        tuple(float(x) for x in p)), st) for R, p in zip(*pose_arrays)]
    return FrameBuffers(*(torch.stack(parts) for parts in zip(*frames)))


def _simulated_sequence(scene, cam, st, pose_arrays, shape):
    static, params = scene.freeze()
    params = params_to_device(params, CPU)
    Rs = torch.as_tensor(pose_arrays[0])
    ps = torch.as_tensor(pose_arrays[1])
    intr = cam.intrinsics
    with torch.no_grad():
        blocks = []
        for f in range(shape[0]):
            tiles = [render_sequence_shard(static, st, params, intr, Rs, ps,
                                           (f, t), shape)
                     for t in range(shape[1])]
            blocks.append(FrameBuffers(*(torch.cat(p, dim=1)
                                         for p in zip(*tiles))))
    fb = FrameBuffers(*(torch.cat(p) for p in zip(*blocks)))
    H, W = intr.height, intr.width
    return FrameBuffers(*(a[:, :H * W].reshape((a.shape[0], H, W)
                                               + a.shape[2:]) for a in fb))


def _assert_bitwise(got, ref, label):
    for name, a, b in zip(FrameBuffers._fields, got, ref):
        assert a.shape == b.shape, (label, name, a.shape, b.shape)
        assert torch.equal(a, b), (label, name)


FRAME_CASES = ["c2_csg 64x64", "c2_csg 250x131", "mesh_soft_ao 250x131"]


@pytest.mark.parametrize("count", [1, 3, 8])
@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("case", FRAME_CASES)
def test_frame_shards_equal_unsharded(case, backend, count):
    """Ranks of a simulated world of 1, 3 and 8: bitwise equal to the
    unsharded frame in every buffer. 250x131 = 32750 rays: over 3 ranks
    each pads its 10917 rays to its own 128-ray rows, over 8 its 4094, so
    every shard ends inside a row of the unsharded call."""
    scene, cam, st = _frame_case(case, backend)
    ref = _unsharded_frame(scene, cam, st)
    assert 0.3 < float(ref.hit.mean()) < 0.95
    _assert_bitwise(_simulated_frame(scene, cam, st, count), ref,
                    f"{case} {backend} x{count}")


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 3), (2, 4)])
@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_sequence_shards_equal_unsharded(backend, shape):
    """Frames in blocks over 'frame', each frame's rays over 'tile': the
    (4, 32, 32) c5 sequence bitwise equal to its frames rendered one by
    one (32 x 32 = 1024 rays, 342 per shard over 3 tiles: a padded
    last pixel and shards ending inside a row)."""
    scene, cam, st, pose_arrays = _c5_sequence()
    st = st.with_(backend=backend)
    ref = _unsharded_sequence(scene, cam, st, pose_arrays)
    got = _simulated_sequence(scene, cam, st, pose_arrays, shape)
    _assert_bitwise(got, ref, f"{backend} {shape}")
    assert float((ref.rgb[0] - ref.rgb[-1]).abs().max()) > 1e-3


def test_sequence_frame_count_must_divide_the_frame_axis(world1):
    """Three frames render on a (1, 1) mesh; over a 'frame' axis of 2
    they do not split into equal blocks and the shard arithmetic raises
    (a world of one rank cannot hold that mesh, so the entry point's own
    check, which raises the same before any rendering, is not reached
    here)."""
    scene, cam, st, pose_arrays = _c5_sequence(8, 3)
    fb = render_sequence_sharded(scene, cam, pose_arrays, st,
                                 make_mesh(device="cpu"), device="cpu")
    assert tuple(fb.rgb.shape) == (3, 8, 8, 3)
    static, params = scene.freeze()
    with pytest.raises(ValueError, match="do not split into 2 equal"):
        render_sequence_shard(static, st, params_to_device(params, CPU),
                              cam.intrinsics,
                              torch.as_tensor(pose_arrays[0]),
                              torch.as_tensor(pose_arrays[1]), (0, 0),
                              (2, 1))


# -- the spawned world and world 1 -------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one rank in this process (the store in tmp)."""
    store = tmp_path_factory.mktemp("world1") / "store"
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    initialize_distributed("cpu", init_method=f"file://{store}", rank=0,
                           world_size=1)
    yield
    dist.destroy_process_group()


def _ring_case():
    """The 509-triangle truncated octasphere and 512 rays."""
    from tests.test_torch_ring_mesh import mesh_tables, rays
    return mesh_tables(509), rays(512)


def _world_worker():
    """One rank of the spawned world: a frame of c2 and of the mesh scene,
    the c5 sequence on a (2, 2) mesh, the triangle ring -> numpy
    results."""
    torch.set_num_threads(1)
    from surfjax_torch.parallel.ring_mesh import ring_trace, shard_triangles
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for case, shape in (("c2_csg 64x64", (1, 4)),
                        ("mesh_soft_ao 250x131", (2, 2))):
        scene, cam, st = _frame_case(case, "pallas")
        fb = render_frame_sharded(scene, cam, st, make_mesh(
            *shape, device="cpu"), device="cpu")
        out[case] = [a.numpy() for a in fb]
    scene, cam, st, pose_arrays = _c5_sequence()
    fb = render_sequence_sharded(scene, cam, pose_arrays,
                                 st.with_(backend="pallas"), device="cpu")
    out["c5 sequence"] = [a.numpy() for a in fb]
    tables, (o, d) = _ring_case()
    ring = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("shard",))
    t, tri = ring_trace(shard_triangles(tables, dist.get_world_size()),
                        o, d, 1e-3, 1e4, ring)
    out["ring"] = (t.numpy(), tri.numpy())
    return out


@pytest.fixture(scope="module")
def spawned_world():
    """The world of 4 gloo ranks on the CPU, spawned once."""
    return run_world(_world_worker, 4, device="cpu", timeout=300.0)


@pytest.mark.parametrize("case", ["c2_csg 64x64", "mesh_soft_ao 250x131"])
def test_spawned_world_frames_equal_unsharded(spawned_world, case):
    """render_frame_sharded over 4 gloo ranks ((1, 4) and (2, 2)): every
    rank holds the whole frame, bitwise equal to the unsharded one."""
    ref = _unsharded_frame(*_frame_case(case, "pallas"))
    for rank, res in enumerate(spawned_world):
        _assert_bitwise([torch.as_tensor(a) for a in res[case]], ref,
                        f"{case} rank {rank}")


def test_spawned_world_sequence_equals_unsharded(spawned_world):
    """render_sequence_sharded on the default mesh of 4 ranks, (2, 2)."""
    scene, cam, st, pose_arrays = _c5_sequence()
    ref = _unsharded_sequence(scene, cam, st.with_(backend="pallas"),
                              pose_arrays)
    for rank, res in enumerate(spawned_world):
        _assert_bitwise([torch.as_tensor(a) for a in res["c5 sequence"]],
                        ref, f"rank {rank}")


def test_spawned_world_ring_equals_one_rank(spawned_world, world1):
    """ring_trace over 4 gloo ranks (three hops by batch_isend_irecv)
    bitwise equal to the ring of one rank, on every rank."""
    from surfjax_torch.parallel.ring_mesh import ring_trace, shard_triangles
    from torch.distributed.device_mesh import init_device_mesh
    tables, (o, d) = _ring_case()
    t1, tri1 = ring_trace(shard_triangles(tables, 1), o, d, 1e-3, 1e4,
                          init_device_mesh("cpu", (1,),
                                           mesh_dim_names=("shard",)))
    for rank, res in enumerate(spawned_world):
        np.testing.assert_array_equal(res["ring"][0], t1.numpy())
        np.testing.assert_array_equal(res["ring"][1], tri1.numpy())


def test_dryrun_multichip_matches_world1(world1):
    """dryrun_multichip(4): the step on the (2, 2) mesh of 4 spawned ranks
    (which checks that every rank holds the same bits) against one rank
    rendering the same 4 frames: the sums run in another order, so within
    1e-6 relative."""
    leaf1, loss1 = dryrun.dryrun_step("cpu", n_frames=4)
    leaf4, loss4 = dryrun.dryrun_multichip(4, device="cpu")
    assert abs(loss4 - loss1) <= 1e-6 * abs(loss1), (loss4, loss1)
    np.testing.assert_allclose(leaf4, leaf1, rtol=1e-6, atol=1e-9)
    assert loss1 > 0.0


def test_world1_frame_through_the_group(world1):
    """render_frame_sharded in a gloo group of one: the default mesh is
    (1, 1) and the frame equals the unsharded one bitwise."""
    scene, cam, st = _frame_case("c2_csg 64x64", "jnp")
    fb = render_frame_sharded(scene, cam, st, device="cpu")
    _assert_bitwise(fb, _unsharded_frame(scene, cam, st), "world 1")


# -- make_mesh, initialize_distributed ---------------------------------------

def test_make_mesh_errors(world1):
    with pytest.raises(ValueError, match=r"n_frame=0 must be in \[1, 1\]"):
        make_mesh(0, device="cpu")
    with pytest.raises(ValueError, match=r"n_frame=2 must be in \[1, 1\]"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not divide the device "
                                         "count 3"):
        make_mesh(2, devices=[0, 0, 0], device="cpu")
    with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) needs 4 "
                                         "devices; have 3"):
        make_mesh(2, 2, devices=[0, 0, 0], device="cpu")
    with pytest.raises(ValueError, match=r"mesh shape \(1, 0\)"):
        make_mesh(1, 0, device="cpu")
    mesh = make_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("frame", "tile")
    assert mesh.get_coordinate() == (0, 0)


def test_initialize_distributed_returns_in_a_group(world1):
    group = dist.group.WORLD
    initialize_distributed("cpu", init_method="file:///nonexistent/store",
                           rank=0, world_size=1)
    assert dist.group.WORLD is group and dist.get_world_size() == 1


def test_cuda_request_without_a_card_raises(world1):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal "
                    "without one")
    scene, cam, st = _frame_case("c2_csg 64x64", "pallas")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_frame_sharded(scene, cam, st)


# -- against surfjax ----------------------------------------------------------

def _sj_pair(name, size, **overrides):
    from tests.test_torch_pipeline import load_pair
    return load_pair(name, size, **overrides)


def test_sharded_frame_matches_surfjax_sharded():
    """c2 at 64x64: the port over 8 simulated ranks against surfjax's
    render_frame_sharded on the 8 virtual CPU devices (jnp backend,
    jitted): hit and obj_id equal, depth 1e-4 x max(1, t), rgb 2e-4,
    normals 5e-4 (JIT_TOL)."""
    from surfjax.parallel import make_mesh as sj_make_mesh
    from surfjax.parallel import render_frame_sharded as sj_rfs
    from tests.test_torch_pipeline import JIT_TOL, assert_tight, gaps
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), _ = \
        _sj_pair("c2_csg", 64)
    ref = sj_rfs(sj_scene, sj_cam, sj_st, sj_make_mesh(1, 8))
    got = _simulated_frame(pt_scene, pt_cam, pt_st, 8)
    assert_tight(gaps(ref, got), n_lanes=64 * 64, **JIT_TOL)


def test_sharded_sequence_matches_surfjax_sharded():
    """c5 at 32x32 x 4 jittered frames, max_steps 32, on a (2, 4) mesh on
    both sides, at JIT_TOL."""
    from surfjax.parallel import make_mesh as sj_make_mesh
    from surfjax.parallel import render_sequence_sharded as sj_rss
    from tests.test_torch_pipeline import JIT_TOL, assert_tight, gaps
    (sj_scene, sj_cam, sj_st), (pt_scene, pt_cam, pt_st), pose_arrays = \
        _sj_pair("c5_anim", 32, n_frames=4, max_steps=32)
    ref = sj_rss(sj_scene, sj_cam, pose_arrays, sj_st, sj_make_mesh(2, 4))
    got = _simulated_sequence(pt_scene, pt_cam, pt_st, pose_arrays, (2, 4))
    assert_tight(gaps(ref, got), n_lanes=4 * 32 * 32, **JIT_TOL)


def _surfjax_step(n_frames):
    """surfjax's train_step of __graft_entry__.py (the loss, its gradient
    and the SGD step), unsharded and jitted, on the dry run's scene, size,
    trace budget and poses -> (updated leaf_params, loss)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from surfjax.core.camera import camera_ray_dirs_dyn, orbit_pose
    from surfjax.pipeline.frame import render_rays as sj_render_rays
    scene, cam, settings = _flagship(dryrun.SIZE)
    settings = settings.with_(max_steps=dryrun.MAX_STEPS)
    static, params = scene.freeze()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    intr = cam.intrinsics
    rows = np.repeat(np.arange(intr.height, dtype=np.float32), intr.width)
    cols = np.tile(np.arange(intr.width, dtype=np.float32), intr.height)
    thetas = jnp.linspace(0.0, 1.0, n_frames)
    Rs, ts = jax.vmap(lambda th: orbit_pose(jnp.float32(4.0),
                                            jnp.float32(1.0), th))(thetas)
    ts = ts + jnp.asarray([0.0, 0.0, 3.0], jnp.float32)
    rest = {k: v for k, v in params.items() if k != "leaf_params"}

    def loss_fn(leaf_params):
        p = dict(rest, leaf_params=leaf_params)

        def frame_rgb(R, t):
            d = camera_ray_dirs_dyn(intr, R, jnp.asarray(rows),
                                    jnp.asarray(cols))
            o = tuple(jnp.broadcast_to(t[k], rows.shape) for k in range(3))
            return sj_render_rays(static, settings, p, o, d).rgb
        rgbs = jax.vmap(frame_rgb)(Rs, ts)
        return jnp.mean(rgbs * rgbs)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params["leaf_params"])
    return (np.asarray(params["leaf_params"] - jnp.float32(dryrun.LR) * g),
            float(loss))


def test_dryrun_step_matches_surfjax_train_step(world1):
    """The port's step (one rank, 4 frames at 16x16, max_steps 8) against
    surfjax's jitted unsharded train_step: loss within 1e-5 relative,
    updated leaf_params within 1e-5."""
    leaf, loss = dryrun.dryrun_step("cpu", n_frames=4)
    sj_leaf, sj_loss = _surfjax_step(4)
    assert abs(loss - sj_loss) <= 1e-5 * abs(sj_loss), (loss, sj_loss)
    np.testing.assert_allclose(leaf, sj_leaf, rtol=0.0, atol=1e-5)
