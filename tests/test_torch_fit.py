"""The port's inverse-rendering fits (diff/fit.py) and fit snapshots
(utils/checkpoint.py): counterparts of tests/test_fit.py with its
assertions, the optimizer against optax update for update, and the first
loss against surfjax's on the same frozen scene.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import surfjax.api as sj_api  # noqa: E402
from surfjax.diff import fit as sj_fit  # noqa: E402

import surfjax_torch.api as pt_api  # noqa: E402
from surfjax_torch.diff import fit as pt_fit  # noqa: E402
from surfjax_torch.kernels import render_tile as pt_rt  # noqa: E402
from surfjax_torch.tools.kernel_check import capture_calls  # noqa: E402
from surfjax_torch.utils.checkpoint import (  # noqa: E402
    load_fit_state, save_fit_state,
)

from tests.test_torch_hybrid import Frozen, port_settings  # noqa: E402

F32 = np.float32
SJ_SETTINGS = sj_api.RenderSettings(shadows=False, max_steps=64, t_max=20.0)
SETTINGS = port_settings(SJ_SETTINGS)
POSE_INIT = (F32([0.05, -0.04, 0.03]), F32([0.05, -0.05, 0.0]))


def _blob_scene(api, radius=0.6):
    scene = api.Scene()
    scene.add(api.smooth_union(api.Sphere((-0.35, -0.1, 3.0), radius),
                               api.Sphere((0.45, 0.1, 3.0), 0.45), 0.3),
              api.Material.lambert(albedo=(0.4, 0.6, 0.8)), engine="sdf")
    scene.add_light(api.PointLight(position=(3.0, 4.0, -1.0)))
    return scene


def _target(scene, cam, settings=SETTINGS):
    return pt_api.render(scene, cam, settings, device="cpu").rgb.numpy()


def test_rodrigues_identity_inverse_and_reference():
    for w in ([0.1, -0.2, 0.05], [1.3, 0.4, -2.0], [1e-4, 0.0, 2e-4]):
        w = np.asarray(w, F32)
        R = pt_fit.rodrigues(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(R, np.asarray(sj_fit.rodrigues(
            jnp.asarray(w))), atol=1e-6)
        Ri = pt_fit.rodrigues(torch.from_numpy(-w)).numpy()
        np.testing.assert_allclose(R.reshape(3, 3) @ Ri.reshape(3, 3),
                                   np.eye(3), atol=1e-6)
    zero = pt_fit.rodrigues(torch.zeros(3))
    np.testing.assert_allclose(zero.numpy(), np.eye(3).reshape(9), atol=1e-7)
    a, b = (np.random.default_rng(4).standard_normal((2, 9))).astype(F32)
    np.testing.assert_allclose(
        pt_fit._matmul9(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(sj_fit._matmul9(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def _adam_float64(grads, state, lr, steps):
    """optax.adam(optax.cosine_decay_schedule(lr, steps)) written out in
    float64, with the constants optax's float32 arithmetic sees: the
    decays b and the corrections 1 - b**t from the float32 betas, the
    gradient weights from 1 - b taken in double and then rounded."""
    b1, b2 = float(F32(0.9)), float(F32(0.999))
    w1, w2 = float(F32(1 - 0.9)), float(F32(1 - 0.999))
    t = state["count"]
    step = lr * 0.5 * (1.0 + np.cos(np.pi * min(t, steps) / steps))
    out = {}
    for k, g in grads.items():
        g = g.astype(np.float64)
        state["mu"][k] = b1 * state["mu"][k] + w1 * g
        state["nu"][k] = b2 * state["nu"][k] + w2 * g * g
        mu_hat = state["mu"][k] / (1 - b1 ** (t + 1))
        nu_hat = state["nu"][k] / (1 - b2 ** (t + 1))
        out[k] = -step * mu_hat / (np.sqrt(nu_hat) + 1e-8)
    state["count"] = t + 1
    return out


def test_optimizer_matches_optax_update_for_update():
    """60 steps of a seeded gradient sequence (magnitudes over six decades)
    through the port's Adam with its cosine step size, through the same
    formulas in float64, and through
    optax.adam(optax.cosine_decay_schedule(lr, steps)).

    Against float64 every update agrees within 1e-6 relative (plus 1e-7
    of lr where the float32 first moment cancels to near zero). Against
    optax the agreement is limited by two float32 cancellations on optax's
    side, each fed by the last bit of an XLA transcendental: the bias
    correction 1 - b2**t (pow; measured gap up to 3.6e-6 of the update
    during the first steps, below 2e-6 from step 6 on) and the schedule's
    1 + cos(pi t / steps) as t nears `steps` (cos; 2.6e-5 of the last
    update, which is 7e-4 of the first in size). So: 8e-6 relative over
    the first five steps and 4e-6 after them, plus 5e-8 of lr absolute for
    the vanishing last steps."""
    steps, lr = 60, 2e-2
    rng = np.random.default_rng(7)
    x0 = {"w": rng.standard_normal(3).astype(F32),
          "lp": rng.standard_normal((2, 8)).astype(F32)}
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    x_j = {k: jnp.asarray(v) for k, v in x0.items()}
    s_j = opt.init(x_j)
    x_t = {k: torch.from_numpy(v.copy()) for k, v in x0.items()}
    s_t = pt_fit.adam_init(x_t)
    s_64 = {"count": 0, "mu": {k: 0.0 for k in x0}, "nu": {k: 0.0 for k in x0}}
    for i in range(steps):
        g = {k: (rng.standard_normal(v.shape)
                 * 10.0 ** rng.uniform(-4, 2)).astype(F32)
             for k, v in x0.items()}
        upd, s_j = opt.update({k: jnp.asarray(v) for k, v in g.items()}, s_j)
        upd_64 = _adam_float64(g, s_64, lr, steps)
        upd_t, s_t = pt_fit.adam_updates(
            {k: torch.from_numpy(v) for k, v in g.items()}, s_t, lr, steps)
        for k in x0:
            np.testing.assert_allclose(upd_t[k].numpy(), upd_64[k],
                                       rtol=1e-6, atol=1e-7 * lr,
                                       err_msg=f"step {i} {k} vs float64")
            np.testing.assert_allclose(upd_t[k].numpy(), np.asarray(upd[k]),
                                       rtol=8e-6 if i < 5 else 4e-6,
                                       atol=5e-8 * lr,
                                       err_msg=f"step {i} {k} vs optax")
        x_j = optax.apply_updates(x_j, upd)
        x_t = {k: x_t[k] + upd_t[k] for k in x0}
    for k in x0:
        np.testing.assert_allclose(x_t[k].numpy(), np.asarray(x_j[k]),
                                   rtol=1e-5, atol=1e-6)
    assert s_t["count"] == steps
    assert pt_fit.cosine_lr(lr, steps, 0) == pytest.approx(lr)
    assert pt_fit.cosine_lr(lr, steps, steps + 5) == pytest.approx(0.0,
                                                                   abs=1e-9)


def test_fit_pose_recovers_perturbation():
    scene = _blob_scene(pt_api)
    cam = pt_api.Camera.pinhole(48, 48, fov_y_deg=45.0)
    target = _target(scene, cam)
    R, t, losses = pt_fit.fit_pose(scene, cam, target, steps=120, lr=3e-2,
                                   settings=SETTINGS, init=POSE_INIT,
                                   device="cpu")
    assert len(losses) == 120
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    np.testing.assert_allclose(R.reshape(3, 3), np.eye(3), atol=0.05)
    np.testing.assert_allclose(t, np.zeros(3), atol=0.08)


def test_fit_sdf_recovers_radius():
    cam = pt_api.Camera.pinhole(48, 48, fov_y_deg=45.0)
    target = _target(_blob_scene(pt_api), cam)
    wrong = _blob_scene(pt_api, radius=0.45)
    mask = np.zeros((2, 8), F32)
    mask[0, 3] = 1.0        # only the first sphere's radius is free
    lp, losses = pt_fit.fit_sdf(wrong, cam, target, steps=120, lr=5e-3,
                                settings=SETTINGS, param_mask=mask,
                                device="cpu")
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    assert abs(lp[0, 3] - 0.6) < 0.02, lp[0, 3]
    true_lp = wrong.freeze()[1]["leaf_params"]
    np.testing.assert_array_equal(lp * (1 - mask), true_lp * (1 - mask))


def test_first_loss_matches_reference_fit():
    """The same frozen scene, target and start through both packages'
    fit_pose: the first loss (the loss at the start pose) agrees within
    2e-3 relative."""
    scene = _blob_scene(sj_api)
    cam = sj_api.Camera.pinhole(48, 48, fov_y_deg=45.0)
    target = _target(Frozen(scene), cam)
    _, _, want = sj_fit.fit_pose(scene, cam, target, steps=1, lr=3e-2,
                                 settings=SJ_SETTINGS, init=POSE_INIT)
    _, _, got = pt_fit.fit_pose(Frozen(scene), cam, target, steps=1, lr=3e-2,
                                settings=SETTINGS, init=POSE_INIT,
                                device="cpu")
    assert abs(got[0] - want[0]) / want[0] < 2e-3, (got, want)
    assert got[0] > 1e-4


def test_checkpoint_resume_gives_the_same_losses(tmp_path):
    """A fit stopped after 4 of 8 steps and resumed from its snapshot
    continues with the losses of the uninterrupted fit; the snapshot holds
    the step, the parameters and the optimizer state as numpy arrays."""
    scene = _blob_scene(pt_api)
    cam = pt_api.Camera.pinhole(24, 24, fov_y_deg=45.0)
    target = _target(scene, cam)
    kw = dict(steps=8, lr=3e-2, settings=SETTINGS, init=POSE_INIT,
              device="cpu")
    R_full, t_full, full = pt_fit.fit_pose(scene, cam, target, **kw)
    path = str(tmp_path / "fit" / "state.npz")

    class Stop(Exception):
        pass

    saved = []

    def save_then_stop(p, step, x, state):
        save_fit_state(p, step, x, state)
        saved.append(step)
        raise Stop

    import surfjax_torch.utils.checkpoint as ckpt
    orig = ckpt.save_fit_state
    ckpt.save_fit_state = save_then_stop
    try:
        with pytest.raises(Stop):
            pt_fit.fit_pose(scene, cam, target, checkpoint_path=path,
                            checkpoint_every=4, **kw)
    finally:
        ckpt.save_fit_state = orig
    assert saved == [4]
    with np.load(path) as z:
        assert int(z["__step__"]) == 4
        assert sorted(z.files) == sorted(
            ["__step__", "p0", "p1"] + [f"o{i}" for i in range(5)])
    R_res, t_res, rest = pt_fit.fit_pose(scene, cam, target,
                                         checkpoint_path=path,
                                         checkpoint_every=100, **kw)
    assert rest == full[4:] and len(rest) == kw["steps"] - 4
    np.testing.assert_array_equal(R_res, R_full)
    np.testing.assert_array_equal(t_res, t_full)
    x = {"w": torch.zeros(3), "dt": torch.zeros(3)}
    step, x2 = load_fit_state(path, x)
    assert step == 4 and set(x2) == {"w", "dt"}
    assert x2["w"].dtype == torch.float32 and bool(x2["w"].any())


def test_snapshot_is_replaced_whole_or_not_at_all(tmp_path, monkeypatch):
    """A save that dies while it writes leaves the earlier snapshot as it
    was, loadable, and no partial file beside it; a save that succeeds
    replaces it."""
    path = str(tmp_path / "state.npz")
    x = {"w": torch.arange(3, dtype=torch.float32)}
    save_fit_state(path, 1, x)
    real_savez = np.savez

    def dies_half_way(fh, **arrays):
        fh.write(b"PK half a file")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", dies_half_way)
    with pytest.raises(OSError, match="disk full"):
        save_fit_state(path, 2, {"w": x["w"] + 1.0})
    monkeypatch.setattr(np, "savez", real_savez)
    assert os.listdir(tmp_path) == ["state.npz"]
    step, got = load_fit_state(path, x)
    assert step == 1 and torch.equal(got["w"], x["w"])
    save_fit_state(path, 2, {"w": x["w"] + 1.0})
    step, got = load_fit_state(path, x)
    assert step == 2 and torch.equal(got["w"], x["w"] + 1.0)
    assert os.listdir(tmp_path) == ["state.npz"]


def test_fit_sdf_moves_the_parameters_the_kernel_path_reads():
    """With backend pallas every step's K1 call gets that step's leaf
    parameters (the float tables are read per call, only the int tables
    are cached), so its forward changes from step to step."""
    cam = pt_api.Camera.pinhole(24, 24, fov_y_deg=45.0)
    st = SETTINGS.with_(backend="pallas", tile_rows=8)
    target = _target(_blob_scene(pt_api), cam, st)
    wrong = _blob_scene(pt_api, radius=0.45)
    mask = np.zeros((2, 8), F32)
    mask[0, 3] = 1.0
    with capture_calls() as calls:
        lp, losses = pt_fit.fit_sdf(wrong, cam, target, steps=3, lr=2e-2,
                                    settings=st, param_mask=mask,
                                    device="cpu")
    k1 = [args for name, args in calls if name == "render_tile"]
    assert len(k1) == 3 and not [n for n, _ in calls if n == "trace_rays"]
    radii = [float(args[0].params["leaf_params"][0, 3]) for args in k1]
    assert radii[0] == pytest.approx(0.45) and radii[0] < radii[1] < radii[2]
    assert not k1[1][0].params["leaf_params"].requires_grad
    t_of = [pt_rt.render_tile_reference(*args)[0] for args in k1[:2]]
    assert not torch.equal(t_of[0], t_of[1])
    assert losses[2] < losses[0] and lp[0, 3] > 0.45


def test_fit_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = _blob_scene(pt_api)
    cam = pt_api.Camera.pinhole(8, 8, fov_y_deg=45.0)
    target = np.zeros((8, 8, 3), F32)
    for call in (lambda: pt_fit.fit_pose(scene, cam, target, steps=1),
                 lambda: pt_fit.fit_sdf(scene, cam, target, steps=1),
                 lambda: pt_fit.pose_loss_and_grad(scene, cam, SETTINGS),
                 lambda: pt_fit.pose_probe_hit(scene, cam, SETTINGS)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    hit = pt_fit.pose_probe_hit(scene, cam, SETTINGS, device="cpu")
    assert hit.shape == (8, 8) and hit.dtype == bool and hit.any()
