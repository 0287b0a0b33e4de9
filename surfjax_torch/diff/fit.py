"""Inverse rendering: pose and SDF-parameter fitting (counterpart of
`surfjax/diff/fit.py`).

The forward model is the ordinary frame pipeline. With backend="jnp" the
gradient flows through the eager pipeline (the march through
engines/sdf.sphere_trace's IFT adjoint, the rest by autograd); with
backend="pallas" the forward runs in the kernels and the gradient is
rebuilt around them (diff/hybrid.py). The optimizer is this module's own
Adam with a cosine-decayed step size, which repeats
`optax.adam(optax.cosine_decay_schedule(lr, steps))` update for update.

The entry points run on the CUDA device unless the caller passes
device="cpu"; without a card a CUDA request raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from surfjax_torch.core.camera import flat_camera_rays
from surfjax_torch.core.math import f32
from surfjax_torch.core.scene_compile import params_to_device
from surfjax_torch.core.types import RenderSettings
from surfjax_torch.pipeline.frame import (
    _as_f32, _check_device, _pose_tensors, render_rays,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def rodrigues(w):
    """Rotation matrix (9,) row-major from an axis-angle 3-vector:
    R = I + sin(t) K + (1 - cos(t)) K^2, t = |w|, K = skew(w / t); the
    identity below t = 1e-8."""
    t2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]
    t = torch.sqrt(t2 + f32(1e-20))
    safe = t > f32(1e-8)
    kx, ky, kz = w[0] / t, w[1] / t, w[2] / t
    s = torch.sin(t)
    c = torch.cos(t)
    one_c = 1.0 - c
    R = torch.stack([
        c + kx * kx * one_c, kx * ky * one_c - kz * s,
        kx * kz * one_c + ky * s,
        ky * kx * one_c + kz * s, c + ky * ky * one_c,
        ky * kz * one_c - kx * s,
        kz * kx * one_c - ky * s, kz * ky * one_c + kx * s,
        c + kz * kz * one_c,
    ])
    eye = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0, 1], dtype=torch.float32,
                       device=w.device)
    return torch.where(safe, R, eye)


def _matmul9(a, b):
    """(9,) row-major 3x3 product a @ b, written out in float32 (each entry
    (a0 b0 + a1 b1) + a2 b2): no reduced-precision matrix unit can touch a
    fitted pose's camera rays."""
    return torch.stack([
        (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3)])


def _frame_rgb(static, intr, settings: RenderSettings, params, R_flat,
               cam_pos):
    o, d, _ = flat_camera_rays(intr, R_flat, cam_pos)
    if settings.backend == "pallas":
        from surfjax_torch.diff.hybrid import render_rays_hybrid
        fb = render_rays_hybrid(static, settings, params, o, d)
    else:
        fb = render_rays(static, settings, params, o, d)
    return fb.rgb.reshape(intr.height, intr.width, 3)


# --- the optimizer ----------------------------------------------------------

def adam_init(x: dict) -> dict:
    """Adam's state for the parameter dict x: step count and the two
    moment estimates."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in x.items()},
            "nu": {k: torch.zeros_like(v) for k, v in x.items()}}


def cosine_lr(lr: float, steps: int, count: int) -> float:
    """lr * 0.5 * (1 + cos(pi * t / steps)), t = min(count, steps): the
    step size of the update that follows `count` earlier ones."""
    t = min(count, steps)
    return f32(lr * 0.5 * (1.0 + math.cos(math.pi * t / steps)))


def adam_updates(grads: dict, state: dict, lr: float, steps: int):
    """One Adam step with the cosine-decayed step size -> (updates to add
    to the parameters, new state): b1 0.9, b2 0.999, eps 1e-8 added outside
    the root, both moments bias-corrected, as optax.adam applies them.
    optax holds b1 and b2 in float32 (its 1 - 0.999 is 1.3e-5 off), so
    the corrections 1 - b**count are formed from the float32 betas here
    too; what then remains between the two is the last bit of XLA's
    float32 pow, which the cancellation in 1 - b2**count magnifies."""
    count = state["count"] + 1
    c1 = f32(1.0 - f32(ADAM_B1) ** count)
    c2 = f32(1.0 - f32(ADAM_B2) ** count)
    step = cosine_lr(lr, steps, state["count"])
    mu, nu, upd = {}, {}, {}
    for k, g in grads.items():
        mu[k] = f32(ADAM_B1) * state["mu"][k] + f32(1.0 - ADAM_B1) * g
        nu[k] = f32(ADAM_B2) * state["nu"][k] + f32(1.0 - ADAM_B2) * (g * g)
        upd[k] = (-step) * ((mu[k] / c1)
                            / (torch.sqrt(nu[k] / c2) + f32(ADAM_EPS)))
    return upd, {"count": count, "mu": mu, "nu": nu}


def _run_fit(loss_fn, x: dict, steps: int, lr: float, checkpoint_path,
             checkpoint_every: int, verbose_every: int, label: str):
    """The step loop both fits share -> (x, losses): loss and gradient at
    x, one Adam update, the loss read back (the only host round trip of a
    step beside those inside the render). A fit that finds a snapshot at
    `checkpoint_path` resumes at the snapshot's step `start`: `losses` then
    holds the losses of steps start..steps-1 only (steps - start of them,
    none when the snapshot is of a finished fit), as in surfjax; the
    earlier ones are not stored."""
    from surfjax_torch.utils.checkpoint import load_fit_state, save_fit_state
    state = adam_init(x)
    start = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        start, x, state = load_fit_state(checkpoint_path, x, state)
    losses = []
    for i in range(start, steps):
        x, state, loss = fit_step(loss_fn, x, state, lr, steps)
        losses.append(float(loss))
        if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
            save_fit_state(checkpoint_path, i + 1, x, state)
        if verbose_every and i % verbose_every == 0:
            print(f"{label} step {i}: loss {losses[-1]:.6g}")
    return x, losses


def fit_step(loss_fn, x: dict, state: dict, lr: float, steps: int):
    """One optimization step -> (x, state, loss tensor); nothing is read
    back to the host here."""
    x = {k: v.detach().requires_grad_(True) for k, v in x.items()}
    loss = loss_fn(x)
    keys = list(x)
    grads = torch.autograd.grad(loss, [x[k] for k in keys],
                                allow_unused=True)
    grads = {k: torch.zeros_like(x[k]) if g is None else g
             for k, g in zip(keys, grads)}
    with torch.no_grad():
        upd, state = adam_updates(grads, state, lr, steps)
        x = {k: v.detach() + upd[k] for k, v in x.items()}
    return x, state, loss.detach()


def _setup(scene, camera, device):
    device = _check_device(device)
    static, params = scene.freeze()
    params = params_to_device(params, device)
    R0, t0 = _pose_tensors(camera, device)
    return device, static, params, camera.intrinsics, R0, t0


def pose_loss_fn(static, intr, settings: RenderSettings, params, R0, t0,
                 target, pixel_weight=None):
    """-> loss_fn(x) of a pose x = {"w": axis-angle delta applied to R0,
    "dt": position delta}: the mean squared rgb error against `target`
    (weighted per pixel if pixel_weight (H, W) is given)."""
    if pixel_weight is not None:
        denom = 3.0 * torch.clamp(pixel_weight.sum(), min=1.0)

    def loss_fn(x):
        R = _matmul9(rodrigues(x["w"]), R0)
        rgb = _frame_rgb(static, intr, settings, params, R, t0 + x["dt"])
        diff = rgb - target
        if pixel_weight is None:
            return (diff * diff).mean()
        return ((diff * diff) * pixel_weight[..., None]).sum() / denom
    return loss_fn


def fit_pose(scene, camera, target_rgb, steps: int = 100, lr: float = 2e-2,
             settings: RenderSettings = RenderSettings(),
             init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 50, verbose: bool = False,
             device="cuda"):
    """Recover the camera pose that produced `target_rgb`: optimizes an
    axis-angle delta rotation w (applied to the camera's rotation) and a
    position delta, from `init` = (w, dt) or zero.
    -> (R_flat (9,), position (3,), list of losses), numpy; resumed from
    a snapshot at `checkpoint_path`, the losses of the steps run now."""
    device, static, params, intr, R0, t0 = _setup(scene, camera, device)
    target = _as_f32(target_rgb, device)
    x = {"w": torch.zeros(3, device=device),
         "dt": torch.zeros(3, device=device)}
    if init is not None:
        x = {"w": _as_f32(init[0], device), "dt": _as_f32(init[1], device)}
    loss_fn = pose_loss_fn(static, intr, settings, params, R0, t0, target)
    x, losses = _run_fit(loss_fn, x, steps, lr, checkpoint_path,
                         checkpoint_every, 10 if verbose else 0, "fit_pose")
    with torch.no_grad():
        R = _matmul9(rodrigues(x["w"]), R0)
        pos = t0 + x["dt"]
    return R.cpu().numpy(), pos.cpu().numpy(), losses


_PROBE_W = (0.02, -0.01, 0.015)
_PROBE_DT = (0.01, -0.02, 0.005)


def pose_loss_and_grad(scene, camera, settings: RenderSettings,
                       w=_PROBE_W, dt=_PROBE_DT, target_value: float = 0.5,
                       pixel_weight=None, device="cuda"):
    """One evaluation of the pose-fit loss and its gradient at a fixed,
    nonzero probe pose against a constant target image (so that two
    backends or devices can be held against each other).
    -> (loss, {"w", "dt"} gradients as numpy)."""
    device, static, params, intr, R0, t0 = _setup(scene, camera, device)
    target = torch.full((intr.height, intr.width, 3), f32(target_value),
                        device=device)
    pw = None if pixel_weight is None else _as_f32(pixel_weight, device)
    loss_fn = pose_loss_fn(static, intr, settings, params, R0, t0, target, pw)
    x = {"w": _as_f32(w, device).requires_grad_(True),
         "dt": _as_f32(dt, device).requires_grad_(True)}
    loss = loss_fn(x)
    g_w, g_dt = torch.autograd.grad(loss, [x["w"], x["dt"]])
    return (float(loss.detach()),
            {"w": g_w.cpu().numpy(), "dt": g_dt.cpu().numpy()})


@torch.no_grad()
def pose_probe_hit(scene, camera, settings: RenderSettings, w=_PROBE_W,
                   dt=_PROBE_DT, device="cuda"):
    """(H, W) bool hit mask at the probe pose of pose_loss_and_grad."""
    device, static, params, intr, R0, t0 = _setup(scene, camera, device)
    R = _matmul9(rodrigues(_as_f32(w, device)), R0)
    o, d, _ = flat_camera_rays(intr, R, t0 + _as_f32(dt, device))
    if settings.backend == "pallas":
        from surfjax_torch.diff.hybrid import render_rays_hybrid
        fb = render_rays_hybrid(static, settings, params, o, d)
    else:
        fb = render_rays(static, settings, params, o, d)
    return (fb.hit.reshape(intr.height, intr.width) > 0.5).cpu().numpy()


def fit_sdf(scene, camera, target_rgb, steps: int = 200, lr: float = 1e-2,
            settings: RenderSettings = RenderSettings(),
            param_mask: Optional[np.ndarray] = None,
            init_leaf_params: Optional[np.ndarray] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 50, verbose: bool = False,
            device="cuda"):
    """Recover the SDF leaf parameters that produced `target_rgb`:
    optimizes params["leaf_params"] (only where param_mask is 1, if given)
    from init_leaf_params (else the scene's own).
    -> (fitted leaf_params, list of losses), numpy; resumed from a
    snapshot at `checkpoint_path`, the losses of the steps run now."""
    device, static, params, intr, R0, t0 = _setup(scene, camera, device)
    if init_leaf_params is not None:
        params["leaf_params"] = _as_f32(init_leaf_params, device)
    target = _as_f32(target_rgb, device)
    lp0 = params["leaf_params"]
    mask = (_as_f32(param_mask, device) if param_mask is not None
            else torch.ones_like(lp0))

    def loss_fn(x):
        p = dict(params, leaf_params=lp0 + (x["lp"] - lp0) * mask)
        rgb = _frame_rgb(static, intr, settings, p, R0, t0)
        diff = rgb - target
        return (diff * diff).mean()

    x, losses = _run_fit(loss_fn, {"lp": lp0}, steps, lr, checkpoint_path,
                         checkpoint_every, 20 if verbose else 0, "fit_sdf")
    lp = lp0 + (x["lp"] - lp0) * mask
    return lp.cpu().numpy(), losses
