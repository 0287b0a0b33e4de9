"""Differentiable rendering: the pose and SDF-parameter fits and the
kernel-forward hybrid render (counterpart of `surfjax/diff/`). The hard
part, the gradient through the raymarcher, is the implicit-function-theorem
adjoint of `sphere_trace` in engines/sdf.py."""

from surfjax_torch.diff.fit import (
    fit_pose, fit_sdf, pose_loss_and_grad, pose_probe_hit, rodrigues,
)
from surfjax_torch.diff.hybrid import render_rays_hybrid

__all__ = ["fit_pose", "fit_sdf", "pose_loss_and_grad", "pose_probe_hit",
           "render_rays_hybrid", "rodrigues"]
