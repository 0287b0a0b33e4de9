"""Camera models: pinhole intrinsics + rigid pose + animated paths.

Counterpart of `surfjax/core/camera.py`, with the same conventions:
  * camera space: +x right, +y down, +z forward (image plane at z=1);
  * pixel (i=row, j=col): xc = (j + 0.5 - cx) / fx, yc = (i + 0.5 - cy) / fy;
  * pose: world_from_cam rotation R (row-major) and camera origin t;
  * rays: origin = t, dir = normalize(R @ (xc, yc, 1)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from surfjax_torch.core.math import f32, fdiv, sqrt, vnormalize

Mat3 = Tuple[Tuple[float, float, float],
             Tuple[float, float, float],
             Tuple[float, float, float]]

IDENTITY3: Mat3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_fov(width: int, height: int, fov_y_deg: float) -> "Intrinsics":
        f = 0.5 * height / math.tan(math.radians(fov_y_deg) * 0.5)
        return Intrinsics(width, height, fx=f, fy=f,
                          cx=0.5 * width, cy=0.5 * height)


def look_at(eye, target, up=(0.0, 1.0, 0.0)
            ) -> Tuple[Mat3, Tuple[float, float, float]]:
    """world_from_cam pose for a camera at `eye` looking at `target`
    (host-side Python floats; the world 'up' maps to camera -y)."""
    fz = [target[i] - eye[i] for i in range(3)]
    n = math.sqrt(fz[0] * fz[0] + fz[1] * fz[1] + fz[2] * fz[2])
    if n < 1e-12:
        raise ValueError("look_at: eye and target coincide")
    fz = [v / n for v in fz]
    rx = [fz[1] * up[2] - fz[2] * up[1],
          fz[2] * up[0] - fz[0] * up[2],
          fz[0] * up[1] - fz[1] * up[0]]
    n = math.sqrt(rx[0] * rx[0] + rx[1] * rx[1] + rx[2] * rx[2])
    if n < 1e-8:
        # view direction parallel to up: fall back to a perpendicular up
        up = (0.0, 0.0, 1.0) if abs(fz[2]) < 0.9 else (1.0, 0.0, 0.0)
        rx = [fz[1] * up[2] - fz[2] * up[1],
              fz[2] * up[0] - fz[0] * up[2],
              fz[0] * up[1] - fz[1] * up[0]]
        n = math.sqrt(rx[0] * rx[0] + rx[1] * rx[1] + rx[2] * rx[2])
    rx = [v / n for v in rx]
    dy = [fz[1] * rx[2] - fz[2] * rx[1],
          fz[2] * rx[0] - fz[0] * rx[2],
          fz[0] * rx[1] - fz[1] * rx[0]]
    R: Mat3 = ((rx[0], dy[0], fz[0]),
               (rx[1], dy[1], fz[1]),
               (rx[2], dy[2], fz[2]))
    return R, (float(eye[0]), float(eye[1]), float(eye[2]))


def camera_ray_dirs_dyn(intr: Intrinsics, R_flat, rows, cols):
    """Normalized world-space ray directions for pixel centres.

    R_flat: (9,) float32 tensor, row-major world_from_cam rotation, or
    per_frame(R_flats, rows.dim()) for F frames at once (a leading frame
    axis on the result); rows/cols: float32 tensors of pixel row/col
    indices (any shape)."""
    i = rows.to(torch.float32)
    j = cols.to(torch.float32)
    xc = fdiv(j + 0.5 - f32(intr.cx), intr.fx)
    yc = fdiv(i + 0.5 - f32(intr.cy), intr.fy)
    dx = (R_flat[0] * xc + R_flat[1] * yc) + R_flat[2]
    dy = (R_flat[3] * xc + R_flat[4] * yc) + R_flat[5]
    dz = (R_flat[6] * xc + R_flat[7] * yc) + R_flat[8]
    return vnormalize((dx, dy, dz))


def per_frame(rows, ndim: int):
    """(F, k) rows of F frames (rotations, positions) -> (k, F, 1, ...,
    1) with ndim trailing ones: entry j broadcasts against a frame's
    ndim-dimensional pixel arrays, so camera_ray_dirs_dyn takes it as its
    R_flat and gives every frame's rays at once, each the number the
    frame's own (9,) rotation gives."""
    return rows.T.reshape(rows.shape[1], rows.shape[0], *([1] * ndim))


def flat_camera_rays(intr: Intrinsics, R_flat, cam_pos, pad_to: int = 1):
    """Flat (row-major) per-pixel rays of a pose given as tensors: the one
    definition of the pixel grid the fit loop renders. pad_to > 1 pads the
    ray count to a multiple by repeating the last pixel. R_flat (9,) and
    cam_pos (3,) give rays of shape (n_pad,); R_flat (F, 9) and cam_pos
    (F, 3), F frames' rays of shape (F, n_pad).
    -> (o tuple, d tuple, number of real pixels)."""
    n = intr.width * intr.height
    n_pad = ((n + pad_to - 1) // pad_to) * pad_to
    dev = R_flat.device
    rows = torch.arange(intr.height, dtype=torch.float32,
                        device=dev).repeat_interleave(intr.width)
    cols = torch.arange(intr.width, dtype=torch.float32,
                        device=dev).repeat(intr.height)
    if n_pad > n:
        rows = torch.cat([rows, rows[-1:].expand(n_pad - n)])
        cols = torch.cat([cols, cols[-1:].expand(n_pad - n)])
    if R_flat.dim() == 2:
        R_flat, cam_pos = per_frame(R_flat, 1), per_frame(cam_pos, 1)
    d = camera_ray_dirs_dyn(intr, R_flat, rows, cols)
    o = tuple(cam_pos[k].expand(d[0].shape) for k in range(3))
    return o, d, n


def orbit_pose(radius, height, theta):
    """Camera orbiting the origin at (radius, height), looking at the
    origin. Tensor inputs (0-d float32) -> (R_flat (9,), eye (3,))."""
    eye = torch.stack([radius * torch.sin(theta), height,
                       -radius * torch.cos(theta)])
    fz = -eye
    inv = 1.0 / sqrt((fz[0] * fz[0] + fz[1] * fz[1]) + fz[2] * fz[2])
    fz = fz * inv
    upw = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                       device=eye.device)
    rx = torch.stack([fz[1] * upw[2] - fz[2] * upw[1],
                      fz[2] * upw[0] - fz[0] * upw[2],
                      fz[0] * upw[1] - fz[1] * upw[0]])
    inv = 1.0 / sqrt((rx[0] * rx[0] + rx[1] * rx[1]) + rx[2] * rx[2])
    rx = rx * inv
    dy = torch.stack([fz[1] * rx[2] - fz[2] * rx[1],
                      fz[2] * rx[0] - fz[0] * rx[2],
                      fz[0] * rx[1] - fz[1] * rx[0]])
    R_flat = torch.stack([rx[0], dy[0], fz[0],
                          rx[1], dy[1], fz[1],
                          rx[2], dy[2], fz[2]])
    return R_flat, eye


def pose_interp(p0, p1, t):
    """Linear pose interpolation: the translation lerped, the rotation
    lerped and its columns re-orthonormalized (Gram-Schmidt on the first
    two, the third their cross product). p = (R_flat (9,), trans (3,)) as
    float32 tensors, t a float or 0-d tensor -> the pose at t."""
    R0, t0 = p0
    R1, t1 = p1
    R = R0 + (R1 - R0) * t
    c0 = torch.stack([R[0], R[3], R[6]])
    c1 = torch.stack([R[1], R[4], R[7]])
    c0 = c0 / sqrt(torch.sum(c0 * c0))
    c1 = c1 - c0 * torch.sum(c0 * c1)
    c1 = c1 / sqrt(torch.sum(c1 * c1))
    c2 = torch.stack([c0[1] * c1[2] - c0[2] * c1[1],
                      c0[2] * c1[0] - c0[0] * c1[2],
                      c0[0] * c1[1] - c0[1] * c1[0]])
    Rn = torch.stack([c0[0], c1[0], c2[0],
                      c0[1], c1[1], c2[1],
                      c0[2], c1[2], c2[2]])
    return Rn, t0 + (t1 - t0) * t
