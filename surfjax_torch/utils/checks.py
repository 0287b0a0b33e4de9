"""Numeric sanitizers (SURVEY.md §5.2), the counterpart of
`surfjax/utils/checks.py`: a NaN/Inf tap on every op for test and debug
runs (`checked`, in place of checkify's float checks), and a framebuffer
validator for production sanity (`validate_framebuffers`)."""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NonFiniteError(FloatingPointError):
    """An op's floating output held NaN or Inf."""


class _FiniteTap(TorchDispatchMode):
    """Raises at the first op whose floating output holds NaN or Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                    not bool(torch.isfinite(t).all()):
                n_nan = int(torch.isnan(t).sum())
                raise NonFiniteError(
                    f"{func} produced {n_nan} NaN and "
                    f"{int(torch.isinf(t).sum())} Inf values "
                    f"(shape {tuple(t.shape)}, {t.device})")
        return out


def checked(fn):
    """fn wrapped so that it runs under a tap on every tensor op and raises
    NonFiniteError, naming the op, at the first op whose floating output
    holds NaN or Inf. Each op's check reads its output back to the host,
    so this is a debug tool, not a production path.

        checked(lambda x: torch.log(x) / x)(x)
    """
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _FiniteTap():
            return fn(*args, **kwargs)
    return run


def validate_framebuffers(fb) -> dict:
    """A FrameBuffers' sanity report (its tensors on any device): counts
    of NaN, Inf and negative rgb values and of NaN depths, the hit
    fraction, and ok (no NaN or Inf in rgb, no NaN depth)."""
    rgb, depth = fb.rgb, fb.depth
    report = {
        "rgb_nan": int(torch.isnan(rgb).sum()),
        "rgb_inf": int(torch.isinf(rgb).sum()),
        "rgb_negative": int((rgb < 0).sum()),
        "depth_nan": int(torch.isnan(depth).sum()),
        "hit_frac": float(fb.hit.float().mean()),
    }
    report["ok"] = (report["rgb_nan"] == 0 and report["rgb_inf"] == 0
                    and report["depth_nan"] == 0)
    return report
