"""Shared value types: RenderSettings, FrameBuffers, Hit.

`RenderSettings` has the same field names and defaults as
`surfjax.core.types.RenderSettings`, so a settings object built for one
package can be rebuilt for the other with `dataclasses.asdict`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (frozen, hashable).

    backend selects the render path:
      "jnp"    -- the eager tensor pipeline (pipeline/frame.py), the
                  counterpart of surfjax's jax.numpy path;
      "pallas" -- the kernel paths (kernels/render_tile.py): the fused
                  frame for mesh-free scenes, the split pipeline for mesh
                  scenes; the hand-written CUDA kernels for tensors on a
                  CUDA device, their plain PyTorch versions on the CPU.
    The name is kept from surfjax so that settings carry over unchanged.
    """
    # trace
    max_steps: int = 256          # bounded march trip count
    t_min: float = 1e-3
    t_max: float = 1e4
    hit_eps: float = 1e-3         # SDF hit threshold
    over_relax: float = 1.4       # fused-path over-relaxed step (1.0 = off)
    hit_eps_scale: float = 0.0    # cone eps: eps_eff = hit_eps + t*scale
    normal_eps: float = 5e-4      # FD-normal tetrahedron offset
    normals: str = "auto"         # "auto" (analytic where possible) | "fd"
    # secondary rays
    shadow_steps: int = 64        # soft-shadow march trip count
    shadows: bool = True
    soft_shadows: bool = False
    soft_shadow_k: float = 8.0    # SDF penumbra sharpness
    soft_shadow_tmin: float = 0.02
    shadow_eps: float = 1e-3      # offset along normal for secondary origins
    ao: bool = False
    ao_samples: int = 5           # taps of the fixed-direction AO probe
    ao_radius: float = 0.5
    ao_strength: float = 1.0
    # fused path only: soft-shadow marches cap fractal DEs at this many
    # iterations (0 = full); the truncated set only darkens penumbrae
    secondary_lod_iters: int = 4
    # fused path only: AO-probe fractal cap (0 = secondary_lod_iters)
    ao_lod_iters: int = 2
    # kernel paths: the capped-march residual. > 0: K1's SDF marches
    # (march_cap) and K2's shadow marches (shadow_march_cap) first run at
    # most this many steps, then the 128-ray rows with a lane cut off run
    # again at the full budget; the frame equals the uncapped one bitwise,
    # and takes the split path (the fused path takes no caps). 0: off. The
    # eager backend ignores both.
    march_cap: int = 0
    shadow_march_cap: int = 0
    # shading
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    backend: str = "jnp"
    # split path: rows of 128 rays per mesh-candidate tile (a multiple of
    # 8); the fused path ignores it
    tile_rows: int = 64
    # a TPU workaround of surfjax; carried for field parity, unused here
    subtile_rows: int = 0
    # cone-march priming on the kernel paths: a 1/4-resolution pass finds a
    # safe SDF-march start for every 4x4 pixel block; frames smaller than
    # prime_min pixels a side, and scenes with an active crowd, skip it
    prime: bool = False
    prime_min: int = 256
    # Mandelbulb iteration form on the fused path: "cheb" | "std"
    bulb_iter: str = "cheb"
    # Mandelbulb DE epilogue log on the fused path: "hw" (the platform
    # log) | "portable" (core.math.portable_log, bitwise across backends)
    bulb_log: str = "hw"
    # kernel paths: single sphere/box objects and two-leaf SDF pairs form a
    # "crowd" taken by member loops (kernels/render_tile.py) instead of one
    # table-driven object each; geometry is bitwise equal either way, and
    # only objects outside the crowd count against the 64-object limit
    vector_objects: bool = False

    def with_(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


class FrameBuffers(NamedTuple):
    """Per-frame output G-buffer. All (H, W[, C]) float32 tensors (a leading
    frame axis for sequences)."""
    rgb: Any          # (H, W, 3)
    depth: Any        # (H, W)   hit distance t (0.0 on miss)
    normal: Any       # (H, W, 3) zeroed on miss
    hit: Any          # (H, W)   1.0 where a surface was hit
    obj_id: Any       # (H, W)   int32 object index (-1 on miss)


class Hit(NamedTuple):
    """Result of scene intersection for a batch of rays (flat shapes)."""
    t: Any            # (N,) float32, BIG on miss
    obj_id: Any       # (N,) int32, -1 on miss
    leaf_id: Any      # (N,) int32 object-local leaf index
    mask: Any         # (N,) bool
