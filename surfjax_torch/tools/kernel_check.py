"""Hold the split path's kernels and the priming kernel against their
plain versions.

`capture_calls` records the arguments of every call a frame makes to one
of their wrappers (render_tile, trace_rays, ao_fix, mesh_candidates,
mesh_tile, prime_tile, and the residual re-runs render_tile_redo and trace_rays_redo, recorded
with their outputs as they were before the re-run) while it renders;
`compare` runs one recorded call through the wrapper (the CUDA kernel, for
CUDA tensors) and through the plain version on the same inputs, and holds
them bitwise; `KERNELS` also gives each kernel's launcher, which prepares
a launch once for timing; `masks_of` gives a K1, K2 or ao_fix call on a
crowd the member masks its crowd kernel votes, for the plain version's
`masks=`.
`chip_smoke.py` and the CUDA tests use them.
"""

from __future__ import annotations

import contextlib

import torch

from surfjax_torch import kernels
from surfjax_torch.kernels import mesh_tile as mt
from surfjax_torch.kernels import render_tile as rt


def _split(entry: str, n_out: int):
    def launcher(scene_t, settings, *rays):
        return rt.split_launcher(entry, scene_t, settings, rays, n_out)
    return launcher


def _redo(entry: str, n_out: int):
    def launcher(scene_t, settings, outs, redo, *rays):
        return rt.split_launcher(entry, scene_t, settings, rays, n_out,
                                 tuple(outs), redo)
    return launcher


# wrapper name -> (wrapper, plain version, output names, launcher: the
# wrapper's arguments -> (launch, outputs) of a prepared kernel, for
# timing back-to-back launches)
K1_OUT = ("t", "obj", "nx", "ny", "nz", "ao", "hit", "unres")
K2_OUT = ("vis", "unres")
KERNELS = {
    "render_tile": (rt.render_tile, rt.render_tile_reference, K1_OUT,
                    _split("sp_render_tile", 8)),
    "render_tile_redo": (rt.render_tile_redo, rt.render_tile_redo_reference,
                         K1_OUT, _redo("sp_render_tile", 8)),
    "trace_rays": (rt.trace_rays, rt.trace_rays_reference, K2_OUT,
                   _split("sp_trace_rays", 2)),
    "trace_rays_redo": (rt.trace_rays_redo, rt.trace_rays_redo_reference,
                        K2_OUT, _redo("sp_trace_rays", 2)),
    "ao_fix": (rt.ao_fix, rt.ao_fix_reference, ("ao",),
               _split("sp_ao_fix", 1)),
    "mesh_tile": (mt.mesh_tile, mt.mesh_tile_reference,
                  ("t", "nsx", "nsy", "nsz", "ngx", "ngy", "ngz"),
                  mt.mesh_tile_launcher),
    "mesh_candidates": (mt.mesh_candidates, mt.mesh_candidates_reference,
                        ("cand", "counts"), mt.mesh_candidates_launcher),
    "prime_tile": (rt.prime_tile, rt.prime_tile_reference, ("t0",),
                   rt.prime_launcher),
}


@contextlib.contextmanager
def capture_calls():
    """-> a list that collects (wrapper name, args) of every split-path
    kernel call made inside the block; the calls themselves run as
    usual."""
    calls = []
    kernels.RECORDED_CALLS = calls
    try:
        yield calls
    finally:
        kernels.RECORDED_CALLS = None


def fresh(name: str, args):
    """A recorded call's arguments, with a copy of the outputs that a
    residual re-run writes over, so that the call can run again."""
    if name.endswith("_redo"):
        return args[:2] + (tuple(o.clone() for o in args[2]),) + args[3:]
    return args


def flat(out):
    """A wrapper's or plain version's result -> a flat list of tensors (an
    output the kernel did not write, None, left out: K1's and K2's unres
    without a cap, the last output)."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def compare(name: str, args, label: str):
    """Run one recorded call through the wrapper and the plain version ->
    (largest abs difference over the outputs, wrapper outputs, plain
    outputs). Raises AssertionError naming the first output that is not
    bitwise equal; the outputs are the wrapper's (without a cap K1 and K2
    write no unres, which the plain version computes all the same)."""
    wrapper, reference, names, _ = KERNELS[name]
    got = flat(wrapper(*fresh(name, args)))
    ref = flat(reference(*fresh(name, args)))[:len(got)]
    errs = [float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            for a, b in zip(got, ref)]
    for out_name, a, b, err in zip(names, got, ref, errs):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs from its plain "
                                 f"version in {out_name} (max abs diff "
                                 f"{err})")
    return max(errs), got, ref


def masks_of(name: str, args):
    """The member masks each warp of the crowd kernel votes for a recorded
    K1 ("render_tile"), K2 ("trace_rays") or ao_fix ("ao_fix") call on a
    scene with a crowd (render_tile.split_warp_masks): the plain version
    called with `masks=` them visits only those members, as the kernel
    does."""
    scene_t, settings = args[:2]
    if name == "render_tile":
        return rt.split_warp_masks(scene_t, settings, *args[2:]).k1
    if name == "trace_rays":
        return rt.split_warp_masks(scene_t, settings, None, None,
                                   shadow_rays=(args[2:],)).k2[0]
    if name == "ao_fix":
        return rt.split_warp_masks(scene_t, settings, None, None,
                                   ao_fix=(args[2], args[4])).ao_fix
    raise ValueError(f"no member masks for {name}")
