"""Hold the split path's kernels and the priming kernel against their
plain versions.

`capture_calls` records the arguments of every call a frame makes to one
of their wrappers (render_tile, trace_rays, ao_fix, mesh_tile, prime_tile)
while it renders; `compare` runs one recorded call through the wrapper (the
CUDA kernel, for CUDA tensors) and through the plain version on the same
inputs, and holds them bitwise; `KERNELS` also gives each kernel's
launcher, which prepares a launch once for timing. `chip_smoke.py` and
the CUDA tests use them.
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


# wrapper name -> (wrapper, plain version, output names, launcher: the
# wrapper's arguments -> (launch, outputs) of a prepared kernel, for
# timing back-to-back launches)
KERNELS = {
    "render_tile": (rt.render_tile, rt.render_tile_reference,
                    ("t", "obj", "nx", "ny", "nz", "ao", "hit"),
                    _split("sp_render_tile", 7)),
    "trace_rays": (rt.trace_rays, rt.trace_rays_reference, ("vis",),
                   _split("sp_trace_rays", 1)),
    "ao_fix": (rt.ao_fix, rt.ao_fix_reference, ("ao",),
               _split("sp_ao_fix", 1)),
    "mesh_tile": (mt.mesh_tile, mt.mesh_tile_reference,
                  ("t", "nsx", "nsy", "nsz", "ngx", "ngy", "ngz"),
                  mt.mesh_tile_launcher),
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


def flat(out):
    """A wrapper's or plain version's result -> a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def compare(name: str, args, label: str):
    """Run one recorded call through the wrapper and the plain version ->
    (largest abs difference over the outputs, wrapper outputs, plain
    outputs). Raises AssertionError naming the first output that is not
    bitwise equal."""
    wrapper, reference, names, _ = KERNELS[name]
    got = flat(wrapper(*args))
    ref = flat(reference(*args))
    errs = [float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            for a, b in zip(got, ref)]
    for out_name, a, b, err in zip(names, got, ref, errs):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs from its plain "
                                 f"version in {out_name} (max abs diff "
                                 f"{err})")
    return max(errs), got, ref
