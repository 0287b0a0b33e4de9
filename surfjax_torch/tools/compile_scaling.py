"""First call and steady frame time against object count, per object and
as a crowd (counterpart of `tools/compile_scaling.py`).

    python -m surfjax_torch.tools.compile_scaling [counts ...]
        [--scene=sphere|csgpair] [--frames 2] [--repeats 3]
        [--size 1920x1080] [--device cpu]

surfjax's Pallas kernels unroll the scene, so its first call compiles one
march per object (about 0.67 s an object on its TPU). The port's kernels
interpret the scene from tables, so one build serves every scene; what a
new scene costs on its first call is packing its tables, copying them to
the card and, for a staged kernel whose scene needs more than 48 KB of
shared memory, cudaFuncSetAttribute. This tool measures, per object count
and per mode (`per-object`: vector_objects off; `crowd`: on), for n seeded
spheres (or two-leaf smooth-union pairs, `--scene=csgpair`) over a floor at
1920x1080 through `render_sequence` with backend pallas:

    first_s  -- the first call's seconds (host clock to a synchronise),
                the kernels' build and the card's context excluded (made
                before the first row)
    ms_frame -- the steady time per frame, the minimum over the repeats of
                a call of --frames frames (CUDA events)

with the fused kernel's launches of each mode. Past 64 objects the
per-object rows are the scenes the kernels took no more before their fixed
per-thread bounds were lifted. Default counts: 8 16 32 64 128.

On the card it prints the card's name and power limit first and one JSON
line last; with --device cpu it runs the kernels' plain versions (no
times of a device).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from surfjax_torch import api
from surfjax_torch.kernels import render_tile as rt
from surfjax_torch.tools.workload import gpu_line, jitter, poses, reframe

COUNTS = (8, 16, 32, 64, 128)
MODES = (("per-object", False), ("crowd", True))


def scene_n(n_spheres: int, kind: str = "sphere"):
    """n seeded spheres (kind "sphere") or two-leaf smooth-union pairs
    ("csgpair") in rows of six over a floor, one point light -> (scene,
    camera at 256x256); tools/compile_scaling.py's scene_n."""
    scene = api.Scene()
    rng = np.random.RandomState(7)
    for i in range(n_spheres):
        c = (float(i % 6 - 2.5), float(i // 6 - 2.0),
             4.0 + float(rng.rand()))
        if kind == "csgpair":
            node = api.smooth_union(
                api.Sphere(center=c, radius=0.3),
                api.Sphere(center=(c[0] + 0.2, c[1], c[2]), radius=0.22),
                0.15)
        else:
            node = api.Sphere(center=c, radius=0.3)
        scene.add(node, api.Material.lambert((0.2 + 0.02 * i, 0.5, 0.8)),
                  engine="sdf")
    scene.add(api.Plane(normal=(0.0, 1.0, 0.0), offset=-2.5),
              api.Material.lambert((0.5, 0.5, 0.5)))
    scene.add_light(api.PointLight(position=(3.0, 5.0, -1.0),
                                   color=(1.0, 1.0, 1.0)))
    cam = api.Camera.pinhole(256, 256, 45.0, position=(0.0, 0.0, -2.0),
                             target=(0.0, 0.0, 4.0))
    return scene, cam


def settings_of(vector_objects: bool):
    """tools/compile_scaling.py's settings, on the kernels."""
    return api.RenderSettings(shadows=True, max_steps=96,
                              vector_objects=vector_objects,
                              backend="pallas")


def case(n: int, kind: str = "sphere", frames: int = 2,
         size=(1920, 1080)):
    """-> (scene, camera reframed to size, (R_flats, positions)): the
    camera moved by 1e-4 * i on every axis in frame i."""
    scene, cam = scene_n(n, kind)
    cam = reframe(cam, *size)
    return scene, cam, poses(cam, frames, jitter(frames))


def measure(n: int, vector_objects: bool, kind: str = "sphere",
            frames: int = 2, repeats: int = 3, size=(1920, 1080),
            device="cuda", out=None) -> dict:
    """One row: first call and steady ms/frame of n objects in one mode,
    the fused kernel's launches, the frames' hit fraction; out: None, or
    a list to append the last call's FrameBuffers to."""
    dev = torch.device(device)
    scene, cam, seq = case(n, kind, frames, size)
    st = settings_of(vector_objects)
    cuda = dev.type == "cuda"

    def call():
        return api.render_sequence(scene, cam, seq, st, device=dev)

    kf = rt.frame_fused.crowd if rt.launches_crowd(scene.freeze()[0], st) \
        else rt.frame_fused
    before = kf.launches
    t0 = time.perf_counter()
    fb = call()
    if cuda:
        torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats if cuda else 0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb = call()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end) / frames)
    if out is not None:
        out.append(fb)
    return {"objects": n + 1, "mode": "crowd" if vector_objects
            else "per-object", "kind": kind, "frames": frames,
            "first_s": first_s,
            "ms_frame": min(times) if times else None,
            "launches": kf.launches - before,
            "hit_fraction": float(fb.hit.float().mean())}


def run(counts=COUNTS, kind: str = "sphere", frames: int = 2,
        repeats: int = 3, size=(1920, 1080), device="cuda") -> list:
    """measure() over counts x MODES, the build and the card's context
    made first -> rows."""
    if torch.device(device).type == "cuda":
        from surfjax_torch.kernels import _build
        _build.load()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    rows = []
    for n in counts:
        for _, vec in MODES:
            row = measure(n, vec, kind, frames, repeats, size, device)
            rows.append(row)
            ms = "not measured" if row["ms_frame"] is None \
                else f"{row['ms_frame']:9.3f} ms/frame"
            print(f"| objects {row['objects']:4d} | {row['mode']:10s} "
                  f"| first {row['first_s']:8.3f} s | {ms} "
                  f"| launches {row['launches']} |", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("counts", nargs="*", type=int, default=list(COUNTS))
    ap.add_argument("--scene", default="sphere",
                    choices=("sphere", "csgpair"))
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    size = tuple(int(x) for x in a.size.split("x"))
    card = None
    if torch.device(a.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("compile_scaling: torch.cuda.is_available() "
                             "is false; --device cpu runs the plain "
                             "versions")
        card = gpu_line()
        print(card, flush=True)
    rows = run(a.counts, a.scene, a.frames, a.repeats, size, a.device)
    print(json.dumps({"card": card, "device": a.device, "size": list(size),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
