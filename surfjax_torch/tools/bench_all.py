"""Every SPEC config and the performance gate's workloads on one card: the
counterpart of the JAX package's `tools/bench_all.py` and of the measuring
half of its `tools/perf_check.py`.

    python -m surfjax_torch.tools.bench_all [--rows matrix|gated]
        [--device cuda]

prints one JSON line per row, then a table. The headline metric is
`surfjax_torch.bench` (c3 at 1080p); these rows record the rest.

  --rows matrix  (default) the workload matrix: c1 at 256^2 (64 frames per
                 call), c2 at 512^2 (32), c3 at 1024^2, c3 with the
                 fixture camera at 1080p, the two rows of run_bench(), the
                 128-triangle c4 fixture and configs/c4_mesh.yaml at 1080p;
  --rows gated   the gate's workloads, each row tagged with its
                 `workload`: the headline (both modes), c2 at 512^2 (128
                 frames, 6 repeats), c4_fixture, c4_config, crowd64 (65
                 objects, `vector_objects`) and c5_seq (configs/c5_anim.yaml's
                 128-frame orbit in one call).

Every row is timed as `bench.time_mode` times the headline: one warm-up
`render_sequence` call, then `repeats` calls ended by a synchronisation,
the fastest over its frames (every repeat and its CUDA-event time beside
it). On the card the kernel paths run (`backend="pallas"`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from surfjax_torch.api import Camera
from surfjax_torch.bench import Timing, ray_counts, run_bench, time_mode
from surfjax_torch.config import load_config
from surfjax_torch.core.camera import Intrinsics
from surfjax_torch.pipeline.frame import _check_device
from surfjax_torch.tools import scenes
from surfjax_torch.tools.workload import ROOT, gpu_line, jitter, poses

C4 = os.path.join(ROOT, "configs", "c4_mesh.yaml")
C5 = os.path.join(ROOT, "configs", "c5_anim.yaml")


def _row(name, resolution, timing, rays, device_name) -> dict:
    dt = timing.s_per_frame
    dev_ms = timing.device_frame_times_s
    return {
        "config": name,
        "resolution": list(resolution),
        "frame_ms": dt * 1e3,
        "fps": 1.0 / dt,
        "mrays_per_s": rays / dt / 1e6,
        "rays_per_frame": int(rays),
        "frame_ms_repeats": [t * 1e3 for t in timing.frame_times_s],
        "device_frame_ms": (None if dev_ms is None
                            else [t * 1e3 for t in dev_ms]),
        "device": device_name,
    }


def _scene_row(name, intr, timing, rays, device) -> dict:
    return _row(name, (intr.width, intr.height), timing, rays,
                gpu_line() if device.type == "cuda" else "cpu")


def bench_scene(scene, camera, settings, lights, name, repeats=3, batch=24,
                device="cuda") -> dict:
    """`batch` frames, frame i moved by 1e-4 * i on every axis, in one
    `render_sequence` call, timed as bench.time_mode -> the row: frame_ms
    the fastest call over its frames; rays counted from frame 0's hits with
    `lights` shadow rays per hit."""
    device = _check_device(device)
    if device.type == "cuda":
        settings = settings.with_(backend="pallas")
    timing = time_mode(scene, camera, settings,
                       poses(camera, batch, jitter(batch)), repeats, device)
    intr = camera.intrinsics
    rays = sum(ray_counts(intr, float(timing.hits[0]), lights, settings))
    return _scene_row(name, intr, timing, rays, device)


def bench_c5_sequence(frames: int = 128, repeats: int = 6,
                      device="cuda") -> dict:
    """configs/c5_anim.yaml's orbit, `frames` poses in one `render_sequence`
    call (the fused kernel on the card) -> the row; rays are primary plus
    one shadow ray per hit and light, hits averaged over the frames."""
    device = _check_device(device)
    scene, cam, settings, extras = load_config(C5)
    if device.type == "cuda":
        settings = settings.with_(backend="pallas")
    poses_ = scenes.c5_orbit_poses(extras.get("animation") or {}, frames)
    timing = time_mode(scene, cam, settings, poses_, repeats, device)
    intr = cam.intrinsics
    # perf_check's accounting: primary and shadow rays, no AO term
    primary, shadow, _ = ray_counts(intr, float(timing.hits.sum()) / frames,
                                    len(scene.lights), settings)
    return _scene_row(f"c5 sequence {frames}f {intr.width}^2 (fused KF "
                      "path)", intr, timing, primary + shadow, device)


def headline_rows(hb: dict) -> list:
    """run_bench's dict -> its two rows (`value`, `value_exact`)."""
    rows = []
    for label, mode in (("c3 METRIC (bench)", "value"),
                        ("c3 METRIC exact-LoD0", "value_exact")):
        host_s = hb["frame_times_s"][mode]
        timing = Timing(min(host_s), None, host_s,
                        hb["device_frame_time_s"][mode])
        rows.append(_row(label, (1920, 1080), timing, hb["rays_per_frame"],
                         hb["device"]))
    return rows


def rows(kind: str, device="cuda") -> list:
    """-> [(workload, thunk)] of the `matrix` or `gated` rows; each thunk
    measures its workload and returns its rows."""
    def scene_row(make, lights, name, **kw):
        return lambda: [bench_scene(*make(), lights, name, device=device,
                                    **kw)]

    def fixture_cam_c3():
        sc, cam, st = scenes.config3_sdf(1024)
        # the fixture camera at the metric resolution: not the headline
        # workload, which frames the yaml's camera
        cam = Camera(Intrinsics.from_fov(1920, 1080, 45.0),
                     rotation=cam.rotation, position=cam.position)
        return sc, cam, st

    headline = ("headline", lambda: headline_rows(run_bench(device=device)))
    c4_fixture = ("c4_fixture", scene_row(
        lambda: scenes.config4_mesh(1920, 1080), 1,
        "c4 FIXTURE mesh (128 tris) 1080p"))
    c4_config = ("c4_config", scene_row(
        lambda: load_config(C4)[:3], 1, "c4 CONFIG mesh (8192 tris) 1080p"))
    if kind == "matrix":
        return [
            ("c1", scene_row(lambda: scenes.config1_sphere(256), 1,
                             "c1 sphere 256^2", batch=64)),
            ("c2", scene_row(lambda: scenes.config2_csg(512), 2,
                             "c2 csg 512^2", batch=32)),
            ("c3", scene_row(lambda: scenes.config3_sdf(1024), 1,
                             "c3 sdf 1024^2")),
            ("c3_fixture_cam", scene_row(fixture_cam_c3, 1,
                                         "c3 FIXTURE-cam 1080p")),
            headline, c4_fixture, c4_config]
    if kind == "gated":
        return [
            headline,
            ("c2", scene_row(lambda: scenes.config2_csg(512), 2,
                             "c2 csg 512^2", batch=128, repeats=6)),
            c4_fixture, c4_config,
            ("crowd64", scene_row(scenes.crowd64, 1,
                                  "crowd 65 objects 256^2")),
            ("c5_seq", lambda: [bench_c5_sequence(device=device)])]
    raise ValueError(f"rows: {kind!r} is neither 'matrix' nor 'gated'")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="surfjax_torch.tools.bench_all")
    ap.add_argument("--rows", choices=("matrix", "gated"), default="matrix")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    _check_device(args.device)
    results = []
    for workload, measure in rows(args.rows, args.device):
        for r in measure():
            if args.rows == "gated":
                r["workload"] = workload
            results.append(r)
            print(json.dumps(r), flush=True)
    print()
    print(f"{'config':<36}{'res':<14}{'ms/frame':>10}{'fps':>10}"
          f"{'Mrays/s':>10}")
    for r in results:
        print(f"{r['config']:<36}{str(r['resolution']):<14}"
              f"{r['frame_ms']:>10.4f}{r['fps']:>10.1f}"
              f"{r['mrays_per_s']:>10.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
