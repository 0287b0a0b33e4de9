"""Command line.

    python -m surfjax_torch render --config configs/c4_mesh.yaml \\
        [--backend jnp|pallas] [--device cpu] [--gbuffer] \\
        [--profile-dir prof/] --out frame.png|frame.exr
    python -m surfjax_torch render --config ... --golden --out g.png
    python -m surfjax_torch animate --config configs/c5_anim.yaml \\
        --frames 16 [--chunk-size 4] [--device cpu] --out-dir frames/
    python -m surfjax_torch fit --config configs/c5_anim.yaml \\
        [--mode pose|sdf] [--steps 60] [--backend jnp|pallas] [--device cpu]
    python -m surfjax_torch bench [--config configs/c3_sdf.yaml] \\
        [--repeats 5] [--device cpu]

All run on the CUDA device unless --device names another; `render
--golden` runs the NumPy golden oracle on the host's threads instead.
`--gbuffer` also writes <out>_gbuffer.npz (rgb, depth, normal, float32);
an .exr output is linear float32 rgb, a .png tonemapped; `--profile-dir`
writes a torch.profiler Chrome trace of the render there. `animate
--chunk-size` renders chunks of frames, each saved as it completes, and a
rerun of the same command skips the chunks that are done. `bench` prints
the JSON line of `surfjax_torch.bench.run_bench` (the pinned 1080p x 48
frame workload of the config, c3 by default, in both fidelity modes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load(args):
    from surfjax_torch.config import load_config
    scene, camera, settings, extras = load_config(args.config)
    if args.backend:
        settings = settings.with_(backend=args.backend)
    return scene, camera, settings, extras


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args):
    from surfjax_torch.io.image import save_exr, save_golden, save_png
    scene, camera, settings, _ = _load(args)
    if args.golden:
        from surfjax_torch.golden import renderer as golden
        t0 = time.perf_counter()
        fb = golden.render_parallel(scene, camera, settings)
        dt = time.perf_counter() - t0
        rgb, depth, normal = fb["rgb"], fb["depth"], fb["normal"]
        where = "golden on the host"
    else:
        from surfjax_torch import render
        from surfjax_torch.utils.profiling import trace_render
        t0 = time.perf_counter()
        with trace_render(args.profile_dir):
            fb = render(scene, camera, settings, device=args.device)
            _sync(args.device)
        dt = time.perf_counter() - t0
        rgb, depth, normal = (a.cpu().numpy()
                              for a in (fb.rgb, fb.depth, fb.normal))
        where = f"{settings.backend} on {args.device}"
    print(f"rendered {rgb.shape[1]}x{rgb.shape[0]} in {dt:.3f}s ({where})")
    if args.out.lower().endswith(".exr"):
        save_exr(args.out, rgb)
    else:
        save_png(args.out, rgb)
    if args.gbuffer:
        base, _ = os.path.splitext(args.out)
        save_golden(base + "_gbuffer.npz",
                    {"rgb": rgb, "depth": depth, "normal": normal})
        print(f"wrote {base}_gbuffer.npz")
    print(f"wrote {args.out}")


def cmd_animate(args):
    import torch
    from surfjax_torch import render_sequence
    from surfjax_torch.core.camera import orbit_pose
    from surfjax_torch.io.image import save_png

    scene, camera, settings, extras = _load(args)
    anim = extras.get("animation") or {
        "type": "orbit", "frames": 16, "radius": 4.0, "height": -1.0}
    n = int(anim.get("frames", 16) if args.frames is None else args.frames)
    thetas = torch.linspace(0.0, 2.0 * np.pi, n + 1,
                            dtype=torch.float32)[:n]
    radius = torch.tensor(float(anim.get("radius", 4.0)))
    height = torch.tensor(float(anim.get("height", -1.0)))
    poses = [orbit_pose(radius, height, th) for th in thetas]
    Rs = torch.stack([R for R, _ in poses])
    ts = torch.stack([t for _, t in poses]) + torch.as_tensor(
        np.asarray(anim.get("center", (0, 0, 0)), np.float32))
    t0 = time.perf_counter()
    if args.chunk_size:
        from surfjax_torch.utils.checkpoint import SequenceCheckpointer
        cp = SequenceCheckpointer(args.out_dir, chunk_size=args.chunk_size)

        def render_chunk(start, count):
            fb = render_sequence(
                scene, camera,
                (Rs[start:start + count], ts[start:start + count]),
                settings, device=args.device)
            return fb.rgb.cpu().numpy()

        cp.render_all(n, render_chunk)
        # n frames asked: chunks left by a longer run must not leak in
        rgb = cp.load_all(n)
    else:
        frames = render_sequence(scene, camera, (Rs, ts), settings,
                                 device=args.device)
        _sync(args.device)
        rgb = frames.rgb.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"rendered {n} frames in {dt:.3f}s ({n / dt:.2f} frames/s, "
          f"{settings.backend} on {args.device})")
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(n):
        save_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"), rgb[i])
    print(f"wrote {n} PNGs to {args.out_dir}")


def cmd_fit(args):
    """Inverse-rendering demo: render a target with the config's true
    parameters, perturb them, then recover them."""
    from surfjax_torch import render
    from surfjax_torch.diff import fit_pose, fit_sdf
    from surfjax_torch.tools.workload import FIT_POSE_INIT, sdf_fit_start

    scene, camera, settings, extras = _load(args)
    fit_cfg = extras.get("fit", {})
    mode = args.mode or fit_cfg.get("type", "pose")
    steps = (int(fit_cfg.get("steps", 100)) if args.steps is None
             else args.steps)
    lr = float(fit_cfg.get("lr", 2e-2))

    target = render(scene, camera, settings, device=args.device).rgb
    t0 = time.perf_counter()
    if mode == "pose":
        init = tuple(np.asarray(v, np.float32) for v in FIT_POSE_INIT)
        R, t, losses = fit_pose(scene, camera, target, steps=steps, lr=lr,
                                settings=settings, init=init, verbose=True,
                                device=args.device)
        print(f"fit_pose: loss {losses[0]:.3e} -> {losses[-1]:.3e} "
              f"in {time.perf_counter() - t0:.1f}s "
              f"({settings.backend} on {args.device})")
        print("recovered R:\n", R.reshape(3, 3).round(4))
        print("recovered t:", t.round(4))
    elif mode == "sdf":
        true_lp, init, mask = sdf_fit_start(scene)
        lp, losses = fit_sdf(scene, camera, target, steps=steps, lr=lr,
                             settings=settings, init_leaf_params=init,
                             param_mask=mask, verbose=True,
                             device=args.device)
        err0 = np.abs(init - true_lp).max()
        err1 = np.abs(lp - true_lp).max()
        print(f"fit_sdf: loss {losses[0]:.3e} -> {losses[-1]:.3e}, "
              f"param err {err0:.4f} -> {err1:.4f} "
              f"in {time.perf_counter() - t0:.1f}s "
              f"({settings.backend} on {args.device})")
    else:
        raise SystemExit(f"unknown fit mode {mode!r}")


def cmd_bench(args):
    from surfjax_torch.bench import run_bench
    print(json.dumps(run_bench(config=args.config, repeats=args.repeats,
                               device=args.device)))


def main(argv=None):
    p = argparse.ArgumentParser(prog="surfjax_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn, helptext in (
            ("render", cmd_render, "render one frame from a config"),
            ("animate", cmd_animate, "render an orbit camera path"),
            ("fit", cmd_fit, "inverse-rendering demo (pose or sdf)")):
        sp = sub.add_parser(name, help=helptext)
        sp.add_argument("--config", required=True)
        sp.add_argument("--backend", choices=("jnp", "pallas"), default=None)
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions of the kernels)")
        sp.set_defaults(fn=fn)
        if name == "render":
            sp.add_argument("--out", default="frame.png",
                            help=".png (tonemapped) or .exr (linear)")
            sp.add_argument("--golden", action="store_true",
                            help="render with the NumPy golden oracle on "
                                 "the host")
            sp.add_argument("--gbuffer", action="store_true",
                            help="also write <out>_gbuffer.npz")
            sp.add_argument("--profile-dir", default=None,
                            help="write a torch.profiler trace here")
        elif name == "fit":
            sp.add_argument("--mode", choices=("pose", "sdf"), default=None)
            sp.add_argument("--steps", type=int, default=None)
        else:
            sp.add_argument("--frames", type=int, default=None)
            sp.add_argument("--out-dir", default="frames")
            sp.add_argument("--chunk-size", type=int, default=None,
                            help="render in chunks, resumable")
    sp = sub.add_parser("bench", help="run the benchmark harness")
    sp.add_argument("--config", default=None)
    sp.add_argument("--repeats", type=int, default=5)
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    sp.set_defaults(fn=cmd_bench)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
