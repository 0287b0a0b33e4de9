"""The output check: the program's sampled pixels against the reference's.

The harness keeps, from a sample of the window's calls drawn from the
seed, a sample of each call's pixels (over all its frames) from all five
buffers; once the window has closed the plain reference renders the same
rays, and these numbers compare the two (numpy, float64):

    nonfinite_share  share of sampled pixels where a buffer holds a NaN or
                     an infinity (the rest are taken over the others)
    hit_mismatch     share of sampled pixels whose hit differs
    id_mismatch      share whose obj_id differs
    rgb_abs_mean     mean absolute rgb difference over the (finite) pixels
    depth_err_mean   mean over the pixels with equal obj_id (misses too) of
                     |depth - ref| / max(ref, 1)
    normal_abs_mean  mean absolute normal difference over the same pixels

Each cell's limits are data (portbench/checks/<cell>.json). A number is
within its limit when it is at most the limit; a NaN never is.
"""

from __future__ import annotations

import numpy as np

NAMES = ("nonfinite_share", "hit_mismatch", "id_mismatch", "rgb_abs_mean",
         "depth_err_mean", "normal_abs_mean")


def numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: dicts of numpy arrays over the same sampled pixels ->
    the numbers of NAMES. The differences are taken over the pixels at
    which both sides hold finite numbers in every buffer; the share of the
    others is a number of its own."""
    g = {k: np.asarray(v, np.float64) for k, v in prog.items()}
    r = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    fin = np.ones(len(g["hit"]), bool)
    for side in (g, r):
        for v in side.values():
            fin &= np.isfinite(v.reshape(len(fin), -1)).all(axis=1)
    out = {"nonfinite_share": float(np.mean(~fin))}
    g = {k: v[fin] for k, v in g.items()}
    r = {k: v[fin] for k, v in r.items()}
    same = g["obj_id"] == r["obj_id"]
    out.update(
        hit_mismatch=float(np.mean((g["hit"] > 0.5) != (r["hit"] > 0.5))),
        id_mismatch=float(np.mean(~same)),
        rgb_abs_mean=float(np.mean(np.abs(g["rgb"] - r["rgb"]))))
    if same.any():
        out["depth_err_mean"] = float(np.mean(
            np.abs(g["depth"][same] - r["depth"][same])
            / np.maximum(r["depth"][same], 1.0)))
        out["normal_abs_mean"] = float(np.mean(
            np.abs(g["normal"][same] - r["normal"][same])))
    else:
        out["depth_err_mean"] = out["normal_abs_mean"] = float("nan")
    return out


def judge(values: dict, limits: dict) -> dict:
    """-> {name: {"value", "limit", "ok"}} for every limited number."""
    return {k: {"value": values.get(k, float("nan")), "limit": lim,
                "ok": bool(values.get(k, float("nan")) <= lim)}
            for k, lim in limits.items()}
