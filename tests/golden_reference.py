"""surfjax's own fused path against the C++ golden on chip_smoke.py phase
20's frames: frame 0 of c3 (modes `value` and `value_exact`) at 1024x1024
and of c5 at 256x256, rendered by surfjax with backend="pallas" (KF,
jitted, in interpret mode on the CPU) and by surfjax's C++ golden, each
compared by the port's golden/compare.golden_gap. Where surfjax breaks a
bound of golden/compare.BOUNDS, its figure is the bound phase 20 holds the
card to (compare.REFERENCE_FIGURES). A script, not a test: the three
renders take about two minutes.

    JAX_PLATFORMS=cpu python -m tests.golden_reference
"""

import json
import os
import time

import numpy as np

from surfjax_torch.tools.workload import EXACT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (config, mode, bound class of golden/compare.py, settings over the
# config's, with backend pallas)
CASES = (("c3_sdf", "value", "sdf", {}),
         ("c3_sdf", "value_exact", "sdf", EXACT),
         ("c5_anim", "config", "strict", {}))


def reference_gap(config: str, over: dict):
    """surfjax's fused frame 0 of `config` at the config's own camera
    against surfjax's C++ golden -> (golden_gap's figures, the frame as a
    dict of numpy arrays). surfjax's C++ golden writes no obj_id: the
    frame's own stands in on the golden's hit pixels."""
    import jax
    from surfjax import render
    from surfjax.config import load_config
    from surfjax.golden import cpp_bridge
    from surfjax_torch.golden.compare import golden_gap

    scene, cam, st, _ = load_config(os.path.join(ROOT, "configs",
                                                 config + ".yaml"))
    gold = cpp_bridge.render(scene, cam, st)
    fb = jax.block_until_ready(render(scene, cam, st.with_(
        backend="pallas", **over)))
    frame = {k: np.asarray(getattr(fb, k))
             for k in ("rgb", "depth", "normal", "hit", "obj_id")}
    gold["obj_id"] = np.where(gold["hit"] > 0.5, frame["obj_id"], -1)
    return golden_gap(frame, gold), frame


def main() -> None:
    from surfjax_torch.golden.compare import broken_bounds
    for config, mode, kind, over in CASES:
        t0 = time.perf_counter()
        gap, _ = reference_gap(config, over)
        gap.pop("obj_agree")
        print(json.dumps({"config": config, "mode": mode,
                          "seconds": time.perf_counter() - t0,
                          "broken": broken_bounds(gap, kind), **gap}),
              flush=True)


if __name__ == "__main__":
    main()
