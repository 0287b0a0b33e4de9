"""Per-frame metrics (SURVEY.md §5.5): ray counts by class (the SPEC
metric counts shadow rays, BASELINE.json:2), wall time and Mrays/s,
appended as one JSON line per frame. The same record as
`surfjax/utils/metrics.py`."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class FrameMetrics:
    """Accumulates per-frame records and appends them to a JSONL file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []

    def record(self, *, width: int, height: int, wall_s: float,
               hits: float, n_lights: int, shadows: bool, ao: bool,
               ao_samples: int = 0, tag: str = "frame") -> dict:
        primary = float(width * height)
        shadow = hits * n_lights if shadows else 0.0
        ao_rays = hits * ao_samples if ao else 0.0
        total = primary + shadow + ao_rays
        rec = {
            "ts": time.time(),
            "tag": tag,
            "resolution": [width, height],
            "wall_s": round(wall_s, 6),
            "rays_primary": int(primary),
            "rays_shadow": int(shadow),
            "rays_ao": int(ao_rays),
            "rays_total": int(total),
            "mrays_per_s": round(total / wall_s / 1e6, 3) if wall_s else 0.0,
            "frames_per_s": round(1.0 / wall_s, 3) if wall_s else 0.0,
        }
        self.records.append(rec)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        return rec
