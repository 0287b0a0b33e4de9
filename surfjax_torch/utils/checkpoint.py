"""Checkpoint and resume (SURVEY.md §5.4), the counterpart of
`surfjax/utils/checkpoint.py`. Two uses:

  * long animation renders: `SequenceCheckpointer` writes each chunk of
    frames to its own .npz and records it in a manifest; a rerun skips the
    chunks that are done (frame-level idempotency, which is also the
    failure-recovery story of §5.3: a failed chunk is rendered again);
  * fits: `save_fit_state` / `load_fit_state` snapshot a fit's parameters
    and optimizer state. A state is a tree of dicts, lists and tuples whose
    leaves are tensors or Python numbers; it is stored as numpy arrays in
    one .npz file, leaves in tree order (dict keys sorted), and restored
    into the structure, and onto the devices and dtypes, of a template
    tree.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _rebuild(tree, leaves: list):
    """The template `tree` with its leaves replaced, in order, by the
    arrays popped from the front of `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(part, leaves) for part in tree)
    a = leaves.pop(0)
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(a, dtype=tree.dtype, device=tree.device)
    return type(tree)(a)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class SequenceCheckpointer:
    """Chunked animation render with resume and retry (§5.3, §5.4)."""

    def __init__(self, out_dir: str, chunk_size: int = 16):
        self.out_dir = out_dir
        self.chunk_size = chunk_size
        self.manifest_path = os.path.join(out_dir, "manifest.json")
        os.makedirs(out_dir, exist_ok=True)
        self.manifest = {"chunks": {}, "chunk_size": chunk_size}
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as fh:
                loaded = json.load(fh)
            # a manifest written with another chunk size is dropped, so
            # chunks of another stride cannot corrupt the sequence
            if loaded.get("chunk_size") == chunk_size:
                self.manifest = loaded

    def _save_manifest(self):
        with open(self.manifest_path, "w") as fh:
            json.dump(self.manifest, fh)

    def render_all(self, n_frames: int,
                   render_chunk: Callable[[int, int], np.ndarray],
                   max_retries: int = 2,
                   fault_hook: Optional[Callable[[int], None]] = None
                   ) -> List[str]:
        """render_chunk(start, count) -> (count, H, W, 3) rgb (numpy or a
        tensor on any device) -> the chunks' paths.

        Chunks that are done are skipped; a chunk that raises is rendered
        again up to max_retries times, then its error is raised.
        `fault_hook(start)` is the fault-injection hook of the tests: it
        runs before each chunk's render and fires once."""
        paths = []
        for start in range(0, n_frames, self.chunk_size):
            count = min(self.chunk_size, n_frames - start)
            key = f"{start}:{count}"
            path = os.path.join(self.out_dir, f"chunk_{start:06d}.npz")
            if self.manifest["chunks"].get(key) == "done" \
                    and os.path.exists(path):
                paths.append(path)
                continue
            err = None
            for _ in range(max_retries + 1):
                try:
                    if fault_hook is not None:
                        fault_hook(start)
                    rgb = _to_numpy(render_chunk(start, count))
                    np.savez(path, rgb=rgb, start=start, count=count)
                    # a rerun with another n_frames can cover this start
                    # with another count: the file above was overwritten,
                    # so any other key at the same start points at wrong
                    # data and goes (else load_all trips on the overlap)
                    for other in list(self.manifest["chunks"]):
                        if other != key and \
                                int(other.split(":")[0]) == start:
                            del self.manifest["chunks"][other]
                    self.manifest["chunks"][key] = "done"
                    self._save_manifest()
                    paths.append(path)
                    err = None
                    break
                except Exception as e:  # noqa: BLE001 - retried, then raised
                    err = e
                    fault_hook = None
            if err is not None:
                raise err
        return paths

    def load_all(self, n_frames: Optional[int] = None) -> np.ndarray:
        """The chunks concatenated, checked to cover [0, n_frames) without
        a gap, so chunks left by a longer run in the same directory cannot
        leak into the result. n_frames None -> the contiguous prefix."""
        keys = sorted(self.manifest["chunks"],
                      key=lambda k: int(k.split(":")[0]))
        chunks = []
        expect = 0
        for key in keys:
            start, count = (int(v) for v in key.split(":"))
            # chunks past the requested range (a longer run) are fine:
            # stop before the gap check
            if n_frames is not None and start >= n_frames:
                break
            if start != expect:
                if n_frames is None and chunks:
                    # no range asked: a chunk beyond a gap is a leftover
                    break
                raise ValueError(
                    f"checkpoint gap: expected chunk at frame {expect}, "
                    f"found {start} (out_dir {self.out_dir})")
            with np.load(os.path.join(self.out_dir,
                                      f"chunk_{start:06d}.npz")) as z:
                chunks.append(z["rgb"])
            expect = start + count
        if n_frames is not None and expect < n_frames:
            raise ValueError(
                f"checkpoint incomplete: chunks cover [0, {expect}) of "
                f"requested {n_frames} frames")
        if not chunks:
            raise ValueError(f"no checkpoint chunks in {self.out_dir}")
        out = np.concatenate(chunks, axis=0)
        return out[:n_frames] if n_frames is not None else out


def save_fit_state(path: str, step: int, params, opt_state=None) -> None:
    """Write the step counter, the parameters and (if given) the optimizer
    state to `path` (.npz); `path` is replaced in one rename, never
    overwritten in place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"__step__": np.asarray(step)}
    for i, leaf in enumerate(_leaves(params)):
        flat[f"p{i}"] = _to_numpy(leaf)
    if opt_state is not None:
        for i, leaf in enumerate(_leaves(opt_state)):
            flat[f"o{i}"] = _to_numpy(leaf)
    # numpy appends .npz to a name without it, so write through a file
    # object; and write beside `path` first, then rename: a fit killed while
    # it writes leaves the earlier snapshot whole for the next start to load
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_fit_state(path: str, params_tree, opt_state_tree=None):
    """-> (step, params[, opt_state]) as saved by save_fit_state, shaped
    like the template trees."""
    with np.load(path, allow_pickle=False) as z:
        step = int(z["__step__"])
        params = _rebuild(params_tree, [
            z[f"p{i}"] for i in range(len(_leaves(params_tree)))])
        if opt_state_tree is None:
            return step, params
        opt = _rebuild(opt_state_tree, [
            z[f"o{i}"] for i in range(len(_leaves(opt_state_tree)))])
        return step, params, opt
