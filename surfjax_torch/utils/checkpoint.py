"""Snapshots of a fit's parameters and optimizer state (counterpart of
`save_fit_state` / `load_fit_state` in `surfjax/utils/checkpoint.py`).

A state is a tree of dicts, lists and tuples whose leaves are tensors or
Python numbers; it is stored as numpy arrays in one .npz file, leaves in
tree order (dict keys sorted), and restored into the structure, and onto
the devices and dtypes, of a template tree.
"""

from __future__ import annotations

import os

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
