"""Spawn a world of ranks on one host and collect what each returns.

`run_world(fn, world, *args)` starts `world` processes with the `spawn`
method (never `fork`: a parent that has touched CUDA cannot fork a child
that uses it), joins them in one process group through a `file://` store
in a fresh temporary directory, runs `fn(*args)` in each and returns the
results in rank order. fn must be importable by name and return
something picklable (numpy arrays, not CUDA tensors). A rank that raises
fails the whole world: its traceback is raised here and the other ranks
are terminated, since they may be waiting on it in a collective.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback


def _rank_main(fn, args, rank: int, world: int, init_method: str,
               device: str, backend, results) -> None:
    import torch.distributed as dist

    from surfjax_torch.parallel.mesh import initialize_distributed
    # the ranks share one host: collectives go over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        kw = {} if backend is None else {"backend": backend}
        initialize_distributed(device, init_method=init_method, rank=rank,
                               world_size=world, **kw)
        results.put((rank, True, fn(*args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, *args, device: str = "cuda", backend=None,
              timeout: float = 600.0) -> list:
    """fn(*args) on ranks 0..world-1 of a new process group on `device`'s
    type (the card unless the caller asks for "cpu"; the backend follows
    it unless `backend` names one: gloo on the CPU, NCCL on cards; several
    ranks on one card need gloo) -> [rank 0's result, ...]. Raises if a
    rank fails or none answers within `timeout` s, and without a card on a
    card request before spawning anything."""
    from surfjax_torch.pipeline.frame import _check_device
    device = _check_device(device).type
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world,
                                   f"file://{tmp}/store", device,
                                   backend, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out = {}
        try:
            deadline = time.monotonic() + timeout
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} of {world} exited with codes "
                            f"{[procs[r].exitcode for r in dead]} before "
                            "answering") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"the world of {world} did not answer within "
                            f"{timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} "
                                       f"failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30.0 if len(out) == world else 0.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [out[r] for r in range(world)]
