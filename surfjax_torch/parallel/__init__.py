"""Sharding over `torch.distributed`: the counterpart of `surfjax.parallel`
(frames and image tiles over a ('frame', 'tile') DeviceMesh, and the
triangle ring of `ring_mesh`)."""

from surfjax_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    render_frame_sharded,
    render_sequence_sharded,
)

__all__ = ["make_mesh", "render_frame_sharded", "render_sequence_sharded",
           "initialize_distributed"]
