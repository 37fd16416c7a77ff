"""Multi-device rendering over torch.distributed (the counterpart of
d3d12_deferred_renderer_tpu/parallel): screen-row bands, frame batches and
triangle shards over a rank mesh.

``make_rows_group`` joins a rank to the group of a frame's ranks;
``make_mesh`` lays that group out on named axes; ``render_sharded`` renders
one frame as N row bands, ``render_tri_sharded`` one frame with its
triangle stream split (sort-last compositing), and
``render_frames_batch_sharded`` / ``render_frames_batch_tri_sharded`` a
batch of frames over a frame axis; ``run_bands`` runs N ranks on one host
(spawned processes, every join with a deadline) and ``dryrun`` holds the
multi-device dry run (``dryrun.dryrun_multichip``)."""
from . import dryrun
from .launch import run_bands
from .mesh import make_mesh, make_rows_group
from .sharded import (
    animation_times,
    render_frames_batch_sharded,
    render_frames_batch_tri_sharded,
    render_sharded,
    render_tri_sharded,
)

__all__ = [
    "make_mesh",
    "make_rows_group",
    "render_sharded",
    "render_frames_batch_sharded",
    "render_tri_sharded",
    "render_frames_batch_tri_sharded",
    "animation_times",
    "run_bands",
    "dryrun",
]
