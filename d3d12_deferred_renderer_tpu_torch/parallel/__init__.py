"""Multi-device rendering over torch.distributed: the screen-row band path
(the counterpart of d3d12_deferred_renderer_tpu/parallel's row bands).

``render_sharded`` renders one frame as N row bands over a process group;
``make_rows_group`` joins a rank to that group; ``run_bands`` runs N band
ranks on one host (spawned processes, every join with a deadline)."""
from .launch import run_bands
from .mesh import make_rows_group
from .sharded import render_sharded

__all__ = ["make_rows_group", "render_sharded", "run_bands"]
