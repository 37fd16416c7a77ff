"""Row scatter: the scatter microbenchmark's kernel.

The counterpart of tools/ubench_pallas_scatter.py (``_row_scatter_kernel``,
entry ``pallas_row_scatter``), which the JAX package used to decide binning's
sort against a counting sort on the TPU.  ``row_scatter(idx, val)`` returns
``out`` [n, 128] int32 with ``out[idx[i]] = val[i]``.  As in that tool, idx
[n] int32 is a permutation of range(n): every row of ``out`` is written
once.  A row that idx does not name is left undefined (the output is
allocated, not cleared), and the kernel skips an index outside [0, n).

``row_scatter_reference`` is the plain version (``out[idx] = val``);
``row_scatter`` runs the CUDA kernel (csrc/scatter.cu) on CUDA tensors and the
plain version on CPU tensors.  No frame calls either: binning stays a sort
(ops/binning.py).
"""
from __future__ import annotations

import torch

ROW = 128


def row_scatter_reference(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Plain version: out[idx[i]] = val[i] for a permutation idx [n]."""
    out = torch.empty_like(val)
    out[idx.long()] = val
    return out


def row_scatter(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Row scatter: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring for the contract)."""
    if val.device.type == "cpu":
        return row_scatter_reference(idx, val)
    from ..utils import cuda_build

    n = idx.shape[0]
    cuda_build.check_tensors(
        val.device,
        idx=(idx, torch.int32, (n,)),
        val=(val, torch.int32, (n, ROW)),
    )
    if val.data_ptr() % 16:
        raise ValueError("val must be 16-byte aligned (the kernel moves 16 bytes a lane)")
    out = torch.empty_like(val)
    err = cuda_build.library().row_scatter_launch(
        idx.data_ptr(), val.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(val.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "row_scatter")
    row_scatter.launches += 1
    return out


row_scatter.launches = 0
