"""PyTorch port: the row scatter (the scatter microbenchmark's kernel).

The plain version against numpy's out[idx] = val on a permutation, as the
JAX package's tool feeds it (tools/ubench_pallas_scatter.py).  That tool's
Pallas kernel has no interpret flag and runs only on a TPU, so numpy is the
reference here; tests/test_torch_cuda.py holds the CUDA kernel to the plain
version on the card.
"""
import numpy as np
import pytest
import torch

from d3d12_deferred_renderer_tpu_torch.ops import scatter


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_row_scatter_plain_matches_numpy(n):
    rng = np.random.default_rng(n)
    idx = rng.permutation(n).astype(np.int32)
    val = rng.integers(0, 1 << 30, (n, 128), dtype=np.int32)
    ref = np.empty_like(val)
    ref[idx] = val
    before = scatter.row_scatter.launches
    got = scatter.row_scatter(torch.from_numpy(idx), torch.from_numpy(val))
    assert scatter.row_scatter.launches == before  # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
