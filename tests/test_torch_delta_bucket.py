"""PyTorch port: the delta queue's miss bucket (runtime/delta._pow2_at_least):
the least power of two at or above n, below 2 n.  (Split from
tests/test_torch_delta.py.)
"""
import pytest

from d3d12_deferred_renderer_tpu_torch.runtime.delta import _pow2_at_least


@pytest.mark.parametrize("n", range(1, 10))
def test_miss_bucket(n):
    k = _pow2_at_least(n)
    assert k >= n and k & (k - 1) == 0 and k < 2 * n
