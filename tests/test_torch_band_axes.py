"""PyTorch port: BandAxes and the sort-last composite, ranks simulated by threads.

The contract of tests/test_band_axes.py: BandAxes's band index and gather
order are pure functions of the mesh coordinates, for both declaration
orders; and the triangle shards' composite keeps the first slice's sign of
zero whichever sign the backend's minimum returns.  No JAX reference, no
spawn.  (Split from tests/test_torch_tri_sharded.py.)
"""
import threading

import numpy as np
import pytest
import torch

from d3d12_deferred_renderer_tpu_torch.ops.raster_ref import FragmentPlanes
from d3d12_deferred_renderer_tpu_torch.parallel import mesh, sharded


class _ThreadGroup(sharded.BandGroup):
    """One axis of ranks simulated by threads: `group` is the shared
    (barrier, slots) pair of the axis's line of ranks."""

    def _exchange(self, x):
        barrier, slots = self.group
        slots[self.index] = x
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def all_gather_tiled(self, x, dim=0):
        return torch.cat(self._exchange(x), dim) if self.total > 1 else x

    def sum(self, x):
        if self.total == 1:
            return x
        vals = self._exchange(x)
        return sum(vals[1:], vals[0])

    zero = 0.0

    def min(self, x):  # ties of +-0.0 resolve to the sign `zero` (a backend's choice)
        m = torch.stack(self._exchange(x)).amin(0)
        return torch.where(m == 0, torch.full_like(m, self.zero), m) if m.is_floating_point() else m

    def sum_scatter(self, x):  # added in turn, as the backends add (torch.sum would start from +0.0)
        vals = self._exchange(x)
        return sum(vals[1:], vals[0]).chunk(self.total)[self.index]


def _run_ranks(sizes, names, fn):
    """fn(mesh coords) in a thread per rank of a mesh of `sizes` -> results
    in rank order; every axis line shares a barrier."""
    lines = {}
    for ax, size in enumerate(sizes):
        for line in mesh.axis_lines(sizes, ax):
            shared = (threading.Barrier(size), [None] * size)
            for r in line:
                lines[(ax, int(r))] = shared
    n = int(np.prod(sizes))
    out = [None] * n

    def run(r):
        coords = mesh.mesh_coords(r, sizes)
        out[r] = fn(coords, {names[ax]: lines[(ax, r)] for ax in range(len(sizes))})

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "a simulated rank is still waiting"
    return out


def _axes(coords, shared, sizes, names, order):
    return sharded.BandAxes(tuple(
        _ThreadGroup(shared[nm], coords[names.index(nm)], sizes[names.index(nm)], False) for nm in order))


@pytest.mark.parametrize("names", [("rows", "tri"), ("tri", "rows")])
def test_band_index_and_gather_are_rows_major(names):
    """tests/test_band_axes.py's contract: on either declaration order the
    band index is rows_idx * 2 + tri_idx and every rank gathers the bands
    in that order."""
    sizes = (2, 2)

    def fn(coords, shared):
        axes = _axes(coords, shared, sizes, names, ("rows", "tri"))
        rows, tri = coords[names.index("rows")], coords[names.index("tri")]
        mine = torch.tensor([10 * rows + tri])
        return (axes.index, rows * 2 + tri, axes.total, axes.all_gather_tiled(mine).tolist(),
                int(axes.sum(torch.tensor(1))))

    for index, expect, total, gathered, count in _run_ranks(sizes, names, fn):
        assert index == expect and total == count == 4
        assert gathered == [0, 1, 10, 11]


def test_band_axes_single_axis():
    def fn(coords, shared):
        axes = _axes(coords, shared, (4,), ("rows",), ("rows",))
        return axes.index, axes.all_gather_tiled(torch.tensor([axes.index])).tolist()

    assert _run_ranks((4,), ("rows",), fn) == [(i, [0, 1, 2, 3]) for i in range(4)]


@pytest.mark.parametrize("zero", [0.0, -0.0], ids=["min_gives_plus", "min_gives_minus"])
def test_composite_keeps_the_first_slice_sign_of_zero(zero):
    """Depths of +0.0 and -0.0 tie; whichever sign the minimum returns, the
    first slice's depth and planes come through with their bits, as the
    single-device raster keeps the first triangle's.  -0.0 attributes stay
    -0.0, and the background keeps mesh id -1."""
    pz, nz = 0.0, -0.0
    depth = [torch.tensor([[pz, nz, 0.5, 1.0]]), torch.tensor([[nz, pz, 0.25, 1.0]])]
    normal = [torch.tensor([[[nz, 1.0, 2.0]] * 4]), torch.tensor([[[3.0, 4.0, 5.0]] * 4])]
    mid = [torch.tensor([[0, 0, 0, -1]], dtype=torch.int32), torch.tensor([[1, 1, 1, -1]], dtype=torch.int32)]

    group = type("Group", (_ThreadGroup,), {"zero": zero})

    def fn(coords, shared):
        g = group(shared["tri"], coords[0], 2, False)
        r = coords[0]
        frags = FragmentPlanes(depth=depth[r].repeat(2, 1), normal=normal[r].repeat(2, 1, 1),
                                                 uv=torch.full((2, 4, 2), nz), mesh_id=mid[r].repeat(2, 1))
        return sharded._stack_planes(sharded._composite_tri(frags, g))

    out = torch.cat(_run_ranks((2,), ("tri",), fn))  # sub-bands of one row each
    for row in out:
        d = row[:, 0]
        assert d.view(torch.int32).tolist() == torch.tensor([pz, nz, 0.25, 1.0]).view(torch.int32).tolist()
        assert row[:, 6].tolist() == [0.0, 0.0, 1.0, -1.0]
        assert row[0, 1].view(torch.int32) == torch.tensor(nz).view(torch.int32)  # slice 0's -0.0 normal
        assert (row[:, 4:6].view(torch.int32) == torch.tensor(nz).view(torch.int32)).all()
