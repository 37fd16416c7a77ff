"""A rank's multi-device frame as one program: CUDA graphs between its
collectives.

JAX compiles each multi-device entry point into one SPMD program, its
collectives inside it.  The port's counterpart, for one rank: a warm-up
call of the entry point's eager body, with real collectives (it builds the
kernels and fills every lru_cache the body reads), then one capture of
the body in which every collective of a band handle (sharded.BandGroup's
all_gather_tiled, sum, min and sum_scatter; BandAxes nests them) ends the
CUDA graph being captured, is recorded with its static input and output
buffers, and begins the next graph in the same memory pool.  A call
replays the graphs in the order of capture (graphs sharing a pool must be)
and runs each recorded collective between two replays: on gloo one staged
host round trip, as the eager band handle makes it; on NCCL queued on the
stream, no host sync.  The capture itself runs no collective, so every rank
captures alone, and every rank records the same collectives in the same
order (the body and the handles' sizes are the same on every rank).

What a graph reads across a collective: the collective's input is the
tensor the graph before it wrote (held, so its memory is never reused);
its result lands in a static buffer outside the pool, which the graph
after it copies into the pool first thing (so that no graph is empty,
between two collectives back to back or after the last).  A gather lands
stacked [ranks, ...] and the next graph concatenates it, so no kernel runs
outside the graphs on either backend.

On CPU tensors there is no graph: a RankProgram runs the body once, each
collective run as it is recorded (the same run() a replay makes) -- the
program's plan, which the tests hold on ranks simulated by threads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..frame import _capture_failed, _StaticInputs, _warm_up


def _out_shape(op: str, shape, n: int) -> tuple:
    """The result shape of collective `op` over n ranks on an input of `shape`."""
    if op == "gather_stacked":
        return (n, *shape)
    if op == "sum_scatter":
        return (shape[0] // n, *shape[1:])
    return tuple(shape)


class Collective(NamedTuple):
    """One recorded collective: the band handle it runs on (the slot in the
    program's handles), the operation, the static input the graph before it
    writes and the static buffer its result lands in."""

    slot: int
    op: str  # "gather_stacked", "sum", "min" or "sum_scatter": a BandGroup method
    x: torch.Tensor
    landing: torch.Tensor

    def run(self, handles) -> None:
        """The collective on the handle of this call in its slot (the same
        ranks, index and size as at capture), its result into the landing
        buffer."""
        self.landing.copy_(getattr(handles[self.slot], self.op)(self.x))

    def describe(self) -> tuple:
        """(slot, op, input shape, result shape, dtype): the plan's entry."""
        return (self.slot, self.op, tuple(self.x.shape), tuple(self.landing.shape), self.x.dtype)


class _Tap:
    """A band handle of the body under capture: the handle's place on its
    axis, and collectives that cut the program.  What follows a collective
    (a gather's concatenation, a copy out of the landing buffer) is the
    next graph's first work."""

    def __init__(self, program: "RankProgram", slot: int, handle):
        self._program, self._slot = program, slot
        self.index, self.total = handle.index, handle.total

    def _cut(self, op: str, x: torch.Tensor) -> torch.Tensor:
        return self._program._collective(self._slot, self.total, op, x)

    def all_gather_tiled(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.total == 1:
            return x
        return torch.cat(list(self._cut("gather_stacked", x).unbind(0)), dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.total == 1 else self._cut("sum", x).clone()

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.total == 1 else self._cut("min", x).clone()

    def sum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.total == 1 else self._cut("sum_scatter", x).clone()


class RankProgram:
    """body(tensors, handles) -> tuple of tensors, captured for this rank
    as CUDA graphs between its collectives (see the module docstring).

    `tensors` are the body's inputs (a state's leaves, a batch's clocks),
    copied into static buffers at each call (frame._StaticInputs);
    `handles` the band handles (sharded.BandGroup) the body's collectives
    run on.  Calling the program with the same kind of tensors and handles
    (the same shapes; the same ranks, index and size on each axis) replays
    it -> the body's outputs, cloned: nothing returned aliases memory that a
    later call writes.  `collectives` holds the recorded collectives in
    order, `graphs` the number of graphs a call replays.  A capture that
    fails raises RuntimeError; nothing falls back to the eager body."""

    def __init__(self, body, tensors, handles, what: str):
        self.collectives, self._steps, self._graph = [], [], None
        taps = [_Tap(self, k, h) for k, h in enumerate(handles)]
        self._handles = handles
        if tensors[0].device.type != "cuda":
            self.graphs = 0
            self.outputs = body(list(tensors), taps)
            return
        dev = tensors[0].device
        self.static = _StaticInputs(tensors)
        self.static.load(tensors)
        with torch.cuda.device(dev):
            side = _warm_up(lambda: body(self.static.bufs, handles), dev)
            self._pool = torch.cuda.graph_pool_handle()
            torch.cuda.synchronize(dev)
            with torch.cuda.stream(side):
                try:
                    self._begin()
                    outputs = body(self.static.bufs, taps)
                    self._end()
                except RuntimeError as e:  # torch.AcceleratorError among them
                    raise _capture_failed(what, e) from e
                finally:
                    if self._graph is not None:  # the body raised mid-capture
                        try:
                            self._graph.capture_end()
                        except RuntimeError:
                            pass  # the capture was invalidated: the body's error says why
            torch.cuda.current_stream(dev).wait_stream(side)
        self.outputs = tuple(outputs)
        self.graphs = sum(1 for s in self._steps if not isinstance(s, Collective))

    def _begin(self) -> None:
        # thread_local: a host sync in this thread breaks the capture;
        # another thread's (a process group's watchdog) does not.
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")

    def _end(self) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        self._steps.append(graph)

    def _collective(self, slot: int, n: int, op: str, x: torch.Tensor) -> torch.Tensor:
        """Record collective `op` of handle `slot` (n ranks) on x -> its
        landing buffer; under capture it ends the graph before it and
        begins the next, else it runs now."""
        x = x.contiguous()
        capturing = self._graph is not None
        if capturing:
            self._end()
        landing = torch.empty(_out_shape(op, x.shape, n), dtype=x.dtype, device=x.device)
        c = Collective(slot, op, x, landing)
        self.collectives.append(c)
        self._steps.append(c)
        if capturing:
            self._begin()
        else:
            c.run(self._handles)
        return landing

    def plan(self) -> list:
        """Each recorded collective's (slot, op, input shape, result shape,
        dtype), in order."""
        return [c.describe() for c in self.collectives]

    def __call__(self, tensors, handles) -> tuple:
        self.static.load(tensors)
        for step in self._steps:
            if isinstance(step, Collective):
                step.run(handles)
            else:
                step.replay()
        return tuple(o.clone() for o in self.outputs)
