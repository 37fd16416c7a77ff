"""ctypes bindings for the native threaded frame sink (native/framesink.cpp).

The counterpart of d3d12_deferred_renderer_tpu/runtime/native_sink.py, bound
to the port's own build (utils/native_build.py: build/native/libframesink.so).
Frames are copied into a bounded native ring (blocking only when full: the
reference's fence-wait backpressure, main.cpp:167-171) and a C++ worker pool
PNG-encodes and writes them off the render thread.  Where the library cannot
be built, native_sink_available() is False and NativeFrameSink raises; the
in-process writer is runtime.app.save_frames_to_dir.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native_build import ensure_built as _ensure_built

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib_path = _ensure_built("libframesink.so", "framesink.cpp")
    if lib_path is None:
        return None
    lib = ctypes.CDLL(lib_path)
    lib.framesink_create.restype = ctypes.c_void_p
    lib.framesink_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
    lib.framesink_push.restype = ctypes.c_int
    lib.framesink_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.framesink_flush.restype = None
    lib.framesink_flush.argtypes = [ctypes.c_void_p]
    lib.framesink_frames_written.restype = ctypes.c_int64
    lib.framesink_frames_written.argtypes = [ctypes.c_void_p]
    lib.framesink_errors.restype = ctypes.c_int64
    lib.framesink_errors.argtypes = [ctypes.c_void_p]
    lib.framesink_destroy.restype = None
    lib.framesink_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_sink_available() -> bool:
    return _load() is not None


class NativeFrameSink:
    """Threaded PNG writer.  Use as a context manager or call close()."""

    def __init__(self, out_dir: str, width: int, height: int, channels: int = 3,
                 queue_depth: int = 4, num_threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native framesink not available")
        if channels not in (1, 3, 4):
            raise ValueError(f"PNG sink supports 1/3/4 channels, got {channels}")
        if width <= 0 or height <= 0:
            raise ValueError(f"invalid frame size {width}x{height}")
        os.makedirs(out_dir, exist_ok=True)
        self._lib = lib
        self.width, self.height, self.channels = width, height, channels
        self._handle = lib.framesink_create(
            out_dir.encode(), width, height, channels, queue_depth, num_threads
        )
        if not self._handle:
            raise RuntimeError("framesink_create failed")
        # Safety net for callers that skip close(): destroy flushes queued
        # frames and joins the worker threads, so interpreter exit can't kill
        # a worker mid-write or drop ring contents.  close() detaches it.
        import weakref

        self._finalizer = weakref.finalize(self, lib.framesink_destroy, self._handle)

    def _h(self):
        # The C ABI dereferences the handle unconditionally; a NULL from a
        # closed sink must become a Python error, not a segfault.
        if not self._handle:
            raise RuntimeError("framesink is closed")
        return self._handle

    def push(self, frame: np.ndarray, index: int) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        # Hard check, not assert: the C side memcpys width*height*channels
        # bytes from this pointer, and asserts vanish under python -O.
        if frame.shape != (self.height, self.width, self.channels):
            raise ValueError(
                f"frame shape {frame.shape} != sink shape "
                f"({self.height}, {self.width}, {self.channels})"
            )
        rc = self._lib.framesink_push(
            self._h(), frame.ctypes.data_as(ctypes.c_void_p), index
        )
        if rc != 0:
            raise RuntimeError(
                "framesink closed" if rc == -1 else "framesink push failed"
            )

    def flush(self) -> None:
        self._lib.framesink_flush(self._h())

    @property
    def frames_written(self) -> int:
        return int(self._lib.framesink_frames_written(self._h()))

    @property
    def errors(self) -> int:
        return int(self._lib.framesink_errors(self._h()))

    def close(self) -> None:
        if self._handle:
            self._finalizer.detach()
            self._lib.framesink_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def as_present_callback(self):
        """Adapter for runtime.App(present_callback=...)."""
        return lambda i, frame: self.push(frame, i)
