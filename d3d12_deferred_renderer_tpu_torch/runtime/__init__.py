from .present import PresentQueue
from .delta import DeltaPresentQueue
from .app import App, FrameStats, save_frames_to_dir
from .profiler import PassProfiler, chrome_trace
from .native_sink import NativeFrameSink, native_sink_available

__all__ = [
    "PresentQueue",
    "DeltaPresentQueue",
    "App",
    "FrameStats",
    "save_frames_to_dir",
    "PassProfiler",
    "chrome_trace",
    "NativeFrameSink",
    "native_sink_available",
]
