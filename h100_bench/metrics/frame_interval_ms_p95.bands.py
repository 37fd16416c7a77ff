"""frame_interval_ms_p95.bands: frame_interval_ms_p95 of a cell that does
not hold it to a bound end to end (the bands cell, whose four processes
meet at every frame's collectives), read as a per-layer metric: the same
95th percentile of the intervals between consecutive frames reaching host
memory, over every frame of the measured window (host clock, ms)."""
from h100_bench.metrics.frame_interval_ms_p95 import read  # noqa: F401
