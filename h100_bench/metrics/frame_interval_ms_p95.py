"""frame_interval_ms_p95: the 95th percentile of the intervals between
consecutive frames reaching host memory, over every frame of the window
(host clock, ms).  A batch's frames arrive together: 7 of a batch of 8
intervals are 0 and the eighth is the batch's."""
import statistics


def read(r):
    t = r.run["arrivals"]
    if len(t) < 21:
        return None
    intervals = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return statistics.quantiles(intervals, n=20)[18]
