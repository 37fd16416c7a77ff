"""device_idle_pct: the share of the profiled window in which rank 0's card
runs no kernel, copy or set: 100 (1 - busy / window), busy the union of the
profiler's device intervals (devtrace.py)."""


def read(r):
    prof = r.run.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
