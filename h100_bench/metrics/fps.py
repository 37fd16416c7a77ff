"""fps: the frames that reached host memory in the window over the
window's seconds (host clock; the window ends when the last frame has
arrived)."""


def read(r):
    run = r.run
    return run["frames"] / run["window_s"] if run["window_s"] > 0 and run["frames"] else None
