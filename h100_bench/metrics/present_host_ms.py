"""present_host_ms: host ms a frame inside runtime.PresentQueue.push and
the present callback (the wait for a frame's copy to pinned memory
included), over the traced run's spans window."""


def read(r):
    spans = r.run.get("spans")
    if not spans or "present" not in spans or not r.run.get("span_frames"):
        return None
    return spans["present"] * 1e3 / r.run["span_frames"]
