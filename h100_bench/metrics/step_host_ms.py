"""step_host_ms: host ms a frame inside the frame-program call
(frame.step_frame_jit under App.run, frame.render_batch, or
parallel.render_sharded and its rank program), over the traced run's spans
window."""


def read(r):
    spans = r.run.get("spans")
    if not spans or "step" not in spans or not r.run.get("span_frames"):
        return None
    return spans["step"] * 1e3 / r.run["span_frames"]
