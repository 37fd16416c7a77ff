"""collective_ms: host ms a frame on rank 0 inside the collectives that a
rank program (parallel.program.RankProgram) runs between its graphs, over
the traced run's spans window."""


def read(r):
    spans = r.run.get("spans")
    if not spans or "collective" not in spans or not r.run.get("span_frames"):
        return None
    return spans["collective"] * 1e3 / r.run["span_frames"]
