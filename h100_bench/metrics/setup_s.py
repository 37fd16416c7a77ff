"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the CUDA context, the scene, loading (or, in a
fresh checkout, building) the kernels, the graph capture, the warm-up and
the rate probe."""


def read(r):
    return r.setup_s
