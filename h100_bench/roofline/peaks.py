"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): HBM bytes a second and float32 operations a second outside
the tensor cores.  A roofline share is stated against these, with the
card's power limit beside it."""
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
