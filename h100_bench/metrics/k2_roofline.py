"""k2_roofline: K2's (the fused tile renderer's) bound over its device
time a frame in the profiled window, in percent (roofline/k2.py)."""
from ..roofline.common import share


def read(r):
    return share(r, "k2")
