"""k3_roofline: K3's bound on the shadow map over its device time a frame
in the profiled window, in percent (roofline/k3.py)."""
from ..roofline.common import share


def read(r):
    return share(r, "k3")
