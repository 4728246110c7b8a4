"""build_pyramid's share of its roofline (see metrics/_roofline.py)."""

from slambench.metrics._roofline import share


def read(run):
    return share(run, "build_pyramid")
