"""Shared by the ``<kernel>_roofline`` readers: the kernel's share of its
roofline, the least time the card could take for the work (the larger of
bytes over peak bandwidth and operations over peak float32 rate, from
``roofline/<kernel>.py``) over its mean device time a call in the
profiled slice, inside the port's range of that name."""


def share(run, kernel: str):
    tr, peaks = run["trace"], run["peaks"]
    if tr is None or peaks is None:
        return None
    k = tr["kernels"].get(kernel)
    if not k or not k["launches"] or k["device_s"] <= 0:
        return None
    work = run["work"](kernel)
    if work is None:
        return None
    nbytes, flop = work
    bound_s = max(nbytes / peaks["hbm_bytes_per_s"],
                  flop / peaks["f32_flop_per_s"])
    return 100.0 * bound_s / (k["device_s"] / k["launches"])
