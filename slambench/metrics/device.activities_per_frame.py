"""Device activities (kernels, copies, fills) per rig frame handed to the
engine in the profiled slice."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr["frames"]:
        return None
    return tr["activities"] / tr["frames"]
