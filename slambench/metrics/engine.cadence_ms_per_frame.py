"""The host cadence's own milliseconds per rig frame in the window
outside the profiled slice: the self time of ``engine.cadence`` and of
its stages, so that the BA (``ba.*``), the host's waits on the card
(``engine.wait.*``) and the kernel wrappers opened inside them stay
out."""

from slambench.metrics._spans import window

CADENCE = ("engine.cadence", "engine.poll_ba", "engine.grouping",
           "engine.merge", "engine.loop", "engine.intercam",
           "engine.intercam_map", "engine.register", "engine.kf_ready",
           "engine.keyframe", "engine.fuse")


def read(run):
    got = window(run)
    if got is None:
        return None
    table, frames = got
    return 1e3 * sum(table[n][2] for n in CADENCE if n in table) / frames
