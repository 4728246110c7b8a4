"""The engine's own stage clock for the keyframe BA (``timing["ba"]``,
which ends in a host read) per rig frame, outside the profiled slice;
0 when no BA ran."""


def read(run):
    if not run["stage_frames"]:
        return None
    return 1e3 * run["stage"].get("ba", 0.0) / run["stage_frames"]
