"""The engine's own stage clock for the fused tracked step
(``timing["core_fused"]``, or ``timing["core_chunk"]`` in chunk mode) per
rig frame, outside the profiled slice: the step's host enqueue time."""


def read(run):
    key = "core_chunk" if run["traffic"]["engine"]["chunk"] > 1 \
        else "core_fused"
    if not run["stage_frames"] or key not in run["stage"]:
        return None
    return 1e3 * run["stage"][key] / run["stage_frames"]
