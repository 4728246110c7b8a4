"""Host milliseconds of one keyframe BA (the span ``ba.run``, what the
stage clock's ``timing["ba"]`` covers, which ends in a host read) in the
window outside the profiled slice; None when no BA ran there."""

from slambench.metrics._spans import window


def read(run):
    got = window(run)
    if got is None or "ba.run" not in got[0]:
        return None
    calls, host_s, _ = got[0]["ba.run"]
    return 1e3 * host_s / calls
