"""Milliseconds per rig frame that the host waited on the card (the
program's ``engine.wait.*`` spans, around each of its blocking reads) in
the window outside the profiled slice."""

from slambench.metrics._spans import window


def read(run):
    got = window(run)
    if got is None:
        return None
    table, frames = got
    return 1e3 * sum(v[1] for n, v in table.items()
                     if n.startswith("engine.wait.")) / frames
