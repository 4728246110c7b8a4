"""Shared by the readers of the program's spans. The harness hands the
readers no span table, so they read the program's own
(``coslam_torch.spans``) in-process; a program without it, or without its
per-call rows, reads nothing.

The rows read are ``engine.frame``'s, one a ``process_frame`` call, in
the window outside the profiled slice, as the harness runs a cell: the
traffic's ``warm_frames`` calls come before the window (the bootstrap
first), and the slice is the calls closed under the profiler with the
``chunk`` calls before them (the profiler's warm-up steps), as
``run["stage"]`` leaves them out."""

import sys

FRAME = "engine.frame"


def window(run):
    """({name: [calls, host_s, self_s]} summed over the rows, the number
    of rows), or None."""
    spans = sys.modules.get("coslam_torch.spans")
    if spans is None or not hasattr(spans, "history"):
        return None
    traffic = run["traffic"]
    warm, chunk = traffic["warm_frames"], traffic["engine"]["chunk"]
    rows = [r for r in spans.history() if r.name == FRAME]
    if not rows or rows[0].n > warm:        # the window's first rows lost
        return None
    rows = [r for r in rows if r.n >= warm]
    traced = [i for i, r in enumerate(rows) if r.traced]
    if traced:
        rows = rows[:max(0, traced[0] - chunk)] + rows[traced[-1] + 1:]
    if not rows:
        return None
    table = {}
    for r in rows:
        for name, (c, h, s) in r.table.items():
            t = table.setdefault(name, [0, 0.0, 0.0])
            t[0] += c
            t[1] += h
            t[2] += s
    return table, len(rows)
