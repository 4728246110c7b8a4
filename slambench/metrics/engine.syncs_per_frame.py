"""Synchronizing calls of the program per rig frame completed in the
window (``syncs.SyncCounter``: the debug mode's reports plus the port's
explicit ``torch.cuda.synchronize()``)."""


def read(run):
    s = run["syncs"]
    if s is None or not run["completed"]:
        return None
    return (s["total"] + s["explicit"]) / run["completed"]
