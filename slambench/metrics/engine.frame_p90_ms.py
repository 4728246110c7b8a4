"""90th percentile of ``process_frame``'s wall (the benchmark's clock) over
the window's calls outside the profiled slice. Live feeds only: there a
call returns with the frame's pose on the host."""

import numpy as np


def read(run):
    walls = run["walls_ms"]
    if run["traffic"]["engine"]["chunk"] > 1 or len(walls) < 10:
        return None
    return float(np.percentile(walls, 90))
