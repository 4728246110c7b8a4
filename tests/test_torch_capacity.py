"""Long-run stability under a tiny map-point budget, on the port's engine
(the port copy of tests/test_capacity.py): the fixed-capacity slot table
must keep reclaiming false/dead slots (lifecycle_update + generation
bumps) so mapping never starves."""

import dataclasses

import numpy as np
import pytest

from coslam_torch.config import small_test_config
from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                       render_batch)
from coslam_torch.slam.pipeline import CoSlamEngine
from coslam_torch.slam.state import ST_ALIVE

pytestmark = pytest.mark.slow

H, W = 150, 200
KMAT = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]],
                dtype=np.float32)


def test_map_capacity_pressure():
    cfg = small_test_config(num_cameras=1, h=H, w=W)
    cfg = cfg.replace(cap=dataclasses.replace(cfg.cap, max_map_points=128))
    kc = np.zeros((1, 5), dtype=np.float32)
    planes = make_room(np.random.default_rng(0), size=10.0)
    F = 50
    Rs_gt, ts_gt = orbit_trajectory(F, forward=0.06)
    frames = render_batch(planes, KMAT[0], Rs_gt, ts_gt, H, W, device="cpu")
    eng = CoSlamEngine(cfg, KMAT, kc, device="cpu")
    late_allocs = 0
    for f in range(F):
        stats = eng.process_frame(frames[f][None])
        if f > 25:
            late_allocs += int(stats.get("n_new_points", 0))
    mp = eng.state.mappts
    status = mp.status.numpy()
    assert (status == ST_ALIVE).sum() <= 128
    assert np.isfinite(mp.xyz.numpy()).all()
    # tracking survived capacity pressure
    assert eng.stats_log[-1]["n_inliers"][0] > 20
    # generation counter advanced: slots were actually recycled
    assert int(mp.gen.max()) >= 1
