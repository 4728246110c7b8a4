"""A tiny cell for the CPU tests: the benchmark's traffic at 150x200 on
two cameras, with the port's small test capacities."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

CONFIG = {
    "name": "tiny", "num_cameras": 2, "image_height": 150, "image_width": 200,
    "focal": 150.0, "principal_point": [100.0, 75.0],
    "distortion": [0.0] * 5,
    "klt": {"n_levels": 3, "min_cornerness": 100.0, "min_distance": 5},
    "cap": {"max_cameras": 2, "max_features": 128, "max_map_points": 1024,
            "max_keyframes": 16, "ba_window": 6, "max_obs_per_ba": 2048},
    "p": {"min_feat_track_len": 5, "num_act_frames": 50,
          "classify_frame_window": 20, "min_static_for_ok": 15,
          "min_static_cover": 0.12, "merge_min_interval": 15},
}


def cell(traffic: str = "live", frames: int = 40, warm: int = 10,
         check=None) -> dict:
    """The tiny cell under the named traffic mix of the benchmark."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    with open(ROOT / "slambench" / "traffic" / f"{traffic}.json") as f:
        tr = json.load(f)
    tr = copy.deepcopy(tr)
    tr["frames"] = frames
    tr["warm_frames"] = warm + (1 if tr["engine"]["chunk"] > 1 else 0)
    tr["check"] = check or {"every": 1, "steps": 3, "ba": 2}
    return {"bench": bench, "config": copy.deepcopy(CONFIG), "traffic": tr,
            "workload": {"name": f"tiny.{traffic}", "config": "tiny",
                         "traffic": traffic, "chips": 1}}
