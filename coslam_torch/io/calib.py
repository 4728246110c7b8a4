"""Input-file and calibration-file parsing in the reference's format (the
port's own copy of ``coslam_tpu/io/calib.py``; files written by the two
packages are byte-identical).

Input txt (MyApp::parseInput, MyApp.cpp:139-196; README.md:91-105):
    <numView>
    <skip> <initFrames>      x numView   (per-camera skip / init counts)
    <video path>             x numView
    <calib path>             x numView
(comments after '#' and blank lines tolerated, as in the reference's
tokenizer which reads the first tokens of each non-empty line).

Calibration file (readIntrinDistParam; README.md:107-116):
    fx s cx
    0 fy cy
    0 0 1
    k0 k1 k2 k3 k4
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class InputSpec(NamedTuple):
    num_views: int
    skip_frames: list[int]
    init_frames: list[int]
    video_paths: list[str]
    calib_paths: list[str]


def _tokens(line: str) -> list[str]:
    return line.split("#", 1)[0].split()


def parse_input_file(path: str) -> InputSpec:
    with open(path) as f:
        toks = [t for t in (_tokens(ln) for ln in f) if t]
    if not toks:
        raise ValueError(f"empty input file {path}")
    n = int(toks[0][0])
    if n < 1 or len(toks) < 1 + 3 * n:
        raise ValueError(f"malformed input file {path}")
    rows = toks[1:]
    skips, inits = [], []
    for k in range(n):
        if len(rows[k]) != 2:
            raise ValueError(f"expected '<skip> <init>' on line {k + 2}")
        skips.append(int(rows[k][0]))
        inits.append(int(rows[k][1]))
    videos = [rows[n + k][0] for k in range(n)]
    calibs = [rows[2 * n + k][0] for k in range(n)]
    return InputSpec(n, skips, inits, videos, calibs)


def read_calib_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (K [3,3] f32, kc [5] f32)."""
    vals = []
    with open(path) as f:
        for ln in f:
            vals.extend(float(v) for v in _tokens(ln))
    if len(vals) < 14:
        raise ValueError(f"calibration file {path} needs 9 + 5 values")
    K = np.array(vals[:9], np.float32).reshape(3, 3)
    kc = np.array(vals[9:14], np.float32)
    return K, kc


def write_calib_file(path: str, K: np.ndarray, kc: np.ndarray):
    with open(path, "w") as f:
        for row in np.asarray(K).reshape(3, 3):
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
        f.write(" ".join(f"{v:.8f}" for v in np.asarray(kc).reshape(-1)[:5])
                + "\n")
