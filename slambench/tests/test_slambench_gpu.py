"""On the card, at each cell's own size: the control (the program with
TF32 switched on, the step below the configurations' float32 with TF32
off) and every planted fault must come out not correct. Each run prints
its readings as one JSON line on standard error. Run with ``python -m
pytest slambench/tests -m gpu -s``."""

import json
import sys
import time

import pytest
import torch

from slambench.run import BENCH_CELLS, load_cell, run_cell
from slambench.tests import faults

SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


def _run(cell, seed, label, **kw):
    """One run of ``cell``: a window of 6 s for a fault in the tracked
    step; the whole ``run_seconds`` where the keyframe BA must be caught
    (the control and the BA fault: the hovering rig's BA is rare)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = load_cell(cell)
    seconds = 6 if label in {f.__name__ for f in faults.STEP_FAULTS} | {
        "later_poses_altered"} else c["bench"]["run_seconds"]
    r = run_cell(c, seed, seconds, False, t_start=time.perf_counter(), **kw)
    print(json.dumps({"cell": cell, "seed": seed, "control": label,
                      "correct": r["correct"], "checks": r["checks"]}),
          file=sys.stderr, flush=True)
    return r


def _fails_a_number(r) -> bool:
    """Not correct, through a compared number over its limit (not only
    through a window that held too little to compare)."""
    return not r["correct"] and any(
        c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_tf32_control_is_not_correct(cell, seed):
    assert _fails_a_number(_run(cell, seed, "tf32", program_tf32=True))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", faults.STEP_FAULTS + [faults.ba_unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_planted_fault_is_not_correct(cell, fault, seed, monkeypatch):
    if fault is faults.ba_unchanged:
        fault(monkeypatch)
    else:
        faults.plant(monkeypatch, fault)
    assert _fails_a_number(_run(cell, seed, fault.__name__))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [c for c in BENCH_CELLS
                                  if load_cell(c)["traffic"]["engine"]
                                  ["chunk"] > 1])
def test_later_poses_altered_is_not_correct(cell, seed, monkeypatch):
    faults.later_poses_altered(monkeypatch)
    r = _run(cell, seed, "later_poses_altered")
    assert _fails_a_number(r)
