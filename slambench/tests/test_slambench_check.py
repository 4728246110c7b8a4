"""The harness on the CPU at a tiny size, with its look for a card
skipped: a sound run is correct, and a run whose tracked step is broken
underneath is not, for each fault a one-chip cell can have."""

import pytest

from slambench.run import run_cell
from slambench.tests import faults
from slambench.tests.tiny import cell

SEED = 2 ** 32 + 77


@pytest.mark.parametrize("traffic", ["live", "survey"])
def test_sound_run_is_correct(traffic):
    c = cell(traffic, frames=40, warm=12)
    r = run_cell(c, SEED, 0, False, device="cpu", max_frames=12)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 12 and r["failed"] == 0
    chain = {"pose_deg_chain", "pose_ctr_chain"} if traffic == "survey" \
        else set()
    assert set(r["checks"]) == {
        "pyr_abs", "klt_px", "pose_deg", "pose_ctr", "ptype_share",
        "ba_cost_median"} | chain, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("late", [1, 2])
def test_chunks_found_after_a_late_bootstrap(late, monkeypatch):
    """Chunk boundaries follow the engine, not the frame number: where the
    map's init fails on the first frames, the chunks start later, and the
    replay still meets the program's chunks."""
    from coslam_torch.slam.pipeline import CoSlamEngine
    real = CoSlamEngine._bootstrap_multicam
    calls = [0]

    def bootstrap(self, pyr):
        calls[0] += 1
        return calls[0] > late and real(self, pyr)
    monkeypatch.setattr(CoSlamEngine, "_bootstrap_multicam", bootstrap)
    r = run_cell(cell("survey", frames=40, warm=12), SEED, 0, False,
                 device="cpu", max_frames=12)
    assert calls[0] > late
    assert r["correct"], r["checks"]
    assert r["checks"]["pyr_abs"]["value"] == 0.0, r["checks"]


@pytest.mark.parametrize("fault", faults.STEP_FAULTS,
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("traffic", ["live", "survey"])
def test_broken_step_is_not_correct(traffic, fault, monkeypatch):
    faults.plant(monkeypatch, fault)
    r = run_cell(cell(traffic, frames=40, warm=12), SEED, 0, False,
                 device="cpu", max_frames=6 if traffic == "live" else 12)
    assert not r["correct"], r["checks"]


def test_chunk_with_later_poses_altered_is_not_correct(monkeypatch):
    faults.later_poses_altered(monkeypatch)
    r = run_cell(cell("survey", frames=40, warm=12), SEED, 0, False,
                 device="cpu", max_frames=12)
    c = r["checks"]
    assert c["pose_deg"]["value"] <= c["pose_deg"]["limit"], c
    assert c["pose_deg_chain"]["value"] > c["pose_deg_chain"]["limit"], c
    assert not r["correct"], c


def test_ba_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    faults.ba_unchanged(monkeypatch)
    r = run_cell(cell("live", frames=40, warm=12), SEED, 0, False,
                 device="cpu", max_frames=12)
    c = r["checks"]["ba_cost_median"]
    assert c["value"] > c["limit"], r["checks"]
    assert not r["correct"], r["checks"]
