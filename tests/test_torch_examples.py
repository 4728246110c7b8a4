"""The port's small example entry points (``coslam_torch/examples``):
``run_synthetic`` on the CPU, the card-or-``--cpu`` rule of the entry
points, ``accuracy_bench.main`` writing its rows, and the viewer's PLY
against the one ``examples/visualize_results.py::write_ply`` writes from
the same export (byte for byte: the same numpy arithmetic and format)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp

REPO = Path(__file__).resolve().parents[1]


def test_run_synthetic_on_the_cpu():
    from coslam_torch.examples import run_synthetic
    assert run_synthetic.main(["--cpu", "--frames", "30"]) == 0


def test_entry_points_need_a_card_or_the_cpu_flag(monkeypatch, tmp_path):
    from coslam_torch.examples import accuracy_bench, run_synthetic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_synthetic.main(["--frames", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy_bench.main(["occlusion", "--small", "--out",
                             str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy_bench.config_mono(3, np.random.default_rng(7))
    assert not list(tmp_path.iterdir())


def test_accuracy_main_writes_its_rows(monkeypatch, tmp_path):
    from coslam_torch.config import small_test_config
    from coslam_torch.examples import accuracy_bench as ab
    monkeypatch.setattr(ab, "H", 120)
    monkeypatch.setattr(ab, "W", 160)
    monkeypatch.setattr(ab, "K1", np.array(
        [[125.0, 0, 80], [0, 125.0, 60], [0, 0, 1]], np.float32))
    monkeypatch.setattr(ab, "_cfg", lambda C: small_test_config(C, 120, 160))
    rows = ab.main(["mono", "--cpu", "--frames", "14", "--out",
                    str(tmp_path)])
    assert [r["config"] for r in rows] == ["mono"]
    assert rows[0]["frames"] == 14 and rows[0]["peak_mem_mib"] is None
    assert np.isfinite(rows[0]["ate_max"])
    with open(tmp_path / "ACCURACY.json") as f:
        assert json.load(f) == rows
    text = (tmp_path / "ACCURACY.md").read_text()
    assert "on `cpu`" in text and "| mono | 1 | 14 |" in text
    with pytest.raises(SystemExit):
        ab.main(["nonesuch", "--cpu", "--out", str(tmp_path)])


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """An export of the port's two-camera engine over 12 frames of the rig
    (150x200, on the CPU)."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.export import export_results
    from coslam_torch.slam.pipeline import CoSlamEngine
    frames, _, _ = tp.render_rig_frames(2, 12)
    eng = CoSlamEngine(small_test_config(2, tp.H, tp.W), *tp.kmats(2),
                       device="cpu")
    for f in range(frames.shape[0]):
        eng.process_frame(frames[f])
    out = tmp_path_factory.mktemp("export")
    export_results(str(out), eng)
    return out, len(eng.map_points()[0])


def _reference_viewer():
    spec = importlib.util.spec_from_file_location(
        "reference_visualize_results",
        REPO / "examples" / "visualize_results.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ply_equals_the_reference(export_dir, tmp_path, monkeypatch):
    from coslam_torch.examples import visualize_results as viewer
    d, n_pts = export_dir
    ref = _reference_viewer()
    ref.write_ply(str(tmp_path / "ref.ply"), *ref.load_results(str(d)))
    # without matplotlib (the card's machine) only the PLY is written
    monkeypatch.setattr(viewer.importlib.util, "find_spec",
                        lambda name: None)
    written = viewer.main([str(d), "--out", str(tmp_path / "port.ply")])
    assert written == [str(tmp_path / "port.ply")]
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "ref.ply").read_bytes()
    header = (tmp_path / "port.ply").read_text().split("end_header")[0]
    assert f"element vertex {n_pts + 2 * 8 * 11}" in header


def test_figures_where_matplotlib_imports(export_dir, tmp_path):
    pytest.importorskip("matplotlib")
    from coslam_torch.examples import visualize_results as viewer
    d, _ = export_dir
    written = viewer.main([str(d), "--out", str(tmp_path / "scene.ply")])
    assert [Path(w).name for w in written] == ["scene.ply", "scene.png",
                                               "scene_3d.png"]
    assert all(Path(w).stat().st_size > 0 for w in written)
