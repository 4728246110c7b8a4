"""The port's I/O surface against the JAX package's, on the CPU:
calibration and input files, the native frame loader, the batched and
distorted renders, result export, visualization and the CLI.

Bands: ``render_batch`` within 0.02 grey levels of the JAX render (the
band of tests/test_torch_io.py: float32 rounding of the ray-plane
arithmetic); ``apply_distortion_warp`` within 0.005 grey levels of the
JAX warp on the same image (the 8-round undistortion rounds differently
in float32, which moves a sample point by ~1e-5 px; measured 9.5e-4);
exported poses within 2e-6 of the JAX export of the same state (the
chain pose graph is solved by each package's own linear algebra; the
files print 8 decimals); loader frames, calibration files, map points,
feature files and input_videos.txt equal."""

import hashlib
import os

import numpy as np
import pytest
import torch

import torch_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KSMALL = np.array([[[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]]], np.float32)


# ---------------------------------------------------------------- calib
def test_calib_and_input_files_match_jax(tmp_path):
    from coslam_tpu.io import calib as jc
    from coslam_torch.io import calib as tc
    K = np.array([[300.0, 0.1, 160], [0, 301.0, 120], [0, 0, 1]], np.float32)
    kc = np.array([-0.2, 0.05, 1e-3, -1e-3, 0.0], np.float32)
    jc.write_calib_file(str(tmp_path / "j.txt"), K, kc)
    tc.write_calib_file(str(tmp_path / "t.txt"), K, kc)
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "t.txt").read_bytes()
    for a, b in zip(jc.read_calib_file(str(tmp_path / "t.txt")),
                    tc.read_calib_file(str(tmp_path / "j.txt"))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    inp = tmp_path / "input.txt"
    inp.write_text("2 #number of sequences\n\n0 0 #skip / init\n5 10\n"
                   f"{tmp_path}/video1.avi #videos\n{tmp_path}/video2.csrw\n"
                   f"{tmp_path}/t.txt\n{tmp_path}/j.txt\n")
    assert tc.parse_input_file(str(inp)) == jc.parse_input_file(str(inp))
    assert tc.parse_input_file(str(inp)).skip_frames == [0, 5]
    (tmp_path / "bad.txt").write_text("2\n0 0\n")
    with pytest.raises(ValueError):
        tc.parse_input_file(str(tmp_path / "bad.txt"))


# ---------------------------------------------------------------- loader
def _write_seq(loader_mod, tmp_path, C=2, F=7, H=24, W=32, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for c in range(C):
        p = str(tmp_path / f"cam{c}.csrw")
        loader_mod.write_raw_sequence(
            p, rng.integers(0, 255, (F, H, W), dtype=np.uint8))
        paths.append(p)
    return paths


def _read_all(ld):
    out = np.stack(list(ld))
    ld.close()
    return out


@pytest.mark.parametrize("case", ["raw", "resize", "start_frames", "pgm"])
def test_loader_matches_jax(tmp_path, case):
    """The port's native loader yields the JAX loader's frames bit for
    bit, and the CSRW files the two write are the same bytes."""
    from coslam_tpu.io import loader as jl
    from coslam_torch.io import loader as tl
    if case == "pgm":
        rng = np.random.default_rng(1)
        frames = rng.integers(0, 255, (4, 20, 28), dtype=np.uint8)
        for i, fr in enumerate(frames):
            with open(tmp_path / f"img_{i:04d}.pgm", "wb") as f:
                f.write(b"P5\n# test\n28 20\n255\n" + fr.tobytes())
        args = ([str(tmp_path / "img_%04d.pgm")],)
        kw = dict(mode=tl.MODE_PGM)
    else:
        paths = _write_seq(tl, tmp_path)
        jl.write_raw_sequence(str(tmp_path / "j.csrw"),
                              np.full((2, 3, 4), 7, np.uint8))
        tl.write_raw_sequence(str(tmp_path / "t.csrw"),
                              np.full((2, 3, 4), 7, np.uint8))
        assert (tmp_path / "j.csrw").read_bytes() == \
            (tmp_path / "t.csrw").read_bytes()
        args = (paths,)
        kw = {"raw": {}, "resize": dict(out_hw=(12, 16)),
              "start_frames": dict(start_frames=[2, 4])}[case]
    ld = tl.FrameLoader(*args, **kw)
    assert ld.native
    hw = ld.hw
    got = _read_all(ld)
    ref = jl.FrameLoader(*args, **kw)
    assert ref.hw == hw
    want = _read_all(ref)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    n_frames = {"raw": 7, "resize": 7, "start_frames": 3, "pgm": 4}[case]
    assert got.shape[0] == n_frames


def test_loader_python_fallback_reads_the_same(tmp_path, monkeypatch):
    """Without g++ the loader falls back to the reference's Python reader
    of raw files: the same frames, start frames and nearest resize."""
    from coslam_torch.io import loader as tl
    paths = _write_seq(tl, tmp_path)
    native = _read_all(tl.FrameLoader(paths, start_frames=[1, 3]))
    monkeypatch.setattr(tl, "_lib", None)
    monkeypatch.setattr(tl, "_build_native", lambda: None)
    ld = tl.FrameLoader(paths, start_frames=[1, 3])
    assert not ld.native
    np.testing.assert_array_equal(_read_all(ld), native)
    with pytest.raises(IOError):
        tl.FrameLoader([str(tmp_path / "img_%04d.pgm")], mode=tl.MODE_PGM)


def test_loader_builds_outside_native(tmp_path):
    """The port compiles native/frameloader.cpp into build/<hash>/ and
    leaves the committed native/libframeloader.so as it was."""
    from coslam_torch.io import loader as tl
    from coslam_torch.util import BUILD_ROOT
    so = os.path.join(REPO, "native", "libframeloader.so")

    def digest():
        with open(so, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest(), os.stat(so).st_mtime
    before = digest()
    lib_path = tl.library_path()
    assert lib_path.parent.parent == BUILD_ROOT
    built = tl._build_native()
    assert built == lib_path and lib_path.exists()
    assert tl.native_lib() is not None
    assert digest() == before


# ---------------------------------------------------------------- render
def _quad_scene():
    from coslam_tpu.io import synthetic as js
    rng = np.random.default_rng(0)
    quad = js.MovingQuad(center0=np.array([-1.0, 0.5, 8.0], np.float32),
                         velocity=np.array([0.05, 0.0, 0.0], np.float32),
                         eu=np.array([1.6, 0, 0], np.float32),
                         ev=np.array([0, 1.6, 0], np.float32),
                         tex=js.make_texture(rng))
    planes = js.make_room(rng, size=10.0)
    Rs, ts = js.orbit_trajectory(11, forward=0.3, yaw_rate=0.05)
    K = np.array([[90.0, 0, 50], [0, 90.0, 30], [0, 0, 1]], np.float32)
    return planes, quad, Rs, ts, K


@pytest.mark.parametrize("quads,frames,chunk", [
    (False, None, 8), (True, None, 4),
    (True, [0, 3, 5, 7, 9, 11, 2, 4, 6, 8, 10], 3)])
def test_render_batch_matches_jax(quads, frames, chunk):
    from coslam_tpu.io import synthetic as js
    from coslam_torch.io import synthetic as ts
    planes, quad, Rs, tt, K = _quad_scene()
    q = [quad] if quads else None
    fr = None if frames is None else np.asarray(frames)
    want = np.asarray(js.render_batch(planes, K, Rs, tt, 60, 100, quads=q,
                                      frames=fr, chunk=chunk))
    got = tp.n(ts.render_batch(planes, K, Rs, tt, 60, 100, quads=q,
                               frames=fr, chunk=chunk, device="cpu"))
    assert got.shape == want.shape == (11, 60, 100)
    assert np.abs(got - want).max() <= 0.02
    one = tp.n(ts.render_sequence(planes, K, Rs, tt, 60, 100, quads=q,
                                  frames=fr, device="cpu"))
    np.testing.assert_array_equal(got, one)


def test_apply_distortion_warp_matches_jax():
    import jax.numpy as jnp
    from coslam_tpu.io import synthetic as js
    from coslam_torch.io import synthetic as ts
    planes, quad, Rs, tt, K = _quad_scene()
    imgs = np.asarray(js.render_batch(planes, K, Rs[:4], tt[:4], 60, 100,
                                      quads=[quad]))
    kc = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.0], np.float32)
    want = np.asarray(js.apply_distortion_warp(jnp.asarray(imgs), K, kc))
    got = tp.n(ts.apply_distortion_warp(tp.t(imgs), K, kc))
    assert got.shape == want.shape == (4, 60, 100)
    assert np.abs(got - want).max() <= 0.005
    want1 = np.asarray(js.apply_distortion_warp(jnp.asarray(imgs[2]), K,
                                                kc))
    got1 = tp.n(ts.apply_distortion_warp(tp.t(imgs[2]), K, kc))
    assert got1.shape == (60, 100)
    assert np.abs(got1 - want1).max() <= 0.005
    np.testing.assert_array_equal(got1, got[2])
    # no distortion: the warp samples every pixel at its own position, up
    # to float32 rounding of K^-1 then K (a border pixel may read its
    # neighbour: sample_bilinear clamps the support's origin and keeps the
    # unclamped fraction, as the JAX package's does)
    same = tp.n(ts.apply_distortion_warp(tp.t(imgs), K, np.zeros(5)))
    np.testing.assert_allclose(same[:, 1:-1, 1:-1], imgs[:, 1:-1, 1:-1],
                               atol=1e-3)


# ---------------------------------------------------------------- export
@pytest.fixture(scope="module")
def room_run(tmp_path_factory):
    """The port's engine over the 30-frame room of tests/test_io.py::
    test_checkpoint_roundtrip with log_features, its checkpoint, and a JAX
    engine restored from that checkpoint (the same state and logs)."""
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_tpu.io.checkpoint import load_checkpoint as jload
    from coslam_tpu.slam.pipeline import CoSlamEngine as JEngine
    from coslam_torch.config import small_test_config
    from coslam_torch.io.checkpoint import save_checkpoint
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.slam.pipeline import CoSlamEngine
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(30, forward=0.06)
    frames = tp.n(render_sequence(planes, KSMALL[0], Rs, ts, 120, 160,
                                  device="cpu"))
    eng = CoSlamEngine(small_test_config(1, 120, 160), KSMALL,
                       np.zeros((1, 5), np.float32), device="cpu",
                       log_features=True)
    for f in range(30):
        eng.process_frame(frames[f][None])
    root = tmp_path_factory.mktemp("room_run")
    ck = str(root / "ck.npz")
    save_checkpoint(ck, eng)
    jeng = JEngine(jcfg(1, 120, 160), KSMALL, np.zeros((1, 5), np.float32))
    jload(ck, jeng)
    return eng, jeng, frames, root


def _parse(path):
    with open(path) as f:
        return [[float(v) for v in ln.split()] for ln in f]


@pytest.mark.parametrize("feat_log", [True, False])
def test_export_matches_jax(room_run, tmp_path, feat_log):
    from coslam_tpu.io.export import export_results as jexport
    from coslam_torch.io.export import export_results, load_campose
    eng, jeng, _, _ = room_run
    jeng.feat_log = list(eng.feat_log) if feat_log else []
    saved = eng.feat_log
    if not feat_log:
        eng.feat_log = []
    try:
        export_results(str(tmp_path / "t"), eng, sources=["a.csrw"])
    finally:
        eng.feat_log = saved
    jexport(str(tmp_path / "j"), jeng, sources=["a.csrw"])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "0_campose.txt", "0_featpts.txt", "input_videos.txt", "mappts.txt"]
    for name in ("input_videos.txt", "0_featpts.txt"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    a, b = _parse(tmp_path / "t" / "mappts.txt"), \
        _parse(tmp_path / "j" / "mappts.txt")
    assert len(a) == len(b) > 50
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    a, b = _parse(tmp_path / "t" / "0_campose.txt"), \
        _parse(tmp_path / "j" / "0_campose.txt")
    assert len(a) == len(b) == 30
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    feats = _parse(tmp_path / "t" / "0_featpts.txt")
    frames_logged = sorted({int(r[0]) for r in feats})
    assert frames_logged == (list(range(10, 30)) if feat_log else [29])
    Rs, ts = load_campose(str(tmp_path / "t" / "0_campose.txt"))
    R0, t0 = eng.trajectory(0, correct=True)
    np.testing.assert_allclose(Rs, R0, atol=1e-7)
    np.testing.assert_allclose(ts, t0, atol=1e-7)


# ---------------------------------------------------------------- viz
def test_viz_writes_pngs(room_run, tmp_path):
    from coslam_torch.io.viz import (render_engine, render_export_dir,
                                     render_image_pane, render_scene)
    from coslam_torch.io.export import export_results
    eng, _, frames, _ = room_run
    render_engine(eng, str(tmp_path / "panes"), images=frames[-1][None])
    for name in ("scene.png", "cam0.png"):
        assert os.path.getsize(tmp_path / "panes" / name) > 10_000
    export_results(str(tmp_path / "res"), eng)
    render_export_dir(str(tmp_path / "res"), str(tmp_path / "from_dir.png"))
    assert os.path.getsize(tmp_path / "from_dir.png") > 10_000
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(300, 3)) * [3, 1, 3] + [0, 0, 8]
    traj = np.stack([np.linspace(0, 2, 40), np.zeros(40),
                     np.linspace(0, 1, 40)], -1)
    render_scene(str(tmp_path / "scene.png"), xyz,
                 rng.integers(0, 3, 300), [traj, traj + [0.5, 0, 0]],
                 group_id=np.array([0, 1]), cam_R=np.stack([np.eye(3)] * 2),
                 cam_t=np.array([[0, 0, 0], [0.5, 0, 0]]),
                 K=np.repeat(KSMALL, 2, 0), img_hw=(120, 160),
                 dyn_trajectories=[traj[:10] + [0, 1, 6]])
    px = rng.uniform(10, 110, (50, 2))
    render_image_pane(str(tmp_path / "pane.png"), frames[0], px,
                      rng.integers(0, 3, 50),
                      reproj_px=px + rng.normal(0, 3, px.shape))
    for name in ("scene.png", "pane.png"):
        assert os.path.getsize(tmp_path / name) > 10_000


# ---------------------------------------------------------------- CLI
def test_cli_end_to_end_on_csrw(tmp_path):
    """python -m coslam_torch.cli on reference-format input (CSRW videos,
    calibration files) at --cpu --small: the export parses."""
    from coslam_torch import cli
    from coslam_torch.io.calib import write_calib_file
    from coslam_torch.io.export import load_campose
    from coslam_torch.io.loader import write_raw_sequence
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_batch)
    F = 24
    planes = make_room(np.random.default_rng(3), size=10.0)
    Rs, ts = orbit_trajectory(F + 2, forward=0.05)
    frames = tp.n(render_batch(planes, KSMALL[0], Rs, ts, 120, 160,
                               device="cpu"))
    write_raw_sequence(str(tmp_path / "cam0.csrw"),
                       np.clip(frames, 0, 255).astype(np.uint8))
    write_calib_file(str(tmp_path / "cam0_calib.txt"), KSMALL[0],
                     np.zeros(5, np.float32))
    (tmp_path / "input.txt").write_text(
        f"1\n2 10\n{tmp_path / 'cam0.csrw'}\n"
        f"{tmp_path / 'cam0_calib.txt'}\n")
    out = tmp_path / "results"
    eng = cli.main([str(tmp_path / "input.txt"), "--out", str(out),
                    "--cpu", "--small"])
    assert eng.device.type == "cpu" and eng.frame == F
    Rs_out, ts_out = load_campose(str(out / "0_campose.txt"))
    assert Rs_out.shape == (F, 3, 3) and ts_out.shape == (F, 3)
    assert np.isfinite(Rs_out).all() and np.isfinite(ts_out).all()
    RtR = np.einsum("fij,fik->fjk", Rs_out, Rs_out)
    assert np.abs(RtR - np.eye(3)).max() < 1e-2
    centers = -np.einsum("fji,fj->fi", Rs_out, ts_out)
    assert np.linalg.norm(centers[-1] - centers[0]) > 0.01
    assert len(_parse(out / "mappts.txt")) > 0
    assert (out / "input_videos.txt").read_text() == \
        f"{tmp_path / 'cam0.csrw'}\n"
    eng = cli.main([str(tmp_path / "input.txt"), "--out", str(out),
                    "--cpu", "--small", "--frames", "12"])
    assert eng.frame == 12
