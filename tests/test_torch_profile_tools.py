"""The timing tools (``coslam_torch/examples/profile_*.py``) against the
JAX package on the CPU, at a small size: 2 cameras at 96x128 with 3 KLT
levels and 128 features for the fused step's stages, a BA of 5 cameras x
256 points, the engine scene at 150x200.

Each tool's inputs are held against the reference tool's construction
(``examples/profile_*.py``, restated here with the JAX package's
functions) and its timed computations against the JAX package's on the
same inputs. Tolerances, and why:
- the BA problem: indices, translations and points exactly, rotations
  to 1e-6 (the port draws them with the numpy Rodrigues, ``so3_exp_np``,
  the reference with ``so3_exp`` in float32) and so the pixels they
  project to 1e-4 px (one float32 step at 512 px); normal terms to 1e-4
  of each term's largest magnitude, the Schur step's camera part to 1e-4
  and its point part to 1e-3 of the scene depth (10 units), the solved
  cost to 1e-3 relative (float32, sums reordered, ``index_add_`` for
  ``segment_sum``; the bands of tests/test_torch_solvers.py: at this
  size the reduced camera system is ill-conditioned, and the two float32
  solves of the same terms are 4.6e-5 and 2.4e-4 apart from a float64
  solve in the camera part, 6.0e-4 and 1.4e-3 in the point part); the
  solve's poses and its points seen from two cameras to the same bands,
  its cost as the comment there says;
- the ablation variants: pyramids to 1e-3 (filters), track tables with at
  most 0.5% of the features flipping at a KLT threshold (the ROADMAP's
  "KLT loop") and positions to 1e-3 px, poses to 1e-4 (the pose-update
  band of tests/test_torch_engine.py), map tables equal;
- the stages' inputs to 1e-4 grey (one blur in another summation order);
- the engine scene: the uint8 frames equal on 99% of the pixels and off
  by at most 1 elsewhere (the two renders are <= 0.005 grey apart and a
  value on an integer boundary truncates either way)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(C=2, H=96, W=128, n_levels=3, max_features=128)


def jax_config(C, H, W, n_levels, max_features):
    from coslam_tpu.config import CapacityConfig, KLTConfig, SlamConfig
    return SlamConfig(
        num_cameras=C, image_height=H, image_width=W,
        klt=KLTConfig(n_levels=n_levels),
        cap=CapacityConfig(max_features=max_features, max_map_points=8192,
                           max_keyframes=64, ba_window=5))


# ------------------------------------------------------------ BA -------

def jax_ba_problem(M, n_points):
    """examples/profile_ba.py:32-57, at M cameras and ``n_points``."""
    from coslam_tpu.geometry.se3 import so3_exp
    from coslam_tpu.solvers.ba import BAProblem
    rng = np.random.default_rng(0)
    Ppts = n_points
    W, H = 640, 480
    K1 = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                  np.float32)
    Xw = rng.uniform(-4, 4, (Ppts, 3)).astype(np.float32)
    Xw[:, 2] += 10
    Rb = np.stack([np.asarray(so3_exp(jnp.asarray(
        0.05 * rng.standard_normal(3).astype(np.float32))))
        for _ in range(M)])
    tb = np.stack([np.array([0.2 * m, 0, 0], np.float32) for m in range(M)])
    oc = rng.integers(0, M, 3 * Ppts).astype(np.int32)
    op = np.tile(np.arange(Ppts), 3).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", Rb[oc], Xw[op]) + tb[oc]
    px = (Xc[:, :2] / Xc[:, 2:3] * 500 + [W / 2, H / 2]).astype(np.float32)
    cam_fixed = np.zeros(M, bool)
    cam_fixed[:2] = True
    return BAProblem(
        K=jnp.broadcast_to(jnp.asarray(K1)[None], (M, 3, 3)),
        R=jnp.asarray(Rb), t=jnp.asarray(tb), X=jnp.asarray(Xw + 0.05),
        obs_cam=jnp.asarray(oc), obs_pt=jnp.asarray(op),
        obs_px=jnp.asarray(px), obs_valid=jnp.ones(len(oc), bool),
        cam_fixed=jnp.asarray(cam_fixed),
        point_fixed=jnp.zeros(Ppts, bool))


def test_profile_ba_against_the_jax_solver():
    from coslam_tpu.solvers.ba import (_ba_normal_terms, _schur_solve,
                                       bundle_adjust)
    from coslam_torch.examples import profile_ba as pb
    M, P = 5, 256
    jp = jax_ba_problem(M, P)
    tpb = pb.bench_problem(M, P, "cpu")
    for f in ("K", "t", "X", "obs_cam", "obs_pt", "obs_valid", "cam_fixed",
              "point_fixed"):
        np.testing.assert_array_equal(tp.n(getattr(tpb, f)),
                                      np.asarray(getattr(jp, f)), f)
    np.testing.assert_allclose(tp.n(tpb.R), np.asarray(jp.R), atol=1e-6)
    # the pixels are the points projected by those rotations: one float32
    # step at 512 px (6.1e-5) where a rotation entry differs
    np.testing.assert_allclose(tp.n(tpb.obs_px), np.asarray(jp.obs_px),
                               atol=1e-4)

    # the timed quantities, both packages on the reference's arrays
    tprob = tpb._replace(R=tp.t(np.asarray(jp.R)))
    w = jp.obs_valid.astype(jnp.float32)
    jterms = _ba_normal_terms(jp.K, jp.R, jp.t, jp.X, jp, w, None)
    tterms = pb.normal_terms(tprob, tprob.X)
    for k, (a, b) in enumerate(zip(tterms, jterms)):
        b = np.asarray(b)
        np.testing.assert_allclose(tp.n(a), b, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"term {k}")
    Hcc, Wcp, Hpp, gc, gp, _ = jterms
    jdc, jdX = _schur_solve(Hcc, Wcp, Hpp, gc, gp,
                            jnp.asarray(1e-4, jnp.float32), jp.cam_fixed,
                            jp.point_fixed)
    sterms = tuple(tp.t(np.asarray(a)) for a in jterms)
    tdc, tdX = pb.schur_step(tprob, sterms, sterms[3])
    depth = float(np.median(np.asarray(jp.X)[:, 2]))
    np.testing.assert_allclose(tp.n(tdc), np.asarray(jdc),
                               atol=1e-4 * depth)
    np.testing.assert_allclose(tp.n(tdX), np.asarray(jdX),
                               atol=1e-3 * depth)
    jres = bundle_adjust(jp, max_err=10.0, max_iter=2, inner_iter=5)
    tres = pb.solve(tprob, inner_iter=5)
    # the problem is noise-free: both solves end on float32's floor, where
    # the costs agree to 1e-3 of the larger of the cost and 1e-6 of the
    # starting one
    c0, jc, tc = float(jterms[5]), float(jres.cost), float(tres.cost)
    assert abs(tc - jc) <= 1e-3 * max(jc, 1e-6 * c0), (tc, jc, c0)
    np.testing.assert_allclose(tp.n(tres.R), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(tres.t), np.asarray(jres.t),
                               atol=1e-4 * depth)
    oc = np.asarray(jp.obs_cam).reshape(3, P)
    two_views = (oc != oc[0]).any(0)
    np.testing.assert_allclose(tp.n(tres.X)[two_views],
                               np.asarray(jres.X)[two_views],
                               atol=1e-3 * depth)

    out = pb.run(iters=1, M=M, n_points=P, inner_iter=5, reps=1,
                 device="cpu")
    for k in ("normal_terms_ms", "schur_solve_ms", "bundle_adjust_ms",
              "lm_iters_per_s"):
        assert np.isfinite(out[k]) and out[k] > 0, k


# -------------------------------------------------- stages, ablation ---

def test_sol_bytes_is_the_reference_formula():
    """``sol_bytes`` at the production shape against the assignments of
    examples/profile_ablate.py, evaluated from its source."""
    from coslam_torch.examples.profile_ablate import sol_bytes
    from coslam_torch.examples.profile_stages import bench_config
    src = (REPO / "examples" / "profile_ablate.py").read_text()
    main = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = {"N", "P", "T", "L", "win", "lvl_px", "sol_bytes"}
    C, H, W = 3, 480, 640
    env = {"C": C, "H": H, "W": W, "cfg": jax_config(C, H, W, 4, 1024)}
    for node in main.body:
        target = node.targets[0] if isinstance(node, ast.Assign) else None
        if isinstance(target, ast.Name) and target.id in names:
            exec(compile(ast.Module([node], []), "profile_ablate", "exec"),
                 env)
    want = env["sol_bytes"]
    got = sol_bytes(bench_config(C, H, W), C, H, W)
    assert got == want
    assert all(isinstance(v, int) for v in got.values())


@pytest.fixture(scope="module")
def jax_stage_inputs():
    """examples/profile_stages.py:36-54 (and profile_ablate's), at the
    small size: the frames, K, kc, the populated state and pyramid (numpy
    trees) after one fused step. The step is the JAX package's stages as
    ``frame_step`` composes them (coslam_tpu/slam/fused.py:70-131, without
    its statistics; equal to its state bit for bit here), so that the
    ablation's variants reuse their compiled programs."""
    from coslam_tpu.ops import build_pyramid
    from coslam_tpu.ops.image import gaussian_blur
    from coslam_tpu.slam import steps
    from coslam_tpu.slam.classify import (classify_map_points,
                                          detect_dynamic_features)
    from coslam_tpu.slam.state import init_state
    C, H, W = SMALL["C"], SMALL["H"], SMALL["W"]
    cfg = jax_config(**SMALL)
    state = init_state(cfg)
    rng = np.random.default_rng(0)
    base = jnp.asarray(rng.uniform(0, 255, (C, H, W)), jnp.float32)
    imgs_prev = gaussian_blur(gaussian_blur(base))
    imgs_cur = jnp.roll(imgs_prev, 2, axis=-1)
    K = jnp.asarray(np.broadcast_to(
        np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                 dtype=np.float32), (C, 3, 3)))
    kc = jnp.zeros((C, 5), jnp.float32)
    pyr_prev = build_pyramid(imgs_prev, cfg.klt.n_levels)
    # state, pyr0, _ = frame_step(state, pyr0, imgs_cur, K, kc, cfg)
    pyr0 = build_pyramid(imgs_cur, cfg.klt.n_levels)
    tracks = steps.advance_tracks(pyr_prev, pyr0, state.tracks, K, kc,
                                  state.frame + 1, cfg)
    state = state._replace(tracks=tracks, frame=state.frame + 1)
    po = steps.pose_update(state, K, kc, (H, W), cfg)
    state = state._replace(R=po.R, t=po.t, tracks=po.tracks,
                           mappts=po.mappts)
    state = steps.push_pose_history(state)
    state = detect_dynamic_features(state, K, cfg)
    cls = classify_map_points(state, K, cfg)
    state = state._replace(mappts=cls.mappts, tracks=cls.tracks)
    mappts, tracks2, _ = steps.new_map_points(state, pyr0, K, kc, cfg)
    mappts = steps.lifecycle_update(mappts, state.frame, cfg)
    state = state._replace(mappts=mappts, tracks=tracks2)
    return dict(cfg=cfg, imgs_prev=np.asarray(imgs_prev),
                imgs_cur=np.asarray(imgs_cur), K=np.asarray(K),
                kc=np.asarray(kc), state=tp.to_numpy(state),
                pyr0=tp.to_numpy(pyr0))


def test_profile_stages_inputs_and_run(jax_stage_inputs):
    from coslam_torch.examples import profile_stages as ps
    ref = jax_stage_inputs
    inp = ps.stage_inputs(**SMALL, device="cpu")
    for f in ("imgs_prev", "imgs_cur", "K", "kc"):
        np.testing.assert_allclose(tp.n(getattr(inp, f)), ref[f], atol=1e-4,
                                   err_msg=f)
    out = ps.run(iters=1, **SMALL, device="cpu")
    assert tuple(out["ms"]) == ps.STAGES
    assert all(np.isfinite(v) and v > 0 for v in out["ms"].values())
    assert np.isfinite(out["fused_fps"]) and out["sum_ms"] > 0
    # the CPU takes the kernels' plain versions: nothing is launched
    assert not any(n for stage in out["launches"].values()
                   for n in stage.values())


def jax_variants(ref):
    """examples/profile_ablate.py:58-89 with the JAX package's stages,
    from the start state: the (state, pyr_cur) after each of the six
    cumulative variants, as numpy trees."""
    from coslam_tpu.ops import build_pyramid
    from coslam_tpu.slam import steps
    from coslam_tpu.slam.classify import (classify_map_points,
                                          detect_dynamic_features)
    cfg = ref["cfg"]
    K, kc = jnp.asarray(ref["K"]), jnp.asarray(ref["kc"])
    img_hw = ref["imgs_cur"].shape[-2:]
    state = jax.tree.map(jnp.asarray, ref["state"])
    pyr_prev = jax.tree.map(jnp.asarray, ref["pyr0"])
    out = []
    pyr_cur = build_pyramid(jnp.asarray(ref["imgs_cur"]) + state.t[0, 0],
                            cfg.klt.n_levels)
    out.append((state, pyr_cur))
    tracks = steps.advance_tracks(pyr_prev, pyr_cur, state.tracks, K,
                                  kc, state.frame + 1, cfg)
    state = state._replace(tracks=tracks, frame=state.frame + 1)
    out.append((state, pyr_cur))
    po = steps.pose_update(state, K, kc, tuple(img_hw), cfg)
    state = state._replace(R=po.R, t=po.t, tracks=po.tracks,
                           mappts=po.mappts)
    state = steps.push_pose_history(state)
    out.append((state, pyr_cur))
    state = detect_dynamic_features(state, K, cfg)
    out.append((state, pyr_cur))
    cls = classify_map_points(state, K, cfg)
    state = state._replace(mappts=cls.mappts)
    out.append((state, pyr_cur))
    mappts, tracks2, _ = steps.new_map_points(state, pyr_cur, K, kc, cfg)
    state = state._replace(mappts=mappts, tracks=tracks2)
    out.append((state, pyr_cur))
    return [tp.to_numpy(o) for o in out]


def assert_tracks_agree(jt, tt, max_flips, name):
    """A JAX track table against the port's: at most ``max_flips`` slots
    whose validity differs, positions and history to 1e-3 px and the
    integer fields equal where both are valid."""
    jv, tv = jt.valid, tp.n(tt.valid)
    assert (jv != tv).sum() <= max_flips, name
    both = jv & tv
    for f in ("pos", "raw"):
        np.testing.assert_allclose(tp.n(getattr(tt, f))[both],
                                   getattr(jt, f)[both], atol=1e-3,
                                   err_msg=f"{name}: {f}")
    for f in ("age", "dyn_votes", "mpt"):
        np.testing.assert_array_equal(tp.n(getattr(tt, f))[both],
                                      getattr(jt, f)[both],
                                      err_msg=f"{name}: {f}")
    hb = jt.hist_valid & tp.n(tt.hist_valid)
    assert (jt.hist_valid != tp.n(tt.hist_valid)).sum() <= \
        max_flips * jt.hist_valid.shape[1], name
    np.testing.assert_allclose(tp.n(tt.hist)[hb], jt.hist[hb], atol=1e-3,
                               err_msg=f"{name}: hist")


def test_ablation_variants_match_the_jax_stages(jax_stage_inputs):
    from coslam_torch.examples import profile_ablate as pa
    from coslam_torch.examples import profile_stages as ps
    from coslam_torch.slam.state import state_from_numpy
    ref = jax_stage_inputs
    want = jax_variants(ref)
    state0 = state_from_numpy(ref["state"], "cpu")
    pyr0 = tp.pyramid_to_torch(ref["pyr0"])
    inp = ps.stage_inputs(**SMALL, device="cpu")._replace(
        imgs_cur=tp.t(ref["imgs_cur"]), K=tp.t(ref["K"]), kc=tp.t(ref["kc"]))
    C, N = ref["state"].tracks.valid.shape
    flips = max(1, int(0.005 * C * N))
    # the reference's twice-blurred noise clears the cornerness floor at
    # few corners: 5 a camera at this size (202 of 1024 at 480x640)
    assert (ref["state"].tracks.valid.sum(1) >= 5).all()
    for upto, name in enumerate(pa.VARIANTS):
        got_st, got_pyr = pa.variant(state0, pyr0, upto, inp)
        want_st, want_pyr = want[upto]
        for f in ("imgs", "dxs", "dys"):
            for lv in range(len(getattr(want_pyr, f))):
                np.testing.assert_allclose(
                    tp.n(getattr(got_pyr, f)[lv]),
                    np.asarray(getattr(want_pyr, f)[lv]), atol=1e-3,
                    err_msg=f"{name}: {f}[{lv}]")
        assert int(got_st.frame) == int(want_st.frame), name
        assert_tracks_agree(want_st.tracks, got_st.tracks, flips, name)
        for f in ("R", "t", "pose_hist_R", "pose_hist_t"):
            np.testing.assert_allclose(tp.n(getattr(got_st, f)),
                                       getattr(want_st, f), atol=1e-4,
                                       err_msg=f"{name}: {f}")
        for f in ("status", "ptype", "owner", "last_obs"):
            np.testing.assert_array_equal(
                tp.n(getattr(got_st.mappts, f)),
                getattr(want_st.mappts, f), err_msg=f"{name}: {f}")
        alive = want_st.mappts.status == 1
        np.testing.assert_allclose(tp.n(got_st.mappts.xyz)[alive],
                                   want_st.mappts.xyz[alive], atol=1e-3)
    out = pa.run(iters=1, **SMALL, device="cpu")
    assert [r["name"] for r in out["rows"]] == list(pa.VARIANTS)
    for r in out["rows"]:
        assert np.isfinite(r["wall_ms"]) and r["wall_ms"] > 0
        assert r["busy_ms"] is None and r["delta_ms"] == r["wall_delta_ms"]


# ------------------------------------------------------------ engine ---

def test_profile_engine_scene_and_run():
    from coslam_tpu.io.synthetic import (make_room, multi_cam_rig,
                                         orbit_trajectory, render)
    from coslam_torch.config import small_test_config
    from coslam_torch.examples import profile_engine as pe
    C, H, W, F = 3, tp.H, tp.W, 4
    got, Kb = pe.scene(F, C, H, W, "cpu")
    # examples/profile_engine.py:44-58 at 150x200
    rng = np.random.default_rng(0)
    planes = make_room(rng, size=10.0)
    Rr, tr = orbit_trajectory(F, forward=0.05)
    rot_c, offs_c = multi_cam_rig(C, baseline=1.0)
    frames = np.zeros((F, C, H, W), np.float32)
    for f in range(F):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(C):
            center = c_rig + Rr[f].T @ offs_c[c]
            Rc = rot_c[c] @ Rr[f]
            frames[f, c] = np.asarray(render(
                planes, Kb[c], Rc, -Rc @ center, H, W))
    want = np.clip(frames, 0, 255).astype(np.uint8)
    diff = np.abs(tp.n(got).astype(int) - want.astype(int))
    assert got.dtype == torch.uint8 and diff.max() <= 1
    assert (diff == 0).mean() >= 0.99

    out = pe.run(frames=26, H=H, W=W, cfg=small_test_config(C, H, W),
                 device="cpu")
    assert len(out["per_frame_ms"]) == 26 - pe.WARM
    assert np.isfinite(out["fps"]) and out["fps"] > 0
    assert "core_fused" in out["timing"]
    assert all(np.isfinite(v) for v in out["timing"].values())


# ------------------------------------------------------ the card rule ---

@pytest.mark.parametrize("tool", ["profile_stages", "profile_ablate",
                                  "profile_ba", "profile_engine"])
def test_tools_need_a_card_or_the_cpu_flag(monkeypatch, tool):
    import importlib
    mod = importlib.import_module(f"coslam_torch.examples.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--iters", "1"] if tool != "profile_engine"
                 else ["--frames", "21"])
