"""The multi-camera map init under the reference's lens distortion (the
distorted rig of ``examples/accuracy_bench.py::config_distorted``: three
cameras, k1 = -0.25, k2 = 0.08, at 240x320), port against the JAX
package, and the port's repair of it (ROADMAP.md, C3). Split from
tests/test_torch_multicam.py, whose other tests run on the two-camera rig:
these two render and initialize a scene of their own.

Tolerances, and why: the RANSAC draws differ between the packages
(``jax.random`` against a seeded ``torch.Generator``), so the inits are
handed the JAX package's draws where they are compared stage by stage,
and the repaired init is held to pose errors against the ground truth.
"""

import numpy as np
import jax.numpy as jnp
import torch

import torch_parity as tp


def _distorted_rig(n: int = 4):
    """Frames 0..n-1 of the reference's distorted rig (three cameras,
    k1 = -0.25, k2 = 0.08) at 240x320, f = 250: rendered, warped and
    quantized on the CPU. Returns K, K per camera, kc, the rig's
    rotations and translations [C, n, ...], the frames [n, C, H, W] and a
    config with 3 KLT levels and 256 features."""
    from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
    from coslam_torch.io.synthetic import (apply_distortion_warp, make_room,
                                           render_batch, rig_sequence)
    h, w, nc = 240, 320, 3
    K = np.array([[250.0, 0, w / 2], [0, 250.0, h / 2], [0, 0, 1]],
                 np.float32)
    KK = np.repeat(K[None], nc, 0)
    kc = np.zeros((nc, 5), np.float32)
    kc[:, 0], kc[:, 1] = -0.25, 0.08
    rng = np.random.default_rng(0)
    rng.uniform()
    planes = make_room(rng, size=10.0)
    Rs, ts = rig_sequence(nc, n, baseline=1.0, forward=0.04)
    views = render_batch(planes, K, Rs.transpose(1, 0, 2, 3).reshape(-1, 3, 3),
                         ts.transpose(1, 0, 2).reshape(-1, 3), h, w,
                         frames=np.repeat(np.arange(n), nc),
                         device="cpu").reshape(n, nc, h, w)
    frames = torch.stack([apply_distortion_warp(views[:, c], K, kc[c])
                          for c in range(nc)], 1).clamp(0, 255).round()
    cfg = SlamConfig(klt=KLTConfig(n_levels=3),
                     cap=CapacityConfig(max_features=256), num_cameras=nc,
                     image_height=h, image_width=w)
    return K, KK, kc, Rs, ts, frames, cfg


def _rig_errors(res, Rs, ts, f):
    """The init's relative rotation and baseline direction errors (deg) of
    cameras 1 and 2 against camera 0 at frame f."""
    out = []
    for b in (1, 2):
        Rg = Rs[b, f] @ Rs[0, f].T
        tg = ts[b, f] - Rg @ ts[0, f]
        Re = res.Rs[b] @ res.Rs[0].T
        te = res.ts[b] - Re @ res.ts[0]
        rot = np.degrees(np.arccos(np.clip(
            (np.trace(Re @ Rg.T) - 1) / 2, -1, 1)))
        dirn = np.degrees(np.arccos(np.clip(
            te @ tg / np.linalg.norm(te) / np.linalg.norm(tg), -1, 1)))
        out.append((rot, dirn))
    return out


def test_init_map_multicam_distorted(monkeypatch):
    """The map init with lens distortion (k1 = -0.25, k2 = 0.08, the
    reference's distorted rig at 240x320, f = 250) against the JAX
    package's, frames 0-3, on the same pyramid and corner positions, the
    port's RANSAC drawing the JAX package's samples (``jax.random`` from
    the same integer seeds). Both cut the NCC blocks at the corners'
    undistorted positions on the distorted image and undistort those
    positions a second time (``coslam_tpu/slam/initmap.py:176-188``).
    Held:
    - the blocks to 1e-4 (this module's band) with the same flags, the
      twice-undistorted coordinates to 1e-6, the NCC matches equal;
    - the F-RANSAC hypotheses whose 8 samples are 8 distinct
      correspondences score the same consensus in both packages, 95% of
      them at least (measured: 1859 of 1901; most of the others by one
      correspondence on the Sampson gate, float32 rounding in the 8-point
      solve). A sample that repeats a correspondence (the reference draws
      with replacement) leaves a null space of two or more dimensions,
      from which each package's SVD returns its own F: those hypotheses
      differ, and where one wins, the verified matches and the init that
      follows differ too (with the same samples, 79 of the 80 hypotheses
      that differ on frame 0's pair (0, 2) repeat a sample). This, and
      the samples themselves, which the port draws from its own stream,
      is why the port's init and the JAX package's succeed on different
      frames of this rig and recover poses several degrees apart;
    - the whole init succeeds in both and orders the cameras alike."""
    from coslam_tpu.config import CapacityConfig as JCap
    from coslam_tpu.config import KLTConfig as JKLT
    from coslam_tpu.config import SlamConfig as JCfg
    from coslam_tpu.geometry import camera as jcam
    from coslam_tpu.geometry import epipolar as jepi
    from coslam_tpu.ops import build_pyramid as jbuild
    from coslam_tpu.ops.matching import guided_match as jmatch
    from coslam_tpu.ops.ncc import extract_ncc_blocks as jblocks
    from coslam_tpu.slam import initmap as ji
    from coslam_torch.geometry import camera as tcam
    from coslam_torch.geometry import epipolar as tepi
    from coslam_torch.ops.matching import guided_match as tmatch
    from coslam_torch.ops.ncc import extract_ncc_blocks as tblocks
    from coslam_torch.slam import initmap as ti
    from coslam_torch.slam.pipeline import CoSlamEngine

    monkeypatch.setattr(tepi, "sample_indices", tp.jax_samples)
    monkeypatch.setattr(tepi, "sample_seed", tp.jax_seed)
    K, KK, kc, Rs, ts, frames, cfg = _distorted_rig()
    nc, n = kc.shape[0], frames.shape[0]
    w = cfg.image_width
    kw = dict(num_cameras=nc, image_height=cfg.image_height, image_width=w)
    jcfg = JCfg(klt=JKLT(n_levels=3), cap=JCap(max_features=256), **kw)
    r = cfg.p.ncc_patch_radius
    hyp_same = hyp_distinct = 0
    for f in range(n):
        jp = tp.to_numpy(jbuild(jnp.asarray(tp.n(frames[f])), 3))
        pyr = tp.pyramid_to_torch(jp)
        eng = CoSlamEngine(cfg, KK, kc, device="cpu")
        eng._first_frame(pyr)
        pos, valid = eng.state.tracks.pos, eng.state.tracks.valid
        jpos, jvalid = jnp.asarray(tp.n(pos)), tp.n(valid)
        tb = [tblocks(pyr.imgs[0][c], pos[c], r) for c in range(nc)]
        jb = [jblocks(jnp.asarray(jp.imgs[0][c]), jpos[c], r)
              for c in range(nc)]
        for (b, ok), (jbk, jok) in zip(tb, jb):
            np.testing.assert_allclose(tp.n(b), np.asarray(jbk), atol=1e-4)
            np.testing.assert_array_equal(tp.n(ok), np.asarray(jok))
        xn = [tcam.normalize_points(pos[c], tp.t(K), tp.t(kc[c]))
              for c in range(nc)]
        for c in range(nc):
            np.testing.assert_allclose(
                tp.n(xn[c]), np.asarray(jcam.normalize_points(
                    jpos[c], K, kc[c])), atol=1e-6)
        for i in range(nc):
            for j in range(i + 1, nc):
                args = dict(F=None, min_ncc=cfg.p.ncc_min_score,
                            max_disparity=0.6 * w, rounds=8)
                m = tp.n(tmatch(tb[i][0], tb[j][0], tb[i][1] & valid[i],
                                tb[j][1] & valid[j], pos[i], pos[j],
                                **args).a_to_b)
                jm = np.asarray(jmatch(
                    jb[i][0], jb[j][0], jb[i][1] & jvalid[i],
                    jb[j][1] & jvalid[j], jpos[i], jpos[j], **args).a_to_b)
                np.testing.assert_array_equal(m, jm)
                # the F-RANSAC hypotheses of this pair, as both score them
                pair_a = np.nonzero(m >= 0)[0]
                N = len(m)
                x1 = torch.zeros((N, 2))
                x2 = torch.zeros((N, 2))
                x1[:len(pair_a)] = xn[i][pair_a]
                x2[:len(pair_a)] = xn[j][m[pair_a]]
                mask = torch.arange(N) < len(pair_a)
                idx = tp.jax_samples(
                    torch.Generator().manual_seed(17 * i + j), mask, 256, 8)
                Ft = tepi.fit_fundamental(x1[idx], x2[idx],
                                          torch.ones(idx.shape))
                got = ((tepi.sampson_error(Ft, x1[None], x2[None]) < 3e-5)
                       & mask).sum(-1).numpy()
                jx1, jx2 = jnp.asarray(tp.n(x1)), jnp.asarray(tp.n(x2))
                jidx = jnp.asarray(tp.n(idx))
                Fj = jepi.fit_fundamental(jx1[jidx], jx2[jidx],
                                          jnp.ones(jidx.shape))
                want = np.asarray(((jepi.sampson_error(
                    Fj, jx1[None], jx2[None]) < 3e-5)
                    & jnp.asarray(tp.n(mask))).sum(-1))
                distinct = np.array([len(set(s)) == 8
                                     for s in tp.n(idx).tolist()])
                hyp_distinct += int(distinct.sum())
                hyp_same += int((got == want)[distinct].sum())
        want = ji.init_map_multicam(jcfg, KK, kc, jp, jpos, jvalid)
        got = ti.init_map_multicam(cfg, tp.t(KK), tp.t(kc), pyr, pos, valid)
        assert want.ok and got.ok, f
        assert got.cam_order == want.cam_order
        for name, res in (("JAX", want), ("port", got)):
            for b, (rot, dirn) in zip((1, 2), _rig_errors(res, Rs, ts, f)):
                print(f"frame {f} camera {b} {name}: rotation {rot:.2f} deg, "
                      f"baseline direction {dirn:.1f} deg off")
    print(f"distinct-sample hypotheses scored alike: {hyp_same} of "
          f"{hyp_distinct}")
    assert hyp_same >= 0.95 * hyp_distinct


def test_init_map_multicam_distorted_reads_the_raw_corners(monkeypatch):
    """The engine's map init under lens distortion (ROADMAP.md, C3):
    handed the corners on the distorted image (``tracks.raw``), the init
    cuts its NCC blocks there and undistorts them once, where the JAX
    package's cuts them at the undistorted positions and undistorts those
    a second time. Frames 0-3 of the distorted rig at 240x320 (the test
    above), the port's own RANSAC draws. Held:
    - the blocks to 1e-4 of the JAX package's ``extract_ncc_blocks`` at
      the same raw positions, with the same flags; the once-undistorted
      coordinates to 1e-6 of the JAX package's ``normalize_points`` of
      them, and to 1e-4 of the undistorted positions ``pos`` normalized
      without distortion (the tracks' two spaces agree);
    - the init succeeds on every frame, each relative rotation within
      1 deg and each baseline direction within 8 deg of the rig's
      (measured: 0.18-0.65 deg and 0.6-5.8 deg, 92-99 chained tracks;
      with the JAX package's call on the same frames the port's init
      fails on frames 0 and 1 and is 1.08-3.12 deg and 3.4-17.3 deg off
      on 2 and 3, 51-52 tracks);
    - the engine hands over ``raw`` only when a camera's ``kc`` is not
      zero: without distortion its call is the JAX package's."""
    from coslam_tpu.geometry import camera as jcam
    from coslam_tpu.ops.ncc import extract_ncc_blocks as jblocks
    from coslam_torch.geometry import camera as tcam
    from coslam_torch.ops import build_pyramid
    from coslam_torch.ops.ncc import extract_ncc_blocks as tblocks
    from coslam_torch.slam import initmap as ti
    from coslam_torch.slam import pipeline as tpipe
    K, KK, kc, Rs, ts, frames, cfg = _distorted_rig()
    nc, n = kc.shape[0], frames.shape[0]
    r = cfg.p.ncc_patch_radius
    for f in range(n):
        pyr = build_pyramid(frames[f], 3)
        eng = tpipe.CoSlamEngine(cfg, KK, kc, device="cpu")
        eng._first_frame(pyr)
        tr = eng.state.tracks
        for c in range(nc):
            b, ok = tblocks(pyr.imgs[0][c], tr.raw[c], r)
            jb, jok = jblocks(jnp.asarray(tp.n(pyr.imgs[0][c])),
                              jnp.asarray(tp.n(tr.raw[c])), r)
            np.testing.assert_allclose(tp.n(b), np.asarray(jb), atol=1e-4)
            np.testing.assert_array_equal(tp.n(ok), np.asarray(jok))
            xn = tcam.normalize_points(tr.raw[c], tp.t(K), tp.t(kc[c]))
            np.testing.assert_allclose(tp.n(xn), np.asarray(
                jcam.normalize_points(jnp.asarray(tp.n(tr.raw[c])), K,
                                      kc[c])), atol=1e-6)
            sel = tr.valid[c]
            np.testing.assert_allclose(
                tp.n(xn[sel]),
                tp.n(tcam.pixel_to_normalized(tr.pos[c][sel], tp.t(K))),
                atol=1e-4)
        ref = ti.init_map_multicam(cfg, tp.t(KK), tp.t(kc), pyr, tr.pos,
                                   tr.valid)
        res = ti.init_map_multicam(cfg, tp.t(KK), tp.t(kc), pyr, tr.pos,
                                   tr.valid, raw=tr.raw)
        assert res.ok, f
        for name, out in (("the JAX package's call", ref), ("raw", res)):
            if not out.ok:
                print(f"frame {f} {name}: failed")
                continue
            for b, (rot, dirn) in zip((1, 2), _rig_errors(out, Rs, ts, f)):
                print(f"frame {f} camera {b} {name}: rotation {rot:.2f} deg, "
                      f"baseline direction {dirn:.1f} deg off, "
                      f"{out.X.shape[0]} tracks")
                assert out is ref or (rot < 1.0 and dirn < 8.0), (f, b)
    # which positions the engine hands over
    seen = []

    def spy(*args, raw=None):
        seen.append(raw)
        return ti.InitMapResult(False, None, None, None, None, None, [])
    monkeypatch.setattr(tpipe, "init_map_multicam", spy)
    pyr = build_pyramid(frames[0], 3)
    for lens in (kc, np.zeros_like(kc)):
        eng = tpipe.CoSlamEngine(cfg, KK, lens, device="cpu")
        eng._first_frame(pyr)
        assert not eng._bootstrap_multicam(pyr)
    assert seen[0] is not None and seen[1] is None
