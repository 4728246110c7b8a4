"""Shared inputs for the parity tests of ``coslam_torch`` against
``coslam_tpu`` (``tests/test_torch_*.py``).

Both packages see the same numpy arrays. JAX state crosses over as numpy
leaves (``state_from_numpy``); pyramids cross level by level. JAX is
imported only by the helpers that run it, so the tests that need the card
(run where JAX is not installed) can use this module too.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from coslam_torch.ops.pyramid import Pyramid as TPyramid

H, W = 150, 200
KMAT = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]], np.float32)
KC = np.zeros((1, 5), np.float32)

# the suite runs in several worker processes at once: keep each one's
# intra-op thread pool small
torch.set_num_threads(min(2, torch.get_num_threads()))


def to_numpy(tree):
    """Every leaf of a JAX pytree as a fresh numpy array (a copy: the JAX
    engine donates its state buffers to the next frame)."""
    import jax
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def t(a):
    """numpy -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a, copy=True))


def n(x):
    """tensor or JAX array -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pyramid_to_torch(pyr) -> TPyramid:
    """A JAX Pyramid (or one with numpy leaves) as the port's Pyramid."""
    return TPyramid(imgs=tuple(t(np.asarray(a)) for a in pyr.imgs),
                    dxs=tuple(t(np.asarray(a)) for a in pyr.dxs),
                    dys=tuple(t(np.asarray(a)) for a in pyr.dys))


def smooth_texture(rng, h, w, passes=2):
    """Trackable smooth random texture in [0, 255], [1, h, w] f32, made in
    numpy (the same [1 4 6 4 1]/16 edge-replicated blur as ops/image.py)."""
    img = rng.uniform(0, 1, (h, w)).astype(np.float64)
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for _ in range(passes):
        p = np.pad(img, 2, mode="edge")
        img = sum(k[i] * p[i:i + h, 2:2 + w] for i in range(5))
        p = np.pad(img, 2, mode="edge")
        img = sum(k[i] * p[2:2 + h, i:i + w] for i in range(5))
    img = (img - img.min()) / (img.max() - img.min() + 1e-12) * 255.0
    return img.astype(np.float32)[None]


def shift_image(img, dx, dy):
    """Bilinear shift of [1, h, w] by (dx, dy): content moves by +d."""
    _, h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    x, y = xs - dx, ys - dy
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx, fy = x - x0, y - y0
    im = img[0].astype(np.float64)
    out = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx * (1 - fy)
           + im[y0 + 1, x0] * (1 - fx) * fy + im[y0 + 1, x0 + 1] * fx * fy)
    return out.astype(np.float32)[None]


def render_mono_frames(n_frames: int, forward: float = 0.06):
    """Frames of the synthetic room rendered by the JAX package (seed 0),
    with their ground-truth poses."""
    from coslam_tpu.io.synthetic import (make_room, orbit_trajectory,
                                         render_sequence)
    rng = np.random.default_rng(0)
    planes = make_room(rng, size=10.0)
    Rs, ts = orbit_trajectory(n_frames, forward=forward)
    frames = np.asarray(render_sequence(planes, KMAT[0], Rs, ts, H, W))
    return frames, Rs, ts


def kmats(C: int):
    """(K [C, 3, 3], kc [C, 5]) numpy for C identical cameras."""
    return np.repeat(KMAT, C, 0), np.zeros((C, 5), np.float32)


def render_rig_frames(C: int, n_frames: int, baseline: float = 1.0,
                      forward: float = 0.06, quads=None, rng=None):
    """Frames [F, C, H, W] of a C-camera rig in the synthetic room rendered
    by the JAX package (the rig of tests/test_pipeline_multicam.py; the
    poses, numpy, from ``rig_sequence``), with ground truth
    (Rs [C, F, 3, 3], ts [C, F, 3])."""
    from coslam_tpu.io.synthetic import make_room, render_sequence
    from coslam_torch.io.synthetic import rig_sequence
    rng = np.random.default_rng(0) if rng is None else rng
    planes = make_room(rng, size=10.0)
    Rs, ts = rig_sequence(C, n_frames, baseline=baseline, forward=forward)
    frames = np.zeros((n_frames, C, H, W), np.float32)
    for c in range(C):
        frames[:, c] = render_sequence(planes, KMAT[0], Rs[c], ts[c], H, W,
                                       quads=quads)
    return frames, Rs, ts


def _drive(eng, frames, snapshots, to_numpy_tree, handover=None):
    """Feed ``frames`` [F, C, H, W] to an engine of either package and
    collect what the engine tests compare: host logs, corrected
    trajectories (which drain the chunk and overlap buffers first), BA
    dispatches that stayed in flight past their frame (async BA), the
    stage clock's keys and the alive map's size. ``to_numpy_tree`` (the
    JAX engine) also keeps ``boot``: the state, pyramid and host fields
    right after the bootstrap frame; ``handover`` (the port's engine) puts
    such a snapshot in place right after that frame."""
    C = frames.shape[1]
    snaps = {}
    boot = None
    dispatches = 0
    for f in range(frames.shape[0]):
        had = getattr(eng, "_pending_ba", None) is not None
        eng.process_frame(frames[f])
        if not had and getattr(eng, "_pending_ba", None) is not None:
            dispatches += 1
        if f in snapshots:
            snaps[f] = (to_numpy_tree(eng.state),
                        to_numpy_tree(eng.pyr_prev))
        if to_numpy_tree is not None and boot is None and eng.bootstrapped:
            boot = dict(frame=f, state=to_numpy_tree(eng.state),
                        pyr=to_numpy_tree(eng.pyr_prev),
                        kf_frames=list(eng.kf_frames),
                        kf_inliers=np.array(eng._kf_inliers),
                        traj=[[(np.array(R), np.array(t)) for R, t in tr]
                              for tr in eng.traj],
                        rel=[[(np.array(R), np.array(t)) for R, t in tr]
                             for tr in eng.rel])
        if handover is not None and f == handover["frame"] \
                and eng.bootstrapped:
            _hand_over(eng, handover)
    trajs = [tuple(np.asarray(a) for a in eng.trajectory(c, correct=True))
             for c in range(C)]
    ids, xyz, _ = eng.map_points()
    return dict(snaps=snaps, boot=boot, kf_frames=list(eng.kf_frames),
                boot_frame=boot_frame(eng.stats_log), traj=trajs[0],
                trajs=trajs, stats_log=eng.stats_log,
                group_id=np.asarray(eng.group_id).copy(),
                group_hist=list(eng.group_hist), dyn_log=eng.dyn_log,
                dispatches=dispatches, timing_keys=set(eng.timing),
                n_map=int(np.isfinite(np.asarray(xyz)).all(1).sum()),
                pending_empty=not eng._chunk_buf
                and eng._chunk_pending is None and eng._pending_fs is None,
                engine=eng)


def _hand_over(eng, snap):
    """The port's engine takes over the JAX engine's bootstrap: its state,
    pyramid (split over the shards of a mesh engine), keyframe inliers and
    the trajectory so far."""
    from coslam_torch.slam.state import state_from_numpy
    eng.state = state_from_numpy(snap["state"], eng.device)
    eng.adopt_pyramid(pyramid_to_torch(snap["pyr"]),
                      int(snap["state"].frame))
    eng.kf_frames = list(snap["kf_frames"])
    eng._kf_inliers = snap["kf_inliers"].copy()
    eng.traj = [list(tr) for tr in snap["traj"]]
    eng.rel = [list(tr) for tr in snap["rel"]]


def run_jax_engine(frames, snapshots=(), **engine_kw):
    """Drive the JAX engine over ``frames`` [F, C, H, W] (or [F, H, W] for
    one camera) at small_test_config(C, H, W), with the engine keyword
    arguments ``engine_kw`` (chunk, overlap, async_ba, use_fused,
    profile). Returns a dict: the engine's host logs, its corrected
    trajectories (one per camera), what ``_drive`` counts and, for each
    frame k in ``snapshots``, (state, pyr_prev) as numpy trees right after
    frame k was processed."""
    from coslam_tpu.config import small_test_config
    from coslam_tpu.slam.pipeline import CoSlamEngine
    if frames.ndim == 3:
        frames = frames[:, None]
    C = frames.shape[1]
    cfg = small_test_config(num_cameras=C, h=H, w=W)
    eng = CoSlamEngine(cfg, *kmats(C), **engine_kw)
    return _drive(eng, frames, snapshots, to_numpy)


def run_port_engine(frames, handover=None, **engine_kw):
    """``run_jax_engine`` for the port's engine on the CPU. ``handover``: a
    JAX run's ``boot`` snapshot, which the port's engine takes over right
    after its own bootstrap at that frame, so that the runs differ only in
    what follows (not in the bootstrap's RANSAC streams)."""
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    if frames.ndim == 3:
        frames = frames[:, None]
    C = frames.shape[1]
    eng = CoSlamEngine(small_test_config(C, H, W), *kmats(C), device="cpu",
                       **engine_kw)
    return _drive(eng, frames, (), None, handover)


def leaves(tree):
    """The leaves of a (nested) tuple tree, in order."""
    if isinstance(tree, tuple):
        return [x for leaf in tree for x in leaves(leaf)]
    return [tree]


def aligned_gap(traj_a, traj_b) -> tuple[float, float]:
    """(RMS of the Sim(3)-aligned camera-centre gap between two
    trajectories, the length of ``traj_b``'s path)."""
    from coslam_torch.io.ate import camera_centers, umeyama
    ca, cb = camera_centers(*traj_a), camera_centers(*traj_b)
    s, R, t = umeyama(ca, cb)
    gap = np.linalg.norm((s * (R @ ca.T)).T + t - cb, axis=-1)
    path = np.linalg.norm(np.diff(cb, axis=0), axis=-1).sum()
    return float(np.sqrt(np.mean(gap ** 2))), float(path)


def boot_frame(stats_log):
    """The frame at which the engine's bootstrap succeeded (None if never)."""
    for s in stats_log:
        if s.get("bootstrap"):
            return s["frame"]
    return None


def assert_tracks_close(jt, tt, max_flips=2, pos_tol=1e-3, max_mpt_diff=0):
    """A JAX track table (jt) against the port's (tt): at most
    ``max_flips`` slots whose validity differs, positions and history to
    ``pos_tol`` px, integer fields equal where both are valid but for at
    most ``max_mpt_diff`` map bindings."""
    jv, tv = np.asarray(jt.valid), n(tt.valid)
    assert (jv != tv).sum() <= max_flips
    both = jv & tv
    assert both.sum() > 50
    for f in ("pos", "raw"):
        np.testing.assert_allclose(n(getattr(tt, f))[both],
                                   np.asarray(getattr(jt, f))[both],
                                   atol=pos_tol, err_msg=f)
    for f in ("age", "dyn_votes"):
        np.testing.assert_array_equal(n(getattr(tt, f))[both],
                                      np.asarray(getattr(jt, f))[both],
                                      err_msg=f)
    assert (n(tt.mpt)[both] != np.asarray(jt.mpt)[both]).sum() \
        <= max_mpt_diff
    hv = np.asarray(jt.hist_valid)
    assert (hv != n(tt.hist_valid)).sum() <= 2 * max_flips * hv.shape[1]
    hb = hv & n(tt.hist_valid)
    np.testing.assert_allclose(n(tt.hist)[hb], np.asarray(jt.hist)[hb],
                               atol=pos_tol)


# ---------------------------------------------------------------------
# engine modes (tests/test_torch_modes_*.py)
# ---------------------------------------------------------------------
# The engine-mode parity tests hold the port's CoSlamEngine against the
# JAX package's in one mode, both fed the same JAX-rendered frames at
# small_test_config(C, 150, 200).
#
# Both engines bootstrap on their own (at the same frame); then the port's
# takes over the JAX engine's bootstrap state, pyramid and trajectory
# (``run_port_engine``'s ``handover``), so the runs differ only in what
# follows: the RANSAC streams of the bootstrap differ (``jax.random``
# against a seeded ``torch.Generator``, ROADMAP queue C), and on the room
# at forward 0.06 the port's bootstrap puts frame 15's pose update (before
# the first BA of the chunk and overlap modes) on a jump, which the JAX
# package's own ``frame_step`` repeats on the port's state.
#
# Each mode runs on a scene where the reference holds the centre band
# against its own run on frames perturbed by +-0.01 grey
# (``reference_stability``; ``PYTHONPATH=. python tests/torch_parity.py``).
# On the room at forward 0.06 (tests/test_torch_engine.py's) the default,
# chunk=4, chunk=4 with overlap and async BA move the reference's centres
# by 0.38-0.76% of the path and its keyframes by two entries at most;
# per-frame overlap and chunk=5 move them by 4.81% and 5.45%, so those
# two run at forward 0.05 (0.64% and 0.55%). The non-fused path moves
# the reference by 3.53% and 13 keyframes at 0.06 (2.88% and 4 at 0.05):
# its keyframe decisions sit on their thresholds on either scene, and it
# runs at 0.06.
#
# Float32 sums run in another order (tests/test_torch_engine.py), so the
# runs are compared by outcome:
# - the same bootstrap frame and the same list of logged stats frames
#   (chunk mode logs a chunk's frames when its stats are read, overlap mode
#   one frame or chunk later and never its transition frame);
# - keyframe lists at most one entry longer and two entries apart (the band
#   of tests/test_torch_pipeline_multicam.py); in per-frame overlap mode a
#   keyframe one frame off counts as the same: there the cadence turns
#   regular, one keyframe decided a frame later shifts all the later ones,
#   and that decision can sit on its threshold;
# - every ATE under 0.20, 0.25 with two cameras (the bounds of
#   tests/test_pipeline_mono.py and test_pipeline_multicam.py);
# - the Sim(3)-aligned camera centres within 5% of the path (RMS);
# - no frame left in the chunk or overlap buffers after ``trajectory``;
# - the stage clock's keys equal.

_RUNS: dict = {}


def scene(C: int, n: int, forward: float = 0.06):
    """JAX-rendered frames [n, C, H, W] and ground truth [C, n]: the mono
    room of tests/test_torch_engine.py, or the C-camera rig."""
    if C == 1:
        frames, Rs, ts = render_mono_frames(n, forward=forward)
        return frames[:, None], Rs[None], ts[None]
    return render_rig_frames(C, n, forward=forward)


def mode_runs(name: str, modes: dict):
    """(JAX run, port run, Rs_gt, ts_gt, ATE bound) of mode ``name`` of
    ``modes`` ({name: (cameras, frames, forward, engine keyword
    arguments)}), each engine driven once per process."""
    C, n, forward, kw = modes[name]
    if name not in _RUNS:
        frames, Rs, ts = scene(C, n, forward)
        ref = run_jax_engine(frames, **kw)
        port = run_port_engine(frames, handover=ref["boot"], **kw)
        _RUNS[name] = (ref, port, Rs, ts)
    ref, port, Rs, ts = _RUNS[name]
    return ref, port, Rs, ts, 0.20 if C == 1 else 0.25


def check_bootstrap_and_logged_frames(ref, port, n: int):
    assert port["boot_frame"] == ref["boot_frame"] is not None
    frames_port = [s["frame"] for s in port["stats_log"]]
    assert frames_port == [s["frame"] for s in ref["stats_log"]]
    assert frames_port == list(range(n))


def check_keyframes(ref, port, lag: int = 0):
    """Keyframe lists at most one entry longer and two entries apart; with
    ``lag``, keyframes within ``lag`` frames of each other count as the
    same one (overlap mode: a keyframe decided one frame later shifts the
    rest of the cadence by a frame)."""
    a, b = port["kf_frames"], ref["kf_frames"]
    left = list(b)
    unmatched = 0
    for f in a:
        near = [g for g in left if abs(g - f) <= lag]
        if near:
            left.remove(min(near, key=lambda g: abs(g - f)))
        else:
            unmatched += 1
    assert abs(len(a) - len(b)) <= 1 and unmatched + len(left) <= 2, (a, b)


def check_ate(ref, port, Rs, ts, bound: float):
    from coslam_torch.io.ate import ate_rmse
    for c in range(Rs.shape[0]):
        assert ate_rmse(*port["trajs"][c], Rs[c], ts[c]) < bound, c
        assert ate_rmse(*ref["trajs"][c], Rs[c], ts[c]) < bound, c


def check_centres(ref, port, C: int):
    for c in range(C):
        gap, path = aligned_gap(port["trajs"][c], ref["trajs"][c])
        assert gap < 0.05 * path, (c, gap, path)


def check_buffers_and_clock(ref, port):
    assert port["pending_empty"] and ref["pending_empty"]
    assert port["timing_keys"] == ref["timing_keys"]
    assert np.isfinite(port["traj"][1]).all()


def reference_stability(C: int, n: int, forward: float, **engine_kw):
    """The JAX engine in one mode on a scene against itself on the same
    frames perturbed by uniform noise of +-0.01 grey (seed 1): (centre
    gap in % of the path, keyframe symmetric difference)."""
    frames, _, _ = scene(C, n, forward)
    noise = np.random.default_rng(1).uniform(-0.01, 0.01, frames.shape)
    a = run_jax_engine(frames, **engine_kw)
    b = run_jax_engine((frames + noise).astype(np.float32), **engine_kw)
    gap, path = aligned_gap(b["traj"], a["traj"])
    return 100 * gap / path, len(set(a["kf_frames"]) ^ set(b["kf_frames"]))


def _jax_categorical(key, allowed, shape) -> torch.Tensor:
    """Indices of the True entries of ``allowed`` drawn as the JAX package
    draws them (``jax.random.categorical`` over flat logits)."""
    import jax
    import jax.numpy as jnp
    logits = jnp.where(jnp.asarray(n(allowed)), 0.0, -1e9)
    return torch.from_numpy(np.asarray(jax.random.categorical(
        key, logits[None, :], shape=shape)).astype(np.int64))


def jax_samples(gen, mask, n_hyp: int, size: int) -> torch.Tensor:
    """The JAX package's epipolar RANSAC samples for the port's generator
    ``gen`` (``jax.random`` keyed by its integer seed): a stand-in for
    ``coslam_torch.geometry.epipolar.sample_indices``."""
    import jax
    return _jax_categorical(jax.random.PRNGKey(gen.initial_seed()), mask,
                            (n_hyp, size))


def jax_seed(gen) -> int:
    """The JAX package's sample seed for ``gen``: a stand-in for
    ``coslam_torch.geometry.epipolar.sample_seed``."""
    import jax
    return int(jax.random.randint(jax.random.PRNGKey(gen.initial_seed()),
                                  (), 0, 2 ** 31 - 1))


@contextlib.contextmanager
def jax_ransac_draws():
    """While entered, the port's RANSAC draws are the JAX package's
    (``jax.random`` from the same integer seeds): the epipolar samples of
    the bootstrap and the map init (``jax_samples``, ``jax_seed``) and the
    merge bridge's PROSAC-tiered PnP samples (``pnp._draw``; its three
    tiers drawn from the seed's key split in three, as
    ``coslam_tpu/geometry/pnp.py`` draws them). The two packages then
    differ in float32 sums only."""
    import jax
    from coslam_torch.geometry import epipolar as tepi
    from coslam_torch.geometry import pnp as tpnp
    tier = {"gen": None, "k": 0}

    def draw(gen, allowed, count, size):
        # one ransac_pnp call draws its three tiers from one generator
        if gen is not tier["gen"]:
            tier.update(gen=gen, k=0)
        key = jax.random.split(jax.random.PRNGKey(gen.initial_seed()),
                               3)[tier["k"]]
        tier["k"] += 1
        return _jax_categorical(key, allowed, (count, size))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tepi, "sample_indices", jax_samples)
        mp.setattr(tepi, "sample_seed", jax_seed)
        mp.setattr(tpnp, "_draw", draw)
        yield


def run_scenario(frames):
    """Both packages' default engines at small_test_config(C, H, W) over
    the same ``frames`` [F, C, H, W] (the port's on the CPU, drawing the
    JAX package's RANSAC samples: ``jax_ransac_draws``). Returns
    {"jax": run, "port": run}, each run a dict: ``groups`` (the group ids
    after every frame), ``merge_log``, ``trajs`` (per camera, corrected)
    and ``trajs_chain`` (corrected with chain scales). Prints both runs'
    group transitions and merges."""
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_tpu.slam.pipeline import CoSlamEngine as JEngine
    from coslam_torch.config import small_test_config as tcfg
    from coslam_torch.slam.pipeline import CoSlamEngine as TEngine
    C = frames.shape[1]
    K, kc = kmats(C)
    out = {}
    for name, eng in (("jax", JEngine(jcfg(C, H, W), K, kc)),
                      ("port", TEngine(tcfg(C, H, W), K, kc,
                                       device="cpu"))):
        groups = []
        with jax_ransac_draws():
            for f in range(frames.shape[0]):
                eng.process_frame(frames[f])
                groups.append(tuple(eng.group_id.tolist()))
        out[name] = dict(
            groups=groups, merge_log=[dict(m) for m in eng.merge_log],
            trajs=[tuple(np.asarray(a) for a in eng.trajectory(c, True))
                   for c in range(C)],
            trajs_chain=[tuple(np.asarray(a) for a in eng.trajectory(
                c, True, chain_scales=True)) for c in range(C)])
        print(f"{name}: group transitions {transitions(groups)}; merges "
              f"{out[name]['merge_log']}", flush=True)
    return out


def partition(groups) -> tuple:
    """A camera grouping with its ids renumbered in order of first
    appearance, so that two runs that name the same split otherwise
    compare equal."""
    first = {}
    return tuple(first.setdefault(g, len(first)) for g in groups)


def transitions(groups) -> list:
    """(frame, partition) at every frame whose grouping differs from the
    frame before."""
    return [(i, partition(g)) for i, g in enumerate(groups)
            if i and partition(g) != partition(groups[i - 1])]


def assert_transitions_agree(a, b, frames: int = 2):
    """The same sequence of groupings, each reached within ``frames``
    frames of the other run's."""
    ta, tb = transitions(a), transitions(b)
    assert [p for _, p in ta] == [p for _, p in tb], (ta, tb)
    for (fa, _), (fb, _) in zip(ta, tb):
        assert abs(fa - fb) <= frames, (ta, tb)


def assert_merges_agree(a, b, frames: int = 2, matches: float = 0.2):
    """The same merges: count, ``noop`` and ``reunify`` flags, each merge's
    frame within ``frames`` frames, and bridge matches within the share
    ``matches`` of the reference's (``b``)."""
    assert len(a) == len(b), (a, b)
    for ma, mb in zip(a, b):
        for k in ("noop", "reunify"):
            assert bool(ma.get(k)) == bool(mb.get(k)), (k, ma, mb)
        assert abs(ma["frame"] - mb["frame"]) <= frames, (ma, mb)
        assert abs(ma["n_matches"] - mb["n_matches"]) \
            <= matches * mb["n_matches"], (ma, mb)


# ---------------------------------------------------------------------
# the mesh engine (tests/test_torch_mesh_engine*.py)
# ---------------------------------------------------------------------

def cpu_mesh(C: int):
    """A camera mesh of C CPU devices: one camera a shard."""
    from coslam_torch.parallel.mesh import make_cam_mesh
    return make_cam_mesh(devices=["cpu"] * C)


def port_test_engine(C: int, mesh=None, **engine_kw):
    """The port's engine at small_test_config(C, H, W) on the CPU, on
    ``mesh`` when one is given."""
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    return CoSlamEngine(small_test_config(C, H, W), *kmats(C), device="cpu",
                        mesh=mesh, **engine_kw)


def run_frames(eng, frames) -> list:
    """Feed ``frames``; each camera's uncorrected trajectory."""
    for f in frames:
        eng.process_frame(f)
    return [eng.trajectory(c, correct=False)
            for c in range(eng.cfg.num_cameras)]


def assert_same_run(a, b, ta, tb):
    """Two engines' runs (engines ``a``, ``b``; trajectories ``ta``,
    ``tb``) agree: bootstrapped, the same keyframes and groups, each
    camera's centres within 0.05 and its poses within 1e-5."""
    assert a.bootstrapped and b.bootstrapped
    assert a.kf_frames == b.kf_frames, (a.kf_frames, b.kf_frames)
    assert a.group_hist == b.group_hist

    def centres(traj):
        R, t = traj
        return -np.einsum("fji,fj->fi", R, t)
    for c, (x, y) in enumerate(zip(ta, tb)):
        gap = float(np.abs(centres(x) - centres(y)).max())
        assert gap < 0.05, (c, gap)
        for u, v in zip(x, y):
            np.testing.assert_allclose(u, v, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------
# the mesh step's inputs (tests/test_torch_parallel.py, _parallel_chunk.py)
# ---------------------------------------------------------------------
# Both packages start one fused step (or one chunk) from the JAX package's
# seeded track table on blurred noise at 96x128 with 128 features (its dry
# run's frames): the port on a mesh of CPU devices and on one device.

MESH_H, MESH_W, MESH_FEATS = 96, 128, 128


def mesh_images(C, seed=0):
    """Blurred uniform noise [C, MESH_H, MESH_W] (the dry run's frames,
    blurred by the JAX package), K and kc for C identical cameras."""
    import jax.numpy as jnp
    from coslam_tpu.ops.image import gaussian_blur
    rng = np.random.default_rng(seed)
    imgs = np.asarray(gaussian_blur(jnp.asarray(
        rng.uniform(0, 255, (C, MESH_H, MESH_W)), jnp.float32)))
    K = np.broadcast_to(np.array(
        [[120.0, 0, MESH_W / 2], [0, 120.0, MESH_H / 2], [0, 0, 1]],
        np.float32), (C, 3, 3)).copy()
    return imgs, K, np.zeros((C, 5), np.float32)


def jax_seeded(C, imgs, K, kc):
    """The JAX package's seeded state (its dry run's track table: the
    first frame's corners) and first-frame pyramid, as numpy trees."""
    import jax.numpy as jnp
    from coslam_tpu.ops import build_pyramid, detect_corners
    from coslam_tpu.parallel.scaling import _mesh_cfg
    from coslam_tpu.slam import steps
    from coslam_tpu.slam.state import init_state
    cfg = _mesh_cfg(C, MESH_H, MESH_W, MESH_FEATS)
    state = init_state(cfg)
    pyr0 = build_pyramid(jnp.asarray(imgs), cfg.klt.n_levels)
    det = detect_corners(pyr0.imgs[0], pyr0.dxs[0], pyr0.dys[0], cfg.klt,
                         MESH_FEATS)
    tracks = steps.seed_tracks(state.tracks, det.pos, det.valid,
                               jnp.full(det.valid.shape, -1, jnp.int32),
                               jnp.asarray(K), jnp.asarray(kc), state.frame)
    return cfg, to_numpy(state._replace(tracks=tracks)), to_numpy(pyr0)


def port_mesh_start(mesh, seeded, pyr0, K, kc):
    from coslam_torch.slam.fused import shard_pyramid
    from coslam_torch.slam.state import state_from_numpy
    tK, tkc = t(K), t(kc)
    return (state_from_numpy(seeded, mesh=mesh),
            shard_pyramid(mesh, pyramid_to_torch(pyr0), 0, tK, tkc),
            tK, tkc)


def port_single_start(seeded, pyr0, K, kc):
    from coslam_torch.slam.state import state_from_numpy
    return (state_from_numpy(seeded, "cpu"), pyramid_to_torch(pyr0),
            t(K), t(kc))


def assert_states_equal(a, b):
    from coslam_torch.slam.state import state_to_numpy
    for x, y in zip(leaves(state_to_numpy(a)), leaves(state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


if __name__ == "__main__":
    # the reference's own spread per mode and scene (see the note above);
    # run from the repository's root: PYTHONPATH=. python tests/torch_parity.py
    import jax
    jax.config.update("jax_platforms", "cpu")
    for fwd in (0.06, 0.05):
        for kw in (dict(), dict(overlap=True), dict(chunk=4),
                   dict(chunk=4, overlap=True), dict(chunk=5),
                   dict(async_ba=True), dict(use_fused=False)):
            gap, sym = reference_stability(1, 40, fwd, **kw)
            print(f"forward {fwd} {kw}: centre gap {gap:.2f}% of the "
                  f"path, keyframe symmetric difference {sym}", flush=True)
