"""The PyTorch port as a package: it stands apart from JAX, its config and
state match the JAX package's field by field, its kernel wrappers follow
the dispatch rule (CPU tensors take the plain version), its ctypes
bindings match the CUDA sources, and the parts outside this slice raise
instead of running silently."""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_parity as tp

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "coslam_torch"
BANNED = {"jax", "jaxlib", "coslam_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f)
           if root in BANNED]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing jax
    or coslam_tpu fails."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"coslam_torch.cli", "coslam_torch.io.checkpoint",
            "coslam_torch.io.loader", "coslam_torch.io.export",
            "coslam_torch.io.viz", "coslam_torch.ops.flow"} <= set(mods)
    code = ("import sys\n"
            "for b in ('jax', 'jaxlib', 'coslam_tpu'):\n"
            "    sys.modules[b] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("args", [(1, 150, 200), (1, 120, 160), (2, 96, 128)])
def test_small_test_config_matches(args):
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_torch.config import small_test_config as tcfg
    assert dataclasses.asdict(tcfg(*args)) == dataclasses.asdict(jcfg(*args))


def test_default_config_matches():
    from coslam_tpu import config as jc
    from coslam_torch import config as tc
    for name in ("KLTConfig", "CapacityConfig", "SlamParams", "SlamConfig"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], name
        assert dataclasses.asdict(a()) == dataclasses.asdict(b()), name


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert list(la) == list(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_init_state_matches():
    from coslam_tpu.slam.state import init_state as jinit
    from coslam_tpu.slam import state as jstate
    from coslam_torch.slam import state as tstate
    from coslam_torch.config import small_test_config
    cfg = small_test_config(1, 150, 200)
    _assert_trees_equal(tp.to_numpy(jinit(cfg)),
                        tstate.state_to_numpy(tstate.init_state(cfg, "cpu")))
    assert tstate.history_len(cfg) == jstate.history_len(cfg)
    assert tstate.long_history_len(cfg) == jstate.long_history_len(cfg)
    for name in ("ST_FREE", "ST_ALIVE", "ST_FALSE", "PT_STATIC",
                 "PT_DYNAMIC", "PT_UNCERTAIN", "LONG_STRIDE"):
        assert getattr(tstate, name) == getattr(jstate, name), name


def test_state_round_trip(rng):
    """state_from_numpy -> state_to_numpy is the identity on a JAX state
    (random contents, the JAX package's own NamedTuple classes)."""
    from coslam_tpu.slam.state import init_state as jinit
    from coslam_torch.slam.state import (SlamState, state_from_numpy,
                                         state_to_numpy)
    from coslam_torch.config import small_test_config
    js = tp.to_numpy(jinit(small_test_config(1, 96, 128)))

    def fill(a):
        if a.dtype == bool:
            return rng.random(a.shape) < 0.5
        if a.dtype.kind == "i":
            return rng.integers(-5, 50, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)
    import jax
    js = jax.tree.map(fill, js)
    ts = state_from_numpy(js, "cpu")
    assert type(ts) is SlamState
    assert all(torch.is_tensor(leaf) for _, leaf in _leaves(ts))
    _assert_trees_equal(js, state_to_numpy(ts))


def test_tf32_is_off():
    import coslam_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("n_valid", [0, 1, 2, 5, 6])
def test_nanmedian_matches_jnp(rng, n_valid):
    """jnp.nanmedian averages the two middle values (torch.nanmedian
    takes the lower one); all-NaN rows give NaN."""
    from coslam_torch.util import nanmedian
    x = rng.standard_normal((4, 6)).astype(np.float32)
    for row in x:
        row[rng.permutation(6)[n_valid:]] = np.nan
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1))
    got = nanmedian(tp.t(x), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def test_set_drop_matches_jax(rng):
    from coslam_torch.util import set_drop
    dst = rng.standard_normal((7, 3)).astype(np.float32)
    idx = np.array([0, 7, 3, 9, 5], np.int64)        # 7 and 9 are dropped
    val = rng.standard_normal((5, 3)).astype(np.float32)
    want = np.asarray(jnp.asarray(dst).at[idx].set(val, mode="drop"))
    got = set_drop(tp.t(dst), tp.t(idx), tp.t(val))
    np.testing.assert_array_equal(got.numpy(), want)
    # accumulate mode = .at[].add(mode="drop")
    acc = set_drop(tp.t(dst), tp.t(np.array([1, 1, 8])),
                   tp.t(np.ones((3, 3), np.float32)), accumulate=True)
    want = np.asarray(jnp.asarray(dst).at[np.array([1, 1, 8])].add(
        1.0, mode="drop"))
    np.testing.assert_allclose(acc.numpy(), want)


def test_wrappers_take_the_plain_version_on_cpu(rng):
    """A CPU tensor runs the plain twin and launches nothing."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    from coslam_torch.ops.patches import extract_windows, \
        extract_windows_plain
    from coslam_torch.ops.pyramid import build_pyramid, build_pyramid_plain
    img = tp.t(rng.uniform(0, 255, (1, 40, 56)).astype(np.float32))
    base = tp.t(rng.integers(-3, 50, (1, 9, 2)).astype(np.int32))
    pos = tp.t(rng.uniform(0, 50, (1, 9, 2)).astype(np.float32))
    valid = tp.t(rng.random((1, 9)) > 0.2)
    n0 = (build_pyramid.launches, klt_track.launches,
          extract_windows.launches)
    pyr, want = build_pyramid(img, 2), build_pyramid_plain(img, 2)
    for a, b in zip(pyr.imgs + pyr.dxs + pyr.dys,
                    want.imgs + want.dxs + want.dys):
        assert torch.equal(a, b)
    for a, b in zip(klt_track(pyr, pyr, pos, valid, KLTConfig(n_levels=2)),
                    klt_track_plain(pyr, pyr, pos, valid,
                                    KLTConfig(n_levels=2))):
        assert torch.equal(a, b)
    assert torch.equal(extract_windows(img, base, 14),
                       extract_windows_plain(img, base, 14))
    assert (build_pyramid.launches, klt_track.launches,
            extract_windows.launches) == n0 == (0, 0, 0)


def test_ctypes_signatures_match_cuda_sources():
    """Each kernel library's ctypes argtypes agree with its extern "C"
    declaration: a pointer, a host array (or the stream) as c_void_p, an
    int as c_int, a float as c_float."""
    import ctypes
    from coslam_torch.ops import cuda_lib
    assert sorted(p.stem for p in cuda_lib.CSRC.glob("*.cu")) == \
        sorted(cuda_lib.SIGNATURES)
    for name, argtypes in cuda_lib.SIGNATURES.items():
        src = (cuda_lib.CSRC / f"{name}.cu").read_text()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if p.startswith("float ") else ctypes.c_int
                 for p in params]
        assert params[-1] == "void* stream", (name, params)
        assert kinds == argtypes, (name, params)
    flags = " ".join(cuda_lib.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags


def test_engine_needs_a_card_or_an_explicit_cpu(monkeypatch):
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    cfg = small_test_config(1, 96, 128)
    K = np.array([[[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]]], np.float32)
    kc = np.zeros((1, 5), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoSlamEngine(cfg, K, kc)
    eng = CoSlamEngine(cfg, K, kc, device="cpu")
    assert eng.state.R.device.type == "cpu"


def test_parts_outside_the_slice_raise():
    """The engine modes (ported, A15) construct; meshes and BA on another
    device than the engine's (A18) raise at construction. The group-merge
    call site (ported, A14) tries a merge on a grouping tick past
    merge_min_interval when two groups' maps could overlap, and then backs
    off one tick while the bridge keeps failing."""
    from types import SimpleNamespace
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import GROUPING_INTERVAL, CoSlamEngine
    cfg = small_test_config(1, 96, 128)
    K = np.array([[[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]]], np.float32)
    kc = np.zeros((1, 5), np.float32)
    for kw in (dict(chunk=4), dict(overlap=True), dict(async_ba=True),
               dict(use_fused=False), dict(profile=True),
               dict(ba_device="cpu"),
               dict(chunk=3, overlap=True, async_ba=True)):
        eng = CoSlamEngine(cfg, K, kc, device="cpu", **kw)
        for k, v in kw.items():
            assert getattr(eng, k) == v
    with pytest.raises(NotImplementedError, match="A18"):
        CoSlamEngine(cfg, K, kc, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A18"):
        CoSlamEngine(cfg, K, kc, device="cpu", ba_device="cuda:1")
    cfg2 = small_test_config(2, 96, 128)
    eng = CoSlamEngine(cfg2, np.repeat(K, 2, 0), np.zeros((2, 5), np.float32),
                       device="cpu")
    eng.group_id = np.array([0, 1], np.int32)
    eng._update_grouping = lambda: None           # keep the split
    eng._merge_possible = lambda: True
    out = SimpleNamespace(n_inliers=np.array([90, 90]),
                          coverage=np.array([0.5, 0.5]),
                          med_err=np.zeros(2), med_depth=np.ones(2))
    kw = dict(n_mapped=np.array([200, 200]), n_new=0, dyn=None, n_static=0,
              n_dynamic=0)
    tries = []
    eng._try_merge = lambda pyr: tries.append(eng.frame)   # bridge fails
    eng._try_loop_closure = lambda pyr: None
    eng.frame = cfg2.p.merge_min_interval - 1     # too early: no merge
    eng._intercam_cadence = lambda *a: 0
    eng._keyframe_ready = lambda out: False
    eng._shared_cadence(None, out, frame=eng.frame, **kw)
    assert tries == []
    f0 = cfg2.p.merge_min_interval + GROUPING_INTERVAL
    for k in range(4):
        eng.frame = f0 + k * GROUPING_INTERVAL
        eng._shared_cadence(None, out, frame=eng.frame, **kw)
    assert tries == [f0, f0 + 2 * GROUPING_INTERVAL]


def test_loop_closure_point_raises():
    """The loop-closure check (ported, A14) is reached only once
    loop_min_interval frames have passed; with no dormant point in view
    it returns at the device prefilter, as the reference does, and never
    raises."""
    from coslam_torch.config import small_test_config
    from coslam_torch.slam import pipeline as pl
    cfg = small_test_config(1, 96, 128)
    K = np.array([[[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]]], np.float32)
    eng = pl.CoSlamEngine(cfg, K, np.zeros((1, 5), np.float32), device="cpu")
    scans = []
    real_scan = eng._host_scan
    eng._host_scan = lambda: scans.append(eng.frame) or real_scan()
    eng.frame = cfg.p.loop_min_interval - 1
    eng._try_loop_closure(None)                      # not due yet
    assert scans == []
    eng.frame = cfg.p.loop_min_interval
    eng._try_loop_closure(None)                      # prefilter: nothing
    assert scans == [eng.frame] and eng.loop_log == []
    assert eng._last_loop_attempt < 0
