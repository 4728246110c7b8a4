"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m slambench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Set-up (counted in ``setup_s``, from process start): imports, the port's
kernel libraries (``build/<hash>/`` in the checkout), the scene rendered
on the card from ``--seed``, the engine, its bootstrap and the warm
frames. Then the window: opened after ``torch.cuda.synchronize()``, it
drives ``CoSlamEngine.process_frame`` one rig frame a call until
``--seconds`` have passed (or the frame buffer ends) and closes on a
synchronize. With ``--trace 1`` the run also counts synchronizing calls,
and torch.profiler records a slice of ``trace_frames`` calls in the
middle of the window; the result then holds the per-layer metrics.
After the window the reference (``check.py``) decides ``correct``.

Exits non-zero, printing no result, without a CUDA card, in a process
that has loaded JAX or the JAX package, or when anything fails.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402

# one process, few threads: the host paces the card, and the intra-op
# pool's spinning threads would compete with the launch path
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "coslam_tpu")
BENCH_CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def log(msg: str) -> None:
    print(f"[slambench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``root``/BENCHMARK.json with its configuration
    and traffic files, found by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return {"bench": bench, "workload": w,
            "config": load_json(root / conf["file"]),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json")}


def load_module(kind: str, name: str):
    """``slambench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list:
    """The modules (default: those loaded) whose top-level name, compared
    whole, is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def card_label(torch) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[torch.cuda.current_device()]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name() + ", power limit not read"


def tree_bytes(x) -> int:
    """Bytes of every tensor in a (named) tuple tree or dict of them."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(tree_bytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(tree_bytes(v) for v in x)
    return 0


class CheckMemory:
    """The device memory that the check's copies hold in the window, kept
    out of the program's peak: before the check takes or frees a copy the
    peak since the last mark, less what the check held, is noted, and the
    allocator's peak restarts from what is allocated now. Host-side
    allocator calls only: nothing waits on the card."""

    def __init__(self, dev, cuda: bool):
        self.dev, self.cuda = dev, cuda
        self.held = self.most = 0
        self.program_peak = 0

    def mark(self):
        import torch
        if self.cuda:
            self.program_peak = max(
                self.program_peak,
                torch.cuda.max_memory_allocated(self.dev) - self.held)

    def _restart(self):
        import torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def take(self, tree):
        from slambench import check
        self.mark()
        c = check.clone_tree(tree)
        self.held += tree_bytes(c)
        self.most = max(self.most, self.held)
        self._restart()
        return c

    def freed(self, nbytes: int):
        """Call before the last reference to ``nbytes`` of copies goes;
        ``_restart`` follows at the next ``take`` or ``settle``."""
        self.mark()
        self.held -= nbytes

    def settle(self):
        self._restart()


class Reservoir:
    """At most ``k`` items, a uniform sample of all offered (reservoir
    sampling, draws from ``rng``), so that what the check keeps does not
    grow with the window. The caller drops its own references to what it
    offered, then calls ``memory.settle()``."""

    def __init__(self, k: int, rng, memory: CheckMemory):
        self.k, self.rng, self.mem = k, rng, memory
        self.items, self.seen = [], 0

    def offer(self, item: dict):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        self.mem.freed(tree_bytes(self.items[j] if j < self.k else item))
        if j < self.k:
            self.items[j] = item


def program_config(cfg: dict):
    """The configuration file as coslam_torch's SlamConfig."""
    from coslam_torch import config as pc
    return pc.SlamConfig(
        num_cameras=cfg["num_cameras"], image_height=cfg["image_height"],
        image_width=cfg["image_width"], klt=pc.KLTConfig(**cfg["klt"]),
        cap=pc.CapacityConfig(**cfg["cap"]), p=pc.SlamParams(**cfg["p"]))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", max_frames: int | None = None,
             program_tf32: bool = False,
             t_start: float | None = None) -> dict:
    """One run of ``cell`` (``load_cell``). Returns the result line's
    dict. ``device="cpu"`` and ``max_frames`` (a window of that many calls
    instead of ``seconds``) serve the tests; the control switches
    ``program_tf32`` on."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    t_start = _T0 if t_start is None else t_start
    split = {}
    t = time.perf_counter()
    from coslam_torch.slam.pipeline import CoSlamEngine
    from slambench import check
    from slambench.scene import intrinsics, render_scene
    torch.backends.cuda.matmul.allow_tf32 = program_tf32
    torch.backends.cudnn.allow_tf32 = program_tf32
    cfg, traffic, wl = cell["config"], cell["traffic"], cell["workload"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    split["imports"] = time.perf_counter() - t_start
    t = time.perf_counter()
    if cuda:
        from coslam_torch.ops import cuda_lib
        cuda_lib.build_all()
    split["libraries"] = time.perf_counter() - t

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    frames = render_scene(cfg, traffic, seed, dev)
    sync()
    if traffic["feed"] == "host":
        frames = frames.cpu().numpy()
    split["render"] = time.perf_counter() - t
    C = cfg["num_cameras"]
    K = intrinsics(cfg)
    kc = np.broadcast_to(np.asarray(cfg["distortion"], np.float32),
                         (C, 5)).copy()
    eng_kw = traffic["engine"]
    chunk = eng_kw["chunk"]
    t = time.perf_counter()
    eng = CoSlamEngine(program_config(cfg), K, kc, device=dev,
                       chunk=chunk, overlap=eng_kw["overlap"],
                       async_ba=eng_kw["async_ba"])
    split["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    eng.process_frame(frames[0])
    sync()
    split["bootstrap"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = traffic["warm_frames"]
    for f in range(1, warm):
        eng.process_frame(frames[f])
    sync()
    if trace and cuda:
        # the profiler's first start initializes its tracing (seconds):
        # done here, so that the slice in the window pays none of it
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            sync()
    split["warm"] = time.perf_counter() - t
    if not eng.bootstrapped:
        raise RuntimeError(f"the engine did not bootstrap in {warm} frames")

    # ---------------- the window ----------------
    rng = np.random.default_rng([seed % 2 ** 64, 0x51A3])
    caps = traffic["check"]
    every = caps["every"]
    pick = int(rng.integers(every))
    mem = CheckMemory(dev, cuda)
    # the sampled calls and BAs, drawn while the window runs; a call whose
    # cadence merged, closed a loop, fused duplicates or solved a joint
    # pose rewrites what the step and the BA made and is not offered
    res_rng = np.random.default_rng([seed % 2 ** 64, 0xBA5E])
    snaps = Reservoir(caps["steps"], res_rng, mem)
    bas = Reservoir(caps["ba"], res_rng, mem)
    F = len(frames)
    n_trace = traffic["trace_frames"]
    walls_ms = []
    n_steps = 0
    slice_at = slice_end = None
    stage0 = stage_in = None
    trace_out = {}
    samples = []
    prof = None
    syncs = None
    if trace and cuda:
        from slambench.syncs import SyncCounter
        syncs = SyncCounter()
    eng.timing = {}
    stats0 = len(eng.stats_log)
    kf0, ba0 = len(eng.kf_frames), eng.ba_runs
    merges0, loops0 = len(eng.merge_log), len(eng.loop_log)
    attempted = 0
    crashed = None
    # every keyframe BA outside the profiled slice: the state it starts
    # from, caught where the port builds its table (merge- and loop-time
    # BAs, which name a window, are not caught)
    from coslam_torch.slam import steps as program_steps
    real_build = program_steps.build_ba_table
    ba_seen = {"on": False, "before": None}

    def build_ba_table(state, *a, **k):
        if ba_seen["on"] and k.get("window") is None and len(a) < 3:
            ba_seen["before"] = mem.take(state)
        return real_build(state, *a, **k)

    program_steps.build_ba_table = build_ba_table
    sync()
    # the program's peak so far (set-up holds no copy of the check's)
    mem.mark()
    mem.settle()
    # set-up's objects (the frames, the engine's warm logs) are left out
    # of the collector's passes in the window
    gc.collect()
    gc.freeze()
    if syncs is not None:
        syncs.__enter__()
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    f = warm
    try:
        while f < F:
            i = f - warm
            if max_frames is not None:
                if i >= max_frames:
                    break
            elif time.perf_counter() - t_open >= seconds and prof is None:
                break
            # the call that fills the engine's chunk steps it: its frames
            # are f - chunk + 1 .. f (``eng.frame`` counts the frames
            # stepped, so a bootstrap that took more than one frame moves
            # the chunks' boundaries with it)
            steps_now = chunk == 1 or f - eng.frame == chunk - 1
            if trace and cuda and slice_at is None and steps_now and (
                    (max_frames is not None and i >= max_frames // 2)
                    or (max_frames is None
                        and time.perf_counter() - t_open >= seconds / 2)):
                from torch.profiler import (ProfilerActivity, profile,
                                            schedule)

                def ready(p):
                    from slambench.trace import summarize
                    trace_out["summary"] = summarize(p.profiler.kineto_results)

                slice_at, slice_end = f, f + chunk + n_trace
                stage_in = dict(eng.timing)
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA],
                               schedule=schedule(wait=0, warmup=chunk,
                                                 active=n_trace, repeat=1),
                               on_trace_ready=ready)
                prof.start()
            in_slice = slice_at is not None and slice_at <= f < slice_end
            snap = None
            if steps_now and not in_slice:
                if n_steps % every == pick:
                    snap = {"f0": f - chunk + 1, "n": chunk,
                            "before": mem.take(eng.state),
                            "ba_runs": eng.ba_runs}
                n_steps += 1
            if in_slice and steps_now and f >= slice_at + chunk:
                # the inputs of the call's first step, for the kernels'
                # counts (roofline/<kernel>.py)
                f1 = f - chunk + 1
                samples.append({"prev": frames[f1 - 1], "cur": frames[f1],
                                "state": mem.take(eng.state)})
            ba_seen["on"] = not in_slice
            ba_seen["before"] = None
            before_call = (len(eng.merge_log), len(eng.loop_log),
                           len(eng.stats_log))
            t_call = time.perf_counter()
            attempted += 1
            if in_slice:
                with torch.profiler.record_function("slambench.frame"):
                    eng.process_frame(frames[f])
                prof.step()
            else:
                eng.process_frame(frames[f])
            if not in_slice and chunk == 1:
                walls_ms.append(1e3 * (time.perf_counter() - t_call))
            if prof is not None and f == slice_end - 1:
                prof.stop()
                prof = None
                stage0 = {k: eng.timing.get(k, 0.0) - stage_in.get(k, 0.0)
                          for k in eng.timing}
            # a merge, loop closure, duplicate fusion or joint pose in the
            # call's cadence rewrites what the step and the BA made
            moved = (len(eng.merge_log) > before_call[0]
                     or len(eng.loop_log) > before_call[1]
                     or any(e.get("joint_pose") or e.get("n_fused")
                            for e in eng.stats_log[before_call[2]:]))
            if ba_seen["before"] is not None:
                if moved:
                    mem.freed(tree_bytes(ba_seen["before"]))
                else:
                    bas.offer({"before": ba_seen["before"],
                               "after": mem.take(eng.state)})
                ba_seen["before"] = None
                mem.settle()
            if snap is not None:
                if moved:
                    mem.freed(tree_bytes(snap["before"]))
                else:
                    snap["after"] = mem.take(eng.state)
                    snap["pyr_after"] = mem.take(eng.pyr_prev)
                    snap["ba"] = eng.ba_runs > snap["ba_runs"]
                    # live: the recorded pose is the step's unless the
                    # cadence ran BA; chunks: the stats rows carry each
                    # step's pose
                    snap["pose_frames"] = (
                        set(range(snap["f0"], f + 1))
                        if chunk > 1 or not snap["ba"] else set())
                    snaps.offer(snap)
                snap = None
                mem.settle()
            f += 1
    except Exception as e:          # a frame the engine did not track
        crashed = f"{type(e).__name__}: {e}"
        log(f"process_frame raised at frame {f}: {crashed}")
    finally:
        program_steps.build_ba_table = real_build
    sync()
    t_close = time.perf_counter()
    gc.unfreeze()
    if syncs is not None:
        syncs.__exit__(None, None, None)
    if prof is not None:
        prof.stop()
    window_s = t_close - t_open
    mem.mark()
    peak = mem.program_peak
    # frames handed in inside the window whose statistics came back (in
    # chunk mode a chunk's once the cadence has read them)
    entries = [e for e in eng.stats_log[stats0:] if e["frame"] >= warm]
    completed = len(entries)
    failed = sum(1 for e in entries
                 if np.any(np.asarray(e.get("n_inliers", [1])) <= 0))
    traj = eng.traj
    first = entries[0]["frame"] if entries else warm
    for fr in range(first, first + completed):
        if fr < len(traj[0]) and not all(
                np.all(np.isfinite(traj[c][fr][0]))
                and np.all(np.isfinite(traj[c][fr][1])) for c in range(C)):
            failed += 1
    if crashed:
        failed += max(0, attempted - completed)
    events = {"keyframes": len(eng.kf_frames) - kf0,
              "ba_runs": eng.ba_runs - ba0,
              "merges": len(eng.merge_log) - merges0,
              "loops": len(eng.loop_log) - loops0,
              "buffer_end_reached": f >= F}
    timing = dict(eng.timing)
    stage = {k: v - (stage0 or {}).get(k, 0.0) for k, v in timing.items()}
    in_slice_frames = (slice_end - slice_at) if slice_at else 0
    launches = None
    if cuda:
        from coslam_torch.ops import launch_counts
        launches = launch_counts()
    log(f"window: {window_s:.6f} s, {attempted} rig frames handed in, "
        f"{completed} completed, {failed} failed; {events}")
    log(f"peak device memory {peak} B without the check's copies "
        f"(those held at most {mem.most} B at once; "
        f"{snaps.seen} calls and {bas.seen} BAs offered to the sample); "
        f"stage clock (s) "
        f"{ {k: round(v, 6) for k, v in sorted(timing.items())} }")
    log(f"kernel launches since process start: {launches}")
    del eng
    if cuda:
        torch.cuda.empty_cache()

    # ---------------- correctness ----------------
    t = time.perf_counter()
    worst, counts = check.judge(snaps.items, bas.items, frames, traj, cfg,
                                K, dev)
    ok, shown = check.verdict(worst, counts, caps)
    if crashed:
        ok = False
    log(f"reference: {counts['steps']} rig frames replayed, "
        f"{counts['ba']} BA windows rerun, {time.perf_counter() - t:.3f} s")

    result = {"correct": bool(ok), "attempted": attempted, "failed": failed}
    run = {"cell": wl, "config": cfg, "traffic": traffic,
           "completed": completed, "window_s": window_s,
           "walls_ms": walls_ms, "stage": stage,
           "stage_frames": completed - in_slice_frames,
           "syncs": None if syncs is None else {
               "total": syncs.total, "explicit": syncs.explicit_syncs},
           "trace": trace_out.get("summary"), "peaks": None,
           # a kernel's (bytes, flop) a call, from roofline/<kernel>.py
           "work": lambda kernel: load_module("roofline", kernel).work(
               cfg, samples)}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        metrics = {
            "cam_frames_per_s": {"value": completed * C / window_s,
                                 "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        run["peaks"] = load_json(HERE / "peaks.json").get(
            device_info["kind"])
        metrics = {}
        for m in cell["bench"]["per_layer"]:
            if wl["name"] not in m.get("workloads", [wl["name"]]):
                continue
            v = load_module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tr = run["trace"]
        if tr is not None:
            device_info["busy_s"] = tr["busy_s"]
            device_info["window_s"] = tr["window_s"]
            result["breakdown"] = tr["breakdown"]
            log(f"trace: {tr['frames']} frames, {tr['activities']} device "
                f"activities, kernels {tr['kernels']}")
        if syncs is not None:
            log(f"synchronizing calls by site: {dict(syncs.sites)}")
    log(f"set-up split (s): { {k: round(v, 6) for k, v in split.items()} }"
        f", setup_s {setup_s:.6f}")
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s): torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
            "found")
        return 2
    cache = ROOT / "build" / "slambench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    log(f"card: {card_label(torch)}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}; workload {args.workload}, seed {args.seed}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r} "
            f"{c['unit']})")
    log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
