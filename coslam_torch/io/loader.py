"""Frame input: the native threaded prefetch loader and format helpers (the
port of ``coslam_tpu/io/loader.py``, with its own ctypes binding).

The reference decodes each camera's video on its own pthread every frame
(grabReadFrame, SL_CoSLAM.cpp:114-133, OpenCV-backed SL_AVIReader). The
native C++ loader ``native/frameloader.cpp`` prefetches and resizes
frames on one worker thread per camera into a ring buffer, so host
decode overlaps device compute. It is compiled at first use with
``g++ -O3 -shared -fPIC -pthread`` into ``build/<hash>/libframeloader.so``
at the repository root (keyed by a hash of the source and the flags);
nothing is written under ``native/``. Without ``g++`` the loader falls
back to a pure-Python reader of raw files (``FrameLoader.native`` says
which one runs).

Sources: CSRW raw grayscale files (written by ``write_raw_sequence``) or
binary PGM file patterns. ``convert_video_to_raw`` converts other videos
to CSRW through cv2 where it is installed (imported only there).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from coslam_torch.util import finish_compile, hashed_build_dir, start_compile

_SRC = Path(__file__).resolve().parents[2] / "native" / "frameloader.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
_build_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the compiled loader lives: build/<hash of source and
    flags>/libframeloader.so."""
    return hashed_build_dir(["g++"] + _FLAGS, [_SRC]) / "libframeloader.so"


def _build_native() -> Path | None:
    """Compile the loader unless it is built already; None when g++ is
    missing or fails."""
    with _build_lock:
        so = library_path()
        if so.exists():
            return so
        try:
            proc, tmp = start_compile(["g++", *_FLAGS, str(_SRC)], so)
        except OSError:
            return None
        return so if finish_compile(proc, tmp, so) else None


def native_lib():
    """The loaded native loader (built on first use), or None."""
    global _lib
    if _lib is not None:
        return _lib
    so = _build_native()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    lib.fl_open_at.restype = ctypes.c_void_p
    lib.fl_open_at.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.fl_src_size.restype = ctypes.c_int
    lib.fl_src_size.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.fl_frame_count.restype = ctypes.c_long
    lib.fl_frame_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


MODE_RAW = 0
MODE_PGM = 1


def write_raw_sequence(path: str, frames: np.ndarray):
    """frames: [F, H, W] u8 -> CSRW file."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    F, H, W = frames.shape
    with open(path, "wb") as f:
        f.write(b"CSRW")
        f.write(np.array([W, H, F], np.uint32).tobytes())
        f.write(frames.tobytes())


class FrameLoader:
    """Threaded multi-camera loader. Yields [C, H, W] float32 numpy frames;
    ``start_frames`` skips each camera's first frames, ``out_hw`` box-
    resizes. ``native`` is True when the C++ loader runs (False: the
    Python fallback, raw files only, no prefetch)."""

    def __init__(self, paths: list[str], mode: int = MODE_RAW,
                 out_hw: tuple[int, int] | None = None, ring: int = 4,
                 start_frames: list[int] | None = None):
        self.paths = paths
        self.n_cams = len(paths)
        lib = native_lib()
        self._native = lib is not None
        self._h = None
        out_h, out_w = out_hw if out_hw else (0, 0)
        starts = start_frames or [0] * self.n_cams
        if self._native:
            arr = (ctypes.c_char_p * self.n_cams)(
                *[p.encode() for p in paths])
            sarr = (ctypes.c_long * self.n_cams)(*starts)
            self._h = lib.fl_open_at(arr, sarr, self.n_cams, mode, out_w,
                                     out_h, ring)
            if not self._h:
                raise IOError(f"native loader failed to open {paths}")
            w = ctypes.c_int()
            h = ctypes.c_int()
            lib.fl_src_size(self._h, 0, ctypes.byref(w), ctypes.byref(h))
            self.hw = (out_h, out_w) if out_hw else (h.value, w.value)
            self._lib = lib
        else:
            if mode != MODE_RAW:
                raise IOError("the Python fallback reads raw files only")
            self._files = []
            for p in paths:
                with open(p, "rb") as f:
                    hdr = f.read(16)
                if hdr[:4] != b"CSRW":
                    raise IOError(f"{p} is not a CSRW file")
                w, h, n = np.frombuffer(hdr[4:], np.uint32)
                self._files.append(np.memmap(p, np.uint8, "r", offset=16,
                                             shape=(int(n), int(h), int(w))))
            self.hw = out_hw or self._files[0].shape[1:]
            self._idx = 0
            self._starts = starts

    @property
    def native(self) -> bool:
        return self._native

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        h, w = self.hw
        if self._native:
            out = np.empty((self.n_cams, h, w), np.uint8)
            ok = self._lib.fl_next(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if not ok:
                raise StopIteration
            return out.astype(np.float32)
        frames = []
        for c, data in enumerate(self._files):
            src = self._idx + self._starts[c]
            if src >= data.shape[0]:
                raise StopIteration
            fr = np.asarray(data[src], np.float32)
            if fr.shape != (h, w):
                ys = np.arange(h) * fr.shape[0] // h
                xs = np.arange(w) * fr.shape[1] // w
                fr = fr[ys][:, xs]
            frames.append(fr)
        self._idx += 1
        return np.stack(frames)

    def close(self):
        if self._native and self._h:
            self._lib.fl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def convert_video_to_raw(video_path: str, out_path: str,
                         max_frames: int | None = None) -> int:
    """Decode a video to a CSRW grayscale file through cv2 (which must be
    installed). Returns the number of frames."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 is not installed: decoding a video needs it; "
                           "convert the video to CSRW where cv2 is present "
                           "(coslam_torch.io.loader.convert_video_to_raw) "
                           "and pass the .csrw file") from e
    cap = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok or (max_frames and len(frames) >= max_frames):
            break
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {video_path}")
    write_raw_sequence(out_path, np.stack(frames))
    return len(frames)
