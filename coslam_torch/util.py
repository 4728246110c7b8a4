"""Small helpers shared across the package: device selection, the
NaN-aware median, batched host copies, host arrays moved to the card
without a wait, JAX-style dropping scatters, and the build cache of the
compiled libraries (the CUDA kernels and the native frame loader)."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

BUILD_ROOT = Path(__file__).resolve().parents[1] / "build"


def hashed_build_dir(flags: list[str], sources) -> Path:
    """``build/<hash>/`` at the repository root for a compile of
    ``sources`` with ``flags``: a change to either gives a new directory."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def start_compile(cmd: list[str], out: Path, log=subprocess.DEVNULL):
    """Start ``cmd -o <a temporary file beside out>`` (its output to
    ``log``). Returns (process, temporary path) for ``finish_compile``.
    Raises OSError when the compiler cannot be run."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.Popen([*cmd, "-o", tmp], stdout=log,
                                stderr=subprocess.STDOUT)
    except OSError:
        os.unlink(tmp)
        raise
    return proc, tmp


def finish_compile(proc, tmp: str, out: Path) -> bool:
    """Wait for a compile from ``start_compile``. On success its output
    becomes ``out`` in one rename (a concurrent reader never sees a partial
    library); on failure it is deleted. Returns whether it succeeded."""
    if proc.wait() != 0:
        os.unlink(tmp)
        return False
    os.replace(tmp, out)
    return True


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises (never falls back to the CPU) when no card is present
    and the caller did not ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmedian`` semantics: the mean of the two middle non-NaN
    values for an even count (``torch.nanmedian`` returns the lower one),
    NaN where a slice holds no number. Interpolates as jnp's quantile
    does (low * (1 - w) + high * w)."""
    s, _ = torch.sort(x, dim=dim)                 # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo = torch.floor(q)
    hi = torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    top = n - 1.0
    lo = torch.maximum(torch.minimum(lo, top), torch.zeros_like(lo)).long()
    hi = torch.maximum(torch.minimum(hi, top), torch.zeros_like(hi)).long()
    out = torch.gather(s, dim, lo) * lw + torch.gather(s, dim, hi) * hw
    return out.squeeze(dim)


def to_host(*tensors):
    """Several tensors as numpy arrays after one wait: the device-to-host
    copies are queued without blocking and the device is synchronized once
    (a host decision that reads many tables pays one sync, not one per
    table). A CPU tensor is not copied: its array shares its memory, so
    callers only read them."""
    out = [a.to("cpu", non_blocking=True) for a in tensors]
    if any(a.is_cuda for a in tensors):
        torch.cuda.synchronize()
    return [a.numpy() for a in out]


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A small host array (numpy, list or CPU tensor) on ``device`` with no
    host wait: the copy to a card is queued with ``non_blocking=True``,
    which stages pageable memory at once and does not synchronize the
    stream (a blocking copy does)."""
    t = torch.as_tensor(a, dtype=dtype)
    return t.to(device, non_blocking=True)


_CONSTANTS: dict = {}


def device_constant(key, device, make) -> torch.Tensor:
    """``to_device(make(), device)``, built once per ``key`` and device and
    kept: a constant of the per-frame step costs no copy after its first
    frame."""
    device = torch.device(device)
    k = (key, device.type, device.index)
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = to_device(make(), device)
    return t


def set_drop(dst: torch.Tensor, idx, val, accumulate: bool = False):
    """``dst.at[idx].set(val, mode="drop")`` along dim 0: entries whose
    index is >= len(dst) are dropped. ``idx`` is a tensor or a tuple of
    index tensors (only the first is range-checked). Writes go through a
    sentinel row, so nothing syncs with the host; a Python scalar ``val``
    becomes a device fill, not a host-to-device copy. Returns a new
    tensor."""
    n = dst.shape[0]
    if not isinstance(idx, tuple):
        idx = (idx,)
    first = torch.clamp(idx[0].long(), 0, n)
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    if torch.is_tensor(val):
        val = val.to(dst.dtype)
    else:
        val = torch.full((), val, dtype=dst.dtype, device=dst.device)
    ext.index_put_((first,) + tuple(i.long() for i in idx[1:]), val,
                   accumulate=accumulate)
    return ext[:n]
