"""Small helpers shared across the package: device selection, the
NaN-aware median, host arrays moved to the card without a wait and
JAX-style dropping scatters (the port's build cache and batched host
copies are not copied)."""

from __future__ import annotations

import torch


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
