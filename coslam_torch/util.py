"""Small tensor helpers shared across the package: device selection, the
NaN-aware median, batched host copies and JAX-style dropping scatters."""

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


def set_drop(dst: torch.Tensor, idx, val, accumulate: bool = False):
    """``dst.at[idx].set(val, mode="drop")`` along dim 0: entries whose
    index is >= len(dst) are dropped. ``idx`` is a tensor or a tuple of
    index tensors (only the first is range-checked). Writes go through a
    sentinel row, so nothing syncs with the host. Returns a new tensor."""
    n = dst.shape[0]
    if not isinstance(idx, tuple):
        idx = (idx,)
    first = torch.clamp(idx[0].long(), 0, n)
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    ext.index_put_((first,) + tuple(i.long() for i in idx[1:]),
                   val.to(dst.dtype) if torch.is_tensor(val)
                   else torch.tensor(val, dtype=dst.dtype, device=dst.device),
                   accumulate=accumulate)
    return ext[:n]
